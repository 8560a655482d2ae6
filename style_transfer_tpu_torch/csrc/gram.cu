// Gram products on (M, C) bf16 activations on Hopper's warpgroup MMA, with
// fp32 accumulation:
//   st_gram     G = F^T F                 (forward Gram epilogue)
//   st_gram_fs  F S, S a (C, C) matrix    (backward Gram term)
// Both take an optional column window (W, clo, chi): row m of F is pixel
// column m % W of an (H, W) image, and rows whose column lies outside
// [clo, chi) add nothing to G and get a zero F S row. That is the gram_cols
// ownership mask of conv_single.py::_fwd_kernel (:112-117) and
// ::_bwd_kernel (:182-187): a W slice with halo columns counts only the
// columns it owns. W = 0 means no window.
//
// Replaces the in-kernel Gram syrk and the y.S products of the TPU kernels
//   style_transfer_tpu/ops/pallas/conv_pair.py::_fwd_kernel (acc_ref += f^T f)
//   and ::_bwd_kernel (r1 @ S in post_b),
//   style_transfer_tpu/ops/pallas/conv_gram.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/block1_packed.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/conv_single.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/gram.py::_gram_kernel.
// The TPU kernels accumulate the Gram across their sequential grid in VMEM
// scratch; Hopper blocks run in no order, so here each block sums its run of
// rows into partial tiles and a second pass adds the partials in a fixed
// order (no atomics), which keeps the result bit-identical run to run.
//
// What bounds them on the H100. F^T F is 2 M C^2 FLOP over 2 M C bytes of F:
// C FLOP a byte, so at 64-256 channels and 0.26-4 M rows (VGG's conv1_1 to
// conv3_1, ResNet's stem and stage 1) the bytes of F bound it (the card's
// bf16 ridge is ~295), and from 512 channels the operations (ResNet's
// stages 3-4: 128^2 x 1024 and 64^2 x 2048, 34 GFLOP each over 17-34 MB). F S
// reads F and writes an output of the same shape (fp32 in VGG's chain,
// twice F's bytes), so it is bound by bytes up to 256 channels and by
// operations from 1024.
//
// The design: both products are persistent, warp-specialised kernels, one
// block an SM, on wgmma (m64nNk16, both operands from shared memory by
// descriptor) fed by TMA into a ring of stages with a full and an empty
// mbarrier each; a producer thread keeps the ring full, running ahead across
// tiles, while the consumer warpgroups multiply.
// - F^T F (gram_kernel). G is symmetric: only the BT x BT tiles on and above
//   the diagonal are computed (BT = 64 where C is not a multiple of 128 or
//   F is small, else 128; the launcher chooses by (M, C)), and the reduce
//   pass mirrors them. F lies row-major,
//   [row][channel], so a stage holds, for 64 rows, the tile's row channels
//   (A = F^T, M-major: wgmma's transpose bit) and its column channels (B =
//   F, N-major), each as 64-channel TMA boxes of 64 rows in the 128-byte
//   swizzle; a diagonal tile loads one slab and reads it as both. BT / 64
//   consumer warpgroups split the tile's rows (one m64nBT product a
//   warpgroup per 16 rows of F). The work, (tile, 64-row step) pairs, is
//   split one of two ways, chosen by the launcher from (M, C):
//   - in chunks (from 2 to 132 tiles: 256-1920 channels): block b takes tile
//     b % tiles over chunk b / tiles of the rows, so the blocks of a chunk
//     read its rows side by side and each row of F comes from memory once
//     and from L2 for the other tiles; on the H100 this took 65536 x 512
//     from 84 to 40 us and 16384 x 1024 from 55 to 40 us against stream-K;
//   - stream-K (one tile, or more than the SMs): block b of G takes the b-th
//     of G equal contiguous runs of the pairs, tile by tile, so every SM
//     gets the same steps whatever the tile count (2048 channels: 136
//     tiles), the run of a tile cut by block boundaries into pieces; at
//     64-128 channels (one tile) a block streams its rows through the ring,
//     deep enough (13-24 stages) to keep the memory busy.
//   A tile's first piece is written into its place in the output, any other
//   into a slot of the scratch: chunked, block b's into slot b; stream-K,
//   only a block's first piece can be another (every later piece of a run
//   starts a tile), into slot b - 1. At most one partial tile a block.
// - The reduce pass adds each 64 x 64 block on or above the diagonal over
//   the pieces of its tile in a fixed order, writes it over the first piece
//   and its transpose below the diagonal: where a tile has 8 or more pieces
//   (64-512 channels) a block takes one row of it (32 or more pieces) or
//   eight, sixteen groups of threads the pieces in turn (gram_reduce_rows);
//   else a block takes it whole, piece after piece (gram_reduce_blocks).
// - F S (gram_fs_kernel), the shape of csrc/conv1x1.cu's GEMM: tiles of 128
//   rows x BN columns (BN = 128, or 64 at 64-128 channels and where the
//   128-wide tiles would not outnumber the SMs),
//   listed row tile by row tile, and block b of G takes tiles b, b + G, ...,
//   so the blocks working together read one row tile's F from memory once;
//   S stays in L2 (at most 8 MB). A stage holds 64 channels of the tile's
//   rows (A, K-major) and the matching 64 rows of S (B, N-major). Two
//   consumer warpgroups own whole tiles in turn: one multiplies while the
//   other writes its tile's results straight from the accumulators (fp32,
//   or one bf16 rounding, ReLU-gated by F > 0 on request), and a warpgroup
//   starts a tile's products once the other has issued its tile's last.
// - Rows beyond M are zero-filled by the TMA loads; the column window is
//   applied by the F^T F consumers zeroing the rows a stage does not own
//   before they multiply (an instantiation of its own), and by F S writing
//   zero rows.
// - Numbers: bf16 operands, fp32 accumulation in a fixed order of 16-row
//   (F^T F) or 16-channel (F S) steps; no atomics, so results are
//   bit-identical run to run.
#include "common.cuh"

namespace {

constexpr int GR = 64;                     // rows of F a stage holds (F^T F)
constexpr int BOX = GR * 128;              // bytes of 64 channels x GR rows
constexpr int SMEM = 232448;               // all a block may have: one block an SM
constexpr int GRAM_MAX_STAGES = 24;

// Column window of the Gram rows (see the header); wcols <= 0: every row.
struct Window {
  int wcols, clo, chi;
  __device__ __forceinline__ bool owns(int m) const {
    if (wcols <= 0) return true;
    const int c = m % wcols;
    return c >= clo && c < chi;
  }
};

struct GramArgs {
  int M, C, bt;
  int T;             // tiles a side: C / bt
  int steps;         // GR-row steps of F: ceil(M / GR)
  long long work;    // (tile, step) pairs: T (T + 1) / 2 * steps
  int chunks;        // 0: stream-K; else chunks of rows, a block a tile each
  int tiles;         // T (T + 1) / 2
  int stages, stage_bytes;
  Window win;
};

// Upper tile t, counted row by row, as (ti, tj) with ti <= tj.
__device__ __forceinline__ void tile_ij(int t, int T, int& ti, int& tj) {
  int i = 0;
  while (t >= T - i) {
    t -= T - i;
    ++i;
  }
  ti = i;
  tj = i + t;
}

// First (tile, step) pair of block b's run.
__device__ __forceinline__ long long run_start(long long b, long long G, long long work) {
  return b * work / G;
}

// The block whose run holds pair x: the largest b with run_start(b) <= x.
__device__ __forceinline__ int block_of(long long x, long long G, long long work) {
  return static_cast<int>(((x + 1) * G + work - 1) / work) - 1;
}

template <int BT>
__device__ __forceinline__ void gram_mma(float (&acc)[BT / 2], uint64_t da, uint64_t db,
                                         bool acc_in);

template <>
__device__ __forceinline__ void gram_mma<128>(float (&acc)[64], uint64_t da, uint64_t db,
                                              bool acc_in) {
  st::wgmma_m64n128k16_bf16_tb<1>(acc, da, db, acc_in);
}

template <>
__device__ __forceinline__ void gram_mma<64>(float (&acc)[32], uint64_t da, uint64_t db,
                                             bool acc_in) {
  st::wgmma_m64n64k16_bf16_tb<1>(acc, da, db, acc_in);
}

// Waits until the 128 threads of consumer warpgroup w have arrived.
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// Calls fn(t, k, n, first) for each piece of this block: steps k .. k + n -
// 1 of tile t, `first` where the piece is its tile's first. Stream-K
// (chunks = 0): the block's run [lo, hi) of the (tile, step) pairs, cut at
// tile boundaries. Chunked: tile blockIdx.x % tiles over chunk blockIdx.x /
// tiles of the steps.
template <class F>
__device__ __forceinline__ void for_each_piece(const GramArgs& a, F&& fn) {
  if (a.chunks == 0) {
    const long long hi = run_start(blockIdx.x + 1, gridDim.x, a.work);
    for (long long x = run_start(blockIdx.x, gridDim.x, a.work); x < hi;) {
      const int t = static_cast<int>(x / a.steps);
      const long long begin = (long long)t * a.steps, end = min(hi, begin + a.steps);
      fn(t, static_cast<int>(x - begin), static_cast<int>(end - x), x == begin);
      x = end;
    }
    return;
  }
  const int z = blockIdx.x / a.tiles, t = blockIdx.x - z * a.tiles;
  const int k0 = static_cast<int>((long long)z * a.steps / a.chunks);
  const int k1 = static_cast<int>((long long)(z + 1) * a.steps / a.chunks);
  fn(t, k0, k1 - k0, z == 0);
}

// Partial tiles of F^T F: warps 0 .. 4 BT / 64 - 1 are the consumer
// warpgroups, the next warp's first thread the producer.
template <int BT, bool WIN>
__global__ void __launch_bounds__(128 * (BT / 64) + 32, 1)
    gram_kernel(const GramArgs a, const __grid_constant__ CUtensorMap map_f,
                float* __restrict__ part, float* __restrict__ out) {
  constexpr int NC = BT / 64;      // consumer warpgroups: 64 rows of the tile each
  constexpr int SLAB = NC * BOX;   // BT channels x GR rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t base = (st::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + a.stages * a.stage_bytes, empty = full + 8 * GRAM_MAX_STAGES;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      st::mbar_init(full + 8 * s, 1);
      st::mbar_init(empty + 8 * s, 4 * NC);  // every consumer warp
    }
    st::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NC) {
    if (lane != 0) return;
    int s = 0, g = 0;
    uint32_t phase = 0;
    for_each_piece(a, [&](int t, int k, int n, bool) {
      int ti, tj;
      tile_ij(t, a.T, ti, tj);
      for (int i = 0; i < n; ++i, ++g, ++k) {
        if (g >= a.stages) st::mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t stage = base + s * a.stage_bytes, bar = full + 8 * s;
        st::mbar_arrive_expect_tx(bar, ti == tj ? SLAB : 2 * SLAB);
#pragma unroll
        for (int h = 0; h < NC; ++h) {
          st::tma_load_2d(stage + h * BOX, &map_f, bar, ti * BT + 64 * h, k * GR);
        }
        if (ti != tj) {
#pragma unroll
          for (int h = 0; h < NC; ++h) {
            st::tma_load_2d(stage + SLAB + h * BOX, &map_f, bar, tj * BT + 64 * h, k * GR);
          }
        }
        if (++s == a.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    });
    return;
  }

  const int w = warp >> 2, q = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  float acc[BT / 2];  // written first by a piece's first product (accumulate false)
  int s = 0;
  uint32_t phase = 0;
  for_each_piece(a, [&](int t, int k, int n, bool first) {
    int ti, tj;
    tile_ij(t, a.T, ti, tj);
    int prev = 0;
    for (int i = 0; i < n; ++i, ++k) {
      st::mbar_wait(full + 8 * s, phase);
      const uint32_t stage = base + s * a.stage_bytes;
      const uint32_t sa = stage + w * BOX, sb = ti == tj ? stage : stage + SLAB;
      if (WIN) {
        // zero the rows outside the window in this warpgroup's A box: a row
        // of F^T that is zero adds nothing, whatever B holds
        for (int e = tid & 127; e < GR * 8; e += 128) {
          if (!a.win.owns(k * GR + (e >> 3))) {
            asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(sa + e * 16), "r"(0),
                         "r"(0), "r"(0), "r"(0)
                         : "memory");
          }
        }
        st::fence_proxy_async();
        warpgroup_sync(w);
      }
      st::wgmma_hold(acc);
      st::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GR / 16; ++kk) {
        const uint64_t da = st::smem_desc_sw128(sa + kk * 16 * 128, BOX, 1024);
        const uint64_t db = st::smem_desc_sw128(sb + kk * 16 * 128, BOX, 1024);
        gram_mma<BT>(acc, da, db, i > 0 || kk > 0);
      }
      st::wgmma_commit();
      st::wgmma_wait<1>();  // the step before's products are done: release its stage
      st::wgmma_hold(acc);
      if (i > 0 && lane == 0) st::mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == a.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    st::wgmma_wait<0>();
    st::wgmma_hold(acc);
    if (lane == 0) st::mbar_arrive(empty + 8 * prev);
    // the piece's partial tile: a tile's first piece into its place in out,
    // any other into slot blockIdx.x (chunked) or blockIdx.x - 1 (stream-K:
    // a block's only such piece is its first, where its run starts inside a
    // tile) of part, row-major BT x BT. d[4j + 0, 1] is row 64 w + 16 q +
    // g8, columns 8 j + 2 t4, + 1; d[4j + 2, 3] the row 8 below.
    const int row = 64 * w + 16 * q + g8;
    const int ld = first ? a.C : BT;
    const size_t slot = blockIdx.x - (a.chunks == 0 ? 1 : 0);
    float* dst = (first ? out + (size_t)(ti * BT + row) * a.C + tj * BT
                        : part + slot * BT * BT + (size_t)row * BT) +
                 2 * t4;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dst + (size_t)8 * ld + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  });
}

// The pieces of the tile t that holds 64 x 64 block (bi, bj), in a fixed
// order: piece 0 in out, at the block's own place; piece p > 0 in a slot of
// part (at(p)): stream-K, block b0 + p's, in slot b0 + p - 1; chunked,
// chunk p's, in slot p tiles + t.
struct Pieces {
  float* home;        // the block's place in out
  const float* sub;   // its place in slot 0 of part
  size_t slot;        // floats from one slot to the next
  int n, first, step;
  __device__ __forceinline__ const float* at(int p) const {
    return sub + (first + (size_t)p * step) * slot;
  }
};

__device__ __forceinline__ Pieces pieces_of(const float* part, float* out, const GramArgs& a,
                                            int grid, int bi, int bj) {
  const int per = a.bt / 64, ti = bi / per, tj = bj / per;
  const int t = ti * a.T - ti * (ti - 1) / 2 + (tj - ti);
  Pieces p;
  p.home = out + (size_t)bi * 64 * a.C + bj * 64;
  p.slot = (size_t)a.bt * a.bt;
  p.sub = part + (size_t)(bi % per) * 64 * a.bt + (bj % per) * 64;
  if (a.chunks) {
    p.first = t;
    p.step = a.tiles;
    p.n = a.chunks;
  } else {
    const int b0 = block_of((long long)t * a.steps, grid, a.work);
    p.first = b0 - 1;
    p.step = 1;
    p.n = block_of((long long)(t + 1) * a.steps - 1, grid, a.work) - b0 + 1;
  }
  return p;
}

__device__ __forceinline__ void add4(float4& v, const float4 q) {
  v.x += q.x;
  v.y += q.y;
  v.z += q.z;
  v.w += q.w;
}

// out = the sum of the pieces, mirrored, where a tile has many pieces (8 or
// more). Block (x, y): rows ROWS y .. ROWS y + ROWS - 1 of the 64 x 64
// block x on or above the diagonal (counted row by row). Sixteen groups of
// 16 threads take pieces g, g + 16, ... (ROWS float4 a thread); the sixteen
// sums are added in order, written over piece 0, and their transpose below
// the diagonal.
template <int ROWS>
__global__ void __launch_bounds__(256)
    gram_reduce_rows(const float* __restrict__ part, float* __restrict__ out, const GramArgs a,
                     int grid) {
  __shared__ float4 sums[16][16 * ROWS];
  int bi, bj;
  tile_ij(blockIdx.x, a.C / 64, bi, bj);
  const Pieces pc = pieces_of(part, out, a, grid, bi, bj);
  const int r0 = blockIdx.y * ROWS, g = threadIdx.x >> 4, li = threadIdx.x & 15;
  float4 v[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int p = g; p < pc.n; p += 16) {
    const int ld = p == 0 ? a.C : a.bt;
    const float* src = (p == 0 ? pc.home : pc.at(p)) + (size_t)r0 * ld;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {  // float4 li of row r0 + u
      add4(v[u], __ldcg(reinterpret_cast<const float4*>(src + (size_t)u * ld) + li));
    }
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) sums[g][16 * u + li] = v[u];
  __syncthreads();
  const int e = threadIdx.x;  // float4 e of the strip: row e / 16, columns 4 (e % 16)
  if (e >= 16 * ROWS) return;
  float4 total = sums[0][e];
#pragma unroll
  for (int k = 1; k < 16; ++k) add4(total, sums[k][e]);
  const int r = r0 + (e >> 4), c = 4 * (e & 15);
  *reinterpret_cast<float4*>(pc.home + (size_t)r * a.C + c) = total;
  if (bi == bj) return;
  float* m = out + (size_t)(bj * 64 + c) * a.C + bi * 64 + r;  // column r of rows c ..
  m[0] = total.x;
  m[a.C] = total.y;
  m[2 * (size_t)a.C] = total.z;
  m[3 * (size_t)a.C] = total.w;
}

// The same where a tile has few pieces (1024-2048 channels): block x adds the
// whole 64 x 64 block, piece after piece (four float4 a thread), writes it
// over piece 0 and its transpose through shared memory.
__global__ void __launch_bounds__(256)
    gram_reduce_blocks(const float* __restrict__ part, float* __restrict__ out, const GramArgs a,
                       int grid) {
  __shared__ float tile[64][65];
  int bi, bj;
  tile_ij(blockIdx.x, a.C / 64, bi, bj);
  const Pieces pc = pieces_of(part, out, a, grid, bi, bj);
  float4 v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int p = 0; p < pc.n; ++p) {
    const float* src = p == 0 ? pc.home : pc.at(p);
    const int ld = p == 0 ? a.C : a.bt;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = threadIdx.x + 256 * u;  // float4 e: row e / 16, columns 4 (e % 16)
      add4(v[u], __ldcg(reinterpret_cast<const float4*>(src + (e >> 4) * ld + 4 * (e & 15))));
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {  // each thread writes over what it read itself
    const int e = threadIdx.x + 256 * u;
    *reinterpret_cast<float4*>(pc.home + (size_t)(e >> 4) * a.C + 4 * (e & 15)) = v[u];
  }
  if (bi == bj) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + 256 * u, r = e >> 4, c = 4 * (e & 15);
    tile[r][c] = v[u].x;
    tile[r][c + 1] = v[u].y;
    tile[r][c + 2] = v[u].z;
    tile[r][c + 3] = v[u].w;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < 64; c += 8) {  // row bj 64 + c: column c of the block
    *reinterpret_cast<float2*>(out + (size_t)(bj * 64 + c) * a.C + bi * 64 + 2 * lane) =
        make_float2(tile[2 * lane][c], tile[2 * lane + 1][c]);
  }
}

// ---- F S ----

constexpr int FS_BM = 128;                 // rows of an F S tile
constexpr int FS_A = FS_BM * 128;          // 64 channels of its rows
constexpr int FS_B = 64 * 128;             // 64 rows of S x 64 columns
constexpr int FS_NWG = 2;                  // consumer warpgroups, each owning whole tiles
constexpr int FS_LOADER_WARP = 4 * FS_NWG;
constexpr int FS_THREADS = 128 * (FS_NWG + 1);
constexpr int FS_MAX_STAGES = 8;
// Registers a thread once the roles are split (4 x 40 + 8 x 232 <= 65536 / 32
// a warp): a consumer holds a 128 x 128 fp32 tile
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
enum FsOut { OUT_F32 = 0, OUT_BF16 = 1, OUT_GATED = 2 };

struct FsArgs {
  const bf16* f;     // the gate of OUT_GATED
  float* out32;
  bf16* out16;
  int M, C, nchunks, tiles_n, tiles, stages;
  Window win;
};

template <int BN>
__device__ __forceinline__ void fs_mma(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                       bool acc_in);

template <>
__device__ __forceinline__ void fs_mma<128>(float (&acc)[64], uint64_t da, uint64_t db,
                                            bool acc_in) {
  st::wgmma_m64n128k16_bf16_tb(acc, da, db, acc_in);
}

template <>
__device__ __forceinline__ void fs_mma<64>(float (&acc)[32], uint64_t da, uint64_t db,
                                           bool acc_in) {
  st::wgmma_m64n64k16_bf16_tb(acc, da, db, acc_in);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 of v, each zeroed where the bf16 beside it in gate is not
// greater than zero (zero, negative or NaN).
__device__ __forceinline__ uint32_t gated_pair(uint32_t v, uint32_t gate) {
  const uint32_t lo = ((gate & 0xffffu) - 1u) < 0x7f80u ? 0xffffu : 0u;
  const uint32_t hi = ((gate >> 16) - 1u) < 0x7f80u ? 0xffff0000u : 0u;
  return v & (lo | hi);
}

// A consumer warpgroup's tiles: products from the ring, then the tile's
// results from the accumulators. Row 16 q + g (+ 8) of m64 half m of the
// tile is row 64 m + 16 q + g (+ 8).
template <int BN, int OUT>
__device__ __forceinline__ void fs_consume(const FsArgs& a, uint32_t base, uint32_t full,
                                           uint32_t empty, uint32_t turn, int ntiles, int wg,
                                           int q, int lane) {
  constexpr int STAGE = FS_A + (BN / 64) * FS_B;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[2][BN / 2];
  for (int i = wg; i < ntiles; i += FS_NWG) {
    const int first = i * a.nchunks;
    int s = first % a.stages, prev = 0;
    uint32_t phase = (first / a.stages) & 1;
    // The other warpgroup's tile before this one has all its chunks in: every
    // use of a stage before this tile's has completed, so a parity wait on
    // the stage's full barrier cannot read an older phase as this one.
    if (i > 0) st::mbar_wait(turn + 8 * wg, ((i - 1) / FS_NWG) & 1);
    for (int c = 0; c < a.nchunks; ++c) {
      st::mbar_wait(full + 8 * s, phase);
      const uint32_t stage = base + s * STAGE;
      st::wgmma_hold(acc[0]);
      st::wgmma_hold(acc[1]);
      st::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = st::smem_desc_sw128(stage + FS_A + kk * 16 * 128, FS_B, 1024);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint64_t da = st::smem_desc_sw128(stage + m * 64 * 128 + kk * 32, 16, 1024);
          fs_mma<BN>(acc[m], da, db, c > 0 || kk > 0);
        }
      }
      st::wgmma_commit();
      if (c == a.nchunks - 1 && lane == 0) st::mbar_arrive(turn + 8 * (1 - wg));
      st::wgmma_wait<1>();  // chunk c - 1's products are done: release its stage
      st::wgmma_hold(acc[0]);
      st::wgmma_hold(acc[1]);
      if (c > 0 && lane == 0) st::mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == a.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    st::wgmma_wait<0>();
    st::wgmma_hold(acc[0]);
    st::wgmma_hold(acc[1]);
    if (lane == 0) st::mbar_arrive(empty + 8 * prev);

    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = (tile / a.tiles_n) * FS_BM, n0 = (tile % a.tiles_n) * BN;
#pragma unroll
    for (int mr = 0; mr < 4; ++mr) {
      const int m = mr >> 1, r = mr & 1, row = m0 + 64 * m + 16 * q + g + 8 * r;
      const bool valid = row < a.M, own = valid && a.win.owns(row);
      const size_t o = (size_t)row * a.C + n0;
      if (OUT == OUT_F32) {
        if (!valid) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<float2*>(a.out32 + o + 8 * j + 2 * t4) =
              own ? make_float2(acc[m][4 * j + 2 * r], acc[m][4 * j + 2 * r + 1])
                  : make_float2(0.f, 0.f);
        }
        continue;
      }
      // bf16: a thread and its neighbour (t4 ^ 1) swap one rounded pair of
      // two 8-column groups, so each stores 4 consecutive columns (8 bytes)
      // and a warp's store fills 32-byte sectors of its 8 rows
      const bool odd = t4 & 1;
      const int col = odd ? 8 + 2 * (t4 - 1) : 2 * t4;
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const uint32_t p0 =
            own ? pack_bf16x2(acc[m][4 * j + 2 * r], acc[m][4 * j + 1 + 2 * r]) : 0u;
        const uint32_t p1 =
            own ? pack_bf16x2(acc[m][4 * j + 4 + 2 * r], acc[m][4 * j + 5 + 2 * r]) : 0u;
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? p0 : p1, 1);
        uint2 w = odd ? make_uint2(got, p1) : make_uint2(p0, got);
        if (!valid) continue;
        if (OUT == OUT_GATED) {
          const uint2 gate = *reinterpret_cast<const uint2*>(a.f + o + 8 * j + col);
          w.x = gated_pair(w.x, gate.x);
          w.y = gated_pair(w.y, gate.y);
        }
        *reinterpret_cast<uint2*>(a.out16 + o + 8 * j + col) = w;
      }
    }
  }
}

template <int BN, int OUT>
__global__ void __launch_bounds__(FS_THREADS, 1)
    gram_fs_kernel(const FsArgs a, const __grid_constant__ CUtensorMap map_f,
                   const __grid_constant__ CUtensorMap map_s) {
  constexpr int NB = BN / 64, STAGE = FS_A + NB * FS_B;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t base = (st::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + a.stages * STAGE, empty = full + 8 * FS_MAX_STAGES;
  const uint32_t turn = empty + 8 * FS_MAX_STAGES;
  const int ntiles = (a.tiles - 1 - blockIdx.x) / gridDim.x + 1;  // the grid has <= a.tiles blocks

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      st::mbar_init(full + 8 * s, 1);
      st::mbar_init(empty + 8 * s, 4);  // one warpgroup's four warps
    }
    for (int w = 0; w < FS_NWG; ++w) st::mbar_init(turn + 8 * w, 4);  // the other warpgroup's warps
    st::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= FS_LOADER_WARP) {
    st::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != FS_LOADER_WARP || lane != 0) return;
    int s = 0, g = 0;
    uint32_t phase = 0;
    for (int i = 0; i < ntiles; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int m0 = (tile / a.tiles_n) * FS_BM, n0 = (tile % a.tiles_n) * BN;
      for (int c = 0; c < a.nchunks; ++c, ++g) {
        if (g >= a.stages) st::mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t stage = base + s * STAGE, bar = full + 8 * s;
        st::mbar_arrive_expect_tx(bar, STAGE);
        st::tma_load_2d(stage, &map_f, bar, 64 * c, m0);
#pragma unroll
        for (int hb = 0; hb < NB; ++hb) {
          st::tma_load_2d(stage + FS_A + hb * FS_B, &map_s, bar, n0 + 64 * hb, 64 * c);
        }
        if (++s == a.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    st::setmaxnreg_inc<CONSUMER_REGS>();
    fs_consume<BN, OUT>(a, base, full, empty, turn, ntiles, warp >> 2, warp & 3, lane);
  }
}

// The tensor map of a row-major (rows, c) bf16 matrix as (c, rows) in boxes
// of 64 channels x box_rows rows, in the 128-byte swizzle, into *map; false
// where it cannot be made. Each host thread keeps the last MAP_CACHE maps it
// made: a step launches the same shapes at the same addresses (PyTorch's
// caching allocator hands them back), and the encoding costs microseconds
// of host time, while a map depends on nothing but its key. The map is
// copied out: the next call may reuse its entry.
constexpr int MAP_CACHE = 32;

bool row_map(CUtensorMap* map, const void* ptr, int rows, int c, int box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int rows, c, box_rows;
  };
  thread_local Entry cache[MAP_CACHE] = {};
  thread_local int next = 0;
  for (const Entry& e : cache) {
    if (e.ptr == ptr && e.rows == rows && e.c == c && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  const st::EncodeTiled encode = st::encode_tiled();
  if (encode == nullptr) return false;
  Entry& e = cache[next];
  next = (next + 1) % MAP_CACHE;
  const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)c * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  e.ptr = nullptr;
  const CUresult made =
      encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (made != CUDA_SUCCESS) return false;
  e.ptr = ptr;
  e.rows = rows;
  e.c = c;
  e.box_rows = box_rows;
  *map = e.map;
  return true;
}

// Sets a kernel's dynamic shared memory to SMEM once per device.
template <class K>
int configure(K kernel, bool* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= st::MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  return 0;
}

template <int BT, bool WIN>
int launch_gram(const GramArgs& a, const CUtensorMap& map_f, float* part, float* out, int grid,
                cudaStream_t stream) {
  static bool configured[st::MAX_DEVICES] = {};
  const int err = configure(gram_kernel<BT, WIN>, configured);
  if (err) return err;
  gram_kernel<BT, WIN><<<grid, 128 * (BT / 64) + 32, SMEM, stream>>>(a, map_f, part, out);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int OUT>
int launch_fs(const FsArgs& a, const CUtensorMap& map_f, const CUtensorMap& map_s, int grid,
              cudaStream_t stream) {
  static bool configured[st::MAX_DEVICES] = {};
  const int err = configure(gram_fs_kernel<BN, OUT>, configured);
  if (err) return err;
  gram_fs_kernel<BN, OUT><<<grid, FS_THREADS, SMEM, stream>>>(a, map_f, map_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (rows of an F^T F step, rows of an F S tile) into out[0..1]; the
// launcher's constants are held against it.
ST_EXPORT int st_gram_info(int* out) {
  out[0] = GR;
  out[1] = FS_BM;
  return 0;
}

// out (C, C) fp32 = F^T F for F (M, C) bf16 over the rows in the column
// window (wcols = 0: all rows), on bt x bt tiles (bt = 64 or 128 dividing
// C): with chunks = 0, `grid` blocks (at most the (tile, 64-row step) pairs)
// split the pairs (stream-K); else the rows are cut into `chunks` chunks of
// one step or more and grid must be chunks x tiles (tiles = T (T + 1) / 2, T
// = C / bt), a block a tile of a chunk. part holds grid x bt x bt fp32 of
// scratch.
ST_EXPORT int st_gram(const void* f, void* part, void* out, int M, int C, int bt, int grid,
                      int chunks, int wcols, int clo, int chi, void* stream) {
  if ((bt != 64 && bt != 128) || C % bt || M <= 0 || grid <= 0 || chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GramArgs a = {};
  a.M = M; a.C = C; a.bt = bt; a.T = C / bt;
  a.steps = (M + GR - 1) / GR;
  a.work = (long long)(a.T * (a.T + 1) / 2) * a.steps;
  a.chunks = chunks;
  a.tiles = a.T * (a.T + 1) / 2;
  if (chunks ? grid != chunks * a.tiles || a.steps < chunks : grid > a.work) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.stage_bytes = (a.T == 1 ? 1 : 2) * (bt / 64) * BOX;  // one tile: always diagonal, one slab
  a.stages = (SMEM - 1024 - 16 * GRAM_MAX_STAGES) / a.stage_bytes;
  if (a.stages > GRAM_MAX_STAGES) a.stages = GRAM_MAX_STAGES;
  a.win = Window{wcols, clo, chi};
  CUtensorMap map_f;
  if (!row_map(&map_f, f, M, C, GR)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *p = static_cast<float*>(part), *o = static_cast<float*>(out);
  const bool win = wcols > 0;
  int err = bt == 64 ? (win ? launch_gram<64, true>(a, map_f, p, o, grid, s)
                            : launch_gram<64, false>(a, map_f, p, o, grid, s))
                     : (win ? launch_gram<128, true>(a, map_f, p, o, grid, s)
                            : launch_gram<128, false>(a, map_f, p, o, grid, s));
  if (err) return err;
  // pieces a tile, about grid / tiles: 44 and more at 64-256 channels, 13 at
  // 512, at most 5 from 1024
  const int blocks64 = (C / 64) * (C / 64 + 1) / 2;
  if (grid >= 32 * a.tiles) {
    gram_reduce_rows<1><<<dim3(blocks64, 64), 256, 0, s>>>(p, o, a, grid);
  } else if (grid >= 8 * a.tiles) {
    gram_reduce_rows<8><<<dim3(blocks64, 8), 256, 0, s>>>(p, o, a, grid);
  } else {
    gram_reduce_blocks<<<blocks64, 256, 0, s>>>(p, o, a, grid);
  }
  return static_cast<int>(cudaGetLastError());
}

// F (M, C) bf16 times S (C, C) bf16 on 128-row x bn-column tiles (bn = 64 or
// 128 dividing C): fp32 into out32, or, when out16 is not null, the bf16
// result into out16, ReLU-gated by F > 0 when `gated`. Rows outside the
// column window (wcols = 0: none) are zero.
ST_EXPORT int st_gram_fs(const void* f, const void* s, void* out32, void* out16, int gated, int M,
                         int C, int bn, int wcols, int clo, int chi, void* stream) {
  if ((bn != 64 && bn != 128) || C % bn || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= st::MAX_DEVICES || st::sm_count(dev) == 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  FsArgs a = {};
  a.f = static_cast<const bf16*>(f);
  a.out32 = static_cast<float*>(out32);
  a.out16 = static_cast<bf16*>(out16);
  a.M = M; a.C = C; a.nchunks = C / 64; a.tiles_n = C / bn;
  a.tiles = ((M + FS_BM - 1) / FS_BM) * a.tiles_n;
  a.stages = (SMEM - 1024 - 8 * (2 * FS_MAX_STAGES + FS_NWG)) / (FS_A + (bn / 64) * FS_B);
  if (a.stages > FS_MAX_STAGES) a.stages = FS_MAX_STAGES;
  a.win = Window{wcols, clo, chi};
  CUtensorMap map_f, map_s;
  if (!row_map(&map_f, f, M, C, FS_BM) || !row_map(&map_s, s, C, C, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = a.tiles < st::sm_count(dev) ? a.tiles : st::sm_count(dev);
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const int out = out16 == nullptr ? OUT_F32 : gated ? OUT_GATED : OUT_BF16;
  if (bn == 128) {
    switch (out) {
      case OUT_F32: return launch_fs<128, OUT_F32>(a, map_f, map_s, grid, st_);
      case OUT_BF16: return launch_fs<128, OUT_BF16>(a, map_f, map_s, grid, st_);
      default: return launch_fs<128, OUT_GATED>(a, map_f, map_s, grid, st_);
    }
  }
  switch (out) {
    case OUT_F32: return launch_fs<64, OUT_F32>(a, map_f, map_s, grid, st_);
    case OUT_BF16: return launch_fs<64, OUT_BF16>(a, map_f, map_s, grid, st_);
    default: return launch_fs<64, OUT_GATED>(a, map_f, map_s, grid, st_);
  }
}
