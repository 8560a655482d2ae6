// VGG block 1 in one forward and one backward launch, on the tensor cores:
//   forward   [conv1_1 + bias + ReLU ->] r1 -> conv1_2 + bias + ReLU -> 2x2
//             mean pool -> pool1, the int8 ReLU mask of conv1_2, and the
//             unnormalized Gram r1^T r1 of the conv1_1 activation;
//   backward  unpool(d_pool) * 0.25, gated by the mask, rounded to bf16 ->
//             transposed conv1_2 -> + r1 S -> d_r1 ("tail"), or gated by
//             r1 > 0, rounded to bf16 and contracted with the 27 conv1_1 taps
//             into patch cotangents ("full"), which a small third kernel
//             gathers onto the image (col2im).
//
// Replaces the TPU kernels of style_transfer_tpu/ops/pallas/block1.py:
//   block1_tail  (_fwd_kernel / _bwd_kernel): starts from r1 in device memory;
//   block1_full  (_full_fwd_kernel / _full_bwd_kernel): starts from the
//                preprocessed 3-channel image, writes r1 once as the
//                backward's residual, and ends its backward in the 27-wide
//                product dpre1 @ k1f^T.
// The TPU kernels walk row tiles in order and carry the Gram in VMEM scratch;
// Hopper blocks run in no order, so a block owns a run of 16x16-pixel tiles,
// keeps its Gram sum in registers across them, writes one (64, 64) partial,
// and a second pass adds the partials in a fixed order (no atomics: the same
// bits from launch to launch). The reference's im2col of the image (an
// XLA-side (H, W, 27) tensor) exists only as a tile in shared memory.
//
// r1 outside the image is ZERO (conv1_2's SAME padding), not relu(b1 + conv
// of padding): the halo pixels that a tile computes beyond the image edge
// are forced to zero, and so are the pixels of a ragged tile beyond the
// edge, so they add nothing to the Gram either.
//
// Rounding points, as in the reference: r1 rounded to bf16 once (stored,
// convolved and summed into the Gram from the rounded value), fp32
// accumulation, fp32 biases, the pool taken on the fp32 ReLU output as
// ((y00 + y01) + (y10 + y11)) * 0.25; in the backward the gated unpooled
// cotangent (bf16; x0.25 is exact), S (bf16, cast by the wrapper), dpre1
// (bf16, from the fp32 sum of the nine taps and the Gram term) and the patch
// cotangents (bf16). Every product is bf16 x bf16 summed in fp32, so only
// the order of the sums differs from the plain version.
//
// What bounds it on the H100, per 1024x1024 call: operations and bytes at
// once. Forward 2*H*W*64*(576 + 64) = 85.9 GFLOP (conv1_2 and the Gram) plus
// conv1_1's 27-deep contraction (2*H*W*27*64 = 3.6 GFLOP; the kernel
// computes it 32 deep on the haloed tile, 5.4 GFLOP); backward the same
// 576 + 64 (the Gram term r1 S rides as a tenth tap) plus, for "full", the
// 27-wide product (3.6 GFLOP, computed 32 wide): 172 to 179 GFLOP, 0.17 to
// 0.18 ms at 989 TFLOP/s. Device-memory traffic of "tail": forward reads r1
// 134 MB, writes mask 67 + pool 34; backward reads d_pool 34 + mask 67 + r1
// 134, writes d_r1 134: 604 MB, 0.18 ms at 3.35 TB/s ("full": r1 written and
// read once, 57 MB of patch cotangents written and read: 0.15 ms). So the
// loads must hide behind the MMAs and nothing may go through device memory
// twice.
//
// The design: one persistent block of 8 warps per SM.
// - Instruction: mma.sync.aligned.m16n8k16 (bf16 x bf16 -> fp32) with
//   operands from shared memory through ldmatrix, as in conv3x3.cu. For the
//   convs the warps lie 4 x 2 over 256 pixels x 64 channels: a warp owns 4
//   m16 tiles (each a 2 x 8 pixel patch, so a pool window is two rows of one
//   thread and a lane 4 away) x 4 n8 tiles, 64 fp32 accumulators a thread.
// - Operands in bf16 in shared memory, every row (a pixel's 64 channels, a
//   tap's 64 output channels) padded from 128 to 144 bytes, so the eight
//   rows of an 8x8 ldmatrix fall into eight different 16-byte bank groups. A
//   tap is a constant added to a tile's row addresses.
// - All nine conv1_2 taps stay resident (82,944 bytes), loaded once per
//   block by cp.async; so do S and the conv1_1 taps (one (32, 64) array,
//   rows 27..31 zero: [k][n] for the forward through ldmatrix.trans, and the
//   same bytes as [n][k] for the backward's 27-wide product).
// - Persistent blocks in forward and backward: block b walks tiles
//   b * tiles_per_block ... and starts the next tile's loads before the
//   current tile's MMAs. "tail" forward: the haloed r1 tile (18 x 18 pixels)
//   by cp.async into the other of two buffers. "full" forward: the image
//   tile with a two-pixel halo by 4-byte cp.async; the block lays its 27-wide
//   patches out in shared memory (padded to 32), multiplies by the resident
//   taps (two k16 steps), adds the fp32 bias, applies ReLU, rounds once,
//   forces zero outside the image and writes the result straight into the
//   r1 tile (and its own pixels to device memory as the residual).
// - The Gram r1^T r1 over the tile's own pixels is MMAs on the same buffer:
//   both operands by ldmatrix.trans from the [pixel][channel] tile; each
//   warp keeps a 16 x 32 piece of the 64 x 64 sum (16 registers a thread)
//   across the block's run of tiles.
// - Backward: the gated unpooled cotangent needs arithmetic, so it is staged
//   through registers one tile ahead, two 8-channel groups a thread per tap:
//   the loads are started before a tap's MMAs and rounded, gated and stored
//   into the other buffer after them. r1 (own pixels only) comes by cp.async;
//   the Gram term is multiplied first, so that its buffer is free for the
//   next tile's copy while the nine taps run. "full" keeps the r1 > 0 gate
//   as 64 bits a thread, writes dpre1 over the consumed cotangent tile and
//   multiplies it by the conv1_1 taps (4 n8 columns per m16 tile).
// - The epilogues work on the accumulator fragments: no fp32 staging tile.
//   The four lanes of a quad trade columns (a 4 x 4 transpose in three
//   shuffles), so that the mask, the pool and d_r1 leave as 8- and 16-byte
//   stores, a pixel's 32 channels as one run.
// No wgmma and no TMA in this version. Tried on the card and dropped:
// stacking a warp's four m16 tiles so that they share haloed rows (ten row
// loads per three taps put together into A fragments, 132 ldmatrix a tile
// instead of 216) was 19% slower: the batch of loads ahead of 96 MMAs
// overlaps worse than a load per tile and tap, and the loop is not bound by
// shared-memory bandwidth. Building the next tile's patches between the
// first taps (image tile double-buffered, one barrier fewer) gained 2% of
// the "full" forward, and staging the patch cotangents through per-warp
// strips for 96-byte runs of stores gained nothing: both left out.
//
// Index widths: tiles (H/16) * (W/16) < 2^31, 3 * W < 2^31, every element
// offset in size_t (r1 at 512x8192 has 268 M elements). No grid dimension
// depends on the image.
#include "common.cuh"

namespace {

constexpr int TH = 16, TW = 16;          // output pixels per tile
constexpr int C = 64;                    // channels of block 1
constexpr int NT = 256;                  // threads per block: 8 warps, 4 (pixels) x 2 (channels)
constexpr int MAX_BLOCKS = 132;          // one persistent block per SM of the H100
constexpr int IH = TH + 2, IW = TW + 2;  // r1 / cotangent tile with its 1-pixel halo
constexpr int NPIX = IH * IW;            // 324
constexpr int OWN = TH * TW;             // 256
constexpr int ROW = C + 8;               // bf16 per padded row
constexpr int ROWB = ROW * 2;            // 144 bytes
constexpr int K1 = 32;                   // conv1_1 contraction depth, 27 padded to 32
constexpr int XH = TH + 4, XW = TW + 4;  // image tile with its 2-pixel halo
constexpr int XWORDS = XW * 3 / 2;       // 4-byte words per image tile row (30)
constexpr int XROWB = 128;               // bytes per staged image row (120 used)
constexpr int PROWS = 336;               // patch rows: NPIX rounded up to m16 tiles
constexpr int PROWB = (K1 + 8) * 2;      // 80 bytes per patch row: conflict-free ldmatrix

constexpr int W2_BYTES = 9 * C * ROWB;   // 82,944
constexpr int R_BYTES = NPIX * ROWB;     // 46,656
constexpr int S_BYTES = C * ROWB;        // 9,216
constexpr int RR_BYTES = OWN * ROWB;     // 36,864
constexpr int K1_BYTES = K1 * ROWB;      // 4,608
constexpr int X_BYTES = XH * XROWB;      // 2,560
constexpr int P_BYTES = PROWS * PROWB;   // 26,880
constexpr int B1_BYTES = C * 4;

// forward: [taps][r1 tile][r1 tile (tail: second buffer)]
//          [taps][r1 tile][patches][conv1_1 taps][image tile][b1]  (full)
constexpr int FWD_TAIL_SMEM = W2_BYTES + 2 * R_BYTES;
constexpr int FWD_FULL_SMEM = W2_BYTES + R_BYTES + P_BYTES + K1_BYTES + X_BYTES + B1_BYTES;
// backward: [taps][S][cotangent tile x 2][r1 own pixels][conv1_1 taps (full)]
constexpr int BWD_TAIL_SMEM = W2_BYTES + S_BYTES + 2 * R_BYTES + RR_BYTES;
constexpr int BWD_FULL_SMEM = BWD_TAIL_SMEM + K1_BYTES;
static_assert(BWD_FULL_SMEM <= 232448, "a block may use 227 KB of shared memory");
static_assert(RR_BYTES <= R_BYTES, "dpre1 is written over a consumed cotangent tile");

struct FwdArgs {
  const bf16* x;      // full: (H, W, 3) preprocessed image
  const bf16* r1_in;  // tail: (H, W, 64) conv1_1 activation
  const bf16* k1;     // full: (32, 64) conv1_1 taps, (dy, dx, ci) major, rows 27..31 zero
  const float* b1;    // full: (64)
  const bf16* k2;     // (3, 3, 64, 64) conv1_2 taps, HWIO
  const float* b2;    // (64)
  bf16* r1_out;       // full: (H, W, 64), the backward's residual
  int8_t* mask;       // (H, W, 64) conv1_2 pre-activation > 0
  bf16* pool;         // (H/2, W/2, 64)
  float* part;        // (gridDim.x, 64, 64) Gram partials
  int H, W, tiles_x, ntiles, tiles_per_block;
};

struct BwdArgs {
  const bf16* d_pool;  // (H/2, W/2, 64)
  const int8_t* mask;  // (H, W, 64)
  const bf16* r1;      // (H, W, 64)
  const bf16* s;       // (64, 64) S = (dG + dG^T) / (H*W)
  const bf16* k2t;     // (3, 3, 64, 64) flipped taps, [tap][out channel][in channel]
  const bf16* k1;      // full: (32, 64), as in the forward
  bf16* out;           // tail: d_r1 (H, W, 64); full: patch cotangents (9, H, W, 3)
  int H, W, tiles_x, ntiles, tiles_per_block;
};

// `rows` rows of 64 bf16, contiguous in device memory, into padded rows.
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int rows, int tid) {
  for (int e = tid; e < rows * 8; e += NT) {
    const int row = e >> 3, c8 = e & 7;
    st::cp_async16(dst + row * ROWB + c8 * 16, src + row * C + c8 * 8, true);
  }
}

// The 64-channel tile at (h0 - halo, w0 - halo), TH + 2 halo rows by
// TW + 2 halo columns, zero outside the image.
template <int HALO>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, int H, int W, int h0,
                                          int w0, int tid) {
  constexpr int TWH = TW + 2 * HALO, N = (TH + 2 * HALO) * TWH;
  for (int e = tid; e < N * 8; e += NT) {
    const int pix = e >> 3, c8 = e & 7;
    const int r = pix / TWH, c = pix - r * TWH;
    const int h = h0 + r - HALO, w = w0 + c - HALO;
    const bool valid = h >= 0 && h < H && w >= 0 && w < W;
    const bf16* p = valid ? src + ((size_t)h * W + w) * C + c8 * 8 : src;
    st::cp_async16(dst + pix * ROWB + c8 * 16, p, valid);
  }
}

// Byte offsets of this lane's ldmatrix rows: the A rows of the warp's four
// m16 tiles (2 x 8 pixel patches) in a tile whose pixel rows are `pitch`
// pixels apart, at tap (0, 0) ...
__device__ __forceinline__ void a_offsets(uint32_t (&a_off)[4], int wm, int lane, int pitch) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mt = wm * 4 + i, ty = mt >> 1, tx = mt & 1;
    const int r = lane & 15, py = 2 * ty + (r >> 3), px = 8 * tx + (r & 7);
    a_off[i] = ((py * pitch + px) * ROW + (lane >> 4) * 8) * 2;
  }
}

// ... and the B rows of a [k][n] array (n contiguous) read with .trans: k
// row lane % 16, n8 tile pair at column `n0`.
__device__ __forceinline__ uint32_t b_offset(int lane, int n0) {
  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  return (krow * ROW + n0 + (lane >> 4) * 8) * 2;
}

// acc += A (the warp's 4 m16 tiles at `a_base + a_off`, 64 deep) x B (64 rows
// at `b_base`, the warp's 32 columns).
__device__ __forceinline__ void mma_k64(float (&acc)[4][4][4], uint32_t a_base,
                                        const uint32_t (&a_off)[4], uint32_t b_base) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t bfr[4][2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t r[4];
      st::ldmatrix_x4_trans(b_base + (ks * 16 * ROW + jp * 16) * 2, r);
      bfr[2 * jp][0] = r[0]; bfr[2 * jp][1] = r[1];
      bfr[2 * jp + 1][0] = r[2]; bfr[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t af[4];
      st::ldmatrix_x4(a_base + a_off[i] + ks * 32, af);
#pragma unroll
      for (int j = 0; j < 4; ++j) st::mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3, int k) {
  return k == 0 ? v0 : k == 1 ? v1 : k == 2 ? v2 : v3;
}

// The four lanes of a quad (same lane / 4) each hold, for n8 tiles j = 0..3,
// one 32-bit value of columns 2 t4, 2 t4 + 1 (the accumulator layout). A
// 4 x 4 transpose in three exchanges gives lane t4 the whole of n8 tile t4:
// four values in column order, 16 contiguous bytes of bf16 instead of four
// scattered 4-byte pieces, so a quad stores one pixel's 32 channels as one
// 64-byte run.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int t4) {
  const uint32_t own = pick4(v[0], v[1], v[2], v[3], t4);
  // lane t4 ^ r wants this lane's tile t4 ^ r, and sends its tile t4
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], t4 ^ 1), 1);
  const uint32_t r2 = __shfl_xor_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], t4 ^ 2), 2);
  const uint32_t r3 = __shfl_xor_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], t4 ^ 3), 3);
  // position p holds the columns of lane p = t4 ^ r
  return make_uint4(pick4(own, r1, r2, r3, t4), pick4(own, r1, r2, r3, t4 ^ 1),
                    pick4(own, r1, r2, r3, t4 ^ 2), pick4(own, r1, r2, r3, t4 ^ 3));
}

template <bool FULL>
__global__ void __launch_bounds__(NT, 1) block1_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t4 = lane & 3;
  const uint32_t w2_s = st::smem_u32(smem);
  const uint32_t r_s = w2_s + W2_BYTES;
  unsigned char* r_g = smem + W2_BYTES;
  const uint32_t p_s = r_s + R_BYTES, k1_s = p_s + P_BYTES, x_s = k1_s + K1_BYTES;
  unsigned char* p_g = r_g + R_BYTES;
  unsigned char* x_g = p_g + P_BYTES + K1_BYTES;
  float* b1_g = reinterpret_cast<float*>(x_g + X_BYTES);

  const int t_begin = blockIdx.x * a.tiles_per_block;
  const int t_end = min(a.ntiles, t_begin + a.tiles_per_block);

  // the image tile of tile t with its two-pixel halo, as 4-byte words of the
  // row's (w, ci) elements: W is even and tile origins are multiples of 16,
  // so a word lies wholly inside or outside the image
  auto copy_image = [&](int t) {
    const int h0 = (t / a.tiles_x) * TH, w0 = (t % a.tiles_x) * TW;
    for (int e = tid; e < XH * XWORDS; e += NT) {
      const int row = e / XWORDS, q = e - row * XWORDS;
      const int h = h0 + row - 2;
      const long long el = (long long)(w0 - 2) * 3 + 2 * q;
      const bool valid = h >= 0 && h < a.H && el >= 0 && el < 3LL * a.W;
      const bf16* p = valid ? a.x + (size_t)h * a.W * 3 + el : a.x;
      st::cp_async4(x_s + row * XROWB + q * 4, p, valid);
    }
  };

  copy_rows(w2_s, a.k2, 9 * C, tid);
  if (FULL) {
    copy_rows(k1_s, a.k1, K1, tid);
    if (tid < C) b1_g[tid] = a.b1[tid];
    // the patches' padding (columns 27.., rows 324..) stays zero throughout
    for (int e = tid; e < P_BYTES / 16; e += NT) {
      reinterpret_cast<uint4*>(p_g)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (t_begin < t_end) copy_image(t_begin);
  } else if (t_begin < t_end) {
    copy_tile<1>(r_s, a.r1_in, a.H, a.W, (t_begin / a.tiles_x) * TH, (t_begin % a.tiles_x) * TW,
                 tid);
  }
  st::cp_async_commit();

  uint32_t a_off[4];
  a_offsets(a_off, wm, lane, IW);
  const uint32_t b_off = b_offset(lane, wn * 32);
  float b2v[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b2v[j][0] = a.b2[wn * 32 + j * 8 + 2 * t4];
    b2v[j][1] = a.b2[wn * 32 + j * 8 + 2 * t4 + 1];
  }
  // this warp's piece of the Gram: rows 16 gm .. + 15, columns 32 gn .. + 31
  const int gm = warp & 3, gn = warp >> 2;
  float gacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) gacc[j][c] = 0.f;
  const uint32_t ga_off = ((((lane >> 4) * 8 + (lane & 7)) * ROW) + gm * 16 + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t gb_off = b_offset(lane, gn * 32);

  for (int t = t_begin; t < t_end; ++t) {
    const int h0 = (t / a.tiles_x) * TH, w0 = (t % a.tiles_x) * TW;
    const int buf = FULL ? 0 : (t - t_begin) & 1;
    const uint32_t rb = r_s + buf * R_BYTES;

    st::cp_async_wait<0>();
    __syncthreads();  // this tile's loads have landed; the previous tile is consumed
    if (!FULL) {
      if (t + 1 < t_end) {
        copy_tile<1>(r_s + (buf ^ 1) * R_BYTES, a.r1_in, a.H, a.W, ((t + 1) / a.tiles_x) * TH,
                     ((t + 1) % a.tiles_x) * TW, tid);
      }
      st::cp_async_commit();
    } else {
      // patches of the haloed r1 tile: row pix holds, for each dy, the nine
      // consecutive (dx, ci) elements of image row r + dy from column c on
      const bf16* xs = reinterpret_cast<const bf16*>(x_g);
      bf16* ps = reinterpret_cast<bf16*>(p_g);
      for (int e = tid; e < NPIX * 3; e += NT) {
        const int pix = e / 3, dy = e - pix * 3;
        const int r = pix / IW, c = pix - r * IW;
        const bf16* src = xs + (r + dy) * (XROWB / 2) + 3 * c;
        bf16* dst = ps + pix * (PROWB / 2) + 9 * dy;
#pragma unroll
        for (int j = 0; j < 9; ++j) dst[j] = src[j];
      }
      __syncthreads();
      if (t + 1 < t_end) copy_image(t + 1);
      st::cp_async_commit();

      // conv1_1: patches (336 x 32) x taps (32 x 64) -> r1 tile
      for (int mt = warp; mt < PROWS / 16; mt += NT / 32) {
        float c1[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) c1[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < K1 / 16; ++ks) {
          uint32_t af[4];
          st::ldmatrix_x4(p_s + (mt * 16 + (lane & 15)) * PROWB + (ks * 16 + (lane >> 4) * 8) * 2, af);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t r[4];
            st::ldmatrix_x4_trans(k1_s + b_offset(lane, jp * 16) + ks * 16 * ROWB, r);
            st::mma_bf16(c1[2 * jp], af, r[0], r[1]);
            st::mma_bf16(c1[2 * jp + 1], af, r[2], r[3]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pix = mt * 16 + g + 8 * half;
          if (pix >= NPIX) continue;
          const int r = pix / IW, c = pix - r * IW;
          const int h = h0 + r - 1, w = w0 + c - 1;
          const bool inside = h >= 0 && h < a.H && w >= 0 && w < a.W;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = j * 8 + 2 * t4;
            const float v0 = inside ? fmaxf(c1[j][2 * half] + b1_g[n], 0.f) : 0.f;
            const float v1 = inside ? fmaxf(c1[j][2 * half + 1] + b1_g[n + 1], 0.f) : 0.f;
            *reinterpret_cast<uint32_t*>(r_g + pix * ROWB + n * 2) = pack2(v0, v1);
          }
        }
      }
      __syncthreads();
      // the tile's own pixels to device memory, 16 bytes a thread
      for (int e = tid; e < OWN * 8; e += NT) {
        const int p = e >> 3, c8 = e & 7;
        const int py = p / TW, px = p - py * TW;
        const int h = h0 + py, w = w0 + px;
        if (h < a.H && w < a.W) {
          *reinterpret_cast<uint4*>(a.r1_out + ((size_t)h * a.W + w) * C + c8 * 8) =
              *reinterpret_cast<const uint4*>(r_g + ((py + 1) * IW + px + 1) * ROWB + c8 * 16);
        }
      }
    }

    // ---- conv1_2: nine taps, 64 deep each, from the tile in shared memory
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      mma_k64(acc, rb + ((tap / 3) * IW + tap % 3) * ROWB, a_off, w2_s + b_off + tap * C * ROWB);
    }

    // ---- the tile's share of r1^T r1 (its own pixels only, not the halo)
#pragma unroll 4
    for (int py = 0; py < TH; ++py) {
      const uint32_t row = rb + ((py + 1) * IW + 1) * ROWB;
      uint32_t af[4];
      st::ldmatrix_x4_trans(row + ga_off, af);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        st::ldmatrix_x4_trans(row + gb_off + jp * 32, r);
        st::mma_bf16(gacc[2 * jp], af, r[0], r[1]);
        st::mma_bf16(gacc[2 * jp + 1], af, r[2], r[3]);
      }
    }

    // ---- bias, mask, ReLU, 2x2 mean pool, from the fragments: rows g and
    // g + 8 of an m16 tile are pixels (2 ty, 8 tx + g) and (2 ty + 1, ...),
    // so a pool window is c0/c2 of this lane and of the lane 4 away. The
    // quad then trades columns, so that a lane stores 8 channels at once.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mt = wm * 4 + i, ty = mt >> 1, tx = mt & 1;
      const int h = h0 + 2 * ty, w = w0 + 8 * tx + g;
      const bool valid = h < a.H && w < a.W;  // H and W even: both rows of the window or none
      uint32_t mk[4], pl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = acc[i][j][0] + b2v[j][0], p1 = acc[i][j][1] + b2v[j][1];
        const float p2 = acc[i][j][2] + b2v[j][0], p3 = acc[i][j][3] + b2v[j][1];
        const float y0 = fmaxf(p0, 0.f), y1 = fmaxf(p1, 0.f);
        const float y2 = fmaxf(p2, 0.f), y3 = fmaxf(p3, 0.f);
        const float s0 = (y0 + __shfl_xor_sync(0xffffffffu, y0, 4)) +
                         (y2 + __shfl_xor_sync(0xffffffffu, y2, 4));
        const float s1 = (y1 + __shfl_xor_sync(0xffffffffu, y1, 4)) +
                         (y3 + __shfl_xor_sync(0xffffffffu, y3, 4));
        // mask bytes: the top row's pair below the bottom row's
        mk[j] = (p0 > 0.f) | ((p1 > 0.f) << 8) | ((p2 > 0.f) << 16) | ((p3 > 0.f) << 24);
        pl[j] = pack2(s0 * 0.25f, s1 * 0.25f);
      }
      const uint4 m = quad_transpose(mk, t4);
      const uint4 p = quad_transpose(pl, t4);
      if (valid) {
        const int n = wn * 32 + t4 * 8;
        int8_t* o = a.mask + ((size_t)h * a.W + w) * C + n;
        *reinterpret_cast<uint2*>(o) =
            make_uint2(__byte_perm(m.x, m.y, 0x5410), __byte_perm(m.z, m.w, 0x5410));
        *reinterpret_cast<uint2*>(o + (size_t)a.W * C) =
            make_uint2(__byte_perm(m.x, m.y, 0x7632), __byte_perm(m.z, m.w, 0x7632));
        // both lanes of a window hold its sum: the even column's stores it
        if ((g & 1) == 0) {
          *reinterpret_cast<uint4*>(a.pool + ((size_t)(h >> 1) * (a.W >> 1) + (w >> 1)) * C + n) = p;
        }
      }
    }
  }

  st::cp_async_wait<0>();  // a block without tiles still waits for its taps
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* dst = a.part + ((size_t)blockIdx.x * C + gm * 16 + g) * C + gn * 32 + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(dst) = make_float2(gacc[j][0], gacc[j][1]);
    *reinterpret_cast<float2*>(dst + 8 * C) = make_float2(gacc[j][2], gacc[j][3]);
  }
}

__global__ void block1_gram_reduce_kernel(const float* __restrict__ part,
                                          float* __restrict__ out, int nparts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * C) return;
  float s = 0.f;
  for (int z = 0; z < nparts; ++z) s += part[(size_t)z * C * C + e];
  out[e] = s;
}

// One 8-channel group of the gated unpooled cotangent, in flight between
// its loads and its store into the next tile's buffer.
struct Staged {
  uint4 d;  // d_pool, 8 bf16
  uint2 m;  // mask, 8 int8 (zero outside the image)
};

template <bool FULL>
__global__ void __launch_bounds__(NT, 1) block1_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t4 = lane & 3;
  const uint32_t w2_s = st::smem_u32(smem);
  const uint32_t s_s = w2_s + W2_BYTES, d_s = s_s + S_BYTES, rr_s = d_s + 2 * R_BYTES;
  const uint32_t k1_s = rr_s + RR_BYTES;
  unsigned char* d_g = smem + W2_BYTES + S_BYTES;
  unsigned char* rr_g = d_g + 2 * R_BYTES;

  const int t_begin = blockIdx.x * a.tiles_per_block;
  const int t_end = min(a.ntiles, t_begin + a.tiles_per_block);
  if (t_begin >= t_end) return;

  // group u of this thread: 8 channels of haloed pixel (tid + u * NT) / 8
  constexpr int UNITS = (NPIX * 8 + NT - 1) / NT;  // 11
  auto stage_load = [&](int u, int h0, int w0) {
    Staged v;
    v.d = make_uint4(0u, 0u, 0u, 0u);
    v.m = make_uint2(0u, 0u);
    const int e = tid + u * NT;
    const int pix = e >> 3, c8 = e & 7;
    const int r = pix / IW, c = pix - r * IW;
    const int h = h0 + r - 1, w = w0 + c - 1;
    if (pix < NPIX && h >= 0 && h < a.H && w >= 0 && w < a.W) {
      v.d = *reinterpret_cast<const uint4*>(
          a.d_pool + ((size_t)(h >> 1) * (a.W >> 1) + (w >> 1)) * C + c8 * 8);
      v.m = *reinterpret_cast<const uint2*>(a.mask + ((size_t)h * a.W + w) * C + c8 * 8);
    }
    return v;
  };
  // da2 = bf16(0.25 * unpool(d_pool) * mask), zero outside the image
  auto stage_store = [&](int u, const Staged& v, unsigned char* dst) {
    const int e = tid + u * NT;
    if (e >= NPIX * 8) return;
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&v.d);
    const int8_t* m = reinterpret_cast<const int8_t*>(&v.m);
    float f[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 d2 = __bfloat1622float2(dp[j]);
      f[2 * j] = m[2 * j] ? d2.x * 0.25f : 0.f;
      f[2 * j + 1] = m[2 * j + 1] ? d2.y * 0.25f : 0.f;
    }
    *reinterpret_cast<uint4*>(dst + (e >> 3) * ROWB + (e & 7) * 16) = st::pack8_bf16(f);
  };

  {
    const int h0 = (t_begin / a.tiles_x) * TH, w0 = (t_begin % a.tiles_x) * TW;
    copy_rows(w2_s, a.k2t, 9 * C, tid);
    copy_rows(s_s, a.s, C, tid);
    if (FULL) copy_rows(k1_s, a.k1, K1, tid);
    copy_tile<0>(rr_s, a.r1, a.H, a.W, h0, w0, tid);
    st::cp_async_commit();
    for (int u = 0; u < UNITS; ++u) stage_store(u, stage_load(u, h0, w0), d_g);
  }

  uint32_t a_off[4], rr_off[4];
  a_offsets(a_off, wm, lane, IW);
  a_offsets(rr_off, wm, lane, TW);
  const uint32_t b_off = b_offset(lane, wn * 32);

  for (int t = t_begin; t < t_end; ++t) {
    const int h0 = (t / a.tiles_x) * TH, w0 = (t % a.tiles_x) * TW;
    const int buf = (t - t_begin) & 1;
    const bool has_next = t + 1 < t_end;
    const int nh0 = ((t + 1) / a.tiles_x) * TH, nw0 = ((t + 1) % a.tiles_x) * TW;
    const uint32_t db = d_s + buf * R_BYTES;
    unsigned char* d_next = d_g + (buf ^ 1) * R_BYTES;

    st::cp_async_wait<0>();
    __syncthreads();  // r1 has landed, the cotangent tile is staged, the previous tile is consumed

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

    // the Gram term r1 S first: a tenth tap on the same accumulators
    mma_k64(acc, rr_s, rr_off, s_s + b_off);
    // full: r1 > 0 at this thread's 64 outputs, bit (i * 4 + j) * 4 + c
    uint32_t gate[2] = {0u, 0u};
    if (FULL) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = wm * 4 + i, ty = mt >> 1, tx = mt & 1;
        const int p = (2 * ty) * TW + 8 * tx + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + j * 8 + 2 * t4;
          const float2 top = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(rr_g + p * ROWB + n * 2));
          const float2 bot = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(rr_g + (p + TW) * ROWB + n * 2));
          const uint32_t bits = (top.x > 0.f) | ((top.y > 0.f) << 1) | ((bot.x > 0.f) << 2) |
                                ((bot.y > 0.f) << 3);
          gate[i >> 1] |= bits << (((i & 1) * 4 + j) * 4);
        }
      }
    }
    __syncthreads();  // every warp is done with r1: the next tile's may come
    if (has_next) copy_tile<0>(rr_s, a.r1, a.H, a.W, nh0, nw0, tid);
    st::cp_async_commit();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      Staged v0, v1;
      const bool stage = has_next && 2 * tap < UNITS;
      if (stage) {
        v0 = stage_load(2 * tap, nh0, nw0);
        if (2 * tap + 1 < UNITS) v1 = stage_load(2 * tap + 1, nh0, nw0);
      }
      mma_k64(acc, db + ((tap / 3) * IW + tap % 3) * ROWB, a_off, w2_s + b_off + tap * C * ROWB);
      if (stage) {
        stage_store(2 * tap, v0, d_next);
        if (2 * tap + 1 < UNITS) stage_store(2 * tap + 1, v1, d_next);
      }
    }

    if (!FULL) {
      // block1_tail: d_r1, not gated (conv1_1's ReLU is upstream of this
      // kernel); the quad trades columns, so that a lane stores 8 channels
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = wm * 4 + i, ty = mt >> 1, tx = mt & 1;
        const int h = h0 + 2 * ty, w = w0 + 8 * tx + g;
        uint32_t top[4], bot[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          top[j] = pack2(acc[i][j][0], acc[i][j][1]);
          bot[j] = pack2(acc[i][j][2], acc[i][j][3]);
        }
        const uint4 vt = quad_transpose(top, t4), vb = quad_transpose(bot, t4);
        if (h < a.H && w < a.W) {
          bf16* o = a.out + ((size_t)h * a.W + w) * C + wn * 32 + t4 * 8;
          *reinterpret_cast<uint4*>(o) = vt;
          *reinterpret_cast<uint4*>(o + (size_t)a.W * C) = vb;
        }
      }
      continue;
    }

    // block1_full: dpre1 = bf16(r1 > 0 ? d_r1 : 0) over the consumed
    // cotangent tile as [own pixel][channel], then the 27-wide product
    __syncthreads();
    unsigned char* dp_g = d_g + buf * R_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mt = wm * 4 + i, ty = mt >> 1, tx = mt & 1;
      const int p = (2 * ty) * TW + 8 * tx + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + 2 * t4;
        const uint32_t bits = gate[i >> 1] >> (((i & 1) * 4 + j) * 4);
        *reinterpret_cast<uint32_t*>(dp_g + p * ROWB + n * 2) =
            pack2(bits & 1u ? acc[i][j][0] : 0.f, bits & 2u ? acc[i][j][1] : 0.f);
        *reinterpret_cast<uint32_t*>(dp_g + (p + TW) * ROWB + n * 2) =
            pack2(bits & 4u ? acc[i][j][2] : 0.f, bits & 8u ? acc[i][j][3] : 0.f);
      }
    }
    __syncthreads();

    // patch cotangents dpt[tap][h][w][ci] = sum_c dpre1[h][w][c] * k1[(tap, ci)][c]:
    // an m16 tile is one row of 16 pixels, the taps are [n][k] with k contiguous
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int py = warp * 2 + mi;
      float c3[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) c3[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4];
        st::ldmatrix_x4(db + ((py * TW + (lane & 15)) * ROW + ks * 16 + (lane >> 4) * 8) * 2, af);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          st::ldmatrix_x4(k1_s + ((jp * 16 + (lane >> 4) * 8 + (lane & 7)) * ROW + ks * 16 +
                                  ((lane >> 3) & 1) * 8) * 2, r);
          st::mma_bf16(c3[2 * jp], af, r[0], r[1]);
          st::mma_bf16(c3[2 * jp + 1], af, r[2], r[3]);
        }
      }
      const int h = h0 + py;
      if (h >= a.H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w0 + g + 8 * half;
        if (w >= a.W) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = j * 8 + 2 * t4 + e;
            if (n < 27) {
              a.out[(((size_t)(n / 3) * a.H + h) * a.W + w) * 3 + n % 3] =
                  __float2bfloat16_rn(c3[j][2 * half + e]);
            }
          }
      }
    }
  }
}

// col2im of block1_full's backward: the image cotangent (H, W, 3) from the
// tap-major patch cotangents (9, H, W, 3): dx[h][w] = sum over taps (dy, dx)
// of dpt[tap][h + 1 - dy][w + 1 - dx], summed in fp32 in tap order.
__global__ void block1_col2im_kernel(const bf16* __restrict__ dpt, bf16* __restrict__ out, int H,
                                     int W) {
  const size_t n = (size_t)H * W * 3;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int ci = static_cast<int>(e % 3);
    const size_t pix = e / 3;
    const int h = static_cast<int>(pix / W), w = static_cast<int>(pix % W);
    float s = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int hh = h + 1 - tap / 3, ww = w + 1 - tap % 3;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        s += __bfloat162float(dpt[(((size_t)tap * H + hh) * W + ww) * 3 + ci]);
      }
    }
    out[e] = __float2bfloat16_rn(s);
  }
}

int tiles_x(int W) { return (W + TW - 1) / TW; }
int tiles_y(int H) { return (H + TH - 1) / TH; }

int tiles_per_block(int H, int W) {
  const long long n = (long long)tiles_x(W) * tiles_y(H);
  return static_cast<int>((n + MAX_BLOCKS - 1) / MAX_BLOCKS);
}

int blocks(int H, int W) {
  const int n = tiles_x(W) * tiles_y(H), per = tiles_per_block(H, W);
  return (n + per - 1) / per;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *configured = err == cudaSuccess;
  return err;
}

template <bool FULL>
int launch_fwd(FwdArgs a, float* gram, cudaStream_t st) {
  static bool configured = false;
  constexpr int bytes = FULL ? FWD_FULL_SMEM : FWD_TAIL_SMEM;
  cudaError_t err = allow_smem(block1_fwd_kernel<FULL>, bytes, &configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = blocks(a.H, a.W);
  block1_fwd_kernel<FULL><<<nblocks, NT, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block1_gram_reduce_kernel<<<(C * C + 255) / 256, 256, 0, st>>>(a.part, gram, nblocks);
  return static_cast<int>(cudaGetLastError());
}

template <bool FULL>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  static bool configured = false;
  constexpr int bytes = FULL ? BWD_FULL_SMEM : BWD_TAIL_SMEM;
  const cudaError_t err = allow_smem(block1_bwd_kernel<FULL>, bytes, &configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  block1_bwd_kernel<FULL><<<blocks(a.H, a.W), NT, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gram partials of one forward for an (H, W) image: one per block. The
// wrapper sizes `part` as this many (64, 64) fp32 tiles.
ST_EXPORT int st_block1_partials(int H, int W) { return blocks(H, W); }

// (tile rows, tile columns, threads, most blocks, shared-memory bytes of the
// tail forward, the full forward, the tail backward, the full backward) into
// out[0..7]; the wrapper's model is held against it.
ST_EXPORT int st_block1_info(int* out) {
  out[0] = TH; out[1] = TW; out[2] = NT; out[3] = MAX_BLOCKS;
  out[4] = FWD_TAIL_SMEM; out[5] = FWD_FULL_SMEM; out[6] = BWD_TAIL_SMEM; out[7] = BWD_FULL_SMEM;
  return 0;
}

// Forward. x != null: block1_full from the (H, W, 3) bf16 image, with k1
// (32, 64) bf16 (the 27 taps, rows 27..31 zero), b1 (64) fp32, writing r1
// (H, W, 64) bf16. x == null: block1_tail, reading r1. Both: k2 (3, 3, 64,
// 64) bf16, b2 (64) fp32 -> mask (H, W, 64) int8, pool (H/2, W/2, 64) bf16,
// gram (64, 64) fp32 unnormalized, through `part`. H and W even.
ST_EXPORT int st_block1_fwd(const void* x, const void* k1, const void* b1, void* r1,
                            const void* k2, const void* b2, void* mask, void* pool, void* part,
                            void* gram, int H, int W, void* stream) {
  FwdArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.k1 = static_cast<const bf16*>(k1);
  a.b1 = static_cast<const float*>(b1);
  a.r1_in = static_cast<const bf16*>(r1);
  a.r1_out = static_cast<bf16*>(r1);
  a.k2 = static_cast<const bf16*>(k2);
  a.b2 = static_cast<const float*>(b2);
  a.mask = static_cast<int8_t*>(mask);
  a.pool = static_cast<bf16*>(pool);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.tiles_x = tiles_x(W);
  a.ntiles = a.tiles_x * tiles_y(H);
  a.tiles_per_block = tiles_per_block(H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x != nullptr ? launch_fwd<true>(a, static_cast<float*>(gram), st)
                      : launch_fwd<false>(a, static_cast<float*>(gram), st);
}

// Backward. k1 == null: block1_tail, out = d_r1 (H, W, 64) bf16. k1 != null:
// block1_full, out = patch cotangents (9, H, W, 3) bf16, tap-major, for
// st_block1_col2im. d_pool (H/2, W/2, 64) bf16, mask (H, W, 64) int8, r1
// (H, W, 64) bf16, s (64, 64) bf16, k2t the flipped transposed conv1_2 taps,
// k1 as in the forward.
ST_EXPORT int st_block1_bwd(const void* d_pool, const void* mask, const void* r1, const void* s,
                            const void* k2t, const void* k1, void* out, int H, int W,
                            void* stream) {
  BwdArgs a = {};
  a.d_pool = static_cast<const bf16*>(d_pool);
  a.mask = static_cast<const int8_t*>(mask);
  a.r1 = static_cast<const bf16*>(r1);
  a.s = static_cast<const bf16*>(s);
  a.k2t = static_cast<const bf16*>(k2t);
  a.k1 = static_cast<const bf16*>(k1);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.tiles_x = tiles_x(W);
  a.ntiles = a.tiles_x * tiles_y(H);
  a.tiles_per_block = tiles_per_block(H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k1 != nullptr ? launch_bwd<true>(a, st) : launch_bwd<false>(a, st);
}

// The image cotangent (H, W, 3) bf16 from the patch cotangents (9, H, W, 3).
ST_EXPORT int st_block1_col2im(const void* dpt, void* out, int H, int W, void* stream) {
  const size_t n = (size_t)H * W * 3;
  const int nblocks = static_cast<int>(n / 256 < 8 * MAX_BLOCKS ? n / 256 + 1 : 8 * MAX_BLOCKS);
  block1_col2im_kernel<<<nblocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dpt), static_cast<bf16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
