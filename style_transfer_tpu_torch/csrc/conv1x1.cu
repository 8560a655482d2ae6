// 1x1 convolution of NHWC bf16 tensors as a bf16 GEMM on Hopper's
// warpgroup MMA, with its epilogue fused: y = [gate >] [relu] (x W [+ bias]
// [+ add]), one bf16 rounding. ResNet-50's 1x1 convolutions (forward and
// backward-data), its stride-2 projection shortcuts, and, fed by the im2col
// of im2col.cu, its strided 3x3 and 7x7 convolutions and their
// backward-data products all run here.
//
// Replaces no TPU kernel: the JAX package runs VGG only. Added for
// ResNet-50 (models/resnet.py, ops/kernels/resnet.py).
//
// What bounds it on the H100. A 1x1 convolution is 2 K N FLOP a pixel
// against 2 (K + N) bytes of activations, plus the residual, added
// cotangent or gate that the epilogue reads: at 64-256 channels (ResNet's
// stem and stages 1-2) 20-102 FLOP a byte, far under the card's bf16 ridge
// of ~295, so most launches are bound by the memory's rate; stage 3 reads
// 171-205, stage 4 341-410. Under that load a read from memory takes
// microseconds, so the memory is only kept busy with many tiles' operands
// in flight at once, and nothing a thread waits on may sit in a tile's
// path: the next tiles' operands are loaded while a tile is multiplied and
// while its epilogue runs, and its output leaves while the next ones run.
//
// The design: a persistent, warp-specialised GEMM, one block of three
// warpgroups an SM.
// - Tiles. An output tile is 8 x 16 pixels (M = 128 rows of the GEMM) x BN
//   channels, BN = 64 or 128 (the launcher picks it: 64 where a 128-wide
//   tile would leave half its columns empty, or reads a gate). The tiles
//   are listed pixel tile by pixel tile, a pixel tile's N tiles next to
//   each other, and block b of G walks tiles b, b + G, b + 2G, ...: the
//   blocks working at one time cover whole pixel tiles, so an input read
//   for one N tile is read from L2 for the others. Where N is not a
//   multiple of 64, a block takes its pixel tiles' N tiles itself
//   (tile_at).
// - Two consumer warpgroups own whole tiles in turn (the block's even tiles
//   and its odd ones). Each multiplies its 128 x BN tile as two m64 halves
//   (wgmma.mma_async m64nBNk16, both operands from shared memory by
//   descriptor), then runs the tile's epilogue while the other warpgroup
//   multiplies the next tile; a warpgroup starts a tile's products once the
//   other has issued its tile's last (the `turn` barriers).
// - The producer warpgroup gives up its registers to the consumers
//   (setmaxnreg: 40 against 232 a thread) and runs three threads:
//   - the loader keeps a ring of stages full by TMA, running ahead across
//     tile boundaries: the input (A) and the weights (B) of each 64-channel
//     chunk of the reduction, a full and an empty mbarrier a stage;
//   - the epilogue loader brings each tile's extra operands (the residual
//     or added cotangent, the gate) into an epilogue slot by TMA, and its
//     bias by a bulk copy, as soon as the slot is free;
//   - the storer sends each finished tile out of its slot by TMA
//     (cp.async.bulk.tensor, shared -> global) and frees a slot once its
//     store has been read (bulk wait_group.read), keeping several stores in
//     flight; no consumer thread ever waits on a store.
// - A (the input) in the 128-byte swizzle, K-major: one 3-D TMA box (64
//   channels x 16 x 8 pixels) a chunk, each pixel one 128-byte row; a k16
//   step is a descriptor 32 bytes further along the rows (SBO = 8 rows).
//   A stride-2 projection reads its input through the same box with TMA
//   element strides (1, 2, 2): the box spans 32 x 16 input pixels and
//   lands as the 16 x 8 it samples, so nothing is subsampled beforehand.
// - B (the weights, (K, N), N contiguous, as an HWIO kernel lies) in the
//   128-byte swizzle, N-major: a 2-D TMA box of 64 channels x 64 rows per
//   64 output channels a chunk (a half beyond N is not loaded: its columns
//   are never stored).
// - Pixels, channels and rows beyond the tensors are zero-filled by TMA
//   loads and left unwritten by TMA stores, so ragged edges and a K that is
//   not a multiple of 64 need no code.
// - Epilogue. A slot holds the output tile, the add and the gate as the
//   same boxes: 64 channels x 128 pixels a half, each pixel a 128-byte row
//   in the 128-byte swizzle (the layout TMA gives them), so a warp's 4-byte
//   accesses hit 32 distinct banks; the add at half the extent (add_sub:
//   the stride-2 projection's input cotangent) is a box of 8 x 4 pixels of
//   it, landing on the tile's even pixels. A thread adds to its
//   accumulators the bias and the add (in fp32), applies the ReLU, zeroes
//   where the gate is <= 0, rounds once to bf16 and writes the result over
//   the add, all by ld/st.shared. The extra operands are template
//   arguments (an instantiation each), so the epilogue carries no code for
//   operands a launch does not have.
// - Shared memory: the block takes all 227 KB, split between ring stages
//   (32 KB at BN = 128, 24 KB at 64) and epilogue slots (the output tile,
//   plus the gate and the half-extent add where the launch has them) so
//   that both run the same number of tiles ahead; at 64 input channels
//   (one chunk a tile) that is 3 stages and 4 slots at BN = 128, 5 and 6 at
//   64; where a tile's chunks do not fit beside two slots, the ring takes
//   all but those two.
// - Numbers: fp32 accumulation over K in ascending chunks of 64, four k16
//   steps each; bias and add in fp32, then ReLU, then the gate; one bf16
//   rounding. No split of K and no atomics: every output has one owner that
//   sums in a fixed order, so results are bit-identical run to run.
#include "common.cuh"

namespace {

constexpr int KC = 64;                  // input channels per chunk: one 128-byte swizzled row of bf16
constexpr int TH = 8, TW = 16;          // output pixels of a tile
constexpr int BM = TH * TW;             // its GEMM rows
constexpr int NWG = 2;                  // consumer warpgroups, each owning whole tiles
constexpr int LOADER_WARP = 4 * NWG;    // in the producer warpgroup: the ring's TMA loads,
constexpr int EPILOGUE_WARP = LOADER_WARP + 1;  // the epilogue operands' loads,
constexpr int STORE_WARP = LOADER_WARP + 2;     // the output tiles' stores
constexpr int NT = 128 * (NWG + 1);
// Registers a thread once the roles are split: the producer warpgroup gives
// most of its share to the consumers (4 x 40 + 8 x 232 <= 65536 / 32 a warp)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 8, MAX_SLOTS = 8;
constexpr int SMEM = 232448;            // all a block may have: one block an SM
constexpr int BOX_BYTES = BM * 128;     // 64 channels of a tile's pixels
constexpr int SUB_BOX_BYTES = BOX_BYTES / 4;  // 64 channels of its even pixels
constexpr int A_BYTES = BM * KC * 2;
constexpr int B_HALF = KC * 64 * 2;     // 64 rows x 64 channels
constexpr int BAR_BYTES = 8 * (2 * MAX_STAGES + NWG + 3 * MAX_SLOTS);
static_assert(A_BYTES % 1024 == 0 && BOX_BYTES % 1024 == 0 && SUB_BOX_BYTES % 1024 == 0,
              "1024-byte swizzle atoms");

// The extra operands of the epilogue, fixed at compile time (an
// instantiation each): an add at the output's extent, an add at half of it
// landing on the even pixels, a gate. The bias and the ReLU are flags.
enum Extras { ADD = 1, ADD_SUB = 2, GATE = 4 };

template <int BN>
struct Width {
  static constexpr int NB = BN / 64;                 // 64-channel halves
  static constexpr int STAGE = A_BYTES + NB * B_HALF;
  static constexpr int OUT = NB * BOX_BYTES;         // the output tile, the add in place
  static constexpr int SUB = NB * SUB_BOX_BYTES;
};

struct GemmArgs {
  const bf16* bias;  // (N), or null
  int N, stride, relu, add, add_sub, gate;
  int nchunks, tiles_w, tiles_n, tiles;
  int own_row;  // a block takes all N tiles of its pixel tiles (see tile_at)
  // Shared memory, from the 1024-byte aligned start: the ring's stages; the
  // epilogue's slots (each the output tile, then the gate, then the
  // half-extent add); a tile's bias values a slot; the mbarriers.
  int stages, slots, slot_off, slot_bytes, gate_off, sub_off, bias_off, bar_off;
  int lag;  // stores in flight before a slot is freed: 1 .. slots - 1
};

struct TileAt {
  int h0, w0, n0, halves;  // halves: 64-channel halves inside N
};

// Tile i of this block. The list runs pixel tile by pixel tile, each one's
// N tiles together, and block b of G takes tiles b, b + G, ... of it; or,
// with own_row, pixel tiles b, b + G, ... with all their N tiles in turn,
// so that one SM writes a pixel's whole output row. That is taken where N
// * 2 bytes is not a whole number of 128-byte lines (the stem's 152
// channels): the lines two N tiles share are then written by one SM in
// turn. Written from several SMs while L2 held the max pool's backward's
// dirty output, the stem's backward took 392 us against 260 us so (H100).
template <int BN>
__device__ __forceinline__ TileAt tile_at(const GemmArgs& a, int i) {
  const int t = a.own_row ? (blockIdx.x + i / a.tiles_n * gridDim.x) * a.tiles_n + i % a.tiles_n
                          : blockIdx.x + i * gridDim.x;
  const int pt = t / a.tiles_n, nt = t - pt * a.tiles_n;
  const int th = pt / a.tiles_w, tw = pt - th * a.tiles_w;
  const int n0 = nt * BN;
  return {th * TH, tw * TW, n0, min(Width<BN>::NB, (a.N - n0 + 63) / 64)};
}

// The loader: chunk after chunk of the block's tiles into the ring, slot s
// once the consumers have released its previous use.
template <int BN>
__device__ __forceinline__ void load_ring(const GemmArgs& a, const CUtensorMap* map_x,
                                          const CUtensorMap* map_w, uint32_t ring, uint32_t full,
                                          uint32_t empty, int ntiles) {
  using W = Width<BN>;
  int s = 0, g = 0;
  uint32_t phase = 0;
  for (int i = 0; i < ntiles; ++i) {
    const TileAt t = tile_at<BN>(a, i);
    const uint32_t tx = A_BYTES + t.halves * B_HALF;
    for (int c = 0; c < a.nchunks; ++c, ++g) {
      if (g >= a.stages) st::mbar_wait(empty + 8 * s, phase ^ 1);
      const uint32_t stage = ring + s * W::STAGE;
      st::mbar_arrive_expect_tx(full + 8 * s, tx);
      st::tma_load_3d(stage, map_x, full + 8 * s, c * KC, t.w0 * a.stride, t.h0 * a.stride);
      for (int hb = 0; hb < t.halves; ++hb) {
        st::tma_load_2d(stage + A_BYTES + hb * B_HALF, map_w, full + 8 * s, t.n0 + 64 * hb,
                        c * KC);
      }
      if (++s == a.stages) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// The epilogue warp: tile i's extra operands and bias into slot i % slots,
// once the tile that held the slot before has left it.
template <int BN, int EX>
__device__ __forceinline__ void load_epilogue(const GemmArgs& a, const CUtensorMap* map_add,
                                              const CUtensorMap* map_gate, uint32_t base,
                                              uint32_t epi_full, uint32_t slot_free, int ntiles) {
  constexpr int per_half = (EX & ADD ? BOX_BYTES : 0) + (EX & GATE ? BOX_BYTES : 0) +
                           (EX & ADD_SUB ? SUB_BOX_BYTES : 0);
  for (int i = 0, k = 0; i < ntiles; ++i, k = k + 1 == a.slots ? 0 : k + 1) {
    if (i >= a.slots) st::mbar_wait(slot_free + 8 * k, ((i / a.slots) - 1) & 1);
    const TileAt t = tile_at<BN>(a, i);
    const uint32_t slot = base + a.slot_off + k * a.slot_bytes, bar = epi_full + 8 * k;
    const int bias_bytes = a.bias != nullptr ? 2 * min(BN, a.N - t.n0) : 0;
    st::mbar_arrive_expect_tx(bar, t.halves * per_half + bias_bytes);
    for (int hb = 0; hb < t.halves; ++hb) {
      const int n = t.n0 + 64 * hb;
      if (EX & ADD) st::tma_load_3d(slot + hb * BOX_BYTES, map_add, bar, n, t.w0, t.h0);
      if (EX & GATE) {
        st::tma_load_3d(slot + a.gate_off + hb * BOX_BYTES, map_gate, bar, n, t.w0, t.h0);
      }
      if (EX & ADD_SUB) {
        st::tma_load_3d(slot + a.sub_off + hb * SUB_BOX_BYTES, map_add, bar, n, t.w0 / 2,
                        t.h0 / 2);
      }
    }
    if (bias_bytes) st::bulk_load(base + a.bias_off + k * BN * 2, a.bias + t.n0, bias_bytes, bar);
  }
}

// Waits until at most n (0 .. MAX_SLOTS - 1) of this thread's bulk groups
// still read shared memory.
__device__ __forceinline__ void bulk_wait_read_at_most(int n) {
  switch (n) {
    case 0: st::bulk_wait_read<0>(); break;
    case 1: st::bulk_wait_read<1>(); break;
    case 2: st::bulk_wait_read<2>(); break;
    case 3: st::bulk_wait_read<3>(); break;
    case 4: st::bulk_wait_read<4>(); break;
    case 5: st::bulk_wait_read<5>(); break;
    case 6: st::bulk_wait_read<6>(); break;
    default: st::bulk_wait_read<7>(); break;
  }
}

// The store warp: each tile's output from its slot by TMA, once its
// warpgroup has written it. Up to `lag` stores stay in flight behind the
// newest; the slot of the one before them is free again once it has been
// read.
template <int BN>
__device__ __forceinline__ void store_tiles(const GemmArgs& a, const CUtensorMap* map_y,
                                            uint32_t base, uint32_t out_ready, uint32_t slot_free,
                                            int ntiles) {
  for (int i = 0, k = 0; i < ntiles; ++i, k = k + 1 == a.slots ? 0 : k + 1) {
    st::mbar_wait(out_ready + 8 * k, (i / a.slots) & 1);
    const TileAt t = tile_at<BN>(a, i);
    const uint32_t slot = base + a.slot_off + k * a.slot_bytes;
    for (int hb = 0; hb < t.halves; ++hb) {
      st::tma_store_3d(map_y, slot + hb * BOX_BYTES, t.n0 + 64 * hb, t.w0, t.h0);
    }
    st::bulk_commit();
    if (i >= a.lag) {
      bulk_wait_read_at_most(a.lag);
      const int old = k - a.lag;
      st::mbar_arrive(slot_free + 8 * (old < 0 ? old + a.slots : old));
    }
  }
  st::bulk_wait<0>();  // every store is done before the block's memory goes
}

template <int BN>
__device__ __forceinline__ void mma_k16(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                        bool acc_in);

template <>
__device__ __forceinline__ void mma_k16<128>(float (&acc)[64], uint64_t da, uint64_t db,
                                             bool acc_in) {
  st::wgmma_m64n128k16_bf16_tb(acc, da, db, acc_in);
}

template <>
__device__ __forceinline__ void mma_k16<64>(float (&acc)[32], uint64_t da, uint64_t db,
                                            bool acc_in) {
  st::wgmma_m64n64k16_bf16_tb(acc, da, db, acc_in);
}

__device__ __forceinline__ float2 bf16x2_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A consumer warpgroup: its tiles' products from the ring, then each tile's
// epilogue in its slot, handed to the store warp. Row 16 q + g (+ 8) of m64
// half m of the tile is pixel p = 64 m + 16 q + g (+ 8): tile row 4 m + q,
// column g (+ 8).
template <int BN, int EX>
__device__ __forceinline__ void consume(const GemmArgs& a, uint32_t base, uint32_t full,
                                        uint32_t empty, uint32_t turn, uint32_t epi_full,
                                        uint32_t out_ready, int ntiles, int wg, int q, int lane) {
  using W = Width<BN>;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[2][BN / 2];  // written first by a tile's first product (accumulate false)
  for (int i = wg; i < ntiles; i += NWG) {
    const int first = i * a.nchunks, k = i % a.slots;
    int s = first % a.stages, prev = 0;
    uint32_t phase = (first / a.stages) & 1;
    // The other warpgroup's tile before this one has all its chunks in: every
    // use of a stage before this tile's has completed, so a parity wait on
    // the stage's full barrier cannot read an older phase as this one.
    if (i > 0) st::mbar_wait(turn + 8 * wg, ((i - 1) / NWG) & 1);
    for (int c = 0; c < a.nchunks; ++c) {
      st::mbar_wait(full + 8 * s, phase);
      const uint32_t stage = base + s * W::STAGE;
      st::wgmma_hold(acc[0]);
      st::wgmma_hold(acc[1]);
      st::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const uint64_t db = st::smem_desc_sw128(stage + A_BYTES + kk * 16 * 128, B_HALF, 1024);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint64_t da = st::smem_desc_sw128(stage + m * 64 * 128 + kk * 32, 16, 1024);
          mma_k16<BN>(acc[m], da, db, c > 0 || kk > 0);
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

    st::mbar_wait(epi_full + 8 * k, (i / a.slots) & 1);  // the tile's operands are in
    // Thread (q, g, t4) holds, for each 8 channels j, pixels p = 64 m + 16 q
    // + g + 8 r (p % 8 == g) at channels 8 j + 2 t4, + 1: in the slot, byte
    // p * 128 + ((j % 8) ^ g) * 16 + 4 t4 of 64-channel half j / 8, a bank
    // of its own in the warp. A channel group's operands are read first,
    // then its four results computed and written over the add.
    const uint32_t out = base + a.slot_off + k * a.slot_bytes;
    const uint32_t bias = base + a.bias_off + k * BN * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint32_t col = (j >> 3) * BOX_BYTES + (((j & 7) ^ g) << 4) + 4 * t4;
      uint32_t add[4], gate[4];
#pragma unroll
      for (int mr = 0; mr < 4; ++mr) {
        const int m = mr >> 1, r = mr & 1, p = 64 * m + 16 * q + g + 8 * r;
        add[mr] = 0;
        if (EX & ADD) {
          add[mr] = st::ld_shared_b32(out + p * 128 + col);
        } else if ((EX & ADD_SUB) && (q & 1) == 0 && (g & 1) == 0) {  // an even row and column
          const int sp = (2 * m + (q >> 1)) * 8 + ((g + 8 * r) >> 1);
          add[mr] = st::ld_shared_b32(out + a.sub_off + (j >> 3) * SUB_BOX_BYTES + sp * 128 +
                                      ((((j & 7) ^ (sp & 7))) << 4) + 4 * t4);
        }
        gate[mr] = EX & GATE ? st::ld_shared_b32(out + a.gate_off + p * 128 + col) : 0;
      }
      const float2 b =
          bf16x2_float2(a.bias != nullptr ? st::ld_shared_b32(bias + (8 * j + 2 * t4) * 2) : 0u);
#pragma unroll
      for (int mr = 0; mr < 4; ++mr) {
        const int m = mr >> 1, r = mr & 1, p = 64 * m + 16 * q + g + 8 * r;
        float v0 = acc[m][4 * j + 2 * r], v1 = acc[m][4 * j + 2 * r + 1];
        if (a.bias != nullptr) {
          v0 += b.x;
          v1 += b.y;
        }
        if ((EX & ADD) || ((EX & ADD_SUB) && (q & 1) == 0 && (g & 1) == 0)) {
          const float2 f = bf16x2_float2(add[mr]);
          v0 += f.x;
          v1 += f.y;
        }
        if (a.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (EX & GATE) {
          const float2 f = bf16x2_float2(gate[mr]);
          if (!(f.x > 0.f)) v0 = 0.f;
          if (!(f.y > 0.f)) v1 = 0.f;
        }
        const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
        st::st_shared_b32(out + p * 128 + col, *reinterpret_cast<const uint32_t*>(&y));
      }
    }
    st::fence_proxy_async();  // this thread's writes, visible to the TMA store
    st::mbar_arrive(out_ready + 8 * k);
  }
}

template <int BN, int EX>
__global__ void __launch_bounds__(NT, 1)
    conv1x1_kernel(const GemmArgs a, const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_y,
                   const __grid_constant__ CUtensorMap map_add,
                   const __grid_constant__ CUtensorMap map_gate) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t base = (st::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + a.bar_off, empty = full + 8 * MAX_STAGES;
  const uint32_t turn = empty + 8 * MAX_STAGES, epi_full = turn + 8 * NWG;
  const uint32_t slot_free = epi_full + 8 * MAX_SLOTS, out_ready = slot_free + 8 * MAX_SLOTS;
  // the block's tiles: the grid has at most a.tiles blocks, and with own_row
  // at most a.tiles / a.tiles_n
  const int ntiles = a.own_row
                         ? ((a.tiles / a.tiles_n - 1 - blockIdx.x) / gridDim.x + 1) * a.tiles_n
                         : (a.tiles - 1 - blockIdx.x) / gridDim.x + 1;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      st::mbar_init(full + 8 * s, 1);
      st::mbar_init(empty + 8 * s, 4);  // one warpgroup's four warps
    }
    for (int w = 0; w < NWG; ++w) st::mbar_init(turn + 8 * w, 4);  // the other warpgroup's warps
    for (int k = 0; k < a.slots; ++k) {
      st::mbar_init(epi_full + 8 * k, 1);
      st::mbar_init(slot_free + 8 * k, 1);
      st::mbar_init(out_ready + 8 * k, 128);  // a consumer warpgroup's threads
    }
    st::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= LOADER_WARP) {
    st::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == LOADER_WARP && lane == 0) {
      load_ring<BN>(a, &map_x, &map_w, base, full, empty, ntiles);
    } else if (warp == EPILOGUE_WARP && lane == 0) {
      load_epilogue<BN, EX>(a, &map_add, &map_gate, base, epi_full, slot_free, ntiles);
    } else if (warp == STORE_WARP && lane == 0) {
      store_tiles<BN>(a, &map_y, base, out_ready, slot_free, ntiles);
    }
  } else {
    st::setmaxnreg_inc<CONSUMER_REGS>();
    consume<BN, EX>(a, base, full, empty, turn, epi_full, out_ready, ntiles, warp >> 2, warp & 3,
                    lane);
  }
}

// An (H, W, C) bf16 tensor as (C, W, H) in boxes of 64 channels x bw x bh
// elements taken every s pixels, in the 128-byte swizzle.
bool map_hwc(st::EncodeTiled encode, CUtensorMap* map, const void* ptr, int h, int w, int c,
             int bw, int bh, int s) {
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)bw, (cuuint32_t)bh};
  const cuuint32_t elem[3] = {1, (cuuint32_t)s, (cuuint32_t)s};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The weights (K, N) as (N, K) in boxes of 64 x 64, in the 128-byte swizzle.
bool map_weights(st::EncodeTiled encode, CUtensorMap* map, const void* ptr, int k, int n) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {64, KC};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The shared-memory layout of a launch: a ring stage holds a chunk of a
// tile's input and weights, an epilogue slot a tile's output and extra
// operands. Both are loaded ahead by the same number of tiles, as far as
// the memory goes, so that at 64 input channels (one chunk a tile) the ring
// runs as far ahead as the slots; where not even one tile's chunks fit
// beside two slots, the ring takes all but those two. False where not even
// one stage and two slots fit.
template <int BN>
bool layout(GemmArgs* a) {
  using W = Width<BN>;
  a->gate_off = W::OUT;
  a->sub_off = W::OUT + (a->gate ? W::OUT : 0);
  a->slot_bytes = a->sub_off + (a->add_sub ? W::SUB : 0);
  const int avail = SMEM - 1024 - BAR_BYTES, slot = a->slot_bytes + BN * 2;
  const int ahead = avail / (a->nchunks * W::STAGE + slot);  // tiles
  const int most = (avail - 2 * slot) / W::STAGE;
  int stages = ahead == 0 ? MAX_STAGES : ahead * a->nchunks > 2 ? ahead * a->nchunks : 2;
  stages = stages < MAX_STAGES ? stages : MAX_STAGES;
  stages = stages < most ? stages : most;
  if (stages < 1) return false;
  const int slots = (avail - stages * W::STAGE) / slot;
  a->stages = stages;
  a->slots = slots < MAX_SLOTS ? slots : MAX_SLOTS;
  a->slot_off = stages * W::STAGE;
  a->bias_off = a->slot_off + a->slots * a->slot_bytes;
  a->bar_off = (a->bias_off + a->slots * BN * 2 + 7) & ~7;
  // Without extra operands a slot needs no lead for loads: all but one are
  // stores in flight; else half of them.
  const bool extras = a->add || a->gate;
  a->lag = extras ? (a->slots / 2 > 1 ? a->slots / 2 : 1) : a->slots - 1;
  return a->slots >= 2;
}

template <int BN, int EX>
int launch(GemmArgs a, const void* x, const void* w, const void* add, const void* gate, void* y,
           int H, int W, int K, int Ho, int Wo, cudaStream_t stream) {
  static bool configured[st::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= st::MAX_DEVICES || st::sm_count(dev) == 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(conv1x1_kernel<BN, EX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  a.tiles_w = (Wo + TW - 1) / TW;
  a.tiles_n = (a.N + BN - 1) / BN;
  a.tiles = ((Ho + TH - 1) / TH) * a.tiles_w * a.tiles_n;
  a.nchunks = (K + KC - 1) / KC;
  if (!layout<BN>(&a)) return static_cast<int>(cudaErrorInvalidValue);
  const st::EncodeTiled encode = st::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x = {}, map_w = {}, map_y = {}, map_add = {}, map_gate = {};
  const int s = a.stride;
  bool ok = map_hwc(encode, &map_x, x, H, W, K, TW * s, TH * s, s) &&
            map_weights(encode, &map_w, w, K, a.N) &&
            map_hwc(encode, &map_y, y, Ho, Wo, a.N, TW, TH, 1);
  if (ok && a.add) {
    ok = a.add_sub ? map_hwc(encode, &map_add, add, (Ho + 1) / 2, (Wo + 1) / 2, a.N, TW / 2,
                             TH / 2, 1)
                   : map_hwc(encode, &map_add, add, Ho, Wo, a.N, TW, TH, 1);
  }
  if (ok && a.gate) ok = map_hwc(encode, &map_gate, gate, Ho, Wo, a.N, TW, TH, 1);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = a.tiles < st::sm_count(dev) ? a.tiles : st::sm_count(dev);
  a.own_row = (a.N & 63) != 0 && a.tiles / a.tiles_n >= grid;
  conv1x1_kernel<BN, EX><<<grid, NT, SMEM, stream>>>(a, map_x, map_w, map_y, map_add, map_gate);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations the launcher can reach: a gated launch always takes
// the 64-wide tile (_launch.conv1x1_width), so the 128-wide one has no gate.
template <int BN>
int launch_extras(const GemmArgs& a, const void* x, const void* w, const void* add,
                  const void* gate, void* y, int H, int W, int K, int Ho, int Wo,
                  cudaStream_t stream) {
  const int ex = (a.add ? (a.add_sub ? ADD_SUB : ADD) : 0) | (a.gate ? GATE : 0);
  switch (ex) {
    case 0: return launch<BN, 0>(a, x, w, add, gate, y, H, W, K, Ho, Wo, stream);
    case ADD: return launch<BN, ADD>(a, x, w, add, gate, y, H, W, K, Ho, Wo, stream);
    case ADD_SUB: return launch<BN, ADD_SUB>(a, x, w, add, gate, y, H, W, K, Ho, Wo, stream);
    default: break;
  }
  if constexpr (BN == 64) {
    switch (ex) {
      case GATE: return launch<BN, GATE>(a, x, w, add, gate, y, H, W, K, Ho, Wo, stream);
      case ADD | GATE:
        return launch<BN, ADD | GATE>(a, x, w, add, gate, y, H, W, K, Ho, Wo, stream);
      default:
        return launch<BN, ADD_SUB | GATE>(a, x, w, add, gate, y, H, W, K, Ho, Wo, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// (TH, TW, BN, threads, dynamic shared-memory bytes, blocks per SM, KC) of
// the tile of width bn (64 or 128) into out[0..6]; the launcher's constants
// are held against it.
ST_EXPORT int st_conv1x1_info(int bn, int* out) {
  if (bn != 64 && bn != 128) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = TH; out[1] = TW; out[2] = bn; out[3] = NT; out[4] = SMEM; out[5] = 1; out[6] = KC;
  return 0;
}

// y (Ho, Wo, N) = [gate >] [relu] (x[::stride, ::stride] W [+ bias] [+ add]),
// with Ho = ceil(H / stride), Wo = ceil(W / stride); K and N multiples of 8,
// every pointer 16-byte aligned; tiles bn (64 or 128) channels wide, a
// gate only at 64.
// add_sub: add is (ceil(Ho/2), ceil(Wo/2), N) and lands on the even pixels
// of y.
ST_EXPORT int st_conv1x1(const void* x, const void* w, const void* bias, const void* add,
                         const void* gate, void* y, int H, int W, int K, int N, int stride,
                         int relu, int add_sub, int bn, void* stream) {
  if ((K & 7) || (N & 7) || K <= 0 || N <= 0 || (stride != 1 && stride != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GemmArgs a = {};
  a.bias = static_cast<const bf16*>(bias);
  a.N = N; a.stride = stride; a.relu = relu;
  a.add = add != nullptr; a.add_sub = add_sub && a.add; a.gate = gate != nullptr;
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch_extras<64>(a, x, w, add, gate, y, H, W, K, Ho, Wo, s);
  if (bn == 128) return launch_extras<128>(a, x, w, add, gate, y, H, W, K, Ho, Wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
