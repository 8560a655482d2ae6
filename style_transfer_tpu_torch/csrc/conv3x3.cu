// 3x3 SAME convolution on NHWC bf16 tensors as a bf16 implicit GEMM on the
// tensor cores with fp32 accumulation: forward (bias + ReLU epilogues) and
// backward-data (transposed taps).
//
// Replaces the conv bodies of the TPU kernels
//   style_transfer_tpu/ops/pallas/conv_pair.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/conv_gram.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/block1_packed.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/conv_single.py::_fwd_kernel / _bwd_kernel
// (the Gram products live in gram.cu). One launch is one conv; a TPU kernel
// that chained two convs in VMEM is two launches here, with the bf16
// activation between them written to device memory (the same tensor the TPU
// kernel saved as its backward residual, so nothing extra is stored).
//
// What bounds it on the H100: operations. conv1_2 at 512x512 (64 -> 64) is
// 19.3 GFLOP against ~60 MB of traffic (~320 FLOP/byte), above the card's
// bf16 ridge (~295); the deeper layers are further above it. Only conv1_1
// (3 -> 64 and its backward 64 -> 3) is bound by the bytes of its 64-channel
// side. So the products must run on the tensor cores and the operands must
// be re-used from shared memory, not re-fetched.
//
// The design. The output tile is pixels (M) x output channels (N); the
// reduction runs over 9 taps x K input channels in chunks of KC = 16
// channels (one k16 MMA step per tap). Each chunk stages the pixel tile with
// its 1-pixel halo once, and all nine taps read it as shifted views, so the
// input is fetched once per chunk, not nine times. Two main loops share the
// staging code and the epilogue:
//
// The warpgroup loop (conv3x3_wgmma_kernel, tile 0: more than 64 output
// channels wherever its grid gives more than a quarter of the SMs a block),
// the loop that sets the pace of a 2048^2 step. Bound by the tensor cores'
// rate once its operands arrive asynchronously: fed from a ring that is
// always full, its consumers reach ~780 TFLOP/s; what it reaches is how fast
// its producer fills the ring (450-780 forward, 350-440 with the backward's
// full prologue at the 2048^2 chain's shapes).
// - Instruction: wgmma.mma_async m64n128k16 (bf16 x bf16 -> fp32), both
//   operands from shared memory by descriptor. A block is 16x16 pixels x
//   128 channels: two consumer warpgroups, each owning two 8x8-pixel
//   patches (an m64 tile each: 2 x 64 fp32 accumulators a thread), and one
//   producer warpgroup; one block an SM (189 KB of shared memory, 154-165
//   registers a thread, none spilled).
// - A operand without swizzle: the haloed tile as two planes of 8 channels,
//   a pixel 16 bytes ([c8][18][18][8]). A core matrix (8 rows x 16 bytes) is
//   8 pixels side by side, so a patch is a descriptor with SBO = one staged
//   row and LBO = one plane, and a tap's shift moves only its start address
//   (16 bytes a pixel). The other choice, A from registers through ldmatrix
//   as in the mma.sync loop, was not needed: the descriptor form costs the
//   consumers no instruction per tap and no registers.
// - B operand: the chunk's nine taps, N-major as the weights lie in device
//   memory ((3, 3, K, N), n contiguous; no other weight layout is kept), in
//   the 128-byte swizzle that TMA writes.
// - Ring: 4 stages of 47 KB (the input, 11 KB, and the weights, 36 KB), a
//   full and an empty mbarrier each. The producer's first thread issues a
//   chunk's TMA loads: the input as two boxes (one per plane, zero-filled
//   outside the image: the SAME padding) and the weights as two boxes of 64
//   channels x 16 rows x 9 taps. The consumers wait on the full mbarrier,
//   issue their 18 wgmmas, and once their products of the chunk before are
//   done (wgmma.wait_group 1, so the tensor cores always hold a chunk)
//   release that chunk's stage on its empty mbarrier. The first product of
//   each accumulator starts the sum (scale-d 0): accumulators zeroed by
//   other instructions make ptxas serialize the wgmmas.
// - The backward's prologue (STAGED: unpool x0.25, int8 mask, + pre_add,
//   pre_gate, one bf16 rounding) needs arithmetic, so its input cannot go to
//   the ring as it lies: the 128 producer threads fetch its operands for
//   the next chunk into registers, then apply the prologue to the current
//   one and store it into the stage, so the loads of one chunk are in
//   flight while the previous one's arithmetic runs. The consumers never
//   wait on that arithmetic, only on the ring. (Raw operands brought by TMA
//   into boxes beside a ring of 3 stages made these kernels 3-8% faster,
//   about 1% of a 2048^2 step: not worth their code.)
//
// The mma.sync loop (conv3x3_kernel, tiles 1-3: 64 channels or fewer, and
// small grids):
// - Instruction: mma.sync.aligned.m16n8k16 (bf16 x bf16 -> fp32), operands
//   from shared memory through ldmatrix. A warp owns MT m16 tiles x NTL n8
//   tiles; per tap it loads NTL / 2 B fragments and MT A fragments for
//   MT * NTL MMAs.
// - Input: staged as bf16 [IH][IW][KC]; the ldmatrix row addresses of a tap
//   are the tile's pixel addresses plus a constant. A staged pixel takes 48
//   bytes (32 of data + 16 of padding), so the eight rows of an 8x8
//   ldmatrix (eight pixels side by side) fall into eight different 16-byte
//   bank groups: no bank conflicts.
// - Weights: the [9][KC][BN] slice staged as it lies (n contiguous) with
//   rows padded by 16 bytes, and read with ldmatrix.trans, which delivers
//   the "col" B fragment; the padding keeps its eight k rows conflict-free.
// - Pipeline: STAGES (2 or 3) shared-memory stages; the weights, and the
//   input when it needs no arithmetic (COPIED: forward, and backward-data
//   without a prologue), arrive by cp.async (16 bytes, zero-filled outside
//   the image) while the previous chunk multiplies; one __syncthreads per
//   chunk. A prologue that needs arithmetic (unpool x0.25, int8 mask, +
//   pre_add, pre_gate, one bf16 rounding) or an odd channel count (K = 3)
//   takes a register-staged path (STAGED, STAGED_SCALAR; separate
//   instantiations): each thread loads its 8 channels of a pixel, applies
//   the prologue, rounds once to bf16 and stores them into the next stage
//   before it multiplies the current one; two or more blocks share an SM,
//   so another block's MMAs cover those loads.
// - Pool-window mapping: row r of an m16 tile is pixel (2 ty + r / 8,
//   8 tx + r % 8) of the block's tile, i.e. an m16 tile is a 2 x 8 pixel
//   patch.
//
// Every prologue result is a bf16 value (x0.25 is exact), so the products
// are those of the fp32 version and only the order of the sum differs.
// Tiles (chosen by the wrapper by shape alone, `conv_tile` in
// ops/kernels/_launch.py):
//     0: 16x16 pixels x 128 channels, 2 warpgroups, wgmma, 4 stages, 189 KB
//        (more than 64 channels where more than a quarter of the SMs get a block)
//     1: 16x16 pixels x 64 channels, 8 warps (4 x 2), 3 stages, 106 KB
//     2: 8x8 pixels x 64 channels,   4 warps (2 x 2), 2 stages,  50 KB
//        (deep, small layers: taken where a larger tile would leave SMs idle)
//     3: 16x16 pixels x 8 channels,  8 warps (8 x 1), 2 stages,  35 KB
//        (conv1_1's backward-data, N = 3: an n8 tile instead of 64 columns)
// The mma.sync tiles are sized for two or more blocks per SM, the wgmma tile
// for one. conv1_1 forward (K = 3) runs the mma.sync body with its one chunk
// zero-padded from 3 to 16 channels. No split of K and no atomics: a block
// owns its outputs and sums in a fixed order, so results are bit-identical
// run to run. After either main loop the fp32 accumulators go through shared
// memory (the ring re-used as a [pixel][channel] tile), and the epilogue
// reads them back 8 channels a thread: the four pixels of a pool window are
// four rows of that tile, and y, the mask and the pool leave as 16-, 8- and
// 16-byte coalesced stores.
//
// Rounding points follow the TPU kernels: fp32 accumulation, bias added in
// fp32 from its bf16 value, the ReLU output rounded once to bf16, the pool
// taken on the fp32 ReLU output ((y00 + y01) + (y10 + y11)) * 0.25 and then
// rounded, the ReLU mask as int8 of pre > 0.
//
// Backward-data is the same loop over pre-flipped, pre-transposed weights
// (the wrapper passes w_t[a][b][co][ci] = w[2-a][2-b][ci][co]), with a
// prologue on the incoming cotangent and an epilogue on the sum. The pair
// (conv_pair.py) gates after the taps: prologue = optional 2x2 unpool (x0.25,
// rows and columns duplicated) and int8-mask gate; epilogue = optional fp32
// add of the Gram term r.S, optional ReLU gate r > 0, bf16 store. The single
// (conv_single.py) gates before the taps, from its own stored activation y:
// prologue = the optionally unpooled cotangent (absent: zero), plus an fp32
// term (the Gram term y.S), zeroed where y <= 0, rounded once to bf16.
#include "common.cuh"

namespace {

constexpr int KC = 16;  // reduction channels per chunk: one k16 MMA step per tap

struct ConvArgs {
  // input: (H, W, K) bf16, or (H/2, W/2, K) when unpool is set; null reads
  // as zero (a cotangent that autograd did not materialize)
  const bf16* x;
  const int8_t* in_mask;  // (H, W, K) gate on the input, or null
  int unpool;
  const float* pre_add;   // (H, W, K) fp32 added to the staged input, or null
  const bf16* pre_gate;   // (H, W, K): staged input zero where pre_gate <= 0, or null
  const bf16* w;          // (3, 3, K, N)
  // forward epilogue
  const bf16* bias;       // (N)
  bf16* y;                // (H, W, N) ReLU output, or null
  int8_t* out_mask;       // (H, W, N) pre > 0, or null
  bf16* pool;             // (H/2, W/2, N) 2x2 mean of the ReLU output, or null
  // backward epilogue
  const float* add;       // (H, W, N) fp32 term added to the sum, or null
  const bf16* gate;       // (H, W, N): zero where gate <= 0, or null
  bf16* out;              // (H, W, N)
  int H, W, K, N;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// One tile configuration: TH x TW pixels x BN channels per block, warps
// arranged WARPS_M x WARPS_N, MINB blocks per SM wanted.
template <int TH_, int TW_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int BM = TH * TW;                  // pixels per block
  static constexpr int NT = 32 * WARPS_M * WARPS_N;   // threads per block
  static constexpr int MT = BM / 16 / WARPS_M;        // m16 tiles per warp
  static constexpr int NTL = BN / 8 / WARPS_N;        // n8 tiles per warp
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int A_STRIDE = KC + 8;             // bf16 per staged pixel
  static constexpr int B_STRIDE = BN == 8 ? 8 : BN + 8;  // bf16 per staged weight row
  static constexpr int A_BYTES = IH * IW * A_STRIDE * 2;
  static constexpr int B_BYTES = 9 * KC * B_STRIDE * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_STRIDE = BN + 8;             // fp32 per pixel of the output tile
  static constexpr int SMEM = cmax(STAGES * STAGE_BYTES, BM * C_STRIDE * 4);
  static constexpr bool WGMMA = false;
  static constexpr int LOADERS = NT;                  // threads that stage a chunk
  static_assert(BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0, "warp tiling");
  static_assert(TW % 8 == 0 && TH % 2 == 0, "an m16 tile is a 2 x 8 pixel patch");
  static_assert(NTL == 1 || NTL % 2 == 0, "B fragments load in pairs");
  // byte offsets inside a stage: channels c8*8.. of staged pixel pix; weights
  // n8*8.. of tap t, row k
  __device__ static uint32_t a_off(int pix, int c8) { return (pix * A_STRIDE + c8 * 8) * 2; }
  __device__ static uint32_t b_off(int t, int k, int n8) {
    return A_BYTES + ((t * KC + k) * B_STRIDE + n8 * 8) * 2;
  }
};

// The warpgroup tile: TH x TW pixels cut into 8 x 8-pixel patches, one m64
// wgmma tile each, x BN = 128 channels; NWG consumer warpgroups, each owning
// PPW patches of the block's rows. A stage holds the haloed input tile as
// KC / 8 planes of 8 channels, a pixel 16 bytes ([c8][IH][IW][8], each plane
// one 128-byte aligned TMA box): a core-matrix layout without swizzle, so an
// A operand is a descriptor at the patch's first pixel (SBO = one staged
// row, LBO = one plane) and a tap's shift moves only its start. The
// weights follow as two TMA boxes, one per half of the 128 channels, each
// [tap][k][64 n] in the 128-byte swizzle (128-byte rows, their 16-byte
// chunks at chunk ^ (k % 8), atoms of 8 rows): per tap an N-major operand
// with SBO = 1024 (8 k rows) and LBO = one half. Stages, and each part of
// them, start on 1024-byte boundaries; the mbarriers follow the ring. One
// producer warpgroup (LOADERS threads) stages the chunks.
template <int TH_, int TW_, int STAGES_>
struct WgTile {
  static constexpr int TH = TH_, TW = TW_, BN = 128, STAGES = STAGES_, MINB = 1;
  static constexpr int BM = TH * TW;                   // pixels per block
  static constexpr int NWG = 2;                        // consumer warpgroups
  static constexpr int LOADERS = 128;                  // the producer warpgroup
  static constexpr int NT = 128 * NWG + LOADERS;       // threads per block
  static constexpr int PPW = BM / 64 / NWG;            // 8x8 patches per consumer warpgroup
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int N8 = BN / 8;
  static constexpr int A_BOX = IH * IW * 16;           // bytes of one 8-channel plane
  static constexpr int A_PLANE = (A_BOX + 127) / 128 * 128;  // a TMA box starts 128-aligned
  static constexpr int A_BYTES = ((KC / 8) * A_PLANE + 1023) / 1024 * 1024;
  static constexpr int B_TAP = KC * 128;               // bytes of a tap in one half
  static constexpr int B_HALF = 9 * B_TAP;             // one TMA box: 64 channels, 9 taps
  static constexpr int B_BYTES = 2 * B_HALF;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_STRIDE = BN + 8;              // fp32 per pixel of the output tile
  static constexpr int BAR_OFF = cmax(STAGES * STAGE_BYTES, BM * C_STRIDE * 4);
  // two mbarriers a stage (full, empty); + 1024: the kernel rounds the
  // dynamic shared memory's start up to 1024 bytes
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;
  static constexpr bool WGMMA = true;
  static_assert(TH % 8 == 0 && TW % 8 == 0 && (BM / 64) % NWG == 0, "8x8 patches per warpgroup");
  static_assert(STAGES >= 2, "one stage multiplying, one loading");
  static_assert(KC == 16 && BN == 128, "two planes of input, two halves of weights");
  static_assert(STAGE_BYTES % 1024 == 0 && B_HALF % 1024 == 0 && A_PLANE % 16 == 0,
                "aligned operands");
  __device__ static uint32_t a_off(int pix, int c8) { return c8 * A_PLANE + pix * 16; }
  __device__ static uint32_t b_off(int t, int k, int n8) {
    return A_BYTES + (n8 >> 3) * B_HALF + t * B_TAP + k * 128 + (((n8 & 7) ^ (k & 7)) << 4);
  }
};

using Tile0 = WgTile<16, 16, 4>;
using Tile1 = Tile<16, 16, 64, 4, 2, 3, 2>;
using Tile2 = Tile<8, 8, 64, 2, 2, 2, 4>;
using Tile3 = Tile<16, 16, 8, 8, 1, 2, 2>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One prologue value (any K): channel k of input pixel (h, w).
__device__ __forceinline__ float load1(const ConvArgs& a, int h, int w, int k) {
  if (h < 0 || h >= a.H || w < 0 || w >= a.W || k >= a.K) return 0.f;
  const size_t pix = ((size_t)h * a.W + w) * a.K + k;
  float v = 0.f;
  if (a.x != nullptr) {
    const size_t src = a.unpool ? ((size_t)(h >> 1) * (a.W >> 1) + (w >> 1)) * a.K + k : pix;
    v = __bfloat162float(a.x[src]);
    if (a.unpool) v *= 0.25f;
  }
  if (a.in_mask != nullptr && a.in_mask[pix] == 0) v = 0.f;
  if (a.pre_add != nullptr) v += a.pre_add[pix];
  if (a.pre_gate != nullptr && !(__bfloat162float(a.pre_gate[pix]) > 0.f)) v = 0.f;
  if (a.pre_add != nullptr || a.pre_gate != nullptr) v = round_bf16(v);
  return v;
}

// The operands of eight consecutive channels k..k+7 of one input pixel
// (K % 8 == 0) as they lie in device memory; absent operands and pixels
// outside the image read as zero. Fetched apart from the arithmetic, so that
// a caller can keep the loads of a later chunk in flight across a barrier.
struct Raw8 {
  uint4 x, gate;  // bf16 x 8: the input (or its unpooled source), pre_gate
  uint2 mask;     // int8 x 8: in_mask
  float4 lo, hi;  // pre_add
};

__device__ __forceinline__ void fetch8(const ConvArgs& a, int h, int w, int k, Raw8& r) {
  r.x = r.gate = make_uint4(0u, 0u, 0u, 0u);
  r.mask = make_uint2(0u, 0u);
  r.lo = r.hi = make_float4(0.f, 0.f, 0.f, 0.f);
  if (h < 0 || h >= a.H || w < 0 || w >= a.W || k >= a.K) return;
  const size_t pix = ((size_t)h * a.W + w) * a.K + k;
  if (a.x != nullptr) {
    const size_t src = a.unpool ? ((size_t)(h >> 1) * (a.W >> 1) + (w >> 1)) * a.K + k : pix;
    r.x = *reinterpret_cast<const uint4*>(a.x + src);
  }
  if (a.in_mask != nullptr) r.mask = *reinterpret_cast<const uint2*>(a.in_mask + pix);
  if (a.pre_add != nullptr) {
    r.lo = *reinterpret_cast<const float4*>(a.pre_add + pix);
    r.hi = *reinterpret_cast<const float4*>(a.pre_add + pix + 4);
  }
  if (a.pre_gate != nullptr) r.gate = *reinterpret_cast<const uint4*>(a.pre_gate + pix);
}

// The prologue on fetched operands, before the one bf16 rounding that the
// caller's pack applies (a pixel outside the image gives zeros).
__device__ __forceinline__ void apply8(const ConvArgs& a, const Raw8& r, float* v) {
  st::load8_bf16(reinterpret_cast<const bf16*>(&r.x), v);
  if (a.unpool) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] *= 0.25f;
  }
  if (a.in_mask != nullptr) {
    const int8_t* m = reinterpret_cast<const int8_t*>(&r.mask);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (m[j] == 0) v[j] = 0.f;
    }
  }
  if (a.pre_add != nullptr) {
    v[0] += r.lo.x; v[1] += r.lo.y; v[2] += r.lo.z; v[3] += r.lo.w;
    v[4] += r.hi.x; v[5] += r.hi.y; v[6] += r.hi.z; v[7] += r.hi.w;
  }
  if (a.pre_gate != nullptr) {
    float g[8];
    st::load8_bf16(reinterpret_cast<const bf16*>(&r.gate), g);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(g[j] > 0.f)) v[j] = 0.f;
    }
  }
}

// Both at once: channels k..k+7 of input pixel (h, w) with the prologue.
__device__ __forceinline__ void load8(const ConvArgs& a, int h, int w, int k, float* v) {
  Raw8 r;
  fetch8(a, h, w, k, r);
  apply8(a, r, v);
}

// Stage chunk c (channels c*KC .. c*KC+15) of the haloed input tile and of
// the weight slice into one pipeline stage.
// How the input tile reaches shared memory: as it lies in device memory
// (cp.async), through registers in groups of 8 channels with the prologue
// applied, or channel by channel (K % 8 != 0: conv1_1). Each is its own
// instantiation, so none pays for another's registers.
enum InputMode { COPIED = 0, STAGED = 1, STAGED_SCALAR = 2 };

template <class T>
constexpr int A_ITEMS = T::IH * T::IW * (KC / 8);  // 16-byte groups of the input tile

// The warpgroup tile's register-staged input: a producer thread's groups of
// chunk c fetched (fetch_input) while the chunk before is staged, and stored
// with the prologue applied (store_input) once the chunk's stage is free.
template <class T>
constexpr int A_PER_THREAD = (A_ITEMS<T> + T::LOADERS - 1) / T::LOADERS;

template <class T>
__device__ __forceinline__ void fetch_input(const ConvArgs& a, Raw8 (&r)[A_PER_THREAD<T>], int c,
                                            int h0, int w0, int tid) {
#pragma unroll
  for (int i = 0; i < A_PER_THREAD<T>; ++i) {
    const int e = tid + i * T::LOADERS, pix = e / (KC / 8), c8 = e % (KC / 8);
    fetch8(a, e < A_ITEMS<T> ? h0 + pix / T::IW - 1 : -1, w0 + pix % T::IW - 1, c * KC + c8 * 8,
           r[i]);
  }
}

template <class T>
__device__ __forceinline__ void store_input(const ConvArgs& a, const Raw8 (&r)[A_PER_THREAD<T>],
                                            unsigned char* stage, int tid) {
#pragma unroll
  for (int i = 0; i < A_PER_THREAD<T>; ++i) {
    const int e = tid + i * T::LOADERS;
    if (e < A_ITEMS<T>) {
      float v[8];
      apply8(a, r[i], v);
      *reinterpret_cast<uint4*>(stage + T::a_off(e / (KC / 8), e % (KC / 8))) = st::pack8_bf16(v);
    }
  }
}

template <class T, int MODE>
__device__ __forceinline__ void load_input(const ConvArgs& a, unsigned char* stage, int c, int h0,
                                           int w0, int tid) {
  const int k0 = c * KC;
  if constexpr (MODE == COPIED) {
    const uint32_t s32 = st::smem_u32(stage);
    for (int e = tid; e < A_ITEMS<T>; e += T::LOADERS) {
      const int pix = e / (KC / 8), c8 = e % (KC / 8);
      const int h = h0 + pix / T::IW - 1, w = w0 + pix % T::IW - 1, k = k0 + c8 * 8;
      const bool valid = h >= 0 && h < a.H && w >= 0 && w < a.W && k < a.K;
      const bf16* src = valid ? a.x + ((size_t)h * a.W + w) * a.K + k : a.x;
      st::cp_async16(s32 + T::a_off(pix, c8), src, valid);
    }
  } else if constexpr (MODE == STAGED) {
    // a rolled loop on purpose: unrolled, or with L2 prefetches of the next
    // chunk beside it, the chunk loop spills at the 128-register cap and the
    // launch gets markedly slower on the H100
    for (int e = tid; e < A_ITEMS<T>; e += T::LOADERS) {
      const int pix = e / (KC / 8), c8 = e % (KC / 8);
      float v[8];
      load8(a, h0 + pix / T::IW - 1, w0 + pix % T::IW - 1, k0 + c8 * 8, v);
      *reinterpret_cast<uint4*>(stage + T::a_off(pix, c8)) = st::pack8_bf16(v);
    }
  } else {
    // odd channel counts (conv1_1: K = 3): half a pixel's chunk a thread,
    // its 8 loads in flight together, channels beyond K zero
    for (int e = tid; e < A_ITEMS<T>; e += T::LOADERS) {
      const int pix = e / (KC / 8), c8 = e % (KC / 8);
      const int h = h0 + pix / T::IW - 1, w = w0 + pix % T::IW - 1;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = load1(a, h, w, k0 + c8 * 8 + k);
      *reinterpret_cast<uint4*>(stage + T::a_off(pix, c8)) = st::pack8_bf16(v);
    }
  }
}

template <class T>
__device__ __forceinline__ void load_weights(const ConvArgs& a, unsigned char* stage, int c, int n0,
                                             int tid) {
  const int k0 = c * KC;
  constexpr int N8 = T::BN / 8;
  if ((a.N & 7) == 0) {
    const uint32_t s32 = st::smem_u32(stage);
    for (int e = tid; e < 9 * KC * N8; e += T::LOADERS) {
      // n8 fastest: a warp copies whole rows of the weights
      const int n8 = e % N8, k = (e / N8) % KC, t = e / (N8 * KC);
      const bool valid = k0 + k < a.K && n0 + n8 * 8 < a.N;
      const bf16* src = valid ? a.w + ((size_t)t * a.K + k0 + k) * a.N + n0 + n8 * 8 : a.w;
      st::cp_async16(s32 + T::b_off(t, k, n8), src, valid);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < 9 * KC * T::BN; e += T::LOADERS) {
      const int n = e % T::BN, k = (e / T::BN) % KC, t = e / (T::BN * KC);
      bf16 v = __float2bfloat16_rn(0.f);
      if (k0 + k < a.K && n0 + n < a.N) v = a.w[((size_t)t * a.K + k0 + k) * a.N + n0 + n];
      *reinterpret_cast<bf16*>(stage + T::b_off(t, k, n >> 3) + (n & 7) * 2) = v;
    }
  }
}

template <class T, int MODE>
__device__ __forceinline__ void load_stage(const ConvArgs& a, unsigned char* stage, int c, int h0,
                                           int w0, int n0, int tid) {
  load_input<T, MODE>(a, stage, c, h0, w0, tid);
  load_weights<T>(a, stage, c, n0, tid);
}

// The epilogue from the fp32 [pixel][channel] output tile `cs` (C_STRIDE
// floats a pixel) to device memory, NT threads: forward bias, ReLU, mask
// and 2x2 pool; backward add, gate and the bf16 store.
template <class T, bool FWD>
__device__ __forceinline__ void epilogue(const ConvArgs& a, const float* cs, int h0, int w0,
                                         int n0, int tid) {
  constexpr int N8 = T::BN / 8;
  const bool vec_n = (a.N & 7) == 0;
  if (FWD) {
    if (vec_n) {
      for (int e = tid; e < T::BM * N8; e += T::NT) {
        const int n8 = e % N8, p = e / N8;
        const int h = h0 + p / T::TW, w = w0 + p % T::TW, n = n0 + n8 * 8;
        if (h >= a.H || w >= a.W || n >= a.N) continue;
        float bv[8], r[8];
        st::load8_bf16(a.bias + n, bv);
        const float* src = &cs[p * T::C_STRIDE + n8 * 8];
        uint2 m;
        int8_t* mb = reinterpret_cast<int8_t*>(&m);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pre = src[j] + bv[j];
          r[j] = fmaxf(pre, 0.f);
          mb[j] = pre > 0.f;
        }
        const size_t o = ((size_t)h * a.W + w) * a.N + n;
        if (a.y != nullptr) *reinterpret_cast<uint4*>(a.y + o) = st::pack8_bf16(r);
        if (a.out_mask != nullptr) *reinterpret_cast<uint2*>(a.out_mask + o) = m;
      }
      if (a.pool != nullptr) {
        // H and W are even (checked by the wrapper); tile origins are even
        for (int e = tid; e < (T::BM / 4) * N8; e += T::NT) {
          const int n8 = e % N8, q = e / N8;
          const int qy = q / (T::TW / 2), qx = q % (T::TW / 2);
          const int ph = (h0 >> 1) + qy, pw = (w0 >> 1) + qx, n = n0 + n8 * 8;
          if (ph >= (a.H >> 1) || pw >= (a.W >> 1) || n >= a.N) continue;
          float bv[8], s[8];
          st::load8_bf16(a.bias + n, bv);
          const float* s00 = &cs[((2 * qy) * T::TW + 2 * qx) * T::C_STRIDE + n8 * 8];
          const float* s10 = s00 + T::TW * T::C_STRIDE;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float y00 = fmaxf(s00[j] + bv[j], 0.f);
            const float y01 = fmaxf(s00[T::C_STRIDE + j] + bv[j], 0.f);
            const float y10 = fmaxf(s10[j] + bv[j], 0.f);
            const float y11 = fmaxf(s10[T::C_STRIDE + j] + bv[j], 0.f);
            s[j] = ((y00 + y01) + (y10 + y11)) * 0.25f;
          }
          *reinterpret_cast<uint4*>(a.pool + ((size_t)ph * (a.W >> 1) + pw) * a.N + n) =
              st::pack8_bf16(s);
        }
      }
    } else {
      for (int e = tid; e < T::BM * T::BN; e += T::NT) {
        const int nn = e % T::BN, p = e / T::BN;
        const int h = h0 + p / T::TW, w = w0 + p % T::TW, n = n0 + nn;
        if (h >= a.H || w >= a.W || n >= a.N) continue;
        const float pre = cs[p * T::C_STRIDE + nn] + __bfloat162float(a.bias[n]);
        const size_t o = ((size_t)h * a.W + w) * a.N + n;
        if (a.y != nullptr) a.y[o] = __float2bfloat16_rn(fmaxf(pre, 0.f));
        if (a.out_mask != nullptr) a.out_mask[o] = pre > 0.f;
      }
      if (a.pool != nullptr) {
        for (int e = tid; e < (T::BM / 4) * T::BN; e += T::NT) {
          const int nn = e % T::BN, q = e / T::BN;
          const int qy = q / (T::TW / 2), qx = q % (T::TW / 2);
          const int ph = (h0 >> 1) + qy, pw = (w0 >> 1) + qx, n = n0 + nn;
          if (ph >= (a.H >> 1) || pw >= (a.W >> 1) || n >= a.N) continue;
          const float b = __bfloat162float(a.bias[n]);
          const float* s00 = &cs[((2 * qy) * T::TW + 2 * qx) * T::C_STRIDE + nn];
          const float* s10 = s00 + T::TW * T::C_STRIDE;
          const float y00 = fmaxf(s00[0] + b, 0.f), y01 = fmaxf(s00[T::C_STRIDE] + b, 0.f);
          const float y10 = fmaxf(s10[0] + b, 0.f), y11 = fmaxf(s10[T::C_STRIDE] + b, 0.f);
          a.pool[((size_t)ph * (a.W >> 1) + pw) * a.N + n] =
              __float2bfloat16_rn(((y00 + y01) + (y10 + y11)) * 0.25f);
        }
      }
    }
  } else {
    if (vec_n) {
      for (int e = tid; e < T::BM * N8; e += T::NT) {
        const int n8 = e % N8, p = e / N8;
        const int h = h0 + p / T::TW, w = w0 + p % T::TW, n = n0 + n8 * 8;
        if (h >= a.H || w >= a.W || n >= a.N) continue;
        const size_t o = ((size_t)h * a.W + w) * a.N + n;
        const float* src = &cs[p * T::C_STRIDE + n8 * 8];
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = src[j];
        if (a.add != nullptr) {
          const float4 lo = *reinterpret_cast<const float4*>(a.add + o);
          const float4 hi = *reinterpret_cast<const float4*>(a.add + o + 4);
          v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
          v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
        }
        if (a.gate != nullptr) {
          float g[8];
          st::load8_bf16(a.gate + o, g);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!(g[j] > 0.f)) v[j] = 0.f;
          }
        }
        *reinterpret_cast<uint4*>(a.out + o) = st::pack8_bf16(v);
      }
    } else {
      for (int e = tid; e < T::BM * T::BN; e += T::NT) {
        const int nn = e % T::BN, p = e / T::BN;
        const int h = h0 + p / T::TW, w = w0 + p % T::TW, n = n0 + nn;
        if (h >= a.H || w >= a.W || n >= a.N) continue;
        const size_t o = ((size_t)h * a.W + w) * a.N + n;
        float v = cs[p * T::C_STRIDE + nn];
        if (a.add != nullptr) v += a.add[o];
        if (a.gate != nullptr && !(__bfloat162float(a.gate[o]) > 0.f)) v = 0.f;
        a.out[o] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <class T, bool FWD, int MODE>
__global__ void __launch_bounds__(T::NT, T::MINB) conv3x3_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int h0 = blockIdx.y * T::TH, w0 = blockIdx.x * T::TW, n0 = blockIdx.z * T::BN;
  const uint32_t smem32 = st::smem_u32(smem);

  float acc[T::MT][T::NTL][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // this lane's ldmatrix row addresses (byte offsets inside a stage): A row
  // lane % 16 of each m16 tile at tap (0, 0), k half lane / 16; B row k
  uint32_t a_off[T::MT];
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    const int mt = wm * T::MT + i, ty = mt / (T::TW / 8), tx = mt % (T::TW / 8);
    const int r = lane & 15, py = 2 * ty + (r >> 3), px = 8 * tx + (r & 7);
    a_off[i] = ((py * T::IW + px) * T::A_STRIDE + (lane >> 4) * 8) * 2;
  }
  uint32_t b_off;
  if constexpr (T::NTL >= 2) {
    const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
    b_off = T::A_BYTES + (krow * T::B_STRIDE + wn * T::NTL * 8 + (lane >> 4) * 8) * 2;
  } else {
    b_off = T::A_BYTES + ((lane & 15) * T::B_STRIDE + wn * 8) * 2;
  }

  const int nchunks = (a.K + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nchunks) load_stage<T, MODE>(a, smem + s * T::STAGE_BYTES, s, h0, w0, n0, tid);
    st::cp_async_commit();
  }

  for (int c = 0; c < nchunks; ++c) {
    st::cp_async_wait<T::STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and chunk c-1 is consumed
    const int nxt = c + T::STAGES - 1;
    if (nxt < nchunks) {
      load_stage<T, MODE>(a, smem + (nxt % T::STAGES) * T::STAGE_BYTES, nxt, h0, w0, n0, tid);
    }
    st::cp_async_commit();

    const uint32_t sa = smem32 + (c % T::STAGES) * T::STAGE_BYTES;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      uint32_t bfr[T::NTL][2];
      if constexpr (T::NTL >= 2) {
#pragma unroll
        for (int j = 0; j < T::NTL / 2; ++j) {
          uint32_t r[4];
          st::ldmatrix_x4_trans(sa + b_off + (t * KC * T::B_STRIDE + j * 16) * 2, r);
          bfr[2 * j][0] = r[0]; bfr[2 * j][1] = r[1];
          bfr[2 * j + 1][0] = r[2]; bfr[2 * j + 1][1] = r[3];
        }
      } else {
        st::ldmatrix_x2_trans(sa + b_off + t * KC * T::B_STRIDE * 2, bfr[0]);
      }
      const uint32_t shift = ((t / 3) * T::IW + (t % 3)) * T::A_STRIDE * 2;
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        uint32_t af[4];
        st::ldmatrix_x4(sa + a_off[i] + shift, af);
#pragma unroll
        for (int j = 0; j < T::NTL; ++j) st::mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
      }
    }
  }
  st::cp_async_wait<0>();
  __syncthreads();

  // the accumulators as an fp32 [pixel][channel] tile in shared memory
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int mt = wm * T::MT + i, ty = mt / (T::TW / 8), tx = mt % (T::TW / 8);
      const int p_top = (2 * ty) * T::TW + 8 * tx + g;
#pragma unroll
      for (int j = 0; j < T::NTL; ++j) {
        const int col = (wn * T::NTL + j) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(&cs[p_top * T::C_STRIDE + col]) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(&cs[(p_top + T::TW) * T::C_STRIDE + col]) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
  __syncthreads();
  epilogue<T, FWD>(a, cs, h0, w0, n0, tid);
}

// The main loop on the warpgroup MMA, warp-specialized. The producer
// warpgroup stages chunk j into stage j % STAGES once the consumers have
// released the chunk that stage held: its first thread issues the chunk's
// TMA loads (the input boxes, forward and bare backward; the weights
// whenever N % 8 == 0) on the stage's full mbarrier, and all 128 stage what
// TMA cannot: the backward's prologue through registers, fetched a chunk
// ahead so that its loads are in flight while the previous chunk's
// arithmetic and stores run. Each producer thread arrives on the full
// mbarrier once its stores are fenced for the tensor cores; the first
// arrives last with the TMA bytes to expect. The two consumer warpgroups
// wait on the full mbarrier, issue the chunk's 9 taps x PPW patches of
// m64n128k16, and, once their products of the chunk before are done
// (wgmma.wait_group 1, so the tensor cores always hold a chunk), release
// that chunk's stage on its empty mbarrier (one arrival a consumer warp).
template <class T, int MODE>
__device__ __forceinline__ void produce(const ConvArgs& a, const CUtensorMap* map_x,
                                        const CUtensorMap* map_w, unsigned char* smem,
                                        uint32_t smem32, uint32_t full, uint32_t empty,
                                        int nchunks, int h0, int w0, int n0, int ptid) {
  constexpr bool PREFETCH = MODE == STAGED;  // the input through registers, a chunk ahead
  const bool b_tma = (a.N & 7) == 0;         // 16-byte rows of weights
  const uint32_t tx = (MODE == COPIED ? 2 * T::A_BOX : 0) + (b_tma ? T::B_BYTES : 0);
  Raw8 raw[PREFETCH ? A_PER_THREAD<T> : 1];
  if constexpr (PREFETCH) fetch_input<T>(a, raw, 0, h0, w0, ptid);
  for (int j = 0; j < nchunks; ++j) {
    const int s = j % T::STAGES;
    if (j >= T::STAGES) st::mbar_wait(empty + 8 * s, (j / T::STAGES - 1) & 1);
    const uint32_t stage = smem32 + s * T::STAGE_BYTES;
    unsigned char* stage_p = smem + s * T::STAGE_BYTES;
    if (ptid == 0) {
      if constexpr (MODE == COPIED) {
#pragma unroll
        for (int c8 = 0; c8 < 2; ++c8) {
          st::tma_load_4d(stage + T::a_off(0, c8), map_x, full + 8 * s, 0, j * 2 + c8, w0 - 1,
                          h0 - 1);
        }
      }
      if (b_tma) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          st::tma_load_3d(stage + T::b_off(0, 0, half * 8), map_w, full + 8 * s, n0 + half * 64,
                          j * KC, 0);
        }
      }
    }
    if constexpr (PREFETCH) {
      store_input<T>(a, raw, stage_p, ptid);
      if (j + 1 < nchunks) fetch_input<T>(a, raw, j + 1, h0, w0, ptid);
    } else if constexpr (MODE != COPIED) {
      load_input<T, MODE>(a, stage_p, j, h0, w0, ptid);
    }
    if (!b_tma) {
      load_weights<T>(a, stage_p, j, n0, ptid);
      st::cp_async_commit();
      st::cp_async_wait<0>();
    }
    st::fence_proxy_async();  // this thread's stores, visible to the tensor cores
    if (ptid == 0) {
      st::mbar_arrive_expect_tx(full + 8 * s, tx);  // tx-count may dip below 0 until now
    } else {
      st::mbar_arrive(full + 8 * s);
    }
  }
}

template <class T, bool FWD, int MODE>
__global__ void __launch_bounds__(T::NT, 1)
    conv3x3_wgmma_kernel(const ConvArgs a, const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int h0 = blockIdx.y * T::TH, w0 = blockIdx.x * T::TW, n0 = blockIdx.z * T::BN;
  // the swizzle's 1024-byte atoms need 1024-byte aligned stages
  const uint32_t smem32 = (st::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem32 - st::smem_u32(smem_raw));
  const uint32_t full = smem32 + T::BAR_OFF, empty = full + 8 * T::STAGES;
  const int nchunks = (a.K + KC - 1) / KC;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      st::mbar_init(full + 8 * s, T::LOADERS);
      st::mbar_init(empty + 8 * s, 4 * T::NWG);
    }
    st::mbar_init_fence();
  }
  __syncthreads();

  float acc[T::PPW][64];  // written first by the first product (accumulate false)
  if (wg == T::NWG) {
    produce<T, MODE>(a, &map_x, &map_w, smem, smem32, full, empty, nchunks, h0, w0, n0,
                     tid - T::NWG * 128);
  } else {
    for (int c = 0; c < nchunks; ++c) {
      const int slot = c % T::STAGES;
      st::mbar_wait(full + 8 * slot, (c / T::STAGES) & 1);  // chunk c has landed
      const uint32_t stage = smem32 + slot * T::STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < T::PPW; ++i) st::wgmma_hold(acc[i]);
      st::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const uint64_t db = st::smem_desc_sw128(stage + T::b_off(t, 0, 0), T::B_HALF, 1024);
#pragma unroll
        for (int i = 0; i < T::PPW; ++i) {
          const int p = wg * T::PPW + i, pr = p / (T::TW / 8), pc = p % (T::TW / 8);
          const int pix = (pr * 8 + t / 3) * T::IW + pc * 8 + t % 3;
          const uint64_t da = st::smem_desc(stage + T::a_off(pix, 0), T::A_PLANE, T::IW * 16);
          st::wgmma_m64n128k16_bf16_tb(acc[i], da, db, c > 0 || t > 0);
        }
      }
      st::wgmma_commit();
      st::wgmma_wait<1>();  // chunk c - 1's products are done: release its stage
#pragma unroll
      for (int i = 0; i < T::PPW; ++i) st::wgmma_hold(acc[i]);
      if (c > 0 && lane == 0) st::mbar_arrive(empty + 8 * ((c - 1) % T::STAGES));
    }
    st::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < T::PPW; ++i) st::wgmma_hold(acc[i]);
  }
  __syncthreads();  // every product done, every load consumed: the ring becomes the output tile

  // the accumulators as an fp32 [pixel][channel] tile: row 16 wq + g of
  // patch p is its pixel (2 wq, g), row + 8 the pixel below
  float* cs = reinterpret_cast<float*>(smem);
  if (wg < T::NWG) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < T::PPW; ++i) {
      const int p = wg * T::PPW + i, pr = p / (T::TW / 8), pc = p % (T::TW / 8);
      const int p_top = (pr * 8 + 2 * wq) * T::TW + pc * 8 + g;
#pragma unroll
      for (int j = 0; j < T::N8; ++j) {
        const int col = j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(&cs[p_top * T::C_STRIDE + col]) =
            make_float2(acc[i][4 * j], acc[i][4 * j + 1]);
        *reinterpret_cast<float2*>(&cs[(p_top + T::TW) * T::C_STRIDE + col]) =
            make_float2(acc[i][4 * j + 2], acc[i][4 * j + 3]);
      }
    }
  }
  __syncthreads();
  epilogue<T, FWD>(a, cs, h0, w0, n0, tid);
}

// The warpgroup tile's TMA maps: the input as (8 channels, K / 8, W, H) in
// boxes of one 8-channel plane of the haloed tile, and the taps (3, 3, K, N)
// as (N, K, 9) in boxes of 64 channels x KC rows x 9 taps, 128-byte swizzle.
template <class T, int MODE>
bool tensor_maps(const ConvArgs& a, CUtensorMap* map_x, CUtensorMap* map_w) {
  const st::EncodeTiled encode = st::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (MODE == COPIED) {
    const cuuint64_t dims[4] = {8, (cuuint64_t)(a.K / 8), (cuuint64_t)a.W, (cuuint64_t)a.H};
    const cuuint64_t strides[3] = {16, (cuuint64_t)a.K * 2, (cuuint64_t)a.W * a.K * 2};
    const cuuint32_t box[4] = {8, 1, T::IW, T::IH};
    if (encode(map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(a.x), dims, strides,
               box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS) {
      return false;
    }
  }
  if ((a.N & 7) == 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)a.N, (cuuint64_t)a.K, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)a.N * 2, (cuuint64_t)a.K * a.N * 2};
    const cuuint32_t box[3] = {64, KC, 9};
    if (encode(map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(a.w), dims, strides,
               box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS) {
      return false;
    }
  }
  return true;
}

template <class T, bool FWD, int MODE>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const void* kernel = nullptr;
  if constexpr (T::WGMMA) {
    kernel = reinterpret_cast<const void*>(conv3x3_wgmma_kernel<T, FWD, MODE>);
  } else {
    kernel = reinterpret_cast<const void*>(conv3x3_kernel<T, FWD, MODE>);
  }
  static bool configured = false;  // per instantiation: allow its dynamic shared memory
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.W + T::TW - 1) / T::TW, (a.H + T::TH - 1) / T::TH, (a.N + T::BN - 1) / T::BN);
  if constexpr (T::WGMMA) {
    CUtensorMap map_x = {}, map_w = {};
    if (!tensor_maps<T, MODE>(a, &map_x, &map_w)) return static_cast<int>(cudaErrorInvalidValue);
    conv3x3_wgmma_kernel<T, FWD, MODE><<<grid, T::NT, T::SMEM, stream>>>(a, map_x, map_w);
  } else {
    conv3x3_kernel<T, FWD, MODE><<<grid, T::NT, T::SMEM, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool FWD>
int launch_mode(const ConvArgs& a, int mode, cudaStream_t stream) {
  if (mode == COPIED) return launch<T, FWD, COPIED>(a, stream);
  if constexpr (!FWD) {  // the forward has no prologue: no such instantiation
    if (mode == STAGED) return launch<T, FWD, STAGED>(a, stream);
  }
  return launch<T, FWD, STAGED_SCALAR>(a, stream);
}

template <bool FWD>
int dispatch(const ConvArgs& a, int tile, cudaStream_t stream) {
  // the input goes by cp.async only as it lies in memory: no prologue, and
  // whole 16-byte groups of channels
  const bool prologue = a.x == nullptr || a.in_mask != nullptr || a.unpool ||
                        a.pre_add != nullptr || a.pre_gate != nullptr;
  const int mode = (a.K & 7) != 0 ? STAGED_SCALAR : prologue ? STAGED : COPIED;
  switch (tile) {
    case 0: return launch_mode<Tile0, FWD>(a, mode, stream);
    case 1: return launch_mode<Tile1, FWD>(a, mode, stream);
    case 2: return launch_mode<Tile2, FWD>(a, mode, stream);
    case 3: return launch_mode<Tile3, FWD>(a, mode, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
void tile_info(int* out) {
  out[0] = T::TH; out[1] = T::TW; out[2] = T::BN; out[3] = T::NT; out[4] = T::SMEM;
  out[5] = T::MINB; out[6] = T::WGMMA;
}

}  // namespace

// (TH, TW, BN, threads, dynamic shared-memory bytes, blocks per SM it is
// built for, whether it runs on wgmma) of tile configuration `tile` into
// out[0..6]; the wrapper's chooser is held against it.
ST_EXPORT int st_conv3x3_tile_info(int tile, int* out) {
  switch (tile) {
    case 0: tile_info<Tile0>(out); return 0;
    case 1: tile_info<Tile1>(out); return 0;
    case 2: tile_info<Tile2>(out); return 0;
    case 3: tile_info<Tile3>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Forward: y/out_mask/pool = epilogues of relu(conv3x3(x, w) + bias); a null
// output pointer disables that output. `tile` picks the tile configuration.
ST_EXPORT int st_conv3x3_fwd(const void* x, const void* w, const void* bias, void* y,
                             void* out_mask, void* pool, int H, int W, int K, int N, int tile,
                             void* stream) {
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  a.out_mask = static_cast<int8_t*>(out_mask);
  a.pool = static_cast<bf16*>(pool);
  a.H = H; a.W = W; a.K = K; a.N = N;
  return dispatch<true>(a, tile, static_cast<cudaStream_t>(stream));
}

// Backward-data: out = [gate >] ([add +] conv3x3(prologue(dy), w_t)) with
// prologue = [unpool] then [in_mask gate] then [+ pre_add] then [pre_gate >]
// (rounded to bf16 when pre_add or pre_gate is given); w_t holds the
// flipped, transposed taps, so K is the cotangent's channel count and N the
// input's. A null dy reads as zero.
ST_EXPORT int st_conv3x3_bwd_data(const void* dy, const void* in_mask, int unpool,
                                  const void* pre_add, const void* pre_gate,
                                  const void* w_t, const void* add, const void* gate,
                                  void* out, int H, int W, int K, int N, int tile,
                                  void* stream) {
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(dy);
  a.in_mask = static_cast<const int8_t*>(in_mask);
  a.unpool = unpool;
  a.pre_add = static_cast<const float*>(pre_add);
  a.pre_gate = static_cast<const bf16*>(pre_gate);
  a.w = static_cast<const bf16*>(w_t);
  a.add = static_cast<const float*>(add);
  a.gate = static_cast<const bf16*>(gate);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.W = W; a.K = K; a.N = N;
  return dispatch<false>(a, tile, static_cast<cudaStream_t>(stream));
}

ST_EXPORT const char* st_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
