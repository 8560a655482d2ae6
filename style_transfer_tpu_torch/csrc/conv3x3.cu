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
// channels (one k16 MMA step per tap).
// - Instruction: mma.sync.aligned.m16n8k16 (bf16 x bf16 -> fp32), operands
//   from shared memory through ldmatrix. A warp owns MT m16 tiles x NTL n8
//   tiles (64 x 32 outputs in the large tiles: 64 fp32 accumulators a
//   thread); per tap it loads NTL / 2 B fragments and MT A fragments for
//   MT * NTL MMAs. No wgmma in this version.
// - Input: the pixel tile with its 1-pixel halo is staged once per chunk as
//   bf16 [IH][IW][KC] and serves all nine taps as shifted views: the
//   ldmatrix row addresses of a tap are the tile's pixel addresses plus a
//   constant. A staged pixel takes 48 bytes (32 of data + 16 of padding), so
//   the eight rows of an 8x8 ldmatrix (eight pixels side by side) fall into
//   eight different 16-byte bank groups: no bank conflicts.
// - Weights: the [9][KC][BN] slice of the (3, 3, K, N) taps is staged as it
//   lies in device memory (n contiguous) with rows padded by 16 bytes, and
//   read with ldmatrix.trans, which delivers the "col" B fragment; the
//   padding keeps its eight k rows conflict-free. The kernel needs no weight
//   layout of its own: the wrapper prepares the bf16 taps (and the flipped,
//   transposed taps of backward-data) once per weight tensor.
// - Pipeline: STAGES (2 or 3) shared-memory stages; the weights, and the
//   input when it needs no arithmetic (COPIED: forward, and backward-data
//   without a prologue), arrive by cp.async (16 bytes, zero-filled outside
//   the image, which is the SAME padding) while the previous chunk
//   multiplies; one __syncthreads per chunk. A prologue that needs
//   arithmetic (unpool x0.25, int8 mask, + pre_add, pre_gate, one bf16
//   rounding) or an odd channel count (K = 3) takes a register-staged
//   path (STAGED, STAGED_SCALAR; separate instantiations): each thread loads its 8 channels of a pixel, applies the
//   prologue, rounds once to bf16 and stores them into the next stage before
//   it multiplies the current one; two blocks share an SM, so the other
//   block's MMAs cover those loads. Every prologue result is a bf16 value
//   (x0.25 is exact), so the products are those of the fp32 version and only
//   the order of the sum differs.
// - Tiles (chosen by the wrapper, `conv_tile` in ops/kernels/_launch.py):
//     0: 8x16 pixels x 128 channels, 8 warps (2 x 4), 2 stages,  93 KB
//     1: 16x16 pixels x 64 channels, 8 warps (4 x 2), 3 stages, 106 KB
//     2: 8x8 pixels x 64 channels,   4 warps (2 x 2), 2 stages,  50 KB
//        (deep, small layers: 32x32x512 gives 128 blocks instead of 32;
//        taken where a larger tile would leave a quarter of the SMs idle)
//     3: 16x16 pixels x 8 channels,  8 warps (8 x 1), 2 stages,  35 KB
//        (conv1_1's backward-data, N = 3: an n8 tile instead of 64 columns)
//   each sized for two or more blocks per SM. conv1_1 forward (K = 3) runs
//   the same tensor-core body with its one chunk zero-padded from 3 to 16
//   channels. No split of K and no atomics: a block owns its outputs and
//   sums in a fixed order, so results are bit-identical run to run.
// - Pool-window mapping: row r of an m16 tile is pixel (2 ty + r / 8,
//   8 tx + r % 8) of the block's tile, i.e. an m16 tile is a 2 x 8 pixel
//   patch. After the main loop the fp32 accumulators go through shared
//   memory (the pipeline's buffers re-used as a [pixel][channel] tile), and
//   the epilogue reads them back 8 channels a thread: the four pixels of a
//   pool window are four rows of that tile, and y, the mask and the pool
//   leave as 16-, 8- and 16-byte coalesced stores.
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
  static_assert(BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0, "warp tiling");
  static_assert(TW % 8 == 0 && TH % 2 == 0, "an m16 tile is a 2 x 8 pixel patch");
  static_assert(NTL == 1 || NTL % 2 == 0, "B fragments load in pairs");
};

using Tile0 = Tile<8, 16, 128, 2, 4, 2, 2>;
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

// Eight consecutive channels k..k+7 of one input pixel (K % 8 == 0), before
// the one bf16 rounding that the caller's pack applies.
__device__ __forceinline__ void load8(const ConvArgs& a, int h, int w, int k, float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  if (h < 0 || h >= a.H || w < 0 || w >= a.W || k >= a.K) return;
  const size_t pix = ((size_t)h * a.W + w) * a.K + k;
  if (a.x != nullptr) {
    const size_t src = a.unpool ? ((size_t)(h >> 1) * (a.W >> 1) + (w >> 1)) * a.K + k : pix;
    st::load8_bf16(a.x + src, v);
    if (a.unpool) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= 0.25f;
    }
  }
  if (a.in_mask != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(a.in_mask + pix);
    const int8_t* m = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (m[j] == 0) v[j] = 0.f;
    }
  }
  if (a.pre_add != nullptr) {
    const float4 lo = *reinterpret_cast<const float4*>(a.pre_add + pix);
    const float4 hi = *reinterpret_cast<const float4*>(a.pre_add + pix + 4);
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  if (a.pre_gate != nullptr) {
    float g[8];
    st::load8_bf16(a.pre_gate + pix, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(g[j] > 0.f)) v[j] = 0.f;
    }
  }
}

// Stage chunk c (channels c*KC .. c*KC+15) of the haloed input tile and of
// the weight slice into one pipeline stage.
// How the input tile reaches shared memory: as it lies in device memory
// (cp.async), through registers in groups of 8 channels with the prologue
// applied, or channel by channel (K % 8 != 0: conv1_1). Each is its own
// instantiation, so none pays for another's registers.
enum InputMode { COPIED = 0, STAGED = 1, STAGED_SCALAR = 2 };

template <class T, int MODE>
__device__ __forceinline__ void load_stage(const ConvArgs& a, unsigned char* stage, int c, int h0,
                                           int w0, int n0, int tid) {
  const int k0 = c * KC;
  unsigned char* sa = stage;
  unsigned char* sb = stage + T::A_BYTES;
  if constexpr (MODE == COPIED) {
    const uint32_t sa32 = st::smem_u32(sa);
    for (int e = tid; e < T::IH * T::IW * (KC / 8); e += T::NT) {
      const int pix = e / (KC / 8), c8 = e % (KC / 8);
      const int h = h0 + pix / T::IW - 1, w = w0 + pix % T::IW - 1, k = k0 + c8 * 8;
      const bool valid = h >= 0 && h < a.H && w >= 0 && w < a.W && k < a.K;
      const bf16* src = valid ? a.x + ((size_t)h * a.W + w) * a.K + k : a.x;
      st::cp_async16(sa32 + (pix * T::A_STRIDE + c8 * 8) * 2, src, valid);
    }
  } else if constexpr (MODE == STAGED) {
    // a rolled loop on purpose: unrolled, or with L2 prefetches of the next
    // chunk beside it, the chunk loop spills at the 128-register cap and the
    // launch gets markedly slower on the H100
    for (int e = tid; e < T::IH * T::IW * (KC / 8); e += T::NT) {
      const int pix = e / (KC / 8), c8 = e % (KC / 8);
      float v[8];
      load8(a, h0 + pix / T::IW - 1, w0 + pix % T::IW - 1, k0 + c8 * 8, v);
      *reinterpret_cast<uint4*>(sa + (pix * T::A_STRIDE + c8 * 8) * 2) = st::pack8_bf16(v);
    }
  } else {
    // odd channel counts (conv1_1: K = 3): half a pixel's chunk a thread,
    // its 8 loads in flight together, channels beyond K zero
    for (int e = tid; e < T::IH * T::IW * (KC / 8); e += T::NT) {
      const int pix = e / (KC / 8), c8 = e % (KC / 8);
      const int h = h0 + pix / T::IW - 1, w = w0 + pix % T::IW - 1;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = load1(a, h, w, k0 + c8 * 8 + k);
      *reinterpret_cast<uint4*>(sa + (pix * T::A_STRIDE + c8 * 8) * 2) = st::pack8_bf16(v);
    }
  }
  if ((a.N & 7) == 0) {
    const uint32_t sb32 = st::smem_u32(sb);
    constexpr int N8 = T::BN / 8;
    for (int e = tid; e < 9 * KC * N8; e += T::NT) {
      const int n8 = e % N8, k = (e / N8) % KC, t = e / (N8 * KC);
      const bool valid = k0 + k < a.K && n0 + n8 * 8 < a.N;
      const bf16* src = valid ? a.w + ((size_t)t * a.K + k0 + k) * a.N + n0 + n8 * 8 : a.w;
      st::cp_async16(sb32 + ((t * KC + k) * T::B_STRIDE + n8 * 8) * 2, src, valid);
    }
  } else {
    bf16* sb16 = reinterpret_cast<bf16*>(sb);
#pragma unroll 4
    for (int e = tid; e < 9 * KC * T::BN; e += T::NT) {
      const int n = e % T::BN, k = (e / T::BN) % KC, t = e / (T::BN * KC);
      bf16 v = __float2bfloat16_rn(0.f);
      if (k0 + k < a.K && n0 + n < a.N) v = a.w[((size_t)t * a.K + k0 + k) * a.N + n0 + n];
      sb16[(t * KC + k) * T::B_STRIDE + n] = v;
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
int launch(const ConvArgs& a, cudaStream_t stream) {
  static bool configured = false;  // per instantiation: allow its dynamic shared memory
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<T, FWD, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.W + T::TW - 1) / T::TW, (a.H + T::TH - 1) / T::TH, (a.N + T::BN - 1) / T::BN);
  conv3x3_kernel<T, FWD, MODE><<<grid, T::NT, T::SMEM, stream>>>(a);
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
}

}  // namespace

// (TH, TW, BN, threads, dynamic shared-memory bytes) of tile configuration
// `tile` into out[0..4]; the wrapper's chooser is held against it.
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
