// Direct 3x3 SAME convolution on NHWC bf16 tensors with fp32 accumulation,
// forward (bias + ReLU epilogues) and backward-data (transposed taps).
//
// Replaces the conv bodies of the TPU kernels
//   style_transfer_tpu/ops/pallas/conv_pair.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/conv_gram.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/block1_packed.py::_fwd_kernel / _bwd_kernel
// (the Gram products live in gram.cu). One launch is one conv; a TPU kernel
// that chained two convs in VMEM is two launches here, with the bf16
// activation between them written to device memory (the same tensor the TPU
// kernel saved as its backward residual, so nothing extra is stored).
//
// What bounds it on the H100: FLOPs. At the 512 px scale conv1_2 (512x512,
// 64->64) is 19.3 GFLOP against ~60 MB of traffic (input, int8 mask, pooled
// output): ~320 FLOP/byte, above the card's bf16 ridge (~295) and far above
// the fp32 CUDA-core ridge (~20). Every VGG conv of the path is compute-bound.
//
// What this simple design does about it: nothing clever yet. It is a direct
// convolution on the CUDA cores (fp32 FMA, 67 TFLOP/s peak), no tensor cores,
// no TMA, no pipelining. A block owns an 8x16-pixel x 64-channel output tile
// and loops over the reduction channels in chunks of 8: it stages the input
// tile with its 1-pixel halo (zero outside the image: SAME padding) and the
// 3x3x8x64 weight slice in shared memory as fp32, then each of 256 threads
// accumulates a 2x4-pixel x 4-channel patch in registers. The 2x4 patch makes
// the 2x2 average pool a register-local epilogue. Rounding points follow the
// TPU kernels: fp32 accumulation, bias added in fp32 from its bf16 value, the
// ReLU output rounded once to bf16, the pool taken on the fp32 ReLU output
// ((y00 + y01) + (y10 + y11)) * 0.25 and then rounded, the ReLU mask as int8
// of pre > 0.
//
// Backward-data is the same loop over pre-flipped, pre-transposed weights
// (the wrapper passes w_t[a][b][co][ci] = w[2-a][2-b][ci][co]), with a
// prologue on the incoming cotangent and an epilogue on the sum. The pair
// (conv_pair.py) gates after the taps: prologue = optional 2x2 unpool (x0.25,
// rows and columns duplicated) and int8-mask gate; epilogue = optional fp32
// add of the Gram term r.S, optional ReLU gate r > 0, bf16 store. The single
// (conv_single.py, replacing conv_single.py::_bwd_kernel) gates before the
// taps, from its own stored activation y: prologue = the optionally unpooled
// cotangent (absent: zero), plus an fp32 term (the Gram term y.S), zeroed
// where y <= 0, rounded once to bf16 (the TPU kernel's .astype at :195) and
// staged as fp32.
#include "common.cuh"

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 8;    // reduction channels staged per step
constexpr int NT = 256;  // threads per block
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// Eight consecutive channels k..k+7 of one input pixel (K % 8 == 0).
__device__ __forceinline__ void load8(const ConvArgs& a, int h, int w, int k, float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  if (h < 0 || h >= a.H || w < 0 || w >= a.W) return;
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
  if (a.pre_add != nullptr || a.pre_gate != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = round_bf16(v[j]);
  }
}

template <bool FWD>
__global__ void __launch_bounds__(NT) conv3x3_kernel(const ConvArgs a) {
  __shared__ float in_s[TK][IH][IW];
  __shared__ __align__(16) float w_s[9][TK][TN];

  const int tid = threadIdx.x;
  const int ng = tid & 15;              // channel group: 4 channels
  const int pg = tid >> 4;              // pixel group: 2 rows x 4 columns
  const int pr = (pg >> 2) * 2;
  const int pc = (pg & 3) * 4;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int n0 = blockIdx.z * TN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const bool vec_in = (a.K & 7) == 0;
  const bool vec_w = (a.N & 7) == 0;

  for (int k0 = 0; k0 < a.K; k0 += TK) {
    // input tile with its halo, channels k0..k0+7
    if (vec_in) {
      for (int p = tid; p < IH * IW; p += NT) {
        const int r = p / IW, c = p % IW;
        float v[8];
        load8(a, h0 + r - 1, w0 + c - 1, k0, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) in_s[j][r][c] = v[j];
      }
    } else {
      for (int e = tid; e < TK * IH * IW; e += NT) {
        const int k = e / (IH * IW), p = e % (IH * IW);
        const int r = p / IW, c = p % IW;
        in_s[k][r][c] = load1(a, h0 + r - 1, w0 + c - 1, k0 + k);
      }
    }
    // weight slice w[:, :, k0..k0+7, n0..n0+63]
    if (vec_w) {
      for (int e = tid; e < 9 * TK * (TN / 8); e += NT) {
        const int n8 = (e % (TN / 8)) * 8;
        const int k = (e / (TN / 8)) % TK;
        const int t = e / ((TN / 8) * TK);
        float v[8];
        if (k0 + k < a.K && n0 + n8 < a.N) {
          st::load8_bf16(a.w + ((size_t)t * a.K + k0 + k) * a.N + n0 + n8, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) w_s[t][k][n8 + j] = v[j];
      }
    } else {
      for (int e = tid; e < 9 * TK * TN; e += NT) {
        const int n = e % TN;
        const int k = (e / TN) % TK;
        const int t = e / (TN * TK);
        float v = 0.f;
        if (k0 + k < a.K && n0 + n < a.N) {
          v = __bfloat162float(a.w[((size_t)t * a.K + k0 + k) * a.N + n0 + n]);
        }
        w_s[t][k][n] = v;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int k = 0; k < TK; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[2][6];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) xv[i][j] = in_s[k][pr + i + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][k][ng * 4]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float xin = xv[i][j + dx];
              acc[i][j][0] = fmaf(xin, wv.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(xin, wv.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(xin, wv.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(xin, wv.w, acc[i][j][3]);
            }
        }
      }
    }
    __syncthreads();
  }

  const int nb = n0 + ng * 4;
  if (FWD) {
    // N % 4 == 0 (checked by the wrapper): a channel group is all in or all out
    if (nb >= a.N) return;
    float bv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = __bfloat162float(a.bias[nb + c]);
    float r[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pre[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pre[c] = acc[i][j][c] + bv[c];
          r[i][j][c] = fmaxf(pre[c], 0.f);
        }
        const int h = h0 + pr + i, w = w0 + pc + j;
        if (h < a.H && w < a.W) {
          const size_t o = ((size_t)h * a.W + w) * a.N + nb;
          if (a.y != nullptr) st::store4_bf16(a.y + o, r[i][j][0], r[i][j][1], r[i][j][2], r[i][j][3]);
          if (a.out_mask != nullptr) {
            *reinterpret_cast<char4*>(a.out_mask + o) =
                make_char4(pre[0] > 0.f, pre[1] > 0.f, pre[2] > 0.f, pre[3] > 0.f);
          }
        }
      }
    if (a.pool != nullptr) {
      // H and W are even (checked by the wrapper); tile origins are even
      const int ph = (h0 + pr) >> 1;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int pw = ((w0 + pc) >> 1) + jj;
        if (ph < (a.H >> 1) && pw < (a.W >> 1)) {
          float s[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[c] = ((r[0][2 * jj][c] + r[0][2 * jj + 1][c]) +
                    (r[1][2 * jj][c] + r[1][2 * jj + 1][c])) * 0.25f;
          }
          st::store4_bf16(a.pool + ((size_t)ph * (a.W >> 1) + pw) * a.N + nb, s[0], s[1], s[2], s[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + pr + i, w = w0 + pc + j;
        if (h >= a.H || w >= a.W) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = nb + c;
          if (n >= a.N) continue;
          const size_t o = ((size_t)h * a.W + w) * a.N + n;
          float v = acc[i][j][c];
          if (a.add != nullptr) v += a.add[o];
          if (a.gate != nullptr && !(__bfloat162float(a.gate[o]) > 0.f)) v = 0.f;
          a.out[o] = __float2bfloat16_rn(v);
        }
      }
  }
}

dim3 conv_grid(int H, int W, int N) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, (N + TN - 1) / TN);
}

}  // namespace

// Forward: y/out_mask/pool = epilogues of relu(conv3x3(x, w) + bias); a null
// output pointer disables that output.
ST_EXPORT int st_conv3x3_fwd(const void* x, const void* w, const void* bias, void* y,
                             void* out_mask, void* pool, int H, int W, int K, int N,
                             void* stream) {
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  a.out_mask = static_cast<int8_t*>(out_mask);
  a.pool = static_cast<bf16*>(pool);
  a.H = H; a.W = W; a.K = K; a.N = N;
  conv3x3_kernel<true><<<conv_grid(H, W, N), NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Backward-data: out = [gate >] ([add +] conv3x3(prologue(dy), w_t)) with
// prologue = [unpool] then [in_mask gate] then [+ pre_add] then [pre_gate >]
// (rounded to bf16 when pre_add or pre_gate is given); w_t holds the
// flipped, transposed taps, so K is the cotangent's channel count and N the
// input's. A null dy reads as zero.
ST_EXPORT int st_conv3x3_bwd_data(const void* dy, const void* in_mask, int unpool,
                                  const void* pre_add, const void* pre_gate,
                                  const void* w_t, const void* add, const void* gate,
                                  void* out, int H, int W, int K, int N, void* stream) {
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
  conv3x3_kernel<false><<<conv_grid(H, W, N), NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ST_EXPORT const char* st_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
