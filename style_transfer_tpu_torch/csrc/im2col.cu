// The pointwise passes around ResNet-50's GEMMs (conv1x1.cu): im2col and
// its gather-form adjoint col2im for the strided convolutions, the stem's
// 3x3 stride-2 max pool forward and backward, and the ReLU gate of a
// stage's output cotangent. NHWC bf16 tensors; sums in fp32, one bf16
// rounding.
//
// Replaces no TPU kernel: the JAX package runs VGG only. Added for
// ResNet-50 (ops/kernels/resnet.py).
//
// What bounds them on the H100: bytes; each reads and writes its operands
// once in 16-byte accesses where the channel count allows (a multiple of
// 8), and element by element for the stem's 3-channel image.
//
// - im2col: col[(oy, ox)][(ky, kx, c)] = x[oy s - p + ky][ox s - p + kx][c]
//   (zero outside the image and in the columns beyond kh kw C, up to Kp),
//   the operand of conv1x1.cu's GEMM with the HWIO kernel as (kh kw C, N).
//   Strided convolutions go this way (ResNet's three 3x3 of stride 2 and
//   its 7x7 stem) rather than through a strided form of conv3x3.cu's tile:
//   they are 11% of the model's convolution FLOPs at one launch each way,
//   and the extra bytes (the operand written and read once) are small
//   against the step (PERF.md).
// - col2im: dx[iy][ix][c] = sum over the taps (ky, kx) whose output pixel
//   oy = (iy + p - ky) / s, ox = (ix + p - kx) / s exists of
//   dcol[(oy, ox)][(ky, kx, c)], in tap order, then zero where gate <= 0:
//   a gather, so each input pixel is written once and nothing is atomic.
// - maxpool: the 3x3 window of stride 2 and padding 1; the forward keeps
//   the window index (0..8, int8) of each output's maximum, the first in
//   window order among equal values (as PyTorch's max_pool2d); the
//   backward gathers each input pixel's cotangent from the (at most four)
//   windows whose maximum it was, adds `add` and gates by `gate`.
// - relu_gate: out = gate > 0 ? dy : 0.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

inline unsigned int blocks_for(size_t n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

struct ColArgs {
  int H, W, C, kh, kw, stride, pad, Ho, Wo, Kp;
};

// one thread: eight consecutive columns of one row of col
__global__ void __launch_bounds__(THREADS) im2col_kernel(const bf16* __restrict__ x,
                                                         bf16* __restrict__ col, ColArgs a) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int groups = a.Kp / 8;
  if (e >= (size_t)a.Ho * a.Wo * groups) return;
  const int g = (int)(e % groups);
  const size_t pix = e / groups;
  const int oy = (int)(pix / a.Wo), ox = (int)(pix % a.Wo);
  const int k0 = g * 8, kall = a.kh * a.kw * a.C;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if ((a.C & 7) == 0) {
    const int tap = k0 / a.C, c = k0 % a.C;
    const int iy = oy * a.stride - a.pad + tap / a.kw, ix = ox * a.stride - a.pad + tap % a.kw;
    if (k0 < kall && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
      out = *reinterpret_cast<const uint4*>(x + ((size_t)iy * a.W + ix) * a.C + c);
    }
  } else {
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j;
      if (k >= kall) break;
      const int tap = k / a.C, c = k % a.C;
      const int iy = oy * a.stride - a.pad + tap / a.kw, ix = ox * a.stride - a.pad + tap % a.kw;
      if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) o[j] = x[((size_t)iy * a.W + ix) * a.C + c];
    }
  }
  *reinterpret_cast<uint4*>(col + pix * a.Kp + k0) = out;
}

// the output pixel of tap k along one axis, or -1: (i + p - k) / s where exact and in range
__device__ __forceinline__ int source(int i, int k, int p, int s, int n) {
  const int t = i + p - k;
  if (t < 0 || t % s) return -1;
  return t / s < n ? t / s : -1;
}

// one thread: eight channels of one input pixel (VEC = 8, C % 8 == 0), or
// every channel of one (VEC = 0, C <= 8: the stem's image)
template <int VEC>
__global__ void __launch_bounds__(THREADS) col2im_kernel(const bf16* __restrict__ dcol,
                                                         const bf16* __restrict__ gate,
                                                         bf16* __restrict__ dx, ColArgs a) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int groups = VEC ? a.C / VEC : 1;
  const int nc = VEC ? VEC : a.C;
  if (e >= (size_t)a.H * a.W * groups) return;
  const int c = (int)(e % groups) * VEC;
  const size_t pix = e / groups;
  const int iy = (int)(pix / a.W), ix = (int)(pix % a.W);
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  for (int ky = 0; ky < a.kh; ++ky) {
    const int oy = source(iy, ky, a.pad, a.stride, a.Ho);
    if (oy < 0) continue;
    for (int kx = 0; kx < a.kw; ++kx) {
      const int ox = source(ix, kx, a.pad, a.stride, a.Wo);
      if (ox < 0) continue;
      const bf16* src = dcol + ((size_t)oy * a.Wo + ox) * a.Kp + (ky * a.kw + kx) * a.C + c;
      if constexpr (VEC == 8) {
        float v[8];
        st::load8_bf16(src, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] += v[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nc) s[j] += __bfloat162float(src[j]);
        }
      }
    }
  }
  const size_t o = pix * a.C + c;
  if (gate != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nc && !(__bfloat162float(gate[o + j]) > 0.f)) s[j] = 0.f;
    }
  }
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(dx + o) = st::pack8_bf16(s);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nc) dx[o + j] = __float2bfloat16_rn(s[j]);
    }
  }
}

struct PoolArgs {
  int H, W, C, Ho, Wo;
};

// one thread: eight channels of one output pixel
__global__ void __launch_bounds__(THREADS) maxpool_fwd_kernel(const bf16* __restrict__ x,
                                                              bf16* __restrict__ y,
                                                              int8_t* __restrict__ idx,
                                                              PoolArgs a) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int groups = a.C / 8;
  if (e >= (size_t)a.Ho * a.Wo * groups) return;
  const int c = (int)(e % groups) * 8;
  const size_t pix = e / groups;
  const int oy = (int)(pix / a.Wo), ox = (int)(pix % a.Wo);
  float m[8];
  union {
    uint2 raw;
    int8_t t[8];
  } best;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = __int_as_float(0xff800000);  // -inf: a window always holds a pixel
    best.t[j] = 0;
  }
  for (int t = 0; t < 9; ++t) {
    const int iy = 2 * oy - 1 + t / 3, ix = 2 * ox - 1 + t % 3;
    if (iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) continue;
    float v[8];
    st::load8_bf16(x + ((size_t)iy * a.W + ix) * a.C + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (v[j] > m[j]) {
        m[j] = v[j];
        best.t[j] = (int8_t)t;
      }
    }
  }
  const size_t o = pix * a.C + c;
  *reinterpret_cast<uint4*>(y + o) = st::pack8_bf16(m);
  *reinterpret_cast<uint2*>(idx + o) = best.raw;
}

// one thread: eight channels of one input pixel
__global__ void __launch_bounds__(THREADS) maxpool_bwd_kernel(const bf16* __restrict__ dy,
                                                              const int8_t* __restrict__ idx,
                                                              const bf16* __restrict__ add,
                                                              const bf16* __restrict__ gate,
                                                              bf16* __restrict__ dx, PoolArgs a) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int groups = a.C / 8;
  if (e >= (size_t)a.H * a.W * groups) return;
  const int c = (int)(e % groups) * 8;
  const size_t pix = e / groups;
  const int iy = (int)(pix / a.W), ix = (int)(pix % a.W);
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  if (dy != nullptr) {
    for (int ky = 0; ky < 3; ++ky) {
      const int oy = source(iy, ky, 1, 2, a.Ho);
      if (oy < 0) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int ox = source(ix, kx, 1, 2, a.Wo);
        if (ox < 0) continue;
        const size_t o = ((size_t)oy * a.Wo + ox) * a.C + c;
        union {
          uint2 raw;
          int8_t t[8];
        } win;
        win.raw = *reinterpret_cast<const uint2*>(idx + o);
        float v[8];
        st::load8_bf16(dy + o, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (win.t[j] == ky * 3 + kx) s[j] += v[j];
        }
      }
    }
  }
  const size_t o = pix * a.C + c;
  if (add != nullptr) {
    float v[8];
    st::load8_bf16(add + o, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] += v[j];
  }
  if (gate != nullptr) {
    float g[8];
    st::load8_bf16(gate + o, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(g[j] > 0.f)) s[j] = 0.f;
    }
  }
  *reinterpret_cast<uint4*>(dx + o) = st::pack8_bf16(s);
}

// one thread: eight elements
__global__ void __launch_bounds__(THREADS) relu_gate_kernel(const bf16* __restrict__ dy,
                                                            const bf16* __restrict__ gate,
                                                            bf16* __restrict__ out, size_t n8) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n8) return;
  float v[8], g[8];
  st::load8_bf16(dy + 8 * e, v);
  st::load8_bf16(gate + 8 * e, g);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!(g[j] > 0.f)) v[j] = 0.f;
  }
  *reinterpret_cast<uint4*>(out + 8 * e) = st::pack8_bf16(v);
}

}  // namespace

// col (Ho, Wo, Kp) of x (H, W, C); Kp a multiple of 8, at least kh kw C.
ST_EXPORT int st_im2col(const void* x, void* col, int H, int W, int C, int kh, int kw, int stride,
                        int pad, int Ho, int Wo, int Kp, void* stream) {
  if (Kp & 7 || Kp < kh * kw * C) return static_cast<int>(cudaErrorInvalidValue);
  const ColArgs a = {H, W, C, kh, kw, stride, pad, Ho, Wo, Kp};
  const size_t n = (size_t)Ho * Wo * (Kp / 8);
  im2col_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(col), a);
  return static_cast<int>(cudaGetLastError());
}

// dx (H, W, C) from dcol (Ho, Wo, Kp), zero where gate (H, W, C) <= 0 (gate may be null);
// C a multiple of 8, or at most 8.
ST_EXPORT int st_col2im(const void* dcol, const void* gate, void* dx, int H, int W, int C, int kh,
                        int kw, int stride, int pad, int Ho, int Wo, int Kp, void* stream) {
  const ColArgs a = {H, W, C, kh, kw, stride, pad, Ho, Wo, Kp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* d = static_cast<const bf16*>(dcol);
  const bf16* g = static_cast<const bf16*>(gate);
  bf16* o = static_cast<bf16*>(dx);
  if ((C & 7) == 0 && (Kp & 7) == 0) {
    col2im_kernel<8><<<blocks_for((size_t)H * W * (C / 8)), THREADS, 0, s>>>(d, g, o, a);
  } else if (C <= 8) {
    col2im_kernel<0><<<blocks_for((size_t)H * W), THREADS, 0, s>>>(d, g, o, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// y, idx (Ho, Wo, C) of the 3x3 stride-2 max pool (padding 1) of x (H, W, C); C % 8 == 0.
ST_EXPORT int st_maxpool_fwd(const void* x, void* y, void* idx, int H, int W, int C, int Ho,
                             int Wo, void* stream) {
  if (C & 7) return static_cast<int>(cudaErrorInvalidValue);
  const PoolArgs a = {H, W, C, Ho, Wo};
  maxpool_fwd_kernel<<<blocks_for((size_t)Ho * Wo * (C / 8)), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), static_cast<int8_t*>(idx), a);
  return static_cast<int>(cudaGetLastError());
}

// dx (H, W, C) = [gate >] (the pool's adjoint of dy (Ho, Wo, C) [+ add]); dy may be null.
ST_EXPORT int st_maxpool_bwd(const void* dy, const void* idx, const void* add, const void* gate,
                             void* dx, int H, int W, int C, int Ho, int Wo, void* stream) {
  if (C & 7) return static_cast<int>(cudaErrorInvalidValue);
  const PoolArgs a = {H, W, C, Ho, Wo};
  maxpool_bwd_kernel<<<blocks_for((size_t)H * W * (C / 8)), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const int8_t*>(idx),
      static_cast<const bf16*>(add), static_cast<const bf16*>(gate), static_cast<bf16*>(dx), a);
  return static_cast<int>(cudaGetLastError());
}

// out = gate > 0 ? dy : 0 over n elements, n % 8 == 0.
ST_EXPORT int st_relu_gate(const void* dy, const void* gate, void* out, long long n,
                           void* stream) {
  if (n & 7) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n8 = (size_t)n / 8;
  relu_gate_kernel<<<blocks_for(n8), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(gate), static_cast<bf16*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}
