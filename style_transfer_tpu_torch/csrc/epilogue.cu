// Fused loss epilogues: the sum of squared differences of two equally shaped
// tensors AND the difference itself, in one pass.
//   sse  = sum((F - T)^2)   accumulated in fp32 from the fp32 difference
//   diff = F - T            written in F's dtype (rounded after the sum took
//                           the unrounded value)
//
// Replaces style_transfer_tpu/ops/pallas/epilogue.py::content_loss
// (_content_sse_diff / _content_kernel: bf16 or fp32 activations) and
// ::style_loss (_style_sse_dg / _style_kernel: two (C, C) fp32 Grams). The
// two TPU kernels differ only in their blocking (a streamed row grid with an
// SMEM accumulator, and one whole-array block); here one kernel serves both,
// instantiated for bf16 and for fp32. Normalization and the loss weights stay
// outside, as in the reference. The TPU kernel carries the sum across its
// sequential grid; here each block writes a partial sum and a one-block
// second pass adds the partials in a fixed order, so the loss is the same
// run to run (no atomics).
//
// What bounds it on the H100: bytes. conv4_2 at 1024 px is 8.4 M bf16
// elements: two reads and one write of 16.8 MB each at ~3 FLOP per element.
// The style form at C = 64 moves 48 KiB and is bound by the launch.
//
// What this simple design does about it: 16-byte loads and stores (eight bf16
// or four fp32 values per thread per step) in a grid-stride loop, scalar
// handling of the last few elements, a shared-memory tree per block.
#include "common.cuh"

namespace {

constexpr int ENT = 256;
constexpr int EMAX_BLOCKS = 1024;

template <typename T> struct Vec;

template <> struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float* v) { st::load8_bf16(p, v); }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    st::store4_bf16(p, v[0], v[1], v[2], v[3]);
    st::store4_bf16(p + 4, v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <typename T>
__global__ void __launch_bounds__(ENT)
sse_diff_kernel(const T* __restrict__ f, const T* __restrict__ t, T* __restrict__ diff,
                float* __restrict__ partial, size_t n) {
  __shared__ float red[ENT];
  constexpr int V = Vec<T>::N;
  const size_t nvec = n / V;
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * ENT + threadIdx.x; i < nvec; i += (size_t)gridDim.x * ENT) {
    float a[V], b[V], d[V];
    Vec<T>::load(f + i * V, a);
    Vec<T>::load(t + i * V, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      d[j] = a[j] - b[j];
      local = fmaf(d[j], d[j], local);
    }
    Vec<T>::store(diff + i * V, d);
  }
  // the last n % V elements, one thread each
  if (blockIdx.x == 0) {
    const size_t e = nvec * V + threadIdx.x;
    if (threadIdx.x < V && e < n) {
      const float d = Vec<T>::load1(f + e) - Vec<T>::load1(t + e);
      local = fmaf(d, d, local);
      Vec<T>::store1(diff + e, d);
    }
  }
  red[threadIdx.x] = local;
  __syncthreads();
  for (int s = ENT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(ENT)
sse_reduce_kernel(const float* __restrict__ partial, int nblocks, float* __restrict__ out) {
  __shared__ float red[ENT];
  float s = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += ENT) s += partial[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = ENT / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

template <typename T>
int launch_sse_diff(const void* f, const void* t, void* diff, void* partial, void* sse,
                    long long n, int nblocks, cudaStream_t st) {
  sse_diff_kernel<T><<<nblocks, ENT, 0, st>>>(static_cast<const T*>(f), static_cast<const T*>(t),
                                              static_cast<T*>(diff), static_cast<float*>(partial),
                                              static_cast<size_t>(n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sse_reduce_kernel<<<1, ENT, 0, st>>>(static_cast<const float*>(partial), nblocks,
                                       static_cast<float*>(sse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the first pass for n elements; the wrapper sizes `partial` with
// this count. One block up to 2048 elements (the (C, C) Gram at C <= 32).
ST_EXPORT int st_sse_diff_blocks(long long n) {
  const long long b = (n + ENT * 8 - 1) / (ENT * 8);
  return static_cast<int>(b < 1 ? 1 : (b > EMAX_BLOCKS ? EMAX_BLOCKS : b));
}

// sse (1,) fp32 and diff (n,) in the inputs' dtype from f and t (n,), both
// bf16 (is_bf16 != 0) or both fp32; 16-byte aligned.
ST_EXPORT int st_sse_diff(const void* f, const void* t, void* diff, void* partial, void* sse,
                          long long n, int is_bf16, void* stream) {
  const int nblocks = st_sse_diff_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_sse_diff<bf16>(f, t, diff, partial, sse, n, nblocks, st)
                 : launch_sse_diff<float>(f, t, diff, partial, sse, n, nblocks, st);
}
