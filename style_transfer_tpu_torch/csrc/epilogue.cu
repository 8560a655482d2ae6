// Fused loss epilogues: mean((F - T)^2) of two equally shaped tensors in one
// launch, and its gradient in one more.
//   forward   mean = sum((F - T)^2) / numel   fp32, from the unrounded fp32
//                                             difference
//   backward  g = diff * ((2 ct) / numel)     diff = F - T rounded once to F's
//                                             dtype, the product in fp32,
//                                             rounded once more
//
// Replaces style_transfer_tpu/ops/pallas/epilogue.py::content_loss
// (_content_sse_diff / _content_kernel with its _content_bwd: bf16 or fp32
// activations) and ::style_loss (_style_sse_dg / _style_kernel with
// _style_bwd: two (C, C) fp32 Grams). The two TPU kernels differ only in
// their blocking (a streamed row grid with an SMEM accumulator, and one
// whole-array block), and XLA fuses their backward chain (cast up, scale,
// cast down) into one pass; here one forward kernel and one backward kernel
// serve both, instantiated for bf16 and for fp32. The reference's forward
// also stores the difference for its backward; here the backward forms it
// again from F and T (the same rounding, so the same bits): the traffic is
// the same, the forward is a pure read, and no buffer the size of F lives
// between the passes (with the difference stored, the pair took 0.030 ms
// instead of 0.026 at conv4_2's bf16 shape on an H100; equal in fp32). The
// backward is the reference's chain bit for bit: the scale is formed as
// (2 ct) / numel in fp32 from the cotangent on the device (no host read),
// then one multiply and one rounding.
//
// What bounds it on the H100: bytes, and below a few hundred KB the launch.
// conv4_2 at 1024 px is 8.4 M bf16 elements: the forward reads 2 x 16.8 MB,
// the backward reads them again and writes 16.8 MB, at ~3 FLOP per element.
// A 64 x 64 fp32 Gram is 16 KB: one block, and the time is the two launches.
//
// What the design does about it: 16-byte loads, four per operand in flight
// per thread before the first use (eight independent loads cover the
// latency of device memory), a grid sized by the caller from the SM count,
// warp-shuffle block sums, and the cross-block sum finished inside the same
// launch by the last block to arrive (st::finish_mean: fixed order, so the
// loss has the same bits run to run; no second launch, no division outside).
// Up to ENT * 4 vectors (a 64 x 64 fp32 Gram) the caller asks for one block,
// which does everything. Eight loads in flight per operand gained 5% at
// conv4_2 and lost 13% at a 512 x 512 Gram.
#include "common.cuh"

namespace {

constexpr int ENT = 256;  // threads per block
constexpr int EU = 4;     // 16-byte loads per operand in flight per thread

template <typename T> struct Vec;

template <> struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) { return st::pack8_bf16(v); }
  static __device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
  // the value a stored difference has: rounded once to bf16
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* v) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

// EU vectors of one operand for this thread, `stride` vectors apart (each
// load of the block is one contiguous run); zeros beyond nvec.
template <typename T>
__device__ __forceinline__ void load_vectors(const T* __restrict__ p, size_t first, size_t stride,
                                             size_t nvec, uint4 (&raw)[EU]) {
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    const size_t i = first + (size_t)u * stride;
    raw[u] = i < nvec ? __ldg(reinterpret_cast<const uint4*>(p) + i) : make_uint4(0, 0, 0, 0);
  }
}

// Forward. Thread t of block b takes the vectors ((k * EU + u) * grid + b) *
// ENT + t for k = 0, 1, ... and u = 0..EU-1 (any grid covers any n), and
// adds their squares to one fp32 sum in that order; block 0 adds the last
// n % V elements.
template <typename T>
__global__ void __launch_bounds__(ENT)
sse_kernel(const T* __restrict__ f, const T* __restrict__ t, float* partial,
           unsigned int* counter, float* out, size_t n, float numel) {
  constexpr int V = Vec<T>::N;
  const size_t nvec = n / V;
  const size_t stride = (size_t)gridDim.x * ENT;
  float local = 0.f;
  for (size_t first = (size_t)blockIdx.x * ENT + threadIdx.x; first < nvec; first += stride * EU) {
    uint4 ra[EU], rb[EU];
    load_vectors<T>(f, first, stride, nvec, ra);
    load_vectors<T>(t, first, stride, nvec, rb);
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      float a[V], b[V];
      Vec<T>::unpack(ra[u], a);
      Vec<T>::unpack(rb[u], b);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = a[j] - b[j];
        local = fmaf(d, d, local);
      }
    }
  }
  if (blockIdx.x == 0) {
    const size_t e = nvec * V + threadIdx.x;
    if (threadIdx.x < V && e < n) {
      const float d = Vec<T>::load1(f + e) - Vec<T>::load1(t + e);
      local = fmaf(d, d, local);
    }
  }
  st::finish_mean<ENT>(local, partial, counter, out, numel, gridDim.x, blockIdx.x);
}

// Backward: out = round(f - t) * ((2 ct) / numel), rounded once more. Thread
// t of block b takes the vectors (u * grid + b) * ENT + t, u = 0..EU-1, so the
// grid must have at least nvec / (ENT * EU) blocks; block 0 takes the last
// n % V elements. ct is read as one scalar.
template <typename T>
__global__ void __launch_bounds__(ENT)
scale_cast_kernel(const T* __restrict__ f, const T* __restrict__ t, const float* __restrict__ ct,
                  T* __restrict__ out, size_t n, float numel) {
  constexpr int V = Vec<T>::N;
  const size_t nvec = n / V;
  const float scale = __fdiv_rn(__fmul_rn(2.f, __ldg(ct)), numel);
  const size_t stride = (size_t)gridDim.x * ENT;
  const size_t first = (size_t)blockIdx.x * ENT + threadIdx.x;
  uint4 ra[EU], rb[EU];
  load_vectors<T>(f, first, stride, nvec, ra);
  load_vectors<T>(t, first, stride, nvec, rb);
#pragma unroll
  for (int u = 0; u < EU; ++u) {
    float a[V], b[V];
    Vec<T>::unpack(ra[u], a);
    Vec<T>::unpack(rb[u], b);
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = __fmul_rn(Vec<T>::round(a[j] - b[j]), scale);
    const size_t i = first + (size_t)u * stride;
    if (i < nvec) reinterpret_cast<uint4*>(out)[i] = Vec<T>::pack(a);
  }
  if (blockIdx.x == 0) {
    const size_t e = nvec * V + threadIdx.x;
    if (threadIdx.x < V && e < n) {
      const float d = Vec<T>::round(Vec<T>::load1(f + e) - Vec<T>::load1(t + e));
      Vec<T>::store1(out + e, __fmul_rn(d, scale));
    }
  }
}

__global__ void noop_kernel() {}

template <typename T>
int launch_sse(const void* f, const void* t, void* partial, void* counter, void* out, long long n,
               float numel, int nblocks, cudaStream_t st) {
  sse_kernel<T><<<nblocks, ENT, 0, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(t), static_cast<float*>(partial),
      static_cast<unsigned int*>(counter), static_cast<float*>(out), static_cast<size_t>(n), numel);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scale_cast(const void* f, const void* t, const void* ct, void* out, long long n,
                      float numel, int nblocks, cudaStream_t st) {
  const long long nvec = n / Vec<T>::N;
  if (nblocks < 1 || nblocks < (nvec + ENT * EU - 1) / (ENT * EU)) {
    return static_cast<int>(cudaErrorInvalidValue);  // the grid would leave vectors out
  }
  scale_cast_kernel<T><<<nblocks, ENT, 0, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(t), static_cast<const float*>(ct),
      static_cast<T*>(out), static_cast<size_t>(n), numel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// info[0..1] = threads per block and 16-byte loads per operand in flight per
// thread, for the wrapper's model of the grid (_launch.sse_blocks).
ST_EXPORT int st_sse_info(int* info) {
  info[0] = ENT;
  info[1] = EU;
  return 0;
}

// out (0-d fp32) = mean((f - t)^2) over n >= 1 elements, both bf16 (is_bf16
// != 0) or both fp32, 16-byte aligned. nblocks from the wrapper (1 = no
// partials); partial holds nblocks floats; counter is one zeroed unsigned int
// of this stream; numel = n as a float.
ST_EXPORT int st_sse(const void* f, const void* t, void* partial, void* counter, void* out,
                     long long n, float numel, int nblocks, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_sse<bf16>(f, t, partial, counter, out, n, numel, nblocks, st)
                 : launch_sse<float>(f, t, partial, counter, out, n, numel, nblocks, st);
}

// out (n,) = round(f - t) * ((2 ct[0]) / numel); f, t, out bf16 or fp32
// alike, 16-byte aligned; ct one fp32 value on the device (4-byte aligned);
// nblocks from the wrapper, at least n / (threads * loads in flight *
// elements per 16 bytes).
ST_EXPORT int st_scale_cast(const void* f, const void* t, const void* ct, void* out, long long n,
                            float numel, int nblocks, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_scale_cast<bf16>(f, t, ct, out, n, numel, nblocks, st)
                 : launch_scale_cast<float>(f, t, ct, out, n, numel, nblocks, st);
}

// An empty kernel: what a launch costs on the card with no work in it.
ST_EXPORT int st_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
