// Fused total-variation loss and gradient on an fp32 image flattened to
// (H, W*C): squared forward differences summed, and the 5-point-stencil
// gradient of that sum, in one pass over the image.
//
// Replaces style_transfer_tpu/ops/pallas/epilogue.py::tv_loss
// (_tv_sse_grad / _tv_kernel). The TPU kernel carries the sum in SMEM scratch
// across its sequential grid; here each block writes a partial sum and a
// second one-block pass adds the partials in a fixed order (deterministic).
// Boundary terms match _tv_kernel's masks: no H-difference out of the last
// row, no W-difference out of the last pixel column.
//
// What bounds it on the H100: bytes. At 512x512x3 the pass reads 3.1 MB and
// writes 3.1 MB at ~10 FLOP per element, far below the ridge; at 3.35 TB/s
// that is ~2 us, so launch latency dominates at the path's sizes.
//
// What this simple design does about it: one thread per element in a grid-
// stride loop, neighbours read straight from device memory (they hit L1/L2),
// a shared-memory tree for the block's partial sum.
#include "common.cuh"

namespace {

constexpr int TNT = 256;

__global__ void __launch_bounds__(TNT)
tv_kernel(const float* __restrict__ x, float* __restrict__ grad, float* __restrict__ partial,
          int H, int WC, int C) {
  __shared__ float red[TNT];
  const size_t n = (size_t)H * WC;
  float local = 0.f;
  for (size_t e = (size_t)blockIdx.x * TNT + threadIdx.x; e < n; e += (size_t)gridDim.x * TNT) {
    const int r = static_cast<int>(e / WC);
    const int q = static_cast<int>(e % WC);
    const float v = x[e];
    const float dh = (r + 1 < H) ? x[e + WC] - v : 0.f;
    const float dw = (q + C < WC) ? x[e + C] - v : 0.f;
    const float dh_prev = (r > 0) ? v - x[e - WC] : 0.f;
    const float dw_prev = (q >= C) ? v - x[e - C] : 0.f;
    local += dh * dh + dw * dw;
    grad[e] = 2.f * (dh_prev - dh + dw_prev - dw);
  }
  red[threadIdx.x] = local;
  __syncthreads();
  for (int s = TNT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(TNT)
tv_reduce_kernel(const float* __restrict__ partial, int nblocks, float* __restrict__ out) {
  __shared__ float red[TNT];
  float s = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += TNT) s += partial[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = TNT / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

}  // namespace

// Blocks of the first pass; the wrapper sizes `partial` with this count.
ST_EXPORT int st_tv_blocks(int H, int WC) {
  const long long n = (long long)H * WC;
  const long long b = (n + TNT - 1) / TNT;
  return static_cast<int>(b < 1024 ? (b < 1 ? 1 : b) : 1024);
}

// sse (1,) fp32 and grad (H, W*C) fp32 from x (H, W*C) fp32; C is the
// channel stride of one pixel step along W.
ST_EXPORT int st_tv_sse_grad(const void* x, void* grad, void* partial, void* sse, int H, int WC,
                             int C, void* stream) {
  const int nblocks = st_tv_blocks(H, WC);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tv_kernel<<<nblocks, TNT, 0, st>>>(static_cast<const float*>(x), static_cast<float*>(grad),
                                     static_cast<float*>(partial), H, WC, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tv_reduce_kernel<<<1, TNT, 0, st>>>(static_cast<const float*>(partial), nblocks,
                                      static_cast<float*>(sse));
  return static_cast<int>(cudaGetLastError());
}
