// Shared helpers for the hand-written Hopper kernels of style_transfer_tpu_torch.
//
// Every entry point has a plain C interface (loaded with ctypes): pointers and
// the CUDA stream arrive as void*, sizes as int. Each entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
//
// Index widths. Sizes arrive as int; every element offset is computed in
// size_t. What each kernel's indexing supports:
//   conv3x3 (fwd, bwd-data): H <= 8 * 65535 = 524,280 rows and
//     N <= 64 * 65535 output channels (gridDim.y / gridDim.z of its tiles),
//     W and K < 2^31; the element count H*W*K is bounded only by memory.
//   gram: M = H*W rows <= 2048 * 65535 = 134,215,680 (gridDim.z of its
//     2048-row partials); gram_fs: M < 2^31 rows.
//   tv: H*W*C elements in size_t, one row W*C < 2^31.
// The largest tensors of a 512x8192 panorama (block 1: 512*8192*64 = 268 M
// elements; Gram rows M = 4.19 M) sit far inside; chip_smoke.py runs block 1
// and TV at that size against their plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ST_EXPORT extern "C" __attribute__((visibility("default")))

using bf16 = __nv_bfloat16;

namespace st {

// Eight consecutive bf16 values (one 16-byte load) widened to fp32.
__device__ __forceinline__ void load8_bf16(const bf16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Four fp32 values rounded to bf16 and stored as one 8-byte write.
__device__ __forceinline__ void store4_bf16(bf16* dst, float a, float b, float c, float d) {
  uint2 raw;
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

}  // namespace st
