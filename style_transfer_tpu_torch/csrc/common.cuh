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
//     N <= 8 * 65535 output channels (gridDim.y / gridDim.z of its smallest
//     tiles), W and K < 2^31; the element count H*W*K is bounded only by
//     memory.
//   gram: M = H*W rows < 2^31, at most 65535 row chunks (gridDim.y; the
//     wrapper asks for a few hundred); gram_fs: M < 2^31 rows.
//   tv: H*W*C elements in size_t, one row W*C < 2^31 - 1024; at most 65535
//     groups of four rows (gridDim.y): H <= 262,140.
//   block1 (fwd, bwd, col2im): persistent blocks walk the 16x16-pixel tiles,
//     so no grid dimension limits H or W; tiles H/16 * W/16 < 2^31 and
//     3 * W < 2^31 (the image row in elements).
//   epilogue (sse, scale_cast): the element count arrives as long long.
// The largest tensors of a 512x8192 panorama (block 1: 512*8192*64 = 268 M
// elements; Gram rows M = 4.19 M) sit far inside; chip_smoke.py runs block 1
// (all three forms) and TV at that size against their plain versions.
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

// ---- tensor-core building blocks (bf16 mma.sync, ldmatrix, cp.async) ----
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 = (row g,     k 2t, 2t+1)   a1 = (row g + 8, k 2t, 2t+1)
//                   a2 = (row g,     k 2t+8, +9)   a3 = (row g + 8, k 2t+8, +9)
//   B (16x8, col):  b0 = (k 2t, 2t+1, col g)       b1 = (k 2t+8, +9, col g)
//   C (16x8, fp32): c0, c1 = (row g, col 2t, 2t+1) c2, c3 = (row g + 8, ...)
// ldmatrix reads four 8x8 bf16 matrices; lanes 8q..8q+7 give the addresses
// of the eight 16-byte rows of matrix q, and register q of every thread gets
// matrix q in the fragment layout above (.trans: of the transposed matrix).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; `valid` false writes zeros
// (src-size 0) and reads nothing, but src must still be a mapped address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// The same for 4 bytes (sources that are only 4-byte aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight fp32 values rounded to bf16 as one 16-byte value.
__device__ __forceinline__ uint4 pack8_bf16(const float* v) {
  uint4 raw;
  __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
  __nv_bfloat162 p2 = __floats2bfloat162_rn(v[4], v[5]);
  __nv_bfloat162 p3 = __floats2bfloat162_rn(v[6], v[7]);
  raw.x = *reinterpret_cast<uint32_t*>(&p0);
  raw.y = *reinterpret_cast<uint32_t*>(&p1);
  raw.z = *reinterpret_cast<uint32_t*>(&p2);
  raw.w = *reinterpret_cast<uint32_t*>(&p3);
  return raw;
}

// ---- deterministic sums: warp shuffles, one value per warp through shared
// memory, and across blocks the last block to arrive adds the partials ----

// Butterfly sum of a warp: every lane ends with the same bits (halves fold
// onto each other: lanes i and i ^ 16, then ^ 8, ... ^ 1).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread of an NT-thread block, valid in warp 0; `red`
// holds NT / 32 floats of shared memory. A second call needs a
// __syncthreads() in between.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x < NT / 32) ? red[threadIdx.x] : 0.f;
  return threadIdx.x < 32 ? warp_sum(v) : 0.f;
}

// out[0] = (sum of `local` over every thread of every block) / numel, in one
// launch and with the same bits from run to run. Each block writes its sum
// to partial[block]; a ticket from `counter` tells the last block to arrive,
// which adds the partials in a fixed order (thread t takes t, t + NT, ...,
// then the block sum) and writes the mean. atomicInc wraps at nblocks - 1,
// so the counter is zero again when the kernel ends; it must be zero at the
// launch and belong to this stream alone. One block needs neither.
template <int NT>
__device__ __forceinline__ void finish_mean(float local, float* partial, unsigned int* counter,
                                            float* out, float numel, unsigned int nblocks,
                                            unsigned int block) {
  __shared__ float red[NT / 32];
  __shared__ bool last;
  const float s = block_sum<NT>(local, red);
  if (nblocks == 1) {
    if (threadIdx.x == 0) out[0] = __fdiv_rn(s, numel);
    return;
  }
  if (threadIdx.x == 0) {
    __stcg(partial + block, s);
    __threadfence();
    last = atomicInc(counter, nblocks - 1) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.f;
  for (unsigned int i = threadIdx.x; i < nblocks; i += NT) t += __ldcg(partial + i);
  t = block_sum<NT>(t, red);
  if (threadIdx.x == 0) out[0] = __fdiv_rn(t, numel);
}

}  // namespace st
