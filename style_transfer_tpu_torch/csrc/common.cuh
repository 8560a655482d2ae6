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

#include <cuda.h>
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

// ---- warpgroup MMA (wgmma, sm_90a): both operands from shared memory ----
//
// A shared-memory matrix descriptor without swizzle describes an operand as
// "core matrices" of 8 rows x 16 bytes (8 bf16), each 128 contiguous bytes
// (rows 16 bytes apart). LBO is the byte distance between core matrices
// adjacent in K, SBO between those adjacent in M (A, K-major) or N (B,
// N-major: a core matrix is then 8 k rows of 8 consecutive n). Start
// address, LBO and SBO are stored in 16-byte units; the start needs only
// 16-byte alignment.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// The same for an operand in the 128-byte swizzle: 1024-byte atoms of 8 rows
// of 128 bytes, whose 16-byte chunks sit at chunk ^ (row % 8); the atoms
// start on 1024-byte boundaries. For an N-major operand LBO is the distance
// between atoms adjacent in N (64 bf16 apart), SBO between those adjacent in
// K (8 rows apart).
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return smem_desc(addr, lbo, sbo) | (1ull << 62);
}

// ---- mbarriers and the tensor memory accelerator (TMA) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialized mbarriers visible to the async proxy (TMA completions).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, announcing `bytes` that TMA loads will complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// One box of a tensor map (a __grid_constant__ kernel parameter) into shared
// memory at dst, completing its bytes on the mbarrier; coordinates innermost
// first, elements outside the tensor are zero.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One box of shared memory at src into a tensor map's tensor (the reverse of
// tma_load_3d): elements outside the tensor are not written. The store joins
// this thread's current bulk group (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) of global memory at src into shared memory at
// dst, both 16-byte aligned, completing its bytes on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 32-bit shared-memory load and store by shared address (ld/st.shared, not
// the generic path); volatile, so they keep their order with the barrier
// waits around them.
__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// A warpgroup's registers a thread, lowered or raised to N (a multiple of 8,
// 24-256) once its role is known; every warp of the warpgroup runs it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed bulk groups still read
// their shared-memory source (the source may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's committed bulk groups are pending
// (their writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread (st.shared, cp.async once waited for)
// made visible to the async proxy that wgmma reads through; a barrier after
// it makes everyone's visible.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to accumulators that an
// asynchronous wgmma may still write across this point.
template <int R>
__device__ __forceinline__ void wgmma_hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32) = A (64 x 16 bf16, K-major; with TRANS_A, M-major:
// the transposed layout, as an N-major B lies) * B (16 x 128 bf16,
// N-major) + (accumulate ? d : 0), both operands by descriptor. Accumulator
// layout (warp q of the warpgroup, g = lane / 4, t = lane % 4): d[4j + 0, 1]
// = row 16q + g, columns 8j + 2t, +1; d[4j + 2, 3] = row 16q + g + 8, the
// same columns. The first product of a sum starts it (accumulate false):
// zeroing d with other instructions instead makes ptxas serialize the
// wgmmas that follow.
template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16_bf16_tb(float (&d)[64], uint64_t da,
                                                         uint64_t db, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)), "n"(TRANS_A));
}

// The same product 64 columns wide: d (64 x 64 fp32) = A (64 x 16) * B (16
// x 64) + (accumulate ? d : 0), d[4j ...] as above for j < 8.
template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64k16_bf16_tb(float (&d)[32], uint64_t da, uint64_t db,
                                                        bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)), "n"(TRANS_A));
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

// ---- host side: tensor maps and the card's SM count ----

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

constexpr int MAX_DEVICES = 64;

// Streaming multiprocessors of device dev (0 where it cannot be read).
inline int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms[dev] = 0;
  }
  return sms[dev];
}

}  // namespace st
