// Gram products on (M, C) bf16 activations with fp32 accumulation:
//   st_gram     G = F^T F                 (forward Gram epilogue)
//   st_gram_fs  F S, S a (C, C) matrix    (backward Gram term)
// Both take an optional column window (W, clo, chi): row m of F is pixel
// column m % W of an (H, W) image, and rows whose column lies outside
// [clo, chi) add nothing to G and get a zero F S row. That is the gram_cols
// ownership mask of conv_single.py::_fwd_kernel (:112-117) and
// ::_bwd_kernel (:182-187): a W slice with halo columns counts only the
// columns it owns. W = 0 means no window.
//
// Replaces the in-kernel Gram syrk and the y.S products of the TPU kernels
//   style_transfer_tpu/ops/pallas/conv_pair.py::_fwd_kernel (acc_ref += f^T f)
//   and ::_bwd_kernel (r1 @ S in post_b),
//   style_transfer_tpu/ops/pallas/conv_gram.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/block1_packed.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/conv_single.py::_fwd_kernel / _bwd_kernel.
// The TPU kernels accumulate the Gram across their sequential grid in VMEM
// scratch; Hopper blocks run in no order, so here each block sums a chunk of
// rows into its own partial (C, C) tile and a second pass adds the partials
// in a fixed order, which keeps the result deterministic run to run.
//
// What bounds it on the H100: at the 512 px scale the largest Gram (conv1_1,
// M = 262144, C = 64) is 2.1 GFLOP over 33.5 MB (64 FLOP/byte) and the deepest
// (conv4_1 at 64x64, C = 512) is 2.1 GFLOP over 4.2 MB; both sit above the
// fp32 CUDA-core ridge (~20 FLOP/byte), so the CUDA-core FMA rate bounds them.
// The F S products have the same shapes and the same bound.
//
// What this simple design does about it: a plain shared-memory tiled product
// on the CUDA cores (64x64 output tile per block, 4x4 per thread, operands
// staged as fp32), with enough row chunks to fill the card. No tensor cores
// yet, and the Gram's symmetry is not exploited.
#include "common.cuh"

namespace {

constexpr int GT = 64;    // output tile edge
constexpr int GR = 32;    // rows staged per step (Gram)
constexpr int FK = 16;    // reduction channels staged per step (F S)
constexpr int GNT = 256;  // threads per block

// Column window of the Gram rows (see the header); wcols <= 0: every row.
struct Window {
  int wcols, clo, chi;
  __device__ __forceinline__ bool owns(int m) const {
    if (wcols <= 0) return true;
    const int c = m % wcols;
    return c >= clo && c < chi;
  }
};

__global__ void __launch_bounds__(GNT)
gram_partial_kernel(const bf16* __restrict__ f, float* __restrict__ part, int M, int C, int rows,
                    Window win) {
  __shared__ __align__(16) float a_s[GR][GT];
  __shared__ __align__(16) float b_s[GR][GT];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int m_begin = blockIdx.z * rows;
  const int m_end = min(M, m_begin + rows);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += GR) {
    for (int e = tid; e < GR * (GT / 8); e += GNT) {
      const int r = e / (GT / 8), c8 = (e % (GT / 8)) * 8, m = m0 + r;
      float va[8], vb[8];
      if (m < m_end && win.owns(m)) {
        st::load8_bf16(f + (size_t)m * C + i0 + c8, va);
        st::load8_bf16(f + (size_t)m * C + j0 + c8, vb);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) { va[j] = 0.f; vb[j] = 0.f; }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a_s[r][c8 + j] = va[j];
        b_s[r][c8 + j] = vb[j];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < GR; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[r][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[r][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      part[((size_t)blockIdx.z * C + i0 + ty * 4 + i) * C + j0 + tx * 4 + j] = acc[i][j];
    }
}

__global__ void gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   int nchunks, int cc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cc) return;
  float s = 0.f;
  for (int z = 0; z < nchunks; ++z) s += part[(size_t)z * cc + e];
  out[e] = s;
}

// out32 = F S (fp32), or, when out16 is given, out16 = bf16(F > 0 ? F S : 0).
__global__ void __launch_bounds__(GNT)
gram_fs_kernel(const bf16* __restrict__ f, const bf16* __restrict__ s, float* __restrict__ out32,
               bf16* __restrict__ out16, int M, int C, Window win) {
  __shared__ __align__(16) float f_s[FK][GT];  // [k][m]
  __shared__ __align__(16) float s_s[FK][GT];  // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * GT, n0 = blockIdx.y * GT;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += FK) {
    if (tid < GT * FK / 8) {
      // F tile: 64 rows x 16 channels, stored transposed
      const int r = tid / (FK / 8), k8 = (tid % (FK / 8)) * 8, m = m0 + r;
      float v[8];
      if (m < M && win.owns(m)) {
        st::load8_bf16(f + (size_t)m * C + k0 + k8, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) f_s[k8 + j][r] = v[j];
    } else {
      // S tile: 16 rows x 64 columns
      const int e = tid - GT * FK / 8;
      const int k = e / (GT / 8), n8 = (e % (GT / 8)) * 8;
      float v[8];
      st::load8_bf16(s + (size_t)(k0 + k) * C + n0 + n8, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_s[k][n8 + j] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 fv = *reinterpret_cast<const float4*>(&f_s[k][ty * 4]);
      const float4 sv = *reinterpret_cast<const float4*>(&s_s[k][tx * 4]);
      const float fi[4] = {fv.x, fv.y, fv.z, fv.w};
      const float sj[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(fi[i], sj[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = (size_t)m * C + n0 + tx * 4 + j;
      if (out16 != nullptr) {
        out16[o] = __float2bfloat16_rn(__bfloat162float(f[o]) > 0.f ? acc[i][j] : 0.f);
      } else {
        out32[o] = acc[i][j];
      }
    }
  }
}

}  // namespace

// Rows of F per partial sum; the wrapper sizes `part` as ceil(M / rows) x C x C.
ST_EXPORT int st_gram_rows_per_chunk() { return 2048; }

// out (C, C) fp32 = F^T F for F (M, C) bf16, C % 64 == 0, over the rows in
// the column window (wcols = 0: all rows).
ST_EXPORT int st_gram(const void* f, void* part, void* out, int M, int C, int wcols, int clo,
                      int chi, void* stream) {
  const int rows = st_gram_rows_per_chunk();
  const int nchunks = (M + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_partial_kernel<<<dim3(C / GT, C / GT, nchunks), GNT, 0, st>>>(
      static_cast<const bf16*>(f), static_cast<float*>(part), M, C, rows, Window{wcols, clo, chi});
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cc = C * C;
  gram_reduce_kernel<<<(cc + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                       static_cast<float*>(out), nchunks, cc);
  return static_cast<int>(cudaGetLastError());
}

// F (M, C) bf16 times S (C, C) bf16, C % 64 == 0: fp32 into out32, or the
// ReLU-gated bf16 result into out16 when out16 is not null. Rows outside the
// column window (wcols = 0: none) are zero.
ST_EXPORT int st_gram_fs(const void* f, const void* s, void* out32, void* out16, int M, int C,
                         int wcols, int clo, int chi, void* stream) {
  gram_fs_kernel<<<dim3((M + GT - 1) / GT, C / GT), GNT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(s), static_cast<float*>(out32),
      static_cast<bf16*>(out16), M, C, Window{wcols, clo, chi});
  return static_cast<int>(cudaGetLastError());
}
