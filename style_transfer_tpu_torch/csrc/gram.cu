// Gram products on (M, C) bf16 activations on the tensor cores, with fp32
// accumulation:
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
//   style_transfer_tpu/ops/pallas/conv_single.py::_fwd_kernel / _bwd_kernel,
//   style_transfer_tpu/ops/pallas/gram.py::_gram_kernel.
// The TPU kernels accumulate the Gram across their sequential grid in VMEM
// scratch; Hopper blocks run in no order, so here each block sums a chunk of
// rows into its own partial tile and a second pass adds the partials in a
// fixed order (no atomics), which keeps the result bit-identical run to run.
//
// What bounds them on the H100: at C = 64 the bytes of F (conv1_1 at 512 px:
// 33.5 MB read for 2.1 GFLOP, 64 FLOP/byte, far under the bf16 ridge of
// ~295); at C = 512 the operations (conv4_1 at 64x64: 2.1 GFLOP over
// 4.2 MB). Small activations are bound by neither but by how many blocks
// there are and how long each one's serial loop is.
//
// The design. Both products run on mma.sync.aligned.m16n8k16 (bf16 -> fp32)
// with operands staged by cp.async (16 bytes, zero-filled for rows outside
// the chunk or the window) into a three-stage ring of shared memory and
// read through ldmatrix; rows are padded by 16 bytes so the eight rows of an
// 8x8 ldmatrix fall into different bank groups.
// - F^T F: a block owns one 64x64 tile of G for one chunk of rows; 4 warps,
//   32x32 a warp. F lies row-major, so A = F^T is read with ldmatrix.trans
//   from the [row][channel] tile, and B = F with ldmatrix.trans as well. G is
//   symmetric: only the T (T + 1) / 2 tiles on and above the diagonal are
//   computed (a diagonal tile stages its slice of F once), and the reduce
//   pass mirrors them. The wrapper chooses the rows per chunk from M and C
//   (`gram_rows_per_chunk` in ops/kernels/_launch.py) so that the grid has at
//   least two blocks per SM, or 64-row chunks when M is too small for that.
//   The reduce pass adds the chunks in a fixed tree: eight warps of a block
//   each add every eighth chunk, then the eight sums are added in order.
// - F S: a block owns 64 rows x BN columns (BN = 128, or 64 when C is not a
//   multiple of 128), 32x32 a warp, and streams F and S in chunks of 32
//   channels; S stays in L2 (at most 512 KB). The epilogue stores fp32, or
//   the bf16 value (ReLU-gated by F > 0 on request), straight from the
//   accumulator fragments.
#include "common.cuh"

namespace {

constexpr int GT = 64;            // output tile edge (F^T F), rows per block (F S)
constexpr int GR = 64;            // rows of F staged per step (F^T F)
constexpr int GSTAGES = 3;
constexpr int GSTRIDE = GT + 8;   // bf16 per staged row of a 64-channel slice
constexpr int GSLICE_BYTES = GR * GSTRIDE * 2;
constexpr int GSTAGE_BYTES = 2 * GSLICE_BYTES;
constexpr int GSMEM = GSTAGES * GSTAGE_BYTES;  // 55296
constexpr int GNT = 128;          // threads per block (F^T F)
constexpr int GRED = 32;          // elements of G per block of the reduce pass

// Column window of the Gram rows (see the header); wcols <= 0: every row.
struct Window {
  int wcols, clo, chi;
  __device__ __forceinline__ bool owns(int m) const {
    if (wcols <= 0) return true;
    const int c = m % wcols;
    return c >= clo && c < chi;
  }
};

// part[chunk][i][j] for the tiles with tile row <= tile column.
__global__ void __launch_bounds__(GNT)
gram_partial_kernel(const bf16* __restrict__ f, float* __restrict__ part, int M, int C, int rows,
                    Window win) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  // blockIdx.x enumerates the upper-triangle tiles row by row
  const int T = C / GT;
  int ti = 0, rem = blockIdx.x;
  while (rem >= T - ti) { rem -= T - ti; ++ti; }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int i0 = ti * GT, j0 = tj * GT;
  const long long m_begin = (long long)blockIdx.y * rows;
  const int m_end = (int)min((long long)M, m_begin + rows);
  const int nsteps = m_begin < m_end ? (int)((m_end - m_begin + GR - 1) / GR) : 0;
  const uint32_t smem32 = st::smem_u32(smem);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto load = [&](int s) {
    const uint32_t dst = smem32 + (s % GSTAGES) * GSTAGE_BYTES;
    const int m0 = (int)m_begin + s * GR;
    const int items = GR * 8 * (diag ? 1 : 2);
    for (int e = tid; e < items; e += GNT) {
      const int c8 = e & 7, r = (e >> 3) % GR, slice = e / (GR * 8);
      const int m = m0 + r;
      const bool valid = m < m_end && win.owns(m);
      const bf16* src = valid ? f + (size_t)m * C + (slice ? j0 : i0) + c8 * 8 : f;
      st::cp_async16(dst + slice * GSLICE_BYTES + (r * GSTRIDE + c8 * 8) * 2, src, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < nsteps) load(s);
    st::cp_async_commit();
  }
  // ldmatrix.trans row addresses: A = F^T (matrix q: rows m + 8 (q / 2),
  // channels i + 8 (q % 2)), B = F (matrix q: rows m + 8 (q % 2), channels
  // j + 8 (q / 2))
  const int q = lane >> 3;
  const uint32_t a_lane = (((lane & 7) + (q >> 1) * 8) * GSTRIDE + wm * 32 + (q & 1) * 8) * 2;
  const uint32_t b_lane = (((lane & 7) + (q & 1) * 8) * GSTRIDE + wn * 32 + (q >> 1) * 8) * 2;
  for (int s = 0; s < nsteps; ++s) {
    st::cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    if (s + GSTAGES - 1 < nsteps) load(s + GSTAGES - 1);
    st::cp_async_commit();
    const uint32_t sa = smem32 + (s % GSTAGES) * GSTAGE_BYTES;
    const uint32_t sb = diag ? sa : sa + GSLICE_BYTES;
#pragma unroll
    for (int ks = 0; ks < GR / 16; ++ks) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st::ldmatrix_x4_trans(sa + a_lane + (ks * 16 * GSTRIDE + i * 16) * 2, af[i]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        st::ldmatrix_x4_trans(sb + b_lane + (ks * 16 * GSTRIDE + j * 16) * 2, r);
        bfr[2 * j][0] = r[0]; bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2]; bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st::mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  st::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  float* dst = part + (size_t)blockIdx.y * C * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = i0 + wm * 32 + i * 16 + g, col = j0 + wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dst + (size_t)row * C + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * C + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// out[i][j] = sum over chunks of part[chunk][i][j], read from the mirrored
// element below the diagonal tiles. Warp w of a block adds chunks w, w + 8,
// ... for 32 consecutive elements; the eight sums are then added in order.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int nchunks, int C) {
  __shared__ float sums[8][GRED];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * GRED + lane;  // C * C is a multiple of 32
  const int i = e / C, j = e % C;
  const size_t src = (i / GT <= j / GT) ? (size_t)i * C + j : (size_t)j * C + i;
  const size_t cc = (size_t)C * C;
  float s = 0.f;
#pragma unroll 4
  for (int z = warp; z < nchunks; z += 8) s += part[(size_t)z * cc + src];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float total = sums[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) total += sums[w][lane];
    out[e] = total;
  }
}

constexpr int FK = 32;            // reduction channels staged per step (F S)
constexpr int FA_STRIDE = FK + 8; // bf16 per staged row of F
constexpr int FSTAGES = 3;

// out32 = F S (fp32), or, when out16 is given, out16 = bf16(F S), with
// `gated` bf16(F > 0 ? F S : 0).
template <int BN>
__global__ void __launch_bounds__(2 * BN)
gram_fs_kernel(const bf16* __restrict__ f, const bf16* __restrict__ s, float* __restrict__ out32,
               bf16* __restrict__ out16, int M, int C, int gated, Window win) {
  constexpr int NT = 2 * BN;  // 2 x (BN / 32) warps
  constexpr int WARPS_N = BN / 32;
  constexpr int B_STRIDE = BN + 8;
  constexpr int A_BYTES = GT * FA_STRIDE * 2;
  constexpr int STAGE_BYTES = A_BYTES + FK * B_STRIDE * 2;
  __shared__ __align__(128) unsigned char smem[FSTAGES * STAGE_BYTES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * GT, n0 = blockIdx.y * BN;
  const uint32_t smem32 = st::smem_u32(smem);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto load = [&](int c) {
    const uint32_t dst = smem32 + (c % FSTAGES) * STAGE_BYTES;
    const int k0 = c * FK;
    for (int e = tid; e < GT * (FK / 8); e += NT) {
      const int c8 = e % (FK / 8), r = e / (FK / 8), m = m0 + r;
      const bool valid = m < M && win.owns(m);
      const bf16* src = valid ? f + (size_t)m * C + k0 + c8 * 8 : f;
      st::cp_async16(dst + (r * FA_STRIDE + c8 * 8) * 2, src, valid);
    }
    for (int e = tid; e < FK * (BN / 8); e += NT) {
      const int n8 = e % (BN / 8), k = e / (BN / 8);
      st::cp_async16(dst + A_BYTES + (k * B_STRIDE + n8 * 8) * 2,
                     s + (size_t)(k0 + k) * C + n0 + n8 * 8, true);
    }
  };

  const int nchunks = C / FK;
#pragma unroll
  for (int c = 0; c < FSTAGES - 1; ++c) {
    if (c < nchunks) load(c);
    st::cp_async_commit();
  }
  const uint32_t a_lane = ((wm * 32 + (lane & 15)) * FA_STRIDE + (lane >> 4) * 8) * 2;
  const uint32_t b_lane =
      A_BYTES + (((lane & 7) + ((lane >> 3) & 1) * 8) * B_STRIDE + wn * 32 + (lane >> 4) * 8) * 2;
  for (int c = 0; c < nchunks; ++c) {
    st::cp_async_wait<FSTAGES - 2>();
    __syncthreads();
    if (c + FSTAGES - 1 < nchunks) load(c + FSTAGES - 1);
    st::cp_async_commit();
    const uint32_t sa = smem32 + (c % FSTAGES) * STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < FK / 16; ++ks) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st::ldmatrix_x4(sa + a_lane + (i * 16 * FA_STRIDE + ks * 16) * 2, af[i]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        st::ldmatrix_x4_trans(sa + b_lane + (ks * 16 * B_STRIDE + j * 16) * 2, r);
        bfr[2 * j][0] = r[0]; bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2]; bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st::mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  st::cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t o = (size_t)m * C + n0 + wn * 32 + j * 8 + 2 * t4;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (out16 != nullptr) {
          float2 fv = make_float2(1.f, 1.f);
          if (gated) fv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f + o));
          *reinterpret_cast<__nv_bfloat162*>(out16 + o) =
              __floats2bfloat162_rn(fv.x > 0.f ? v0 : 0.f, fv.y > 0.f ? v1 : 0.f);
        } else {
          *reinterpret_cast<float2*>(out32 + o) = make_float2(v0, v1);
        }
      }
    }
}

}  // namespace

// out (C, C) fp32 = F^T F for F (M, C) bf16, C % 64 == 0, over the rows in
// the column window (wcols = 0: all rows), summed in chunks of `rows` rows
// (a multiple of 64): part holds ceil(M / rows) x C x C fp32 of scratch.
ST_EXPORT int st_gram(const void* f, void* part, void* out, int M, int C, int rows, int wcols,
                      int clo, int chi, void* stream) {
  if (rows <= 0 || rows % GR || C % GT) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nchunks = (M + rows - 1) / rows;
  const int T = C / GT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_partial_kernel<<<dim3(T * (T + 1) / 2, nchunks), GNT, GSMEM, st>>>(
      static_cast<const bf16*>(f), static_cast<float*>(part), M, C, rows, Window{wcols, clo, chi});
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<C * C / GRED, 256, 0, st>>>(static_cast<const float*>(part),
                                                    static_cast<float*>(out), nchunks, C);
  return static_cast<int>(cudaGetLastError());
}

// F (M, C) bf16 times S (C, C) bf16, C % 64 == 0: fp32 into out32, or, when
// out16 is not null, the bf16 result into out16, ReLU-gated by F > 0 when
// `gated`. Rows outside the column window (wcols = 0: none) are zero.
ST_EXPORT int st_gram_fs(const void* f, const void* s, void* out32, void* out16, int gated, int M,
                         int C, int wcols, int clo, int chi, void* stream) {
  if (C % GT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Window win{wcols, clo, chi};
  const int row_tiles = (M + GT - 1) / GT;
  if (C % 128 == 0) {
    gram_fs_kernel<128><<<dim3(row_tiles, C / 128), 256, 0, st>>>(
        static_cast<const bf16*>(f), static_cast<const bf16*>(s), static_cast<float*>(out32),
        static_cast<bf16*>(out16), M, C, gated, win);
  } else {
    gram_fs_kernel<64><<<dim3(row_tiles, C / 64), 128, 0, st>>>(
        static_cast<const bf16*>(f), static_cast<const bf16*>(s), static_cast<float*>(out32),
        static_cast<bf16*>(out16), M, C, gated, win);
  }
  return static_cast<int>(cudaGetLastError());
}
