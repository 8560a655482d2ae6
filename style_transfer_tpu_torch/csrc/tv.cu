// Fused total-variation loss on an fp32 image flattened to (H, W*C): the mean
// of the squared forward differences in one launch, and its 5-point-stencil
// gradient in one more.
//   forward   mean = (sum dh^2 + sum dw^2) / numel,  dh = x[r+1][q] - x[r][q],
//                                                    dw = x[r][q+C] - x[r][q]
//   backward  g * (ct / numel),  g = 2 (dh[r-1] - dh[r] + dw[q-C] - dw[q]),
//             computed from the image again
//
// Replaces style_transfer_tpu/ops/pallas/epilogue.py::tv_loss (_tv_sse_grad /
// _tv_kernel with _tv_bwd). The TPU kernel carries the sum in SMEM scratch
// across its sequential grid, writes the raw gradient in its forward and
// lets XLA scale it in the backward; here the last block to arrive adds the
// blocks' partial sums in a fixed order (st::finish_mean: one launch, the
// same bits run to run), and the backward is a kernel that reads the
// cotangent on the device and forms the stencil itself. Boundary terms match
// _tv_kernel's masks: no H-difference out of the last row, no W-difference
// out of the last pixel column. The gradient is the reference's expression
// in the reference's order, so it has the reference's bits.
//
// What bounds it on the H100: bytes, and at 512x512x3 (3.1 MB, resident in
// L2) the two launches. At 512x8192x3 the image is 50 MB: a forward that
// stores the gradient and a backward that scales it move 4 x 50 MB, a
// forward that only reads and a backward that recomputes 3 x 50 MB (0.078
// against 0.059 ms on an H100; 0.0073 against 0.0068 at 512x512x3), and the
// image is the leaf of the optimization, alive at the backward anyway.
//
// What the design does about it: a 2-D grid (column chunks x row groups, so
// no division per element); a thread owns V = 4 adjacent columns of TR rows
// and starts all its loads before the first use. For an RGB image (C = 3,
// W*C a multiple of 4) every load is 16 bytes: the pixels to the right and
// left lie 12 bytes away, on no 16-byte boundary, so a thread loads the
// aligned 16 bytes right and left of its own and picks three values of each
// (lines that the block loads anyway: L1 hits; eight scalar loads a row
// instead, four lines a warp each, kept L1 as busy as device memory). Any
// other image takes V = 1, one column a thread. The halo rows are re-read by
// the neighbouring block, out of L2.
#include "common.cuh"

namespace {

constexpr int TNT = 256;  // threads per block
constexpr int TR = 4;     // rows per block

template <int V>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float* v) {
  if (V == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Block (bx, by) takes columns [bx * TNT * V, +TNT * V) of rows [by * TR,
// +TR). A thread first starts every load it needs (its TR rows, the row
// above and below, and for V = 4 the 16 bytes right and left of each of its
// rows), then adds dh^2 then dw^2 of its columns, left to right, row by row,
// to one fp32 sum (GRAD false: the mean), or writes the gradient times ct /
// numel (GRAD true). V = 4 needs C = 3 and W*C a multiple of 4: the pixel to
// the right of column q0 + j is own column 3 for j = 0 and column j - 1 of
// the vector to the right otherwise, and mirrored to the left.
template <int V, bool GRAD>
__global__ void __launch_bounds__(TNT)
tv_kernel(const float* __restrict__ x, const float* __restrict__ ct, float* __restrict__ grad,
          float* partial, unsigned int* counter, float* out, int H, int WC, int C, float numel) {
  const int q0 = (blockIdx.x * TNT + threadIdx.x) * V;
  const int r0 = blockIdx.y * TR;
  float local = 0.f;
  float scale = 0.f;
  if (GRAD) scale = __fdiv_rn(__ldg(ct), numel);
  if (q0 < WC) {  // W*C is a multiple of V: all V columns exist
    const bool has_right = q0 + V + C - 1 < WC;  // the last of the V columns has a pixel to its right
    const bool has_left = q0 >= C;               // the first has one to its left
    float v[TR + 2][V];                          // rows r0 - 1 .. r0 + TR; zeros outside the image
    float rt[TR][V], lf[TR][V];                  // what lies C to the right and left of v[i + 1]
#pragma unroll
    for (int i = 0; i < TR + 2; ++i) {
      const int r = r0 - 1 + i;
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.f;
      if ((i > 0 || GRAD) && r >= 0 && r < H) load_cols<V>(x + (size_t)r * WC + q0, v[i]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float* row = x + (size_t)(r0 + i) * WC + q0;
#pragma unroll
      for (int j = 0; j < V; ++j) rt[i][j] = lf[i][j] = 0.f;
      if (r0 + i < H) {
        if (V == 4) {
          if (q0 + 4 < WC) load_cols<V>(row + 4, rt[i]);
          if (GRAD && q0 > 0) load_cols<V>(row - 4, lf[i]);
        } else {
          if (has_right) rt[i][0] = __ldg(row + C);
          if (GRAD && has_left) lf[i][0] = __ldg(row - C);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = r0 + i;
      if (r < H) {
        float g[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = v[i + 1][j];
          float right, left;
          bool right_in, left_in;
          if (V == 4) {
            right = j == 0 ? v[i + 1][3] : rt[i][j == 0 ? 0 : j - 1];
            left = j == 3 ? v[i + 1][0] : lf[i][j == 3 ? 0 : j + 1];
            right_in = j == 0 || q0 + 4 < WC;
            left_in = j == 3 || q0 > 0;
          } else {
            right = rt[i][0];
            left = lf[i][0];
            right_in = has_right;
            left_in = has_left;
          }
          const float dh = (r + 1 < H) ? v[i + 2][j] - c : 0.f;
          const float dw = right_in ? right - c : 0.f;
          if (GRAD) {
            const float dh_prev = (r > 0) ? c - v[i][j] : 0.f;
            const float dw_prev = left_in ? c - left : 0.f;
            g[j] = __fmul_rn(2.f * (dh_prev - dh + dw_prev - dw), scale);
          } else {
            local = fmaf(dh, dh, local);
            local = fmaf(dw, dw, local);
          }
        }
        if (GRAD) {
          float* o = grad + (size_t)r * WC + q0;
          if (V == 4) {
            *reinterpret_cast<float4*>(o) = make_float4(g[0], g[1], g[2], g[3]);
          } else {
            o[0] = g[0];
          }
        }
      }
    }
  }
  if (!GRAD) {
    st::finish_mean<TNT>(local, partial, counter, out, numel, gridDim.x * gridDim.y,
                         blockIdx.y * gridDim.x + blockIdx.x);
  }
}

template <int V, bool GRAD>
int launch_tv(const void* x, const void* ct, void* grad, void* partial, void* counter, void* out,
              int H, int WC, int C, float numel, cudaStream_t st) {
  const dim3 grid((WC + TNT * V - 1) / (TNT * V), (H + TR - 1) / TR);
  tv_kernel<V, GRAD><<<grid, TNT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ct), static_cast<float*>(grad),
      static_cast<float*>(partial), static_cast<unsigned int*>(counter), static_cast<float*>(out),
      H, WC, C, numel);
  return static_cast<int>(cudaGetLastError());
}

template <bool GRAD>
int launch_tv_v(int vec, const void* x, const void* ct, void* grad, void* partial, void* counter,
                void* out, int H, int WC, int C, float numel, cudaStream_t st) {
  return vec == 4
      ? launch_tv<4, GRAD>(x, ct, grad, partial, counter, out, H, WC, C, numel, st)
      : launch_tv<1, GRAD>(x, ct, grad, partial, counter, out, H, WC, C, numel, st);
}

}  // namespace

// info[0..1] = threads and rows per block, for the wrapper's model of the
// grid (_launch.tv_grid).
ST_EXPORT int st_tv_info(int* info) {
  info[0] = TNT;
  info[1] = TR;
  return 0;
}

// out (0-d fp32) = the TV mean of x (H, W*C) fp32, 16-byte aligned; C is the
// channel stride of one pixel step along W. vec = 4 (C = 3 and W*C a multiple
// of 4 only) or 1 columns a thread: the grid is ceil(W*C / (TNT * vec)) x
// ceil(H / TR) (H <= 65535 * TR), and partial holds one float per block.
// counter is one zeroed unsigned int of this stream; numel = H*W*C as a float.
ST_EXPORT int st_tv(const void* x, void* partial, void* counter, void* out, int H, int WC, int C,
                    int vec, float numel, void* stream) {
  return launch_tv_v<false>(vec, x, nullptr, nullptr, partial, counter, out, H, WC, C, numel,
                            static_cast<cudaStream_t>(stream));
}

// grad (H, W*C) = the TV gradient of x times ct[0] / numel; ct one fp32 value
// on the device; vec as in st_tv.
ST_EXPORT int st_tv_grad(const void* x, const void* ct, void* grad, int H, int WC, int C, int vec,
                         float numel, void* stream) {
  return launch_tv_v<true>(vec, x, ct, grad, nullptr, nullptr, nullptr, H, WC, C, numel,
                           static_cast<cudaStream_t>(stream));
}
