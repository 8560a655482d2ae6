// VGG block 1 in one forward and one backward launch:
//   forward   [conv1_1 + bias + ReLU ->] r1 -> conv1_2 + bias + ReLU -> 2x2
//             mean pool -> pool1, the int8 ReLU mask of conv1_2, and the
//             unnormalized Gram r1^T r1 of the conv1_1 activation;
//   backward  unpool(d_pool) * 0.25, gated by the mask, rounded to bf16 ->
//             transposed conv1_2 -> + r1 S -> d_r1 ("tail"), or gated by
//             r1 > 0, rounded to bf16 and contracted with the 27 conv1_1 taps
//             into patch cotangents ("full").
//
// Replaces the TPU kernels of style_transfer_tpu/ops/pallas/block1.py:
//   block1_tail  (_fwd_kernel / _bwd_kernel): starts from r1 in device memory;
//   block1_full  (_full_fwd_kernel / _full_bwd_kernel): starts from the
//                preprocessed 3-channel image, writes r1 once as the
//                backward's residual, and ends its backward in the 27-wide
//                product dpre1 @ k1f^T (the col2im that scatters the patch
//                cotangents onto the image stays outside, as in the reference).
// The TPU kernels walk row tiles in order and carry the Gram in VMEM scratch;
// Hopper blocks run in no order, so a block owns a run of 8x16-pixel tiles,
// keeps its Gram sum in registers across them, writes one (64, 64) partial,
// and a second pass adds the partials in a fixed order (no atomics). The
// reference's im2col of the image (an XLA-side (H, W, 27) tensor) is not
// built: the block stages the image tile with a two-pixel halo in shared
// memory and contracts the 27 taps from there.
//
// r1 outside the image is ZERO (conv1_2's SAME padding), not relu(b1 + conv
// of padding): the halo rows and columns that a tile computes beyond the
// image edge are forced to zero, and so are the pixels of a ragged tile
// beyond the edge, so they add nothing to the Gram either.
//
// Rounding points, as in the reference: r1 rounded to bf16 once (stored,
// convolved and summed into the Gram from the rounded value), fp32
// accumulation, fp32 biases, the pool taken on the fp32 ReLU output; in the
// backward the gated unpooled cotangent (bf16), S (bf16, cast by the
// wrapper), dpre1 (bf16) and the patch cotangents (bf16).
//
// What bounds it on the H100: operations. At 1024x1024 the forward is
// 2*H*W*64*(27 + 576 + 64) = 89.5 GFLOP over ~240 MB (r1 134 MB, mask 67 MB,
// pool1 34 MB, image 6 MB): ~370 FLOP/byte, above the bf16 ridge (~295).
//
// What this simple design does about it: nothing clever yet. Direct
// convolution on the CUDA cores (fp32 FMA), no tensor cores, no TMA. What it
// does save against running block 1 as two generic convs is traffic and
// waste: r1 never returns from device memory between the convs, the Gram
// reads r1 from shared memory, the backward's Gram term r1 S rides in the
// transposed conv's accumulators as a tenth tap instead of an fp32 (H, W, 64)
// tensor, and the last contraction is 27 wide instead of a 64-wide tile with
// 3 live channels.
//
// Index widths: H <= 8 * 65535 rows (gridDim.y of the backward), W < 2^31,
// every element offset in size_t (r1 at 512x8192 has 268 M elements).
#include "common.cuh"

namespace {

constexpr int TH = 8;     // output rows per tile
constexpr int TW = 16;    // output columns per tile
constexpr int C = 64;     // channels of block 1
constexpr int TK = 8;     // reduction channels staged per step
constexpr int NT = 256;   // threads per block
constexpr int IH = TH + 2, IW = TW + 2;  // r1 tile with its 1-pixel halo
constexpr int XH = TH + 4, XW = TW + 4;  // image tile with its 2-pixel halo
constexpr int PS = IH * IW + 1;          // channel-plane stride of the r1 tile (odd: no bank conflicts)
constexpr int TAPS1 = 27;                // conv1_1 contraction depth (3 x 3 x 3)
constexpr int KS = C + 2;                // padded row of the conv1_1 taps in the backward
constexpr int DS = C + 2;                // padded row of the dpre1 tile in the backward
constexpr int TARGET_BLOCKS = 1056;      // forward blocks aimed at: 8 per SM

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct FwdArgs {
  const bf16* x;      // full: (H, W, 3) preprocessed image
  const bf16* r1_in;  // tail: (H, W, 64) conv1_1 activation
  const bf16* k1;     // full: (27, 64) conv1_1 taps, (dy, dx, ci) major
  const float* b1;    // full: (64)
  const bf16* k2;     // (3, 3, 64, 64) conv1_2 taps, HWIO
  const float* b2;    // (64)
  bf16* r1_out;       // full: (H, W, 64), the backward's residual
  int8_t* mask;       // (H, W, 64) conv1_2 pre-activation > 0
  bf16* pool;         // (H/2, W/2, 64)
  float* part;        // (gridDim.x, 64, 64) Gram partials
  int H, W, tiles_x, ntiles, tiles_per_block;
};

template <bool FULL>
__global__ void __launch_bounds__(NT) block1_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                  // [C][PS] the r1 tile, channel planes
  float* w_s = r_s + C * PS;          // [9][TK][C] conv1_2 tap slice
  float* x_s = w_s + 9 * TK * C;      // full: [XH][XW][3] image tile
  float* k1_s = x_s + XH * XW * 3;    // full: [27][C]
  float* b1_s = k1_s + TAPS1 * C;     // full: [C]

  const int tid = threadIdx.x;
  const int ng = tid & 15;            // channel group: 4 channels
  const int pg = tid >> 4;            // pixel group: 2 rows x 4 columns
  const int pr = (pg >> 2) * 2;
  const int pc = (pg & 3) * 4;
  const int nb = ng * 4;

  if (FULL) {
    for (int e = tid; e < TAPS1 * C; e += NT) k1_s[e] = __bfloat162float(a.k1[e]);
    if (tid < C) b1_s[tid] = a.b1[tid];
  }
  float b2v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) b2v[c] = a.b2[nb + c];

  float gacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;

  const int t_begin = blockIdx.x * a.tiles_per_block;
  const int t_end = min(a.ntiles, t_begin + a.tiles_per_block);
  for (int t = t_begin; t < t_end; ++t) {
    const int h0 = (t / a.tiles_x) * TH;
    const int w0 = (t % a.tiles_x) * TW;

    // ---- the r1 tile with its halo, zero outside the image
    if (FULL) {
      for (int e = tid; e < XH * XW * 3; e += NT) {
        const int ci = e % 3, p = e / 3;
        const int h = h0 + p / XW - 2, w = w0 + p % XW - 2;
        float v = 0.f;
        if (h >= 0 && h < a.H && w >= 0 && w < a.W) {
          v = __bfloat162float(a.x[((size_t)h * a.W + w) * 3 + ci]);
        }
        x_s[e] = v;
      }
      __syncthreads();
      for (int e = tid; e < IH * IW * C; e += NT) {
        const int ch = e & (C - 1), pos = e >> 6;
        const int r = pos / IW, c = pos % IW;
        const int h = h0 + r - 1, w = w0 + c - 1;
        float v = 0.f;
        if (h >= 0 && h < a.H && w >= 0 && w < a.W) {
          float s = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float* xp = x_s + ((r + dy) * XW + c + dx) * 3;
              const float* kp = k1_s + (dy * 3 + dx) * 3 * C + ch;
              s = fmaf(xp[0], kp[0], s);
              s = fmaf(xp[1], kp[C], s);
              s = fmaf(xp[2], kp[2 * C], s);
            }
          const bf16 vb = __float2bfloat16_rn(fmaxf(s + b1_s[ch], 0.f));
          v = __bfloat162float(vb);
          if (r >= 1 && r <= TH && c >= 1 && c <= TW) {
            a.r1_out[((size_t)h * a.W + w) * C + ch] = vb;
          }
        }
        r_s[ch * PS + pos] = v;
      }
    } else {
      for (int e = tid; e < IH * IW * (C / 8); e += NT) {
        const int g = e & 7, pos = e >> 3;
        const int h = h0 + pos / IW - 1, w = w0 + pos % IW - 1;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
        if (h >= 0 && h < a.H && w >= 0 && w < a.W) {
          st::load8_bf16(a.r1_in + ((size_t)h * a.W + w) * C + g * 8, v);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) r_s[(g * 8 + j) * PS + pos] = v[j];
      }
    }

    // ---- conv1_2 from the tile in shared memory
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

    for (int k0 = 0; k0 < C; k0 += TK) {
      for (int e = tid; e < 9 * TK * (C / 8); e += NT) {
        const int n8 = (e & 7) * 8, k = (e >> 3) % TK, tp = e / (8 * TK);
        float v[8];
        st::load8_bf16(a.k2 + ((size_t)tp * C + k0 + k) * C + n8, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) w_s[(tp * TK + k) * C + n8 + j] = v[j];
      }
      __syncthreads();  // also orders the r1 tile's writes before its first reads
#pragma unroll 2
      for (int k = 0; k < TK; ++k) {
        const float* rp = r_s + (k0 + k) * PS;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float xv[2][6];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) xv[i][j] = rp[(pr + i + dy) * IW + pc + j];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wv =
                *reinterpret_cast<const float4*>(&w_s[((dy * 3 + dx) * TK + k) * C + nb]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float xin = xv[i][j + dx];
                acc[i][j][0] = fmaf(xin, wv.x, acc[i][j][0]);
                acc[i][j][1] = fmaf(xin, wv.y, acc[i][j][1]);
                acc[i][j][2] = fmaf(xin, wv.z, acc[i][j][2]);
                acc[i][j][3] = fmaf(xin, wv.w, acc[i][j][3]);
              }
          }
        }
      }
      __syncthreads();
    }

    // ---- bias, mask, ReLU, 2x2 mean pool (H and W even, tile origins even)
    float y[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pre[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pre[c] = acc[i][j][c] + b2v[c];
          y[i][j][c] = fmaxf(pre[c], 0.f);
        }
        const int h = h0 + pr + i, w = w0 + pc + j;
        if (h < a.H && w < a.W) {
          *reinterpret_cast<char4*>(a.mask + ((size_t)h * a.W + w) * C + nb) =
              make_char4(pre[0] > 0.f, pre[1] > 0.f, pre[2] > 0.f, pre[3] > 0.f);
        }
      }
    const int ph = (h0 + pr) >> 1;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int pw = ((w0 + pc) >> 1) + jj;
      if (ph < (a.H >> 1) && pw < (a.W >> 1)) {
        float s[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[c] = ((y[0][2 * jj][c] + y[0][2 * jj + 1][c]) +
                  (y[1][2 * jj][c] + y[1][2 * jj + 1][c])) * 0.25f;
        }
        st::store4_bf16(a.pool + ((size_t)ph * (a.W >> 1) + pw) * C + nb, s[0], s[1], s[2], s[3]);
      }
    }

    // ---- the tile's share of r1^T r1 (its own pixels only, not the halo)
#pragma unroll 4
    for (int p = 0; p < TH * TW; ++p) {
      const int pos = (p / TW + 1) * IW + (p % TW) + 1;
      float ai[4], bj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ai[i] = r_s[(pg * 4 + i) * PS + pos];
#pragma unroll
      for (int j = 0; j < 4; ++j) bj[j] = r_s[(nb + j) * PS + pos];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gacc[i][j] = fmaf(ai[i], bj[j], gacc[i][j]);
    }
    __syncthreads();  // the next tile overwrites r_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.part[((size_t)blockIdx.x * C + pg * 4 + i) * C + nb + j] = gacc[i][j];
    }
}

__global__ void block1_gram_reduce_kernel(const float* __restrict__ part,
                                          float* __restrict__ out, int nparts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * C) return;
  float s = 0.f;
  for (int z = 0; z < nparts; ++z) s += part[(size_t)z * C * C + e];
  out[e] = s;
}

struct BwdArgs {
  const bf16* d_pool;  // (H/2, W/2, 64)
  const int8_t* mask;  // (H, W, 64)
  const bf16* r1;      // (H, W, 64)
  const bf16* s;       // (64, 64) S = (dG + dG^T) / (H*W)
  const bf16* k2t;     // (3, 3, 64, 64) flipped taps, [tap][out channel][in channel]
  const bf16* k1;      // full: (27, 64)
  bf16* out;           // tail: d_r1 (H, W, 64); full: patch cotangents (9, H, W, 3)
  int H, W;
};

template <bool FULL>
__global__ void __launch_bounds__(NT) block1_bwd_kernel(const BwdArgs a) {
  __shared__ float in_s[TK][IH][IW];               // gated unpooled cotangent, with halo
  __shared__ float rr_s[TK][TH * TW];              // r1, the tile's own pixels
  __shared__ __align__(16) float w_s[9][TK][C];    // transposed conv1_2 tap slice
  __shared__ __align__(16) float s_s[TK][C];       // rows of S
  __shared__ __align__(8) float k1_s[FULL ? TAPS1 : 1][KS];

  const int tid = threadIdx.x;
  const int ng = tid & 15, pg = tid >> 4;
  const int pr = (pg >> 2) * 2, pc = (pg & 3) * 4;
  const int nb = ng * 4;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;

  if (FULL) {
    for (int e = tid; e < TAPS1 * C; e += NT) k1_s[e / C][e % C] = __bfloat162float(a.k1[e]);
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int k0 = 0; k0 < C; k0 += TK) {
    // da2 = bf16(0.25 * unpool(d_pool) * mask), zero outside the image
    for (int p = tid; p < IH * IW; p += NT) {
      const int r = p / IW, c = p % IW;
      const int h = h0 + r - 1, w = w0 + c - 1;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (h >= 0 && h < a.H && w >= 0 && w < a.W) {
        st::load8_bf16(a.d_pool + ((size_t)(h >> 1) * (a.W >> 1) + (w >> 1)) * C + k0, v);
        const uint2 raw =
            *reinterpret_cast<const uint2*>(a.mask + ((size_t)h * a.W + w) * C + k0);
        const int8_t* m = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = m[j] ? round_bf16(v[j] * 0.25f) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) in_s[j][r][c] = v[j];
    }
    for (int p = tid; p < TH * TW; p += NT) {
      const int h = h0 + p / TW, w = w0 + p % TW;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (h < a.H && w < a.W) st::load8_bf16(a.r1 + ((size_t)h * a.W + w) * C + k0, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) rr_s[j][p] = v[j];
    }
    for (int e = tid; e < 9 * TK * (C / 8); e += NT) {
      const int n8 = (e & 7) * 8, k = (e >> 3) % TK, tp = e / (8 * TK);
      float v[8];
      st::load8_bf16(a.k2t + ((size_t)tp * C + k0 + k) * C + n8, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) w_s[tp][k][n8 + j] = v[j];
    }
    if (tid < TK * (C / 8)) {
      const int n8 = (tid & 7) * 8, k = tid >> 3;
      float v[8];
      st::load8_bf16(a.s + (size_t)(k0 + k) * C + n8, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_s[k][n8 + j] = v[j];
    }
    __syncthreads();

#pragma unroll 2
    for (int k = 0; k < TK; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[2][6];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) xv[i][j] = in_s[k][pr + i + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][k][nb]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float xin = xv[i][j + dx];
              acc[i][j][0] = fmaf(xin, wv.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(xin, wv.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(xin, wv.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(xin, wv.w, acc[i][j][3]);
            }
        }
      }
      // the Gram term r1 S, a tenth tap on the same accumulators
      const float4 sv = *reinterpret_cast<const float4*>(&s_s[k][nb]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float rin = rr_s[k][(pr + i) * TW + pc + j];
          acc[i][j][0] = fmaf(rin, sv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(rin, sv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(rin, sv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(rin, sv.w, acc[i][j][3]);
        }
    }
    __syncthreads();
  }

  if (!FULL) {
    // block1_tail: d_r1, not gated (conv1_1's ReLU is upstream of this kernel)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + pr + i, w = w0 + pc + j;
        if (h < a.H && w < a.W) {
          st::store4_bf16(a.out + ((size_t)h * a.W + w) * C + nb, acc[i][j][0], acc[i][j][1],
                          acc[i][j][2], acc[i][j][3]);
        }
      }
    return;
  }

  // block1_full: dpre1 = bf16(r1 > 0 ? d_r1 : 0) into shared memory (the tap
  // slice's space: the loop above is done with it), then the 27-wide product
  bf16* dpre_s = reinterpret_cast<bf16*>(&w_s[0][0][0]);  // [TH*TW][DS]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = h0 + pr + i, w = w0 + pc + j;
      const int p = (pr + i) * TW + pc + j;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (h < a.H && w < a.W) {
        const uint2 raw = *reinterpret_cast<const uint2*>(a.r1 + ((size_t)h * a.W + w) * C + nb);
        const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 lo = __bfloat1622float2(rp[0]), hi = __bfloat1622float2(rp[1]);
        v[0] = lo.x > 0.f ? acc[i][j][0] : 0.f;
        v[1] = lo.y > 0.f ? acc[i][j][1] : 0.f;
        v[2] = hi.x > 0.f ? acc[i][j][2] : 0.f;
        v[3] = hi.y > 0.f ? acc[i][j][3] : 0.f;
      }
      __nv_bfloat162* dp = reinterpret_cast<__nv_bfloat162*>(dpre_s + p * DS + nb);
      dp[0] = __floats2bfloat162_rn(v[0], v[1]);
      dp[1] = __floats2bfloat162_rn(v[2], v[3]);
    }
  __syncthreads();

  // patch cotangents dpt[tap][h][w][ci] = sum_c dpre1[h][w][c] * k1[(tap, ci)][c]
  for (int e = tid; e < 9 * TH * TW * 3; e += NT) {
    const int tp = e / (TH * TW * 3), rem = e % (TH * TW * 3);
    const int p = rem / 3, ci = rem % 3;
    const int h = h0 + p / TW, w = w0 + p % TW;
    if (h >= a.H || w >= a.W) continue;
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(dpre_s + p * DS);
    const float2* kp = reinterpret_cast<const float2*>(&k1_s[tp * 3 + ci][0]);
    float s = 0.f;
#pragma unroll 8
    for (int c2 = 0; c2 < C / 2; ++c2) {
      const float2 d = __bfloat1622float2(dp[c2]);
      const float2 kk = kp[c2];
      s = fmaf(d.x, kk.x, s);
      s = fmaf(d.y, kk.y, s);
    }
    a.out[(((size_t)tp * a.H + h) * a.W + w) * 3 + ci] = __float2bfloat16_rn(s);
  }
}

int tiles_x(int W) { return (W + TW - 1) / TW; }
int tiles_y(int H) { return (H + TH - 1) / TH; }

int tiles_per_block(int H, int W) {
  const long long n = (long long)tiles_x(W) * tiles_y(H);
  return static_cast<int>((n + TARGET_BLOCKS - 1) / TARGET_BLOCKS);
}

template <bool FULL>
int launch_fwd(FwdArgs a, float* gram, cudaStream_t st) {
  a.tiles_x = tiles_x(a.W);
  a.ntiles = a.tiles_x * tiles_y(a.H);
  a.tiles_per_block = tiles_per_block(a.H, a.W);
  const int nblocks = (a.ntiles + a.tiles_per_block - 1) / a.tiles_per_block;
  const int floats = C * PS + 9 * TK * C + (FULL ? XH * XW * 3 + TAPS1 * C + C : 0);
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(block1_fwd_kernel<FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  block1_fwd_kernel<FULL><<<nblocks, NT, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block1_gram_reduce_kernel<<<(C * C + 255) / 256, 256, 0, st>>>(a.part, gram, nblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gram partials of one forward for an (H, W) image; the wrapper sizes `part`
// as this many (64, 64) fp32 tiles.
ST_EXPORT int st_block1_partials(int H, int W) {
  const int n = tiles_x(W) * tiles_y(H);
  const int per = tiles_per_block(H, W);
  return (n + per - 1) / per;
}

// Forward. x != null: block1_full from the (H, W, 3) bf16 image, with k1
// (27, 64) bf16, b1 (64) fp32, writing r1 (H, W, 64) bf16. x == null:
// block1_tail, reading r1. Both: k2 (3, 3, 64, 64) bf16, b2 (64) fp32 ->
// mask (H, W, 64) int8, pool (H/2, W/2, 64) bf16, gram (64, 64) fp32
// unnormalized, through `part`. H and W even.
ST_EXPORT int st_block1_fwd(const void* x, const void* k1, const void* b1, void* r1,
                            const void* k2, const void* b2, void* mask, void* pool, void* part,
                            void* gram, int H, int W, void* stream) {
  FwdArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.k1 = static_cast<const bf16*>(k1);
  a.b1 = static_cast<const float*>(b1);
  a.r1_in = static_cast<const bf16*>(r1);
  a.r1_out = static_cast<bf16*>(r1);
  a.k2 = static_cast<const bf16*>(k2);
  a.b2 = static_cast<const float*>(b2);
  a.mask = static_cast<int8_t*>(mask);
  a.pool = static_cast<bf16*>(pool);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x != nullptr ? launch_fwd<true>(a, static_cast<float*>(gram), st)
                      : launch_fwd<false>(a, static_cast<float*>(gram), st);
}

// Backward. k1 == null: block1_tail, out = d_r1 (H, W, 64) bf16. k1 != null:
// block1_full, out = patch cotangents (9, H, W, 3) bf16, tap-major, for the
// caller's col2im. d_pool (H/2, W/2, 64) bf16, mask (H, W, 64) int8, r1
// (H, W, 64) bf16, s (64, 64) bf16, k2t the flipped transposed conv1_2 taps.
ST_EXPORT int st_block1_bwd(const void* d_pool, const void* mask, const void* r1, const void* s,
                            const void* k2t, const void* k1, void* out, int H, int W,
                            void* stream) {
  BwdArgs a = {};
  a.d_pool = static_cast<const bf16*>(d_pool);
  a.mask = static_cast<const int8_t*>(mask);
  a.r1 = static_cast<const bf16*>(r1);
  a.s = static_cast<const bf16*>(s);
  a.k2t = static_cast<const bf16*>(k2t);
  a.k1 = static_cast<const bf16*>(k1);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  const dim3 grid(tiles_x(W), tiles_y(H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k1 != nullptr) {
    block1_bwd_kernel<true><<<grid, NT, 0, st>>>(a);
  } else {
    block1_bwd_kernel<false><<<grid, NT, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
