// 1x1 convolution of NHWC bf16 tensors as a bf16 GEMM on Hopper's
// warpgroup MMA, with its epilogue fused: y = [gate >] [relu] (x W [+ bias]
// [+ add]), one bf16 rounding. ResNet-50's 1x1 convolutions (forward and
// backward-data), its stride-2 projection shortcuts, and, fed by the im2col
// of im2col.cu, its strided 3x3 and 7x7 convolutions and their
// backward-data products all run here.
//
// Replaces no TPU kernel: the JAX package runs VGG only. Added for
// ResNet-50 (models/resnet.py, ops/kernels/resnet.py).
//
// What bounds it on the H100. A 1x1 convolution is 2 K N FLOP a pixel
// against 2 (K + N) bytes of activations (plus the residual or gate the
// epilogue reads): at 64-256 channels (ResNet's stages 1-2) 32-102 FLOP a
// byte, far under the card's bf16 ridge of ~295, so those launches are
// bound by bandwidth; stage 3 reads 171-205, stage 4 341-410. So the
// operands must arrive by TMA with the loads of the next chunk in flight,
// the epilogue must read its extra operands and write the output once, in
// 16-byte coalesced accesses, and enough blocks must share an SM that one
// block's epilogue overlaps another's loads.
//
// The design. A block owns 8 x 16 output pixels (M = 128 rows of the GEMM)
// x 128 output channels; two consumer warpgroups own one m64 tile each
// (wgmma.mma_async m64n128k16, both operands from shared memory by
// descriptor, 64 fp32 accumulators a thread), and one producer warp's first
// thread keeps a ring of 3 stages full by TMA, a full and an empty mbarrier
// a stage. The reduction runs over the input channels in chunks of KC = 64
// (four k16 steps).
// - A (the input) in the 128-byte swizzle, K-major: one 3-D TMA box (64
//   channels x 16 x 8 pixels) a chunk, each pixel one 128-byte row; a k16
//   step is a descriptor 32 bytes further along the rows (SBO = 8 rows).
//   A stride-2 projection reads its input through the same box with TMA
//   element strides (1, 2, 2): the box spans 32 x 16 input pixels and
//   lands as the 16 x 8 it samples, so nothing is subsampled beforehand.
// - B (the weights, (K, N), N contiguous, as an HWIO kernel lies) in the
//   128-byte swizzle, N-major: two 2-D TMA boxes of 64 channels x 64 rows a
//   chunk (a half beyond N is not loaded: its columns are never stored).
// - Pixels, channels and rows beyond the tensors are zero-filled by TMA,
//   so ragged edges and a K that is not a multiple of 64 need no code.
// - 3 stages of 32 KB, 97 KB a block: two blocks share an SM (the
//   launch bounds hold a thread to 113 registers), so the epilogue and the
//   loads of one block run while the other multiplies.
// - Epilogue: the accumulators go through shared memory (the ring re-used
//   as an fp32 [pixel][channel] tile) and come back 8 channels a thread:
//   + bias (fp32 of its bf16 value), + add (bf16: the residual shortcut
//   forward; backward, the shortcut's cotangent, which with add_sub lies at
//   half the extent and lands on the even pixels, the stride-2
//   projection's input), ReLU, zero where gate <= 0 (the backward's ReLU
//   gate of the input's own activation), one bf16 rounding, a 16-byte
//   store. No split of K and no atomics: a block sums its outputs in a
//   fixed order, so results are bit-identical run to run.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int KC = 64;  // input channels per chunk: one 128-byte swizzled row of bf16

struct GemmArgs {
  const bf16* x;     // (H, W, K)
  const bf16* w;     // (K, N), N contiguous
  const bf16* bias;  // (N), or null
  const bf16* add;   // (Ho, Wo, N), or with add_sub (ceil(Ho/2), ceil(Wo/2), N); or null
  const bf16* gate;  // (Ho, Wo, N): output zero where gate <= 0, or null
  bf16* y;           // (Ho, Wo, N)
  int H, W, K, N, stride, relu, add_sub, Ho, Wo;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

struct Tile {
  static constexpr int TH = 8, TW = 16, BM = TH * TW, BN = 128, STAGES = 3;
  static constexpr int NWG = 2;                       // consumer warpgroups, one m64 tile each
  static constexpr int NT = 128 * NWG + 32;           // and one producer warp
  static constexpr int MINB = 2;                      // blocks an SM
  static constexpr int A_BYTES = BM * KC * 2;         // one 128-byte row a pixel
  static constexpr int B_HALF = KC * 64 * 2;          // 64 rows x 64 channels
  static constexpr int B_BYTES = 2 * B_HALF;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_STRIDE = BN + 8;             // fp32 a pixel of the output tile
  static constexpr int BAR_OFF = cmax(STAGES * STAGE_BYTES, BM * C_STRIDE * 4);
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;  // + 1024: alignment of the start
  static_assert(BM == 64 * NWG, "one m64 tile a consumer warpgroup");
  static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0, "1024-byte swizzle atoms");
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The producer warp: chunk j into stage j % STAGES once the consumers have
// released what that stage held; its first lane issues the loads.
__device__ __forceinline__ void produce(const GemmArgs& a, const CUtensorMap* map_x,
                                        const CUtensorMap* map_w, uint32_t smem32, uint32_t full,
                                        uint32_t empty, int nchunks, int h0, int w0, int n0,
                                        bool leader) {
  using T = Tile;
  const bool second = n0 + 64 < a.N;  // the second half of the weights holds channels
  const uint32_t tx = T::A_BYTES + (second ? 2 : 1) * T::B_HALF;
  for (int j = 0; j < nchunks; ++j) {
    const int s = j % T::STAGES;
    if (j >= T::STAGES) st::mbar_wait(empty + 8 * s, (j / T::STAGES - 1) & 1);
    if (leader) {
      const uint32_t stage = smem32 + s * T::STAGE_BYTES;
      st::mbar_arrive_expect_tx(full + 8 * s, tx);
      st::tma_load_3d(stage, map_x, full + 8 * s, j * KC, w0 * a.stride, h0 * a.stride);
      tma_load_2d(stage + T::A_BYTES, map_w, full + 8 * s, n0, j * KC);
      if (second) {
        tma_load_2d(stage + T::A_BYTES + T::B_HALF, map_w, full + 8 * s, n0 + 64, j * KC);
      }
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void epilogue(const GemmArgs& a, const float* cs, int h0, int w0,
                                         int n0, int tid) {
  using T = Tile;
  constexpr int N8 = T::BN / 8;
  const int sub_w = (a.Wo + 1) >> 1;
  for (int e = tid; e < T::BM * N8; e += T::NT) {
    const int n8 = e % N8, p = e / N8;
    const int h = h0 + p / T::TW, w = w0 + p % T::TW, n = n0 + n8 * 8;
    if (h >= a.Ho || w >= a.Wo || n >= a.N) continue;
    const size_t o = ((size_t)h * a.Wo + w) * a.N + n;
    const float* src = &cs[p * T::C_STRIDE + n8 * 8];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = src[j];
    if (a.bias != nullptr) {
      float b[8];
      st::load8_bf16(a.bias + n, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += b[j];
    }
    if (a.add != nullptr) {
      const bf16* src_add = nullptr;
      if (!a.add_sub) {
        src_add = a.add + o;
      } else if (((h | w) & 1) == 0) {
        src_add = a.add + ((size_t)(h >> 1) * sub_w + (w >> 1)) * a.N + n;
      }
      if (src_add != nullptr) {
        float r[8];
        st::load8_bf16(src_add, r);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += r[j];
      }
    }
    if (a.relu) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
    }
    if (a.gate != nullptr) {
      float g[8];
      st::load8_bf16(a.gate + o, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!(g[j] > 0.f)) v[j] = 0.f;
      }
    }
    *reinterpret_cast<uint4*>(a.y + o) = st::pack8_bf16(v);
  }
}

__global__ void __launch_bounds__(Tile::NT, Tile::MINB)
    conv1x1_kernel(const GemmArgs a, const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w) {
  using T = Tile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int h0 = blockIdx.y * T::TH, w0 = blockIdx.x * T::TW, n0 = blockIdx.z * T::BN;
  const uint32_t smem32 = (st::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem32 - st::smem_u32(smem_raw));
  const uint32_t full = smem32 + T::BAR_OFF, empty = full + 8 * T::STAGES;
  const int nchunks = (a.K + KC - 1) / KC;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      st::mbar_init(full + 8 * s, 1);
      st::mbar_init(empty + 8 * s, 4 * T::NWG);
    }
    st::mbar_init_fence();
  }
  __syncthreads();

  float acc[64];  // written first by the first product (accumulate false)
  if (wg == T::NWG) {
    produce(a, &map_x, &map_w, smem32, full, empty, nchunks, h0, w0, n0, lane == 0);
  } else {
    for (int c = 0; c < nchunks; ++c) {
      const int slot = c % T::STAGES;
      st::mbar_wait(full + 8 * slot, (c / T::STAGES) & 1);
      const uint32_t stage = smem32 + slot * T::STAGE_BYTES;
      st::wgmma_hold(acc);
      st::wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 16; ++k) {
        const uint64_t da = st::smem_desc_sw128(stage + wg * 64 * 128 + k * 32, 16, 1024);
        const uint64_t db = st::smem_desc_sw128(stage + T::A_BYTES + k * 16 * 128, T::B_HALF, 1024);
        st::wgmma_m64n128k16_bf16_tb(acc, da, db, c > 0 || k > 0);
      }
      st::wgmma_commit();
      st::wgmma_wait<1>();  // chunk c - 1's products are done: release its stage
      st::wgmma_hold(acc);
      if (c > 0 && lane == 0) st::mbar_arrive(empty + 8 * ((c - 1) % T::STAGES));
    }
    st::wgmma_wait<0>();
    st::wgmma_hold(acc);
  }
  __syncthreads();  // every product done, every load consumed: the ring becomes the output tile

  // row 16 wq + g of warpgroup wg's m64 tile is pixel 64 wg + 16 wq + g of the block
  float* cs = reinterpret_cast<float*>(smem);
  if (wg < T::NWG) {
    const int g = lane >> 2, t4 = lane & 3;
    const int p_top = wg * 64 + 16 * wq + g;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(&cs[p_top * T::C_STRIDE + col]) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&cs[(p_top + 8) * T::C_STRIDE + col]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  epilogue(a, cs, h0, w0, n0, tid);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// The input as (K, W, H) in boxes of 64 channels x TW x TH output pixels
// (element strides 1, s, s), and the weights as (N, K) in boxes of 64 x 64;
// both in the 128-byte swizzle.
bool tensor_maps(const GemmArgs& a, CUtensorMap* map_x, CUtensorMap* map_w) {
  using T = Tile;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t s = (cuuint32_t)a.stride;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)a.K, (cuuint64_t)a.W, (cuuint64_t)a.H};
    const cuuint64_t strides[2] = {(cuuint64_t)a.K * 2, (cuuint64_t)a.W * a.K * 2};
    const cuuint32_t box[3] = {KC, T::TW * s, T::TH * s};
    const cuuint32_t elem[3] = {1, s, s};
    if (encode(map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(a.x), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS) {
      return false;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)a.N, (cuuint64_t)a.K};
  const cuuint64_t strides[1] = {(cuuint64_t)a.N * 2};
  const cuuint32_t box[2] = {64, KC};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(a.w), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// (TH, TW, BN, threads, dynamic shared-memory bytes, blocks per SM, KC) of
// the tile into out[0..6]; the wrapper's model of the grid is held against it.
ST_EXPORT int st_conv1x1_info(int* out) {
  using T = Tile;
  out[0] = T::TH; out[1] = T::TW; out[2] = T::BN; out[3] = T::NT; out[4] = T::SMEM;
  out[5] = T::MINB; out[6] = KC;
  return 0;
}

// y (Ho, Wo, N) = [gate >] [relu] (x[::stride, ::stride] W [+ bias] [+ add]),
// with Ho = ceil(H / stride), Wo = ceil(W / stride); K and N multiples of 8,
// every pointer 16-byte aligned. add_sub: add is (ceil(Ho/2), ceil(Wo/2), N)
// and lands on the even pixels of y.
ST_EXPORT int st_conv1x1(const void* x, const void* w, const void* bias, const void* add,
                         const void* gate, void* y, int H, int W, int K, int N, int stride,
                         int relu, int add_sub, void* stream) {
  using T = Tile;
  GemmArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.add = static_cast<const bf16*>(add);
  a.gate = static_cast<const bf16*>(gate);
  a.y = static_cast<bf16*>(y);
  a.H = H; a.W = W; a.K = K; a.N = N; a.stride = stride; a.relu = relu; a.add_sub = add_sub;
  a.Ho = (H + stride - 1) / stride;
  a.Wo = (W + stride - 1) / stride;
  if ((K & 7) || (N & 7) || (stride != 1 && stride != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv1x1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap map_x = {}, map_w = {};
  if (!tensor_maps(a, &map_x, &map_w)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.Wo + T::TW - 1) / T::TW, (a.Ho + T::TH - 1) / T::TH, (N + T::BN - 1) / T::BN);
  conv1x1_kernel<<<grid, T::NT, T::SMEM, static_cast<cudaStream_t>(stream)>>>(a, map_x, map_w);
  return static_cast<int>(cudaGetLastError());
}
