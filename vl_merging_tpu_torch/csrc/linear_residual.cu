// K4: y = bf16(res + γ ⊙ (x·Wᵀ + b)), the proj + LayerScale + residual of
// an eval block on its own (the first kernel of the split tail, K4 → K5).
//
// Replaces vl_merging_tpu/ops/fused_block.py:_linear_residual_kernel (via
// linear_residual/_row_call).  Same rounding points: x and W in bf16,
// products accumulated in f32, bias, LayerScale and residual in f32, the
// output rounded once to bf16.  The epilogue is K3's proj epilogue
// (block_tail.cuh:proj_residual_rows) term for term, and the products
// accumulate in the same order (16-deep steps from k = 0 up), so K4's
// output is bit for bit the x' that K3 rounds and keeps on chip.
//
// Bound on the H100: by its bytes.  At the main-path shape (M = 32·577,
// C = O = 768) it moves x, res and y (3·M·768·2 bytes, 85 MB) and the
// 1.2 MB weight for 21.8 GFLOP: ~250 flops/byte, below the bf16 ridge of
// ~295.  Design: K1's (csrc/ln_linear.cu) 64 x 384 output tiles without the
// LN prologue: the block copies its 64 rows of x into shared memory while
// the first W tile is in flight, streams 384 x 64 tiles of W through a
// double-buffered cp.async ring into WMMA bf16 products, and adds bias,
// LayerScale and the residual row in the epilogue.  No TMA or wgmma yet.
#include "common.cuh"

using namespace vlm;

namespace {

constexpr int BM = 64, BN = 384, BK = 64, STAGES = 2;
constexpr int WARPS_N = 4, MF = 2, NF = 6;  // 2 x 4 warps, 32 x 96 outputs each

template <int C>
__global__ void __launch_bounds__(kGemmThreads)
linear_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ gamma,
                       const bf16* __restrict__ res, bf16* __restrict__ y, int M, int O) {
  constexpr int lda = C + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                         // BM x lda
  bf16* Ws = As + BM * lda;                              // STAGES x BN x (BK + kPad)
  float* scratch = reinterpret_cast<float*>(Ws + STAGES * BN * (BK + kPad));  // 8 x 256

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const bf16* wt = w + (size_t)n0 * C;
  gemm_prefetch<BN, BK, STAGES>(wt, C, C, Ws);
  for (int v = threadIdx.x; v < BM * C / 8; v += kGemmThreads) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(As + r * lda + c) =
        row0 + r < M ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * C + c))
                     : make_uint4(0u, 0u, 0u, 0u);
  }

  FragC acc[MF][NF];
  zero_acc(acc);
  gemm_main<MF, NF, WARPS_N, BK, STAGES>(acc, As, lda, wt, C, C, Ws);

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r, c0;
      const float* v = frag_to_scratch(acc[i][j], sc, r, c0);
      const int row = row0 + (wm * MF + i) * 16 + r;
      const int col = n0 + (wn * NF + j) * 16 + c0;
      if (row < M) {
        Pack8 rs, o;
        rs.u = __ldg(reinterpret_cast<const uint4*>(res + (size_t)row * O + col));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o.h()[e] = __float2bfloat16(rs.f(e) + (v[e] + bias[col + e]) * gamma[col + e]);
        *reinterpret_cast<uint4*>(y + (size_t)row * O + col) = o.u;
      }
      __syncwarp();
    }
  }
}

template <int C>
int launch(const void* x, const void* w, const void* b, const void* gamma, const void* res,
           void* y, int M, int O, void* stream) {
  const size_t smem = (size_t)(BM * (C + kPad) + STAGES * BN * (BK + kPad)) * sizeof(bf16) +
                      (kGemmThreads / 32) * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      linear_residual_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, O / BN);
  linear_residual_kernel<C><<<grid, kGemmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<const float*>(gamma), static_cast<const bf16*>(res), static_cast<bf16*>(y),
      M, O);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_linear_residual(const void* x, const void* w, const void* b,
                                   const void* gamma, const void* res, void* y, int M, int C,
                                   int O, void* stream) {
  if (M <= 0 || O % BN != 0 || C != 768) return (int)cudaErrorInvalidValue;
  return launch<768>(x, w, b, gamma, res, y, M, O, stream);
}
