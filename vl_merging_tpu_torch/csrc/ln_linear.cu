// K1: y = LN(x)·Wᵀ + b, the pre-norm + qkv projection of an eval block.
//
// Replaces vl_merging_tpu/ops/fused_block.py:_ln_linear_kernel (via
// ln_linear/_row_call).  Same rounding points: LN statistics in f32 with
// eps, the normalised row rounded to bf16 before the GEMM, f32
// accumulation, bias added in f32, output rounded to bf16.
//
// Bound on the H100: tensor-core throughput.  At the main-path shape
// (B·577 x 768) · (768 x 2304) it is 2·M·768·2304 flops against
// (M·768 + 768·2304 + M·2304)·2 bytes: 65.3 GFLOP over 117 MB at B=32,
// ~560 flops/byte, above the H100's bf16 ridge of ~295.  Design: one
// block per 64 x 384 output tile.  The block normalises its 64 rows into
// shared memory (the LN output never reaches device memory; each warp
// reads its rows four at a time into registers) while the first tile of
// W is already in flight, then streams 384 x 64 tiles of W through a
// double-buffered cp.async ring into WMMA bf16 products.  The LN is
// recomputed by each of the O/384 column blocks of a row block: an L2
// read of 64·C values per tile.  Shared memory holds the resident rows
// plus two W tiles: at C = 1024 the 64 rows take 132 KB, so the tile is
// 64 x 256 there (two 256 x 64 W tiles, 74 KB; 214 KB in all), the same
// instructions per output element as at C = 768 (64 x 384 tiles, 208 KB).
// Built for C = 768 and 1024.  No TMA or wgmma yet.
#include "common.cuh"

using namespace vlm;

namespace {

constexpr int BM = 64, BK = 64, STAGES = 2;
constexpr int WARPS_N = 4, MF = 2;  // 2 x 4 warps, 32 x BN/4 outputs each
constexpr int LN_ROWS = 4;          // rows a warp normalises at once

// The output tile's width at model width C.
constexpr int tile_n(int C) { return C > 768 ? 256 : 384; }

// NV: C / 256 (the LN's 16-byte vectors per lane and row); BN: the tile width
template <int NV, int BN>
__global__ void __launch_bounds__(kGemmThreads)
ln_linear_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ y, int M, int O,
                 float eps) {
  constexpr int C = NV * 256, lda = C + kPad, WARPS = kGemmThreads / 32;
  constexpr int NF = BN / (WARPS_N * 16);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                         // BM x lda
  bf16* Ws = As + BM * lda;                              // STAGES x BN x (BK + kPad)
  float* scratch = reinterpret_cast<float*>(Ws + STAGES * BN * (BK + kPad));  // 8 x 256

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const bf16* wt = w + (size_t)n0 * C;
  gemm_prefetch<BN, BK, STAGES>(wt, C, C, Ws);

  // warp w normalises rows w, w + 8, ..., LN_ROWS at a time
  for (int r = warp; r < BM; r += LN_ROWS * WARPS) {
    const int left = M - (row0 + r);  // rows of this group that exist: ceil(left / 8)
    ln_rows_to_bf16<LN_ROWS, NV>(x + (size_t)(row0 + r) * C, (size_t)WARPS * C,
                                 left > 0 ? (left + WARPS - 1) / WARPS : 0, ln_w, ln_b, eps,
                                 As + r * lda, WARPS * lda);
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
        Pack8 o;
#pragma unroll
        for (int e = 0; e < 8; ++e) o.h()[e] = __float2bfloat16(v[e] + bias[col + e]);
        *reinterpret_cast<uint4*>(y + (size_t)row * O + col) = o.u;
      }
      __syncwarp();
    }
  }
}

template <int NV>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* b,
           void* y, int M, int O, float eps, void* stream) {
  constexpr int C = NV * 256, BN = tile_n(C);
  if (O % BN != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(BM * (C + kPad) + STAGES * BN * (BK + kPad)) * sizeof(bf16) +
                      (kGemmThreads / 32) * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_linear_kernel<NV, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, O / BN);
  ln_linear_kernel<NV, BN><<<grid, kGemmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y), M, O, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_ln_linear(const void* x, const void* ln_w, const void* ln_b,
                             const void* w, const void* b, void* y, int M, int C, int O,
                             float eps, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 768:
      return launch<3>(x, ln_w, ln_b, w, b, y, M, O, eps, stream);
    case 1024:
      return launch<4>(x, ln_w, ln_b, w, b, y, M, O, eps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vlm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
