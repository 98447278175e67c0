// K14: y = dequant(quant(LN(x)) · Wqᵀ) + b, the pre-norm + int8 qkv
// projection of a W8A8 eval block.
//
// Replaces vl_merging_tpu/ops/int8.py:_ln_linear_i8_kernel (via
// ln_linear_i8/_row_call_i8).  Same arithmetic as the TPU kernel: LN
// statistics and the normalised row in f32 (no bf16 rounding before the
// quantizer, unlike K1), per-token int8 with scale max(amax, 1e-8)/127,
// s8·s8 products summed exactly in s32 against the per-output-channel
// int8 weight, ((acc · s) · ws) + b in f32, output rounded to bf16.
//
// Bound on the H100: by bytes.  At the main-path shape
// (B·577 x 768) · (768 x 2304) it is 65.3 GOP of int8 work (0.033 ms at
// 1,979 TOP/s) against ~115 MB (x 28.4 MB in, y 85.1 MB out, W 1.8 MB):
// 0.034 ms at 3.35 TB/s.  Design: K1's, in int8.  One block per 64 x 384
// output tile normalises and quantizes its 64 rows into shared memory
// (each warp four rows at a time, the row scales beside them) while the
// first W tiles are in flight, then streams 384 x 64 int8 tiles of W
// through a 3-deep cp.async ring into mma.sync m16n8k32 (s8·s8→s32)
// products; each of the 8 warps owns a 32 x 96 slice of the tile in 96
// s32 registers.  The LN and quantization are recomputed by each of the
// O/384 column blocks of a row block (an L2 read of 64·C values per
// tile).  No TMA or wgmma yet.
#include "int8.cuh"

using namespace vlm;

namespace {

constexpr int BM = 64, BN = 384, BK = 64, STAGES = 3;
constexpr int WARPS_N = 4, MF = 2, NF = 12;  // 2 x 4 warps, 32 x 96 outputs each
constexpr int LN_ROWS = 4;                    // rows a warp normalises at once

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)BM * (C + kPad8) + (size_t)STAGES * BN * (BK + kPad8) + BM * sizeof(float);
}

// NV: C / 256 (the LN's 16-byte vectors per lane and row)
template <int NV>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_linear_i8_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, const int8_t* __restrict__ w,
                    const float* __restrict__ ws, const float* __restrict__ bias,
                    bf16* __restrict__ y, int M, int O, float eps) {
  constexpr int C = NV * 256, LDA = C + kPad8, WARPS = kGemmThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);                     // BM x LDA
  int8_t* Ws = As + BM * LDA;                                       // STAGES x BN x (BK + 16)
  float* row_scale = reinterpret_cast<float*>(Ws + STAGES * BN * (BK + kPad8));  // BM

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* wt = w + (size_t)n0 * C;
  gemm8_prefetch<BN, BK, STAGES>(wt, C, C, Ws);

  // warp w normalises and quantizes rows w, w + 8, ..., LN_ROWS at a time
  for (int r = warp; r < BM; r += LN_ROWS * WARPS) {
    const int left = M - (row0 + r);  // rows of this group that exist: ceil(left / 8)
    ln_quant_rows<LN_ROWS, NV>(x + (size_t)(row0 + r) * C, (size_t)WARPS * C,
                               left > 0 ? (left + WARPS - 1) / WARPS : 0, ln_w, ln_b, eps,
                               As + r * LDA, WARPS * LDA, row_scale + r, WARPS);
  }

  int acc[MF][NF][4];
  zero_acc8(acc);
  gemm8_main<MF, NF, WARPS_N, BK, STAGES>(acc, As, LDA, wt, C, C, Ws);

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the fragment
      const int r = (wm * MF + i) * 16 + g + 8 * h;
      if (row0 + r >= M) continue;
      const float s = row_scale[r];
      bf16* yr = y + (size_t)(row0 + r) * O;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int col = n0 + (wn * NF + j) * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(
            dequant(acc[i][j][2 * h], s, ws[col], bias[col]),
            dequant(acc[i][j][2 * h + 1], s, ws[col + 1], bias[col + 1]));
      }
    }
  }
}

template <int NV>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* ws,
           const void* b, void* y, int M, int O, float eps, void* stream) {
  constexpr size_t smem = smem_bytes(NV * 256);
  cudaError_t err = cudaFuncSetAttribute(
      ln_linear_i8_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, O / BN);
  ln_linear_i8_kernel<NV><<<grid, kGemmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<const float*>(b), static_cast<bf16*>(y), M, O,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_ln_linear_i8(const void* x, const void* ln_w, const void* ln_b,
                                const void* w, const void* ws, const void* b, void* y, int M,
                                int C, int O, float eps, void* stream) {
  if (M <= 0 || O % BN != 0 || C != 768) return (int)cudaErrorInvalidValue;
  return launch<3>(x, ln_w, ln_b, w, ws, b, y, M, O, eps, stream);
}
