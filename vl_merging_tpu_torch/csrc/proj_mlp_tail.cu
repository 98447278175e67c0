// K3: the post-attention half of an eval block in one kernel:
//   x' = bf16(res + γ1 ⊙ (ctx·Wpᵀ + bp))
//   h  = bf16(gelu(bf16(LN2(x'))·W1ᵀ + b1))
//   out = bf16(x' + γ2 ⊙ (h·W2ᵀ + b2))
//
// Replaces vl_merging_tpu/ops/fused_block.py:_proj_mlp_kernel (via
// proj_mlp_tail/_row_call).  Same rounding points as the TPU kernel: x',
// the LN2 output and the gelu output are rounded to bf16 exactly where the
// split pipeline would store them; products accumulate in f32; biases,
// LayerScale and the residual adds are f32.  The gelu is exact-erf with
// CUDA's erff (max error 2 ulp); the TPU kernel used the
// Abramowitz-Stegun erf (|err| <= 1.5e-7, ops/mlp.py:_erf_approx).
//
// Bound on the H100: by its arithmetic, tensor-core throughput (196 GFLOP
// against ~96 MB of activations and weights at B=32, N=577, C=768).  As
// built it is not: every 32-row block streams all 10.6 MB of bf16 weights
// from L2 (6.1 GB per call), and the f32 output accumulators (96 per
// thread) hold it to one block of 8 warps per SM, too few to hide the
// L2 latency of the weight tiles.  Larger row blocks need wgmma's
// register-resident 64-row accumulators or a multicast of the weight
// tiles across a cluster: later work.  The TPU kernel keeps
// a (512, 3072) f32 hidden in VMEM; a block here gets at most 227 KB of
// shared memory, so it owns 32 rows and walks the hidden dimension in
// 128-wide chunks: each chunk's fc1 output goes through gelu into a
// 32 x 128 bf16 tile and is immediately contracted with the matching 128
// columns of W2 into the f32 output accumulators, which stay in registers
// for the whole MLP.  Only the f32 summation order of fc2 changes.  The
// LN2 output stays in shared memory; x' is parked in the block's own rows
// of the output (an L2-resident 48 KB per block) to leave shared memory
// for the weight tiles, which stream through cp.async rings (double-
// buffered 768 x 32 tiles for proj and fc2, 6-stage 128 x 64 tiles for
// fc1) into WMMA bf16 products.
#include "common.cuh"

using namespace vlm;

namespace {

constexpr int BM = 32, HC = 128;
constexpr int BK_WIDE = 32, STAGES_WIDE = 2;  // GEMMs over the model width
constexpr int BK_HID = 64, STAGES_HID = 6;    // fc1 into one hidden chunk
constexpr int MF = 2;                         // every warp covers all 32 rows
constexpr int WS = STAGES_WIDE * 768 * (BK_WIDE + kPad) > STAGES_HID * HC * (BK_HID + kPad)
                       ? STAGES_WIDE * 768 * (BK_WIDE + kPad)
                       : STAGES_HID * HC * (BK_HID + kPad);  // staging, for C <= 768

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// NF: 16-column fragments per warp over the model width, C = 8 * NF * 16.
template <int NF>
__global__ void __launch_bounds__(kGemmThreads, 1)
proj_mlp_tail_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ res,
                     const bf16* __restrict__ wp, const float* __restrict__ bp,
                     const float* __restrict__ g1, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ g2,
                     bf16* __restrict__ out, int M, int Hd, float eps) {
  constexpr int C = 8 * NF * 16;
  constexpr int LDA = C + kPad, LDH = HC + kPad, WARPS = kGemmThreads / 32;
  static_assert(C <= 768, "the staging area WS is sized for C <= 768");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);         // BM x LDA: ctx, then LN2(x')
  bf16* Hs = As + BM * LDA;                          // BM x LDH: gelu(fc1) chunk
  bf16* Ws = Hs + BM * LDH;                          // weight tile staging
  float* scratch = reinterpret_cast<float*>(Ws + WS);  // 8 x 16 x 16

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  float* sc = scratch + warp * 256;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // proj + LayerScale + residual -> x' (bf16, shared memory); the first
  // Wp tiles are in flight while the ctx rows load
  gemm_prefetch<C, BK_WIDE, STAGES_WIDE>(wp, C, C, Ws);
  for (int v = threadIdx.x; v < BM * C / 8; v += kGemmThreads) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(As + r * LDA + c) =
        row0 + r < M ? __ldg(reinterpret_cast<const uint4*>(ctx + (size_t)(row0 + r) * C + c))
                     : zero;
  }
  FragC acc[MF][NF];
  zero_acc(acc);
  gemm_main<MF, NF, 8, BK_WIDE, STAGES_WIDE>(acc, As, LDA, wp, C, C, Ws);
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r, c0;
      const float* v = frag_to_scratch(acc[i][j], sc, r, c0);
      const int rr = i * 16 + r, col = (warp * NF + j) * 16 + c0;
      if (row0 + rr < M) {
        Pack8 rs, x1;
        rs.u = __ldg(reinterpret_cast<const uint4*>(res + (size_t)(row0 + rr) * C + col));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x1.h()[e] = __float2bfloat16(rs.f(e) + (v[e] + bp[col + e]) * g1[col + e]);
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + rr) * C + col) = x1.u;
      }
      __syncwarp();
    }
  }
  __syncthreads();  // x' complete (in out's rows); every warp is done reading ctx

  {  // warp w normalises rows w, w + 8, w + 16, w + 24 of x'
    const int left = M - (row0 + warp);
    ln_rows_to_bf16<BM / WARPS, NF / 2>(out + (size_t)(row0 + warp) * C, (size_t)WARPS * C,
                                        left > 0 ? (left + WARPS - 1) / WARPS : 0, ln_w,
                                        ln_b, eps, As + warp * LDA, WARPS * LDA);
  }

  // MLP over 128-wide hidden chunks; fc2 partials accumulate in acc
  zero_acc(acc);
  for (int j0 = 0; j0 < Hd; j0 += HC) {
    FragC hacc[MF][1];
    zero_acc(hacc);
    gemm_smem_a<MF, 1, 8, BK_HID, STAGES_HID>(hacc, As, LDA, w1 + (size_t)j0 * C, C, C, Ws);
    __syncthreads();  // every warp is done with the last W1 tile: W2's tiles may land
    gemm_prefetch<C, BK_WIDE, STAGES_WIDE>(w2 + j0, Hd, HC, Ws);
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      int r, c0;
      const float* v = frag_to_scratch(hacc[i][0], sc, r, c0);
      const int rr = i * 16 + r, col = warp * 16 + c0;
      Pack8 hv;
#pragma unroll
      for (int e = 0; e < 8; ++e) hv.h()[e] = __float2bfloat16(gelu_erf(v[e] + b1[j0 + col + e]));
      *reinterpret_cast<uint4*>(Hs + rr * LDH + col) = hv.u;
      __syncwarp();
    }
    gemm_main<MF, NF, 8, BK_WIDE, STAGES_WIDE>(acc, Hs, LDH, w2 + j0, Hd, HC, Ws);
  }

  // fc2 bias + LayerScale + residual -> out
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r, c0;
      const float* v = frag_to_scratch(acc[i][j], sc, r, c0);
      const int rr = i * 16 + r, col = (warp * NF + j) * 16 + c0;
      if (row0 + rr < M) {
        Pack8 x1, o;  // this lane stored exactly these x' values itself
        x1.u = *reinterpret_cast<const uint4*>(out + (size_t)(row0 + rr) * C + col);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o.h()[e] = __float2bfloat16(x1.f(e) + (v[e] + b2[col + e]) * g2[col + e]);
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + rr) * C + col) = o.u;
      }
      __syncwarp();
    }
  }
}

template <int NF>
int launch(const void* ctx, const void* res, const void* wp, const void* bp,
           const void* g1, const void* ln_w, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* g2, void* out,
           int M, int Hd, float eps, cudaStream_t stream) {
  constexpr int C = 8 * NF * 16;
  const size_t smem = (size_t)(BM * (C + kPad) + BM * (HC + kPad) + WS) * sizeof(bf16) +
                      (kGemmThreads / 32) * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      proj_mlp_tail_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  proj_mlp_tail_kernel<NF><<<(M + BM - 1) / BM, kGemmThreads, smem, stream>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(res),
      static_cast<const bf16*>(wp), static_cast<const float*>(bp),
      static_cast<const float*>(g1), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<bf16*>(out), M, Hd, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_proj_mlp_tail(const void* ctx, const void* res, const void* wp,
                                 const void* bp, const void* g1, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* g2, void* out,
                                 int M, int C, int Hd, float eps, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % HC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<6>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd,
                       eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
