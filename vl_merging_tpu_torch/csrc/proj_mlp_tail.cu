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
// CUDA's erff (max error 2 ulp, common.cuh:ErffGelu); the TPU kernel used
// the Abramowitz-Stegun erf (|err| <= 1.5e-7, ops/mlp.py:_erf_approx).
//
// Bound on the H100: by its arithmetic, tensor-core throughput (196 GFLOP
// against ~96 MB of activations and weights at B=32, N=577, C=768; 0.198
// ms at the bf16 peak).  The TPU kernel keeps a (512, 3072) f32 hidden in
// VMEM.  Here it is mlp_body.cuh in mode kProjMlp, built for C = 768 and
// 1024: a cluster of four CTAs per 64-row block, each owning a quarter of
// the output columns; wgmma in two warpgroups, each with its own mbarrier
// ring of TMA weight tiles: one for the output columns (its f32
// accumulators in registers for the whole MLP), one for the CTA's quarter
// of each 128-wide hidden chunk, which it sends to the other CTAs by bulk
// copies into their shared memory; x' parked in the block's own rows of
// the output.  Each weight tile is read from L2 once per 64 rows (the
// 32-row WMMA body before read every weight once per 32 rows: 6.1 GB per
// launch at C = 768).  K4 → K5, K6 and K7 run the same body and give the
// same bits.
#include "mlp_body.cuh"

using namespace vlm;

namespace {

template <int C>
__global__ void __cluster_dims__(body::kCluster, 1, 1) __launch_bounds__(body::kThreads, 1)
    proj_mlp_tail_kernel(const __grid_constant__ body::Maps m, const body::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  body::run<C, body::kProjMlp, ErffGelu>(m, a, smem, (blockIdx.x / body::kCluster) * body::kRows);
}

template <int C>
int launch(const void* ctx, const void* res, const void* wp, const void* bp, const void* g1,
           const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* g2, void* out, int M, int Hd, float eps,
           cudaStream_t stream) {
  body::Maps m;
  if (!body::make_maps<C>(&m, body::kProjMlp, ctx, M, wp, w1, w2, Hd))
    return (int)cudaErrorNotSupported;
  const body::Args a{static_cast<const bf16*>(res),  nullptr,
                     static_cast<const float*>(bp),  static_cast<const float*>(g1),
                     static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                     static_cast<const float*>(b1),  static_cast<const float*>(b2),
                     static_cast<const float*>(g2),  static_cast<bf16*>(out),
                     M,                              Hd,
                     0,                              eps};
  return body::launch<C>(proj_mlp_tail_kernel<C>, m, a, stream);
}

}  // namespace

extern "C" int vlm_proj_mlp_tail(const void* ctx, const void* res, const void* wp,
                                 const void* bp, const void* g1, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* g2, void* out,
                                 int M, int C, int Hd, float eps, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % body::kHC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<768>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps, s);
    case 1024:
      return launch<1024>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps,
                          s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
