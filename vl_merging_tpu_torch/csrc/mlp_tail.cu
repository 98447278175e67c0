// K5: out = bf16(x + γ ⊙ (bf16(gelu(bf16(LN(x))·W1ᵀ + b1))·W2ᵀ + b2)), the
// LN2 + MLP + LayerScale + residual of an eval block on its own (the second
// kernel of the split tail, K4 → K5).
//
// Replaces vl_merging_tpu/ops/fused_block.py:_mlp_tail_kernel (via
// mlp_tail/_row_call).  Same rounding points: LN statistics in f32, the
// normalised row and the gelu output rounded to bf16, products accumulated
// in f32, biases, LayerScale and residual in f32.  The gelu is K3's (exact
// erf through erff, common.cuh:ErffGelu).
//
// Bound on the H100: by its arithmetic (4·M·C·H flops: 174 GFLOP at
// M = 32·577, C = 768, H = 3072, against 61 MB of rows, weights and
// output).  Design: K3's second half, mlp_body.cuh in mode kLnMlp, built
// for C = 768 and 1024 (64-row blocks over a cluster of four CTAs, LN2 into
// swizzled shared memory, wgmma, the f32 output accumulators in
// registers).  Fed the x' that K4 stores (K3 rounds x' to bf16 at the same
// point and parks it in its output rows), it gives K3's output bit for bit.
#include "mlp_body.cuh"

using namespace vlm;

namespace {

template <int C>
__global__ void __cluster_dims__(body::kCluster, 1, 1) __launch_bounds__(body::kThreads, 1)
    mlp_tail_kernel(const __grid_constant__ body::Maps m, const body::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  body::run<C, body::kLnMlp, ErffGelu>(m, a, smem, (blockIdx.x / body::kCluster) * body::kRows);
}

template <int C>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* g2, void* out, int M, int Hd, float eps,
           cudaStream_t stream) {
  body::Maps m;
  if (!body::make_maps<C>(&m, body::kLnMlp, nullptr, M, nullptr, w1, w2, Hd))
    return (int)cudaErrorNotSupported;
  const body::Args a{nullptr,
                     static_cast<const bf16*>(x),
                     nullptr,
                     nullptr,
                     static_cast<const float*>(ln_w),
                     static_cast<const float*>(ln_b),
                     static_cast<const float*>(b1),
                     static_cast<const float*>(b2),
                     static_cast<const float*>(g2),
                     static_cast<bf16*>(out),
                     M,
                     Hd,
                     0,
                     eps};
  return body::launch<C>(mlp_tail_kernel<C>, m, a, stream);
}

}  // namespace

extern "C" int vlm_mlp_tail(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, const void* g2,
                            void* out, int M, int C, int Hd, float eps, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % body::kHC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<768>(x, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps, s);
    case 1024:
      return launch<1024>(x, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
