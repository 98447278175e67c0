// K4: y = bf16(res + γ ⊙ (x·Wᵀ + b)), the proj + LayerScale + residual of
// an eval block on its own (the first kernel of the split tail, K4 → K5).
//
// Replaces vl_merging_tpu/ops/fused_block.py:_linear_residual_kernel (via
// linear_residual/_row_call).  Same rounding points: x and W in bf16,
// products accumulated in f32, bias, LayerScale and residual in f32, the
// output rounded once to bf16.
//
// Bound on the H100: by its bytes.  At the main-path shape (M = 32·577,
// C = O = 768) it moves x, res and y (3·M·768·2 bytes, 85 MB) and the
// 1.2 MB weight for 21.8 GFLOP: ~250 flops/byte, below the bf16 ridge of
// ~295.  Design: K3's first half, mlp_body.cuh in mode kProj, built for
// C = O = 768 and 1024: the x rows of a 64-row block and 64-column Wp
// tiles by TMA, wgmma in its output warpgroup, a cluster of four CTAs
// over the output quarters.  Its output is bit for bit the x' that K3
// rounds and parks: the same instructions in the same order.
#include "mlp_body.cuh"

using namespace vlm;

namespace {

template <int C>
__global__ void __cluster_dims__(body::kCluster, 1, 1) __launch_bounds__(body::kThreads, 1)
    linear_residual_kernel(const __grid_constant__ body::Maps m, const body::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  body::run<C, body::kProj, ErffGelu>(m, a, smem, (blockIdx.x / body::kCluster) * body::kRows);
}

template <int C>
int launch(const void* x, const void* w, const void* b, const void* gamma, const void* res,
           void* y, int M, cudaStream_t stream) {
  body::Maps m;
  if (!body::make_maps<C>(&m, body::kProj, x, M, w, nullptr, nullptr, 0))
    return (int)cudaErrorNotSupported;
  const body::Args a{static_cast<const bf16*>(res), nullptr,
                     static_cast<const float*>(b),  static_cast<const float*>(gamma),
                     nullptr,                       nullptr,
                     nullptr,                       nullptr,
                     nullptr,                       static_cast<bf16*>(y),
                     M,                             0,
                     0,                             0.f};
  return body::launch<C>(linear_residual_kernel<C>, m, a, stream);
}

}  // namespace

extern "C" int vlm_linear_residual(const void* x, const void* w, const void* b,
                                   const void* gamma, const void* res, void* y, int M, int C,
                                   int O, void* stream) {
  if (M <= 0 || O != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<768>(x, w, b, gamma, res, y, M, s);
    case 1024:
      return launch<1024>(x, w, b, gamma, res, y, M, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
