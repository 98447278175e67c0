// K13: the transformer MLP in one kernel:
//   out = bf16(bf16(gelu(x·W1ᵀ + b1))·W2ᵀ + b2)
//
// Replaces vl_merging_tpu/ops/mlp.py:_mlp_kernel (via _pallas_mlp /
// fused_mlp).  Same rounding points as the TPU kernel: fc1 accumulates in
// f32 and adds b1 in f32, the gelu runs in f32 with the Abramowitz-Stegun
// erf (|err| <= 1.5e-7; the TPU kernel's _erf_approx, evaluated here with
// fused multiply-adds), the hidden is rounded to bf16, fc2 accumulates in
// f32 and adds b2 in f32, and the output is rounded once.
//
// Bound on the H100: by its arithmetic (4·M·C·H flops: 174 GFLOP at
// M = 32·577, C = 768, H = 3072, against 57 MB of rows, weights and
// output).  The TPU kernel keeps both weights and a (256, 3072) f32 hidden
// in VMEM.  Here it is K3's MLP body (mlp_body.cuh, mode kMlp), built for
// C = 768 and 1024: the x rows of a 64-row block come by TMA, a cluster of
// four CTAs splits the output columns and each 128-wide hidden chunk four
// ways, wgmma products accumulate in f32 registers, and each weight tile is
// read from L2 once per 64 rows.
#include "mlp_body.cuh"

using namespace vlm;

namespace {

template <int C>
__global__ void __cluster_dims__(body::kCluster, 1, 1) __launch_bounds__(body::kThreads, 1)
    mlp_kernel(const __grid_constant__ body::Maps m, const body::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  body::run<C, body::kMlp, ErfApproxGelu>(m, a, smem,
                                          (blockIdx.x / body::kCluster) * body::kRows);
}

template <int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int M, int Hd, cudaStream_t stream) {
  body::Maps m;
  if (!body::make_maps<C>(&m, body::kMlp, x, M, nullptr, w1, w2, Hd))
    return (int)cudaErrorNotSupported;
  const body::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     static_cast<const float*>(b1), static_cast<const float*>(b2), nullptr,
                     static_cast<bf16*>(out), M, Hd, 0, 0.f};
  return body::launch<C>(mlp_kernel<C>, m, a, stream);
}

}  // namespace

extern "C" int vlm_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int M, int C, int Hd, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % body::kHC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<768>(x, w1, b1, w2, b2, out, M, Hd, s);
    case 1024:
      return launch<1024>(x, w1, b1, w2, b2, out, M, Hd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
