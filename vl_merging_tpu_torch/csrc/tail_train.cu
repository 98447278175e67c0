// K6: the post-attention half of a training block in one kernel, with
// per-element effective gammas (LayerScale times the stochastic-depth
// scale of each batch element):
//   x' = bf16(res + g1[b] ⊙ (ctx·Wpᵀ + bp))
//   h  = bf16(gelu(bf16(LN2(x'))·W1ᵀ + b1))
//   out = bf16(x' + g2[b] ⊙ (h·W2ᵀ + b2))
// for row r of element b = r / N; g1 and g2 are (B, C) tables.
//
// Replaces vl_merging_tpu/ops/fused_block.py:_tail_train_kernel (via
// _tail_train_pallas / proj_mlp_tail_train), the forward of the training
// fusion (VLM_TPU_TRAIN_FUSION=tail|full there, ``train_fusion`` here).
// It is K3's arithmetic (mlp_body.cuh in mode kProjMlp, shared with K3 and
// K7) with the gammas read per row: the TPU kernel grids over batch
// elements, each cell holding one element's (N, C) rows and its (1, C)
// gammas, with N padded to a multiple of 16.  Here the grid is over
// 64-row blocks of the flattened (B·N, C) rows, as K3's: 577 (or 40) is
// not a multiple of 64, so a block may straddle elements, and each row
// looks up its own element's gammas.  N is not padded.  With every
// element's gammas equal to K3's γ, K6 gives K3's bits.  The backward is
// not a kernel: it is the autograd VJP of the unfused composition
// (ops/fused_block.py:tail_reference), as in the JAX package.
//
// Bound on the H100: by its arithmetic, as K3: 196 GFLOP at 32·577 rows
// (0.198 ms at the bf16 peak), 13.6 GFLOP at the text tower's 32·40 rows
// (0.014 ms).  Design: K3's (proj_mlp_tail.cu, mlp_body.cuh), built for
// C = 768 and 1024.
#include "mlp_body.cuh"

using namespace vlm;

namespace {

template <int C>
__global__ void __cluster_dims__(body::kCluster, 1, 1) __launch_bounds__(body::kThreads, 1)
    tail_train_kernel(const __grid_constant__ body::Maps m, const body::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  body::run<C, body::kProjMlp, ErffGelu>(m, a, smem, (blockIdx.x / body::kCluster) * body::kRows);
}

template <int C>
int launch(const void* ctx, const void* res, const void* wp, const void* bp, const void* g1,
           const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* g2, void* out, int M, int N, int Hd, float eps,
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
                     N,                              eps};
  return body::launch<C>(tail_train_kernel<C>, m, a, stream);
}

}  // namespace

// M = B·N rows; g1 and g2 are (B, C) f32.
extern "C" int vlm_tail_train(const void* ctx, const void* res, const void* wp, const void* bp,
                              const void* g1, const void* ln_w, const void* ln_b,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              const void* g2, void* out, int M, int N, int C, int Hd,
                              float eps, void* stream) {
  if (M <= 0 || N <= 0 || M % N != 0 || Hd <= 0 || Hd % body::kHC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<768>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, N, Hd,
                         eps, s);
    case 1024:
      return launch<1024>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, N, Hd,
                          eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
