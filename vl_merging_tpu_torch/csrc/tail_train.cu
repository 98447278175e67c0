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
// It is K3's arithmetic (block_tail.cuh, shared with K3, K5 and K7) with the
// gammas read per row: the TPU kernel grids over batch elements, each cell
// holding one element's (N, C) rows and its (1, C) gammas, with N padded to
// a multiple of 16.  Here the grid is over 32-row blocks of the flattened
// (B·N, C) rows, as K3's: 577 (or 40) is not a multiple of 32, so a block
// may straddle two elements, and each row looks up its own element's
// gammas.  N is not padded.  With every element's gammas equal to K3's γ,
// K6 gives K3's bits.  The backward is not a kernel: it is the autograd
// VJP of the unfused composition (ops/fused_block.py:tail_reference), as
// in the JAX package.
//
// Bound on the H100: by its arithmetic, as K3: 196 GFLOP at 32·577 rows
// (0.198 ms at the bf16 peak), 13.6 GFLOP at the text tower's 32·40 rows
// (0.014 ms).  As built it is K3: every 32-row block streams the 10.6 MB
// of bf16 weights from L2, and one block of 8 warps per SM holds the f32
// output accumulators (see proj_mlp_tail.cu).
#include "block_tail.cuh"

using namespace vlm;

namespace {

template <int NF>
__global__ void __launch_bounds__(kGemmThreads, 1)
tail_train_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ res,
                  const bf16* __restrict__ wp, const float* __restrict__ bp,
                  const float* __restrict__ g1, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ g2, bf16* out,
                  int M, int N, int Hd, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem sm(smem, 8 * NF * 16);
  const int row0 = blockIdx.x * kMlpRows;
  proj_residual_rows<NF>(ctx, res, wp, bp, g1, out, M, row0, sm, N);
  __syncthreads();  // x' complete (in out's rows); every warp is done reading ctx
  ln_mlp_residual_rows<NF>(out, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps, row0, sm, N);
}

template <int NF>
int launch(const void* ctx, const void* res, const void* wp, const void* bp, const void* g1,
           const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* g2, void* out, int M, int N, int Hd, float eps,
           cudaStream_t stream) {
  constexpr size_t smem = mlp_smem_bytes(8 * NF * 16);
  cudaError_t err = cudaFuncSetAttribute(
      tail_train_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_train_kernel<NF><<<(M + kMlpRows - 1) / kMlpRows, kGemmThreads, smem, stream>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(res),
      static_cast<const bf16*>(wp), static_cast<const float*>(bp),
      static_cast<const float*>(g1), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<bf16*>(out),
      M, N, Hd, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// M = B·N rows; g1 and g2 are (B, C) f32.
extern "C" int vlm_tail_train(const void* ctx, const void* res, const void* wp, const void* bp,
                              const void* g1, const void* ln_w, const void* ln_b,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              const void* g2, void* out, int M, int N, int C, int Hd,
                              float eps, void* stream) {
  if (M <= 0 || N <= 0 || M % N != 0 || Hd <= 0 || Hd % kHiddenChunk != 0 || C != 768)
    return (int)cudaErrorInvalidValue;
  return launch<6>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, N, Hd, eps,
                   static_cast<cudaStream_t>(stream));
}
