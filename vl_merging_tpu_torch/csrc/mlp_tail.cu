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
// output).  Design: K3's second half verbatim
// (block_tail.cuh:ln_mlp_residual_rows): 32-row blocks, LN2 into shared
// memory, the hidden in 128-wide chunks contracted at once into f32 output
// accumulators in registers.  Fed the x' that K4 stores (K3 rounds x' to
// bf16 at the same point and keeps it on chip), it gives K3's output bit
// for bit.  As in K3 every 32-row block streams the 9.4 MB of MLP weights
// from L2.
#include "block_tail.cuh"

using namespace vlm;

namespace {

template <int NF>
__global__ void __launch_bounds__(kGemmThreads, 1)
mlp_tail_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ g2,
                bf16* __restrict__ out, int M, int Hd, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem sm(smem, 8 * NF * 16);
  ln_mlp_residual_rows<NF>(x, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps,
                           blockIdx.x * kMlpRows, sm);
}

template <int NF>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* g2, void* out, int M, int Hd, float eps,
           cudaStream_t stream) {
  constexpr size_t smem = mlp_smem_bytes(8 * NF * 16);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tail_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_tail_kernel<NF><<<(M + kMlpRows - 1) / kMlpRows, kGemmThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<bf16*>(out), M,
      Hd, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_mlp_tail(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, const void* g2,
                            void* out, int M, int C, int Hd, float eps, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % kHiddenChunk != 0 || C != 768)
    return (int)cudaErrorInvalidValue;
  return launch<6>(x, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps,
                   static_cast<cudaStream_t>(stream));
}
