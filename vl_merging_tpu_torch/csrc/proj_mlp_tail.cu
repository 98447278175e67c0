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
// The body is block_tail.cuh's two halves, which K4 + K5 (the split pair)
// and K7 (the whole block) run too.
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
// shared memory, so it owns 32 rows and runs the MLP as
// common.cuh:mlp_hidden_chunks (128-wide hidden chunks, the f32 output
// accumulators in registers for the whole MLP).  The LN2 output stays in
// shared memory; x' is parked in the block's own rows of the output (an
// L2-resident 48 KB per block) to leave shared memory for the weight
// tiles.
#include "block_tail.cuh"

using namespace vlm;

namespace {

constexpr int BM = kMlpRows;

// NF: 16-column fragments per warp over the model width, C = 8 * NF * 16.
template <int NF>
__global__ void __launch_bounds__(kGemmThreads, 1)
proj_mlp_tail_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ res,
                     const bf16* __restrict__ wp, const float* __restrict__ bp,
                     const float* __restrict__ g1, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ g2,
                     bf16* out, int M, int Hd, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TailSmem sm(smem, 8 * NF * 16);
  const int row0 = blockIdx.x * BM;
  proj_residual_rows<NF>(ctx, res, wp, bp, g1, out, M, row0, sm);
  __syncthreads();  // x' complete (in out's rows); every warp is done reading ctx
  ln_mlp_residual_rows<NF>(out, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd, eps, row0, sm);
}

template <int NF>
int launch(const void* ctx, const void* res, const void* wp, const void* bp,
           const void* g1, const void* ln_w, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* g2, void* out,
           int M, int Hd, float eps, cudaStream_t stream) {
  constexpr int C = 8 * NF * 16;
  constexpr size_t smem = mlp_smem_bytes(C);
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
  if (M <= 0 || Hd <= 0 || Hd % kHiddenChunk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<6>(ctx, res, wp, bp, g1, ln_w, ln_b, w1, b1, w2, b2, g2, out, M, Hd,
                       eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
