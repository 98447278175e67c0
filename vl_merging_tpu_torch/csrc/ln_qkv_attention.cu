// K8: ctx = attention(LN(x)·W_qkvᵀ + b) with the f32 rel-pos bias and the
// key mask, the packed qkv never written to device memory.
//
// Replaces vl_merging_tpu/ops/attention.py:_ln_qkv_attn_kernel (via
// _pallas_ln_qkv_attention / ln_qkv_attention, with
// fused_block.py:_qkv_pair_ctx).  Rounding points as K1 → K2 (see
// ln_qkv_attention.cuh, which holds the body).
//
// Bound on the H100: by its arithmetic.  At B = 32, N = 577, C = 768, 12
// heads it needs 2·M·C·3C = 65.4 GFLOP of projections and 4·64·N·N·12 per
// element (32.7 GFLOP at B = 32) of attention, ~98 GFLOP, against the x
// read, the context write, the weights and the 16 MB bias (~75 MB).
// Design: one block of 8 warps per (batch element, head), blockIdx.x the
// element, so the 32 blocks that share a head's bias (1.3 MB) run together
// and find it in L2.  Each block keeps its head's k and v for all N rows in
// shared memory (184 KB: one block per SM) and recomputes the LN
// statistics; x is re-read from L2 by each of the 12 heads.  N <= 640.
#include "ln_qkv_attention.cuh"

using namespace vlm;

namespace {

template <int C>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_qkv_attention_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                        const float* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ bias,
                        const int* __restrict__ mask, bf16* __restrict__ out, int N, float scale,
                        float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  ln_qkv_attention_block<C>(x + (size_t)b * N * C, ln_w, ln_b, wqkv, bqkv, bias,
                            mask + (size_t)b * N, out + (size_t)b * N * C, h, N, scale, eps,
                            smem);
}

}  // namespace

extern "C" int vlm_ln_qkv_attention(const void* x, const void* ln_w, const void* ln_b,
                                    const void* wqkv, const void* bqkv, const void* bias,
                                    const void* mask, void* out, int B, int N, int H,
                                    float scale, float eps, void* stream) {
  constexpr int C = 768;
  if (B <= 0 || N <= 0 || N > kMaxKeys || H * kAttnDim != C) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = ln_qkv_attention_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_attention_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_qkv_attention_kernel<C><<<dim3(B, H), kGemmThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(bias),
      static_cast<const int*>(mask), static_cast<bf16*>(out), N, scale, eps);
  return (int)cudaGetLastError();
}
