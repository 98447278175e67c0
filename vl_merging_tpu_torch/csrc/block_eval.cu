// K7: a whole eval transformer block in one launch:
//   ctx = attention(LN1(x)·W_qkvᵀ + b_qkv)          (K8's body)
//   x'  = bf16(x + γ1 ⊙ (ctx·Wpᵀ + bp))             (K3's body, first half)
//   out = bf16(x' + γ2 ⊙ fc2(gelu(fc1(LN2(x')))))   (K3's body, second half)
//
// Replaces vl_merging_tpu/ops/fused_block.py:_block_eval_kernel (via
// _pallas_block_eval / fused_eval_block, with _qkv_pair_ctx).  Rounding
// points are K1 → K2 → K3's, and the device code is K8's and K3's
// (ln_qkv_attention.cuh, block_tail.cuh), so K7 can equal the staged
// kernels bit for bit.
//
// Bound on the H100: by its arithmetic, ~294 GFLOP at B = 32, N = 577
// (K8's 98 plus K3's 196) against x read once and out written once.
// Design: the TPU kernel keeps a batch block's x, LN(x), qkv and context in
// VMEM; one element's x alone (886 KB at N = 577) is four times a block's
// 227 KB of shared memory.  So K7 is one persistent, cooperative launch:
// as many blocks as fit on the card at once (1 per SM: K8's phase needs
// 218 KB of shared memory), each walking work items, with a grid-wide
// barrier between the phases.  Per chunk of bb batch elements:
//   phase 1: items (element, head), K8's body, the context into a scratch
//            buffer (bb·N·C bf16: the wrapper sizes bb so that it stays
//            within L2, 28 MB for the whole batch of 32 at N = 577);
//   barrier;
//   phase 2: 32-row blocks of the chunk's rows, K3's body, the output;
//   barrier (the next chunk overwrites the scratch).
// What stays on chip: LN1(x), q, k, v, the logits, LN2(x') and the MLP
// hidden; what goes through L2 (and, past its capacity, device memory):
// the context, and x' parked in the output rows as K3 parks it.
#include <cooperative_groups.h>

#include "block_tail.cuh"
#include "ln_qkv_attention.cuh"

using namespace vlm;
namespace cg = cooperative_groups;

namespace {

constexpr int C = 768, NF = C / 128;

constexpr size_t smem_bytes() {
  return ln_qkv_attention_smem_bytes() > mlp_smem_bytes(C) ? ln_qkv_attention_smem_bytes()
                                                           : mlp_smem_bytes(C);
}

struct BlockArgs {
  const bf16 *x, *wqkv, *wp, *w1, *w2;
  const float *ln1_w, *ln1_b, *bqkv, *bias, *bp, *g1, *ln2_w, *ln2_b, *b1, *b2, *g2;
  const int* mask;
  bf16 *scratch, *out;
  int B, N, H, Hd, bb;
  float scale, eps;
};

__global__ void __launch_bounds__(kGemmThreads, 1) block_eval_kernel(const BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const TailSmem sm(smem, C);
  for (int c0 = 0; c0 < a.B; c0 += a.bb) {
    const int nb = min(a.bb, a.B - c0);
    for (int item = blockIdx.x; item < nb * a.H; item += gridDim.x) {
      const int e = item % nb, h = item / nb;  // neighbouring blocks share a head's bias
      __syncthreads();  // no warp still reads the previous item's shared memory
      ln_qkv_attention_block<C>(a.x + (size_t)(c0 + e) * a.N * C, a.ln1_w, a.ln1_b, a.wqkv,
                                a.bqkv, a.bias, a.mask + (size_t)(c0 + e) * a.N,
                                a.scratch + (size_t)e * a.N * C, h, a.N, a.scale, a.eps, smem);
    }
    grid.sync();  // the chunk's context is complete
    const int rows = nb * a.N;
    const bf16* res = a.x + (size_t)c0 * a.N * C;
    bf16* out = a.out + (size_t)c0 * a.N * C;
    for (int blk = blockIdx.x; blk * kMlpRows < rows; blk += gridDim.x) {
      __syncthreads();
      proj_residual_rows<NF>(a.scratch, res, a.wp, a.bp, a.g1, out, rows, blk * kMlpRows, sm);
      __syncthreads();
      ln_mlp_residual_rows<NF>(out, a.ln2_w, a.ln2_b, a.w1, a.b1, a.w2, a.b2, a.g2, out, rows,
                               a.Hd, a.eps, blk * kMlpRows, sm);
    }
    grid.sync();  // every block is done reading the scratch
  }
}

}  // namespace

// The number of blocks K7 launches: all resident at once (a grid-wide
// barrier needs that), or 0 where the card cannot hold one.
extern "C" int vlm_block_eval_grid() {
  constexpr size_t smem = smem_bytes();
  if (cudaFuncSetAttribute(block_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_eval_kernel, kGemmThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

extern "C" int vlm_block_eval(const void* x, const void* ln1_w, const void* ln1_b,
                              const void* wqkv, const void* bqkv, const void* bias,
                              const void* mask, const void* wp, const void* bp, const void* g1,
                              const void* ln2_w, const void* ln2_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, const void* g2,
                              void* scratch, void* out, int B, int N, int H, int Hd, int bb,
                              float scale, float eps, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxKeys || H * kAttnDim != C || Hd <= 0 ||
      Hd % kHiddenChunk != 0 || bb <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = vlm_block_eval_grid();
  if (grid <= 0) return (int)cudaErrorLaunchOutOfResources;
  BlockArgs a{static_cast<const bf16*>(x),     static_cast<const bf16*>(wqkv),
              static_cast<const bf16*>(wp),    static_cast<const bf16*>(w1),
              static_cast<const bf16*>(w2),    static_cast<const float*>(ln1_w),
              static_cast<const float*>(ln1_b), static_cast<const float*>(bqkv),
              static_cast<const float*>(bias), static_cast<const float*>(bp),
              static_cast<const float*>(g1),   static_cast<const float*>(ln2_w),
              static_cast<const float*>(ln2_b), static_cast<const float*>(b1),
              static_cast<const float*>(b2),   static_cast<const float*>(g2),
              static_cast<const int*>(mask),   static_cast<bf16*>(scratch),
              static_cast<bf16*>(out),         B,
              N,                               H,
              Hd,                              bb,
              scale,                           eps};
  void* args[] = {&a};
  cudaError_t err =
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(block_eval_kernel), dim3(grid),
                                  dim3(kGemmThreads), args, smem_bytes(),
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
