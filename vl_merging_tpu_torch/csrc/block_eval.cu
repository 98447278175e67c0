// K7: a whole eval transformer block in one launch:
//   ctx = attention(LN1(x)·W_qkvᵀ + b_qkv)          (K8's body)
//   x'  = bf16(x + γ1 ⊙ (ctx·Wpᵀ + bp))             (K3's body, first half)
//   out = bf16(x' + γ2 ⊙ fc2(gelu(fc1(LN2(x')))))   (K3's body, second half)
//
// Replaces vl_merging_tpu/ops/fused_block.py:_block_eval_kernel (via
// _pallas_block_eval / fused_eval_block, with _qkv_pair_ctx).  Rounding
// points are K1 → K2 → K3's, and the device code is K8's and K3's
// (ln_qkv_attention.cuh, mlp_body.cuh), so K7 can equal the staged
// kernels bit for bit.
//
// Bound on the H100: by its arithmetic, ~294 GFLOP at B = 32, N = 577
// (K8's 98 plus K3's 196) against x read once and out written once.
// Design: the TPU kernel keeps a batch block's x, LN(x), qkv and context in
// VMEM; one element's x alone (886 KB at N = 577) is four times a block's
// 227 KB of shared memory.  So K7 is one persistent, cooperative launch of
// clusters of four CTAs (K3's body needs its cluster): as many clusters as
// fit on the card at once (1 CTA per SM: each phase needs ~220 KB of shared
// memory), each CTA walking work items, with a grid-wide barrier between
// the phases.  Per chunk of bb batch elements:
//   phase 1: items (element, head), K8's body, the context into
//            a scratch buffer (bb·N·C bf16: the wrapper sizes bb so that it
//            stays within L2, 28 MB for the whole batch of 32 at N = 577);
//   barrier;
//   phase 2: 64-row blocks of the chunk's rows, one per cluster, K3's body;
//   barrier (the next chunk overwrites the scratch).
// What stays on chip: LN1(x), q, k, v, the logits, LN2(x') and the MLP
// hidden; what goes through L2 (and, past its capacity, device memory):
// the context, and x' parked in the output rows as K3 parks it.
#include <cooperative_groups.h>

#include "mlp_body.cuh"
#include "ln_qkv_attention.cuh"

using namespace vlm;
namespace cg = cooperative_groups;

namespace {

constexpr int C = 768;
static_assert(body::kThreads == kGemmThreads, "K8's and K3's bodies share the block");

constexpr size_t smem_bytes() {
  return ln_qkv_attention_smem_bytes() > (size_t)body::Cfg<C>::SMEM
             ? ln_qkv_attention_smem_bytes()
             : (size_t)body::Cfg<C>::SMEM;
}

struct BlockArgs {
  const bf16 *x, *wqkv, *wp, *w1, *w2;
  const float *ln1_w, *ln1_b, *bqkv, *bias, *bp, *g1, *ln2_w, *ln2_b, *b1, *b2, *g2;
  const int* mask;
  bf16 *scratch, *out;
  unsigned long long* trace;  // null, or kTrace counters per CTA (the profiler's)
  int B, N, H, Hd, bb;
  float scale, eps;
};

// The phase trace a profiler may ask for: per CTA, the nanoseconds (the
// global timer) spent in phase 1's items, waiting at the first barrier, in
// phase 2's blocks and waiting at the second barrier, summed over the
// chunks; the items and blocks it took; its first and last time stamp.
constexpr int kTrace = 8;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One stamp of the trace: after the CTA's threads meet, thread 0 adds the
// time since the previous stamp to counter i.  Not traced: nothing.
__device__ __forceinline__ void stamp(unsigned long long* trace, int i, unsigned long long& t0) {
  if (trace == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t = global_ns();
    trace[blockIdx.x * kTrace + i] += t - t0;
    t0 = t;
  }
}

__global__ void __launch_bounds__(kGemmThreads, 1)
    block_eval_kernel(const __grid_constant__ body::Maps maps, const BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  unsigned long long* trace = a.trace;
  unsigned long long t0 = 0;
  if (trace != nullptr && threadIdx.x == 0) t0 = trace[blockIdx.x * kTrace + 6] = global_ns();
  for (int c0 = 0; c0 < a.B; c0 += a.bb) {
    const int nb = min(a.bb, a.B - c0);
    for (int item = blockIdx.x; item < nb * a.H; item += gridDim.x) {
      const int e = item % nb, h = item / nb;  // neighbouring blocks share a head's bias
      __syncthreads();  // no warp still reads the previous item's shared memory
      ln_qkv_attention_block<C>(a.x + (size_t)(c0 + e) * a.N * C, a.ln1_w, a.ln1_b, a.wqkv,
                                a.bqkv, a.bias, a.mask + (size_t)(c0 + e) * a.N,
                                a.scratch + (size_t)e * a.N * C, h, a.N, a.scale, a.eps, smem);
      if (trace != nullptr && threadIdx.x == 0) trace[blockIdx.x * kTrace + 4] += 1;
    }
    stamp(trace, 0, t0);
    grid.sync();  // the chunk's context is complete
    stamp(trace, 1, t0);
    const body::Args t{a.x + (size_t)c0 * a.N * C, nullptr, a.bp, a.g1, a.ln2_w, a.ln2_b,
                       a.b1, a.b2, a.g2, a.out + (size_t)c0 * a.N * C, nb * a.N, a.Hd, 0,
                       a.eps};
    for (int blk = blockIdx.x / body::kCluster; blk * body::kRows < t.M;
         blk += gridDim.x / body::kCluster) {
      __syncthreads();  // no warp still reads the previous item's shared memory
      body::run<C, body::kProjMlp, ErffGelu>(maps, t, smem, blk * body::kRows);
      if (trace != nullptr && threadIdx.x == 0) trace[blockIdx.x * kTrace + 5] += 1;
    }
    stamp(trace, 2, t0);
    grid.sync();  // every block is done reading the scratch
    stamp(trace, 3, t0);
  }
  if (trace != nullptr && threadIdx.x == 0) trace[blockIdx.x * kTrace + 7] = t0;
}

// The launch configuration of K7 without its grid: clusters of four CTAs,
// cooperative (its grid-wide barriers need every CTA resident at once).
cudaLaunchConfig_t launch_config(cudaLaunchAttribute (&attrs)[2], cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = smem_bytes();
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = body::kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

// The number of CTAs K7 launches: as many whole clusters as the card holds
// at once (a grid-wide barrier needs that), or 0 where it cannot hold one.
// trace (of vlm_block_eval): null, or grid x kTrace zeroed u64 counters
// that receive the phase trace above.
extern "C" int vlm_block_eval_grid() {
  if (cudaFuncSetAttribute(block_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes()) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config(attrs, nullptr);
  cfg.numAttrs = 1;  // the occupancy query takes the cluster shape alone
  cfg.gridDim = dim3(body::kCluster);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, block_eval_kernel, &cfg) != cudaSuccess) return 0;
  return clusters * body::kCluster;
}

extern "C" int vlm_block_eval(const void* x, const void* ln1_w, const void* ln1_b,
                              const void* wqkv, const void* bqkv, const void* bias,
                              const void* mask, const void* wp, const void* bp, const void* g1,
                              const void* ln2_w, const void* ln2_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, const void* g2,
                              void* scratch, void* out, void* trace, int B, int N, int H,
                              int Hd, int bb, float scale, float eps, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxKeys || H * kAttnDim != C || Hd <= 0 ||
      Hd % body::kHC != 0 || bb <= 0)
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
              static_cast<bf16*>(out),         static_cast<unsigned long long*>(trace),
              B,
              N,                               H,
              Hd,                              bb,
              scale,                           eps};
  body::Maps maps;
  if (!body::make_maps<C>(&maps, body::kProjMlp, scratch, bb * N, wp, w1, w2, Hd))
    return (int)cudaErrorNotSupported;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config(attrs, static_cast<cudaStream_t>(stream));
  cfg.gridDim = dim3(grid);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, block_eval_kernel, maps, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
