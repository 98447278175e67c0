// K1: y = LN(x)·Wᵀ + b, the pre-norm + qkv projection of an eval block (and
// of a training block's forward under train_fusion "full").
//
// Replaces vl_merging_tpu/ops/fused_block.py:_ln_linear_kernel (via
// ln_linear/_row_call).  Same rounding points: LN statistics in f32 with
// eps, the normalised row rounded to bf16 before the GEMM, f32
// accumulation, bias added in f32, output rounded to bf16.  The LN
// arithmetic is common.cuh's ln_rows_stats (the per-row f32 sums of
// ln_rows_to_bf16_at, in the same order) and its (x - mean) · rstd · w + b.
// The products sum their k16 steps in order on wgmma, where the WMMA K1
// before (and K8) summed them on mma.sync: the same rounding points, not
// the same bits.
//
// Bound on the H100: tensor-core throughput.  At the main-path shape
// (B·577 x 768) · (768 x 2304) it is 2·M·768·2304 flops against
// (M·768 + 768·2304 + M·2304)·2 bytes: 65.3 GFLOP over 117 MB at B=32,
// ~560 flops/byte, above the H100's bf16 ridge of ~295.
//
// Design (Hopper, sm_90a).  A CTA owns 128 x 256 output tiles: two
// consumer warpgroups of 64 rows, each with its 128 f32 accumulators a
// thread in registers (one wgmma m64n256k16 per k16 step; 232 registers a
// thread, which the producer warpgroup's 40 leave room for), and a producer
// warpgroup whose first thread keeps a ring of STAGES k-tiles full by TMA:
// per stage the CTA's 128 x 64 raw x tile and the 256 x 64 W tile, both
// 128B-swizzled, completing on the stage's mbarrier.  The two CTAs of a
// cluster (CL) take consecutive 128-row blocks of the same output columns,
// and each loads half of every W tile, multicast to both, so W reaches the
// SMs once per 256 rows.  A stage is refilled once every consumer warp of
// the cluster released it: each warp arrives on both CTAs' barrier, with
// release semantics at CTA scope (cluster scope measured slower).  The LN
// is applied on the fly, in registers: when a tile starts a new row block,
// each warp computes the f32 statistics of its 16 rows from device memory
// (ln_rows_stats, four rows at once) while the producer already streams
// the tile's k-tiles; then per k step each warp reads its rows of the raw
// x k-tile as wgmma A fragments (ldmatrix), normalises them, rounds them to
// bf16 and feeds them to wgmma from registers (A from registers, W from
// shared memory), in two halves of 32 columns, so that the products of one
// half run while the next is normalised.  The grid is persistent: as many
// clusters as fit (one CTA per SM), each walking a contiguous run of tiles
// in row-major tile order, so consecutive tiles share their rows
// (statistics computed once per run of row blocks) and a tile's epilogue
// (+ bias, bf16; the four threads of a quad trade columns so that each
// row's 8 columns leave in one 16-byte store) overlaps the loads of the
// next.
//
// L2 traffic per launch at 32·577 rows (arithmetic from the tiles):
//   C = 768, O = 2304: 73 row pairs x 9 column tiles = 657 cluster tiles;
//     W 657 x 393 KB = 258 MB (the 64 x 384 WMMA design before: 1.02 GB),
//     raw x k-tiles 1314 x 197 KB = 258 MB, statistics ~(145 + 132) x
//     197 KB = 55 MB.
//   C = 1024, O = 3072: 876 cluster tiles; W 459 MB (before: 1.82 GB), x
//     k-tiles 459 MB, statistics ~73 MB.
// Waves (66 clusters of 2 on 132 SMs): 18464 rows, 9.95 cluster tiles a
// cluster at C = 768, 13.3 at 1024; 1280 rows (a text batch), 45 tiles:
// one partial wave on 90 SMs; 4616 rows (ViT-L micro-batch 8), 19 row
// pairs x 12 = 228 tiles, 3.5.
//
// Shared memory: STAGES x (16 KB x + 32 KB W) = 192 KB, LN weights 2·C
// floats, 128 row means and rstds, barriers, 1 KB alignment slack: 200 KB
// at C = 768, 202 KB at 1024.  Built for C = 768 and 1024; O a multiple of
// 256.
#include "ln_linear.cuh"

using namespace vlm;
using namespace vlm::k1;

namespace {

template <int C>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
    ln_linear_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Args a) {
  extern __shared__ __align__(1024) unsigned char raw[];
  setup<C>(a, raw);
  const Range rg(a, blockIdx.x / CL, gridDim.x / CL, 0);
  if (threadIdx.x >= CONSUMERS) {  // the producer gives up registers for the accumulators
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    produce<C>(xmap, wmap, a, raw, rg);
  } else {
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    consume<C>(a, raw, rg);
  }
  hop::cluster_sync();  // no CTA leaves while its peer may still multicast or arrive into it
}

// Clusters of the persistent grid: as many as fit on the device at once.
template <int C>
int max_clusters() {
  static int n = 0;
  if (n == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = Layout<C>::BYTES;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, ln_linear_kernel<C>, &cfg) != cudaSuccess ||
        clusters <= 0) {
      cudaGetLastError();
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      clusters = sms / CL;
    }
    n = clusters;
  }
  return n;
}

template <int C>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* b,
           void* y, int M, int O, float eps, cudaStream_t stream) {
  if (O % BN != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ln_linear_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<C>::BYTES);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap;
  if (!hop::make_tensor_map(&xmap, x, M, C, BM, BK) ||
      !hop::make_tensor_map(&wmap, w, O, C, BN / CL, BK))
    return (int)cudaErrorNotSupported;
  const int ncb = O / BN, tiles = (M + BM * CL - 1) / (BM * CL) * ncb;
  const int clusters = tiles < max_clusters<C>() ? tiles : max_clusters<C>();
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
               static_cast<const float*>(ln_b), static_cast<const float*>(b),
               static_cast<bf16*>(y), M, O, ncb, tiles, eps, 0};
  ln_linear_kernel<C><<<clusters * CL, THREADS, Layout<C>::BYTES, stream>>>(xmap, wmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_ln_linear(const void* x, const void* ln_w, const void* ln_b,
                             const void* w, const void* b, void* y, int M, int C, int O,
                             float eps, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<768>(x, ln_w, ln_b, w, b, y, M, O, eps, s);
    case 1024:
      return launch<1024>(x, ln_w, ln_b, w, b, y, M, O, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vlm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
