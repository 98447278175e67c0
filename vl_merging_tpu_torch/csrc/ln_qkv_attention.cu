// K8: ctx = attention(LN(x)·W_qkvᵀ + b) with the f32 rel-pos bias and the
// key mask, in one launch.
//
// Replaces vl_merging_tpu/ops/attention.py:_ln_qkv_attn_kernel (via
// _pallas_ln_qkv_attention / ln_qkv_attention, with
// fused_block.py:_qkv_pair_ctx).  Its device code is K1's and K2's
// (ln_linear.cuh, packed_attention_fwd.cuh) with their tile shapes, so K8
// equals K1 → K2 bit for bit.
//
// Bound on the H100: by its arithmetic.  At B = 32, N = 577, C = 768, 12
// heads it needs 2·M·C·3C = 65.4 GFLOP of projections and 4·64·N·N·12 per
// element (32.7 GFLOP at B = 32) of attention, ~98 GFLOP, against the x
// read, the context write, the weights and the 16 MB bias (~75 MB).  The
// qkv scratch (85 MB at B = 32) goes through L2, as between K1 and K2.
//
// Design (Hopper, sm_90a).  The TPU kernel keeps a batch block's LN(x) and
// qkv in VMEM; here they would not fit in shared memory (one element's qkv
// is 2.7 MB at N = 577).  So K8 is one persistent launch of two roles on
// disjoint SMs, joined by a per-element handoff through L2, with no grid
// barrier:
//   * CTAs [0, ga) run K1's roles (a producer warpgroup and two consumer
//     warpgroups at 40 / 232 registers through setmaxnreg, clusters of two
//     sharing each W tile by TMA multicast) over the batch's rows, storing
//     the packed qkv in a (B, N, 3C) scratch, in K1's 128 x 256 tiles.
//     Their order (ln_linear.cuh Strided): the row pairs in order, cut
//     into units of `unit` column tiles dealt to the pairs in turn, so
//     that the elements' rows are finished from element 0 on.  After each
//     tile's stores every consumer warp adds 1, with release semantics at
//     GPU scope, to the counter done[b] of each element b its 16 rows
//     touch.
//   * CTAs [ga, grid) run K2's roles (a producer warpgroup, two consumer
//     warpgroups in ping-pong) over its (element, 128 query rows, head)
//     items, element-major (packed_attention_fwd.cuh ElementMajor).  Before
//     an item's q, k and v are loaded by TMA from the scratch, the
//     producer's first thread waits with an acquire load until done[b]
//     counts every (16-row group, column tile) of element b, and then
//     orders that view before the TMA reads (fence.proxy.async.global).
// The K2 role's CTAs first take the LN statistics of every row (K1's
// arithmetic, four rows a warp at a time in row order) into a global
// buffer, published per 128-row block; the K1 role's producer waits for
// its row block's before a tile's loads and its consumers read them once
// the tile's first stage has landed, so each row's statistics are taken
// once per launch, not once per tile (dealt singly, a pair's consecutive
// tiles have other rows).
// A CTA runs one role for the whole launch, so no value lives across the
// roles and each keeps the register budget of its own kernel.  The K2
// role's statistics wait for nothing and the K1 role for nothing else, so
// the waits form no cycle; the launch is cooperative (every CTA resident
// at once), so a spinning CTA never holds an SM that the CTA it waits for
// needs.  The counters are zeroed on the stream before the launch.
//
// The split ga is the caller's (ops/fused_block.ln_qkv_attention_split:
// the K1 role's share of the grid in proportion to its work, K1's per-tile
// and K2's per-item times).  delay_ns, a test's: every K1 tile's stores
// held back that long.
//
// Shared memory: the larger of the two roles' (K2's 225 KB).  Built for
// C = 768 and 1024 (12 and 16 heads of 64); any N that K2 takes.
#include "ln_linear.cuh"
#include "packed_attention_fwd.cuh"

using namespace vlm;

namespace {

constexpr int kThreads = k1::THREADS;
static_assert(k2::THREADS == kThreads, "K1's and K2's CTAs of three warpgroups");

template <int C>
constexpr int smem_bytes() {
  return k1::Layout<C>::BYTES > k2::SMEM ? k1::Layout<C>::BYTES : k2::SMEM;
}

struct Maps {
  CUtensorMap x, w;  // the K1 role's: x (B·N x C), W_qkv (3C x C)
  k2::Maps attn;     // the K2 role's: over the qkv scratch (B, N, 3C)
};

// The trace a profiler may ask for, per CTA: its first and last time stamp
// (the global timer, ns), the ns its K2 role spent waiting for elements,
// and the units it took (K1 role: column tiles; K2 role: items).
constexpr int kTrace = 4;

struct Args {
  k1::Args k1;
  k2::Args k2;
  int* done;       // (B,) zeroed: the K1 role's published tiles per element
  int* stat_done;  // (ceil(M / 128),) zeroed: the rows' LN statistics taken
  float* stats;    // (2, M): each row's LN mean and rstd
  unsigned long long* trace;  // null, or kTrace counters per CTA
  int ga, unit, delay_ns;
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    ln_qkv_attention_kernel(const __grid_constant__ Maps m, const Args a) {
  extern __shared__ __align__(1024) unsigned char raw[];
  unsigned long long* tr = a.trace == nullptr ? nullptr : a.trace + kTrace * blockIdx.x;
  if (tr != nullptr && threadIdx.x == 0) tr[0] = hop::global_ns();
  if ((int)blockIdx.x < a.ga) {
    k1::setup<C>(a.k1, raw);
    const k1::Strided rg(a.k1, blockIdx.x / k1::CL, a.ga / k1::CL, a.unit, a.done, a.stat_done,
                         a.stats, a.k2.N, a.delay_ns);
    if (threadIdx.x >= k1::CONSUMERS) {
      hop::setmaxnreg_dec<k1::PRODUCER_REGS>();
      k1::produce<C>(m.x, m.w, a.k1, raw, rg);
    } else {
      hop::setmaxnreg_inc<k1::CONSUMER_REGS>();
      k1::consume<C>(a.k1, raw, rg);
    }
    hop::cluster_sync();  // no CTA leaves while its peer may still multicast or arrive into it
    if (tr != nullptr && threadIdx.x == 0) tr[3] = rg.count;
  } else {
    // the LN statistics of every row for the K1 role (its arithmetic:
    // ln_linear.cuh warp_row_stats), four rows a warp at a time in row
    // order, each 128-row block's published by a release increment of
    // stat_done per four rows
    constexpr int W = kThreads / 32;
    const int M = a.k1.M, lane = threadIdx.x & 31;
    const int nw = ((int)gridDim.x - a.ga) * W;
    for (int r = 4 * (((int)blockIdx.x - a.ga) * W + (int)(threadIdx.x >> 5)); r < M;
         r += 4 * nw) {
      float mu[4], rs[4];
      ln_rows_stats<4, C / 256>(a.k1.x + (size_t)r * C, C, M - r, a.k1.eps, mu, rs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane == i && r + i < M) {
          a.stats[r + i] = mu[i];
          a.stats[M + r + i] = rs[i];
        }
      __syncwarp();  // every lane's stores come before lane 0's release
      if (lane == 0) hop::red_release_gpu(a.stat_done + r / 128, 1);
    }
    k2::setup(raw);
    const k2::ElementMajor its((int)blockIdx.x - a.ga, (int)gridDim.x - a.ga, a.done, a.k1.ncb,
                               a.k2.N, tr == nullptr ? nullptr : tr + 2);
    if (threadIdx.x >= k2::CONSUMERS)
      k2::produce(m.attn, a.k2, raw, its);
    else
      k2::consume(a.k2, raw, its);
    if (tr != nullptr) __syncthreads();  // every thread is past its role
  }
  if (tr != nullptr && threadIdx.x == 0) tr[1] = hop::global_ns();
}

// Clusters of two (K1's), cooperative: every CTA resident at once.
cudaLaunchConfig_t launch_config(cudaLaunchAttribute (&attrs)[2], int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = k1::CL;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cfg;
}

template <int C>
int max_grid() {
  constexpr int smem = smem_bytes<C>();
  if (cudaFuncSetAttribute(ln_qkv_attention_kernel<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config(attrs, smem, nullptr);
  cfg.numAttrs = 1;  // the occupancy query takes the cluster shape alone
  cfg.gridDim = dim3(k1::CL);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, ln_qkv_attention_kernel<C>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters * k1::CL;
}

template <int C>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv,
           const void* bias, const void* mask, void* qkv, int* done, float* stats, void* out,
           void* trace, int B, int N, int grid, int ga, int unit, int delay_ns, float scale,
           float eps, cudaStream_t stream) {
  constexpr int H = C / k2::D, O = 3 * C, ncb = O / k1::BN;
  constexpr int smem = smem_bytes<C>();
  if (grid % k1::CL != 0 || ga % k1::CL != 0 || ga < k1::CL || ga >= grid || unit <= 0 ||
      ncb % unit != 0)
    return (int)cudaErrorInvalidValue;
  const int M = B * N, tiles = (M + k1::BM * k1::CL - 1) / (k1::BM * k1::CL) * ncb;
  const int blocks = (M + k1::BM - 1) / k1::BM;
  const int nqt = (N + k2::BQ - 1) / k2::BQ;
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_attention_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Maps m;
  const uint64_t C3 = 3ull * C;
  if (!hop::make_tensor_map(&m.x, x, M, C, k1::BM, k1::BK) ||
      !hop::make_tensor_map(&m.w, wqkv, O, C, k1::BN / k1::CL, k1::BK) ||
      !hop::make_tensor_map_3d(&m.attn.q, qkv, {C3, (uint64_t)N, (uint64_t)B}, C3 * 2,
                               C3 * 2 * N, {k2::D, k2::BQ, 1}) ||
      !hop::make_tensor_map_3d(&m.attn.kv, qkv, {C3, (uint64_t)N, (uint64_t)B}, C3 * 2,
                               C3 * 2 * N, {k2::D, k2::BKV, 1}))
    return (int)cudaErrorNotSupported;
  const Args a{{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                static_cast<const float*>(ln_b), static_cast<const float*>(bqkv),
                static_cast<bf16*>(qkv), M, O, ncb, tiles, eps, 0},
               {static_cast<const float*>(bias), static_cast<const int*>(mask),
                static_cast<bf16*>(out), nullptr, B, N, H, nqt, B * H * nqt, scale},
               done,
               done + B,
               stats,
               static_cast<unsigned long long*>(trace),
               ga,
               unit,
               delay_ns};
  err = cudaMemsetAsync(done, 0, sizeof(int) * (B + blocks), stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config(attrs, smem, stream);
  cfg.gridDim = dim3(grid);
  err = cudaLaunchKernelEx(&cfg, ln_qkv_attention_kernel<C>, m, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The CTAs K8 launches at model width C: as many whole clusters of two as
// the card holds at once (the handoff needs every CTA resident), or 0
// where it cannot hold one or C is not built.
extern "C" int vlm_ln_qkv_attention_grid(int C) {
  switch (C) {
    case 768:
      return max_grid<768>();
    case 1024:
      return max_grid<1024>();
    default:
      return 0;
  }
}

// qkv: a (B, N, 3C) bf16 scratch; done: B + ceil(B·N / 128) int32 (zeroed
// here); stats: 2·B·N f32; trace: null, or grid x kTrace zeroed u64
// counters that receive the trace above.  grid: the value of
// vlm_ln_qkv_attention_grid(C); ga: the K1 role's CTAs (even, at least 2,
// below grid); unit: the K1 role's column tiles per unit (a divisor of
// 3C/256).
extern "C" int vlm_ln_qkv_attention(const void* x, const void* ln_w, const void* ln_b,
                                    const void* wqkv, const void* bqkv, const void* bias,
                                    const void* mask, void* qkv, void* done, void* stats,
                                    void* out, void* trace, int B, int N, int H, int grid,
                                    int ga, int unit, int delay_ns, float scale, float eps,
                                    void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* d = static_cast<int*>(done);
  float* st = static_cast<float*>(stats);
  switch (H * k2::D) {
    case 768:
      return launch<768>(x, ln_w, ln_b, wqkv, bqkv, bias, mask, qkv, d, st, out, trace, B, N,
                         grid, ga, unit, delay_ns, scale, eps, s);
    case 1024:
      return launch<1024>(x, ln_w, ln_b, wqkv, bqkv, bias, mask, qkv, d, st, out, trace, B, N,
                          grid, ga, unit, delay_ns, scale, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
