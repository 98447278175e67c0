// K7: a whole eval transformer block in one launch:
//   qkv = LN1(x)·W_qkvᵀ + b_qkv                    (K1's tiles)
//   ctx = attention(qkv, rel-pos bias, key mask)   (K2's items)
//   x'  = bf16(x + γ1 ⊙ (ctx·Wpᵀ + bp))            (the MLP body, first half)
//   out = bf16(x' + γ2 ⊙ fc2(gelu(fc1(LN2(x')))))  (the MLP body, second half)
//
// Replaces vl_merging_tpu/ops/fused_block.py:_block_eval_kernel (via
// _pallas_block_eval / fused_eval_block, with _qkv_pair_ctx).  Its
// rounding points are K1 → K2 → K3's, and its device code is theirs
// (ln_linear.cuh, packed_attention_fwd.cuh, mlp_body.cuh), so K7 equals
// the staged kernels bit for bit.
//
// Bound on the H100: by its arithmetic, ~294 GFLOP at B = 32, N = 577
// (qkv 65, attention 33, the body's 196) against x read once and out
// written once.
//
// Design: the TPU kernel keeps a batch block's x, LN(x), qkv and context in
// VMEM; one element's x alone (886 KB at N = 577) is four times a block's
// 227 KB of shared memory.  So K7 is one persistent, cooperative launch of
// clusters of four CTAs (the body's cluster, in which K1's CTA pairs are
// rank pairs), as many clusters as fit on the card at once (one CTA per
// SM), with a grid-wide barrier between the phases.  Per chunk of bb batch
// elements:
//   phase A: K1's tiles of the chunk's rows (64 x 128 a CTA: one consumer
//            warpgroup, LN1 in registers, W_qkv multicast across the CTA
//            pair), the packed qkv into a scratch;
//   barrier;
//   phase B: K2's (element, 64 query rows, head) items (one consumer
//            warpgroup), K/V by TMA from that scratch, the bias by 16-byte
//            cp.async; the context into a second scratch;
//   barrier;
//   phase C: the body's 64-row blocks (kProjMlp), one per cluster;
//   barrier (the next chunk overwrites the scratches).
// The wrapper sizes bb so that the two scratches (bb·N·3C + bb·N·C bf16)
// stay within 32 MB of the H100's 50 MB L2 and the body blocks fill the
// fewest rounds of clusters.
//
// Registers.  The CTA has NC + 1 warpgroups.  Built: NC = 1, two
// warpgroups at 255 registers a thread, one budget for every phase (in
// phases A and B a consumer and a producer warpgroup, in phase C the
// body's hidden and output warpgroups); ptxas reports no spill.  NC = 2 is
// K1's and K2's own CTA, three warpgroups at 168 registers a thread at
// launch, each phase's roles setting their own budget with setmaxnreg on
// entry and returning to 168 before the roles meet again (phase A K1's
// 232/40, phase B K2's 168, phase C the body's 240 and the idle third
// warpgroup's 24).  It computes the same bits, but ptxas spills over a
// kilobyte in it (most where phases A and B meet), and its phases B and C
// run slower than the built design's:
// chip_profile.py --variants times both, and the three warpgroups at one
// budget of 168.  Products start with write-only steps (hopper.cuh), and
// values an iteration reads are written on every path: without that the
// body spills in a loop at any budget.
// What stays on chip: LN1(x), the logits, LN2(x') and the MLP hidden; what
// goes through L2 (and, past its capacity, device memory): qkv and the
// context, and x' parked in the output rows as K3 parks it.
//
// Built for C = 768 and 1024 (ViT-B and ViT-L: 12 and 16 heads): each
// phase's code is built for both already (K1's Layout, K2 at any head
// count, body::Cfg), and the largest phase's shared memory, the body's,
// is the same at both.
#include <cooperative_groups.h>

#include "ln_linear.cuh"
#include "mlp_body.cuh"
#include "packed_attention_fwd.cuh"

using namespace vlm;
namespace cg = cooperative_groups;

namespace {

// NC consumer warpgroups in phases A and B (see the design notes), K1's
// tile width in phase A.
constexpr int NC = 1, kTN = 128 * NC;
constexpr int kThreads = k1::Roles<NC, kTN>::THREADS;
// A thread's registers at launch and between the phases' roles; with NC =
// 2, the budgets of phase C's warpgroups
constexpr int kRegs = NC == 2 ? 168 : 255;
constexpr int kBodyRegs = 240, kIdleRegs = 24;
static_assert(k2::Cfg<NC>::THREADS == kThreads && body::kThreads <= kThreads,
              "K1's and K2's roles, and the body's two warpgroups");
static_assert(NC == 1 || 2 * kBodyRegs + kIdleRegs == 3 * kRegs &&
                             2 * k1::CONSUMER_REGS + k1::PRODUCER_REGS == 3 * kRegs,
              "a phase's budgets fill the registers of the launch");

constexpr size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
template <int C>
constexpr size_t kSmem =
    max3(k1::Layout<C, NC, kTN>::BYTES, k2::Cfg<NC>::SMEM, body::Cfg<C>::SMEM);
static_assert(kSmem<768> <= 232448 && kSmem<1024> <= 232448,
              "over the H100's shared memory per block");

struct Maps {
  CUtensorMap x, wqkv;  // phase A: x (B·N x C) and W_qkv (3C x C)
  k2::Maps attn;        // phase B: over the qkv scratch (bb, N, 3C)
  body::Maps tail;      // phase C: a over the context scratch (bb·N x C), wp, w1, w2
};

struct BlockArgs {
  const bf16* x;
  const float *ln1_w, *ln1_b, *bqkv, *bias, *bp, *g1, *ln2_w, *ln2_b, *b1, *b2, *g2;
  const int* mask;
  bf16 *qkv, *ctx, *out;
  unsigned long long* trace;  // null, or kTrace counters per CTA (the profiler's)
  int B, N, H, Hd, bb;
  float scale, eps;
};

// The phase trace a profiler may ask for, per CTA, summed over the chunks:
// the nanoseconds (the global timer) in phase A, at its barrier, in phase
// B, at its barrier, in phase C, at its barrier [0..5]; the K1 tiles of its
// pair, its K2 items and its body blocks [6..8]; its first and last time
// stamp [9, 10]; the chunks [11].
constexpr int kTrace = 12;

// One stamp of the trace: after the CTA's threads meet, thread 0 adds the
// time since the previous stamp (kept in counter 10) to counter i.  Not
// traced: nothing.
__device__ __forceinline__ void stamp(unsigned long long* trace, int i) {
  if (trace == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* mine = trace + blockIdx.x * kTrace;
    const unsigned long long t = hop::global_ns();
    mine[i] += t - mine[10];
    mine[10] = t;
  }
}

__device__ __forceinline__ void count(unsigned long long* trace, int i, long long n) {
  if (trace != nullptr && threadIdx.x == 0) trace[blockIdx.x * kTrace + i] += n;
}

// Run `role` with R registers a thread, then return to kRegs (the caller's
// warpgroup, every thread of it).  With one budget (NC = 1): the role alone.
template <int R, class Role>
__device__ __forceinline__ void with_regs(Role role) {
  if constexpr (NC == 2 && R > kRegs) hop::setmaxnreg_inc<R>();
  if constexpr (NC == 2 && R < kRegs) hop::setmaxnreg_dec<R>();
  role();
  __syncwarp();  // a role's lanes part ways (K1's producer: its first lane alone)
  if constexpr (NC == 2 && R > kRegs) hop::setmaxnreg_dec<kRegs>();
  if constexpr (NC == 2 && R < kRegs) hop::setmaxnreg_inc<kRegs>();
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    block_eval_kernel(const __grid_constant__ Maps maps, const BlockArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (a.trace != nullptr && threadIdx.x == 0)
    a.trace[blockIdx.x * kTrace + 9] = a.trace[blockIdx.x * kTrace + 10] = hop::global_ns();
#pragma unroll 1
  for (int c0 = 0; c0 < a.B; c0 += a.bb) {
    const int nb = min(a.bb, a.B - c0), M = nb * a.N;

    // ---- phase A: the chunk's packed qkv (K1's tiles)
    {
      using R = k1::Roles<NC, kTN>;
      const int ncb = 3 * C / kTN, tiles = (M + R::BM * k1::CL - 1) / (R::BM * k1::CL) * ncb;
      const k1::Args ka{a.x + (size_t)c0 * a.N * C, a.ln1_w, a.ln1_b, a.bqkv, a.qkv, M, 3 * C,
                        ncb, tiles, a.eps, c0 * a.N};
      const k1::Range rg(ka, blockIdx.x / k1::CL, gridDim.x / k1::CL,
                         hop::cluster_rank() & ~(uint32_t)(k1::CL - 1));
      count(a.trace, 6, rg.count);
      hop::fence_proxy_async();  // earlier generic use of the shared memory before TMA writes
      k1::setup<C, NC, kTN>(ka, smem);
      if (threadIdx.x >= R::CONSUMERS)
        with_regs<k1::PRODUCER_REGS>(
            [&] { k1::produce<C, NC, kTN>(maps.x, maps.wqkv, ka, smem, rg); });
      else
        with_regs<k1::CONSUMER_REGS>([&] { k1::consume<C, NC, kTN>(ka, smem, rg); });
      hop::cluster_sync();  // no CTA goes on while its peer may still multicast or arrive into it
      if (threadIdx.x == 0) k1::invalidate<C, NC, kTN>(smem);
    }
    stamp(a.trace, 0);
    cg::this_grid().sync();  // the chunk's qkv is complete
    stamp(a.trace, 1);

    // ---- phase B: the chunk's context (K2's items)
    {
      const int nqt = (a.N + k2::Cfg<NC>::BQ - 1) / k2::Cfg<NC>::BQ, items = nb * a.H * nqt;
      const k2::Args kb{a.bias, a.mask + (size_t)c0 * a.N, a.ctx, nullptr, nb, a.N, a.H, nqt,
                        items, a.scale};
      hop::fence_proxy_async();
      k2::setup<NC>(smem);
      if (threadIdx.x >= k2::Cfg<NC>::CONSUMERS)
        k2::produce<NC>(maps.attn, kb, smem);
      else
        k2::consume<NC>(kb, smem);
      __syncthreads();  // every thread is past its role: the barriers can go
      if (threadIdx.x == 0) k2::invalidate<NC>(smem);
      count(a.trace, 7,
            items > (int)blockIdx.x ? (items - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0);
    }
    stamp(a.trace, 2);
    cg::this_grid().sync();  // the chunk's context is complete; nobody reads its qkv any more
    stamp(a.trace, 3);

    // ---- phase C: the body's 64-row blocks, one per cluster.  It reads and
    // writes x and out at global rows (c0·N + the block's), the context
    // scratch at the chunk's.  Every warpgroup walks the blocks (their
    // barriers need all the CTA's threads); a third one (NC = 2) idles.
    {
      const body::Args t{a.x, nullptr, a.bp, a.g1, a.ln2_w, a.ln2_b, a.b1, a.b2, a.g2, a.out,
                         c0 * a.N + M, a.Hd, 0, a.eps};
      const body::Smem<C> s(smem);
      auto blocks = [&](auto role) {
#pragma unroll 1
        for (int blk = blockIdx.x / body::kCluster; blk * body::kRows < M;
             blk += gridDim.x / body::kCluster) {
          // (no warp reads the previous block's shared memory: end() ends in a
          // cluster barrier, and a CTA barrier here would sit in divergent code)
          body::begin<C, body::kProjMlp>(maps.tail, s, blk * body::kRows);
          role(blk);
          body::end<C>(s);
          count(a.trace, 8, 1);
        }
      };
      if (NC == 1 || threadIdx.x < body::kThreads)
        with_regs<kBodyRegs>([&] {
          blocks([&](int blk) {
            body::consume<C, body::kProjMlp, ErffGelu>(
                maps.tail, t, s, c0 * a.N + blk * body::kRows, (int)hop::cluster_rank());
          });
        });
      else
        with_regs<kIdleRegs>([&] { blocks([](int) {}); });
      count(a.trace, 11, 1);
    }
    stamp(a.trace, 4);
    cg::this_grid().sync();  // every block is done reading the context scratch
    stamp(a.trace, 5);
  }
}

// The launch configuration of K7 at width C without its grid: clusters of
// four CTAs, cooperative (its grid-wide barriers need every CTA resident
// at once).
template <int C>
cudaLaunchConfig_t launch_config(cudaLaunchAttribute (&attrs)[2], cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem<C>;
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

template <int C>
int grid_of() {
  if (cudaFuncSetAttribute(block_eval_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmem<C>) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config<C>(attrs, nullptr);
  cfg.numAttrs = 1;  // the occupancy query takes the cluster shape alone
  cfg.gridDim = dim3(body::kCluster);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, block_eval_kernel<C>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters * body::kCluster;
}

// The tensor maps and the launch at width C.
template <int C>
int launch(const BlockArgs& a, const void* x, const void* wqkv, const void* wp, const void* w1,
           const void* w2, int grid, cudaStream_t stream) {
  const int B = a.B, N = a.N, bb = a.bb;
  Maps maps;
  const uint64_t C3 = 3ull * C;
  if (!hop::make_tensor_map(&maps.x, x, (uint64_t)B * N, C, k1::Roles<NC, kTN>::BM, k1::BK) ||
      !hop::make_tensor_map(&maps.wqkv, wqkv, 3 * C, C, kTN / k1::CL, k1::BK) ||
      !hop::make_tensor_map_3d(&maps.attn.q, a.qkv, {C3, (uint64_t)N, (uint64_t)bb}, C3 * 2,
                               C3 * 2 * N, {k2::D, k2::Cfg<NC>::BQ, 1}) ||
      !hop::make_tensor_map_3d(&maps.attn.kv, a.qkv, {C3, (uint64_t)N, (uint64_t)bb}, C3 * 2,
                               C3 * 2 * N, {k2::D, k2::BKV, 1}) ||
      !body::make_maps<C>(&maps.tail, body::kProjMlp, a.ctx, bb * N, wp, w1, w2, a.Hd))
    return (int)cudaErrorNotSupported;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config<C>(attrs, stream);
  cfg.gridDim = dim3(grid);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, block_eval_kernel<C>, maps, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The number of CTAs K7 launches at width C: as many whole clusters as the
// card holds at once (a grid-wide barrier needs that), or 0 where it cannot
// hold one or K7 is not built for C.  The caller queries it once per
// process and width (the port runs on one card).
extern "C" int vlm_block_eval_grid(int C) {
  switch (C) {
    case 768:
      return grid_of<768>();
    case 1024:
      return grid_of<1024>();
    default:
      return 0;
  }
}

// scratch: bb·N·3C bf16 of packed qkv, then bb·N·C bf16 of context, C =
// 64·H.  trace: null, or grid x kTrace zeroed u64 counters that receive the
// phase trace above.  grid: the value of vlm_block_eval_grid(C).
extern "C" int vlm_block_eval(const void* x, const void* ln1_w, const void* ln1_b,
                              const void* wqkv, const void* bqkv, const void* bias,
                              const void* mask, const void* wp, const void* bp, const void* g1,
                              const void* ln2_w, const void* ln2_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, const void* g2,
                              void* scratch, void* out, void* trace, int B, int N, int H,
                              int Hd, int bb, int grid, float scale, float eps, void* stream) {
  const int C = H * k2::D;
  if (B <= 0 || N <= 0 || (C != 768 && C != 1024) || Hd <= 0 || Hd % body::kHC != 0 || bb <= 0)
    return (int)cudaErrorInvalidValue;
  if (grid <= 0 || grid % body::kCluster != 0) return (int)cudaErrorLaunchOutOfResources;
  bf16* qkv = static_cast<bf16*>(scratch);
  bf16* ctx = qkv + (size_t)bb * N * 3 * C;
  const BlockArgs a{static_cast<const bf16*>(x),      static_cast<const float*>(ln1_w),
                    static_cast<const float*>(ln1_b), static_cast<const float*>(bqkv),
                    static_cast<const float*>(bias),  static_cast<const float*>(bp),
                    static_cast<const float*>(g1),    static_cast<const float*>(ln2_w),
                    static_cast<const float*>(ln2_b), static_cast<const float*>(b1),
                    static_cast<const float*>(b2),    static_cast<const float*>(g2),
                    static_cast<const int*>(mask),    qkv,
                    ctx,                              static_cast<bf16*>(out),
                    static_cast<unsigned long long*>(trace),
                    B,                                N,
                    H,                                Hd,
                    bb,                               scale,
                    eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 768 ? launch<768>(a, x, wqkv, wp, w1, w2, grid, s)
                  : launch<1024>(a, x, wqkv, wp, w1, w2, grid, s);
}
