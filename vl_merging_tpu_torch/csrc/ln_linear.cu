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
#include "common.cuh"
#include "hopper.cuh"

using namespace vlm;

namespace {

constexpr int BM = 128, BN = 256, BK = 64;  // a CTA's tile; a k-tile is one swizzle row
constexpr int CL = 2;                       // CTAs of a cluster, sharing every W tile
constexpr int STAGES = 4;
// two consumer warpgroups and a producer warpgroup, whose first thread issues
// the loads; the producer gives up registers for the consumers' accumulators
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int A_BYTES = BM * BK * 2, W_BYTES = BN * BK * 2, STAGE = A_BYTES + W_BYTES;

template <int C>
struct Layout {
  static constexpr int LNW = STAGES * STAGE;  // ln_w, ln_b (f32) by column pairs
  static constexpr int STAT = LNW + 2 * C * 4;  // mean, rstd of the CTA's 128 rows
  static constexpr int BAR = STAT + 2 * BM * 4;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = 1024 + BAR + 2 * STAGES * 8;
  static_assert(BYTES <= 232448, "over the H100's shared memory per block");
};

struct Args {
  const bf16* x;
  const float *ln_w, *ln_b, *bias;
  bf16* y;
  int M, O, ncb, tiles;  // ncb: column tiles; tiles: cluster tiles (row pairs x ncb)
  float eps;
};

// The byte offset of the 16-byte chunk ch (columns 8ch..8ch+7) of row r in
// a 128B-swizzled tile of 128-byte rows.
__device__ __forceinline__ int swz(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8): a 16 x 16 m16n8k16 A fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hop::smem_u32(p)));
}

template <int C>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
    ln_linear_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Args a) {
  using L = Layout<C>;
  constexpr int NV = C / 256, KT = C / BK;
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* base = raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
  // LN weights by column pairs: {w[c], w[c + 1], b[c], b[c + 1]} at wb[c / 2]
  float4* wb = reinterpret_cast<float4*>(base + L::LNW);
  float* mean = reinterpret_cast<float*>(base + L::STAT);
  float* rstd = mean + BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + STAGES;

  const int rank = (int)hop::cluster_rank();
  const int cluster = blockIdx.x / CL, nclusters = gridDim.x / CL;
  const int t_begin = (int)((long long)cluster * a.tiles / nclusters);
  const int t_end = (int)((long long)(cluster + 1) * a.tiles / nclusters);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CL * CONSUMER_WARPS);
    }
    hop::fence_mbar_init();
  }
  for (int i = threadIdx.x; i < C / 2; i += THREADS)
    wb[i] = make_float4(a.ln_w[2 * i], a.ln_w[2 * i + 1], a.ln_b[2 * i], a.ln_b[2 * i + 1]);
  hop::cluster_sync();  // both CTAs' barriers exist before any multicast or remote arrive

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: the first thread of warpgroup 2 fills the ring
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int rb = (t / a.ncb) * CL + rank, cb = t % a.ncb;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          // the stage's previous use released by every consumer warp of the cluster
          if (it >= STAGES) hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = base + s * STAGE;
          // a CTA past the last row (the second of the last pair) loads no
          // x: its rows are computed from stale values and not stored
          const bool rows = rb * BM < a.M;
          hop::mbar_arrive_expect_tx(&full[s], rows ? STAGE : W_BYTES);
          if (rows) hop::tma_load_2d(st, &xmap, kt * BK, rb * BM, &full[s]);
          hop::tma_load_2d_multicast(st + A_BYTES + rank * (W_BYTES / CL), &wmap, kt * BK,
                                     cb * BN + rank * (BN / CL), &full[s], (1u << CL) - 1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64wg.. of the CTA's tile, warp w
    // of it rows 16w.. (wr), this thread rows wr + g and wr + g + 8
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = 16 * warp;
    auto release = [&](int s) {  // every lane of the warp is past its wgmma wait
      if (lane == 0)
        for (int r = 0; r < CL; ++r) hop::mbar_arrive_remote(&empty[s], r);
    };
    float acc[BN / 2];
    float mu0 = 0.f, rs0 = 0.f, mu1 = 0.f, rs1 = 0.f;  // LN statistics of the two rows
    int it = 0, cur_rb = -1;

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int rb = (tile / a.ncb) * CL + rank, cb = tile % a.ncb;
      const int row0 = rb * BM;
      if (rb != cur_rb) {  // the LN statistics of the warp's 16 rows, four at a time
        __syncwarp();      // every lane has read the previous ones
#pragma unroll 1
        for (int i = 0; i < 16; i += 4) {
          float mu[4], rs[4];
          ln_rows_stats<4, NV>(a.x + (size_t)(row0 + wr + i) * C, C, a.M - (row0 + wr + i), a.eps,
                               mu, rs);
          if (lane < 4) {
            mean[wr + i + lane] = lane == 0 ? mu[0] : lane == 1 ? mu[1] : lane == 2 ? mu[2] : mu[3];
            rstd[wr + i + lane] = lane == 0 ? rs[0] : lane == 1 ? rs[1] : lane == 2 ? rs[2] : rs[3];
          }
        }
        __syncwarp();
        mu0 = mean[wr + g];
        rs0 = rstd[wr + g];
        mu1 = mean[wr + g + 8];
        rs1 = rstd[wr + g + 8];
        cur_rb = rb;
      }
      // Per k step: the warp's 16 rows of the landed x k-tile as wgmma A
      // fragments (ldmatrix from the swizzled tile), normalised in
      // registers and rounded to bf16, then the product with the W k-tile,
      // in two halves of 32 columns, each its own wgmma group: the group
      // before runs while a half is normalised, and its fragments (fr[h])
      // are not touched until it has retired.  Once the previous step's
      // second half has retired, its stage is released.
      uint32_t fr[2][2][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        const uint8_t* st = base + s * STAGE;
        const uint64_t db = hop::sw128_desc(st + A_BYTES);
        hop::mbar_wait(&full[s], (it / STAGES) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int kk = 2 * h + q;
            const int row = wr + (lane & 15), col = 16 * kk + (lane >> 4) * 8;
            uint32_t raw4[4];
            ldsm_x4(raw4, st + swz(row, col >> 3));
            // columns kt·64 + 16kk + 2t (+1) in raw4[0..1], + 8 in raw4[2..3];
            // rows g in raw4[0, 2], g + 8 in raw4[1, 3]
            const float4 p0 = wb[(kt * BK + 16 * kk + 2 * t) / 2];
            const float4 p1 = wb[(kt * BK + 16 * kk + 2 * t + 8) / 2];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 p = e < 2 ? p0 : p1;
              const float mu = e & 1 ? mu1 : mu0, rs = e & 1 ? rs1 : rs0;
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&raw4[e]);
              fr[h][q][e] = pack_bf16((__low2float(v) - mu) * rs * p.x + p.z,
                                      (__high2float(v) - mu) * rs * p.y + p.w);
            }
          }
          hop::wgmma_fence();
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (kt == 0 && h == 0 && q == 0)  // the tile's first product overwrites acc
              hop::wgmma_m64n256_rs_first(acc, fr[h][q], db);
            else
              hop::wgmma_m64n256_rs(acc, fr[h][q], hop::desc_add(db, (2 * h + q) * 32));
          }
          hop::wgmma_commit();
          hop::wgmma_wait<1>();
          if (h == 0 && kt > 0) release((it - 1) % STAGES);
        }
      }
      hop::wgmma_wait<0>();
      release((it - 1) % STAGES);
      hop::fence_regs(acc);

      // epilogue: y = bf16(acc + b).  Per pair of 8-column blocks the four
      // threads of a quad trade their column pairs (a 4 x 4 transpose of
      // bf16x2 words) so that each stores one row's 8 columns in one
      // 16-byte store.
      const int row = row0 + wr + g;
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t u[4];  // u[2jj + hh]: block 2p + jj, row + 8hh, columns 2t, 2t + 1
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * p + jj;
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(a.bias + cb * BN + 8 * j + 2 * t));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            u[2 * jj + hh] = pack_bf16(acc[4 * j + 2 * hh] + bb.x, acc[4 * j + 2 * hh + 1] + bb.y);
        }
        uint32_t c[4];  // chunk t of the four: its word w from quad lane w
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = (t - i) & 3, src = (t + i) & 3;
          const uint32_t send = k == 0 ? u[0] : k == 1 ? u[1] : k == 2 ? u[2] : u[3];
          const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (src == w) c[w] = got;
        }
        const int rr = row + 8 * (t & 1);
        if (rr < a.M)
          *reinterpret_cast<uint4*>(a.y + (size_t)rr * a.O + cb * BN + 8 * (2 * p + (t >> 1))) =
              make_uint4(c[0], c[1], c[2], c[3]);
      }
    }
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
               static_cast<bf16*>(y), M, O, ncb, tiles, eps};
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
