// K1's device code: y = LN(x)·Wᵀ + b over 64·NC x 256 output tiles, run by
// its own kernel (ln_linear.cu, which holds the design notes), by K7's
// phase A (block_eval.cu) and by K8's first role (ln_qkv_attention.cu), so
// that the three compute every element with the same instructions.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vlm {
namespace k1 {


// A CTA's tile is BM x TN (K1: BN; K7: 192, so that its consumers' 96
// accumulators a thread leave room for the rest of K7); a k-tile is one
// swizzle row.
constexpr int BN = 256, BK = 64;
constexpr int CL = 2;                       // CTAs of a cluster, sharing every W tile
constexpr int STAGES = 4;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// NC consumer warpgroups of 64 rows each and a producer warpgroup, whose
// first thread issues the loads: K1 two, its producer giving up registers
// for the consumers' accumulators; K7 one (its 256 threads hold 255
// registers each).
template <int NC, int TN = BN>
struct Roles {
  static constexpr int BM = 64 * NC, CONSUMERS = 128 * NC, THREADS = CONSUMERS + 128;
  static constexpr int CONSUMER_WARPS = CONSUMERS / 32;
  static constexpr int A_BYTES = BM * BK * 2, W_BYTES = TN * BK * 2, STAGE = A_BYTES + W_BYTES;
};
// K1's own kernel
constexpr int BM = Roles<2>::BM, CONSUMERS = Roles<2>::CONSUMERS, THREADS = Roles<2>::THREADS;

template <int C, int NC = 2, int TN = BN>
struct Layout {
  using R = Roles<NC, TN>;
  static constexpr int LNW = STAGES * R::STAGE;  // ln_w, ln_b (f32) by column pairs
  static constexpr int STAT = LNW + 2 * C * 4;   // mean, rstd of the CTA's BM rows
  static constexpr int BAR = STAT + 2 * R::BM * 4;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = 1024 + BAR + 2 * STAGES * 8;
  static_assert(BYTES <= 232448, "over the H100's shared memory per block");
};

struct Args {
  const bf16* x;
  const float *ln_w, *ln_b, *bias;
  bf16* y;
  int M, O, ncb, tiles;  // ncb: column tiles; tiles: cluster tiles (row pairs x ncb)
  float eps;
  int x_row0;  // the row of x (in xmap) that is row 0 of a.x
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

// Shared memory of a CTA of K1 (1024-aligned inside the dynamic block).
template <int C, int NC = 2, int TN = BN>
struct Smem {
  uint8_t* base;
  float4* wb;  // LN weights by column pairs: {w[c], w[c + 1], b[c], b[c + 1]} at wb[c / 2]
  float *mean, *rstd;
  uint64_t *full, *empty;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    using L = Layout<C, NC, TN>;
    base = raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
    wb = reinterpret_cast<float4*>(base + L::LNW);
    mean = reinterpret_cast<float*>(base + L::STAT);
    rstd = mean + Roles<NC, TN>::BM;
    full = reinterpret_cast<uint64_t*>(base + L::BAR);
    empty = full + STAGES;
  }
};

// Run by every thread of the CTA (Roles<NC, TN>::THREADS) before its roles: the ring's
// barriers and the LN weights, then a cluster barrier (both CTAs' barriers
// exist before any multicast or remote arrive).
template <int C, int NC = 2, int TN = BN>
__device__ __forceinline__ void setup(const Args& a, unsigned char* raw) {
  using R = Roles<NC, TN>;
  const Smem<C, NC, TN> sm(raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], CL * R::CONSUMER_WARPS);
    }
    hop::fence_mbar_init();
  }
  for (int i = threadIdx.x; i < C / 2; i += R::THREADS)
    sm.wb[i] = make_float4(a.ln_w[2 * i], a.ln_w[2 * i + 1], a.ln_b[2 * i], a.ln_b[2 * i + 1]);
  hop::cluster_sync();
}

// The LN statistics of the 16 rows r0.. of x into mean[0..15] and
// rstd[0..15] (shared memory), computed by the calling warp four rows at a
// time (common.cuh ln_rows_stats).
template <int C>
__device__ __forceinline__ void warp_row_stats(const Args& a, int r0, float* mean, float* rstd) {
  constexpr int NV = C / 256;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int i = 0; i < 16; i += 4) {
    float mu[4], rs[4];
    ln_rows_stats<4, NV>(a.x + (size_t)(r0 + i) * C, C, a.M - (r0 + i), a.eps, mu, rs);
    if (lane < 4) {
      mean[i + lane] = lane == 0 ? mu[0] : lane == 1 ? mu[1] : lane == 2 ? mu[2] : mu[3];
      rstd[i + lane] = lane == 0 ? rs[0] : lane == 1 ? rs[1] : lane == 2 ? rs[2] : rs[3];
    }
  }
}

// The order of a pair's tiles (its CTAs are ranks peer0 and peer0 + 1 of
// their cluster): count of them, the k-th one's index (row pair t / ncb,
// column tile t % ncb), what the producer waits for before a tile's loads,
// where a warp's LN statistics come from, and two hooks around each tile's
// stores.
//
// Range, K1's own and K7's: the tiles [t_begin, t_end) of pair `pair` of
// npairs, in row-major tile order, so that consecutive tiles share their
// rows (LN statistics computed once per run of a row block).
struct Range {
  uint32_t peer0;
  int rank, t_begin, count;
  __device__ __forceinline__ Range(const Args& a, int pair, int npairs, uint32_t peer0_)
      : peer0(peer0_), rank((int)(hop::cluster_rank() - peer0_)),
        t_begin((int)((long long)pair * a.tiles / npairs)),
        count((int)((long long)(pair + 1) * a.tiles / npairs) - t_begin) {}
  __device__ __forceinline__ int tile(int k) const { return t_begin + k; }
  __device__ __forceinline__ void rows_ready(int) const {}
  template <int C>
  __device__ __forceinline__ void row_stats(const Args& a, int r0, float* mean, float* rstd,
                                            uint64_t*, int) const {
    warp_row_stats<C>(a, r0, mean, rstd);
  }
  __device__ __forceinline__ void hold() const {}
  __device__ __forceinline__ void publish(int, int) const {}
};

// Strided, K8's: the row pairs in order, each cut into units of `unit`
// consecutive column tiles (unit = ncb: whole row pairs), and the units
// dealt to the pairs in turn (pair p takes units p, p + npairs, ...), so
// that the batch elements' rows are finished from the first element on and
// not at the end of some pair's share.  The LN statistics of every row
// were computed once, by K8's attention role at the start of the launch
// (stats: the M means, then the M rstds; warp_row_stats's arithmetic):
// before a tile's loads the producer waits until stat_done[the CTA's
// 128-row block] counts the block's groups of four rows (acquire at GPU
// scope), and a warp reads its 16 rows' once the tile's first stage has
// landed (the barrier orders them after that wait; a spin in the consumers
// cost them registers at C = 1024).
// After a tile's stores every warp publishes them: one release increment
// of done[e] (GPU scope) for each batch element e of `rows` rows that its
// 16 rows touch, which K8's attention role waits for.  delay_ns (a
// test's): every tile's stores held back that long, so that a wait that
// does not hold shows.
struct Strided {
  uint32_t peer0;
  int rank, pair, npairs, unit, upr, ncb, count;
  int *done, *stat_done;
  const float* stats;
  int rows, M, delay_ns;
  __device__ __forceinline__ Strided(const Args& a, int pair_, int npairs_, int unit_, int* done_,
                                     int* stat_done_, const float* stats_, int rows_, int delay)
      : peer0(0), rank((int)hop::cluster_rank()), pair(pair_), npairs(npairs_), unit(unit_),
        upr(a.ncb / unit_), ncb(a.ncb), count(0), done(done_), stat_done(stat_done_),
        stats(stats_), rows(rows_), M(a.M), delay_ns(delay) {
    const int units = a.tiles / a.ncb * upr;
    count = units > pair ? ((units - 1 - pair) / npairs + 1) * unit : 0;
  }
  __device__ __forceinline__ int tile(int k) const {
    const int j = k / unit, u = pair + j * npairs;
    return u / upr * ncb + u % upr * unit + (k - j * unit);
  }
  // rb: the CTA's row block (128 rows)
  __device__ __forceinline__ void rows_ready(int rb) const {
    if (rb * 128 < M) hop::wait_at_least(stat_done + rb, (min(128, M - rb * 128) + 3) / 4);
  }
  // full, it: the ring's barriers and the tile's first stage; rows past M
  // keep stale statistics: they are not stored
  template <int C>
  __device__ __forceinline__ void row_stats(const Args&, int r0, float* mean, float* rstd,
                                            uint64_t* full, int it) const {
    hop::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    const int lane = threadIdx.x & 31;
    if (lane < 16 && r0 + lane < M) {
      mean[lane] = __ldcg(stats + r0 + lane);
      rstd[lane] = __ldcg(stats + M + r0 + lane);
    }
  }
  __device__ __forceinline__ void hold() const {
    if (delay_ns <= 0) return;
    const unsigned long long t0 = hop::global_ns();
    while (hop::global_ns() - t0 < (unsigned long long)delay_ns) {
    }
  }
  // r0: the warp's first row of x
  __device__ __forceinline__ void publish(int r0, int lane) const {
    __syncwarp();  // every lane's stores come before lane 0's release
    if (lane == 0 && r0 < M)
      for (int e = r0 / rows; e <= min(r0 + 15, M - 1) / rows; ++e) hop::red_release_gpu(done + e, 1);
  }
};

// The producer role, the last warpgroup (its first thread fills the ring).
template <int C, int NC = 2, int TN = BN, class Order = Range>
__device__ __forceinline__ void produce(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                        const Args& a, unsigned char* raw, const Order& rg) {
  using R = Roles<NC, TN>;
  constexpr int KT = C / BK;
  const Smem<C, NC, TN> sm(raw);
  uint8_t* base = sm.base;
  uint64_t *full = sm.full, *empty = sm.empty;
  const uint32_t peer0 = rg.peer0;
  const int rank = rg.rank;
  if (threadIdx.x == R::CONSUMERS) {
    int it = 0;
    for (int k = 0; k < rg.count; ++k) {
      const int t = rg.tile(k);
      const int rb = (t / a.ncb) * CL + rank, cb = t % a.ncb;
      rg.rows_ready(rb);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        // the stage's previous use released by every consumer warp of the cluster
        if (it >= STAGES) hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* st = base + s * R::STAGE;
        // a CTA past the last row (the second of the last pair) loads no
        // x: its rows are computed from stale values and not stored
        const bool rows = rb * R::BM < a.M;
        hop::mbar_arrive_expect_tx(&full[s], rows ? R::STAGE : R::W_BYTES);
        if (rows) hop::tma_load_2d(st, &xmap, kt * BK, a.x_row0 + rb * R::BM, &full[s]);
        hop::tma_load_2d_multicast(st + R::A_BYTES + rank * (R::W_BYTES / CL), &wmap, kt * BK,
                                   cb * TN + rank * (TN / CL), &full[s],
                                   (uint16_t)(((1u << CL) - 1) << peer0));
      }
    }
  }
}

// The consumer role, warpgroups 0 .. NC - 1: warpgroup wg owns rows 64wg..
// of the CTA's tile, warp w of it rows 16w.. (wr), this thread rows wr + g
// and wr + g + 8.
template <int C, int NC = 2, int TN = BN, class Order = Range>
__device__ __forceinline__ void consume(const Args& a, unsigned char* raw, const Order& rg) {
  using R = Roles<NC, TN>;
  constexpr int KT = C / BK;
  const Smem<C, NC, TN> sm(raw);
  uint8_t* base = sm.base;
  const float4* wb = sm.wb;
  float *mean = sm.mean, *rstd = sm.rstd;
  uint64_t *full = sm.full, *empty = sm.empty;
  const uint32_t peer0 = rg.peer0;
  const int rank = rg.rank;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;
  auto release = [&](int s) {  // every lane of the warp is past its wgmma wait
    if (lane == 0)
      for (int r = 0; r < CL; ++r) hop::mbar_arrive_remote(&empty[s], peer0 + r);
  };
  float acc[TN / 2];
  float mu0 = 0.f, rs0 = 0.f, mu1 = 0.f, rs1 = 0.f;  // LN statistics of the two rows
  int it = 0, cur_rb = -1;

  for (int k = 0; k < rg.count; ++k) {
    const int tile = rg.tile(k);
    const int rb = (tile / a.ncb) * CL + rank, cb = tile % a.ncb;
    const int row0 = rb * R::BM;
    if (rb != cur_rb) {  // the LN statistics of the warp's 16 rows
      __syncwarp();      // every lane has read the previous ones
      rg.template row_stats<C>(a, row0 + wr, mean + wr, rstd + wr, full, it);
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
      const uint8_t* st = base + s * R::STAGE;
      const uint64_t db = hop::sw128_desc(st + R::A_BYTES);
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
            hop::wgmma_rs_first<TN>(acc, fr[h][q], db);
          else
            hop::wgmma_rs<TN>(acc, fr[h][q], hop::desc_add(db, (2 * h + q) * 32));
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
    rg.hold();
#pragma unroll
    for (int p = 0; p < TN / 16; ++p) {
      uint32_t u[4];  // u[2jj + hh]: block 2p + jj, row + 8hh, columns 2t, 2t + 1
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * p + jj;
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(a.bias + cb * TN + 8 * j + 2 * t));
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
        *reinterpret_cast<uint4*>(a.y + (size_t)rr * a.O + cb * TN + 8 * (2 * p + (t >> 1))) =
            make_uint4(c[0], c[1], c[2], c[3]);
    }
    rg.publish(row0 + wr, lane);
  }
}

// Invalidate the ring's barriers (by one thread, once the roles are past
// the cluster barrier that ends them), so that a persistent kernel (K7)
// may use the shared memory for something else next.
template <int C, int NC = 2, int TN = BN>
__device__ __forceinline__ void invalidate(unsigned char* raw) {
  const Smem<C, NC, TN> sm(raw);
  for (int s = 0; s < 2 * STAGES; ++s) hop::mbar_inval(&sm.full[s]);
}

}  // namespace k1
}  // namespace vlm
