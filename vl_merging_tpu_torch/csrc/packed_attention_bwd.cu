// K9: the backward of K2's attention over packed qkv.  From qkv (B, N, 3C),
// the f32 bias (H, N, N), the key mask (B, N), the context's gradient g
// (B, N, C) and the softmax statistics K2's training launch stored (each
// query row's max m and sum l), it computes dqkv (B, N, 3C) and
// dbias (H, N, N) f32 summed over the batch, without any (N, N) tensor of
// p, dp or ds in device memory.
//
// Replaces vl_merging_tpu/ops/attention.py:_packed_bwd_kernel (via
// _pallas_packed_attention_bwd / _packed_bwd).  Same rounding points: q is
// pre-scaled in bf16; s = q·kᵀ in f32 + bias, masked keys at -inf (as in K2
// the bias is the initial value of the f32 accumulator); p = exp(s - m)/l
// in f32, 0 on a row with no valid key (l = 0); dv = bf16(p)ᵀ·g;
// dp = g·vᵀ; ds = p ⊙ (dp − D) in f32 with D = Σ_k dp ⊙ p, the row sum in
// f32 as the reference takes it; dq = bf16(ds)·k · scale and dk = bf16(ds)ᵀ·q (q
// pre-scaled), both accumulated in f32; dq, dk, dv are stored in bf16 and
// dbias = Σ_b ds stays f32.
//
// The TPU kernel holds whole (N, N) tiles of a batch block in VMEM and sums
// dbias over a sequential grid.  Here three launches share the work:
//   1. dq_kernel, one block per (batch, 64-query tile, head), one
//      warpgroup (4 warps of 16 query rows): two passes over 64-key tiles
//      that recompute s and dp and form p from the stored m and l, the
//      first summing D = Σ_k dp ⊙ p of its rows, the second forming ds and
//      accumulating dq; it stores D for the second launch.  (D taken from
//      a context, Σ_c g ⊙ o, saves the first pass but moves ds by the
//      context's rounding of P, which K2 and a plain forward take at other
//      points: against a twin fed the plain forward's context, 1.10 of
//      K9's 4-ulp bound from the bf16 context, 1.13 from an f32 one that
//      K2's training launch would store; chip_profile.py --c8.)
//   2. dkv_kernel, one block per (64-key tile, head, batch group), one
//      warpgroup of 16 keys per warp: for each batch of its group it walks
//      the query tiles, recomputes sᵀ and dpᵀ with the key rows as the A
//      operand, forms p and ds from the row statistics, accumulates dk and
//      dv in registers and adds ds into its own (N, 64) column slab of the
//      group's dbias partial, one 64 x 64 tile at a time: the tile comes in
//      by cp.async with the query tiles and goes back in one coalesced
//      store.  The block owns that slab for its group, so the batch sum
//      needs no atomics and repeats bit for bit.
//   3. reduce_kernel sums the G group partials (G ≤ 4) into dbias, in a
//      fixed order (the partials' rows are padded to a multiple of 4 floats,
//      so a partial tile moves 16 bytes a copy).
// Rows past N are neither read nor stored; keys past N are masked.
//
// Bound on the H100: by its arithmetic, 10·B·H·N²·d flops for the five
// products (82 GFLOP at B = 32, N = 577, 12 heads) against ~100 MB of qkv,
// g, dqkv, bias and dbias.  As built it recomputes s and dp twice more
// (18·B·H·N²·d over whole 64-wide tiles: dq_kernel's D pass, then its dq
// pass).  The q·kᵀ-type products
// (s = q·kᵀ, dp = g·vᵀ and their transposes in dkv_kernel) are wgmma
// m64n64k16 with A from registers (the mma.sync A fragments of each warp's
// 16 rows) and B a 64 x 64 tile in 128B-swizzled shared memory
// (hopper.cuh); the products against a tile along its rows (ds·k, pᵀ·g,
// dsᵀ·q) stay mma.sync m16n8k16 with ldmatrix.trans fragments, read from
// the same swizzled tiles.  K/V and Q/g tiles are double-buffered through
// cp.async; the per-element bias loads are issued before the products so
// that they hide behind them (read as aligned pairs from a copy of the bias
// whose rows the wrapper pads to whole 64-key tiles).
#include "common.cuh"
#include "hopper.cuh"

using namespace vlm;

namespace {

constexpr int D = 64, TQ = 64, TK = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int TILE = TQ * D;   // one 64 x 64 bf16 tile, 128B-swizzled (8 KB)
constexpr int kMaxGroups = 4;  // dbias partials (batch groups)

// Offset (in bf16) of element (r, c) of a swizzled 64 x 64 tile; c % 8 is
// kept, so 2 or 8 consecutive values from an even / 8-aligned c stay
// contiguous.
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// Copy rows [r0, r0 + 64) of a (rows, ld) bf16 operand (columns [0, 64) of
// base) into a swizzled tile with cp.async; rows at or past n are
// zero-filled.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base, size_t ld, int r0,
                                           int n) {
  for (int v = threadIdx.x; v < TQ * D / 8; v += THREADS) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    if (r0 + r < n)
      cp_async16(dst + sw(r, c), base + (size_t)(r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(dst + sw(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The warp's 16 rows of a swizzled tile as A fragments of m16n8k16 (and of
// wgmma's register-A form), for all of d.
__device__ __forceinline__ void a_frags(uint32_t (&a)[D / 16][4], const bf16* tile, int row0,
                                        int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld32(tile + sw(row0 + g, kk * 16 + 2 * t));
    a[kk][1] = ld32(tile + sw(row0 + g + 8, kk * 16 + 2 * t));
    a[kk][2] = ld32(tile + sw(row0 + g, kk * 16 + 2 * t + 8));
    a[kk][3] = ld32(tile + sw(row0 + g + 8, kk * 16 + 2 * t + 8));
  }
}

// acc += A · Bᵀ for the warpgroup's 64 rows (A: each warp's fragments a of
// its 16 rows) against a swizzled 64 x 64 tile B (rows are the n index, d
// is contracted): the products q·kᵀ, g·vᵀ, k·qᵀ and v·gᵀ as four wgmma
// m64n64k16.  acc is the m16n8 accumulator layout of the warp's rows,
// which is wgmma's.  Returns with the products complete.
__device__ __forceinline__ void rows_dot(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile) {
  float(&d)[32] = reinterpret_cast<float(&)[32]>(acc);
  hop::fence_regs(d);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::wgmma_m64n64_rs(d, a[kk], hop::sw128_desc(tile + kk * 16));
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(d);
}

// out[n] += bf16(w) · tile, w being a 16 x 64 accumulator block (rows of the
// warp, the 64 tile rows as columns) and tile a swizzled 64 x 64 tile: the
// products p·v, ds·k, pᵀ·g and dsᵀ·q.
__device__ __forceinline__ void acc_times_tile(float (&out)[D / 8][4], const float (&w)[8][4],
                                               const bf16* tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t pa[4] = {pack_bf16(w[2 * kc][0], w[2 * kc][1]),
                            pack_bf16(w[2 * kc][2], w[2 * kc][3]),
                            pack_bf16(w[2 * kc + 1][0], w[2 * kc + 1][1]),
                            pack_bf16(w[2 * kc + 1][2], w[2 * kc + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, tile + sw(kc * 16 + (lane & 15), np * 16 + (lane >> 4) * 8));
      mma16816(out[2 * np], pa, vb[0], vb[1]);
      mma16816(out[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
}

// Scale the tile's bf16 values by bf16(scale) in place, rounding each
// product to bf16 (the reference's q * scale in q's dtype).
__device__ __forceinline__ void scale_tile(bf16* tile, float qscale) {
  for (int v = threadIdx.x; v < TQ * D / 8; v += THREADS) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(tile + v * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) p.h()[e] = __float2bfloat16(p.f(e) * qscale);
    *reinterpret_cast<uint4*>(tile + v * 8) = p.u;
  }
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void zero8x4(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// 1. D and dq
// ---------------------------------------------------------------------------
// stats: (3, B, H, N) f32: m and l (from K2), and D (written here).
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
          const int* __restrict__ mask, const bf16* __restrict__ gout,
          bf16* __restrict__ dqkv, float* __restrict__ stats, int B,
          int N, int H, int ldb, float scale) {
  __shared__ __align__(1024) bf16 St[TILE];  // the Q tile, then the g tile
  __shared__ __align__(1024) bf16 Ks[2][TILE];
  __shared__ __align__(1024) bf16 Vs[2][TILE];
  __shared__ int kvalid[2][TK];

  const int b = blockIdx.x, q0 = blockIdx.y * TQ, h = blockIdx.z;
  const int C = H * D;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld + h * D;
  const int* mask_b = mask + (size_t)b * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (N + TK - 1) / TK;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * TK;
    stage_rows(Ks[st], base + C, ld, k0, N);
    stage_rows(Vs[st], base + 2 * C, ld, k0, N);
    if (tid < TK) kvalid[st][tid] = (k0 + tid < N) && mask_b[k0 + tid] > 0;
  };
  load_kv(0, 0);
  cp_async_commit();

  // the warp's 16 query rows (scaled) and g rows as A fragments
  uint32_t qa[D / 16][4], ga[D / 16][4];
  stage_rows(St, base, ld, q0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  scale_tile(St, __bfloat162float(__float2bfloat16(scale)));
  __syncthreads();
  a_frags(qa, St, warp * 16, g, t);
  __syncthreads();
  stage_rows(St, gout + (size_t)b * N * C + h * D, C, q0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  a_frags(ga, St, warp * 16, g, t);

  const int qrow0 = q0 + warp * 16 + g, qrow1 = qrow0 + 8;
  const size_t srow = ((size_t)b * H + h) * N, plane = (size_t)B * H * N;
  // m, 1/l (0 on a row with no valid key: p = 0) and D of the two rows
  float m0 = 0.f, m1 = 0.f, inv0 = 0.f, inv1 = 0.f;
  if (qrow0 < N && stats[plane + srow + qrow0] > 0.f) {
    m0 = stats[srow + qrow0];
    inv0 = 1.f / stats[plane + srow + qrow0];
  }
  if (qrow1 < N && stats[plane + srow + qrow1] > 0.f) {
    m1 = stats[srow + qrow1];
    inv1 = 1.f / stats[plane + srow + qrow1];
  }
  const float* brow0 = bias + ((size_t)h * N + min(qrow0, N - 1)) * ldb;  // rows past N
  const float* brow1 = bias + ((size_t)h * N + min(qrow1, N - 1)) * ldb;  // are not stored
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float d0 = 0.f, d1 = 0.f;  // D of the two rows: the thread's share, then the row's

  // iterations [0, ntiles): the D pass; [ntiles, 2 ntiles): the dq pass,
  // over the same key tiles in the same order
  for (int it = 0; it < 2 * ntiles; ++it) {
    const int k0 = (it % ntiles) * TK, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it is visible; every warp is done with tile it - 1
    if (it + 1 < 2 * ntiles) load_kv((it + 1) % ntiles, st ^ 1);
    cp_async_commit();
    const bf16* Kt = Ks[st];
    const int* kv = kvalid[st];
    hop::fence_proxy_async();  // the landed tiles, before wgmma reads them
    __syncthreads();

    // s starts as the bias (-inf for an invalid key), then += q·kᵀ, as in
    // K2; dp = g·vᵀ
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(brow0 + k0 + c));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(brow1 + k0 + c));
      s[j][0] = kv[c] ? b0.x : -INFINITY;
      s[j][1] = kv[c + 1] ? b0.y : -INFINITY;
      s[j][2] = kv[c] ? b1.x : -INFINITY;
      s[j][3] = kv[c + 1] ? b1.y : -INFINITY;
    }
    zero8x4(dp);
    rows_dot(dp, ga, Vs[st]);
    rows_dot(s, qa, Kt);

    if (it < ntiles) {  // D += Σ_k dp ⊙ p in f32
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = inv0 > 0.f ? expf(s[j][e] - m0) * inv0 : 0.f;
          const float p1 = inv1 > 0.f ? expf(s[j][2 + e] - m1) * inv1 : 0.f;
          d0 += dp[j][e] * p0;
          d1 += dp[j][2 + e] * p1;
        }
      }
      if (it == ntiles - 1) {  // the rows' D, for this pass and dkv_kernel
        d0 = group_sum(d0);
        d1 = group_sum(d1);
        if (t == 0) {
          if (qrow0 < N) stats[2 * plane + srow + qrow0] = d0;
          if (qrow1 < N) stats[2 * plane + srow + qrow1] = d1;
        }
      }
      continue;
    }

    // p, ds = p (dp - D), dq += bf16(ds) · k
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = inv0 > 0.f ? expf(s[j][e] - m0) * inv0 : 0.f;
        const float p1 = inv1 > 0.f ? expf(s[j][2 + e] - m1) * inv1 : 0.f;
        s[j][e] = p0 * (dp[j][e] - d0);
        s[j][2 + e] = p1 * (dp[j][2 + e] - d1);
      }
    }
    acc_times_tile(dq, s, Kt, lane);
  }

  bf16* out_b = dqkv + (size_t)b * N * ld + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qrow0 < N)
      store_bf16x2(out_b + (size_t)qrow0 * ld + n * 8, dq[n][0] * scale, dq[n][1] * scale);
    if (qrow1 < N)
      store_bf16x2(out_b + (size_t)qrow1 * ld + n * 8, dq[n][2] * scale, dq[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv and the group's dbias partial
// ---------------------------------------------------------------------------
constexpr int LDP = TK + 4;  // f32 stride of a dbias tile: conflict-free fragment access

struct DkvSmem {
  bf16 kv[2][TILE];         // the block's K and V rows for one batch (swizzled)
  bf16 qg[2][2][TILE];      // [stage][q | g] query tiles, double-buffered (swizzled)
  float part[2][TQ * LDP];  // [stage] the group's dbias partial for the tile
  float qst[2][3][TQ];      // [stage][m | 1/l | D] of the query rows (1/l = 0: p = 0)
  int kvalid[TK];
};
constexpr int kDkvSmem = (int)sizeof(DkvSmem) + 1024;  // + alignment slack

// Start copying the (TQ x TK) dbias partial tile at rows q0.., columns k0..
// of a row-major (N, ldp) f32 matrix (ldp: N rounded up to 4, so every row
// starts 16-byte aligned) into shared memory, 4 floats a copy (rows inside
// N; a vector may reach into the row's padding, which no one reads).
__device__ __forceinline__ void stage_part(float* dst, const float* src, int q0, int k0,
                                           int N, int ldp) {
  for (int v = threadIdx.x; v < TQ * TK / 4; v += THREADS) {
    const int r = v / (TK / 4), c = (v % (TK / 4)) * 4;
    if (q0 + r < N && k0 + c < N) cp_async16(dst + r * LDP + c, src + (size_t)(q0 + r) * ldp + k0 + c);
  }
}

__global__ void __launch_bounds__(THREADS)
dkv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
           const int* __restrict__ mask, const bf16* __restrict__ gout,
           const float* __restrict__ stats, bf16* __restrict__ dqkv,
           float* __restrict__ dbias_part, int B, int N, int H, int ldb, int ldp,
           int per_group, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(
      smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u));

  const int k0 = blockIdx.x * TK, h = blockIdx.y, grp = blockIdx.z;
  const int b_begin = grp * per_group, b_end = min(B, b_begin + per_group);
  const int C = H * D;
  const size_t ld = 3 * (size_t)C, plane = (size_t)B * H * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (N + TQ - 1) / TQ;
  const int niter = (b_end - b_begin) * nq;
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  float* part = dbias_part + ((size_t)grp * H + h) * N * ldp;
  // With one query tile, iteration i + 1 reads the partial tile that
  // iteration i stores: it is loaded only after that store (below).
  const bool prefetch_part = nq > 1;

  // this thread's two keys: rows g and g + 8 of the warp's 16 (kl: in the tile)
  const int kl0 = warp * 16 + g, kl1 = kl0 + 8;
  const int key0 = k0 + kl0, key1 = k0 + kl1;

  // start loading iteration i's tiles (and, at a batch start, the K/V rows)
  auto load = [&](int i, int st) {
    const int b = b_begin + i / nq, q0 = (i % nq) * TQ;
    const bf16* base = qkv + (size_t)b * N * ld + h * D;
    if (i % nq == 0) {
      stage_rows(sm.kv[0], base + C, ld, k0, N);
      stage_rows(sm.kv[1], base + 2 * C, ld, k0, N);
      if (tid < TK) sm.kvalid[tid] = (k0 + tid < N) && mask[(size_t)b * N + k0 + tid] > 0;
    }
    stage_rows(sm.qg[st][0], base, ld, q0, N);
    stage_rows(sm.qg[st][1], gout + (size_t)b * N * C + h * D, C, q0, N);
    if (prefetch_part && b != b_begin) stage_part(sm.part[st], part, q0, k0, N, ldp);
    for (int r = tid; r < TQ; r += THREADS) {
      const size_t at = ((size_t)b * H + h) * N + q0 + r;
      const float l = q0 + r < N ? stats[plane + at] : 0.f;
      sm.qst[st][0][r] = l > 0.f ? stats[at] : 0.f;
      sm.qst[st][1][r] = l > 0.f ? 1.f / l : 0.f;
      sm.qst[st][2][r] = l > 0.f ? stats[2 * plane + at] : 0.f;
    }
  };

  uint32_t ka[D / 16][4], va[D / 16][4];
  bool kv0 = false, kv1 = false;
  float dk[D / 8][4], dv[D / 8][4];

  load(0, 0);
  cp_async_commit();
  for (int i = 0; i < niter; ++i) {
    const int st = i & 1, b = b_begin + i / nq, q0 = (i % nq) * TQ;
    const bool first_q = i % nq == 0, first_b = b == b_begin;
    if (!prefetch_part && !first_b) {
      __syncthreads();  // iteration i - 1 stored this very tile
      stage_part(sm.part[st], part, q0, k0, N, ldp);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // iteration i's tiles are visible; i - 1 is consumed
    if (first_q) {    // a new batch: its K/V rows into registers
      a_frags(ka, sm.kv[0], warp * 16, g, t);
      a_frags(va, sm.kv[1], warp * 16, g, t);
      kv0 = sm.kvalid[kl0];
      kv1 = sm.kvalid[kl1];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    }
    scale_tile(sm.qg[st][0], qscale);
    hop::fence_proxy_async();  // the scaled q and the landed g, before wgmma reads them
    __syncthreads();           // q scaled; the K/V staging is free again
    if (i + 1 < niter) load(i + 1, st ^ 1);
    cp_async_commit();
    const bf16* Qt = sm.qg[st][0];
    const bf16* Gt = sm.qg[st][1];
    const float* qm = sm.qst[st][0];
    const float* qinv = sm.qst[st][1];
    const float* qd = sm.qst[st][2];
    float* ps = sm.part[st];
    const float* bq = bias + ((size_t)h * N + q0) * ldb;  // row q0 of head h

    // sᵀ = bias + k·qᵀ and dpᵀ = v·gᵀ: rows are this warp's keys, columns
    // queries (bias past N is never read); the bias loads are in flight
    // during the dp product
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t row = (size_t)min(q0 + j * 8 + 2 * t + e, N - 1) - q0;
        s[j][e] = __ldg(bq + row * ldb + key0);
        s[j][2 + e] = __ldg(bq + row * ldb + key1);
      }
    }
    zero8x4(dp);
    rows_dot(dp, va, Gt);
    rows_dot(s, ka, Qt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        const float inv = qinv[qc], m = qm[qc], d = qd[qc];
        // inv > 0: a query row inside N with a valid key
        const float p0 = kv0 && inv > 0.f ? expf(s[j][e] - m) * inv : 0.f;
        const float p1 = kv1 && inv > 0.f ? expf(s[j][2 + e] - m) * inv : 0.f;
        const float ds0 = p0 * (dp[j][e] - d);
        const float ds1 = p1 * (dp[j][2 + e] - d);
        float* prow = ps + qc * LDP;
        prow[kl0] = first_b ? ds0 : prow[kl0] + ds0;
        prow[kl1] = first_b ? ds1 : prow[kl1] + ds1;
        s[j][e] = p0;
        s[j][2 + e] = p1;
        dp[j][e] = ds0;
        dp[j][2 + e] = ds1;
      }
    }
    acc_times_tile(dv, s, Gt, lane);   // dv += bf16(p)ᵀ · g
    acc_times_tile(dk, dp, Qt, lane);  // dk += bf16(ds)ᵀ · q

    if (i % nq == nq - 1) {  // the batch is done: store its dk and dv
      bf16* out_b = dqkv + (size_t)b * N * ld + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (key0 < N) {
          store_bf16x2(out_b + (size_t)key0 * ld + C + n * 8, dk[n][0], dk[n][1]);
          store_bf16x2(out_b + (size_t)key0 * ld + 2 * C + n * 8, dv[n][0], dv[n][1]);
        }
        if (key1 < N) {
          store_bf16x2(out_b + (size_t)key1 * ld + C + n * 8, dk[n][2], dk[n][3]);
          store_bf16x2(out_b + (size_t)key1 * ld + 2 * C + n * 8, dv[n][2], dv[n][3]);
        }
      }
    }

    __syncthreads();  // the tile's partial is complete: store it, 4 floats a store
    for (int v = tid; v < TQ * TK / 4; v += THREADS) {
      const int r = v / (TK / 4), c = (v % (TK / 4)) * 4;
      if (q0 + r < N && k0 + c < N)
        *reinterpret_cast<float4*>(part + (size_t)(q0 + r) * ldp + k0 + c) =
            *reinterpret_cast<const float4*>(ps + r * LDP + c);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dbias = Σ over the group partials, in group order
// ---------------------------------------------------------------------------
// dbias (rows of N) from the partials (rows of ldp), each element the sum
// over groups in group order.
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                              size_t rows, int N, int ldp, int groups) {
  const size_t n = rows * N, plane = rows * ldp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t at = (i / N) * ldp + i % N;
    float acc = part[at];
    for (int k = 1; k < groups; ++k) acc += part[(size_t)k * plane + at];
    dbias[i] = acc;
  }
}

}  // namespace

// Number of dbias partials the launch uses for a batch of B: at most
// kMaxGroups, each group holding ceil(B / groups) samples and none empty.
extern "C" int vlm_packed_attention_bwd_groups(int B) {
  if (B <= 0) return 0;
  const int want = B < kMaxGroups ? B : kMaxGroups;
  const int per = (B + want - 1) / want;
  return (B + per - 1) / per;
}

// bias: (H, N, ldb) f32, the (H, N, N) bias with each row padded to ldb
// columns (ldb even and at least N rounded up to 64: the kernels read
// whole 64-key tiles, bias pairs as float2).
// stats: (3, B, H, N) f32, planes 0 and 1 the m and l of K2's training
// launch; plane 2 receives D.  dbias_part: (groups, H, N, ldp) f32 scratch,
// ldp = N rounded up to 4.
extern "C" int vlm_packed_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                        const void* g, void* dqkv, void* dbias,
                                        void* stats, void* dbias_part, int B, int N, int H,
                                        int ldb, int groups, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || groups != vlm_packed_attention_bwd_groups(B) ||
      ldb % 2 != 0 || ldb < (N + TK - 1) / TK * TK)
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* bi = static_cast<const float*>(bias);
  const int* m = static_cast<const int*>(mask);
  const bf16* go = static_cast<const bf16*>(g);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(dbias_part);

  dq_kernel<<<dim3(B, (N + TQ - 1) / TQ, H), THREADS, 0, s>>>(q, bi, m, go, dq, st, B, N, H,
                                                               ldb, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  const int per_group = (B + groups - 1) / groups;
  const int ldp = (N + 3) / 4 * 4;
  dkv_kernel<<<dim3((N + TK - 1) / TK, H, groups), THREADS, kDkvSmem, s>>>(
      q, bi, m, go, st, dq, part, B, N, H, ldb, ldp, per_group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_kernel<<<264, 256, 0, s>>>(part, static_cast<float*>(dbias), (size_t)H * N, N, ldp,
                                    groups);
  return (int)cudaGetLastError();
}
