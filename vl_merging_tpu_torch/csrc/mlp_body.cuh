// The shared MLP body of the eval block's post-attention half and of the
// transformer MLP, written for Hopper (sm_90a): TMA weight tiles in
// mbarrier rings, wgmma products in two warpgroups, and a cluster of four
// CTAs that share each 64-row block.
//
// Its modes are the kernels that run it:
//   kProjMlp  K3, K6, K7:  x' = bf16(res + γ1 ⊙ (ctx·Wpᵀ + bp))
//                          out = bf16(x' + γ2 ⊙ (bf16(gelu(bf16(LN2(x'))·W1ᵀ
//                                + b1))·W2ᵀ + b2))
//   kProj     K4:          out = x' (the first half alone)
//   kLnMlp    K5:          out = bf16(x + γ2 ⊙ MLP(LN2(x))) (the second half)
//   kMlp      K13:         out = bf16(bf16(gelu(x·W1ᵀ + b1))·W2ᵀ + b2)
// with the rounding points of the kernels it replaced: LN2 statistics in
// f32 and its output rounded to bf16, every product accumulated in f32 from
// k = 0 up in k16 steps, gelu(fc1 + b1) rounded to bf16, fc2 summed in f32
// over the hidden chunks in order, biases, γ and residuals in f32.  Every
// kernel computes each element with the same instructions in the same
// order, so K4 → K5 equals K3, K7 equals K1 → K2 → K3 and K6 at uniform
// gammas equals K3, bit for bit.  The gelu is the caller's: ErffGelu
// (K3, K5, K6, K7) or ErfApproxGelu (K13).  With g_rows = N, row r reads
// γ row r / N of a (B, C) table (K6); g_rows = 0 reads one γ.
//
// Why this shape.  The 32-row WMMA body it replaces streamed all 10.6 MB
// of bf16 weights (C = 768) from L2 for every 32 rows: 6.1 GB per K3
// launch at 32·577 rows.  A wgmma tile has 64 rows, and 64 rows of f32
// output accumulators over the whole width (64·C·4 bytes: 192 KB at
// C = 768, 256 KB at C = 1024) do not fit one SM's 256 KB register file
// beside anything else.  So the four CTAs of a cluster take the same 64
// rows and each owns a quarter of the output columns (CQ = C/4 = 192 or
// 256): each weight tile is fetched once per 64 rows by exactly one CTA,
// half the L2 weight traffic of before (3.0 GB per K3 launch at C = 768).
// The hidden chunk of 128 is split the same way: each CTA computes 32
// hidden columns (fc1 over the full LN2 rows), rounds gelu to bf16 into
// its own 4 KB slice of a hidden buffer and copies the slice to the other
// three CTAs in one bulk copy each, which completes on their buffer's
// mbarrier (hfull); so each CTA's fc2 sees the whole chunk.  A second
// mbarrier per buffer (hempty) says every CTA is done reading it; two
// buffers alternate.  In kProjMlp each CTA stores its quarter of x' into
// the output rows; a cluster barrier (an mbarrier every consumer warp of
// the cluster arrives on) publishes the whole x' rows to every CTA for LN2,
// and the final output of a quarter is stored only after every CTA has
// read x' (they pass the first chunk's barrier after their LN2).
//
// Threads: two warpgroups, 256.  Each fills its own ring of weight tiles
// (its first thread issues the TMA loads, a stage ahead of its products)
// and the warpgroups take roles.  The proj is split between them, half of the
// CTA's CQ columns each (m64n96 or m64n128).  In the MLP, warpgroup 1 owns
// the CTA's CQ output columns: the fc2 products (one m64n192 wgmma per
// k16 step at C = 768, two m64n128 at 1024) and the epilogue.  Warpgroup 0
// owns the CTA's 32 hidden columns of each chunk: fc1 (m64n32), gelu and
// the exchange.  With their own rings they run concurrently: fc1 of chunk
// c + 1 beside fc2 of chunk c.  Registers: the output warpgroup's f32
// accumulators, CQ/2 a thread (96 at C = 768, 128 at C = 1024), plus an
// epilogue group of 32 columns; the hidden warpgroup's 16; up to 255 a
// thread.
//
// Shared memory:
//   A rows      C/64 atoms of 64 rows x 64 bf16, 128B-swizzled (8 KB): the
//               ctx (or x) rows by TMA, then LN2(x')                 96 / 128 KB
//   hidden      2 buffers x 4 slices of 64 rows x 32 bf16, 64B-swizzled  32 KB
//   rings       2 rings x 2 stages of 24 KB (C = 768) or 16 KB (C = 1024):
//               ring 0 the upper half of the proj's Wp rows (CQ/2 x 64
//               columns) and the W2 tiles (NB x 64), ring 1 the lower
//               half of Wp and the W1 tiles (32 x KW1)            96 / 64 KB
//   barriers + 1 KB of alignment slack
// = 230,528 bytes at both widths, under the H100's 232,448 per block.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace vlm {
namespace body {

constexpr int kRows = 64;                  // rows of a cluster's block (every CTA)
constexpr int kCluster = 4;                // CTAs per cluster, one column quarter each
constexpr int kHC = 128;                   // hidden chunk of the cluster
constexpr int kHq = kHC / kCluster;        // hidden columns a CTA computes per chunk
constexpr int kAtom = 64 * 128;            // bytes of 64 rows x 64 bf16
constexpr int kThreads = 256;              // two warpgroups: warps 0-3 and 4-7
constexpr int kWarps = kThreads / 32;
constexpr int kW1Box = kHq * 128;          // bytes of one 32-row x 64-column W1 box
constexpr int kSlice = kRows * kHq * 2;    // bytes of a CTA's slice of a hidden chunk
constexpr int kHBuf = kCluster * kSlice;   // bytes of a hidden buffer (a whole chunk)

enum Mode : int { kProjMlp = 0, kProj = 1, kLnMlp = 2, kMlp = 3 };

template <int C>
struct Cfg {
  static_assert(C % 256 == 0, "C/4 output columns in 64-wide tiles");
  static constexpr int CQ = C / kCluster, KA = C / 64, NV = C / 256;
  // a stage of the output ring: NB of the CTA's CQ weight rows x 64
  // columns; of the hidden ring: the CTA's 32 W1 rows x KW1 columns.  Both
  // STAGE bytes: 24 KB at C = 768 (NB = CQ = 192, KW1 = C/2), 16 KB at
  // C = 1024 (NB = CQ/2 = 128, KW1 = C/4), so that each ring holds two.
  static constexpr int NB = C <= 768 ? CQ : CQ / 2, KW1 = C <= 768 ? C / 2 : C / 4;
  static constexpr int STAGE = NB * 128;
  static_assert(STAGE == kHq * KW1 * 2, "the two rings' stages differ");
  static constexpr int SLOTS = 2;  // per ring
  static constexpr int H_OFF = KA * kAtom;
  static constexpr int RING_OFF = H_OFF + 4 * kAtom;  // the output ring, then the hidden ring
  static constexpr int BAR_OFF = RING_OFF + 2 * SLOTS * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + 128;
  static_assert(SMEM <= 232448, "over the H100's shared memory per block");
};

// Tensor maps (hop::make_tensor_map): a over the A rows (M x C, 64 x 64
// boxes), wp (C x C) in CQ/2 x 64 boxes, w2 (C x Hd) in NB x 64 boxes, w1
// (Hd x C) in 32 x 64 boxes.  A mode reads only the maps it needs.
struct Maps {
  CUtensorMap a, wp, w1, w2;
};

struct Args {
  const bf16* res;  // kProjMlp, kProj: the residual rows of the proj
  const bf16* xin;  // kLnMlp: the LN input rows, also the residual
  const float *bp, *g1, *ln_w, *ln_b, *b1, *b2, *g2;
  bf16* out;        // kProjMlp parks x' in its rows
  int M, Hd, g_rows;
  float eps;
};

// The body's shared memory.  The rings' bases are computed from the ring's
// index, not kept in arrays indexed by it: an array indexed at run time
// lives in local memory.
template <int C>
struct Smem {
  using F = Cfg<C>;
  uint8_t *a, *h;
  uint8_t* ring0;    // ring 0 (warpgroup 1's), then ring 1 (warpgroup 0's)
  uint64_t* full0;   // per ring, SLOTS barriers: a stage has landed
  uint64_t *hfull, *hempty, *afull, *xready;
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    uint8_t* base = raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
    a = base;
    h = base + F::H_OFF;
    ring0 = base + F::RING_OFF;
    full0 = reinterpret_cast<uint64_t*>(base + F::BAR_OFF);
    hfull = full0 + 2 * F::SLOTS;
    hempty = hfull + 2;
    afull = hempty + 2;
    xready = afull + 1;
  }
  __device__ __forceinline__ uint8_t* ring(int r) const { return ring0 + r * F::SLOTS * F::STAGE; }
  __device__ __forceinline__ uint64_t* full(int r) const { return full0 + r * F::SLOTS; }
  static constexpr int kBarriers = 2 * F::SLOTS + 6;
};

// The byte offset, in a hidden buffer, of the 16 bytes of row r (0..63),
// hidden columns [col, col + 8): CTA q's 32 columns are its own contiguous
// 4 KB slice (64 rows of 64 bytes, 64B-swizzled), so that a slice moves to
// another CTA in one bulk copy.
__device__ __forceinline__ int hswz(int r, int col) {
  return (col >> 5) * kSlice + r * 64 + (((((col >> 3) & 3) ^ (r >> 1)) & 3) << 4);
}

// The byte offset of the 16 bytes of row r (0..63), columns [col, col + 8),
// in a block of 128B-swizzled atoms along the columns.
__device__ __forceinline__ int swz(int r, int col) {
  return (col >> 6) * kAtom + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4);
}

// A warpgroup's ring of weight tiles, which it fills and empties itself:
// stage k is loaded by TMA into slot k % SLOTS by the warpgroup's first
// thread, at the start for the first SLOTS stages and then as soon as the
// products reading a slot have retired.  Ring 0 (warpgroup 1) holds the
// upper half of the proj's Wp rows, then the W2 tiles; ring 1 (warpgroup
// 0) the lower half of Wp, then the W1 tiles, each in the order its
// warpgroup takes them.  The warpgroup keeps its newest product group in
// flight.
template <int C, int MODE>
struct Ring {
  using F = Cfg<C>;
  static constexpr bool kHasProj = MODE == kProjMlp || MODE == kProj;
  static constexpr int NH = F::CQ / F::NB, SW1 = C / F::KW1;
  uint8_t* const base;  // the ring's stages and their barriers
  uint64_t* const full;
  const Maps& m;
  const int r, q, nproj, total;
  int n = 0, filled = 0;
  bool pend = false;  // a stage before the newest still holds its slot
  __device__ __forceinline__ Ring(const Smem<C>& sm, const Maps& mp, int ring, int q_, int Hd)
      : base(sm.ring(ring)), full(sm.full(ring)), m(mp), r(ring), q(q_),
        nproj(kHasProj ? F::KA : 0),
        total(nproj + (MODE == kProj ? 0 : Hd / kHC * (ring == 0 ? 2 * NH : SW1))) {
    while (filled < F::SLOTS && filled < total) fill();
  }
  __device__ __forceinline__ bool leader() const { return (threadIdx.x & 127) == 0; }
  // load the next stage, by the warpgroup's first thread
  __device__ __forceinline__ void fill() {
    const int k = filled++;
    if (!leader()) return;
    uint64_t* bar = &full[k % F::SLOTS];
    uint8_t* dst = base + (k % F::SLOTS) * F::STAGE;
    if (k < nproj) {
      hop::mbar_arrive_expect_tx(bar, F::CQ / 2 * 128);
      hop::tma_load_2d(dst, &m.wp, 64 * k, q * F::CQ + (1 - r) * F::CQ / 2, bar);
      return;
    }
    hop::mbar_arrive_expect_tx(bar, F::STAGE);
    const int k1 = k - nproj;
    if (r == 0) {  // W2: hidden columns j0 + 64hs, the CTA's output rows h·NB..
      const int c = k1 / (2 * NH), hs = k1 % (2 * NH) / NH, h = k1 % NH;
      hop::tma_load_2d(dst, &m.w2, c * kHC + 64 * hs, q * F::CQ + h * F::NB, bar);
    } else {  // W1: the CTA's 32 hidden rows of chunk c, depth k0..k0 + KW1
      const int c = k1 / SW1, k0 = k1 % SW1 * F::KW1;
      for (int i = 0; i < F::KW1 / 64; ++i)
        hop::tma_load_2d(dst + i * kW1Box, &m.w1, k0 + 64 * i, c * kHC + kHq * q, bar);
    }
  }
  // the next stage's byte offset in the ring, once its tiles have landed
  __device__ __forceinline__ int acquire() {
    const int st = n % F::SLOTS;
    hop::mbar_wait(&full[st], (n / F::SLOTS) & 1);
    hop::wgmma_fence();
    return st * F::STAGE;
  }
  // the slot of the stage before the newest is free: every warp of the
  // warpgroup has seen its products retire; load the next stage into it
  __device__ __forceinline__ void refill() {
    hop::named_sync(3 + r, 128);
    if (filled < total) fill();
  }
  // after the stage's products are issued
  __device__ __forceinline__ void retire() {
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    if (pend) refill();
    pend = true;
    ++n;
  }
  __device__ __forceinline__ void drain() {
    hop::wgmma_wait<0>();
    if (pend) refill();
    pend = false;
  }
};

// A descriptor `bytes` further into the swizzled memory of descriptor d
// (both 16-byte multiples inside the 256 KB window of shared memory).
__device__ __forceinline__ uint64_t at(uint64_t d, int bytes) {
  return d + (uint64_t)(bytes >> 4);
}

__device__ __forceinline__ const float* gamma_row(const float* g, int row, int g_rows, int C) {
  return g_rows ? g + (size_t)(row / g_rows) * C : g;
}

// The epilogue of 8·J columns of a warpgroup's m64nN accumulators (the
// 8-column blocks jb..jb + J - 1): out = bf16(x + γ ⊙ (acc + bias)) at the
// thread's rows r and r + 8 and columns col + 8j (+1), or bf16(acc + bias)
// without x.  load() issues every load (the residual pairs, bias and γ)
// before store() writes anything, so the loads' latency is paid once per
// group.  Rows at or past M are neither read nor stored.
template <int J>
struct Epi {
  __nv_bfloat162 x[J][2];
  float2 bias[J], g[J][2];
  bool has_x;
  __device__ __forceinline__ void load(const bf16* xr, const float* __restrict__ b,
                                       const float* gam, int M, int g_rows, int row, int col,
                                       int C) {
    has_x = xr != nullptr;
    b = opaque(b);
    gam = opaque(gam);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      bias[j] = __ldg(reinterpret_cast<const float2*>(b + col + 8 * j));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = row + 8 * hh;
        // (zero where not read: a value left unset would be taken for the
        // previous block's and kept live across a persistent kernel's loop)
        x[j][hh] = __floats2bfloat162_rn(0.f, 0.f);
        g[j][hh] = make_float2(0.f, 0.f);
        if (xr != nullptr && rr < M) {
          x[j][hh] = *reinterpret_cast<const __nv_bfloat162*>(xr + (size_t)rr * C + col + 8 * j);
          g[j][hh] = __ldg(reinterpret_cast<const float2*>(gamma_row(gam, rr, g_rows, C) + col +
                                                           8 * j));
        }
      }
    }
  }
  template <int NA>
  __device__ __forceinline__ void store(const float (&acc)[NA], int jb, bf16* out, int M,
                                        int row, int col, int C) const {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = row + 8 * hh;
        if (rr >= M) continue;
        const float v0 = acc[4 * (jb + j) + 2 * hh] + bias[j].x;
        const float v1 = acc[4 * (jb + j) + 2 * hh + 1] + bias[j].y;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rr * C + col + 8 * j) =
            has_x ? __floats2bfloat162_rn(__low2float(x[j][hh]) + v0 * g[j][hh].x,
                                          __high2float(x[j][hh]) + v1 * g[j][hh].y)
                  : __floats2bfloat162_rn(v0, v1);
      }
  }
};

// The epilogue of all N columns of m64nN accumulators, 32 columns at a time.
template <int N>
__device__ __forceinline__ void epilogue(const float (&acc)[N / 2], const bf16* xr,
                                         const float* b, const float* gam, bf16* out, int M,
                                         int g_rows, int row, int col, int C) {
  constexpr int J = 4;
#pragma unroll
  for (int jb = 0; jb < N / 8; jb += J) {
    Epi<J> e;
    e.load(xr, b, gam, M, g_rows, row, col + 8 * jb, C);
    e.store(acc, jb, out, M, row, col + 8 * jb, C);
  }
}

// ---------------------------------------------------------------------------
// consumers: warps 0-7.  Warpgroup 1 (warps 4-7) owns the CTA's CQ output
// columns: the proj and fc2 products (one m64nCQ wgmma per k16 step) and
// the epilogues.  Warpgroup 0 (warps 0-3) owns the CTA's kHq hidden columns
// of each chunk: fc1 (m64n32), gelu and the exchange.  The two run
// concurrently on their own ring stages: fc1 of chunk c + 1 beside fc2 of
// chunk c.  Both normalise LN2.
// ---------------------------------------------------------------------------
template <int C, int MODE, class Gelu>
__device__ __forceinline__ void consume(const Maps& m, const Args& a, const Smem<C>& s,
                                        int row0, int q) {
  using F = Cfg<C>;
  constexpr int CQ = F::CQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const bool out_wg = warp >= 4;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = q * CQ;                          // the CTA's output columns
  constexpr int NB = F::NB, NH = CQ / NB;  // the output columns in NH wgmmas of NB
  const uint64_t dA = hop::sw128_desc(s.a), dH = hop::sw64_desc(s.h);
  constexpr bool kHasProj = MODE == kProjMlp || MODE == kProj;
  const int nch = a.Hd / kHC;
  Ring<C, MODE> ring(s, m, out_wg ? 0 : 1, q, a.Hd);
  const uint64_t dW = hop::sw128_desc(s.ring(out_wg ? 0 : 1));

  if (kHasProj) {  // x' = bf16(res + γ1 ⊙ (ctx·Wpᵀ + bp)): a half of the CTA's
    float acc[CQ / 4];  // columns per warpgroup, from its ring, into out's rows
    hop::mbar_wait(s.afull, 0);
    auto step = [&](auto first, int kt) {  // first: kt = 0, which starts the product
      const int w = ring.acquire();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss<CQ / 2>(acc, at(dA, kt * kAtom + kk * 32), at(dW, w + kk * 32),
                              decltype(first)::value && kk == 0);
      ring.retire();
    };
    step(std::true_type{}, 0);
    for (int kt = 1; kt < F::KA; ++kt) step(std::false_type{}, kt);
    ring.drain();
    hop::fence_regs(acc);
    epilogue<CQ / 2>(acc, a.res, a.bp, a.g1, a.out, a.M, a.g_rows, row0 + r0,
                     c0 + (out_wg ? CQ / 2 : 0) + 2 * t, C);
    if (MODE == kProj) return;
    __syncwarp();  // publish this part of x' to the cluster, then wait for the rest
    if (lane == 0)
      for (int rk = 0; rk < kCluster; ++rk) hop::mbar_arrive_cluster(s.xready, rk);
    hop::mbar_wait<true>(s.xready, 0);
  }

  if (MODE == kProjMlp || MODE == kLnMlp) {  // LN2 of the block's rows into the A atoms
    const bf16* src = MODE == kLnMlp ? a.xin : a.out;
#pragma unroll 1
    for (int b = 0; b < 2; ++b) {  // warp w: rows w + 32b + 8i, i = 0..3
      const int r = warp + 32 * b, left = a.M - (row0 + r);
      ln_rows_to_bf16_at<4, F::NV, true>(
          src + (size_t)(row0 + r) * C, (size_t)kWarps * C,
          left > 0 ? (left + kWarps - 1) / kWarps : 0, a.ln_w, a.ln_b, a.eps,
          [&](int i, int col) { return reinterpret_cast<bf16*>(s.a + swz(r + 8 * i, col)); });
    }
    hop::fence_proxy_async();
    hop::named_sync(1, kThreads);
  } else if (!out_wg) {
    hop::mbar_wait(s.afull, 0);  // kMlp: the x rows by TMA
  }

  if (!out_wg) {
    // ---- hidden role: per chunk, fc1, bf16(gelu(fc1 + b1)) into every CTA's
    // buffer.  A buffer is written again (chunk c + 2) only after every
    // CTA's output warpgroup released it (hempty).
    Gelu gelu{};
    float hacc[kHq / 2];
    const float* b1w = opaque(a.b1) + kHq * q + 2 * t;
    float2 b1n[kHq / 8];  // b1 of the next chunk, loaded a chunk ahead
#pragma unroll
    for (int j = 0; j < kHq / 8; ++j)
      b1n[j] = __ldg(reinterpret_cast<const float2*>(b1w + 8 * j));
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      auto step = [&](auto first, int k0) {  // first: k0 = 0, which starts the product
        const int w = ring.acquire();
#pragma unroll
        for (int i = 0; i < F::KW1 / 64; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss<kHq>(hacc, at(dA, (k0 / 64 + i) * kAtom + kk * 32),
                               at(dW, w + i * kW1Box + kk * 32),
                               decltype(first)::value && (i | kk) == 0);
        ring.retire();
      };
      step(std::true_type{}, 0);
#pragma unroll 1
      for (int k0 = F::KW1; k0 < C; k0 += F::KW1) step(std::false_type{}, k0);
      ring.drain();
      hop::fence_regs(hacc);
      // A thread holds 2 columns of each of 8 (row, 8-column) chunks; the 4
      // threads of a quad exchange them so that each holds 2 whole 16-byte
      // chunks, stored to the 4 CTAs in 8 stores.
      uint32_t u[2][4];  // [group][k]: chunk 4·group + k = 2j + hh
#pragma unroll
      for (int j = 0; j < kHq / 8; ++j) {
        const float2 bb = b1n[j];
        if (c + 1 < nch)
          b1n[j] = __ldg(reinterpret_cast<const float2*>(b1w + (c + 1) * kHC + 8 * j));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          u[j >> 1][2 * (j & 1) + hh] = pack_bf16(gelu(hacc[4 * j + 2 * hh] + bb.x),
                                                  gelu(hacc[4 * j + 2 * hh + 1] + bb.y));
      }
      uint32_t chunk[2][4];  // [group]: chunk 4·group + t, its word s from quad lane s
#pragma unroll
      for (int gq = 0; gq < 2; ++gq)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = (t - i) & 3, s_ = (t + i) & 3;
          const uint32_t send = k == 0 ? u[gq][0] : k == 1 ? u[gq][1] : k == 2 ? u[gq][2]
                                                                              : u[gq][3];
          const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | s_);
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (s_ == w) chunk[gq][w] = got;
        }
      if (c >= 2) hop::mbar_wait<true>(&s.hempty[c & 1], ((c - 2) >> 1) & 1);
      uint8_t* hb = s.h + (c & 1) * kHBuf;
#pragma unroll
      for (int gq = 0; gq < 2; ++gq) {
        const int k = 4 * gq + t;  // = 2j + hh
        *reinterpret_cast<uint4*>(hb + hswz(r0 + 8 * (k & 1), kHq * q + 8 * (k >> 1))) =
            make_uint4(chunk[gq][0], chunk[gq][1], chunk[gq][2], chunk[gq][3]);
      }
      hop::fence_proxy_async();
      hop::named_sync(2, kThreads / 2);  // the slice is complete
      if (threadIdx.x == 0) {  // the slice to the other CTAs; this CTA's share of the chunk
        const uint8_t* slice = hb + q * kSlice;
        hop::mbar_arrive_expect_tx(&s.hfull[c & 1], (kCluster - 1) * kSlice);
        for (int rk = 1; rk < kCluster; ++rk) {
          const uint32_t dst = (q + rk) % kCluster;
          hop::bulk_copy_cluster(hop::mapa(slice, dst), slice, kSlice,
                                 hop::mapa(&s.hfull[c & 1], dst));
        }
      }
    }
    return;
  }

  // ---- output role: acc += H · W2ᵀ per chunk, once every CTA's hidden
  // warpgroup stored its columns (hfull); a buffer is released to all CTAs
  // (hempty) once the products reading it retired.
  float acc[NH][NB / 2];
  // the products of hidden columns 64hs.. of chunk c; first: c = 0, hs = 0,
  // which starts each product
  auto step = [&](auto first, int c, int hs) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int w = ring.acquire();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // hidden columns 64hs + 16kk: slice 2hs + kk/2
        hop::wgmma_ss<NB>(acc[h],
                          at(dH, (c & 1) * kHBuf + (2 * hs + (kk >> 1)) * kSlice +
                                     (kk & 1) * 32),
                          at(dW, w + kk * 32), decltype(first)::value && kk == 0);
      ring.retire();
      if (hs == 0 && h == 0 && c > 0 && lane == 0)  // chunk c - 1's products retired
        for (int rk = 0; rk < kCluster; ++rk)
          hop::mbar_arrive_cluster(&s.hempty[(c - 1) & 1], rk);
    }
  };
  hop::mbar_wait<true>(&s.hfull[0], 0);  // chunk 0 apart: no branch around a wgmma
  step(std::true_type{}, 0, 0);
  step(std::false_type{}, 0, 1);
#pragma unroll 1
  for (int c = 1; c < nch; ++c) {
    hop::mbar_wait<true>(&s.hfull[c & 1], (c >> 1) & 1);
#pragma unroll 1
    for (int hs = 0; hs < 2; ++hs) step(std::false_type{}, c, hs);
  }
  ring.drain();
  // fc2 bias (+ γ2 and the residual) -> out, the CTA's columns
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    hop::fence_regs(acc[h]);
    epilogue<NB>(acc[h], MODE == kMlp ? nullptr : MODE == kLnMlp ? a.xin : a.out, a.b2,
                 MODE == kMlp ? nullptr : a.g2, a.out, a.M, a.g_rows, row0 + r0,
                 c0 + h * NB + 2 * t, C);
  }
}

// The start of one cluster's 64-row block [row0, row0 + 64) in mode MODE,
// run by every thread of the CTA: the barriers, a cluster barrier, the A
// rows by TMA.  Then the first kThreads threads consume the block, and
// every thread ends it (end()).  The barriers are initialised here and
// invalidated at the end, so a persistent kernel (K7, whose CTAs have a
// third warpgroup, idle in the body) may use the shared memory for
// something else between blocks.
template <int C, int MODE>
__device__ __forceinline__ void begin(const Maps& m, const Smem<C>& s, int row0) {
  using F = Cfg<C>;
  if (threadIdx.x == 0) {
    for (int r = 0; r < 2; ++r)
      for (int i = 0; i < F::SLOTS; ++i) hop::mbar_init(&s.full(r)[i], 1);
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&s.hfull[i], 1);  // this CTA's arrival, with the others' bytes
      hop::mbar_init(&s.hempty[i], kCluster * kWarps / 2);
    }
    hop::mbar_init(s.afull, 1);
    hop::mbar_init(s.xready, kCluster * kWarps);
    hop::fence_mbar_init();
  }
  hop::fence_proxy_async();  // earlier generic use of this memory before TMA writes
  hop::cluster_sync();       // every CTA's barriers exist before anyone arrives remotely
  if (MODE != kLnMlp && threadIdx.x == 0) {  // the A rows, once
    hop::mbar_arrive_expect_tx(s.afull, F::KA * kAtom);
    for (int i = 0; i < F::KA; ++i) hop::tma_load_2d(s.a + i * kAtom, &m.a, 64 * i, row0, s.afull);
  }
}

template <int C>
__device__ __forceinline__ void end(const Smem<C>& s) {
  hop::cluster_sync();  // no CTA leaves while another may still write into it
  if (threadIdx.x == 0) {
    for (int i = 0; i < Smem<C>::kBarriers; ++i) hop::mbar_inval(&s.full0[i]);
  }
}

// One cluster's 64-row block, run by every thread of a CTA of kThreads.
template <int C, int MODE, class Gelu>
__device__ __forceinline__ void run(const Maps& m, const Args& a, uint8_t* raw, int row0) {
  const Smem<C> s(raw);
  begin<C, MODE>(m, s, row0);
  consume<C, MODE, Gelu>(m, a, s, row0, (int)hop::cluster_rank());
  end<C>(s);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
// The tensor maps of a mode (a over `arows` rows); false if the driver
// refuses one.
template <int C>
bool make_maps(Maps* m, int MODE, const void* a_rows, int arows, const void* wp, const void* w1,
               const void* w2, int Hd) {
  using F = Cfg<C>;
  *m = Maps{};
  if (MODE != kLnMlp && !hop::make_tensor_map(&m->a, a_rows, arows, C, 64, 64)) return false;
  if ((MODE == kProjMlp || MODE == kProj) &&
      !hop::make_tensor_map(&m->wp, wp, C, C, F::CQ / 2, 64))
    return false;
  if (MODE != kProj && (!hop::make_tensor_map(&m->w1, w1, Hd, C, kHq, 64) ||
                        !hop::make_tensor_map(&m->w2, w2, C, Hd, F::NB, 64)))
    return false;
  return true;
}

// A stand-alone launch of `kernel` (a __cluster_dims__(kCluster, 1, 1)
// kernel of kThreads threads that runs `run` on block blockIdx.x /
// kCluster) over a.M rows: one cluster per 64 rows.
template <int C, class Kernel>
int launch(Kernel kernel, const Maps& m, const Args& a, cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<((a.M + kRows - 1) / kRows) * kCluster, kThreads, smem, stream>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace body
}  // namespace vlm
