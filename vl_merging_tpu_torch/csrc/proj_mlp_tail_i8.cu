// K15: the post-attention half of a W8A8 eval block in one kernel:
//   x1  = bf16(res + (dequant(quant(ctx)·pqᵀ) + bp) ⊙ γ1)
//   h   = gelu(dequant(quant(LN2(x1))·w1qᵀ) + b1)              (f32)
//   out = bf16(x1 + (dequant(quant(h)·w2qᵀ) + b2) ⊙ γ2)
// every quant per token (row), every product s8·s8→s32.
//
// Replaces vl_merging_tpu/ops/int8.py:_proj_mlp_i8_kernel (via
// proj_mlp_tail_i8/_row_call_i8), with its arithmetic: x1 rounded to
// bf16 before LN2, LN2 in f32 into the quantizer, the gelu chosen by the
// caller (the degree-19 polynomial by default; ops/mlp.py GELUS order),
// one rounding per f32 operation.
//
// Bound on the H100: by its arithmetic, int8 tensor-core throughput (196
// GOP at B=32, N=577: 0.099 ms at 1,979 TOP/s, against ~90 MB of
// activations and weights, 0.027 ms at 3.35 TB/s).
//
// Design (Hopper, sm_90a): the MLP body's structure (mlp_body.cuh) over
// int8.  A cluster of four CTAs takes one 64-row block and each CTA owns
// a quarter of the output columns (CQ = C/4: 192 or 256), so that each
// weight tile reaches the SMs once per 64 rows; TMA rings carry
// 128B-swizzled int8 weight tiles; the products are wgmma m64nNk32
// s8·s8→s32 in two warpgroups with their own rings: an output warpgroup
// (CQ/2 s32 accumulators a thread for fc2: 96, or 128 at C = 1024) and a
// hidden warpgroup.  Byte for byte
// every operand has the bf16 body's layout (a k32 step of s8 is 32 bytes
// of a swizzled row, as a k16 step of bf16), with a hidden chunk of 256
// (64 columns a CTA, a 4 KB slice as in the body).
//   * The ctx rows are quantized per row by every CTA (the scale needs the
//     whole row) into C/128 int8 atoms of 64 rows x 128 bytes; the proj
//     runs half of the CTA's columns in each warpgroup (m64nCQ/2), and each CTA
//     stores its quarter of x1 into the output rows; a cluster barrier
//     publishes the whole x1 rows; LN2 runs in f32 and is quantized into
//     the same atoms.
//   * The fc2 input is quantized per row over all 3072 hidden columns, so
//     its scale needs the row's amax first.  Two passes, as the design
//     before took them (on mma.sync), now on wgmma: pass 1 runs fc1 over
//     the CTA's 768 hidden columns and keeps only each row's amax of
//     gelu(h); the chunks are split between the two warpgroups (the
//     output warpgroup, idle until fc2, takes every second); a row's
//     partial amaxes meet
//     in the CTA and then, four of them, through distributed shared
//     memory, and the 1e-8 floor is applied after their max, as
//     quant_rows applies it.  Pass 2 recomputes each chunk (m64n64),
//     quantizes it with the now known scale and exchanges the int8 slices
//     between the CTAs by bulk copies, as the body exchanges its bf16
//     slices; fc2 (m64n192, or two m64n128 at C = 1024) contracts them.
//     The recomputation is exact:
//     the s32 sums do not depend on their order and the f32 epilogue runs
//     the same instructions in both passes.
// Weight traffic per 64 rows: proj 0.59 MB, fc1 2 x 2.36, fc2 2.36: 7.7
// MB, 2.2 GB per launch at 32·577 rows (the 32-row mma.sync design
// before streamed the same 7.7 MB per 32 rows: 4.4 GB).  The second fc1
// pass costs 45% more products and no shared memory for an f32 hidden.
//
// Each product starts with a write-only first step (hopper.cuh), and a
// chunk's f32 epilogue follows its products.
//
// Shared memory at C = 768: A atoms 48 KB, hidden 2 buffers x 16 KB (the
// proj's row scales and pass 1's partial amaxes live there first), rings
// of 3 + 3 stages of 24 KB, LN2's row scales and the CTAs' amaxes 1.25
// KB, barriers, 1 KB of alignment slack: 226.4 KB.  At C = 1024 the A
// atoms take 64 KB and six such stages would not fit (290 KB): a stage is
// halved (16 KB: NB = CQ/2 rows of W2, KW1 = C/4 of W1, as the bf16 body
// halves its own), and each ring holds four, the least that fc1's four
// stages a chunk, all issued before it waits, take: 226.4 KB.  Built for C = 768
// and 1024 (Cfg); the hidden a multiple of 256.
#include <type_traits>

#include "hopper.cuh"
#include "int8.cuh"

using namespace vlm;

namespace {

constexpr int kRows = 64, kCluster = 4;
constexpr int kAtom = kRows * 128;        // 64 rows x 128 bytes, 128B-swizzled
constexpr int kHC = 256;                  // hidden chunk of the cluster
constexpr int kHq = kHC / kCluster;       // hidden columns a CTA computes per chunk
constexpr int kSlice = kRows * kHq;       // bytes of a CTA's slice of a hidden chunk
constexpr int kHBuf = kCluster * kSlice;  // bytes of a hidden buffer
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kW1Box = kHq * 128;
constexpr int kOutEvery = 2;              // pass 1: chunk c to the output warpgroup iff c % 2 == 1

// The width's layout.  CQ output columns a CTA, KA k-tiles (atoms) of 128
// int8 over the width.  A stage of the output ring holds NB of the CTA's
// W2 rows x 128 bytes (fc2 runs NH = CQ/NB products of NB columns), a
// stage of the hidden ring the CTA's 64 W1 rows x KW1 bytes (SW1 stages a
// chunk); both STAGE bytes; SLOTS0 and SLOTS1 stages in the output and the
// hidden ring.
template <int C>
struct Cfg {
  static constexpr int CQ = C / kCluster, KA = C / 128;
  static constexpr int NB = C <= 768 ? CQ : CQ / 2, KW1 = C <= 768 ? 384 : C / 4;
  static constexpr int NH = CQ / NB, SW1 = C / KW1;
  static constexpr int STAGE = NB * 128;
  static_assert(STAGE == kHq * KW1, "the two rings' stages differ");
  static constexpr int kProjBox = CQ / 2 * 128;  // a warpgroup's half of a Wp k-tile
  static_assert(kProjBox <= STAGE, "a proj k-tile in a ring stage");
  static constexpr int SLOTS0 = C <= 768 ? 3 : 4, SLOTS1 = SLOTS0;
  static_assert(SLOTS0 >= SW1 && SLOTS1 >= SW1,
                "fc1 issues a chunk's SW1 stages before it waits for any");
  static constexpr int H_OFF = KA * kAtom;
  static constexpr int RING0 = H_OFF + 2 * kHBuf;
  static constexpr int RING1 = RING0 + SLOTS0 * STAGE;
  static constexpr int F_OFF = RING1 + SLOTS1 * STAGE;  // s_ln[64], red[4][64]
  static constexpr int BAR_OFF = F_OFF + (1 + kCluster) * kRows * 4;
  static constexpr int kBarriers = SLOTS0 + SLOTS1 + 6;  // full, hfull[2], hempty[2], xready, amax
  static constexpr int SMEM = 1024 + BAR_OFF + kBarriers * 8;
  static_assert(SMEM <= 232448, "over the H100's shared memory per block");
};

// Tensor maps (hop::make_tensor_map_i8): wp (C x C) in CQ/2 x 128 boxes,
// w1 (Hd x C) in 64 x 128, w2 (C x Hd) in NB x 128.
struct Maps {
  CUtensorMap wp, w1, w2;
};

struct Args {
  const bf16 *ctx, *res;
  const float *ps, *bp, *g1, *ln_w, *ln_b, *w1s, *b1, *w2s, *b2, *g2;
  bf16* out;  // x1 is parked in its rows
  int M, Hd;
  float eps;
};

// The byte offset of row r (0..63), byte column col, in the A atoms
// (128B-swizzled along the columns).
__device__ __forceinline__ int swz(int r, int col) {
  return (col >> 7) * kAtom + r * 128 + ((((col >> 4) & 7) ^ (r & 7)) << 4) + (col & 15);
}
// ... and in a hidden buffer: CTA q's 64 columns are its own 4 KB slice
// (64 rows of 64 bytes, 64B-swizzled), moved to another CTA in one copy.
__device__ __forceinline__ int hswz(int r, int col) {
  return (col >> 6) * kSlice + r * 64 + ((((col >> 4) & 3) ^ ((r >> 1) & 3)) << 4) + (col & 15);
}

// Horner in u² with one rounding per step: horner(u2, c0, .., cn) =
// c0 + u2·(c1 + u2·(.. cn)), evaluated as ((cn·u2 + cn-1)·u2 + ..) + c0.
__device__ __forceinline__ float horner(float, float c) { return c; }
template <class... Rest>
__device__ __forceinline__ float horner(float u2, float c, Rest... rest) {
  return __fadd_rn(__fmul_rn(horner(u2, rest...), u2), c);
}

// 0.5·x·(1 + u·P(u²)), u = clip(x, -T, T)·(1/T): ops/mlp.py's polynomial
// gelus; constants are the f32 roundings of the doubles the twins use.
template <class... Coef>
__device__ __forceinline__ float poly_gelu(float x, double T, Coef... c) {
  const float u = __fmul_rn(fminf(fmaxf(x, -(float)T), (float)T), (float)(1.0 / T));
  const float p = horner(__fmul_rn(u, u), (float)c...);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, __fmul_rn(u, p)));
}

// G: the index of the activation in ops/mlp.py GELUS
template <int G>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (G == 0)
    return poly_gelu(x, 4.5, 3.590282846823918, -12.10273623182234, 36.461995337755816,
                     -85.03475787176419, 152.33199218079585, -204.54489822051983,
                     196.73375743149893, -126.45531926658512, 48.21324671368246,
                     -8.1935629198655);
  else if constexpr (G == 1)
    return poly_gelu(x, 3.5, 2.781156562, -5.458430753, 8.694525338, -8.887355099,
                     5.116006695, -1.245902743);
  else if constexpr (G == 2)
    return poly_gelu(x, 3.95, 3.144041517, -7.974838082, 16.980673852, -24.785977463,
                     23.048449174, -12.161256715, 2.748907717);
  else
    return ErfApproxGelu()(x);
}

// A warpgroup's ring of weight tiles, which it fills and empties itself
// (the body's Ring): stage k is loaded by TMA into slot k % slots by the
// warpgroup's first thread, at the start for the first slots and then as
// soon as the products reading a slot have retired.  Ring 0 (the output
// warpgroup): the upper half of the CTA's Wp rows, the W1 stages of its
// pass-1 chunks, the W2 stages; ring 1 (the hidden warpgroup): the lower
// half of Wp, the W1 stages of its pass-1 chunks, the W1 stages of every
// chunk again for pass 2.
template <int C>
struct Ring {
  using F = Cfg<C>;
  static constexpr int KA = F::KA, STAGE = F::STAGE, SW1 = F::SW1, NH = F::NH;
  const Maps& m;
  uint8_t* base;
  uint64_t* full;
  const int r, q, slots, np1, total;
  int n = 0, filled = 0, freed = 0;  // stages acquired, loaded, handed back
  __device__ __forceinline__ Ring(const Maps& mp, uint8_t* b, uint64_t* f, int ring, int q_,
                                  int nch)
      : m(mp), base(b), full(f), r(ring), q(q_), slots(ring == 0 ? F::SLOTS0 : F::SLOTS1),
        np1(ring == 0 ? nch / kOutEvery : nch - nch / kOutEvery),
        total(KA + SW1 * np1 + (ring == 0 ? 2 * NH : SW1) * nch) {
    while (filled < slots && filled < total) fill();
  }
  // the chunk of this ring's j-th pass-1 chunk
  __device__ __forceinline__ int pass1_chunk(int j) const {
    return r == 0 ? kOutEvery * j + kOutEvery - 1 : j + j / (kOutEvery - 1);
  }
  __device__ __forceinline__ bool leader() const { return (threadIdx.x & 127) == 0; }
  __device__ __forceinline__ void w1_stage(uint8_t* dst, uint64_t* bar, int c, int s) const {
    hop::mbar_arrive_expect_tx(bar, STAGE);
    for (int i = 0; i < F::KW1 / 128; ++i)
      hop::tma_load_2d(dst + i * kW1Box, &m.w1, s * F::KW1 + 128 * i, c * kHC + kHq * q, bar);
  }
  // load the next stage, by the warpgroup's first thread
  __device__ __forceinline__ void fill() {
    const int k = filled++;
    if (!leader()) return;
    uint64_t* bar = &full[k % slots];
    uint8_t* dst = base + (k % slots) * STAGE;
    if (k < KA) {
      hop::mbar_arrive_expect_tx(bar, F::kProjBox);
      hop::tma_load_2d(dst, &m.wp, 128 * k, q * F::CQ + (1 - r) * F::CQ / 2, bar);
      return;
    }
    const int k1 = k - KA;
    if (k1 < SW1 * np1) {
      w1_stage(dst, bar, pass1_chunk(k1 / SW1), k1 % SW1);
      return;
    }
    const int k2 = k1 - SW1 * np1;
    if (r == 1) {
      w1_stage(dst, bar, k2 / SW1, k2 % SW1);
    } else {  // W2: hidden columns c·256 + 128hs.., the CTA's output rows h·NB..
      const int c = k2 / (2 * NH), hs = k2 % (2 * NH) / NH, h = k2 % NH;
      hop::mbar_arrive_expect_tx(bar, STAGE);
      hop::tma_load_2d(dst, &m.w2, c * kHC + 128 * hs, q * F::CQ + h * F::NB, bar);
    }
  }
  // the next stage's byte offset in the ring, once its tiles have landed
  __device__ __forceinline__ int acquire() {
    const int st = n % slots;
    hop::mbar_wait(&full[st], (n / slots) & 1);
    hop::wgmma_fence();
    return st * STAGE;
  }
  // the slots of the stages before `upto` are free: every warp of the
  // warpgroup has seen their products retire; load the next stages into them
  __device__ __forceinline__ void free_through(int upto) {
    if (freed >= upto) return;
    hop::named_sync(3 + r, 128);
    for (; freed < upto; ++freed)
      if (filled < total) fill();
  }
  // after the stage's products are issued: keep the newest in flight
  __device__ __forceinline__ void retire() {
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    free_through(n++);
  }
  // after the stage's products are issued, none waited for
  __device__ __forceinline__ void commit() {
    hop::wgmma_commit();
    ++n;
  }
  // every stage but the newest D retired
  template <int D>
  __device__ __forceinline__ void wait_free() {
    hop::wgmma_wait<D>();
    free_through(n - D);
  }
  __device__ __forceinline__ void drain() { wait_free<0>(); }
};

__device__ __forceinline__ uint64_t at(uint64_t d, int bytes) {
  return d + (uint64_t)(bytes >> 4);
}

template <int C, int G>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    proj_mlp_tail_i8_kernel(const __grid_constant__ Maps m, const Args a) {
  using F = Cfg<C>;
  constexpr int CQ = F::CQ, KA = F::KA, NB = F::NB, NH = F::NH, SW1 = F::SW1;
  constexpr int SLOTS0 = F::SLOTS0, SLOTS1 = F::SLOTS1;
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* base = raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
  int8_t* A = reinterpret_cast<int8_t*>(base);
  uint8_t* H = base + F::H_OFF;
  // s_ctx (the proj's row scales) and the warpgroups' pass-1 partials
  // (part[warpgroup][row]) live in the hidden buffers, which no CTA writes
  // before every CTA is past pass 1 (the amax barrier)
  float* s_ctx = reinterpret_cast<float*>(base + F::H_OFF);
  float* part = s_ctx + kRows;
  float* s_ln = reinterpret_cast<float*>(base + F::F_OFF);
  float* red = s_ln + kRows;  // [CTA][row]: the CTAs' pass-1 amaxes
  uint64_t* full0 = reinterpret_cast<uint64_t*>(base + F::BAR_OFF);
  uint64_t* full1 = full0 + SLOTS0;
  uint64_t* hfull = full1 + SLOTS1;
  uint64_t* hempty = hfull + 2;
  uint64_t* xready = hempty + 2;
  uint64_t* amax_bar = xready + 1;

  const int q = (int)hop::cluster_rank();
  const int row0 = blockIdx.x / kCluster * kRows;
  const int nch = a.Hd / kHC;
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS0 + SLOTS1; ++i) hop::mbar_init(&full0[i], 1);
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&hfull[i], 1);  // this CTA's arrival, with the others' bytes
      hop::mbar_init(&hempty[i], kCluster * kWarps / 2);
    }
    hop::mbar_init(xready, kCluster * kWarps);
    hop::mbar_init(amax_bar, kCluster * kThreads / 8);  // the hidden warpgroups' t = 0 lanes
    hop::fence_mbar_init();
  }
  hop::cluster_sync();  // every CTA's barriers exist before anyone arrives remotely

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int wg = warp >> 2;  // 1: the output warpgroup, 0: the hidden warpgroup
  const bool out_wg = wg == 1;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = q * CQ;                          // the CTA's output columns
  Ring<C> ring(m, base + (out_wg ? F::RING0 : F::RING1), out_wg ? full0 : full1, out_wg ? 0 : 1,
               q, nch);
  const uint64_t dA = hop::sw128_desc(A), dH = hop::sw64_desc(H);
  const uint64_t dW = hop::sw128_desc(base + (out_wg ? F::RING0 : F::RING1));

  // ---- quant(ctx) of the block's 64 rows into the A atoms: warp w, rows
  // w + 8i
#pragma unroll 1
  for (int b = 0; b < 2; ++b) {
    const int r = warp + 32 * b, left = a.M - (row0 + r);
    quant_rows_at<4, C / 256>(
        a.ctx + (size_t)(row0 + r) * C, (size_t)kWarps * C,
        left > 0 ? (left + kWarps - 1) / kWarps : 0,
        [&](int i, int col) { return A + swz(r + 8 * i, col); }, s_ctx + r, kWarps);
  }
  hop::fence_proxy_async();
  hop::named_sync(1, kThreads);

  // ---- proj: x1 = bf16(res + (dequant(acc) + bp) ⊙ γ1), a half of the
  // CTA's columns per warpgroup, into out's rows
  {
    int acc[CQ / 4];
    auto step = [&](auto first, int kt) {  // first: kt = 0, which starts the product
      const int w = ring.acquire();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_s8<CQ / 2>(acc, at(dA, kt * kAtom + kk * 32), at(dW, w + kk * 32),
                              decltype(first)::value && kk == 0);
      ring.retire();
    };
    step(std::true_type{}, 0);
#pragma unroll 1
    for (int kt = 1; kt < KA; ++kt) step(std::false_type{}, kt);
    ring.drain();
    hop::fence_regs(acc);
    const int cb = c0 + (out_wg ? CQ / 2 : 0) + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh, row = row0 + r;
      if (row >= a.M) continue;
      const float s = s_ctx[r];
      const bf16* rr = a.res + (size_t)row * C;
      bf16* orow = a.out + (size_t)row * C;
#pragma unroll
      for (int j = 0; j < CQ / 16; ++j) {
        const int col = cb + 8 * j;
        const float2 ps = __ldg(reinterpret_cast<const float2*>(a.ps + col));
        const float2 bp = __ldg(reinterpret_cast<const float2*>(a.bp + col));
        const float2 g1 = __ldg(reinterpret_cast<const float2*>(a.g1 + col));
        const float2 rv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + col));
        const float y0 = __fmul_rn(dequant(acc[4 * j + 2 * hh], s, ps.x, bp.x), g1.x);
        const float y1 = __fmul_rn(dequant(acc[4 * j + 2 * hh + 1], s, ps.y, bp.y), g1.y);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(__fadd_rn(rv.x, y0), __fadd_rn(rv.y, y1));
      }
    }
  }
  __syncwarp();  // publish this part of x1 to the cluster, then wait for the rest
  if (lane == 0)
    for (int rk = 0; rk < kCluster; ++rk) hop::mbar_arrive_cluster(xready, rk);
  hop::mbar_wait<true>(xready, 0);

  // ---- LN2(x1) in f32, quantized per row into the A atoms
#pragma unroll 1
  for (int b = 0; b < 2; ++b) {
    const int r = warp + 32 * b, left = a.M - (row0 + r);
    ln_quant_rows_at<4, C / 256>(
        a.out + (size_t)(row0 + r) * C, (size_t)kWarps * C,
        left > 0 ? (left + kWarps - 1) / kWarps : 0, a.ln_w, a.ln_b, a.eps,
        [&](int i, int col) { return A + swz(r + 8 * i, col); }, s_ln + r, kWarps);
  }
  hop::fence_proxy_async();
  hop::named_sync(1, kThreads);

  // fc1 of the CTA's 64 hidden columns of chunk c: issue() its products
  // (SW1 ring stages) into acc, finish() its f32 epilogue once they retired,
  // h = gelu(dequant(acc) + b1), handed to take(j, hh, h0, h1): the thread's
  // row r0 (hh 0) or r0 + 8 (hh 1), columns c·256 + 64q + 8j + 2t and + 1.
  // Both passes compute h with these same instructions.
  const float sl0 = s_ln[r0], sl1 = s_ln[r0 + 8];
  using Acc = int[kHq / 2];
  auto issue = [&](Acc& acc, int c) {
    auto step = [&](auto first, int s) {  // first: s = 0, which starts the product
      const int w = ring.acquire();
#pragma unroll
      for (int i = 0; i < F::KW1 / 128; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_s8<kHq>(acc, at(dA, (s * (F::KW1 / 128) + i) * kAtom + kk * 32),
                             at(dW, w + i * kW1Box + kk * 32),
                             decltype(first)::value && (i | kk) == 0);
      ring.commit();
    };
    step(std::true_type{}, 0);
#pragma unroll
    for (int s = 1; s < SW1; ++s) step(std::false_type{}, s);
  };
  auto finish = [&](Acc& acc, int c, auto take) {
    hop::fence_regs(acc);
    const int cb = c * kHC + kHq * q + 2 * t;
#pragma unroll
    for (int j = 0; j < kHq / 8; ++j) {
      const float2 ws = __ldg(reinterpret_cast<const float2*>(a.w1s + cb + 8 * j));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b1 + cb + 8 * j));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float s = hh ? sl1 : sl0;
        take(j, hh, gelu<G>(dequant(acc[4 * j + 2 * hh], s, ws.x, bb.x)),
             gelu<G>(dequant(acc[4 * j + 2 * hh + 1], s, ws.y, bb.y)));
      }
    }
  };
  // fc1 of chunks chunk(0 .. n-1), each issued, retired and finished in turn
  auto fc1 = [&](int n, auto chunk, auto take, auto done) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      Acc acc;
      issue(acc, chunk(j));
      ring.drain();
      finish(acc, chunk(j), take);
      done(chunk(j));
    }
  };

  // ---- pass 1: each row's amax of h over the CTA's hidden columns, the
  // chunks split between the warpgroups
  float amax[2] = {0.f, 0.f};
  {
    auto chunk = [&](int j) { return ring.pass1_chunk(j); };
    auto take = [&](int, int hh, float h0, float h1) {
      amax[hh] = fmaxf(amax[hh], fmaxf(fabsf(h0), fabsf(h1)));
    };
    fc1(ring.np1, chunk, take, [](int) {});
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    amax[hh] = fmaxf(amax[hh], __shfl_xor_sync(0xffffffffu, amax[hh], 1));
    amax[hh] = fmaxf(amax[hh], __shfl_xor_sync(0xffffffffu, amax[hh], 2));
  }
  if (t == 0) {
    part[wg * kRows + r0] = amax[0];
    part[wg * kRows + r0 + 8] = amax[1];
  }
  hop::named_sync(1, kThreads);
  if (!out_wg && t == 0) {  // the CTA's amaxes of rows r0, r0 + 8 to every CTA
    const float m0 = fmaxf(part[r0], part[kRows + r0]);
    const float m1 = fmaxf(part[r0 + 8], part[kRows + r0 + 8]);
    for (int rk = 0; rk < kCluster; ++rk) {
      hop::st_cluster_f32(hop::mapa(red + q * kRows + r0, rk), m0);
      hop::st_cluster_f32(hop::mapa(red + q * kRows + r0 + 8, rk), m1);
      hop::mbar_arrive_cluster(amax_bar, rk);
    }
  }
  hop::mbar_wait<true>(amax_bar, 0);
  float s_hid[2], inv_hid[2];  // the fc2 input's row scales, max(amax, 1e-8)/127
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < kCluster; ++i) mx = fmaxf(mx, red[i * kRows + r0 + 8 * hh]);
    s_hid[hh] = quant_scale(mx);
    inv_hid[hh] = __frcp_rn(s_hid[hh]);
  }

  if (!out_wg) {
    // ---- pass 2, hidden role: per chunk, fc1 again, quant(h) into every
    // CTA's buffer.  A buffer is written again (chunk c + 2) only after
    // every CTA's output warpgroup released it (hempty).
    uint16_t qv[kHq / 8][2];
    auto take = [&](int j, int hh, float h0, float h1) {
      qv[j][hh] = (uint16_t)((quantize(h0, inv_hid[hh]) & 0xff) |
                             ((quantize(h1, inv_hid[hh]) & 0xff) << 8));
    };
    auto done = [&](int c) {
      if (c >= 2) hop::mbar_wait<true>(&hempty[c & 1], ((c - 2) >> 1) & 1);
      uint8_t* hb = H + (c & 1) * kHBuf;
#pragma unroll
      for (int j = 0; j < kHq / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint16_t*>(hb + hswz(r0 + 8 * hh, kHq * q + 8 * j + 2 * t)) =
              qv[j][hh];
      hop::fence_proxy_async();
      hop::named_sync(2, kThreads / 2);  // the slice is complete
      if (threadIdx.x == 0) {  // the slice to the other CTAs; this CTA's share of the chunk
        const uint8_t* slice = hb + q * kSlice;
        hop::mbar_arrive_expect_tx(&hfull[c & 1], (kCluster - 1) * kSlice);
        for (int rk = 1; rk < kCluster; ++rk) {
          const uint32_t dst = (q + rk) % kCluster;
          hop::bulk_copy_cluster(hop::mapa(slice, dst), slice, kSlice,
                                 hop::mapa(&hfull[c & 1], dst));
        }
      }
    };
    fc1(nch, [](int c) { return c; }, take, done);
  } else {
    // ---- pass 2, output role: acc += quant(h) · W2ᵀ per chunk, once every
    // CTA's hidden warpgroup stored its slice (hfull); a buffer is released
    // to all CTAs (hempty) once the products reading it retired.
    int acc[NH][NB / 2];
    // the products of hidden bytes 128hs.. of chunk c, NB output columns at
    // a time, each from its own stage; first: c = 0, hs = 0, which starts
    // each product
    auto step = [&](auto first, int c, int hs) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int w = ring.acquire();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // hidden bytes 128hs + 32kk: slice 2hs + kk/2
          hop::wgmma_s8<NB>(acc[h],
                            at(dH, (c & 1) * kHBuf + (2 * hs + (kk >> 1)) * kSlice +
                                       (kk & 1) * 32),
                            at(dW, w + kk * 32), decltype(first)::value && kk == 0);
        ring.retire();
        if (hs == 0 && h == 0 && c > 0 && lane == 0)  // chunk c - 1's products retired
          for (int rk = 0; rk < kCluster; ++rk)
            hop::mbar_arrive_cluster(&hempty[(c - 1) & 1], rk);
      }
    };
    hop::mbar_wait<true>(&hfull[0], 0);  // chunk 0 apart: no branch around a wgmma
    step(std::true_type{}, 0, 0);
    step(std::false_type{}, 0, 1);
#pragma unroll 1
    for (int c = 1; c < nch; ++c) {
      hop::mbar_wait<true>(&hfull[c & 1], (c >> 1) & 1);
#pragma unroll 1
      for (int hs = 0; hs < 2; ++hs) step(std::false_type{}, c, hs);
    }
    ring.drain();
    // out = bf16(x1 + (dequant(acc) + b2) ⊙ γ2), the CTA's columns, 32 at a
    // time: a group's loads, then its stores
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      hop::fence_regs(acc[h]);
#pragma unroll
      for (int jb = 0; jb < NB / 8; jb += 4) {
        float2 ws[4], bb[4], g2[4], x1[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + h * NB + 8 * (jb + j) + 2 * t;
          ws[j] = __ldg(reinterpret_cast<const float2*>(a.w2s + col));
          bb[j] = __ldg(reinterpret_cast<const float2*>(a.b2 + col));
          g2[j] = __ldg(reinterpret_cast<const float2*>(a.g2 + col));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + r0 + 8 * hh;
            x1[j][hh] = make_float2(0.f, 0.f);
            if (row < a.M)
              x1[j][hh] = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(a.out + (size_t)row * C + col));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + r0 + 8 * hh, col = c0 + h * NB + 8 * (jb + j) + 2 * t;
            if (row >= a.M) continue;
            const int e = 4 * (jb + j) + 2 * hh;
            const float y0 = __fmul_rn(dequant(acc[h][e], s_hid[hh], ws[j].x, bb[j].x), g2[j].x);
            const float y1 =
                __fmul_rn(dequant(acc[h][e + 1], s_hid[hh], ws[j].y, bb[j].y), g2[j].y);
            *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)row * C + col) =
                __floats2bfloat162_rn(__fadd_rn(x1[j][hh].x, y0), __fadd_rn(x1[j][hh].y, y1));
          }
        asm volatile("" ::: "memory");  // the next group's loads stay after these stores
      }
    }
  }
  hop::cluster_sync();  // no CTA leaves while another may still write into it
}

template <int C, int G>
int launch(const Maps& m, const Args& a, cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      proj_mlp_tail_i8_kernel<C, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  proj_mlp_tail_i8_kernel<C, G>
      <<<(a.M + kRows - 1) / kRows * kCluster, kThreads, smem, stream>>>(m, a);
  return (int)cudaGetLastError();
}

// The launch at width C with the gelu gelu_kind; the tensor maps first.
template <int C>
int launch_width(const void* pq, const void* w1q, const void* w2q, const Args& a, int gelu_kind,
                 cudaStream_t stream) {
  using F = Cfg<C>;
  Maps m;
  if (!hop::make_tensor_map_i8(&m.wp, pq, C, C, F::CQ / 2, 128) ||
      !hop::make_tensor_map_i8(&m.w1, w1q, a.Hd, C, kHq, 128) ||
      !hop::make_tensor_map_i8(&m.w2, w2q, C, a.Hd, F::NB, 128))
    return (int)cudaErrorNotSupported;
  switch (gelu_kind) {
    case 0:
      return launch<C, 0>(m, a, stream);
    case 1:
      return launch<C, 1>(m, a, stream);
    case 2:
      return launch<C, 2>(m, a, stream);
    default:
      return launch<C, 3>(m, a, stream);
  }
}

}  // namespace

extern "C" int vlm_proj_mlp_tail_i8(const void* ctx, const void* res, const void* pq,
                                    const void* ps, const void* bp, const void* g1,
                                    const void* ln_w, const void* ln_b, const void* w1q,
                                    const void* w1s, const void* b1, const void* w2q,
                                    const void* w2s, const void* b2, const void* g2,
                                    void* out, int M, int width, int Hd, int gelu_kind,
                                    float eps, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % kHC != 0 || gelu_kind < 0 || gelu_kind > 3)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(ctx),  static_cast<const bf16*>(res),
               static_cast<const float*>(ps),  static_cast<const float*>(bp),
               static_cast<const float*>(g1),  static_cast<const float*>(ln_w),
               static_cast<const float*>(ln_b), static_cast<const float*>(w1s),
               static_cast<const float*>(b1),  static_cast<const float*>(w2s),
               static_cast<const float*>(b2),  static_cast<const float*>(g2),
               static_cast<bf16*>(out),        M,
               Hd,                             eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 768:
      return launch_width<768>(pq, w1q, w2q, a, gelu_kind, s);
    case 1024:
      return launch_width<1024>(pq, w1q, w2q, a, gelu_kind, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
