// K2's device code: a persistent flash attention over packed qkv, run by
// its own kernel (packed_attention_fwd.cu, which holds the design notes),
// by K7's phase B (block_eval.cu), by K8's second role
// (ln_qkv_attention.cu) and, over split q, k and v (the SplitMaps layout
// policy), by K10 and K11 (split_attention.cu), so that all five compute
// every element with the same instructions; and, with its q·kᵀ in int8
// (the Int8Qk policy), by K12 (packed_attention_i8qk.cu).
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "int8.cuh"

namespace vlm {
namespace k2 {


constexpr int D = 64, BKV = 64, STAGES = 4, PRODUCERS = 128;
constexpr int KV_BYTES = BKV * D * 2;
// The f32 bias tile of a stage: for each of the BQ query rows, the 16-byte
// chunks of the bias row that hold its 64 keys (17 at a row offset of 1 to
// 3 floats), rows BIAS_LD floats apart; a row's key k0 + c sits at float
// off + c, off = the row's key k0 modulo 4 floats.
constexpr int BIAS_CHUNKS = BKV / 4 + 1, BIAS_LD = 72;
constexpr int kBarriers = 2 * STAGES + 2;

// The q·kᵀ policy of a launch.
//
// Bf16Qk, K2's, K7's, K8's, K10's and K11's: s = bias + (q·scale)·kᵀ in f32,
// q scaled in bf16 in the consumers' A fragments, k the bf16 tile TMA
// wrote, the bias the initial value of the accumulator.
//
// Int8Qk, K12's: q and k quantized per (token, head) row of 64 as the
// int8 twins quantize (int8.cuh), and s = ((f32(q_i8·k_i8ᵀ) · (sq·scale))
// · sk) + bias in f32, one rounding per operation.  The producer warpgroup
// quantizes each landed k tile in place (quant_k): the int8 K-major tile,
// 64B-swizzled, in the first I8_K_BYTES of the stage's K buffer and the
// 64 keys' scales after it, at I8_SCALES.  A barrier of its own per stage
// (kfull) says when the bf16 k tile has landed, and the stage's full
// barrier counts the quantizers' arrivals beside the bias copiers'.  The
// consumers quantize their q rows once per item (quant_q), run s8 wgmma
// into a fresh s32 accumulator and dequantize it (logits_i8).
struct Bf16Qk {
  static constexpr bool kInt8 = false;
  static constexpr int BARRIERS = 0;  // beyond kBarriers
};
struct Int8Qk {
  static constexpr bool kInt8 = true;
  static constexpr int BARRIERS = STAGES;  // kfull
};
constexpr int I8_K_BYTES = BKV * D, I8_SCALES = I8_K_BYTES;
static_assert(I8_SCALES + BKV * 4 <= KV_BYTES, "the int8 k tile and its scales fill a K buffer");
// the named barrier of the producer's quantizers (1 and 2: the consumers' turns)
constexpr int kQuantBarrier = 3;

// The shapes of a CTA with NC consumer warpgroups of 64 query rows each
// (K2: 2, in ping-pong; K7: 1) and the producer warpgroup, under the q·kᵀ
// policy Qk.
template <int NC, class Qk = Bf16Qk>
struct Cfg {
  static constexpr int BQ = 64 * NC, CONSUMERS = 128 * NC, THREADS = CONSUMERS + PRODUCERS;
  static constexpr int CONSUMER_WARPS = CONSUMERS / 32;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int CHUNKS_PER_THREAD = (BQ * BIAS_CHUNKS + PRODUCERS - 1) / PRODUCERS;
  static constexpr int BIAS_BYTES = BQ * BIAS_LD * 4;
  static constexpr int STAGE = 2 * KV_BYTES + BIAS_BYTES;
  static constexpr int RING = Q_BYTES, BAR = RING + STAGES * STAGE;
  static constexpr int SMEM = 1024 + BAR + (kBarriers + Qk::BARRIERS) * 8;
  static_assert(SMEM <= 232448, "over the H100's shared memory per block");
};
// K2's own kernel
constexpr int BQ = Cfg<2>::BQ, CONSUMERS = Cfg<2>::CONSUMERS, THREADS = Cfg<2>::THREADS;
constexpr int SMEM = Cfg<2>::SMEM;

// Where the producer's TMA loads find an item's q tile and a key tile's k
// and v (completing on k_bar and v_bar): the layout policy of the launch.
//
// Maps, K2's, K7's and K8's: q, k and v in place in a packed qkv, one 3-D
// map over (B, N, 3C) (q at column 0, k at C, v at 2C, head h at h·64).
struct Maps {
  CUtensorMap q, kv;  // qkv (B, N, 3C) in 64 x BQ and 64 x 64 boxes
  __device__ __forceinline__ void load_q(void* dst, int b, int h, int row, int,
                                         uint64_t* bar) const {
    hop::tma_load_3d(dst, &q, h * D, row, b, bar);
  }
  __device__ __forceinline__ void load_kv(void* k_dst, void* v_dst, int b, int h, int k0, int C,
                                          uint64_t* k_bar, uint64_t* v_bar) const {
    hop::tma_load_3d(k_dst, &kv, C + h * D, k0, b, k_bar);
    hop::tma_load_3d(v_dst, &kv, 2 * C + h * D, k0, b, v_bar);
  }
};

// SplitMaps, K10's and K11's: q, k and v as three (B, H, N, 64) tensors
// with a contiguous head dimension and any (element, head, token) strides
// (16-byte multiples), each through a 4-D map over (64, N, H, B) whose
// rows past N read as zeros.  The boxes, and so the shared memory the
// consumers read, are the packed maps' own.
struct SplitMaps {
  CUtensorMap q, k, v;  // 64 x BQ x 1 x 1 and 64 x 64 x 1 x 1 boxes
  __device__ __forceinline__ void load_q(void* dst, int b, int h, int row, int,
                                         uint64_t* bar) const {
    hop::tma_load_4d(dst, &q, 0, row, h, b, bar);
  }
  __device__ __forceinline__ void load_kv(void* k_dst, void* v_dst, int b, int h, int k0, int,
                                          uint64_t* k_bar, uint64_t* v_bar) const {
    hop::tma_load_4d(k_dst, &k, 0, k0, h, b, k_bar);
    hop::tma_load_4d(v_dst, &v, 0, k0, h, b, v_bar);
  }
};

struct Args {
  const float* bias;
  const int* mask;
  bf16* out;
  float* stats;
  int B, N, H, nqt, items;
  float scale;
};

// The items a CTA takes, first, first + stride, .., and their order: the
// (element b, query tile qt, head h) of item `item`, and what the
// producer's first thread waits for before it loads an item's q, k and v.
//
// Items, K2's own and K7's: items blockIdx.x, + gridDim.x, .., element
// fastest, so that the CTAs that share a bias tile run together and a
// head's K/V rows stay in L2 across its query tiles; nothing to wait for.
struct Items {
  int first, stride;
  __device__ __forceinline__ Items() : first(blockIdx.x), stride(gridDim.x) {}
  __device__ __forceinline__ void decode(const Args& a, int item, int& b, int& qt, int& h) const {
    b = item % a.B;
    qt = item / a.B % a.nqt;
    h = item / a.B / a.nqt;
  }
  __device__ __forceinline__ void ready(int) const {}
};

// ElementMajor, K8's: element slowest (then head, query tile fastest), the
// elements in the order K8's first role finishes their qkv rows; an item
// of element b waits until done[b] counts every (16-row group, column
// tile) of its rows that the first role publishes (ln_linear.cuh
// Strided), with acquire semantics, then orders that view before the TMA
// loads (async proxy) that read the rows.  waited: null, or where the
// nanoseconds spent waiting and the items are summed (a profiler's trace:
// waited[0], waited[1]).
struct ElementMajor {
  int first, stride;
  const int* done;
  int ncb, N;  // the first role's column tiles; rows per element
  unsigned long long* waited;
  __device__ __forceinline__ ElementMajor(int first_, int stride_, const int* done_, int ncb_,
                                          int N_, unsigned long long* waited_)
      : first(first_), stride(stride_), done(done_), ncb(ncb_), N(N_), waited(waited_) {}
  __device__ __forceinline__ void decode(const Args& a, int item, int& b, int& qt, int& h) const {
    const int per = a.H * a.nqt, r = item % per;
    b = item / per;
    qt = r % a.nqt;
    h = r / a.nqt;
  }
  __device__ __forceinline__ void ready(int b) const {
    const int groups = (b * N + N - 1) / 16 - b * N / 16 + 1;
    const unsigned long long t0 = waited != nullptr ? hop::global_ns() : 0;
    hop::wait_at_least(done + b, groups * ncb);
    hop::fence_proxy_async_global();
    if (waited != nullptr) {
      waited[0] += hop::global_ns() - t0;
      waited[1] += 1;
    }
  }
};

// An arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted in the barrier's arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(hop::smem_u32(bar))
               : "memory");
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22; 0 for -inf).  The
// softmax takes exp(s - u) as 2^(s·log2 e - u·log2 e), one FFMA and one
// MUFU op a logit.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumer state of one warp: its 16 query rows' output, running max
// and sum (rows g and g + 8 of the warp's 16, the m64nN accumulator
// layout: o[4n + e] is column 8n + 2t + (e & 1) of row g + 8(e >> 1)).
struct Rows {
  float o[32];
  float m0, m1, l0, l1;
};

// The two consumer warpgroups take turns at issuing their products (named
// barriers 1 and 2, FlashAttention-3's ping-pong), so that one's softmax
// runs while the other's products do, not both at once.  Warpgroup 1
// grants warpgroup 0 the first turn; warpgroup 0 takes the last grant after
// its last turn.
// One consumer warpgroup (NC = 1) takes no turns.
template <int NC>
__device__ __forceinline__ void tensor_turn_begin() {
  if constexpr (NC == 2) hop::named_sync(1 + (threadIdx.x >> 7), 256);
}
template <int NC>
__device__ __forceinline__ void tensor_turn_end() {
  if constexpr (NC == 2) hop::named_arrive(2 - (threadIdx.x >> 7), 256);
}

// The phases of one key tile of W keys (16, 32 or 64) for the warp's rows.
// The logits start as the bias tile's values (in shared memory) or -inf for
// a key that is masked (mask <= 0) or past N (bits lo: even keys 2i, hi:
// odd keys 2i + 1).
// b0, b1: the bias tile's rows of this thread's two query rows, at their
// offsets, plus 2t.
template <int W>
__device__ __forceinline__ void init_logits(float (&s)[32], const float* b0, const float* b1,
                                            uint32_t lo, uint32_t hi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const bool v0 = (lo >> (4 * j + t)) & 1, v1 = (hi >> (4 * j + t)) & 1;
    s[4 * j] = v0 ? b0[8 * j] : -INFINITY;
    s[4 * j + 1] = v1 ? b0[8 * j + 1] : -INFINITY;
    s[4 * j + 2] = v0 ? b1[8 * j] : -INFINITY;
    s[4 * j + 3] = v1 ? b1[8 * j + 1] : -INFINITY;
  }
}

// s += q·kᵀ (wgmma, A from registers, K a K-major 64 x 64 tile), issued.
template <int W>
__device__ __forceinline__ void issue_qk(float (&s)[32], const uint32_t (&qa)[4][4],
                                         const uint8_t* kt) {
  float(&d)[W / 2] = reinterpret_cast<float(&)[W / 2]>(s);
  const uint64_t dk = hop::sw128_desc(kt);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (W == 16)
      hop::wgmma_m64n16_rs(d, qa[kk], hop::desc_add(dk, kk * 32));
    else if constexpr (W == 32)
      hop::wgmma_m64n32_rs(d, qa[kk], hop::desc_add(dk, kk * 32));
    else
      hop::wgmma_m64n64_rs(d, qa[kk], hop::desc_add(dk, kk * 32));
  }
}

// Int8Qk: si = q_i8·k_i8ᵀ (s8 wgmma, A from registers: the two k32 steps
// of d = 64, the first overwriting si; K the stage's int8 K-major tile,
// 64B-swizzled), issued.
template <int W>
__device__ __forceinline__ void issue_qk_i8(int (&si)[W / 2], const uint32_t (&qa)[4][4],
                                            const uint8_t* kt) {
  const uint64_t dk = hop::sw64_desc(kt);
  hop::wgmma_s8_rs<W>(si, qa[0], dk, true);
  hop::wgmma_s8_rs<W>(si, qa[1], hop::desc_add(dk, 32), false);
}

// Int8Qk: the logits of a tile of W keys from its landed s32 products si
// (the accumulator layout: si[4j + e] is key 8j + 2t + (e & 1) of row
// g + 8(e >> 1)), ((f32(si) · sq) · sk) + bias with one rounding per
// operation, or -inf for a key that is masked or past N.  sq0, sq1: the
// thread's two rows' scales times the softmax scale; ks: the stage's key
// scales; b0, b1, lo, hi as init_logits takes them.
template <int W>
__device__ __forceinline__ void logits_i8(float (&s)[32], const int (&si)[W / 2], float sq0,
                                          float sq1, const float* ks, const float* b0,
                                          const float* b1, uint32_t lo, uint32_t hi) {
  const int t = threadIdx.x & 3;
  auto dq = [](int x, float sq, float sk, float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn(s32_to_f32(x), sq), sk), b);
  };
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const bool v0 = (lo >> (4 * j + t)) & 1, v1 = (hi >> (4 * j + t)) & 1;
    const float2 k = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * t);
    s[4 * j] = v0 ? dq(si[4 * j], sq0, k.x, b0[8 * j]) : -INFINITY;
    s[4 * j + 1] = v1 ? dq(si[4 * j + 1], sq0, k.y, b0[8 * j + 1]) : -INFINITY;
    s[4 * j + 2] = v0 ? dq(si[4 * j + 2], sq1, k.x, b1[8 * j]) : -INFINITY;
    s[4 * j + 3] = v1 ? dq(si[4 * j + 3], sq1, k.y, b1[8 * j + 1]) : -INFINITY;
  }
}

// Int8Qk: the warp's 16 query rows (this thread's g and g + 8 of them) from
// the swizzled q tile, quantized per row as quant_rows quantizes them
// (quantize_alu: no F2I), as the s8 A fragments of the two k32 steps
// (qa[kk][0]: row g at columns 32kk + 4t.., [1] row g + 8, [2] and [3] the
// same at 32kk + 16 + 4t..), and the rows' scales times the softmax scale.
// A row's 64 columns are spread over the 4 threads of a group.
__device__ __forceinline__ void quant_q(uint32_t (&qa)[4][4], float& sq0, float& sq1,
                                        const uint8_t* qs, int wr, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float v[2][16], sc[2], inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = wr + g + 8 * e;
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // columns 16c + 4t..: 8 bytes of one 16-byte chunk
      const int col = 16 * c + 4 * t;
      const uint2 raw = *reinterpret_cast<const uint2*>(
          qs + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        v[e][4 * c + x] = __bfloat162float(h[x]);
        amax = fmaxf(amax, fabsf(v[e][4 * c + x]));
      }
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, sh));
    sc[e] = quant_scale(amax);
    inv[e] = __frcp_rn(sc[e]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qa[c >> 1][e + 2 * (c & 1)] = pack_s8x4(
          quantize_alu(v[e][4 * c], inv[e]), quantize_alu(v[e][4 * c + 1], inv[e]),
          quantize_alu(v[e][4 * c + 2], inv[e]), quantize_alu(v[e][4 * c + 3], inv[e]));
  sq0 = __fmul_rn(sc[0], scale);
  sq1 = __fmul_rn(sc[1], scale);
}

// Int8Qk, run by the producer's 128 threads once a stage's bf16 k tile has
// landed (kfull): the tile quantized in place, key r = pt / 2 by threads 2r
// and 2r + 1 (32 columns each, read twice: for the row's amax, then to
// quantize, so that few registers hold them), into the int8 K-major tile
// at its start, 64B-swizzled for sw64_desc, and the keys' scales at
// I8_SCALES (quantize_alu: no F2I); then those writes ordered before the
// consumers' wgmma reads them (async proxy), and an arrival on the stage's
// full barrier.
__device__ __forceinline__ void quant_k(uint8_t* kt, uint64_t* kfull, uint32_t parity,
                                        uint64_t* full, int pt) {
  hop::mbar_wait(kfull, parity);
  const int r = pt >> 1, half = pt & 1;
  auto chunk = [&](int c) {  // 16-byte chunk 4·half + c of row r, 128B-swizzled
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(kt + r * 128 + (((4 * half + c) ^ (r & 7)) << 4));
    return p;
  };
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const Pack8 p = chunk(c);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(p.f(e)));
  }
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  const float sc = quant_scale(amax), inv = __frcp_rn(sc);
  uint32_t w[8];  // the row's 32 int8 values, 4 a word
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const Pack8 p = chunk(c);
    w[2 * c] = pack_s8x4(quantize_alu(p.f(0), inv), quantize_alu(p.f(1), inv),
                         quantize_alu(p.f(2), inv), quantize_alu(p.f(3), inv));
    w[2 * c + 1] = pack_s8x4(quantize_alu(p.f(4), inv), quantize_alu(p.f(5), inv),
                             quantize_alu(p.f(6), inv), quantize_alu(p.f(7), inv));
  }
  hop::named_sync(kQuantBarrier, PRODUCERS);  // every thread's reads of the bf16 tile are done
#pragma unroll
  for (int j = 0; j < 2; ++j)  // int8 chunk 2·half + j of row r
    *reinterpret_cast<uint4*>(kt + r * 64 + (((2 * half + j) ^ ((r >> 1) & 3)) << 4)) =
        make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  if (half == 0) reinterpret_cast<float*>(kt + I8_SCALES)[r] = sc;
  hop::fence_proxy_async();
  hop::mbar_arrive(full);
}

// o += bf16(p)·v (wgmma, P from registers, V an MN-major tile), issued.
template <int W>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[4][4],
                                         const uint8_t* vt) {
  const uint64_t dv = hop::sw128_desc(vt);
#pragma unroll
  for (int kc = 0; kc < W / 16; ++kc)
    hop::wgmma_m64n64_rs_tb(o, pa[kc], hop::desc_add(dv, kc * 16 * 128));
}

// The online softmax of a tile's landed logits: the new running max and
// sum, p = exp(s - max) in s, and the factors a0, a1 by which the output
// accumulated so far is to be rescaled.  A row's keys are spread over the
// 4 threads of a group.
template <int W>
__device__ __forceinline__ void softmax(float (&s)[32], Rows& r, float& a0, float& a1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  // u·log2 e, u the running max (0 while a row has no valid key)
  const float ul0 = (mn0 == -INFINITY ? 0.f : mn0) * kLog2e;
  const float ul1 = (mn1 == -INFINITY ? 0.f : mn1) * kLog2e;
  a0 = ex2(r.m0 * kLog2e - ul0);
  a1 = ex2(r.m1 * kLog2e - ul1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], kLog2e, -ul0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], kLog2e, -ul0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], kLog2e, -ul1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], kLog2e, -ul1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, sh);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, sh);
  }
  r.l0 = r.l0 * a0 + sum0;
  r.l1 = r.l1 * a1 + sum1;
  r.m0 = mn0;
  r.m1 = mn1;
}

// p as bf16 P·V A fragments: the accumulator layout of s is the A layout.
template <int W>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < W / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// One key tile: its logits and q·kᵀ, issued ahead of the previous tile's
// P·V (when there is one, a whole 64-key tile: only the last tile is
// narrower), so that this tile's softmax runs while that P·V does; then,
// once the P·V is done, the rescale of the output and this tile's P.
// `retire` releases the previous tile's stage.  Int8Qk: the s32 product
// is dequantized into the logits once it has landed (sq0, sq1: the rows'
// scales; Bf16Qk ignores them).
template <class Qk, int NC, int W, bool kPrev, class Retire>
__device__ __forceinline__ void key_tile(Rows& r, uint32_t (&pa)[4][4], const uint32_t (&qa)[4][4],
                                         float sq0, float sq1, const uint8_t* st,
                                         const uint8_t* v_prev, uint32_t lo, uint32_t hi, int b0,
                                         int b1, Retire retire) {
  float s[32];
  // the W/2 logits of this tile (a narrow last tile leaves the rest of s
  // unwritten: naming them here would keep them live from tile to tile)
  [[maybe_unused]] float(&sw)[W / 2] = reinterpret_cast<float(&)[W / 2]>(s);
  const float* bt = reinterpret_cast<const float*>(st + 2 * KV_BYTES);
  [[maybe_unused]] int si[W / 2];  // Int8Qk's s32 products
  if constexpr (!Qk::kInt8) {
    init_logits<W>(s, bt + b0, bt + b1, lo, hi);
    hop::fence_regs(sw);
  }
  tensor_turn_begin<NC>();
  hop::wgmma_fence();
  if constexpr (Qk::kInt8)
    issue_qk_i8<W>(si, qa, st);
  else
    issue_qk<W>(s, qa, st);
  hop::wgmma_commit();
  if constexpr (kPrev) {
    issue_pv<64>(r.o, pa, v_prev);
    hop::wgmma_commit();
  }
  tensor_turn_end<NC>();
  if constexpr (kPrev)
    hop::wgmma_wait<1>();  // q·kᵀ done; the P·V may still run
  else
    hop::wgmma_wait<0>();
  if constexpr (Qk::kInt8) {
    hop::fence_regs(si);
    logits_i8<W>(s, si, sq0, sq1, reinterpret_cast<const float*>(st + I8_SCALES), bt + b0,
                 bt + b1, lo, hi);
  } else {
    hop::fence_regs(sw);
  }
  float a0, a1;
  softmax<W>(s, r, a0, a1);
  hop::wgmma_wait<0>();
  hop::fence_regs(r.o);
  retire();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    r.o[4 * n] *= a0;
    r.o[4 * n + 1] *= a0;
    r.o[4 * n + 2] *= a1;
    r.o[4 * n + 3] *= a1;
  }
  pack_p<W>(pa, s);
}

// Shared memory of a CTA of K2 (1024-aligned inside the dynamic block).
template <int NC>
struct Smem {
  uint8_t *qs, *ring;
  uint64_t *full, *empty, *q_full, *q_empty, *kfull;  // kfull: Int8Qk's alone
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    uint8_t* base = raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
    qs = base;
    ring = base + Cfg<NC>::RING;
    full = reinterpret_cast<uint64_t*>(base + Cfg<NC>::BAR);
    empty = full + STAGES;
    q_full = empty + STAGES;
    q_empty = q_full + 1;
    kfull = q_empty + 1;
  }
};

// Run by every thread of the CTA (THREADS) before its roles: the barriers.
template <int NC = 2, class Qk = Bf16Qk>
__device__ __forceinline__ void setup(unsigned char* raw) {
  const Smem<NC> sm(raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the K/V loads' arrival, the bias copiers' (and Int8Qk's quantizers')
      hop::mbar_init(&sm.full[s], 1 + PRODUCERS * (Qk::kInt8 ? 2 : 1));
      hop::mbar_init(&sm.empty[s], Cfg<NC>::CONSUMER_WARPS);
      if constexpr (Qk::kInt8) hop::mbar_init(&sm.kfull[s], 1);
    }
    hop::mbar_init(sm.q_full, 1);
    hop::mbar_init(sm.q_empty, Cfg<NC>::CONSUMER_WARPS);
    hop::fence_mbar_init();
  }
  __syncthreads();
}

// The items `its` deals this CTA: the producer role (warpgroup NC) and the
// consumer role (warpgroups 0 .. NC - 1).
template <int NC = 2, class It = Items, class M = Maps, class Qk = Bf16Qk>
__device__ __forceinline__ void produce(const M& maps, const Args& a, unsigned char* raw,
                                        const It& its = It()) {
  using K = Cfg<NC>;
  const Smem<NC> sm(raw);
  uint8_t *qs = sm.qs, *ring = sm.ring;
  uint64_t *full = sm.full, *empty = sm.empty, *q_full = sm.q_full, *q_empty = sm.q_empty,
           *kfull = sm.kfull;
  const int N = a.N, C = a.H * D, nkt = (N + BKV - 1) / BKV;
  // ---- producer, warpgroup NC: its first thread loads the Q tile and the
  // K/V tiles by TMA (where the layout policy M finds them); its 128
  // threads copy the bias tile by 16-byte cp.async (the rows of the
  // (H, N, N) bias start at any 4-byte offset, so a tensor map cannot
  // take them), each then arriving on the stage's barrier once its copies
  // have landed.  Chunks past a row's last key, and the rows past N, are
  // not copied: no consumer reads them into a stored row or a valid key.
  // A row's last chunk may reach 12 bytes past its last key, inside the
  // 16-byte granule that holds that key.  Int8Qk: k lands on its own
  // barrier, and the 128 threads quantize each key tile once it has landed
  // (one tile behind its loads measured slower: chip_profile.py --variants
  // K12).
  const int pt = threadIdx.x - K::CONSUMERS;
  int it = 0;
  for (int i = 0, item = its.first; item < a.items; ++i, item += its.stride) {
    int b, qt, h;
    its.decode(a, item, b, qt, h);
    const int rows = min(K::BQ, N - qt * K::BQ);
    if (pt == 0) {
      its.ready(b);
      if (i > 0) hop::mbar_wait(q_empty, (i - 1) & 1);
      hop::mbar_arrive_expect_tx(q_full, K::Q_BYTES);
      maps.load_q(qs, b, h, qt * K::BQ, C, q_full);
    }
    // this thread's chunks of every bias tile of the item: chunk idx =
    // pt + 128m is chunk idx % 17 of row idx / 17; key 0 of that row is
    // float f[m] of the bias (rows past N: none)
    size_t f[K::CHUNKS_PER_THREAD];
    int dst[K::CHUNKS_PER_THREAD];
#pragma unroll
    for (int m = 0; m < K::CHUNKS_PER_THREAD; ++m) {
      const int idx = pt + PRODUCERS * m, r = idx / BIAS_CHUNKS, c = idx % BIAS_CHUNKS;
      f[m] = r < rows ? ((size_t)h * N + qt * K::BQ + r) * N : ~(size_t)0;
      dst[m] = r * BIAS_LD + 4 * c;
    }
    for (int j = 0; j < nkt; ++j, ++it) {
      const int s = it % STAGES, k0 = j * BKV;
      if (it >= STAGES) hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      uint8_t* st = ring + s * K::STAGE;
      if (pt == 0) {
        if constexpr (Qk::kInt8) {
          hop::mbar_arrive_expect_tx(&kfull[s], KV_BYTES);
          hop::mbar_arrive_expect_tx(&full[s], KV_BYTES);
          maps.load_kv(st, st + KV_BYTES, b, h, k0, C, &kfull[s], &full[s]);
        } else {
          hop::mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
          maps.load_kv(st, st + KV_BYTES, b, h, k0, C, &full[s], &full[s]);
        }
      }
      float* bt = reinterpret_cast<float*>(st + 2 * KV_BYTES);
#pragma unroll
      for (int m = 0; m < K::CHUNKS_PER_THREAD; ++m) {
        // the chunk's first float: chunk dst[m] % 72 / 4 of the aligned span
        const size_t at = ((f[m] + k0) & ~(size_t)3) + (dst[m] % BIAS_LD);
        if (f[m] != ~(size_t)0 && at < f[m] + N) cp_async16(bt + dst[m], a.bias + at);
      }
      cp_async_arrive(&full[s]);
      if constexpr (Qk::kInt8) quant_k(st, &kfull[s], (it / STAGES) & 1, &full[s], pt);
    }
  }
}

template <int NC = 2, class It = Items, class Qk = Bf16Qk>
__device__ __forceinline__ void consume(const Args& a, unsigned char* raw, const It& its = It()) {
  using K = Cfg<NC>;
  const Smem<NC> sm(raw);
  const uint8_t* qs = sm.qs;
  const uint8_t* ring = sm.ring;
  uint64_t *full = sm.full, *empty = sm.empty, *q_full = sm.q_full, *q_empty = sm.q_empty;
  const int N = a.N, C = a.H * D, nkt = (N + BKV - 1) / BKV;
  // the width of the last key tile's products: its keys rounded up to 16, 32 or 64
  const int w_last = N - (nkt - 1) * BKV > 32 ? 64 : N - (nkt - 1) * BKV > 16 ? 32 : 16;
  // ---- consumers: warpgroup wg owns query rows 64wg.. of the item's 128
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 64 * wg + 16 * (warp & 3);  // the warp's first row in the item
  const float qscale = __bfloat162float(__float2bfloat16(a.scale));
  if (NC == 2 && wg == 1) hop::named_arrive(1, 256);  // warpgroup 0 takes the first turn
  int it = 0;
  for (int i = 0, item = its.first; item < a.items; ++i, item += its.stride) {
    int b, qt, h;
    its.decode(a, item, b, qt, h);
    const int q0 = qt * K::BQ;

    // the warp's 16 query rows as A fragments for every key tile: scaled in
    // bf16, or (Int8Qk) quantized, with their rows' scales sq0, sq1
    uint32_t qa[4][4];
    float sq0 = 0.f, sq1 = 0.f;
    hop::mbar_wait(q_full, i & 1);
    if constexpr (Qk::kInt8) {
      quant_q(qa, sq0, sq1, qs, wr, a.scale);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wr + g + 8 * (e & 1), col = 16 * kk + 2 * t + 8 * (e >> 1);
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              qs + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
          const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&v);
          qa[kk][e] = pack_bf16(__low2float(h2) * qscale, __high2float(h2) * qscale);
        }
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(q_empty);

    Rows r;
#pragma unroll
    for (int n = 0; n < 32; ++n) r.o[n] = 0.f;
    r.m0 = r.m1 = -INFINITY;
    r.l0 = r.l1 = 0.f;
    uint32_t pa[4][4];
    int prev = 0;  // the stage of the previous key tile, released once its P·V is done
    const int* mask_b = a.mask + (size_t)b * N;
    // where this thread's two rows' keys k0 + 2t sit in a bias tile: row
    // offset plus the row's key 0 modulo 4 floats (k0 is a multiple of 64)
    auto bias_at = [&](int row) {
      return row * BIAS_LD + (int)((((size_t)h * N + q0 + row) * N) & 3) + 2 * t;
    };
    const int boff0 = bias_at(wr + g), boff1 = bias_at(wr + g + 8);
    // the mask of keys k0 + 2·lane and + 1 of tile j, loaded a tile ahead
    auto mask_at = [&](int j, int e) {
      const int k = j * BKV + 2 * lane + e;
      return k < N ? mask_b[k] : 0;
    };
    int m0 = mask_at(0, 0), m1 = mask_at(0, 1);
    // tile j: its key validity bits, its landed stage, then key_tile<W, j > 0>
    auto tile = [&](auto width, auto after_first, int j) {
      const int s = it % STAGES;
      const uint32_t lo = __ballot_sync(0xffffffffu, m0 > 0), hi = __ballot_sync(0xffffffffu, m1 > 0);
      m0 = mask_at(j + 1, 0);
      m1 = mask_at(j + 1, 1);
      hop::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* st = ring + s * K::STAGE;
      const uint8_t* v_prev = ring + prev * K::STAGE + KV_BYTES;  // j > 0
      auto retire = [&] {
        if (decltype(after_first)::value && lane == 0) hop::mbar_arrive(&empty[prev]);
        prev = s;
      };
      key_tile<Qk, NC, decltype(width)::value, decltype(after_first)::value>(
          r, pa, qa, sq0, sq1, st, v_prev, lo, hi, boff0, boff1, retire);
      ++it;
    };
    // The tiles before the last are 64 keys wide; the last one's products
    // take its keys rounded up to 16, 32 or 64.  The branch on that width
    // stays outside the loop: one inside it makes ptxas serialize every
    // wgmma of the kernel.
    using W64 = std::integral_constant<int, 64>;
    using First = std::false_type;
    using Later = std::true_type;
#pragma unroll 1
    for (int j = 0; j + 1 < nkt; ++j) {
      if (j == 0)
        tile(W64{}, First{}, j);
      else
        tile(W64{}, Later{}, j);
    }
    if (nkt == 1) {
      if (w_last == 64)
        tile(W64{}, First{}, 0);
      else if (w_last == 32)
        tile(std::integral_constant<int, 32>{}, First{}, 0);
      else
        tile(std::integral_constant<int, 16>{}, First{}, 0);
    } else {
      if (w_last == 64)
        tile(W64{}, Later{}, nkt - 1);
      else if (w_last == 32)
        tile(std::integral_constant<int, 32>{}, Later{}, nkt - 1);
      else
        tile(std::integral_constant<int, 16>{}, Later{}, nkt - 1);
    }
    // the last tile's P·V
    const uint8_t* v_last = ring + prev * K::STAGE + KV_BYTES;
    tensor_turn_begin<NC>();
    hop::wgmma_fence();
    if (w_last == 64)
      issue_pv<64>(r.o, pa, v_last);
    else if (w_last == 32)
      issue_pv<32>(r.o, pa, v_last);
    else
      issue_pv<16>(r.o, pa, v_last);
    hop::wgmma_commit();
    tensor_turn_end<NC>();
    hop::wgmma_wait<0>();
    hop::fence_regs(r.o);
    if (lane == 0) hop::mbar_arrive(&empty[prev]);

    // the context o / l in bf16 (rows past N are not stored), and the
    // training launch's statistics
    const int row0 = q0 + wr + g, row1 = row0 + 8;
    bf16* ob = a.out + (size_t)b * N * C + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (row0 < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + n * 8) =
            __floats2bfloat162_rn(r.o[4 * n] / r.l0, r.o[4 * n + 1] / r.l0);
      if (row1 < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + n * 8) =
            __floats2bfloat162_rn(r.o[4 * n + 2] / r.l1, r.o[4 * n + 3] / r.l1);
    }
    if (a.stats != nullptr && t == 0) {
      const size_t srow = ((size_t)b * a.H + h) * N, plane = (size_t)a.B * a.H * N;
      if (row0 < N) {
        a.stats[srow + row0] = r.m0;
        a.stats[plane + srow + row0] = r.l0;
      }
      if (row1 < N) {
        a.stats[srow + row1] = r.m1;
        a.stats[plane + srow + row1] = r.l1;
      }
    }
  }
  if (NC == 2 && wg == 0) hop::named_sync(1, 256);  // the grant after warpgroup 1's last turn
}


// Invalidate the barriers, once every thread of the CTA is past its role (a
// persistent kernel, K7, then uses the shared memory for something else).
template <int NC = 2>
__device__ __forceinline__ void invalidate(unsigned char* raw) {
  uint64_t* bars = Smem<NC>(raw).full;
  for (int i = 0; i < kBarriers; ++i) hop::mbar_inval(&bars[i]);
}

// The host side of a launch of a kernel that runs these roles over a
// packed qkv with the Maps layout, `smem` bytes of shared memory a CTA (K2's
// own, K12's): the tensor maps, the items, and a persistent grid of one CTA
// per SM, as many as fit (counted once into `ctas`).  stats: as
// vlm_packed_attention takes it, or null.
template <class Kernel>
int launch_packed(Kernel kernel, int smem, int& ctas, const void* qkv, const void* bias,
                  const void* mask, void* out, void* stats, int B, int N, int H, float scale,
                  void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) !=
            cudaSuccess ||
        per_sm <= 0) {
      cudaGetLastError();
      per_sm = 1;
    }
    ctas = sms * per_sm;
  }
  const uint64_t C3 = 3ull * H * D;
  Maps maps;
  if (!hop::make_tensor_map_3d(&maps.q, qkv, {C3, (uint64_t)N, (uint64_t)B}, C3 * 2, C3 * 2 * N,
                               {D, BQ, 1}) ||
      !hop::make_tensor_map_3d(&maps.kv, qkv, {C3, (uint64_t)N, (uint64_t)B}, C3 * 2, C3 * 2 * N,
                               {D, BKV, 1}))
    return (int)cudaErrorNotSupported;
  const int nqt = (N + BQ - 1) / BQ, items = B * H * nqt;
  const Args a{static_cast<const float*>(bias), static_cast<const int*>(mask),
               static_cast<bf16*>(out), static_cast<float*>(stats), B, N, H, nqt, items, scale};
  const int grid = items < ctas ? items : ctas;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace k2
}  // namespace vlm
