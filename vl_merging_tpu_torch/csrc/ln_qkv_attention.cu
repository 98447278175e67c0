// K8: ctx = attention(LN(x)·W_qkvᵀ + b) with the f32 rel-pos bias and the
// key mask, the packed qkv never written to device memory.
//
// Replaces vl_merging_tpu/ops/attention.py:_ln_qkv_attn_kernel (via
// _pallas_ln_qkv_attention / ln_qkv_attention, with
// fused_block.py:_qkv_pair_ctx).  Rounding points as K1 → K2 (see the
// body below).
//
// Bound on the H100: by its arithmetic.  At B = 32, N = 577, C = 768, 12
// heads it needs 2·M·C·3C = 65.4 GFLOP of projections and 4·64·N·N·12 per
// element (32.7 GFLOP at B = 32) of attention, ~98 GFLOP, against the x
// read, the context write, the weights and the 16 MB bias (~75 MB).
// Design: one block of 8 warps per (batch element, head), blockIdx.x the
// element, so the 32 blocks that share a head's bias (1.3 MB) run together
// and find it in L2.  Each block keeps its head's k and v for all N rows in
// shared memory (184 KB: one block per SM) and recomputes the LN
// statistics; x is re-read from L2 by each of the 12 heads.  N <= 640.
//
// LN1 + one head's q/k/v projection + attention for one batch element, as
// the device function of one 256-thread block, one block per (element,
// head).  The packed qkv never exists outside shared memory and
// registers.
//
// What it computes, with K1 → K2's rounding points (the TPU kernels'
// contract, vl_merging_tpu/ops/fused_block.py:_qkv_pair_ctx): LN statistics
// in f32 with exactly K1's arithmetic (common.cuh:ln_rows_stats), the
// normalised row rounded to bf16, q/k/v = bf16(f32 products + bias), q
// scaled in bf16, logits, bias, mask and softmax in f32, P in bf16, the
// context rounded to bf16 (K2's step, common.cuh:online_softmax_pv).  The
// products run on mma.sync m16n8k16, 16-deep steps from k = 0 up, as K1's
// WMMA products do.
//
// Design.  The TPU kernel normalises x once per batch block and relies on
// its grid running the head pairs of a block in sequence
// (vl_merging_tpu/ops/attention.py:404-409); CUDA blocks run in no fixed
// order, so here a block owns one (element, head) and does its own LN:
//   1. the LN statistics of all N rows (four rows a warp at once) into
//      shared memory, and which keys are valid;
//   2. k and v of the head for all N rows, in 128-row tiles, into shared
//      memory where they stay: 2 x 640 x 72 bf16 (184 KB), so N <= 640;
//   3. per 128-row query tile, q of the head (each warp's 16 rows land in
//      the accumulator layout of m16n8, which is the A-fragment layout of
//      the q·kᵀ product: q never leaves registers), then K2's online
//      softmax over the resident 64-key tiles, and the context to out.
// Each projection streams x and the head's weight rows from L2 in 32-deep
// chunks: x normalised on the fly from the kept statistics into a
// 128 x 32 tile (the next chunk's x already in registers while this
// chunk's products run), the weight rows through a double-buffered
// cp.async ring.  x is read from L2 three times per (element, head):
// statistics, k/v, q.
#include "common.cuh"

namespace vlm {

constexpr int kQkvRows = 128;   // rows of a projection / query tile: 8 warps x 16
constexpr int kQkvBk = 32;      // depth of a projection chunk
constexpr int kQkvLdx = kQkvBk + kPad;
constexpr int kMaxKeys = 640;   // resident K/V rows (N <= kMaxKeys)

// Dynamic shared memory of ln_qkv_attention_block.
__host__ __device__ constexpr size_t ln_qkv_attention_smem_bytes() {
  return (size_t)(2 * kMaxKeys * kAttnLdt + kQkvRows * kQkvLdx + 2 * kQkvRows * kQkvLdx) *
             sizeof(bf16) +
         (size_t)2 * kMaxKeys * sizeof(float) + (size_t)kMaxKeys * sizeof(int);
}

// acc (the warp's 16 rows x NCOL columns, m16n8 accumulator layout) =
// bf16(LN(x rows [t0, t0 + 128)))·Wᵀ over the whole depth C, W's rows
// [0, NCOL/2) at w_lo and [NCOL/2, NCOL) at w_hi (row stride C).  Rows past
// N read as zeros.  Every thread of the block must call it.
template <int NCOL, int C>
__device__ __forceinline__ void qkv_project(float (&acc)[NCOL / 8][4], const bf16* __restrict__ xb,
                                            int t0, int N, const float* mean_s,
                                            const float* rstd_s, const float* __restrict__ ln_w,
                                            const float* __restrict__ ln_b,
                                            const bf16* __restrict__ w_lo,
                                            const bf16* __restrict__ w_hi, bf16* Xs, bf16* Ws) {
  constexpr int VPR = kQkvBk / 8, NK = C / kQkvBk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  auto stage_w = [&](int kc) {
    bf16* dst = Ws + (kc & 1) * kQkvRows * kQkvLdx;
    for (int v = tid; v < NCOL * VPR; v += kGemmThreads) {
      const int r = v / VPR, c = (v % VPR) * 8;
      const bf16* src = r < NCOL / 2 ? w_lo + (size_t)r * C : w_hi + (size_t)(r - NCOL / 2) * C;
      cp_async16(dst + r * kQkvLdx + c, src + kc * kQkvBk + c);
    }
    cp_async_commit();
  };

  // each thread carries XV 16-byte vectors of an x chunk; chunk kc + 1 is
  // loaded into registers while chunk kc's products run
  constexpr int XV = kQkvRows * VPR / kGemmThreads;
  static_assert(XV * kGemmThreads == kQkvRows * VPR, "whole vectors per thread");
  Pack8 xr[XV];
  auto load_x = [&](int kc) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * kGemmThreads, row = t0 + v / VPR;
      xr[i].u = row < N ? __ldg(reinterpret_cast<const uint4*>(
                              xb + (size_t)row * C + kc * kQkvBk + (v % VPR) * 8))
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  load_x(0);
  stage_w(0);  // the stage last read two chunks ago: every warp passed a barrier since
  for (int kc = 0; kc < NK; ++kc) {
    __syncthreads();  // every warp is done with Xs and with the other stage
    if (kc + 1 < NK) stage_w(kc + 1);
    else cp_async_commit();
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * kGemmThreads, r = v / VPR, c = (v % VPR) * 8;
      const int row = t0 + r, col = kc * kQkvBk + c;
      Pack8 o;
      o.u = make_uint4(0u, 0u, 0u, 0u);
      if (row < N) {
        const float mean = mean_s[row], rstd = rstd_s[row];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o.h()[e] =
              __float2bfloat16((xr[i].f(e) - mean) * rstd * ln_w[col + e] + ln_b[col + e]);
      }
      *reinterpret_cast<uint4*>(Xs + r * kQkvLdx + c) = o.u;
    }
    if (kc + 1 < NK) load_x(kc + 1);
    cp_async_wait<1>();
    __syncthreads();  // chunk kc of x and of W is in shared memory
    const bf16* Xw = Xs + warp * 16 * kQkvLdx;
    const bf16* Wt = Ws + (kc & 1) * kQkvRows * kQkvLdx;
#pragma unroll
    for (int kk = 0; kk < kQkvBk; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(Xw + g * kQkvLdx + kk + 2 * t);
      a[1] = ld32(Xw + (g + 8) * kQkvLdx + kk + 2 * t);
      a[2] = ld32(Xw + g * kQkvLdx + kk + 2 * t + 8);
      a[3] = ld32(Xw + (g + 8) * kQkvLdx + kk + 2 * t + 8);
#pragma unroll
      for (int n = 0; n < NCOL / 8; ++n) {
        const bf16* wrow = Wt + (n * 8 + g) * kQkvLdx + kk + 2 * t;
        mma16816(acc[n], a, ld32(wrow), ld32(wrow + 8));
      }
    }
  }
}

// The context of head h of one batch element: xb its (N, C) rows, mask_b
// its (N,) key mask, out_b its (N, C) context (this head's 64 columns are
// written).  wqkv (3C, C) and bqkv (3C) are the packed projection, bias
// the (H, N, N) f32 rel-pos bias.  Requires N <= kMaxKeys and
// ln_qkv_attention_smem_bytes() of dynamic shared memory; every thread of
// the block must call it.
template <int C>
__device__ __forceinline__ void ln_qkv_attention_block(
    const bf16* __restrict__ xb, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const bf16* __restrict__ wqkv, const float* __restrict__ bqkv, const float* __restrict__ bias,
    const int* __restrict__ mask_b, bf16* out_b, int h, int N, float scale, float eps,
    unsigned char* smem) {
  constexpr int NV = C / 256, D = kAttnDim, WARPS = kGemmThreads / 32;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kMaxKeys * kAttnLdt;
  bf16* Xs = Vs + kMaxKeys * kAttnLdt;
  bf16* Ws = Xs + kQkvRows * kQkvLdx;
  float* mean_s = reinterpret_cast<float*>(Ws + 2 * kQkvRows * kQkvLdx);
  float* rstd_s = mean_s + kMaxKeys;
  int* kvalid = reinterpret_cast<int*>(rstd_s + kMaxKeys);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // 1. LN statistics of every row (warp w: rows 4w .. 4w + 3, then 32
  //    rows on); valid keys
  constexpr int SR = 4;
  for (int r = warp * SR; r < N; r += WARPS * SR) {
    float mean[SR], rstd[SR];
    ln_rows_stats<SR, NV>(xb + (size_t)r * C, C, N - r, eps, mean, rstd);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < SR; ++i)
        if (r + i < N) {
          mean_s[r + i] = mean[i];
          rstd_s[r + i] = rstd[i];
        }
    }
  }
  for (int r = tid; r < kMaxKeys; r += kGemmThreads) kvalid[r] = r < N && mask_b[r] != 0;

  // 2. k and v of head h for every row, resident in shared memory; rows
  //    past N (up to the last 64-key tile) are zeros
  for (int t0 = 0; t0 < N; t0 += kQkvRows) {
    float acc[2 * D / 8][4];
    qkv_project<2 * D, C>(acc, xb, t0, N, mean_s, rstd_s, ln_w, ln_b,
                          wqkv + (size_t)(C + h * D) * C, wqkv + (size_t)(2 * C + h * D) * C,
                          Xs, Ws);
    const int r0 = t0 + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < 2 * D / 8; ++n) {
      const int col = (n % (D / 8)) * 8 + 2 * t;
      const float* bcol = bqkv + (n < D / 8 ? C : 2 * C) + h * D + col;
      bf16* dst = n < D / 8 ? Ks : Vs;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const __nv_bfloat162 kv =
            r < N ? __floats2bfloat162_rn(acc[n][2 * half] + bcol[0], acc[n][2 * half + 1] + bcol[1])
                  : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dst + r * kAttnLdt + col) = kv;
      }
    }
  }

  // 3. per query tile: q in registers, then K2's online softmax over the
  //    resident key tiles (the first barrier of qkv_project publishes K/V)
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  const int ntiles = (N + kAttnKeys - 1) / kAttnKeys;
  for (int t0 = 0; t0 < N; t0 += kQkvRows) {
    float acc[D / 8][4];
    qkv_project<D, C>(acc, xb, t0, N, mean_s, rstd_s, ln_w, ln_b, wqkv + (size_t)h * D * C,
                      wqkv + (size_t)(h * D + D / 2) * C, Xs, Ws);
    const int qrow0 = t0 + warp * 16 + g;
    if (t0 + warp * 16 >= N) continue;  // no barrier follows in this tile
    // q = bf16(bf16(acc + b) * bf16(scale)), as K1 stores it and K2 scales it
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // columns kk*16 + 2t (+8)
        const int n = 2 * kk + hf, col = n * 8 + 2 * t;
        const float b0 = bqkv[h * D + col], b1 = bqkv[h * D + col + 1];
        float q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          q[e] = __bfloat162float(__float2bfloat16(
                     __bfloat162float(__float2bfloat16(acc[n][e] + (e & 1 ? b1 : b0))) * qscale));
        // the A layout: [0] row g, [1] row g + 8 at columns 2t; [2], [3] at 2t + 8
        qa[kk][2 * hf] = pack_bf16(q[0], q[1]);
        qa[kk][2 * hf + 1] = pack_bf16(q[2], q[3]);
      }
    }

    const float* brow0 = bias + ((size_t)h * N + min(qrow0, N - 1)) * N;  // rows past N
    const float* brow1 = bias + ((size_t)h * N + min(qrow0 + 8, N - 1)) * N;  // are not stored
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = it * kAttnKeys;
      float s[kAttnKeys / 8][4];
      logits_from_bias(s, kvalid + k0, brow0 + k0, brow1 + k0);
      add_qk_bf16(s, qa, Ks + k0 * kAttnLdt);
      online_softmax_pv(s, o, m0, m1, l0, l1, Vs + k0 * kAttnLdt);
    }
    store_ctx_rows(o, l0, l1, out_b + h * D + 2 * t, C, qrow0, N);
  }
}

}  // namespace vlm

using namespace vlm;

namespace {

template <int C>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_qkv_attention_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                        const float* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ bias,
                        const int* __restrict__ mask, bf16* __restrict__ out, int N, float scale,
                        float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  ln_qkv_attention_block<C>(x + (size_t)b * N * C, ln_w, ln_b, wqkv, bqkv, bias,
                            mask + (size_t)b * N, out + (size_t)b * N * C, h, N, scale, eps,
                            smem);
}

}  // namespace

extern "C" int vlm_ln_qkv_attention(const void* x, const void* ln_w, const void* ln_b,
                                    const void* wqkv, const void* bqkv, const void* bias,
                                    const void* mask, void* out, int B, int N, int H,
                                    float scale, float eps, void* stream) {
  constexpr int C = 768;
  if (B <= 0 || N <= 0 || N > kMaxKeys || H * kAttnDim != C) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = ln_qkv_attention_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_attention_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_qkv_attention_kernel<C><<<dim3(B, H), kGemmThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(bias),
      static_cast<const int*>(mask), static_cast<bf16*>(out), N, scale, eps);
  return (int)cudaGetLastError();
}
