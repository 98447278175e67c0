// The post-attention half of an eval block for one 32-row block, as two
// device functions shared by K3 (proj_mlp_tail.cu, both halves), K5
// (mlp_tail.cu, the second half) and K7 (block_eval.cu, both halves):
//   proj_residual_rows:   x' = bf16(res + γ1 ⊙ (ctx·Wpᵀ + bp))
//   ln_mlp_residual_rows: out = bf16(x' + γ2 ⊙ (bf16(gelu(bf16(LN2(x'))·W1ᵀ
//                         + b1))·W2ᵀ + b2))
// Every kernel that runs them rounds, sums and orders its products exactly
// as K3 does, so K4 → K5 and K7 can equal K3 bit for bit.  K6
// (tail_train.cu) runs both halves with per-element gammas: g_rows = N
// makes row r read γ row r / N of a (B, C) table; g_rows = 0 (every other
// caller) reads one γ for every row.
//
// Block: 8 warps, each covering all kMlpRows rows and 1/8 of the columns
// of the width C = 8 * NF * 16.  Dynamic shared memory: mlp_smem_bytes(C),
// laid out by TailSmem.
#pragma once

#include "common.cuh"

namespace vlm {

struct TailSmem {
  bf16* As;   // kMlpRows x (C + kPad): ctx rows, then LN2(x')
  bf16* Hs;   // kMlpRows x (kHiddenChunk + kPad): the gelu(fc1) chunk
  bf16* Ws;   // weight tile staging
  float* sc;  // this warp's 16 x 16 f32 scratch tile
  __device__ __forceinline__ TailSmem(unsigned char* smem, int C) {
    As = reinterpret_cast<bf16*>(smem);
    Hs = As + kMlpRows * (C + kPad);
    Ws = Hs + kMlpRows * (kHiddenChunk + kPad);
    sc = reinterpret_cast<float*>(Ws + kMlpStaging) + (threadIdx.x >> 5) * 256;
  }
};

// Rows [row0, row0 + kMlpRows) of x' = bf16(res + γ1 ⊙ (ctx·Wpᵀ + bp))
// into xout (rows past M are neither read nor stored).  ctx is read
// through L2 only (__ldcg): K7 writes it in the same launch.  The caller
// must make sure no warp still reads As or Ws.
template <int NF>
__device__ __forceinline__ void proj_residual_rows(const bf16* ctx, const bf16* __restrict__ res,
                                                   const bf16* __restrict__ wp,
                                                   const float* __restrict__ bp,
                                                   const float* __restrict__ g1, bf16* xout,
                                                   int M, int row0, const TailSmem& sm,
                                                   int g_rows = 0) {
  constexpr int C = 8 * NF * 16, LDA = C + kPad, MF = kMlpMF;
  const int warp = threadIdx.x >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // the first Wp tiles are in flight while the ctx rows load
  gemm_prefetch<C, kBkWide, kStagesWide>(wp, C, C, sm.Ws);
  for (int v = threadIdx.x; v < kMlpRows * C / 8; v += kGemmThreads) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(sm.As + r * LDA + c) =
        row0 + r < M ? __ldcg(reinterpret_cast<const uint4*>(ctx + (size_t)(row0 + r) * C + c))
                     : zero;
  }
  FragC acc[MF][NF];
  zero_acc(acc);
  gemm_main<MF, NF, 8, kBkWide, kStagesWide>(acc, sm.As, LDA, wp, C, C, sm.Ws);
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r, c0;
      const float* v = frag_to_scratch(acc[i][j], sm.sc, r, c0);
      const int rr = i * 16 + r, col = (warp * NF + j) * 16 + c0;
      if (row0 + rr < M) {
        const float* g = g_rows ? g1 + (size_t)((row0 + rr) / g_rows) * C : g1;
        Pack8 rs, x1;
        rs.u = __ldg(reinterpret_cast<const uint4*>(res + (size_t)(row0 + rr) * C + col));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x1.h()[e] = __float2bfloat16(rs.f(e) + (v[e] + bp[col + e]) * g[col + e]);
        *reinterpret_cast<uint4*>(xout + (size_t)(row0 + rr) * C + col) = x1.u;
      }
      __syncwarp();
    }
  }
}

// Rows [row0, row0 + kMlpRows) of out = bf16(x' + γ2 ⊙ MLP(LN2(x'))), x'
// read from xin (which may be out itself: K3 and K7 park x' in the output
// rows).  The caller must make sure that every row of x' is stored and
// that no warp still reads As, Hs or Ws.
template <int NF>
__device__ __forceinline__ void ln_mlp_residual_rows(
    const bf16* xin, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ g2, bf16* out, int M, int Hd,
    float eps, int row0, const TailSmem& sm, int g_rows = 0) {
  constexpr int C = 8 * NF * 16, LDA = C + kPad, MF = kMlpMF, WARPS = kGemmThreads / 32;
  const int warp = threadIdx.x >> 5;
  {  // warp w normalises rows w, w + 8, w + 16, w + 24 of x'
    const int left = M - (row0 + warp);
    ln_rows_to_bf16<kMlpRows / WARPS, NF / 2>(xin + (size_t)(row0 + warp) * C,
                                              (size_t)WARPS * C,
                                              left > 0 ? (left + WARPS - 1) / WARPS : 0, ln_w,
                                              ln_b, eps, sm.As + warp * LDA, WARPS * LDA);
  }

  // MLP over 128-wide hidden chunks; fc2 partials accumulate in acc
  FragC acc[MF][NF];
  zero_acc(acc);
  mlp_hidden_chunks<NF>(acc, sm.As, LDA, w1, b1, w2, Hd, sm.Hs, sm.Ws, sm.sc, ErffGelu());

  // fc2 bias + LayerScale + residual -> out
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r, c0;
      const float* v = frag_to_scratch(acc[i][j], sm.sc, r, c0);
      const int rr = i * 16 + r, col = (warp * NF + j) * 16 + c0;
      if (row0 + rr < M) {
        const float* g = g_rows ? g2 + (size_t)((row0 + rr) / g_rows) * C : g2;
        Pack8 x1, o;  // where xin is out, this lane stored exactly these x' values itself
        x1.u = *reinterpret_cast<const uint4*>(xin + (size_t)(row0 + rr) * C + col);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o.h()[e] = __float2bfloat16(x1.f(e) + (v[e] + b2[col + e]) * g[col + e]);
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + rr) * C + col) = o.u;
      }
      __syncwarp();
    }
  }
}

}  // namespace vlm
