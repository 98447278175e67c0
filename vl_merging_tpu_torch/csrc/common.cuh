// Shared pieces of the port's kernels (sm_90a, bf16 tensor cores).
//
// Conventions shared by every kernel here:
//   * activations and weights are bf16; LN parameters, biases and
//     LayerScale gammas are f32; every product accumulates in f32;
//   * weights stay in torch layout W (out, in), row-major, so a tile of W
//     rows is the column-major B operand of x·Wᵀ;
//   * shared-memory rows carry kPad bf16 of padding: a 16-row fragment
//     then starts on a 32-byte boundary (WMMA's alignment rule) and
//     consecutive rows start in different banks;
//   * the GEMM kernels (K1, K3, K13) use WMMA fragments; the attention
//     kernels (K2, K9) use mma.sync directly, for its documented register
//     layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace vlm {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
// B operand read from the rows of a torch-layout weight: B(k, n) = W(n, k).
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kPad = 8;          // bf16 elements of padding per smem row
constexpr int kGemmThreads = 256;  // 8 warps in the GEMM kernels

// Eight bf16 values packed for one 16-byte load or store.
struct Pack8 {
  uint4 u;
  __device__ __forceinline__ bf16* h() { return reinterpret_cast<bf16*>(&u); }
  __device__ __forceinline__ float f(int e) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&u)[e]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp normalises R rows of C = NV * 256 bf16 values at once (global
// or shared memory, 16-byte aligned): row i is src + i*src_step, written
// to dst + i*dst_step; rows i >= nvalid are written as zeros.  All R rows'
// loads are in flight before the first reduction.  Mean and variance are
// f32 (two passes over the registers, as the reference's LN), and
// (x - mean) * rsqrt(var + eps) * w + b is rounded to bf16.
template <int R, int NV>
__device__ __forceinline__ void ln_rows_to_bf16(const bf16* src, size_t src_step, int nvalid,
                                                const float* __restrict__ w,
                                                const float* __restrict__ b, float eps,
                                                bf16* dst, int dst_step) {
  constexpr int C = NV * 256;
  const int lane = threadIdx.x & 31;
  uint4 raw[R][NV];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      raw[i][j] = i < nvalid ? *reinterpret_cast<const uint4*>(src + i * src_step +
                                                                (j * 32 + lane) * 8)
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bf16* h = reinterpret_cast<const bf16*>(&raw[i][j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += __bfloat162float(h[e]);
    }
    const float mean = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bf16* h = reinterpret_cast<const bf16*>(&raw[i][j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __bfloat162float(h[e]) - mean;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (j * 32 + lane) * 8;
      const bf16* h = reinterpret_cast<const bf16*>(&raw[i][j]);
      Pack8 o;
      o.u = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvalid) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o.h()[e] = __float2bfloat16((__bfloat162float(h[e]) - mean) * rstd * w[col + e] +
                                      b[col + e]);
      }
      *reinterpret_cast<uint4*>(dst + i * dst_step + col) = o.u;
    }
  }
}

// Asynchronous 16-byte global -> shared copies (cp.async, sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying one NT x BK tile of W (columns [k0, k0 + BK)) into a stage.
template <int NT, int BK>
__device__ __forceinline__ void stage_w_tile(bf16* dst, const bf16* __restrict__ W, int ldw,
                                             int k0) {
  constexpr int LDB = BK + kPad, VPR = BK / 8;  // VPR: 16-byte vectors per row
  for (int v = threadIdx.x; v < NT * VPR; v += blockDim.x) {
    const int r = v / VPR, c = (v % VPR) * 8;
    cp_async16(dst + r * LDB + c, W + (size_t)r * ldw + k0 + c);
  }
}

// acc[MF][NF] += A · Wᵀ for one block of 8 warps, W streamed through a
// STAGES-deep ring of shared-memory tiles filled by cp.async.
//   A: the block's rows, bf16 in shared memory, row-major with stride lda,
//      holding the whole depth K (rows [wm*MF*16, (wm+1)*MF*16) per warp);
//   W: torch-layout weight rows [0, NT) of the block's output tile, in
//      global memory with row stride ldw (NT = WARPS_N*NF*16);
//   Ws: STAGES tiles of NT x (BK + kPad).
// The warp grid is (8 / WARPS_N) x WARPS_N.  Requires K % BK == 0 and
// 16-byte aligned W rows.
//
// gemm_prefetch starts the first STAGES-1 tiles; call it only when no warp
// still reads Ws.  gemm_main runs the product; its first barrier also
// publishes whatever the block wrote to A between the two calls.
// gemm_smem_a does both behind a leading __syncthreads().
template <int NT, int BK, int STAGES>
__device__ __forceinline__ void gemm_prefetch(const bf16* __restrict__ W, int ldw, int K,
                                              bf16* Ws) {
  constexpr int TILE = NT * (BK + kPad);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s * BK < K) stage_w_tile<NT, BK>(Ws + s * TILE, W, ldw, s * BK);
    cp_async_commit();
  }
}

template <int MF, int NF, int WARPS_N, int BK, int STAGES>
__device__ __forceinline__ void gemm_main(FragC (&acc)[MF][NF], const bf16* As, int lda,
                                          const bf16* __restrict__ W, int ldw, int K,
                                          bf16* Ws) {
  constexpr int NT = WARPS_N * NF * 16;
  constexpr int LDB = BK + kPad, TILE = NT * LDB;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int kt = K / BK;
  for (int t = 0; t < kt; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    __syncthreads();              // everyone's did; tile t-1 is consumed
    const int tn = t + STAGES - 1;
    if (tn < kt) stage_w_tile<NT, BK>(Ws + (tn % STAGES) * TILE, W, ldw, tn * BK);
    cp_async_commit();
    const bf16* Wt = Ws + (t % STAGES) * TILE;
    const int k0 = t * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[MF];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * MF + i) * 16 * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragBt b;
        wmma::load_matrix_sync(b, Wt + (wn * NF + j) * 16 * LDB + kk, LDB);
#pragma unroll
        for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
}

template <int MF, int NF, int WARPS_N, int BK, int STAGES>
__device__ __forceinline__ void gemm_smem_a(FragC (&acc)[MF][NF], const bf16* As, int lda,
                                            const bf16* __restrict__ W, int ldw, int K,
                                            bf16* Ws) {
  __syncthreads();
  gemm_prefetch<WARPS_N * NF * 16, BK, STAGES>(W, ldw, K, Ws);
  gemm_main<MF, NF, WARPS_N, BK, STAGES>(acc, As, lda, W, ldw, K, Ws);
}

template <int MF, int NF>
__device__ __forceinline__ void zero_acc(FragC (&acc)[MF][NF]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// Epilogue access to an accumulator fragment: the warp stores it to its
// own 16x16 f32 scratch tile; lane l then owns row l/2, columns
// (l%2)*8 .. +8 of it (returned through row/col0).
__device__ __forceinline__ const float* frag_to_scratch(const FragC& f, float* scratch,
                                                        int& row, int& col0) {
  wmma::store_matrix_sync(scratch, f, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  row = lane >> 1;
  col0 = (lane & 1) * 8;
  return scratch + row * 16 + col0;
}

// mma.sync helpers of the attention kernels (K2, K9).

// d += a · b for one m16n8k16 tile (a: 16 x 16 row-major, b: 16 x 8 col-major).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four 8x8 bf16 matrices from shared memory, transposed (B operands of
// P·V from a row-major V tile).  Lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The MLP body of K3 and K13 for one block of kMlpRows rows: 8 warps, each
// covering all kMlpRows rows.  The (rows, Hd) f32 hidden never exists: the
// block walks the hidden dimension in kHiddenChunk-wide chunks, rounds each
// chunk's gelu(fc1 + b1) to bf16 into Hs, and contracts it at once with the
// matching kHiddenChunk columns of W2 into acc (f32, registers, kept over the
// whole MLP).  Weight tiles stream through cp.async rings in Ws (fc1: 6-deep
// 128 x 64 tiles; fc2: double-buffered C x 32 tiles).  Only the f32
// summation order of fc2 differs from a product over the whole hidden.
constexpr int kMlpRows = 32, kHiddenChunk = 128;
constexpr int kBkWide = 32, kStagesWide = 2;  // GEMMs over the model width
constexpr int kBkHid = 64, kStagesHid = 6;    // fc1 into one hidden chunk
constexpr int kMlpMF = kMlpRows / 16;
// staging area for weight tiles, in bf16 elements, for model widths <= 768
constexpr int kMlpStaging =
    kStagesWide * 768 * (kBkWide + kPad) > kStagesHid * kHiddenChunk * (kBkHid + kPad)
        ? kStagesWide * 768 * (kBkWide + kPad)
        : kStagesHid * kHiddenChunk * (kBkHid + kPad);

// Dynamic shared memory of a kernel built on mlp_hidden_chunks, for width C:
// the A rows, the hidden chunk, the weight staging and 8 warps' scratch.
__host__ __device__ constexpr size_t mlp_smem_bytes(int C) {
  return (size_t)(kMlpRows * (C + kPad) + kMlpRows * (kHiddenChunk + kPad) + kMlpStaging) *
             sizeof(bf16) +
         (kGemmThreads / 32) * 256 * sizeof(float);
}

// acc += gelu(As·W1ᵀ + b1)·W2ᵀ.  As holds the block's rows (bf16, stride
// lda); the first call's leading barrier publishes what the block wrote to
// As.  gelu maps an f32 pre-activation to the f32 value rounded into Hs.
template <int NF, class Gelu>
__device__ __forceinline__ void mlp_hidden_chunks(FragC (&acc)[kMlpMF][NF], const bf16* As,
                                                  int lda, const bf16* __restrict__ w1,
                                                  const float* __restrict__ b1,
                                                  const bf16* __restrict__ w2, int Hd, bf16* Hs,
                                                  bf16* Ws, float* sc, Gelu gelu) {
  constexpr int C = 8 * NF * 16, LDH = kHiddenChunk + kPad;
  static_assert(C <= 768, "the staging area is sized for C <= 768");
  const int warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < Hd; j0 += kHiddenChunk) {
    FragC hacc[kMlpMF][1];
    zero_acc(hacc);
    gemm_smem_a<kMlpMF, 1, 8, kBkHid, kStagesHid>(hacc, As, lda, w1 + (size_t)j0 * C, C, C, Ws);
    __syncthreads();  // every warp is done with the last W1 tile: W2's tiles may land
    gemm_prefetch<C, kBkWide, kStagesWide>(w2 + j0, Hd, kHiddenChunk, Ws);
#pragma unroll
    for (int i = 0; i < kMlpMF; ++i) {
      int r, c0;
      const float* v = frag_to_scratch(hacc[i][0], sc, r, c0);
      const int rr = i * 16 + r, col = warp * 16 + c0;
      Pack8 hv;
#pragma unroll
      for (int e = 0; e < 8; ++e) hv.h()[e] = __float2bfloat16(gelu(v[e] + b1[j0 + col + e]));
      *reinterpret_cast<uint4*>(Hs + rr * LDH + col) = hv.u;
      __syncwarp();
    }
    gemm_main<kMlpMF, NF, 8, kBkWide, kStagesWide>(acc, Hs, LDH, w2 + j0, Hd, kHiddenChunk, Ws);
  }
}


}  // namespace vlm

extern "C" const char* vlm_error_string(int code);
