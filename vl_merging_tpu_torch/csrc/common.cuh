// Shared pieces of the eval-block kernels (sm_90a, bf16 tensor cores).
//
// Conventions shared by every kernel here:
//   * activations and weights are bf16; LN parameters, biases and
//     LayerScale gammas are f32; every product accumulates in f32;
//   * weights stay in torch layout W (out, in), row-major, so a tile of W
//     rows is the column-major B operand of x·Wᵀ;
//   * shared-memory rows carry kPad bf16 of padding: a 16-row fragment
//     then starts on a 32-byte boundary (WMMA's alignment rule) and
//     consecutive rows start in different banks;
//   * the GEMM kernels (K1, K3) use WMMA fragments; the attention kernel
//     (K2) uses mma.sync directly, for its documented register layout.
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


}  // namespace vlm

extern "C" const char* vlm_error_string(int code);
