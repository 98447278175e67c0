// Shared pieces of the port's kernels (sm_90a, bf16 tensor cores).
//
// Conventions shared by every kernel here:
//   * activations and weights are bf16; LN parameters, biases and
//     LayerScale gammas are f32; every product accumulates in f32;
//   * weights stay in torch layout W (out, in), row-major, so a tile of W
//     rows is the column-major B operand of x·Wᵀ;
//   * the mma.sync helpers serve K9's products along a tile, for their
//     documented register layout; K1, K2, K7, K8, K10, K11, K12, K14, K15,
//     the MLP body of K3, K4, K5, K6, K7 and K13 (mlp_body.cuh) and K9's
//     q·kᵀ-type products use wgmma (hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vlm {

using bf16 = __nv_bfloat16;

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

// p, as a value the compiler cannot see through (an empty asm): a load
// from it stays where it is written.  The loads of a block's weights, whose
// addresses do not change from block to block, would otherwise be hoisted
// out of a persistent kernel's loop over blocks (K7's) and held in
// registers across it; they are what spilled the MLP body in a loop.
template <class T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// One warp normalises R rows of C = NV * 256 bf16 values at once (global
// or shared memory, 16-byte aligned): row i is src + i*src_step, and the 8
// values at column col of it go to dst(i, col) (a bf16*, 16-byte aligned);
// rows i >= nvalid are written as zeros.  All R rows' loads are in flight
// before the first reduction (kL2: through L2 only, for rows other CTAs
// wrote in this launch).  Mean and variance are f32 (two passes over the
// registers, as the reference's LN), and (x - mean) * rsqrt(var + eps) * w
// + b is rounded to bf16.
template <int R, int NV, bool kL2 = false, class Dst>
__device__ __forceinline__ void ln_rows_to_bf16_at(const bf16* src, size_t src_step, int nvalid,
                                                   const float* __restrict__ w,
                                                   const float* __restrict__ b, float eps,
                                                   Dst dst) {
  constexpr int C = NV * 256;
  const int lane = threadIdx.x & 31;
  uint4 raw[R][NV];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const uint4* p = reinterpret_cast<const uint4*>(src + i * src_step + (j * 32 + lane) * 8);
      raw[i][j] = i < nvalid ? (kL2 ? __ldcg(p) : *p) : make_uint4(0u, 0u, 0u, 0u);
    }
  float wv[NV][8], bv[NV][8];  // this lane's columns of w and b, the same for every row
  w = opaque(w);
  b = opaque(b);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wv[j][e] = __ldg(w + (j * 32 + lane) * 8 + e);
      bv[j][e] = __ldg(b + (j * 32 + lane) * 8 + e);
    }
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
          o.h()[e] = __float2bfloat16((__bfloat162float(h[e]) - mean) * rstd * wv[j][e] +
                                      bv[j][e]);
      }
      *reinterpret_cast<uint4*>(dst(i, col)) = o.u;
    }
  }
}

// The LN statistics of R rows of C = NV * 256 bf16 values (global memory,
// 16-byte aligned; row i at src + i*src_step, rows i >= nvalid skipped),
// computed by one warp with all R rows' loads in flight and, per row,
// exactly the arithmetic of ln_rows_to_bf16_at, so a kernel that normalises
// on the fly rounds as K1.
template <int R, int NV>
__device__ __forceinline__ void ln_rows_stats(const bf16* src, size_t src_step, int nvalid,
                                              float eps, float (&mean)[R], float (&rstd)[R]) {
  constexpr int C = NV * 256;
  const int lane = threadIdx.x & 31;
  uint4 raw[R][NV];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      raw[i][j] = i < nvalid ? __ldg(reinterpret_cast<const uint4*>(src + i * src_step +
                                                                     (j * 32 + lane) * 8))
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
    mean[i] = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bf16* h = reinterpret_cast<const bf16*>(&raw[i][j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __bfloat162float(h[e]) - mean[i];
        v += d * d;
      }
    }
    rstd[i] = rsqrtf(warp_sum(v) / C + eps);
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

// mma.sync helpers of K9, and bf16 pair packing.

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

// gelu with exact erf through CUDA's erff (max error 2 ulp): K3's, and so
// K5's, K6's and K7's, activation.
struct ErffGelu {
  __device__ __forceinline__ float operator()(float v) const {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  }
};

// gelu with the A&S 7.1.26 erf, as vl_merging_tpu/ops/mlp.py:_erf_gelu
// (K13, and K15 with gelu="erf").
struct ErfApproxGelu {
  __device__ __forceinline__ float operator()(float v) const {
    const float x = v * 0.70710678118654752f;
    const float ax = fabsf(x);
    const float t = 1.f / (1.f + 0.3275911f * ax);
    const float poly =
        ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
         0.254829592f) *
        t;
    const float y = 1.f - poly * expf(-ax * ax);
    const float erf_x = x > 0.f ? y : (x < 0.f ? -y : 0.f);
    return 0.5f * v * (1.f + erf_x);
  }
};

}  // namespace vlm

extern "C" const char* vlm_error_string(int code);
