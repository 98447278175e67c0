// Shared pieces of the port's kernels (sm_90a, bf16 tensor cores).
//
// Conventions shared by every kernel here:
//   * activations and weights are bf16; LN parameters, biases and
//     LayerScale gammas are f32; every product accumulates in f32;
//   * weights stay in torch layout W (out, in), row-major, so a tile of W
//     rows is the column-major B operand of x·Wᵀ;
//   * shared-memory rows of the mma.sync kernels carry kPad bf16 of
//     padding, so that consecutive rows start in different banks;
//   * the attention helpers (K12, and K9's products along a tile) use
//     mma.sync directly, for its documented register layout; K1, K2, K7,
//     K8, K10, K11, K14, K15, the MLP body of K3, K4, K5, K6, K7 and K13
//     (mlp_body.cuh) and K9's q·kᵀ-type products use wgmma (hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vlm {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;          // bf16 elements of padding per smem row

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

// One warp's step of the flash-style attention of K12 over
// one 64-key tile (kAttnKeys keys of kAttnDim values, rows kAttnLdt apart in
// shared memory).  s holds the warp's 16 x 64 f32 logits in the m16n8
// accumulator layout (rows g and g + 8 of the thread's group); m and l are
// the running row maxima and sums, o the running 16 x 64 output.  The
// softmax is online: exp(s - running max) is rounded to bf16 and
// contracted with the V tile at once; the division by l comes at the end
// (store_ctx_rows).
constexpr int kAttnDim = 64, kAttnKeys = 64, kAttnLdt = kAttnDim + kPad;

// The logits of a 64-key tile before q·kᵀ: the f32 bias of the thread's
// rows (brow0, brow1: the bias rows at the tile's first key) or -inf for a
// key that is masked or past N (kv[c] == 0).
__device__ __forceinline__ void logits_from_bias(float (&s)[kAttnKeys / 8][4],
                                                 const int* kv, const float* brow0,
                                                 const float* brow1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kAttnKeys / 8; ++j) {
    const int c = j * 8 + 2 * t;
    const bool v0 = kv[c], v1 = kv[c + 1];
    s[j][0] = v0 ? __ldg(brow0 + c) : -INFINITY;
    s[j][1] = v1 ? __ldg(brow0 + c + 1) : -INFINITY;
    s[j][2] = v0 ? __ldg(brow1 + c) : -INFINITY;
    s[j][3] = v1 ? __ldg(brow1 + c + 1) : -INFINITY;
  }
}

// s += q·kᵀ for the warp's 16 query rows (A fragments qa, bf16, scaled)
// against a 64-key tile Kt in shared memory (rows kAttnLdt apart).
__device__ __forceinline__ void add_qk_bf16(float (&s)[kAttnKeys / 8][4],
                                            const uint32_t (&qa)[kAttnDim / 16][4],
                                            const bf16* Kt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kAttnKeys / 8; ++j) {
    const bf16* krow = Kt + (j * 8 + g) * kAttnLdt + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kAttnDim / 16; ++kk)
      mma16816(s[j], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
  }
}

__device__ __forceinline__ void online_softmax_pv(float (&s)[kAttnKeys / 8][4],
                                                  float (&o)[kAttnDim / 8][4], float& m0,
                                                  float& m1, float& l0, float& l1,
                                                  const bf16* Vt) {
  const int lane = threadIdx.x & 31;
  // a row's 64 keys are spread over the 4 threads of a group
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kAttnKeys / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float u0 = mn0 == -INFINITY ? 0.f : mn0;  // no valid key yet
  const float u1 = mn1 == -INFINITY ? 0.f : mn1;
  const float a0 = expf(m0 - u0), a1 = expf(m1 - u1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kAttnKeys / 8; ++j) {
    s[j][0] = expf(s[j][0] - u0);
    s[j][1] = expf(s[j][1] - u0);
    s[j][2] = expf(s[j][2] - u1);
    s[j][3] = expf(s[j][3] - u1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, sh);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, sh);
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int n = 0; n < kAttnDim / 8; ++n) {
    o[n][0] *= a0;
    o[n][1] *= a0;
    o[n][2] *= a1;
    o[n][3] *= a1;
  }

  // o += bf16(p) · v; the accumulator layout of s is the A layout of p
#pragma unroll
  for (int kc = 0; kc < kAttnKeys / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                            pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                            pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                            pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int np = 0; np < kAttnDim / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, Vt + (kc * 16 + (lane & 15)) * kAttnLdt + np * 16 + (lane >> 4) * 8);
      mma16816(o[2 * np], pa, vb[0], vb[1]);
      mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
}

// The context of the thread's query rows qrow0 and qrow0 + 8 (rows past N
// are not stored): o / l rounded to bf16, at out_row0 = the context's
// column of this head (+ 2t) in row 0, rows ld apart.
__device__ __forceinline__ void store_ctx_rows(const float (&o)[kAttnDim / 8][4], float l0,
                                               float l1, bf16* out_row0, size_t ld, int qrow0,
                                               int N) {
  const int qrow1 = qrow0 + 8;
#pragma unroll
  for (int n = 0; n < kAttnDim / 8; ++n) {
    if (qrow0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out_row0 + (size_t)qrow0 * ld + n * 8) =
          __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    if (qrow1 < N)
      *reinterpret_cast<__nv_bfloat162*>(out_row0 + (size_t)qrow1 * ld + n * 8) =
          __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
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
