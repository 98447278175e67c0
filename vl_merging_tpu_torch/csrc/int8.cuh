// Shared pieces of the port's W8A8 int8 kernels (K12, K14, K15; sm_90a):
// the quantizers (all three) and K12's mma.sync product (K14 and K15 run
// theirs on wgmma, hopper.cuh).
//
// Quantization follows vl_merging_tpu/ops/int8.py exactly, with one
// rounding per operation (the __f*_rn intrinsics keep nvcc from
// contracting a product and a sum into one fma, which the plain twins,
// one PyTorch op per step, never do):
//   * an activation row of f32 values x gets scale = max(amax, 1e-8)/127
//     (IEEE division) and q = round-half-even(x · (1/scale)) with the
//     reciprocal correctly rounded; no clip, |x/scale| ≤ 127 by
//     construction (int8.py:100-109);
//   * s8·s8 products accumulate exactly in s32 (mma.sync m16n8k32 in K12,
//     wgmma m64nNk32 in K14 and K15), and dequantise as
//     ((float(acc) · s) · ws) + b (int8.py:128-129).
//
// K12's shared-memory int8 rows carry kPad8 bytes of padding: a row stride
// of K + 16 bytes (K a multiple of 64) puts the 32-bit fragment loads of 8
// rows x 4 threads in 32 distinct banks and keeps 16-byte alignment for
// cp.async.
#pragma once

#include "common.cuh"

namespace vlm {

constexpr int kPad8 = 16;

// d += a · b for one m16n8k32 tile of int8 (a: 16 x 32 row-major, b: 32 x 8
// col-major, d: s32).  Fragment layouts (PTX ISA, mma.m16n8k32): a[0]/a[1]
// are rows g / g+8 at k 4t..4t+3, a[2]/a[3] the same rows at k 16+4t..;
// b0/b1 are column g at k 4t.. and 16+4t..; d[0..1] row g, columns 2t,
// 2t+1, d[2..3] row g+8.  Byte for byte these are the bf16 m16n8k16
// layouts, so ld32 at the same byte offsets feeds them.
__device__ __forceinline__ void mma16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// scale = max(amax, 1e-8) / 127; the 1e-8 is the f32 rounding of the
// double 1e-8, as the twins' Python literal becomes.
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, (float)1e-8), 127.f);
}

// round-half-even(x · inv) as an int8 value in an int (|x · inv| ≤ 127)
__device__ __forceinline__ int quantize(float x, float inv) {
  return __float2int_rn(__fmul_rn(x, inv));
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ((float(acc) · s) · ws) + b, one rounding per operation
__device__ __forceinline__ float dequant(int acc, float s, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s), ws), b);
}

// One warp LayerNorms R rows of C = NV * 256 bf16 values (global or shared
// memory, 16-byte aligned; row i at src + i*src_step) in f32, as
// models/layers.layer_norm computes it (mean, then the mean of squared
// deviations, (x - mean) · rsqrt(var + eps) · w + b, one rounding per
// operation), and quantizes each f32 row per token into int8 dst + i*dst_step,
// its scale into scale[i * scale_step].  Rows i >= nvalid become zeros.
// dst(i, col) is where the 8 bytes of row i at columns col.. go (col a
// multiple of 8): a swizzled wgmma operand (K14, K15).
template <int R, int NV, class Dst>
__device__ __forceinline__ void ln_quant_rows_at(const bf16* src, size_t src_step, int nvalid,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ b, float eps, Dst dst,
                                                 float* scale, int scale_step) {
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
    float v[NV][8];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bf16* h = reinterpret_cast<const bf16*>(&raw[i][j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[j][e] = __bfloat162float(h[e]);
        s += v[j][e];
      }
    }
    const float mean = __fmul_rn(warp_sum(s), 1.f / C);
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(v[j][e], mean);
        var = __fadd_rn(var, __fmul_rn(d, d));
      }
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(var), 1.f / C), eps));
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (j * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[j][e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][e], mean), rstd), w[col + e]),
                            b[col + e]);
        amax = fmaxf(amax, fabsf(v[j][e]));
      }
    }
    const float sc = quant_scale(warp_max(amax));
    const float inv = __frcp_rn(sc);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      uint2 q = make_uint2(0u, 0u);
      if (i < nvalid) {
        q.x = pack_s8x4(quantize(v[j][0], inv), quantize(v[j][1], inv),
                        quantize(v[j][2], inv), quantize(v[j][3], inv));
        q.y = pack_s8x4(quantize(v[j][4], inv), quantize(v[j][5], inv),
                        quantize(v[j][6], inv), quantize(v[j][7], inv));
      }
      *reinterpret_cast<uint2*>(dst(i, (j * 32 + lane) * 8)) = q;
    }
    if (lane == 0) scale[i * scale_step] = sc;
  }
}

// The same without the LayerNorm: quantize R bf16 rows as they are.
template <int R, int NV, class Dst>
__device__ __forceinline__ void quant_rows_at(const bf16* src, size_t src_step, int nvalid,
                                              Dst dst, float* scale, int scale_step) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float v[NV][8];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      Pack8 p;
      p.u = i < nvalid ? *reinterpret_cast<const uint4*>(src + i * src_step + (j * 32 + lane) * 8)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[j][e] = p.f(e);
        amax = fmaxf(amax, fabsf(v[j][e]));
      }
    }
    const float sc = quant_scale(warp_max(amax));
    const float inv = __frcp_rn(sc);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      uint2 q;
      q.x = pack_s8x4(quantize(v[j][0], inv), quantize(v[j][1], inv), quantize(v[j][2], inv),
                      quantize(v[j][3], inv));
      q.y = pack_s8x4(quantize(v[j][4], inv), quantize(v[j][5], inv), quantize(v[j][6], inv),
                      quantize(v[j][7], inv));
      *reinterpret_cast<uint2*>(dst(i, (j * 32 + lane) * 8)) = q;
    }
    if (lane == 0) scale[i * scale_step] = sc;
  }
}

}  // namespace vlm
