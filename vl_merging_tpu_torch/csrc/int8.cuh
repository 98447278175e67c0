// Shared pieces of the port's W8A8 int8 kernels (K12, K14, K15; sm_90a):
// the quantizers (all three) and the s32 -> f32 conversion of K12's
// logits.  The products run on wgmma (hopper.cuh).
//
// Quantization follows vl_merging_tpu/ops/int8.py exactly, with one
// rounding per operation (the __f*_rn intrinsics keep nvcc from
// contracting a product and a sum into one fma, which the plain twins,
// one PyTorch op per step, never do):
//   * an activation row of f32 values x gets scale = max(amax, 1e-8)/127
//     (IEEE division) and q = round-half-even(x · (1/scale)) with the
//     reciprocal correctly rounded; no clip, |x/scale| ≤ 127 by
//     construction (int8.py:100-109);
//   * s8·s8 products accumulate exactly in s32 (wgmma m64nNk32), and
//     dequantise as ((float(acc) · s) · ws) + b (int8.py:128-129).
#pragma once

#include "common.cuh"

namespace vlm {

// scale = max(amax, 1e-8) / 127; the 1e-8 is the f32 rounding of the
// double 1e-8, as the twins' Python literal becomes.
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, (float)1e-8), 127.f);
}

// round-half-even(x · inv) as an int8 value in an int (|x · inv| ≤ 127)
__device__ __forceinline__ int quantize(float x, float inv) {
  return __float2int_rn(__fmul_rn(x, inv));
}

// quantize() on the FP32 and integer pipes (F2I runs at a quarter of the
// FP32 rate): x·inv + 1.5·2^23 rounds to an integer, ties to even, since
// its ulp is 1; exact for |x·inv| < 2^22.  K12's quantizers.
__device__ __forceinline__ int quantize_alu(float x, float inv) {
  return __float_as_int(__fadd_rn(__fmul_rn(x, inv), 12582912.f)) - 0x4B400000;
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

// float(x) for |x| < 2^22, exactly, on the integer and FP32 pipes: the bits
// of x + 1.5·2^23 as a float, less 1.5·2^23.  (I2F runs at a quarter of
// the FP32 rate on sm_90, as MUFU does.)  K12's s32 logits, |q·k| ≤
// 127²·64 < 2^20, take it; K14's and K15's sums over C may not.
__device__ __forceinline__ float s32_to_f32(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);
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
