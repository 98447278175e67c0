// K12, and the first-slice design of K2 it was built from: attention over
// packed qkv with an f32 relative-position bias and a key mask, writing the
// context in (B, N, C).  K2 itself is now packed_attention_fwd.cu (the
// Hopper design); this file keeps only the I8QK instantiation below.
//
// Replaces vl_merging_tpu/ops/attention.py:_packed_kernel (via
// _pallas_packed_attention / packed_fused_attention).  Per head:
// s = (q·scale)·kᵀ in f32 with q pre-scaled in bf16 (exact for 1/8),
// + bias[h] in f32, keys with mask <= 0 (or past N) at -inf, softmax in f32,
// P in bf16, P·v accumulated in f32, context rounded to bf16.  q, k and v
// are read in place from the packed qkv columns (q at 0, k at C, v at 2C,
// head h at h·64): no transpose into (3, B, H, N, d).
//
// The TPU kernel holds a whole (N, N) logits row tile in VMEM and
// normalises P before its bf16 cast.  Here a block owns one
// (batch, 64-query tile, head) cell and walks 64-key tiles with an online
// softmax (flash style), so the bf16 cast applies to exp(s - running max)
// before normalisation; the division by the row sum happens once, in f32,
// at the end.  That moves where P is rounded, not what is computed.  The
// bias enters as the initial value of the f32 accumulator of q·kᵀ, so it
// is summed with the products inside the tensor-core accumulation rather
// than after it: an f32 reordering.
//
// Bound on the H100: at B=32, N=577, 12 heads it is 32.7 GFLOP of
// tensor-core work against ~130 MB of qkv, context and bias traffic
// (~250 flops/byte, near the ridge), plus N² exps per head on the CUDA
// cores.  The (H, N, N) f32 bias (16 MB per layer) is re-read by every
// batch element; blockIdx.x walks the batch, so the B blocks that share a
// bias tile run together and find it in L2.  Each of the 4 warps owns 16
// query rows and keeps S, P and the running output in registers: the
// products are mma.sync m16n8k16 (bf16 in, f32 accumulate), whose
// fragment layouts are documented, so the softmax works on the
// accumulators in place and P feeds the P·V product without a trip
// through shared memory.  K and V tiles are double-buffered with
// cp.async.  The training launch also stores each query row's softmax
// statistics (running max m and sum l, f32, (2, B, H, N): 0.9 MB per layer
// at B = 32, N = 577, 12 heads) for the backward K9; the eval launch stores
// none and its arithmetic is the same.
//
// K12 (``I8QK``): the same kernel with QKᵀ as s8·s8→s32.  Replaces
// vl_merging_tpu/ops/attention.py:_packed_kernel_i8qk (via
// _pallas_packed_attention(qk_int8=True)), the opt-in int8-QK mode of the
// int8 eval.  q and k are quantized per (token, head) row of 64 (scale
// max(amax, 1e-8)/127, no clip; the TPU's zero pad of the depth to 128 is
// a tiling detail and is dropped), q once per block straight from device
// memory, each 64-key tile of k in shared memory right after it lands;
// the logits are ((float(si) · (sq·scale)) · sk) + bias in f32, one
// rounding per operation, and the softmax and P·V are K2's.  The int8
// tiles and their scales live beside K2's bf16 K/V ring (48 KB of static
// shared memory in all).  Bound: as K2, by bytes (~130 MB at B=32).
#include "int8.cuh"

using namespace vlm;

namespace {

constexpr int D = kAttnDim, BQ = 64, BKV = kAttnKeys, WARPS = 4, THREADS = WARPS * 32;
constexpr int LDT = kAttnLdt;  // bf16 tile stride: 144 bytes, conflict-free fragment loads
constexpr int LDI = D + kPad8;  // int8 tile stride: 80 bytes, conflict-free fragment loads

// Quantize 16 rows of 64 bf16 values (row i at src + i*ld; rows i >=
// nvalid read as zeros) per token into int8 dst + i*LDI, their scales
// (times mul) into scale[i].  One warp, two rows a step (lanes 0-15 row
// 2s, lanes 16-31 row 2s + 1), four values a lane; the 16 IEEE divisions
// and reciprocals of the scales run once, lane r for row r.
__device__ __forceinline__ void quant_rows16(const bf16* src, size_t ld, int nvalid,
                                             int8_t* dst, float* scale, float mul) {
  const int lane = threadIdx.x & 31, half = lane >> 4, c = (lane & 15) * 4;
  float v[8][4];
  float amax_row = 0.f;  // lane r < 16: the amax of row r
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int i = 2 * s + half;
    uint2 raw = make_uint2(0u, 0u);
    if (i < nvalid) raw = *reinterpret_cast<const uint2*>(src + i * ld + c);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
    float m = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[s][e] = __bfloat162float(h[e]);
      m = fmaxf(m, fabsf(v[s][e]));
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float row_m = __shfl_sync(0xffffffffu, m, (lane & 1) << 4);  // row 2s + (lane & 1)
    if ((lane >> 1) == s) amax_row = row_m;
  }
  const float sc = quant_scale(amax_row), inv = __frcp_rn(sc);
  if (lane < 16) scale[lane] = __fmul_rn(sc, mul);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int i = 2 * s + half;
    const float iv = __shfl_sync(0xffffffffu, inv, i);
    *reinterpret_cast<uint32_t*>(dst + i * LDI + c) =
        pack_s8x4(quantize(v[s][0], iv), quantize(v[s][1], iv), quantize(v[s][2], iv),
                  quantize(v[s][3], iv));
  }
}

// Start loading key tile [k0, k0 + BKV) of K and V into shared memory
// (rows past N are zeros) and record which of its keys are valid.
__device__ __forceinline__ void load_kv_tile(bf16* Kt, bf16* Vt, int* kvalid,
                                             const bf16* base, size_t ld, int C, int k0,
                                             int N, const int* __restrict__ mask_b) {
  for (int v = threadIdx.x; v < BKV * D / 8; v += THREADS) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    if (k0 + r < N) {
      const bf16* row = base + (size_t)(k0 + r) * ld + c;
      cp_async16(Kt + r * LDT + c, row + C);
      cp_async16(Vt + r * LDT + c, row + 2 * C);
    } else {
      *reinterpret_cast<uint4*>(Kt + r * LDT + c) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Vt + r * LDT + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (threadIdx.x < BKV)
    kvalid[threadIdx.x] = (k0 + (int)threadIdx.x < N) && mask_b[k0 + threadIdx.x] > 0;
}

// I8QK: K12 (int8 q·kᵀ) instead of K2 (bf16 q·kᵀ)
template <bool I8QK>
__global__ void __launch_bounds__(THREADS)
packed_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const int* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ stats, int B, int N, int H, float scale) {
  __shared__ __align__(128) bf16 Qs[I8QK ? 8 : BQ * LDT];
  __shared__ __align__(128) bf16 Ks[2][BKV * LDT];
  __shared__ __align__(128) bf16 Vs[2][BKV * LDT];
  __shared__ int kvalid[2][BKV];
  __shared__ __align__(16) int8_t Qi[I8QK ? BQ * LDI : 16];   // K12: int8 q, k tiles
  __shared__ __align__(16) int8_t Ki[I8QK ? BKV * LDI : 16];
  __shared__ float qscale_s[I8QK ? BQ : 1], kscale_s[I8QK ? BKV : 1];

  const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;
  const int C = H * D;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld + h * D;
  const int* mask_b = mask + (size_t)b * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group

  load_kv_tile(Ks[0], Vs[0], kvalid[0], base, ld, C, 0, N, mask_b);
  cp_async_commit();

  // the warp's 16 query rows as A fragments, for every key tile: K2 scales
  // them in bf16, K12 quantizes them (its row scales absorb the softmax
  // scale)
  uint32_t qa[D / 16][4];
  float qs0 = 0.f, qs1 = 0.f;
  if constexpr (I8QK) {
    const int left = N - (q0 + warp * 16);
    quant_rows16(base + (size_t)(q0 + warp * 16) * ld, ld, left, Qi + warp * 16 * LDI,
                 qscale_s + warp * 16, scale);
    __syncwarp();
    const int8_t* qw = Qi + warp * 16 * LDI;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      qa[kk][0] = ld32(qw + g * LDI + kk * 32 + 4 * t);
      qa[kk][1] = ld32(qw + (g + 8) * LDI + kk * 32 + 4 * t);
      qa[kk][2] = ld32(qw + g * LDI + kk * 32 + 4 * t + 16);
      qa[kk][3] = ld32(qw + (g + 8) * LDI + kk * 32 + 4 * t + 16);
    }
    qs0 = qscale_s[warp * 16 + g];
    qs1 = qscale_s[warp * 16 + g + 8];
  } else {
    const float qscale = __bfloat162float(__float2bfloat16(scale));
    for (int v = tid; v < BQ * D / 8; v += THREADS) {
      const int r = v / (D / 8), c = (v % (D / 8)) * 8;
      Pack8 p;
      p.u = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < N) {
        p.u = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ld + c));
#pragma unroll
        for (int e = 0; e < 8; ++e) p.h()[e] = __float2bfloat16(p.f(e) * qscale);
      }
      *reinterpret_cast<uint4*>(Qs + r * LDT + c) = p.u;
    }
    __syncthreads();
    const bf16* qw = Qs + warp * 16 * LDT;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld32(qw + g * LDT + kk * 16 + 2 * t);
      qa[kk][1] = ld32(qw + (g + 8) * LDT + kk * 16 + 2 * t);
      qa[kk][2] = ld32(qw + g * LDT + kk * 16 + 2 * t + 8);
      qa[kk][3] = ld32(qw + (g + 8) * LDT + kk * 16 + 2 * t + 8);
    }
  }

  // this thread's two query rows: g and g + 8 of the warp's 16
  const int qrow0 = q0 + warp * 16 + g, qrow1 = qrow0 + 8;
  const float* brow0 = bias + ((size_t)h * N + min(qrow0, N - 1)) * N;  // rows past N
  const float* brow1 = bias + ((size_t)h * N + min(qrow1, N - 1)) * N;  // are not stored
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int ntiles = (N + BKV - 1) / BKV;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BKV, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it is visible; every warp is done with tile it - 1
    if (it + 1 < ntiles)
      load_kv_tile(Ks[st ^ 1], Vs[st ^ 1], kvalid[st ^ 1], base, ld, C, k0 + BKV, N, mask_b);
    cp_async_commit();
    const bf16* Kt = Ks[st];
    const bf16* Vt = Vs[st];
    const int* kv = kvalid[st];
    if constexpr (I8QK) {  // quantize the landed key tile, 16 rows a warp
      quant_rows16(Kt + warp * 16 * LDT, LDT, 16, Ki + warp * 16 * LDI, kscale_s + warp * 16,
                   1.f);
      __syncthreads();
    }

    // s starts as bias (or -inf for an invalid key), then += q·kᵀ; K12
    // adds its dequantized s32 products to the bias instead
    float s[BKV / 8][4];
    logits_from_bias(s, kv, brow0 + k0, brow1 + k0);
    if constexpr (I8QK) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const int8_t* krow = Ki + (j * 8 + g) * LDI + 4 * t;
        int si[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          mma16832(si, qa[kk], ld32(krow + kk * 32), ld32(krow + kk * 32 + 16));
        const int c = j * 8 + 2 * t;
        const float ks0 = kscale_s[c], ks1 = kscale_s[c + 1];
        s[j][0] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(si[0]), qs0), ks0), s[j][0]);
        s[j][1] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(si[1]), qs0), ks1), s[j][1]);
        s[j][2] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(si[2]), qs1), ks0), s[j][2]);
        s[j][3] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(si[3]), qs1), ks1), s[j][3]);
      }
    } else {
      add_qk_bf16(s, qa, Kt);
    }

    online_softmax_pv(s, o, m0, m1, l0, l1, Vt);
  }

  store_ctx_rows(o, l0, l1, out + (size_t)b * N * C + h * D + 2 * t, C, qrow0, N);
  if (stats != nullptr && t == 0) {  // the training launch: each row's softmax max and sum
    const size_t row = ((size_t)b * H + h) * N, plane = (size_t)B * H * N;
    if (qrow0 < N) {
      stats[row + qrow0] = m0;
      stats[plane + row + qrow0] = l0;
    }
    if (qrow1 < N) {
      stats[row + qrow1] = m1;
      stats[plane + row + qrow1] = l1;
    }
  }
}

template <bool I8QK>
int launch(const void* qkv, const void* bias, const void* mask, void* out, void* stats, int B,
           int N, int H, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (N + BQ - 1) / BQ, H);
  packed_attention_kernel<I8QK><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const int*>(mask), static_cast<bf16*>(out), static_cast<float*>(stats), B, N,
      H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_packed_attention_i8qk(const void* qkv, const void* bias, const void* mask,
                                         void* out, int B, int N, int H, float scale,
                                         void* stream) {
  return launch<true>(qkv, bias, mask, out, nullptr, B, N, H, scale, stream);
}
