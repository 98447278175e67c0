// K2: attention over packed qkv with an f32 relative-position bias and a
// key mask, writing the context in (B, N, C).
//
// Replaces vl_merging_tpu/ops/attention.py:_packed_kernel (via
// _pallas_packed_attention / packed_fused_attention).  Per head:
// s = (q·scale)·kᵀ in f32 with q pre-scaled in bf16 (exact for 1/8),
// + bias[h] in f32, keys with mask 0 (or past N) at -inf, softmax in f32,
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
// cp.async.
#include "common.cuh"

using namespace vlm;

namespace {

constexpr int D = 64, BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int LDT = D + kPad;  // bf16 tile stride: 144 bytes, conflict-free fragment loads

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
    kvalid[threadIdx.x] = (k0 + (int)threadIdx.x < N) && mask_b[k0 + threadIdx.x] != 0;
}

__global__ void __launch_bounds__(THREADS)
packed_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const int* __restrict__ mask, bf16* __restrict__ out, int N,
                        int H, float scale) {
  __shared__ __align__(128) bf16 Qs[BQ * LDT];
  __shared__ __align__(128) bf16 Ks[2][BKV * LDT];
  __shared__ __align__(128) bf16 Vs[2][BKV * LDT];
  __shared__ int kvalid[2][BKV];

  const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;
  const int C = H * D;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * ld + h * D;
  const int* mask_b = mask + (size_t)b * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group

  load_kv_tile(Ks[0], Vs[0], kvalid[0], base, ld, C, 0, N, mask_b);
  cp_async_commit();

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

  // the warp's 16 scaled query rows as A fragments, for every key tile
  uint32_t qa[D / 16][4];
  const bf16* qw = Qs + warp * 16 * LDT;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(qw + g * LDT + kk * 16 + 2 * t);
    qa[kk][1] = ld32(qw + (g + 8) * LDT + kk * 16 + 2 * t);
    qa[kk][2] = ld32(qw + g * LDT + kk * 16 + 2 * t + 8);
    qa[kk][3] = ld32(qw + (g + 8) * LDT + kk * 16 + 2 * t + 8);
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

    // s starts as bias (or -inf for an invalid key), then += q·kᵀ
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const bool v0 = kv[c], v1 = kv[c + 1];
      s[j][0] = v0 ? __ldg(brow0 + k0 + c) : -INFINITY;
      s[j][1] = v1 ? __ldg(brow0 + k0 + c + 1) : -INFINITY;
      s[j][2] = v0 ? __ldg(brow1 + k0 + c) : -INFINITY;
      s[j][3] = v1 ? __ldg(brow1 + k0 + c + 1) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const bf16* krow = Kt + (j * 8 + g) * LDT + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma16816(s[j], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // online softmax: a row's 64 keys are spread over the 4 threads of a group
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
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
    for (int j = 0; j < BKV / 8; ++j) {
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
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // o += bf16(p) · v; the accumulator layout of s is the A layout of p
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kc * 16 + (lane & 15)) * LDT + np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], pa, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  bf16* out_b = out + (size_t)b * N * C + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qrow0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out_b + (size_t)qrow0 * C + n * 8) =
          __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    if (qrow1 < N)
      *reinterpret_cast<__nv_bfloat162*>(out_b + (size_t)qrow1 * C + n * 8) =
          __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
}

}  // namespace

extern "C" int vlm_packed_attention(const void* qkv, const void* bias, const void* mask,
                                    void* out, int B, int N, int H, float scale,
                                    void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (N + BQ - 1) / BQ, H);
  packed_attention_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const int*>(mask), static_cast<bf16*>(out), N, H, scale);
  return (int)cudaGetLastError();
}
