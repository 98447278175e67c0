// K10 and K11: attention over split q, k, v of shape (B, H, N, 64), with an
// f32 (H, N, N) relative-position bias and a (B, N) key mask, writing the
// context in the same (B, H, N, 64) layout.
//
// Replaces vl_merging_tpu/ops/attention.py:_mha_kernel (K10, via
// _pallas_attention) and :_mha_kernel_bb (K11, via _pallas_attention_bb):
// the split-layout attention that fused_attention runs at N >= 128 when the
// packed kernel (K2) does not apply, as in every block of a @224 image tower
// (197 tokens).  Per (element, head): s = (q·scale)·kᵀ in f32 with q scaled
// in bf16 (exact for 1/8), + bias[h] in f32, keys with mask <= 0 (or past N)
// at -inf, softmax in f32, P in bf16, P·v accumulated in f32, the context
// rounded to bf16.
//
// q, k, v and the output are addressed through (element, head, token)
// strides with a contiguous head dimension, so the port hands the kernels
// the (B, H, N, 64) views of its packed qkv projection without a transpose,
// and takes the context back in (B, N, C) order through a transposed view.
//
// The TPU kernels hold a whole (Np, Np) logits tile in VMEM, with N padded
// to a multiple of 128.  Here a block walks 64-key tiles with K2's online
// softmax (common.cuh:online_softmax_pv, shared with K12): the bf16
// cast applies to exp(s - running max) before normalisation, and the
// division by the row sum happens once, in f32, at the end.  The bias is the
// initial value of the f32 accumulator of q·kᵀ.  N is not padded: keys past
// N are -inf and queries past N are not stored.
//   * K10 (split_attention): a block per (element, 64-query tile, head), 4
//     warps of 16 query rows, the bias read from device memory (L2) as K2
//     reads it.
//   * K11 (split_attention_bb): a block per (group of 4 elements, 64-query
//     tile, head), 16 warps, 4 per element.  Each 64 x 64 bias tile is
//     copied into shared memory once and read by the 4 elements' warps:
//     the TPU kernel's resident bias block, here a quarter of the bias
//     reads from L2.  Whether that pays on this card is measured
//     (chip_smoke.py), not assumed.
// Both run the same arithmetic per element in the same order (the same
// device functions, the same bias values), so their outputs are equal bit
// for bit.
//
// Bound on the H100: at B=32, H=12, N=197 the work is 3.8 GFLOP of tensor-
// core products against ~40 MB of q, k, v, context and bias, about 100
// flops a byte, below the ridge (~295): the bytes bound it (~0.012 ms).
// K and V tiles are double-buffered with cp.async (and K11's bias tiles
// with 4-byte cp.async: a bias row of 197 floats is not 16-byte aligned);
// S, P and the output stay in registers in the mma.sync m16n8k16 layouts.
#include "common.cuh"

using namespace vlm;

namespace {

constexpr int D = kAttnDim, BQ = 64, BKV = kAttnKeys, LDT = kAttnLdt;
constexpr int WARPS_PER_ELEM = BQ / 16;   // 4 warps of 16 query rows per element
constexpr int LDBIAS = BKV + 4;           // K11's f32 bias tile stride

// Element strides of a (B, H, N, 64) tensor whose last dimension is
// contiguous.
struct Layout {
  int b, h, n;
  __device__ __forceinline__ size_t at(int bi, int hi, int ni) const {
    return (size_t)bi * b + (size_t)hi * h + (size_t)ni * n;
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

template <int EB>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)2 * 2 * EB * BKV * LDT * sizeof(bf16)     // K and V, 2 stages
         + (size_t)2 * EB * BKV * sizeof(int)                // valid keys, 2 stages
         + (EB > 1 ? (size_t)2 * BQ * LDBIAS * sizeof(float) : 0);  // K11's bias tiles
}

// Start loading key tile [k0, k0 + BKV) of the block's EB elements' K and V
// into stage st (rows past N are zeros), record which keys are valid, and
// (K11) start copying the bias rows of the block's queries at these keys.
template <int EB>
__device__ __forceinline__ void load_tiles(bf16* Ks, bf16* Vs, int* kvalid, float* Bs,
                                           const bf16* __restrict__ k,
                                           const bf16* __restrict__ v,
                                           const float* __restrict__ bias,
                                           const int* __restrict__ mask, Layout lk,
                                           Layout lv, int b0, int h, int q0, int k0, int N,
                                           int st) {
  constexpr int THREADS = EB * WARPS_PER_ELEM * 32, VECS = BKV * D / 8;
  for (int idx = threadIdx.x; idx < EB * VECS; idx += THREADS) {
    const int e = idx / VECS, r = (idx % VECS) / (D / 8), c = (idx % (D / 8)) * 8;
    bf16* kt = Ks + (st * EB + e) * BKV * LDT + r * LDT + c;
    bf16* vt = Vs + (st * EB + e) * BKV * LDT + r * LDT + c;
    if (k0 + r < N) {
      cp_async16(kt, k + lk.at(b0 + e, h, k0 + r) + c);
      cp_async16(vt, v + lv.at(b0 + e, h, k0 + r) + c);
    } else {
      *reinterpret_cast<uint4*>(kt) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vt) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (threadIdx.x < EB * BKV) {
    const int e = threadIdx.x / BKV, r = threadIdx.x % BKV;
    kvalid[(st * EB + e) * BKV + r] =
        (k0 + r < N) && mask[(size_t)(b0 + e) * N + k0 + r] > 0;
  }
  if constexpr (EB > 1) {
    // keys past N are never read (they are -inf); query rows past N read
    // row N - 1, as K10 does, and are not stored
    for (int idx = threadIdx.x; idx < BQ * BKV; idx += THREADS) {
      const int r = idx / BKV, c = idx % BKV;
      if (k0 + c < N)
        cp_async4(Bs + st * BQ * LDBIAS + r * LDBIAS + c,
                  bias + ((size_t)h * N + min(q0 + r, N - 1)) * N + k0 + c);
    }
  }
}

// The logits of a 64-key tile before q·kᵀ, from K11's bias tile in shared
// memory (rows brow0, brow1 of the thread): the same values, chosen the
// same way, as common.cuh:logits_from_bias reads from device memory.
__device__ __forceinline__ void logits_from_bias_smem(float (&s)[BKV / 8][4], const int* kv,
                                                      const float* brow0,
                                                      const float* brow1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const int c = j * 8 + 2 * t;
    const bool v0 = kv[c], v1 = kv[c + 1];
    s[j][0] = v0 ? brow0[c] : -INFINITY;
    s[j][1] = v1 ? brow0[c + 1] : -INFINITY;
    s[j][2] = v0 ? brow1[c] : -INFINITY;
    s[j][3] = v1 ? brow1[c + 1] : -INFINITY;
  }
}

// Two consecutive q values of a row (zeros past N), each scaled in bf16 as
// K2 scales them, packed as one A-fragment register.
__device__ __forceinline__ uint32_t scaled_q_pair(const bf16* qrow, bool valid, float qscale) {
  if (!valid) return 0u;
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(qrow);
  return pack_bf16(__bfloat162float(p.x) * qscale, __bfloat162float(p.y) * qscale);
}

// EB elements per block: 1 for K10, 4 for K11.
template <int EB>
__global__ void __launch_bounds__(EB * WARPS_PER_ELEM * 32)
split_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const int* __restrict__ mask, bf16* __restrict__ out, Layout lq,
                       Layout lk, Layout lv, Layout lo, int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);               // [2][EB][BKV * LDT]
  bf16* Vs = Ks + 2 * EB * BKV * LDT;                     // [2][EB][BKV * LDT]
  int* kvalid = reinterpret_cast<int*>(Vs + 2 * EB * BKV * LDT);  // [2][EB][BKV]
  float* Bs = reinterpret_cast<float*>(kvalid + 2 * EB * BKV);    // K11: [2][BQ * LDBIAS]

  const int b0 = blockIdx.x * EB, q0 = blockIdx.y * BQ, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = warp / WARPS_PER_ELEM, wq = warp % WARPS_PER_ELEM;  // element, row slice
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  const int b = b0 + e;

  load_tiles<EB>(Ks, Vs, kvalid, Bs, k, v, bias, mask, lk, lv, b0, h, q0, 0, N, 0);
  cp_async_commit();

  // this thread's two query rows (g and g + 8 of the warp's 16) as A
  // fragments, straight from device memory, scaled in bf16
  const int qrow0 = q0 + wq * 16 + g, qrow1 = qrow0 + 8;
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  const bf16* qr0 = q + lq.at(b, h, min(qrow0, N - 1)) + 2 * t;
  const bf16* qr1 = q + lq.at(b, h, min(qrow1, N - 1)) + 2 * t;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = scaled_q_pair(qr0 + kk * 16, qrow0 < N, qscale);
    qa[kk][1] = scaled_q_pair(qr1 + kk * 16, qrow1 < N, qscale);
    qa[kk][2] = scaled_q_pair(qr0 + kk * 16 + 8, qrow0 < N, qscale);
    qa[kk][3] = scaled_q_pair(qr1 + kk * 16 + 8, qrow1 < N, qscale);
  }

  const float* brow0 = bias + ((size_t)h * N + min(qrow0, N - 1)) * N;  // K10: rows past N
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
      load_tiles<EB>(Ks, Vs, kvalid, Bs, k, v, bias, mask, lk, lv, b0, h, q0, k0 + BKV, N,
                     st ^ 1);
    cp_async_commit();
    const int* kv = kvalid + (st * EB + e) * BKV;
    float s[BKV / 8][4];
    if constexpr (EB > 1) {
      const float* bt = Bs + st * BQ * LDBIAS + (wq * 16 + g) * LDBIAS;
      logits_from_bias_smem(s, kv, bt, bt + 8 * LDBIAS);
    } else {
      logits_from_bias(s, kv, brow0 + k0, brow1 + k0);
    }
    add_qk_bf16(s, qa, Ks + (st * EB + e) * BKV * LDT);
    online_softmax_pv(s, o, m0, m1, l0, l1, Vs + (st * EB + e) * BKV * LDT);
  }

  store_ctx_rows(o, l0, l1, out + lo.at(b, h, 0) + 2 * t, (size_t)lo.n, qrow0, N);
}

template <int EB>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, int B, int N, int H, const int* strides, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B % EB != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)  // 16-byte aligned rows for cp.async
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]};
  constexpr size_t smem = smem_bytes<EB>();
  cudaError_t err = cudaFuncSetAttribute(
      split_attention_kernel<EB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B / EB, (N + BQ - 1) / BQ, H);
  split_attention_kernel<EB><<<grid, EB * WARPS_PER_ELEM * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(mask), static_cast<bf16*>(out),
      lq, lk, lv, lo, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides, in elements: (element, head, token) of q, then k, v and out.
extern "C" int vlm_split_attention(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int B,
                                   int N, int H, int qsb, int qsh, int qsn, int ksb, int ksh,
                                   int ksn, int vsb, int vsh, int vsn, int osb, int osh,
                                   int osn, float scale, void* stream) {
  const int strides[12] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, osb, osh, osn};
  return launch<1>(q, k, v, bias, mask, out, B, N, H, strides, scale, stream);
}

extern "C" int vlm_split_attention_bb(const void* q, const void* k, const void* v,
                                      const void* bias, const void* mask, void* out, int B,
                                      int N, int H, int qsb, int qsh, int qsn, int ksb,
                                      int ksh, int ksn, int vsb, int vsh, int vsn, int osb,
                                      int osh, int osn, float scale, void* stream) {
  const int strides[12] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, osb, osh, osn};
  return launch<4>(q, k, v, bias, mask, out, B, N, H, strides, scale, stream);
}
