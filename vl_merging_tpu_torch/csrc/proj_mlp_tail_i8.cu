// K15: the post-attention half of a W8A8 eval block in one kernel:
//   x1  = bf16(res + (dequant(quant(ctx)·pqᵀ) + bp) ⊙ γ1)
//   h   = gelu(dequant(quant(LN2(x1))·w1qᵀ) + b1)              (f32)
//   out = bf16(x1 + (dequant(quant(h)·w2qᵀ) + b2) ⊙ γ2)
// every quant per token (row), every product s8·s8→s32.
//
// Replaces vl_merging_tpu/ops/int8.py:_proj_mlp_i8_kernel (via
// proj_mlp_tail_i8/_row_call_i8), with its arithmetic: x1 rounded to
// bf16 before LN2, LN2 in f32 into the quantizer, the gelu chosen by the
// caller (the degree-19 polynomial by default; ops/mlp.py GELUS order),
// one rounding per f32 operation.
//
// The design problem: the fc2 input is quantized per token over the
// whole 3072-wide f32 hidden, so its scale needs the row's amax before
// any fc2 product, and K3/K13's walk over 128-wide hidden chunks, each
// consumed at once, does not carry over.  The TPU kernel keeps a
// (512, 3072) f32 hidden in VMEM.  Here a block of 32 rows runs fc1
// twice: a first pass over the 24 hidden chunks only takes each row's
// amax of gelu(h), a second pass recomputes each chunk, quantizes it
// with the now known scale and contracts it at once into the fc2
// accumulators.  The recomputation is exact: the s32 sums do not depend
// on their order and the f32 epilogue runs the same instructions, so both
// passes see the same h.  It costs 44% more products (fc1 is 2.4 of the
// 5.3 M multiply-adds per row) and none of the shared memory that
// keeping a 16-row f32 hidden (192 KiB of the 227) would take, which
// leaves room for 32-row blocks: every block streams all 5.3 MB of int8
// weights (7.7 MB with the second fc1 pass) from L2, against the 10.6 MB
// of bf16 weights a K3 block streams for the same 32 rows.
//
// Bound on the H100: by its arithmetic, int8 tensor-core throughput (196
// GOP at B=32, N=577: 0.099 ms at 1,979 TOP/s, against ~90 MB of
// activations and weights, 0.027 ms at 3.35 TB/s).  As built, the s32
// output accumulators (96 per thread) hold it to one block of 8 warps
// per SM, and the L2 weight stream to a fraction of that rate.  x1 is
// parked in the block's own rows of the output (L2-resident) between the
// proj and the residual, as in K3.
#include "int8.cuh"

using namespace vlm;

namespace {

constexpr int BM = 32, MF = BM / 16;         // every warp covers all 32 rows
constexpr int HC = 128;                       // hidden chunk (16 columns a warp)
constexpr int BK_WIDE = 64, STAGES_WIDE = 3;  // proj / fc2 tiles: C x 64 bytes
constexpr int BK_HID = 128, STAGES_HID = 6;   // fc1 tiles: 128 x 128 bytes
constexpr int LDH = HC + kPad8;

__host__ __device__ constexpr size_t staging_bytes(int C) {
  return (size_t)STAGES_WIDE * C * (BK_WIDE + kPad8) >
                 (size_t)STAGES_HID * HC * (BK_HID + kPad8)
             ? (size_t)STAGES_WIDE * C * (BK_WIDE + kPad8)
             : (size_t)STAGES_HID * HC * (BK_HID + kPad8);
}

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)BM * (C + kPad8) + (size_t)BM * LDH + staging_bytes(C) +
         (4 * BM + 8 * BM) * sizeof(float);
}

// Horner in u² with one rounding per step: horner(u2, c0, .., cn) =
// c0 + u2·(c1 + u2·(.. cn)), evaluated as ((cn·u2 + cn-1)·u2 + ..) + c0.
__device__ __forceinline__ float horner(float, float c) { return c; }
template <class... Rest>
__device__ __forceinline__ float horner(float u2, float c, Rest... rest) {
  return __fadd_rn(__fmul_rn(horner(u2, rest...), u2), c);
}

// 0.5·x·(1 + u·P(u²)), u = clip(x, -T, T)·(1/T): ops/mlp.py's polynomial
// gelus; constants are the f32 roundings of the doubles the twins use.
template <class... Coef>
__device__ __forceinline__ float poly_gelu(float x, double T, Coef... c) {
  const float u = __fmul_rn(fminf(fmaxf(x, -(float)T), (float)T), (float)(1.0 / T));
  const float p = horner(__fmul_rn(u, u), (float)c...);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, __fmul_rn(u, p)));
}

// gelu_kind: the index of the activation in ops/mlp.py GELUS
__device__ __forceinline__ float gelu(float x, int gelu_kind) {
  switch (gelu_kind) {
    case 0:
      return poly_gelu(x, 4.5, 3.590282846823918, -12.10273623182234, 36.461995337755816,
                       -85.03475787176419, 152.33199218079585, -204.54489822051983,
                       196.73375743149893, -126.45531926658512, 48.21324671368246,
                       -8.1935629198655);
    case 1:
      return poly_gelu(x, 3.5, 2.781156562, -5.458430753, 8.694525338, -8.887355099,
                       5.116006695, -1.245902743);
    case 2:
      return poly_gelu(x, 3.95, 3.144041517, -7.974838082, 16.980673852, -24.785977463,
                       23.048449174, -12.161256715, 2.748907717);
    default:
      return ErfApproxGelu()(x);
  }
}

// NF: 8-column fragments per warp over the model width, C = 8 * NF * 8.
template <int NF>
__global__ void __launch_bounds__(kGemmThreads, 1)
proj_mlp_tail_i8_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ res,
                        const int8_t* __restrict__ pq, const float* __restrict__ ps,
                        const float* __restrict__ bp, const float* __restrict__ g1,
                        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                        const int8_t* __restrict__ w1q, const float* __restrict__ w1s,
                        const float* __restrict__ b1, const int8_t* __restrict__ w2q,
                        const float* __restrict__ w2s, const float* __restrict__ b2,
                        const float* __restrict__ g2, bf16* __restrict__ out, int M, int Hd,
                        int gelu_kind, float eps) {
  constexpr int C = 8 * NF * 8, LDA = C + kPad8, WARPS = kGemmThreads / 32;
  constexpr int ROWS_PER_WARP = BM / WARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);        // BM x LDA: quant(ctx), then quant(LN2)
  int8_t* Hs = As + BM * LDA;                           // BM x LDH: quantized hidden chunk
  int8_t* Ws = Hs + BM * LDH;                           // weight tile staging
  float* s_ctx = reinterpret_cast<float*>(Ws + staging_bytes(C));  // BM row scales each
  float* s_ln = s_ctx + BM;
  float* s_hid = s_ln + BM;
  float* inv_hid = s_hid + BM;                          // 1 / s_hid
  float* red = inv_hid + BM;                            // 8 warps x BM partial amaxes

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int left = M - (row0 + warp);  // this warp's rows warp, warp + 8, ...
  const int nvalid = left > 0 ? (left + WARPS - 1) / WARPS : 0;

  // ---- proj + LayerScale + residual -> x1 (bf16, parked in out's rows);
  // the first pq tiles are in flight while ctx is quantized
  gemm8_prefetch<C, BK_WIDE, STAGES_WIDE>(pq, C, C, Ws);
  quant_rows<ROWS_PER_WARP, NF / 4>(ctx + (size_t)(row0 + warp) * C, (size_t)WARPS * C, nvalid,
                                    As + warp * LDA, WARPS * LDA, s_ctx + warp, WARPS);
  int acc[MF][NF][4];
  zero_acc8(acc);
  gemm8_main<MF, NF, 8, BK_WIDE, STAGES_WIDE>(acc, As, LDA, pq, C, C, Ws);
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + 8 * h;
      if (row0 + r >= M) continue;
      const float s = s_ctx[r];
      const bf16* rr = res + (size_t)(row0 + r) * C;
      bf16* orow = out + (size_t)(row0 + r) * C;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int col = (warp * NF + j) * 8 + 2 * t;
        const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + col));
        const float y0 = __fmul_rn(dequant(acc[i][j][2 * h], s, ps[col], bp[col]), g1[col]);
        const float y1 =
            __fmul_rn(dequant(acc[i][j][2 * h + 1], s, ps[col + 1], bp[col + 1]), g1[col + 1]);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(__fadd_rn(rv.x, y0), __fadd_rn(rv.y, y1));
      }
    }
  }
  __syncthreads();  // x1 complete (in out's rows); every warp is done with As

  // ---- LN2(x1) in f32, quantized per token into As
  ln_quant_rows<ROWS_PER_WARP, NF / 4>(out + (size_t)(row0 + warp) * C, (size_t)WARPS * C,
                                       nvalid, ln_w, ln_b, eps, As + warp * LDA, WARPS * LDA,
                                       s_ln + warp, WARPS);

  // fc1 over one hidden chunk [j0, j0 + HC): hacc = quant(LN2)·w1q[j0..]ᵀ;
  // the leading barrier publishes As (and the row scales) and frees the
  // staging area.  Fragment element (i, j, e) is row i*16 + g + 8*(e/2),
  // chunk column (warp*2 + j)*8 + 2t + e%2.
  auto fc1_chunk = [&](int (&hacc)[MF][2][4], int j0) {
    zero_acc8(hacc);
    __syncthreads();
    gemm8_prefetch<HC, BK_HID, STAGES_HID>(w1q + (size_t)j0 * C, C, C, Ws);
    gemm8_main<MF, 2, 8, BK_HID, STAGES_HID>(hacc, As, LDA, w1q + (size_t)j0 * C, C, C, Ws);
  };
  auto hidden = [&](int acc_ie, int r, int col) {  // gelu(dequant + b1), f32
    return gelu(dequant(acc_ie, s_ln[r], w1s[col], b1[col]), gelu_kind);
  };

  // ---- pass 1: each row's amax of the f32 hidden
  float amax[MF][2] = {};
  for (int j0 = 0; j0 < Hd; j0 += HC) {
    int hacc[MF][2][4];
    fc1_chunk(hacc, j0);
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = i * 16 + g + 8 * (e >> 1);
          const int col = j0 + (warp * 2 + j) * 8 + 2 * t + (e & 1);
          amax[i][e >> 1] = fmaxf(amax[i][e >> 1], fabsf(hidden(hacc[i][j][e], r, col)));
        }
  }
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = amax[i][h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[warp * BM + i * 16 + g + 8 * h] = m;
    }
  __syncthreads();
  if (threadIdx.x < BM) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w * BM + threadIdx.x]);
    s_hid[threadIdx.x] = quant_scale(m);
    inv_hid[threadIdx.x] = __frcp_rn(s_hid[threadIdx.x]);
  }

  // ---- pass 2: recompute each chunk, quantize it, contract it into fc2
  zero_acc8(acc);
  for (int j0 = 0; j0 < Hd; j0 += HC) {
    int hacc[MF][2][4];
    fc1_chunk(hacc, j0);  // its leading barrier also publishes inv_hid
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = i * 16 + g + 8 * h;
          const int c = (warp * 2 + j) * 8 + 2 * t;  // column within the chunk
          const int q0 = quantize(hidden(hacc[i][j][2 * h], r, j0 + c), inv_hid[r]);
          const int q1 = quantize(hidden(hacc[i][j][2 * h + 1], r, j0 + c + 1), inv_hid[r]);
          *reinterpret_cast<uint16_t*>(Hs + r * LDH + c) =
              (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
    __syncthreads();  // the chunk is in Hs; every warp is done with the W1 tiles
    gemm8_prefetch<C, BK_WIDE, STAGES_WIDE>(w2q + j0, Hd, HC, Ws);
    gemm8_main<MF, NF, 8, BK_WIDE, STAGES_WIDE>(acc, Hs, LDH, w2q + j0, Hd, HC, Ws);
  }

  // ---- fc2 dequant + bias + LayerScale + residual -> out
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + 8 * h;
      if (row0 + r >= M) continue;
      const float s = s_hid[r];
      bf16* orow = out + (size_t)(row0 + r) * C;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int col = (warp * NF + j) * 8 + 2 * t;
        // this thread stored exactly these x1 values itself
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + col));
        const float y0 = __fmul_rn(dequant(acc[i][j][2 * h], s, w2s[col], b2[col]), g2[col]);
        const float y1 =
            __fmul_rn(dequant(acc[i][j][2 * h + 1], s, w2s[col + 1], b2[col + 1]), g2[col + 1]);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(__fadd_rn(x1.x, y0), __fadd_rn(x1.y, y1));
      }
    }
  }
}

template <int NF>
int launch(const void* ctx, const void* res, const void* pq, const void* ps, const void* bp,
           const void* g1, const void* ln_w, const void* ln_b, const void* w1q,
           const void* w1s, const void* b1, const void* w2q, const void* w2s, const void* b2,
           const void* g2, void* out, int M, int Hd, int gelu_kind, float eps,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(8 * NF * 8);
  cudaError_t err = cudaFuncSetAttribute(
      proj_mlp_tail_i8_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  proj_mlp_tail_i8_kernel<NF><<<(M + BM - 1) / BM, kGemmThreads, smem, stream>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(res),
      static_cast<const int8_t*>(pq), static_cast<const float*>(ps),
      static_cast<const float*>(bp), static_cast<const float*>(g1),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2q),
      static_cast<const float*>(w2s), static_cast<const float*>(b2),
      static_cast<const float*>(g2), static_cast<bf16*>(out), M, Hd, gelu_kind, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_proj_mlp_tail_i8(const void* ctx, const void* res, const void* pq,
                                    const void* ps, const void* bp, const void* g1,
                                    const void* ln_w, const void* ln_b, const void* w1q,
                                    const void* w1s, const void* b1, const void* w2q,
                                    const void* w2s, const void* b2, const void* g2,
                                    void* out, int M, int C, int Hd, int gelu_kind, float eps,
                                    void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % HC != 0 || gelu_kind < 0 || gelu_kind > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<12>(ctx, res, pq, ps, bp, g1, ln_w, ln_b, w1q, w1s, b1, w2q, w2s, b2, g2,
                        out, M, Hd, gelu_kind, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
