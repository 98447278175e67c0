// K13: the transformer MLP in one kernel:
//   out = bf16(bf16(gelu(x·W1ᵀ + b1))·W2ᵀ + b2)
//
// Replaces vl_merging_tpu/ops/mlp.py:_mlp_kernel (via _pallas_mlp /
// fused_mlp).  Same rounding points as the TPU kernel: fc1 accumulates in
// f32 and adds b1 in f32, the gelu runs in f32 with the Abramowitz-Stegun
// erf (|err| <= 1.5e-7; the TPU kernel's _erf_approx, evaluated here with
// fused multiply-adds), the hidden is rounded to bf16, fc2 accumulates in
// f32 and adds b2 in f32, and the output is rounded once.
//
// Bound on the H100: by its arithmetic (4·M·C·H flops: 174 GFLOP at
// M = 32·577, C = 768, H = 3072, against 57 MB of rows, weights and
// output).  The TPU kernel keeps both weights and a (256, 3072) f32 hidden
// in VMEM; a block here gets at most 227 KB of shared memory, so it owns 32
// rows and runs common.cuh:mlp_hidden_chunks, K3's MLP body: the hidden in
// 128-wide chunks, each rounded to bf16 and contracted at once into f32
// output accumulators that stay in registers.  As in K3, every 32-row
// block streams all 9.4 MB of weights from L2, which bounds it in practice
// (wgmma's 64-row accumulators are later work).
#include "common.cuh"

using namespace vlm;

namespace {

constexpr int BM = kMlpRows, MF = kMlpMF;

template <int NF>
__global__ void __launch_bounds__(kGemmThreads, 1)
mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, bf16* __restrict__ out, int M, int Hd) {
  constexpr int C = 8 * NF * 16;
  constexpr int LDA = C + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);         // BM x LDA: the block's x rows
  bf16* Hs = As + BM * LDA;                          // BM x (HC + kPad): gelu(fc1) chunk
  bf16* Ws = Hs + BM * (kHiddenChunk + kPad);        // weight tile staging
  float* scratch = reinterpret_cast<float*>(Ws + kMlpStaging);  // 8 x 16 x 16

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  float* sc = scratch + warp * 256;

  for (int v = threadIdx.x; v < BM * C / 8; v += kGemmThreads) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(As + r * LDA + c) =
        row0 + r < M ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * C + c))
                     : make_uint4(0u, 0u, 0u, 0u);
  }

  FragC acc[MF][NF];
  zero_acc(acc);
  mlp_hidden_chunks<NF>(acc, As, LDA, w1, b1, w2, Hd, Hs, Ws, sc, ErfApproxGelu());

#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int r, c0;
      const float* v = frag_to_scratch(acc[i][j], sc, r, c0);
      const int rr = i * 16 + r, col = (warp * NF + j) * 16 + c0;
      if (row0 + rr < M) {
        Pack8 o;
#pragma unroll
        for (int e = 0; e < 8; ++e) o.h()[e] = __float2bfloat16(v[e] + b2[col + e]);
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + rr) * C + col) = o.u;
      }
      __syncwarp();
    }
  }
}

template <int NF>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int M, int Hd, cudaStream_t stream) {
  constexpr size_t smem = mlp_smem_bytes(8 * NF * 16);
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_kernel<NF><<<(M + BM - 1) / BM, kGemmThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, Hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int M, int C, int Hd, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % kHiddenChunk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768:
      return launch<6>(x, w1, b1, w2, b2, out, M, Hd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
