// K10 and K11: attention over split q, k, v of shape (B, H, N, 64), with an
// f32 (H, N, N) relative-position bias and a (B, N) key mask, writing the
// context as (B, N, H, 64), which the caller sees as a (B, H, N, 64)
// transposed view.
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
// q, k and v are addressed through (element, head, token) strides with a
// contiguous head dimension, so the port hands the kernels the
// (B, H, N, 64) views of its packed qkv projection without a transpose.
//
// The TPU kernels hold a whole (Np, Np) logits tile in VMEM, with N padded
// to a multiple of 128; K11 keeps a bias block resident for a group of 4
// elements.  Here both are launches of K2's device code
// (packed_attention_fwd.cuh, whose kernel holds the design notes): a
// persistent grid, items of (element b, 128 query rows, head h) taken b
// fastest, a producer warpgroup keeping a 4-stage ring of 64-key K/V tiles
// full by TMA and copying the f32 bias tile by 16-byte cp.async at any
// 4-byte row offset (the 197-float rows are not aligned), two consumer
// warpgroups in ping-pong on wgmma with q and P from registers, the online
// softmax on the SFU, the last key tile as narrow as its keys allow (197 =
// 3·64 + 5: 16 keys), rows past N computed and not stored.  The one
// difference from K2 is the layout policy: each of q, k and v is read
// through a 4-D tensor map over (64, N, H, B) built from its strides
// (SplitMaps), where K2 reads one 3-D map over the packed (B, N, 3C).  So
// K10, K11 and K2 on the same values give the same bits.
//
// K11 keeps its own entry (the JAX package's dispatch: B % 4 == 0 and
// N <= 640) and runs the same kernel as K10: on this card a layer's bias
// (12·197·197·4 B = 1.9 MB) stays in L2, and the b-fastest order already
// runs the CTAs that share a bias tile together.  A CTA that takes a
// group's 4 elements (or a pair) back to back and copies each bias tile
// once for the group is a variant (chip_profile.py --variants K11): the
// groups of 4 measured slower on the H100 (fewer, larger units leave the
// CTAs uneven), the pairs no faster.
//
// Bound on the H100: at B=32, H=12, N=197 the work is 3.8 GFLOP of tensor-
// core products against ~40 MB of q, k, v, context and bias, about 100
// flops a byte, below the ridge (~295): the bytes bound it (~0.012 ms).
#include "packed_attention_fwd.cuh"

using namespace vlm;
using namespace vlm::k2;

namespace {

// consumer warpgroups: 2 (K2's CTA, 128-row items)
constexpr int kNC = 2;
// K11's item order: K10's
using GroupOrder = Items;

template <class It>
__global__ void __launch_bounds__(Cfg<kNC>::THREADS, 1)
    split_attention_kernel(const __grid_constant__ SplitMaps maps, const Args a) {
  extern __shared__ __align__(1024) unsigned char raw[];
  setup<kNC>(raw);
  if (threadIdx.x >= Cfg<kNC>::CONSUMERS) {
    produce<kNC>(maps, a, raw, It());
    return;
  }
  consume<kNC>(a, raw, It());
}

// CTAs of the persistent grid: one per SM, as many as fit.
template <class It>
int max_ctas() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (cudaFuncSetAttribute(split_attention_kernel<It>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<kNC>::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, split_attention_kernel<It>,
                                                      Cfg<kNC>::THREADS,
                                                      Cfg<kNC>::SMEM) != cudaSuccess ||
        per_sm <= 0) {
      cudaGetLastError();
      return 0;
    }
    n = sms * per_sm;
  }
  return n;
}

// A 4-D map over a (B, H, N, 64) bf16 tensor with element strides sb, sh,
// sn (multiples of 8: 16-byte rows) and boxes of 64 x rows.
bool split_map(CUtensorMap* map, const void* base, int B, int H, int N, int sb, int sh, int sn,
               uint32_t rows) {
  return hop::make_tensor_map_4d(map, base, {D, (uint64_t)N, (uint64_t)H, (uint64_t)B},
                                 {(uint64_t)sn * 2, (uint64_t)sh * 2, (uint64_t)sb * 2},
                                 {D, rows, 1, 1});
}

// Strides, in elements: (element, head, token) of q, then k, v and out; out
// must be the (B, N, H, 64) contiguous tensor seen as (B, H, N, 64).
template <class It>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, int B, int N, int H, const int* st, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)  // 16-byte rows for the tensor maps
    if (st[i] <= 0 || st[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (st[9] != N * H * D || st[10] != D || st[11] != H * D) return (int)cudaErrorInvalidValue;
  const int ctas = max_ctas<It>();
  if (ctas == 0) return (int)cudaErrorNotSupported;
  SplitMaps maps;
  if (!split_map(&maps.q, q, B, H, N, st[0], st[1], st[2], Cfg<kNC>::BQ) ||
      !split_map(&maps.k, k, B, H, N, st[3], st[4], st[5], BKV) ||
      !split_map(&maps.v, v, B, H, N, st[6], st[7], st[8], BKV))
    return (int)cudaErrorNotSupported;
  const int nqt = (N + Cfg<kNC>::BQ - 1) / Cfg<kNC>::BQ, items = B * H * nqt;
  const Args a{static_cast<const float*>(bias), static_cast<const int*>(mask),
               static_cast<bf16*>(out), nullptr, B, N, H, nqt, items, scale};
  const int grid = items < ctas ? items : ctas;
  split_attention_kernel<It><<<grid, Cfg<kNC>::THREADS, Cfg<kNC>::SMEM,
                               static_cast<cudaStream_t>(stream)>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_split_attention(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int B,
                                   int N, int H, int qsb, int qsh, int qsn, int ksb, int ksh,
                                   int ksn, int vsb, int vsh, int vsn, int osb, int osh,
                                   int osn, float scale, void* stream) {
  const int st[12] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, osb, osh, osn};
  return launch<Items>(q, k, v, bias, mask, out, B, N, H, st, scale, stream);
}

extern "C" int vlm_split_attention_bb(const void* q, const void* k, const void* v,
                                      const void* bias, const void* mask, void* out, int B,
                                      int N, int H, int qsb, int qsh, int qsn, int ksb,
                                      int ksh, int ksn, int vsb, int vsh, int vsn, int osb,
                                      int osh, int osn, float scale, void* stream) {
  if (B % 4 != 0) return (int)cudaErrorInvalidValue;
  const int st[12] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, osb, osh, osn};
  return launch<GroupOrder>(q, k, v, bias, mask, out, B, N, H, st, scale, stream);
}
