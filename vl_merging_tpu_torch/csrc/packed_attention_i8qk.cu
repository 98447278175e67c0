// K12: K2 with its q·kᵀ as s8·s8 -> s32, the opt-in int8-QK mode of the
// int8 eval, writing the context in (B, N, C).
//
// Replaces vl_merging_tpu/ops/attention.py:_packed_kernel_i8qk (via
// _pallas_packed_attention(qk_int8=True)).  Per head: q and k quantized per
// (token, head) row of 64 (scale max(amax, 1e-8)/127, round half even, no
// clip: the quantizer of every int8 kernel, int8.cuh; the TPU's zero pad
// of the depth to 128 is a tiling detail and is dropped); the logits
// ((f32(q_i8·k_i8ᵀ) · (sq·scale)) · sk) + bias[h] in f32, one rounding per
// operation; keys with mask <= 0, or past N, at -inf; then K2's softmax
// and bf16 P·V.
//
// Design (Hopper, sm_90a): K2's persistent kernel (packed_attention_fwd.cu
// holds its notes) with the Int8Qk policy of its device code
// (packed_attention_fwd.cuh) and the Maps layout.  The k tile still lands
// by TMA in bf16; the producer warpgroup, once it has landed, quantizes
// it in place into a 64B-swizzled int8 K-major tile and the 64 keys'
// scales (a stage stays 52 KB, so four still fit), fences the
// writes for the async proxy and arrives on the stage's barrier, which
// counts those arrivals beside the bias copiers'.  The consumers quantize
// their q rows once per item into s8 A fragments (the amax of a row over
// the 4 threads of its group), run q·kᵀ as two m64n{16,32,64}k32 s8 wgmma
// steps with A from registers into a fresh s32 accumulator, and after the
// wait dequantize it where K2 would have seeded its accumulator with the
// bias: s32 -> f32 by the bits of x + 1.5·2^23 (|q·k| < 2^20; no I2F,
// which runs at a quarter of the FP32 rate), two FMUL and an FADD a
// logit.  The rest is K2's code: the ping-pong turns, the online softmax,
// P·V, the ragged edge, the mask rule.  Unlike K2, the kernel shifts
// registers from the consumers (152) to the producer (200) by setmaxnreg:
// at K2's even 168 the producer, quantizing beside its bias copies,
// spilled.  Both quantizers round on the FP32 and integer pipes
// (quantize_alu: no F2I).
//
// Bound on the H100: as K2's, by bytes (~130 MB of qkv, context and bias
// at B=32, N=577, 12 heads); the int8 product halves the tensor-core term
// of q·kᵀ.
#include "packed_attention_fwd.cuh"

using namespace vlm;
using namespace vlm::k2;

namespace {

constexpr int SMEM_I8 = Cfg<2, Int8Qk>::SMEM;
static_assert(SMEM_I8 <= 232448, "over the H100's shared memory per block");
// The roles' register budgets (setmaxnreg): the launch's 168 a thread,
// shifted from the consumers to the producer, which holds its bias chunks'
// offsets beside the k tile it quantizes (at 168 each it spilled; 184 /
// 160 ran ~2% slower: chip_profile.py --variants K12).
constexpr int PRODUCER_REGS = 200, CONSUMER_REGS = 152;
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS == 3 * 168, "the launch's registers");

__global__ void __launch_bounds__(THREADS, 1)
    packed_attention_i8qk_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ __align__(1024) unsigned char raw[];
  setup<2, Int8Qk>(raw);
  if (threadIdx.x >= CONSUMERS) {
    hop::setmaxnreg_inc<PRODUCER_REGS>();
    produce<2, Items, Maps, Int8Qk>(maps, a, raw);
    return;
  }
  hop::setmaxnreg_dec<CONSUMER_REGS>();
  consume<2, Items, Int8Qk>(a, raw);
}

int ctas = 0;  // CTAs of the persistent grid

}  // namespace

// bias: (H, N, N) f32; mask: (B, N) int32; out: (B, N, C) bf16.
extern "C" int vlm_packed_attention_i8qk(const void* qkv, const void* bias, const void* mask,
                                         void* out, int B, int N, int H, float scale,
                                         void* stream) {
  return launch_packed(packed_attention_i8qk_kernel, SMEM_I8, ctas, qkv, bias, mask, out, nullptr,
                       B, N, H, scale, stream);
}
