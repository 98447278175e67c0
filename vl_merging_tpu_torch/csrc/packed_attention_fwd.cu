// K2: attention over packed qkv with an f32 relative-position bias and a
// key mask, writing the context in (B, N, C).
//
// Replaces vl_merging_tpu/ops/attention.py:_packed_kernel (via
// _pallas_packed_attention / packed_fused_attention).  Per head:
// s = (q·scale)·kᵀ in f32 with q pre-scaled in bf16 (exact for 1/8),
// + bias[h] in f32, keys with mask 0 (or past N) at -inf, softmax in f32,
// P in bf16, P·v accumulated in f32, context rounded to bf16.  q, k and v
// are read in place from the packed qkv columns (q at 0, k at C, v at 2C,
// head h at h·64).
//
// The TPU kernel holds a whole (N, N) logits row tile in VMEM and
// normalises P before its bf16 cast.  Here each query row walks 64-key
// tiles with an online softmax (flash style), so the bf16 cast applies to
// exp(s - running max) before normalisation; the division by the row sum
// happens once, in f32, at the end.  The bias is the initial value of the
// f32 accumulator of q·kᵀ.  The training launch also stores each query
// row's softmax statistics (running max m and sum l, f32, (2, B, H, N);
// m = -inf and l = 0 on a row with no valid key) for the backward K9; the
// eval launch stores none and its arithmetic is the same.  A row with no
// valid key stores 0/0.
//
// Bound on the H100: at B=32, N=577, 12 heads it is 32.7 GFLOP of
// tensor-core work against ~130 MB of qkv, context and bias, plus N² exps
// per head on the SFU, which at head dim 64 take about as long as the
// products.
//
// Design (Hopper, sm_90a).  A work item is (element b, 128 query rows,
// head h): two consumer warpgroups of 64 query rows share every K/V tile.
// A producer warpgroup keeps a ring of STAGES key tiles full: its first
// thread loads the 64 x 64 K and V tiles by TMA, read in place through a
// 3-D tensor map over qkv as (B, N, 3C) whose rows past N read as zeros
// (128B-swizzled), and the item's Q tile into its own buffer an item
// ahead; its 128 threads copy the 128 x 64 f32 bias tile by 16-byte
// cp.async, a bias row's keys at their own offset of 0 to 3 floats (the
// rows of the (H, N, N) bias are 577 floats long, not 16-byte aligned, so
// a tensor map cannot take them, and no padded copy is made).  Each
// consumer warp keeps its 16 query rows, scaled in bf16, as wgmma A
// fragments in registers.  Per key tile it sets its logits to the bias
// (or -inf for a masked key: the mask is read a tile ahead), issues q·kᵀ
// (wgmma, A from registers, K K-major) and then the previous tile's P·V,
// waits for q·kᵀ alone and takes the online softmax on the accumulators
// in place (exp as 2^x on the SFU) while that P·V runs, then rescales the
// output and packs P into the A fragments of its own P·V (wgmma, A from
// registers, V an MN-major operand: the transpose bit).  The two
// warpgroups take turns at issuing their products (FlashAttention-3's
// ping-pong), so that one's softmax runs beside the other's products.  The
// last key tile's products are the narrowest the shapes allow: 16, 32 or
// 64 keys (577 = 9·64 + 1: 16); the branch on that width stays outside the
// key loop, and every warpgroup computes all its rows, also those past N
// (not stored): a branch around wgmma that ptxas cannot prove uniform
// makes it serialize every product of the kernel.  The grid is persistent:
// one CTA per SM walks the items b fastest, so the CTAs that share a bias
// tile run together and a head's K/V rows stay in L2 across its query
// tiles.  K10 and K11 (split_attention.cu) run the same device code over
// split q, k and v: only the producer's TMA maps differ (the layout
// policy, Maps here, SplitMaps there).  K12 (packed_attention_i8qk.cu)
// runs it with its q·kᵀ in int8 (the Int8Qk policy, Bf16Qk here).
//
// L2 traffic per launch at B=32, N=577, 12 heads (arithmetic from the
// tiles): 1920 items; K and V 1920 x 148 KB = 284 MB (the 64-query-row
// mma.sync design before: 629 MB); the bias, in 16-byte chunks over the
// valid rows and keys, ~538 MB (before: 567 MB, element by element), the
// same for every element b: sharing it between elements is not done; q
// 28 MB.
//
// Shared memory: the Q tile (16 KB) and STAGES x (8 KB K + 8 KB V + 36 KB
// bias) = 208 KB, barriers, 1 KB alignment slack: 225 KB.
#include "packed_attention_fwd.cuh"

using namespace vlm;
using namespace vlm::k2;

namespace {

__global__ void __launch_bounds__(THREADS, 1)
    packed_attention_fwd_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ __align__(1024) unsigned char raw[];
  setup(raw);
  if (threadIdx.x >= CONSUMERS) {
    produce(maps, a, raw);
    return;
  }
  consume(a, raw);
}

int ctas = 0;  // CTAs of the persistent grid

}  // namespace

// bias: (H, N, N) f32.  stats: null (the eval), or a (2, B, H, N) f32
// buffer that receives each query row's running max m and sum
// l = Σ exp(s - m) over its valid keys (m = -inf and l = 0 on a row with no
// valid key): the statistics K9 reads.
extern "C" int vlm_packed_attention(const void* qkv, const void* bias, const void* mask,
                                    void* out, void* stats, int B, int N, int H, float scale,
                                    void* stream) {
  return launch_packed(packed_attention_fwd_kernel, SMEM, ctas, qkv, bias, mask, out, stats, B, N,
                       H, scale, stream);
}
