// K14: y = dequant(quant(LN(x)) · Wqᵀ) + b, the pre-norm + int8 qkv
// projection of a W8A8 eval block.
//
// Replaces vl_merging_tpu/ops/int8.py:_ln_linear_i8_kernel (via
// ln_linear_i8/_row_call_i8).  Same arithmetic as the TPU kernel: LN
// statistics and the normalised row in f32 (no bf16 rounding before the
// quantizer, unlike K1), per-token int8 with scale max(amax, 1e-8)/127,
// s8·s8 products summed exactly in s32 against the per-output-channel
// int8 weight, ((acc · s) · ws) + b in f32, output rounded to bf16.  The LN
// and quantizer are int8.cuh's ln_quant_rows_at (K15's) and the products
// are exact, so the output does not depend on the tiling.
//
// Bound on the H100: by bytes.  At the main-path shape
// (B·577 x 768) · (768 x 2304) it is 65.3 GOP of int8 work (0.033 ms at
// 1,979 TOP/s) against ~115 MB (x 28.4 MB in, y 85.1 MB out, W 1.8 MB):
// 0.034 ms at 3.35 TB/s.
//
// Design (Hopper, sm_90a): K1's (ln_linear.cu), in int8.  A CTA owns
// 128 x 256 output tiles: two consumer warpgroups of 64 rows, each with its
// 128 s32 accumulators a thread in registers (wgmma m64n256k32 s8·s8, 232
// registers a thread, which the producer warpgroup's 40 leave room for),
// and a producer warpgroup whose first thread keeps a ring of STAGES W
// k-tiles (256 output columns x 128 bytes, 128B-swizzled) full by TMA.  The
// two CTAs of a cluster take consecutive 128-row blocks and each loads half
// of every W k-tile, multicast to both, so W reaches the SMs once per 256
// rows.  The A operand is resident: when a tile starts a new row block,
// each consumer warp LayerNorms its 16 rows in f32 and quantizes them per
// row into the CTA's 128 x C int8 operand in shared memory (C/128
// 128B-swizzled k-blocks), the row scales beside it, once for all the
// column tiles of the row block that the CTA takes in a row (Cfg::LN_ROWS
// rows a warp at a time: more spill).  The grid is persistent (as many
// clusters as fit): each
// cluster walks a contiguous run of units of `group` column tiles in
// row-major order, so its tiles share their rows.  The epilogue dequantizes
// into a 128B-swizzled staging tile in shared memory, half a tile at a
// time, from which the warpgroup's first thread stores it by TMA while the
// threads go on.  (K1's epilogue, 16-byte stores from registers after a
// quad transpose, measured slower here.)
//
// Work at 32·577 rows, C = 768, O = 2304: 73 row pairs x 9 column tiles =
// 657 cluster tiles on 66 clusters (10 rounds at group 1); LN passes
// ~(145 + 132) x 128 rows, x read from L2 ~2x; W 657 x 196 KB = 129 MB of
// L2 reads.  The design before (64 x 384 tiles, 1734 CTAs) normalised and
// quantized every row six times and read W from L2 by each of its 289 row
// blocks (511 MB), on mma.sync.
//
// Shared memory at C = 768: the A operand 96 KB, 3 x 32 KB of W, the
// staging 32 KB, 128 row scales, barriers, 1 KB alignment slack: 225.6 KB.
// At C = 1024 the A operand is 128 KB, and the ring holds two stages of W
// beside the staging: 225.5 KB.  (Three stages and no staging, the tile
// stored from registers as K1 stores it, fit too, and ran 8% slower on
// the card: PERF.md.)  Built for C = 768 and 1024 (Cfg); O a multiple of
// 256.
#include "hopper.cuh"
#include "int8.cuh"

using namespace vlm;

namespace {

constexpr int BM = 128, TN = 256, CL = 2;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128, CONSUMER_WARPS = CONSUMERS / 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int kAtom = BM * 128;   // a k-block of the CTA's rows
constexpr int W_BYTES = TN * 128;  // a W k-tile
// a warpgroup's staging: 64 rows x 128 columns of bf16 as two 64 x 64 boxes
constexpr int kBox = 64 * 128, STG_WG = 2 * kBox;

// The width's layout: KB k-blocks of 128 int8 values; LN_ROWS rows a warp
// normalises and quantizes at once (ptxas compiles the kernel for 168
// registers a thread: at C = 1024 four rows of x spill); STAGES W k-tiles
// in the ring, beside the epilogue's staging.
template <int C>
struct Cfg {
  static constexpr int KB = C / 128;
  static constexpr int LN_ROWS = C <= 768 ? 4 : 2;
  static constexpr int STAGES = C <= 768 ? 3 : 2;
  static constexpr int RING = KB * kAtom, STG = RING + STAGES * W_BYTES;
  static constexpr int SCALE = STG + 2 * STG_WG, BAR = SCALE + BM * 4;
  static constexpr int SMEM = 1024 + BAR + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "over the H100's shared memory per block");
};

struct Args {
  const bf16* x;
  const float *ln_w, *ln_b, *ws, *bias;
  int M, ncb, units, group;  // units: row pairs x ncb / group
  float eps;
};

// The byte offset of row r, byte column col, in the A operand: k-block
// col / 128, 128B-swizzled.
__device__ __forceinline__ int swz(int r, int col) {
  return (col >> 7) * kAtom + r * 128 + ((((col >> 4) & 7) ^ (r & 7)) << 4) + (col & 15);
}

template <int C>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
    ln_linear_i8_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap ymap, const Args a) {
  using F = Cfg<C>;
  constexpr int KB = F::KB, STAGES = F::STAGES;
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* base = raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
  int8_t* A = reinterpret_cast<int8_t*>(base);
  uint8_t* ring = base + F::RING;
  float* scale = reinterpret_cast<float*>(base + F::SCALE);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + F::BAR);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CL * CONSUMER_WARPS);
    }
    hop::fence_mbar_init();
  }
  hop::cluster_sync();  // both CTAs' barriers exist before any multicast or remote arrive

  const int rank = (int)hop::cluster_rank();
  const int pair = blockIdx.x / CL, npairs = gridDim.x / CL;
  const int t_begin = (int)((long long)pair * a.units / npairs) * a.group;
  const int t_end = (int)((long long)(pair + 1) * a.units / npairs) * a.group;

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: its first thread fills the ring with the W k-tiles,
    // its half of each multicast to both CTAs
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int cb = t % a.ncb;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % STAGES;
          // the stage's previous use released by every consumer warp of the cluster
          if (it >= STAGES) hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&full[s], W_BYTES);
          hop::tma_load_2d_multicast(ring + s * W_BYTES + rank * (W_BYTES / CL), &wmap, kb * 128,
                                     cb * TN + rank * (TN / CL), &full[s],
                                     (uint16_t)((1u << CL) - 1));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64wg.. of the CTA's tile, warp
    // w of the CTA rows 16w.. (wr), this thread rows wr + g and wr + g + 8
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, wg = warp >> 2, wr = 16 * warp;
    const bool lead = (threadIdx.x & 127) == 0;  // the warpgroup's first thread
    const uint64_t dA = hop::sw128_desc(A + wg * 64 * 128);
    auto release = [&](int s) {  // every lane of the warp is past its wgmma wait
      if (lane == 0)
        for (int r = 0; r < CL; ++r) hop::mbar_arrive_remote(&empty[s], r);
    };
    int acc[TN / 2];
    float s0 = 0.f, s1 = 0.f;  // the quantizer scales of the thread's two rows
    int it = 0, cur_rb = -1;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int rb = (tile / a.ncb) * CL + rank, cb = tile % a.ncb;
      const int row0 = rb * BM;
      if (rb != cur_rb) {
        // LN and quantize the warp's 16 rows into the A operand, LN_ROWS at
        // a time, once the warpgroup's products on the previous rows are done
        hop::named_sync(1 + wg, 128);
#pragma unroll 1
        for (int i = 0; i < 16; i += F::LN_ROWS) {
          const int r = wr + i;
          ln_quant_rows_at<F::LN_ROWS, C / 256>(
              a.x + (size_t)(row0 + r) * C, C, a.M - (row0 + r), a.ln_w, a.ln_b, a.eps,
              [&](int j, int col) { return A + swz(r + j, col); }, scale + r, 1);
        }
        hop::fence_proxy_async();  // the operand's generic writes before wgmma reads them
        hop::named_sync(1 + wg, 128);
        s0 = scale[wr + g];
        s1 = scale[wr + g + 8];
        cur_rb = rb;
      }
      // acc = A·Wᵀ over the six k-blocks, one ring stage each; a stage is
      // released once the products of the next have been issued and it has
      // retired
#pragma unroll
      for (int kb = 0; kb < KB; ++kb, ++it) {
        const int s = it % STAGES;
        const uint64_t dW = hop::sw128_desc(ring + s * W_BYTES);
        hop::mbar_wait(&full[s], (it / STAGES) & 1);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // the tile's first product overwrites acc
          hop::wgmma_s8<TN>(acc, hop::desc_add(dA, kb * kAtom + kk * 32),
                            hop::desc_add(dW, kk * 32), kb == 0 && kk == 0);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        if (kb > 0) release((it - 1) % STAGES);
      }
      hop::wgmma_wait<0>();
      release((it - 1) % STAGES);
      hop::fence_regs(acc);

      // epilogue: y = bf16(((acc · s) · ws) + b),
      // staged and stored by TMA in two halves of 128 columns: the
      // warpgroup's 64 rows of a half as two 64 x 64 boxes, 128B-swizzled
      // (row r's 8-column chunk ch at chunk ch ^ (r % 8)), while the next
      // half is computed and the next tile's products run
      uint8_t* stg = base + F::STG + wg * STG_WG;
      const int lr = 16 * (warp & 3) + g;  // the thread's first row in the warpgroup's 64
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (lead) hop::bulk_wait_read<0>();  // the previous store has read the staging
        hop::named_sync(1 + wg, 128);
#pragma unroll
        for (int jb = 0; jb < 16; ++jb) {
          const int j = 16 * hf + jb, col = cb * TN + 8 * j + 2 * t;
          const float2 w2 = __ldg(reinterpret_cast<const float2*>(a.ws + col));
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(a.bias + col));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = lr + 8 * hh;
            const float s = hh ? s1 : s0;
            *reinterpret_cast<uint32_t*>(stg + (jb >> 3) * kBox + r * 128 +
                                         (((jb & 7) ^ (r & 7)) << 4) + 4 * t) =
                pack_bf16(dequant(acc[4 * j + 2 * hh], s, w2.x, b2.x),
                          dequant(acc[4 * j + 2 * hh + 1], s, w2.y, b2.y));
          }
        }
        hop::fence_proxy_async();  // the staging's generic writes before the TMA reads them
        hop::named_sync(1 + wg, 128);
        if (lead) {
          for (int box = 0; box < 2; ++box)
            hop::tma_store_2d(&ymap, stg + box * kBox, cb * TN + 128 * hf + 64 * box,
                              row0 + 64 * wg);
          hop::bulk_commit();
        }
      }
    }
    if (lead) hop::bulk_wait<0>();  // the last stores are complete
  }
  hop::cluster_sync();  // no CTA leaves while its peer may still multicast or arrive into it
}

template <int C>
int grid_of() {
  constexpr int smem = Cfg<C>::SMEM;
  if (cudaFuncSetAttribute(ln_linear_i8_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, ln_linear_i8_kernel<C>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters * CL;
}

template <int C>
int launch(const void* w, void* y, int O, const Args& a, int grid, cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(ln_linear_i8_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap wmap, ymap;
  if (!hop::make_tensor_map_i8(&wmap, w, O, C, TN / CL, 128) ||
      !hop::make_tensor_map(&ymap, y, a.M, O, 64, 64))
    return (int)cudaErrorNotSupported;
  const int clusters = a.units < grid / CL ? a.units : grid / CL;
  ln_linear_i8_kernel<C><<<clusters * CL, THREADS, smem, stream>>>(wmap, ymap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The CTAs of K14's persistent grid at width C: as many whole clusters of
// two as fit on the device at once (0 at a width it is not built for).  The
// caller queries it once per process and width (the port runs on one
// card).
extern "C" int vlm_ln_linear_i8_grid(int C) {
  switch (C) {
    case 768:
      return grid_of<768>();
    case 1024:
      return grid_of<1024>();
    default:
      return 0;
  }
}

// grid: the value of vlm_ln_linear_i8_grid(width); group: column tiles of
// 256 per unit of work (a divisor of O / 256).
extern "C" int vlm_ln_linear_i8(const void* x, const void* ln_w, const void* ln_b,
                                const void* w, const void* ws, const void* b, void* y, int M,
                                int width, int O, int grid, int group, float eps, void* stream) {
  if (M <= 0 || O <= 0 || O % TN != 0 || grid < CL || grid % CL != 0 || group <= 0 ||
      (O / TN) % group != 0)
    return (int)cudaErrorInvalidValue;
  const int ncb = O / TN, units = (M + BM * CL - 1) / (BM * CL) * (ncb / group);
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
               static_cast<const float*>(ln_b), static_cast<const float*>(ws),
               static_cast<const float*>(b), M, ncb, units, group, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 768:
      return launch<768>(w, y, O, a, grid, s);
    case 1024:
      return launch<1024>(w, y, O, a, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
