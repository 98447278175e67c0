#!/usr/bin/env python3
"""Where the device time goes on the port's main paths (needs one NVIDIA
GPU):

    python3 chip_profile.py

Traces, with ``torch.profiler`` (CPU and CUDA activities), one warm call
of each window at ``chip_smoke.py``'s shapes and seeded inputs:
  * ``eval``: ``compute_irtr_recall`` over 64 images and 320 captions;
  * ``eval int8``: the same in the W8A8 int8 eval mode (``eval_int8``:
    K14 → K2 → K15 per image block); ``image tower int8`` and ``image
    tower int8-QK``: its image tower over the 64 images, and with the
    int8-QK attention (``qk_int8``: K14 → K12 → K15);
  * ``eval @224``: the Flickr30k @224 eval over 70 images (batches of 32,
    32 and 6: K11, K11, K10 in every block) and 350 captions;
  * ``train @224 (kernels)``: one optimizer step of the f30k @224
    fine-tune (2 micro-batches of 32 pairs; K11 forward in every image
    block under ``fused_attention``, K13 in every block);
  * ``image tower, fusion <route>``: ``extract_features`` over the 64
    images under each eval-block route ("pair" K1 → K2 → K4 → K5, "tail"
    K1 → K2 → K3, "qkv" K8 → K3, "mega" K7);
  * ``train (kernels)`` / ``train (kernels, train_fusion full)`` /
    ``train (plain)``: one optimizer step (2 micro-batches of 32 pairs) on
    the kernel path, on the kernel path under the training fusion "full"
    (K1 and K6 in every block) and on the plain path (K9's three CUDA
    kernels, D + dq, dk/dv + dbias partials and the partial sum, show
    separately);
  * ``eval ViT-L`` / ``image tower ViT-L, fusion <route>`` / ``eval
    ViT-L int8`` / ``train ViT-L (kernels)``: the ViT-L @384 width
    (C=1024, 16 heads, MLP 4096, 24 layers): ``compute_irtr_recall`` over
    32 images and 64 captions, the image tower over the 32 images by
    "tail" (K1 → K2 → K3) and by "mega" (K7), the same eval in the W8A8
    int8 mode (K14 → K2 → K15 per image block), and one optimizer step of
    one micro-batch of 8 pairs on the kernel path.
For each window it prints the host wall time, the device busy time (the
union of the device kernels' intervals), the idle share (1 − busy / wall)
and the kernels with the most device time.

``python3 chip_profile.py --int8`` runs only the three int8 windows.
Last come the fused VL pass's windows (``python3 chip_profile.py --vl``
runs them alone): ``VQA @480 bf16`` and ``VQA @480 W8A8``,
``vqa_predictions`` over 2 batches of 32 questions (ufo; 40 text and 901
image tokens, the joint 941 in layers 10-11); ``NLVR2 @384 ufo``, the
paired pass over 32 pairs; and the @384 eval with the ITM rerank (top 4,
64 pairs a fused pass).  ``python3 chip_profile.py --objectives`` runs
the training objectives' windows alone: one optimizer step each of the
NLVR2 @384 fine-tune (2 x 16 pairs) and the VLMo pretrain @224 (32
pairs), kernel and plain path, and of the all-in-one pretrain (16 images,
texts and pairs; kernel path).  ``python3 chip_profile.py --preprocess``
runs the device-side preprocessing's windows alone (``chip_smoke.py``
phase 16): the canvas resize of 64 images and its parts (the weights,
the two exact passes, the normalization), the train augment of 16 images
and its parts (the crop-resize, each RandAugment candidate, a stage),
the whole-word masking's draws and core, and the VLMo pretrain @224 step
with the device preprocessing and on host-made inputs (a traced window
each, then 6 steps of each in turns).

``python3 chip_profile.py --variants`` runs only this: K1, K2, K7, K8, K14,
K15 and K12 beside design variants that their sources rejected, each built from a
patched copy of ``vl_merging_tpu_torch/csrc`` into ``build/variants/``
(one nvcc per variant, all at once; its ptxas spill bytes printed) and
timed in turns with the built kernel through the same wrapper, at
``chip_smoke.py``'s main-path shapes (B=32, N=577; K1 at C=768 and 1024,
K2 at 12 and 16 heads): K1 without its cluster of two CTAs sharing each W
tile by TMA multicast, K1 releasing its ring stages at cluster scope, K2
without the ping-pong of its two consumer warpgroups, K2 with a whole
64-key last key tile, K7 with K1's and K2's own CTA of three warpgroups (a
``setmaxnreg`` budget per phase, or one budget of 168 registers; their
phase split too), K15 with its pass 1 on the hidden
warpgroup alone or with every fourth chunk on the output warpgroup, K15
with weight rings of two stages each (at C=768), K2 with
K8's element-major item order, K14 normalising twice the rows a warp at a
time, K14 at C=1024 with three W stages and the tile stored from
registers (no staging), K12 (at 12 and 16 heads) converting its s32
logits by I2F, quantizing each k tile one tile behind its loads (not as
soon as it lands), without the ping-pong, rounding q and k by F2I, or
at the register budgets 184 / 160; K7, K14 and K15 are timed at C=768 and at the
ViT-L width (C=1024, 16 heads, MLP 4096); seven diagnostics that
change the output, timed to show what a part costs: K1 without its stores,
K8 with its K2 role not waiting for its elements, K14 without its LN pass,
K14 without its epilogue, K12 without its producer's quantization, K12
without its dequantization (the bias alone), and K2's bf16 q·kᵀ at K12's
register budgets.  And, through the wrappers' own
arguments (no rebuild): K8's two roles from its trace (``ln_qkv_attention
(..., trace=...)``: when each role's CTAs end and how long the K2 role
waits) at three splits and two units, beside K1 and K2 alone; K8 with its
K1 role on 8 CTAs fewer or more than ``ln_qkv_attention_split`` gives it,
or dealing units of 3 column tiles (q, k, v) or whole row pairs (9)
instead of single tiles; K14 in units of 3 column tiles.  K10 (B=6) and
K11 (B=32) at N=197, their per-call and device times (a CUDA graph): K10
with 64-row items (K7's CTA of one consumer warpgroup), K11 taking a
group's 4 elements (or a pair) back to back with each bias tile copied
once for the group (the TPU kernel's resident bias block); and K10's
wrapper's host µs a call beside its parts and K2's wrapper's.  ``--variants K10 K11 --parent
TREE`` also times the K10 and K11 of the tree at TREE (another checkout,
its wrappers and its kernels built from its own sources) beside this
tree's: per call, device time and the wrappers' host µs.  ``--variants
K7`` (any of K1, K2, K7, K8, K14, K15, K10, K11, K12) runs those kernels'
variants alone.

``python3 chip_profile.py --digests TREE`` runs only this: the SHA-256 of
the outputs of K2, K7, K8, K10, K11, K12, K14 and K15 at C=768 on
``chip_smoke.py``'s phase 3 inputs, through this tree's kernels and
through those of the tree at TREE (another checkout's root, its wrappers
and kernels built from its own sources).

``python3 chip_profile.py --c8`` runs only this: fault C8's two repairs of
K9's row sums D side by side (``c8_repairs``): the built one, D = Σ_k dp ⊙ p
in a first pass over the keys, and an f32 context stored by K2's training
launch, built from patched sources (``C8_F32_CONTEXT``); each against its
twin fed the plain forward and against the plain backward, K9 and K2's
training launch in turns, and the @384 train step's time and peak memory
in turns.

First, K7's phase split (``python3 chip_profile.py --k7`` runs it alone):
one traced launch of K7 (``block_eval(..., trace=...)``) at
``chip_smoke.py``'s main-path shapes (B=32, N=577) gives, per CTA, the time
in phase A (K1's tiles), at its grid barrier, in phase B (K2's items), at
its barrier, in phase C (the MLP body's 64-row blocks) and at its barrier,
and the units each CTA took; beside it K7's grid against the SMs, its chunk
size, K7 untraced and traced, and the staged K1, K2 and K3 at the same
shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from vl_merging_tpu_torch import dvae
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, master_params
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.device import require_cuda
from vl_merging_tpu_torch.evaluation import downstream
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall, \
    extract_features
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import _build
from vl_merging_tpu_torch.ops import attention as attn_ops
from vl_merging_tpu_torch.ops import fused_block as fb_ops
from vl_merging_tpu_torch.ops import int8 as i8_ops
from vl_merging_tpu_torch.ops.fused_block import FUSIONS
from vl_merging_tpu_torch.train.loop import accum_steps, build_train_step

TOP = 14


def _device_kernels(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_ms(kernels) -> float:
    """The union of the kernels' [start, end) intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def trace(name: str, fn, card: str) -> None:
    fn()                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = _device_kernels(prof)
    busy = _busy_ms(kernels)
    print(f"== {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall:.4f}, {len(kernels)} device kernels "
          f"[{card}]")
    by_name = {}
    for k in kernels:
        ms, count = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (ms + (k.time_range.end - k.time_range.start) / 1e3,
                           count + 1)
    for kname, (ms, count) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{count:<5d} "
              f"{kname[:100]}")


def k7_phases(dev, card: str) -> None:
    """K7's per-CTA phase trace at the main-path shapes, beside the staged
    K1, K2 and K3 (see the module's docstring)."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    inputs = smoke.kernel_inputs(dev, gen)
    inputs.update(smoke.fusion_inputs(inputs))
    args = inputs["block_eval"]
    B, N = args[0].shape[:2]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = fb_ops.block_eval_grid(smoke.C)
    clusters = grid // 4
    bb = fb_ops.block_eval_chunk(B, N, smoke.C, clusters)
    k7_ms = smoke.time_ms(lambda: fb_ops.block_eval(*args))
    counters = torch.zeros(grid, 12, dtype=torch.int64, device=dev)

    def traced():
        counters.zero_()
        fb_ops.block_eval(*args, trace=counters)
    traced_ms = smoke.time_ms(traced)
    traced()
    torch.cuda.synchronize()
    t = counters.cpu().numpy().astype(np.float64)
    ms = t[:, :6] / 1e6
    tiles, items, blocks = t[:, 6], t[:, 7], t[:, 8]
    span = (t[:, 10].max() - t[:, 9].min()) / 1e6
    print(f"== K7 phases (B={B}, N={N}): grid {grid} CTAs ({clusters} "
          f"clusters of 4) on {sms} SMs, {sms - grid} SMs idle; chunks of "
          f"{bb} elements ({int(t[0, 11])} chunks); K7 {k7_ms:.4f} ms, traced "
          f"{traced_ms:.4f} ms, traced span {span:.4f} ms [{card}]")
    for i, label in enumerate(("phase A (K1's tiles)", "barrier A",
                               "phase B (K2's items)", "barrier B",
                               "phase C (the body's blocks)", "barrier C")):
        print(f"   {label:28s} per CTA: mean {ms[:, i].mean():.4f} ms, "
              f"min {ms[:, i].min():.4f}, max {ms[:, i].max():.4f}")
    for label, col, n in (("A", 0, tiles), ("B", 2, items), ("C", 4, blocks)):
        print(f"   phase {label}: {int(n.min())}-{int(n.max())} units per CTA, "
              f"{(ms[:, col] / np.maximum(n, 1)).mean():.4f} ms per unit")
    x, l1w, l1b, wqkv, bqkv, bias, mask, scale, heads = args[:9]
    qkv = fb_ops.ln_linear(x, l1w, l1b, wqkv, bqkv)
    ctx = attn_ops.packed_attention(qkv, bias, mask, scale, heads)
    k1_ms = smoke.time_ms(lambda: fb_ops.ln_linear(x, l1w, l1b, wqkv, bqkv))
    k2_ms = smoke.time_ms(
        lambda: attn_ops.packed_attention(qkv, bias, mask, scale, heads))
    k3_ms = smoke.time_ms(lambda: fb_ops.proj_mlp_tail(ctx, *args[9:12], x,
                                                       *args[12:]))
    print(f"   staged: K1 {k1_ms:.4f} ms, K2 {k2_ms:.4f} ms, K3 {k3_ms:.4f} "
          f"ms, sum {k1_ms + k2_ms + k3_ms:.4f}; K7 / sum "
          f"{k7_ms / (k1_ms + k2_ms + k3_ms):.3f} [{card}]")


def k8_roles(dev, card: str) -> None:
    """K8's two roles at the main-path shapes (B=32, N=577), for its split
    and order and a few others: K8's time, and from a traced launch the
    span of its K1 role (the launch's first time stamp to each K1 CTA's
    last), the span of its K2 role and the time its K2 CTAs spent waiting
    for elements, mean and max per CTA; beside K1 and K2 alone."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    inputs = smoke.kernel_inputs(dev, gen)
    inputs.update(smoke.fusion_inputs(inputs))
    args = inputs["ln_qkv_attention"]
    B, N, C = args[0].shape
    grid = fb_ops.ln_qkv_attention_grid(C)
    ga = fb_ops.ln_qkv_attention_split(grid, B, N, C, args[8])
    qkv = fb_ops.ln_linear(*args[:5])
    k1_ms = smoke.time_ms(lambda: fb_ops.ln_linear(*args[:5]))
    k2_ms = smoke.time_ms(lambda: attn_ops.packed_attention(qkv, *args[5:]))
    print(f"== K8 roles (B={B}, N={N}, C={C}): grid {grid} CTAs; K1 alone "
          f"{k1_ms:.4f} ms, K2 alone {k2_ms:.4f} ms, sum {k1_ms + k2_ms:.4f} "
          f"[{card}]")
    for split in sorted({ga - 4, ga, ga + 4}):
        for unit in (1, 3):
            def call(**kw):
                return fb_ops.ln_qkv_attention(*args, split=split, unit=unit,
                                               **kw)
            ms = smoke.time_ms(call)
            trace = torch.zeros(grid, 4, dtype=torch.int64, device=dev)
            call(trace=trace)
            t = trace.double().cpu().numpy()
            t0 = t[:, 0].min()
            k1, k2 = t[:split], t[split:]
            print(f"   K1 role on {split} CTAs, units of {unit}: K8 {ms:.4f} "
                  f"ms; K1 role ends at {(k1[:, 1] - t0).mean() / 1e6:.4f} / "
                  f"{(k1[:, 1] - t0).max() / 1e6:.4f} ms (mean / max), "
                  f"{k1[:, 3].min():.0f}-{k1[:, 3].max():.0f} tiles a CTA; K2 "
                  f"role ends at {(k2[:, 1] - t0).mean() / 1e6:.4f} / "
                  f"{(k2[:, 1] - t0).max() / 1e6:.4f} ms, waits "
                  f"{k2[:, 2].mean() / 1e6:.4f} / {k2[:, 2].max() / 1e6:.4f} "
                  f"ms, {k2[:, 3].min():.0f}-{k2[:, 3].max():.0f} items a CTA")


def k11_groups(g: int) -> list:
    """K11's group variant: a CTA takes the items of a group of g elements
    (one query tile and head) back to back, units of groups dealt to the
    CTAs in turn; its producer skips the copy of a bias tile that the stage
    it fills already holds (at N = 197 the 4 key tiles of an item fill the
    4 stages, so the group's later elements find all of theirs)."""
    return [
        ("packed_attention_fwd.cuh", "item += its.stride", "item = its.next(item)"),
        ("packed_attention_fwd.cuh",
         "  __device__ __forceinline__ Items() : first(blockIdx.x), stride(gridDim.x) {}\n",
         "  __device__ __forceinline__ Items() : first(blockIdx.x), stride(gridDim.x) {}\n"
         "  __device__ __forceinline__ int next(int item) const { return item + stride; }\n"),
        ("packed_attention_fwd.cuh",
         "  const int pt = threadIdx.x - K::CONSUMERS;\n  int it = 0;\n",
         "  const int pt = threadIdx.x - K::CONSUMERS;\n  int it = 0;\n"
         "  int held[STAGES];  // the (head, query tile, key tile) of each stage's bias\n"
         "  for (int q = 0; q < STAGES; ++q) held[q] = -1;\n"),
        ("packed_attention_fwd.cuh",
         "      float* bt = reinterpret_cast<float*>(st + 2 * KV_BYTES);\n",
         "      float* bt = reinterpret_cast<float*>(st + 2 * KV_BYTES);\n"
         "      const int key = (h * a.nqt + qt) * nkt + j;\n"
         "      const bool copy = held[s] != key;\n"
         "      held[s] = key;\n"),
        ("packed_attention_fwd.cuh", "if (f[m] != ~(size_t)0 && at < f[m] + N)",
         "if (copy && f[m] != ~(size_t)0 && at < f[m] + N)"),
        ("split_attention.cu", "using GroupOrder = Items;\n", f"""struct GroupOrder {{
  int first, stride;
  __device__ __forceinline__ GroupOrder() : first({g} * blockIdx.x), stride(gridDim.x) {{}}
  __device__ __forceinline__ int next(int item) const {{
    return item % {g} != {g} - 1 ? item + 1 : item + 1 + {g} * (stride - 1);
  }}
  __device__ __forceinline__ void decode(const Args& a, int item, int& b, int& qt, int& h) const {{
    const int u = item / {g}, groups = a.B / {g};
    b = {g} * (u % groups) + item % {g};
    qt = u / groups % a.nqt;
    h = u / groups / a.nqt;
  }}
  __device__ __forceinline__ void ready(int) const {{}}
}};
"""),
    ]


# K14's epilogue at C=1024 stored from registers as K1 stores it (per pair
# of 8-column blocks the four threads of a quad trade their column pairs, a
# 4 x 4 transpose of bf16x2 words, so that each stores one row's 8 columns
# in one 16-byte store), inserted before the staged epilogue, which it skips
K14_REGISTER_EPILOGUE = """      if constexpr (C > 768) {
        const int row = row0 + wr + g;
#pragma unroll
        for (int p = 0; p < TN / 16; ++p) {
          uint32_t u[4];  // u[2jj + hh]: block 2p + jj, row + 8hh, columns 2t, 2t + 1
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * p + jj, col = cb * TN + 8 * j + 2 * t;
            const float2 w2 = __ldg(reinterpret_cast<const float2*>(a.ws + col));
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(a.bias + col));
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float s = hh ? s1 : s0;
              u[2 * jj + hh] = pack_bf16(dequant(acc[4 * j + 2 * hh], s, w2.x, b2.x),
                                         dequant(acc[4 * j + 2 * hh + 1], s, w2.y, b2.y));
            }
          }
          uint32_t c[4];  // chunk t of the four: its word w from quad lane w
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = (t - i) & 3, src = (t + i) & 3;
            const uint32_t send = k == 0 ? u[0] : k == 1 ? u[1] : k == 2 ? u[2] : u[3];
            const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
            for (int w = 0; w < 4; ++w)
              if (src == w) c[w] = got;
          }
          const int rr = row + 8 * (t & 1);
          if (rr < a.M)
            *reinterpret_cast<uint4*>(a.y + (size_t)rr * a.O + cb * TN + 8 * (2 * p + (t >> 1))) =
                make_uint4(c[0], c[1], c[2], c[3]);
        }
        continue;
      }
"""

# name: (kernel, [(file, text, replacement)]): the design variants each
# kernel's source rejected, each a patch of csrc/
VARIANTS = {
    "K1 without the cluster (CL = 1: W read once per 128 rows)": (
        "K1", [("ln_linear.cuh", "constexpr int CL = 2;", "constexpr int CL = 1;")]),
    "K1 releasing its stages with cluster-scope semantics": (
        "K1", [("ln_linear.cuh", "hop::mbar_arrive_remote(&empty[s], peer0 + r)",
                "hop::mbar_arrive_cluster(&empty[s], peer0 + r)")]),
    "K2 without the warpgroups' ping-pong": (
        "K2", [("packed_attention_fwd.cuh",
                "  if constexpr (NC == 2) hop::named_sync(1 + (threadIdx.x >> 7), 256);\n", ""),
               ("packed_attention_fwd.cuh",
                "  if constexpr (NC == 2) hop::named_arrive(2 - (threadIdx.x >> 7), 256);\n", ""),
               ("packed_attention_fwd.cuh", "  if (NC == 2 && wg == 1) hop::named_arrive(1, 256);",
                ""),
               ("packed_attention_fwd.cuh", "  if (NC == 2 && wg == 0) hop::named_sync(1, 256);",
                "")]),
    "K2 with a whole 64-key last tile": (
        "K2", [("packed_attention_fwd.cuh",
                "  const int w_last = N - (nkt - 1) * BKV > 32 ? 64 : "
                "N - (nkt - 1) * BKV > 16 ? 32 : 16;", "  const int w_last = 64;")]),
    "K7 with K1's and K2's CTA (three warpgroups, a setmaxnreg budget per phase: "
    "A 232/40, B 168, C 240/24)": (
        "K7", [("block_eval.cu", "constexpr int NC = 1, kTN = 128 * NC;",
                "constexpr int NC = 2, kTN = 128 * NC;")]),
    "K7 with K1's and K2's CTA at one budget (three warpgroups, 168 registers)": (
        "K7", [("block_eval.cu", "constexpr int NC = 1, kTN = 128 * NC;",
                "constexpr int NC = 2, kTN = 128 * NC;"),
               ("block_eval.cu", "NC == 2 && R", "NC == 0 && R")]),
    "K15 with pass 1 on the hidden warpgroup alone": (
        "K15", [("proj_mlp_tail_i8.cu", "constexpr int kOutEvery = 2;",
                 "constexpr int kOutEvery = 1 << 20;")]),
    "K15 with pass 1's every fourth chunk on the output warpgroup": (
        "K15", [("proj_mlp_tail_i8.cu", "constexpr int kOutEvery = 2;",
                 "constexpr int kOutEvery = 4;")]),
    "K15 with weight rings of two stages each (at C=768; at 1024 four is the "
    "least)": (
        "K15", [("proj_mlp_tail_i8.cu", "SLOTS0 = C <= 768 ? 3 : 4, SLOTS1 = SLOTS0;",
                 "SLOTS0 = C <= 768 ? 2 : 4, SLOTS1 = SLOTS0;")]),
    "K2 with element-major items (K8's order, nothing to wait for)": (
        "K2", [("packed_attention_fwd.cuh", """    b = item % a.B;
    qt = item / a.B % a.nqt;
    h = item / a.B / a.nqt;""", """    b = item / (a.H * a.nqt);
    qt = item % a.nqt;
    h = item / a.nqt % a.H;""")]),
    "K8 with its K2 role not waiting (a diagnostic: wrong output)": (
        "K8", [("packed_attention_fwd.cuh", "    hop::wait_at_least(done + b, groups * ncb);",
                "    (void)groups;")]),
    "K1 without its stores (a diagnostic: no output)": (
        "K1", [("ln_linear.cuh", "      if (rr < a.M)\n        *reinterpret_cast<uint4*>(a.y",
                "      if (rr < 0)\n        *reinterpret_cast<uint4*>(a.y")]),
    "K14 without its LN pass (a diagnostic: wrong output)": (
        "K14", [("ln_linear_i8.cu", "for (int i = 0; i < 16; i += F::LN_ROWS) {",
                 "for (int i = 0; i < 0; i += F::LN_ROWS) {")]),
    "K14 normalising twice the rows a warp at a time (8 at C=768, 4 at 1024)": (
        "K14", [("ln_linear_i8.cu", "LN_ROWS = C <= 768 ? 4 : 2;",
                 "LN_ROWS = C <= 768 ? 8 : 4;")]),
    "K14 at C=1024 with three W stages and no staging (the tile stored from "
    "registers as K1 stores it)": (
        "K14", [("ln_linear_i8.cu", "STAGES = C <= 768 ? 3 : 2;", "STAGES = 3;"),
                ("ln_linear_i8.cu", "SCALE = STG + 2 * STG_WG,",
                 "SCALE = STG + (C <= 768 ? 2 * STG_WG : 0),"),
                ("ln_linear_i8.cu", "    if (lead) hop::bulk_wait<0>();",
                 "    if (C <= 768 && lead) hop::bulk_wait<0>();"),
                ("ln_linear_i8.cu", "  int M, ncb, units, group;",
                 "  bf16* y;\n  int M, O, ncb, units, group;"),
                ("ln_linear_i8.cu", "static_cast<const float*>(b), M, ncb,",
                 "static_cast<const float*>(b), static_cast<bf16*>(y), M, O, ncb,"),
                ("ln_linear_i8.cu", "      uint8_t* stg = base + F::STG + wg * STG_WG;\n",
                 K14_REGISTER_EPILOGUE
                 + "      uint8_t* stg = base + F::STG + wg * STG_WG;\n")]),
    "K14 without its epilogue (a diagnostic: no output)": (
        "K14", [("ln_linear_i8.cu", "for (int hf = 0; hf < 2; ++hf) {",
                 "for (int hf = 0; hf < 0; ++hf) {")]),
    "K10 with 64-row items (K7's CTA of one consumer warpgroup)": (
        "K10", [("split_attention.cu", "constexpr int kNC = 2;",
                 "constexpr int kNC = 1;")]),
    "K11 taking a group's 4 elements back to back, each bias tile copied "
    "once for the 4": ("K11", k11_groups(4)),
    "K11 taking pairs of elements back to back, each bias tile copied once "
    "for the 2": ("K11", k11_groups(2)),
}
# K12's rejected variants (patches of csrc/): its s32 logits converted by
# I2F (the conversion the design avoids); each k tile quantized one tile
# behind its loads (so that the loads never wait for a tile to land); no
# ping-pong of the consumer warpgroups (K2's variant, the same device
# code); q and k rounded by F2I; the register budgets the first build took.
VARIANTS["K12 converting its s32 logits by I2F (__int2float_rn)"] = (
    "K12", [("int8.cuh",
             "  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);",
             "  return __int2float_rn(x);")])
VARIANTS["K12 quantizing each k tile one tile behind its loads"] = (
    "K12", [("packed_attention_fwd.cuh", """      if constexpr (Qk::kInt8) quant_k(st, &kfull[s], (it / STAGES) & 1, &full[s], pt);
    }
  }
}""", """      if constexpr (Qk::kInt8)
        if (it > 0) {
          const int u = (it - 1) % STAGES;
          quant_k(ring + u * K::STAGE, &kfull[u], ((it - 1) / STAGES) & 1, &full[u], pt);
        }
    }
  }
  if constexpr (Qk::kInt8)
    if (it > 0) {
      const int u = (it - 1) % STAGES;
      quant_k(ring + u * K::STAGE, &kfull[u], ((it - 1) / STAGES) & 1, &full[u], pt);
    }
}""")])
VARIANTS["K12 without the warpgroups' ping-pong"] = (
    "K12", VARIANTS["K2 without the warpgroups' ping-pong"][1])
VARIANTS["K12 quantizing q and k by F2I (__float2int_rn)"] = (
    "K12", [("packed_attention_fwd.cuh", "quantize_alu(", "quantize(")])
VARIANTS["K12 with registers 184 / 160 (producer / consumers)"] = (
    "K12", [("packed_attention_i8qk.cu", "PRODUCER_REGS = 200, CONSUMER_REGS = 152",
             "PRODUCER_REGS = 184, CONSUMER_REGS = 160")])
# three diagnostics that change the output, timed to show what a part of
# K12 costs: its producer waiting for each k tile without quantizing it,
# its logits taking the bias alone (no dequantization), and K2's bf16
# q·kᵀ at K12's register budgets
VARIANTS["K12 without its producer's quantization (a diagnostic: wrong "
         "output)"] = (
    "K12", [("packed_attention_fwd.cuh",
             "      if constexpr (Qk::kInt8) quant_k(st, &kfull[s], (it / STAGES) & 1, &full[s], pt);",
             "      if constexpr (Qk::kInt8) {\n"
             "        hop::mbar_wait(&kfull[s], (it / STAGES) & 1);\n"
             "        hop::mbar_arrive(&full[s]);\n"
             "      }")])
VARIANTS["K12 without its dequantization (a diagnostic: the bias alone)"] = (
    "K12", [("packed_attention_fwd.cuh",
             "    return __fadd_rn(__fmul_rn(__fmul_rn(s32_to_f32(x), sq), sk), b);",
             "    return b;")])
VARIANTS["K2's bf16 q·kᵀ at K12's register budgets (a diagnostic)"] = (
    "K12", [("packed_attention_i8qk.cu", "setup<2, Int8Qk>", "setup<2, Bf16Qk>"),
            ("packed_attention_i8qk.cu", "produce<2, Items, Maps, Int8Qk>",
             "produce<2, Items, Maps, Bf16Qk>"),
            ("packed_attention_i8qk.cu", "consume<2, Items, Int8Qk>",
             "consume<2, Items, Bf16Qk>")])

# Fault C8's other repair, measured beside the built one (D = Σ_k dp ⊙ p,
# a first pass of K9's dq_kernel over the keys): K2's training launch also
# stores the f32 context (after three planes of statistics: m, l and the D
# K9 writes), and dq_kernel takes D = Σ_c g ⊙ o from it, without the first
# pass.  Its wrappers (``c8_wrappers``) give the launch that buffer.
C8_F32_CONTEXT = [
    ("packed_attention_fwd.cuh", """    if (a.stats != nullptr && t == 0) {
      const size_t srow""", """    if (a.stats != nullptr) {
      float* o32 = a.stats + 3 * (size_t)a.B * a.H * N + (size_t)b * N * C + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (row0 < N)
          *reinterpret_cast<float2*>(o32 + (size_t)row0 * C + n * 8) =
              make_float2(r.o[4 * n] / r.l0, r.o[4 * n + 1] / r.l0);
        if (row1 < N)
          *reinterpret_cast<float2*>(o32 + (size_t)row1 * C + n * 8) =
              make_float2(r.o[4 * n + 2] / r.l1, r.o[4 * n + 3] / r.l1);
      }
    }
    if (a.stats != nullptr && t == 0) {
      const size_t srow"""),
    ("packed_attention_bwd.cu",
     "  float d0 = 0.f, d1 = 0.f;  // D of the two rows: the thread's share, then the row's\n",
     """  float d0 = 0.f, d1 = 0.f;
  {
    const float* ob = stats + 3 * plane + (size_t)b * N * C + h * D + 2 * t;
    auto dot = [](uint32_t gw, const float* p) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&gw);
      const float2 y = *reinterpret_cast<const float2*>(p);
      return __low2float(x) * y.x + __high2float(x) * y.y;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (qrow0 < N)
        d0 += dot(ga[kk][0], ob + (size_t)qrow0 * C + kk * 16) +
              dot(ga[kk][2], ob + (size_t)qrow0 * C + kk * 16 + 8);
      if (qrow1 < N)
        d1 += dot(ga[kk][1], ob + (size_t)qrow1 * C + kk * 16) +
              dot(ga[kk][3], ob + (size_t)qrow1 * C + kk * 16 + 8);
    }
    d0 = group_sum(d0);
    d1 = group_sum(d1);
    if (inv0 == 0.f) d0 = 0.f;
    if (inv1 == 0.f) d1 = 0.f;
    if (t == 0) {
      if (qrow0 < N) stats[2 * plane + srow + qrow0] = d0;
      if (qrow1 < N) stats[2 * plane + srow + qrow1] = d1;
    }
  }
"""),
    ("packed_attention_bwd.cu", "  for (int it = 0; it < 2 * ntiles; ++it) {",
     "  for (int it = ntiles; it < 2 * ntiles; ++it) {"),
    ("packed_attention_bwd.cu", "    const int k0 = (it % ntiles) * TK, st = it & 1;",
     "    const int k0 = (it % ntiles) * TK, st = (it - ntiles) & 1;"),
]
VARIANTS["K9 with D from an f32 context stored by K2's training launch "
         "(C8 repair b)"] = ("K9b", C8_F32_CONTEXT)
# the variants timed at C=768 only: K7 with three warpgroups did not finish
# a launch at C=1024 within 900 s
AT_768_ONLY = {n for n in VARIANTS if n.startswith("K7 with K1's and K2's CTA")}
# the sources a kernel's variant library is built from (with tensor_map.cu;
# ln_linear.cu also exports vlm_error_string)
SOURCES = {"K1": ("ln_linear.cu",), "K2": ("packed_attention_fwd.cu", "ln_linear.cu"),
           "K7": ("block_eval.cu", "ln_linear.cu"),
           "K8": ("ln_qkv_attention.cu", "ln_linear.cu"),
           "K14": ("ln_linear_i8.cu", "ln_linear.cu"),
           "K15": ("proj_mlp_tail_i8.cu", "ln_linear.cu"),
           "K10": ("split_attention.cu", "ln_linear.cu"),
           "K11": ("split_attention.cu", "ln_linear.cu"),
           "K9b": ("packed_attention_bwd.cu", "packed_attention_fwd.cu",
                   "ln_linear.cu"),
           "K12": ("packed_attention_i8qk.cu", "ln_linear.cu")}


def spills(log: str) -> str:
    """The spill bytes ptxas reported in an nvcc log, summed."""
    st = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    ld = sum(int(m) for m in re.findall(r"(\d+) bytes spill loads", log))
    warned = [line.strip() for line in log.splitlines() if "setmaxnreg" in line]
    return f"{st} / {ld} bytes spill stores / loads" + "".join(
        f"; {w}" for w in warned)


def build_variants(kernels) -> dict:
    """Each variant of the kernels named, its library from a patched copy of
    csrc/ built with nvcc (all at once) into build/variants/<i>/, loaded
    with ctypes, with the ptxas spill summary of its build."""
    root = _build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, (kernel, patches)) in enumerate(VARIANTS.items()):
        if kernel not in kernels:
            continue
        d = root / str(i)
        shutil.copytree(_build.CSRC, d)
        for file, old, new in patches:
            text = (d / file).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {file}")
            (d / file).write_text(text.replace(old, new))
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             *(str(d / f) for f in SOURCES[kernel]), str(d / "tensor_map.cu"), "-ldl"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        lib.vlm_error_string.argtypes = [ctypes.c_int]
        lib.vlm_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, spills(log))
    return libs


# the grids the wrappers query once per process: each library's own
GRIDS = (fb_ops.block_eval_grid, fb_ops.ln_qkv_attention_grid,
         i8_ops.ln_linear_i8_grid)


@contextlib.contextmanager
def using(lib):
    """The wrappers launch from ``lib`` (a variant's library) meanwhile,
    with its own grids."""
    built = _build.library()
    _build._lib = lib
    for grid in GRIDS:
        grid.cache_clear()
    try:
        yield
    finally:
        _build._lib = built
        for grid in GRIDS:
            grid.cache_clear()


def load_parent_ops(root: Path, name: str):
    """The module ``ops.<name>`` of another tree of the port (its root
    ``root``), whose package is imported as ``parent_vlm``: its wrappers,
    and its library built from its own ``csrc/`` into its own
    ``build/``."""
    if "parent_vlm" not in sys.modules:
        pkg = root / "vl_merging_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_vlm", pkg / "__init__.py",
            submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules["parent_vlm"] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"parent_vlm.ops.{name}")


def parent_digests(root: Path, dev, card: str) -> None:
    """The SHA-256 of the outputs of K2, K7, K8, K10, K11, K12, K14 and K15
    at C=768 on ``chip_smoke.py``'s phase 3 inputs, through this tree's
    wrappers and kernels and through those of the tree at ``root``."""
    inputs = smoke.digest_inputs(dev)
    for name in smoke.DIGESTED:
        args = inputs[name]
        kernel = smoke.KERNELS[name][0]
        old = getattr(load_parent_ops(root, kernel.__module__.rsplit(".", 1)[1]),
                      name)
        new, was = (smoke.digest(k, args) for k in (kernel, old))
        print(f"digests: {name} at {'x'.join(map(str, args[0].shape))}: "
              f"this tree {new}, {root} {was}, equal: {new == was} [{card}]")


def parent_split(root: Path, inputs, card: str) -> None:
    """K10 (B=6) and K11 (B=32) at N=197 of the tree at ``root`` (its
    wrappers and kernels) beside this tree's, in turns: per-call time,
    device time alone (a CUDA graph), the wrapper's host µs a call, and
    whether the outputs are bit-equal."""
    old = load_parent_ops(root, "attention")
    for name in ("split_attention", "split_attention_bb"):
        args = inputs[name]

        def new_call(name=name, args=args):
            return getattr(attn_ops, name)(*args)

        def old_call(name=name, args=args):
            return getattr(old, name)(*args)
        same = torch.equal(new_call(), old_call())
        per_call = smoke.in_turns(new_call, old_call)
        device = smoke.in_turns(new_call, old_call, smoke.device_ms)
        us = (smoke.host_us(new_call), smoke.host_us(old_call))
        print(f"variants: {name} at {'x'.join(map(str, args[0].shape))}: "
              f"this tree per call {per_call[0]:.4f} ms, device "
              f"{device[0]:.4f} ms, host {us[0]:.2f} us; {root} per call "
              f"{per_call[1]:.4f} ms, device {device[1]:.4f} ms, host "
              f"{us[1]:.2f} us (in turns; outputs bit-equal: {same}) [{card}]")


def split_host(inputs, card: str) -> None:
    """Where K10's wrapper spends its host time (B=6, N=197): the whole
    call beside its parts, each alone, µs a call over 200 calls."""
    q, k, v, bias, mask, scale = args = inputs["split_attention"]
    dev = q.device
    B, H, N, d = q.shape
    key = ("vlm_split_attention", q.shape, k.shape, v.shape, q.stride(),
           k.stride(), v.stride(), (q.dtype, k.dtype, v.dtype),
           (dev, k.device, v.device, bias.device, mask.device), bias.shape,
           mask.shape)
    strides = attn_ops._split_strides(*key)
    out = torch.empty_strided(q.shape, (*strides[9:], 1), dtype=q.dtype,
                              device=dev)
    launch = _build.library().vlm_split_attention
    c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
              mask.data_ptr(), out.data_ptr(), B, N, H, *strides,
              float(scale))
    stream = _build.stream_handle(dev)
    parts = {
        "the wrapper (split_attention)": lambda: attn_ops.split_attention(
            *args),
        "the layout lookup (_split_strides, cached)": lambda:
            attn_ops._split_strides(*key),
        "torch.empty_strided of the output": lambda: torch.empty_strided(
            q.shape, (*strides[9:], 1), dtype=q.dtype, device=dev),
        "_build.stream_handle": lambda: _build.stream_handle(dev),
        "the C entry alone (3 tensor maps + launch)": lambda: launch(
            *c_args, stream),
        "K2's wrapper at B=32, N=577": lambda: attn_ops.packed_attention(
            *inputs["packed_attention"]),
    }
    for name, fn in parts.items():
        print(f"variants: K10 host path, {name}: {smoke.host_us(fn):.2f} us "
              f"a call [{card}]")


def variants(dev, card: str, kernels, parent=None) -> None:
    """The kernels named against their rejected variants, in turns (built,
    variant, variant, built), through the same wrappers and inputs; with
    ``parent`` (another tree's root), K10 and K11 beside that tree's."""
    libs = build_variants(kernels)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    inputs = smoke.kernel_inputs(dev, gen)
    inputs.update(smoke.fusion_inputs(inputs))
    calls = {k: {} for k in SOURCES}
    for c in (smoke.C, smoke.C_L):
        x = torch.randn(smoke.IMAGE_BATCH, smoke.N, c, device=dev,
                        generator=gen).bfloat16()
        lw, lb = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        w = (0.02 * torch.randn(3 * c, c, device=dev, generator=gen)).bfloat16()
        b = torch.zeros(3 * c, device=dev)
        calls["K1"][f"C={c}"] = lambda x=x, lw=lw, lb=lb, w=w, b=b: \
            fb_ops.ln_linear(x, lw, lb, w, b)
    for heads in (smoke.HEADS, smoke.HEADS_L):
        qkv = torch.randn(smoke.IMAGE_BATCH, smoke.N, 3 * 64 * heads,
                          device=dev, generator=gen).bfloat16()
        bias = torch.randn(heads, smoke.N, smoke.N, device=dev, generator=gen)
        mask = torch.ones(smoke.IMAGE_BATCH, smoke.N, dtype=torch.int32,
                          device=dev)
        mask[-1, 500:] = 0
        calls["K2"][f"{heads} heads"] = \
            lambda qkv=qkv, bias=bias, mask=mask, heads=heads: \
            attn_ops.packed_attention(qkv, bias, mask, 64 ** -0.5, heads)
        calls["K12"][f"{heads} heads"] = \
            lambda qkv=qkv, bias=bias, mask=mask, heads=heads: \
            attn_ops.packed_attention_i8qk(qkv, bias, mask, 64 ** -0.5, heads)
    wide = smoke.wide_fused_inputs(dev, gen)
    calls["K7"]["B=32"] = lambda: fb_ops.block_eval(*inputs["block_eval"])
    calls["K7"]["B=32, C=1024"] = lambda: fb_ops.block_eval(*wide["block_eval"])
    calls["K15"]["B=32"] = lambda: i8_ops.proj_mlp_tail_i8(
        *inputs["proj_mlp_tail_i8"])
    calls["K15"]["B=32, C=1024"] = lambda: i8_ops.proj_mlp_tail_i8(
        *wide["proj_mlp_tail_i8"])
    calls["K8"]["B=32"] = lambda: fb_ops.ln_qkv_attention(
        *inputs["ln_qkv_attention"])
    calls["K14"]["B=32"] = lambda: i8_ops.ln_linear_i8(*inputs["ln_linear_i8"])
    calls["K14"]["B=32, C=1024"] = lambda: i8_ops.ln_linear_i8(
        *wide["ln_linear_i8"])
    calls["K10"]["B=6, N=197"] = lambda: attn_ops.split_attention(
        *inputs["split_attention"])
    calls["K11"]["B=32, N=197"] = lambda: attn_ops.split_attention_bb(
        *inputs["split_attention_bb"])
    built = _build.library()

    def k7_split(lib) -> str:
        """A traced K7 launch from ``lib``: its phase split."""
        with using(lib):
            trace = torch.zeros(fb_ops.block_eval_grid(smoke.C), 12, dtype=torch.int64,
                                device=dev)
            fb_ops.block_eval(*inputs["block_eval"], trace=trace)
        t = trace.double().cpu()[:, :6].mean(0) / 1e6
        return " / ".join(f"{v:.4f}" for v in t.tolist())
    if "K8" in kernels:
        k8_roles(dev, card)
        k8_variants(inputs, card)
    if "K14" in kernels:
        k14_variants(inputs, card)
    if "K10" in kernels:
        split_host(inputs, card)
    if parent is not None and {"K10", "K11"} & set(kernels):
        parent_split(parent, inputs, card)
    for name, (lib, spill) in libs.items():
        kernel = VARIANTS[name][0]
        for shape, call in calls[kernel].items():
            if name in AT_768_ONLY and "C=1024" in shape:
                continue
            with using(lib):
                got = call()
            same = torch.equal(got, call())
            times = []
            for which in (built, lib, lib, built):
                with using(which):
                    times.append(smoke.time_ms(call))
            if kernel in ("K10", "K11"):   # host-bound per call: device too
                for which in (built, lib, lib, built):
                    with using(which):
                        times.append(smoke.device_ms(call))
            device = "" if len(times) == 4 else (
                f"; device {times[4]:.4f} / {times[7]:.4f} ms against "
                f"{times[5]:.4f} / {times[6]:.4f}")
            print(f"variants: {kernel} at {shape}: built "
                  f"{times[0]:.4f} / {times[3]:.4f} ms, {name} {times[1]:.4f} / "
                  f"{times[2]:.4f} ms{device} (ptxas: {spill}; output bit-equal "
                  f"to the built kernel's: {same}) [{card}]")
            if VARIANTS[name][0] == "K7":
                print(f"variants: K7 phases A, barrier, B, barrier, C, barrier "
                      f"(ms, mean per CTA): built {k7_split(built)}, variant "
                      f"{k7_split(lib)}")


def against_built(label: str, built, variants: dict, card: str) -> None:
    """Each variant against the built call, in turns (built, variant,
    variant, built), and whether its output equals the built one's."""
    want = built()
    for name, call in variants.items():
        same = torch.equal(call(), want)
        t = [smoke.time_ms(built), smoke.time_ms(call), smoke.time_ms(call),
             smoke.time_ms(built)]
        print(f"variants: {label}: built {t[0]:.4f} / {t[3]:.4f} ms, {name} "
              f"{t[1]:.4f} / {t[2]:.4f} ms (output bit-equal to the built "
              f"kernel's: {same}) [{card}]")


def k8_variants(inputs, card: str) -> None:
    """K8 at the main-path shapes with other splits of its grid and other
    units of its K1 role."""
    args = inputs["ln_qkv_attention"]
    B, N, C = args[0].shape
    grid = fb_ops.ln_qkv_attention_grid(C)
    ga = fb_ops.ln_qkv_attention_split(grid, B, N, C, args[8])
    ncb = 3 * C // 256
    variants = {f"K1 role on {g} of {grid} CTAs": (lambda g=g: fb_ops.ln_qkv_attention(
        *args, split=g)) for g in (ga - 8, ga + 8)}
    variants.update({f"units of {u} column tiles": (lambda u=u: fb_ops.ln_qkv_attention(
        *args, unit=u)) for u in (3, ncb)})
    against_built(f"K8 at B={B} (K1 role on {ga} of {grid} CTAs, units of "
             f"{fb_ops._K8_UNIT} column tile)",
             lambda: fb_ops.ln_qkv_attention(*args), variants, card)


def k14_variants(inputs, card: str) -> None:
    """K14 at the main-path shapes in units of 3 column tiles."""
    args = inputs["ln_linear_i8"]
    M, O = args[0].shape[0] * args[0].shape[1], args[3].shape[0]
    grid = i8_ops.ln_linear_i8_grid(args[0].shape[-1])
    variants = {}
    for group in (3,):
        units, rounds = i8_ops.ln_linear_i8_plan(M, O, grid, group)
        variants[f"units of {group} column tiles ({units} units, {rounds} "
                 f"rounds)"] = lambda group=group: i8_ops.ln_linear_i8(
                     *args, group=group)
    units, rounds = i8_ops.ln_linear_i8_plan(M, O, grid)
    against_built(f"K14 at B={args[0].shape[0]} (units of {i8_ops._I8_GROUP} "
             f"column tile: {units} units, {rounds} rounds)",
             lambda: i8_ops.ln_linear_i8(*args), variants, card)


@contextlib.contextmanager
def c8_wrappers(vlib):
    """Meanwhile K2's training launch and K9 run from ``vlib`` (C8's repair
    b): the training launch gets one f32 buffer of 3·B·H·N statistics
    (m, l, and the D K9 writes) and the B·N·C f32 context, and hands back
    the first two planes as its statistics; K9 reads the whole buffer
    through them.  Every other kernel runs from the built library."""
    real_fwd, real_bwd = attn_ops.packed_attention, attn_ops.packed_attention_bwd

    def fwd(qkv, bias, mask, scale, num_heads, *, with_stats=False):
        if not with_stats:
            return real_fwd(qkv, bias, mask, scale, num_heads)
        B, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
        plane = B * num_heads * N
        bias, mask = attn_ops._f32_aligned(bias), mask.to(torch.int32)
        buf = torch.empty(3 * plane + B * N * C, dtype=torch.float32,
                          device=qkv.device)
        out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
        _build.check(vlib.vlm_packed_attention(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
            buf.data_ptr(), B, N, num_heads, float(scale),
            _build.stream_handle(qkv.device)), "packed_attention (C8 b)")
        return out, buf[:2 * plane].view(2, B, num_heads, N)

    def bwd(qkv, bias, mask, g, stats, scale, num_heads):
        B, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
        plane = B * num_heads * N
        buf = torch.as_strided(stats, (3 * plane + B * N * C,), (1,),
                               stats.storage_offset())
        bias, mask = attn_ops._f32_aligned(bias), mask.to(torch.int32)
        ldb = -(-N // 64) * 64
        bias_rows = torch.nn.functional.pad(bias, (0, ldb - N))
        groups = vlib.vlm_packed_attention_bwd_groups(B)
        dqkv = torch.empty_like(qkv)
        dbias = torch.empty((num_heads, N, N), dtype=torch.float32,
                            device=qkv.device)
        part = torch.empty((groups, num_heads, N, -(-N // 4) * 4),
                           dtype=torch.float32, device=qkv.device)
        _build.check(vlib.vlm_packed_attention_bwd(
            qkv.data_ptr(), bias_rows.data_ptr(), mask.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), buf.data_ptr(),
            part.data_ptr(), B, N, num_heads, ldb, groups, float(scale),
            _build.stream_handle(qkv.device)), "packed_attention_bwd (C8 b)")
        return dqkv, dbias

    attn_ops.packed_attention, attn_ops.packed_attention_bwd = fwd, bwd
    try:
        yield
    finally:
        attn_ops.packed_attention, attn_ops.packed_attention_bwd = \
            real_fwd, real_bwd


def plain_context_f32(qkv, bias, mask, scale, heads):
    """The plain forward's context before its rounding: f32 logits, f32
    softmax, P rounded to qkv's dtype, P·V in f32 (``reference_attention``
    without its last cast)."""
    B, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (attn_ops._heads(t, heads) for t in qkv.split(C, dim=-1))
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) + \
        bias[None].float()
    s = s.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.matmul(p.float(), v.float()).transpose(1, 2).reshape(B, N, C)


def twin_from_context(qkv, bias, mask, g, o, stats, scale, heads):
    """K9's twin (``packed_attention_bwd_reference``) with repair (b)'s
    row sums, D = Σ g ⊙ o over each head's columns of a context o, in
    place of Σ_k dp ⊙ p."""
    B, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    dt = qkv.dtype
    q, k, v = (attn_ops._heads(t, heads) for t in qkv.split(C, dim=-1))
    qs = q * torch.tensor(scale, dtype=dt)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) + \
        bias[None].float()
    s = s.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    m, l = stats[0].float(), stats[1].float()
    live = (l > 0)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, m[..., None], 0.0))
                    / torch.where(live, l[..., None], 1.0), 0.0)
    gh = attn_ops._heads(g, heads).float()
    d = torch.where(live, (gh * attn_ops._heads(o, heads).float()).sum(
        -1, keepdim=True), 0.0)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.float().transpose(-1, -2))
    ds = p * (dp - d)
    ds16 = ds.to(dt).float()
    dq = torch.matmul(ds16, k.float()) * scale
    dk = torch.matmul(ds16.transpose(-1, -2), qs.float())
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, N, C)
                      for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(dt), ds.sum(0)


def c8_repairs(dev, card: str) -> None:
    """Fault C8's two repairs side by side: (a), built, D = Σ_k dp ⊙ p in a
    first pass of K9's dq_kernel; (b) D = Σ_c g ⊙ o from an f32 context
    K2's training launch stores (``C8_F32_CONTEXT``).  At chip_smoke.py's K9
    inputs (B=32, N=577, 12 heads), as a share of K9's 4-ulp bound: each
    repair against its twin fed the plain forward (its statistics and, for
    (b), its f32 context: the figure the fault was found by), and (b) also
    against (a)'s twin, the plain backward with the reference's
    D = Σ_k dp ⊙ p; K9 and K2's training launch timed (a) against (b) in
    turns; the @384 irtr train step (2 micro-batches of 32, kernel path)
    in turns, with its peak memory."""
    (vlib, spill), = build_variants(["K9b"]).values()
    print(f"c8: repair (b) built (ptxas: {spill})")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    args = smoke.kernel_inputs(dev, gen)["packed_attention_bwd"]
    qkv, bias, mask, g, stats, scale, heads = args
    plain = smoke.plain_args("packed_attention_bwd", args)
    want_a = attn_ops.packed_attention_bwd_reference(*plain)
    want_b = twin_from_context(qkv, bias, mask, g, plain_context_f32(
        qkv, bias, mask, scale, heads), plain[4], scale, heads)
    got_a = attn_ops.packed_attention_bwd(*args)
    with c8_wrappers(vlib):
        _, stats_b = attn_ops.packed_attention(qkv, bias, mask, scale, heads,
                                               with_stats=True)
        got_b = attn_ops.packed_attention_bwd(qkv, bias, mask, g, stats_b,
                                              scale, heads)
    torch.cuda.synchronize()
    for label, got, want in (
            ("(a) against its twin fed the plain forward", got_a, want_a),
            ("(b) against its twin fed the plain forward (its f32 context)",
             got_b, want_b),
            ("(b) against (a)'s twin, the plain backward (D = Σ_k dp ⊙ p)",
             got_b, want_a)):
        max_err, worst, differ = smoke.ulp_check("packed_attention_bwd",
                                                 got[0], want[0])
        rel = float((got[1] - want[1]).norm() / want[1].norm())
        print(f"c8: repair {label}: worst err/bound = {worst:.3f} (bound 4 "
              f"bf16 ulps), max |kernel - twin| = {max_err:.6g}, "
              f"{differ:.3e} of the elements differ; dbias relative norm "
              f"error {rel:.3e}")

    def k2_train():
        return attn_ops.packed_attention(qkv, bias, mask, scale, heads,
                                         with_stats=True)

    # (the wrappers are looked up at each call: within c8_wrappers, (b)'s)
    calls = {"K2 training launch": (k2_train, k2_train),
             "K9": (lambda: attn_ops.packed_attention_bwd(*args),
                    lambda: attn_ops.packed_attention_bwd(
                        qkv, bias, mask, g, stats_b, scale, heads))}
    for label, (fa, fb) in calls.items():
        t = {"a": [], "b": []}
        for path in ("a", "b", "b", "a"):
            with c8_wrappers(vlib) if path == "b" else \
                    contextlib.nullcontext():
                t[path].append(smoke.time_ms(fa if path == "a" else fb))
        print(f"c8: {label} at B=32, N=577, 12 heads: repair (a) "
              f"{min(t['a']):.4f} ms, repair (b) {min(t['b']):.4f} ms (in "
              f"turns) [{card}]")

    cfg = build_config(*smoke.CONFIG)
    spec = make_model_spec(cfg)
    base = smoke.seeded_params(spec, dev)
    tcfg = smoke.train_config(kernels=True)
    batch = smoke.synthetic_train_batch(spec, accum_steps(tcfg), dev, gen)
    state, step = build_train_step(tcfg, spec, master_params(base), 10)
    holder = [state]
    times, peak = {"a": [], "b": []}, {}
    for path in ("a", "b", "a", "b", "b", "a"):
        with c8_wrappers(vlib) if path == "b" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats(dev)
            holder[0], _, ms = smoke.timed_step(step, holder[0], batch)
            peak[path] = torch.cuda.max_memory_allocated(dev)
        times[path].append(ms)
    print(f"c8: train step @384 (kernel path, 2 micro-batches of 32): repair "
          f"(a) {min(times['a'][1:]):.1f} ms, peak {peak['a'] / 2**30:.2f} "
          f"GiB; repair (b) {min(times['b'][1:]):.1f} ms, peak "
          f"{peak['b'] / 2**30:.2f} GiB (best of 2 after a warm step each, "
          f"in turns) [{card}]")


def int8_windows(base, text_b, image_b, tiids, iids, card: str) -> None:
    """The W8A8 int8 eval over the @384 eval set, and its image tower with
    K2 and with K12 (``qk_int8``)."""
    cfg8 = build_config(*smoke.CONFIG, overrides=dict(eval_int8=True))
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(base, spec8, cfg8)
    trace("eval int8", lambda: compute_irtr_recall(
        params8, spec8, text_b, image_b, tiids, iids), card)
    for label, qk_int8 in (("image tower int8", False),
                           ("image tower int8-QK", True)):
        trace(label, lambda qk_int8=qk_int8: extract_features(
            params8, spec8, image_b, "image", qk_int8=qk_int8), card)


def vl_windows(dev, card: str) -> None:
    """The fused VL pass at ``chip_smoke.py`` phase 12's shapes and seeds:
    VQA @480 through ``vqa_predictions`` (2 batches of 32 questions, bf16
    "tail" and W8A8), the NLVR2 @384 paired pass over 32 pairs, and the
    COCO @384 eval with the ITM rerank (top 4)."""
    cfg = build_config(*smoke.CONFIG_VQA,
                       overrides=dict(image_size=smoke.VQA_SIZE))
    spec = make_model_spec(cfg)
    base = smoke.seeded_params(spec, dev)
    batches = smoke.vqa_batches(spec, dev)
    for label, over in (("bf16", {}), ("W8A8", dict(eval_int8=True))):
        c = dict(cfg, **over)
        s = make_model_spec(c)
        p = eval_cast_params(base, s, c)
        trace(f"VQA @480 {label}, {len(batches)} x {smoke.VQA_BATCH}",
              lambda p=p, s=s: downstream.vqa_predictions(p, s, batches, {}),
              card)
        del p
    del base
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 31)
    cfg = build_config(smoke.CONFIG_NLVR2, "ufo")
    spec = make_model_spec(cfg)
    params = eval_cast_params(smoke.seeded_params(spec, dev), spec, cfg)
    batch = smoke.nlvr2_batch(spec, dev, gen, smoke.NLVR2_PAIRS)
    trace(f"NLVR2 @384 ufo, {smoke.NLVR2_PAIRS} pairs",
          lambda: downstream.nlvr2_predictions(params, spec, [batch]), card)
    cfg = build_config(*smoke.CONFIG, overrides=dict(
        loss_names={"irtr": 1, "itm": 1}))
    spec = make_model_spec(cfg)
    params = eval_cast_params(smoke.seeded_params(spec, dev), spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    eval_set = smoke.synthetic_eval_set(spec, dev, gen)
    trace(f"eval @384 with the ITM rerank (top {smoke.RERANK_TOPK})",
          lambda: compute_irtr_recall(params, spec, *eval_set,
                                      itm_rerank_topk=smoke.RERANK_TOPK),
          card)


def objective_windows(dev, card: str) -> None:
    """One optimizer step of ``chip_smoke.py`` phase 13's paths, kernel and
    plain path: the NLVR2 @384 fine-tune (ufo, 2 x 16 pairs), the VLMo
    pretrain @224 (all_moe, 32 pairs: mlm, ifm, itm) and the all-in-one
    pretrain (16 images, 16 texts, 16 pairs; MIM labels from the dVAE
    encoder on the card)."""
    over = dict(per_device_batch_size=smoke.NLVR2_MICRO,
                batch_size=smoke.NLVR2_MICRO * smoke.NLVR2_ACCUM)
    cfg = build_config(*smoke.CONFIG_NLVR2_TRAIN, overrides=over)
    spec = make_model_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 42)
    accum = accum_steps(cfg)
    pairs = smoke.nlvr2_batch(spec, dev, gen, smoke.NLVR2_MICRO * accum)
    batch = {k: v.reshape(accum, smoke.NLVR2_MICRO, *v.shape[1:])
             for k, v in pairs.items()}
    runs = smoke.objective_runs(smoke.CONFIG_NLVR2_TRAIN, spec,
                                smoke.seeded_params(spec, dev), 10, **over)
    for which, (state, step) in runs.items():
        trace(f"NLVR2 @384 fine-tune step, {which} path, {accum} x "
              f"{smoke.NLVR2_MICRO} pairs", lambda: step(state, batch), card)
    del runs
    n = smoke.PRETRAIN_PAIRS
    over = dict(per_device_batch_size=n, batch_size=n)
    cfg = build_config(*smoke.CONFIG_PRETRAIN, overrides=over)
    spec = make_model_spec(cfg)
    batch = smoke.pretrain_batch(spec, cfg, n, dev, gen)
    runs = smoke.objective_runs(smoke.CONFIG_PRETRAIN, spec,
                                smoke.seeded_params(spec, dev), 10, **over)
    for which, (state, step) in runs.items():
        trace(f"VLMo pretrain @224 step, {which} path, {n} pairs",
              lambda: step(state, batch), card)
    del runs
    n = smoke.MIXED_BATCH
    over = dict(per_device_batch_size=n, batch_size=n)
    cfg = build_config(*smoke.CONFIG_ALL_IN_ONE, overrides=over)
    spec = make_model_spec(cfg)
    batch = {k: smoke.pretrain_batch(spec, cfg, n, dev, gen)
             for k in ("v", "l", "vl")}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "encoder.pkl")
        torch.save(dvae.init_encoder_params(
            torch.Generator().manual_seed(smoke.SEED + 45)), path)
        label_fn = dvae.make_mim_label_fn(path)
    runs = smoke.objective_runs(smoke.CONFIG_ALL_IN_ONE, spec,
                                smoke.seeded_params(spec, dev), 10,
                                plain=False, mim_label_fn=label_fn, **over)
    state, step = runs["kernels"]
    trace(f"all-in-one pretrain step, kernel path, {n} images, texts and "
          f"pairs", lambda: step(state, batch), card)


# the pretrain steps timed in turns per path after the traced ones
PREPROCESS_TURNS = 6


def preprocess_windows(dev, card: str) -> None:
    """``chip_smoke.py`` phase 16's device-side preprocessing, by part:
    the canvas resize of 64 images (640 canvas to 384) and its parts, the
    train augment of one micro-batch of 16 and its parts, the whole-word
    masking core of 32 captions; then the VLMo pretrain @224 step with
    the device preprocessing and on host-made inputs, one traced window
    each and PREPROCESS_TURNS steps of each in turns."""
    from vl_merging_tpu_torch.ops import augment, image as image_ops
    from vl_merging_tpu_torch.ops import text_masking

    S = make_model_spec(build_config(*smoke.CONFIG)).image_size
    rng = np.random.RandomState(smoke.SEED + 70)
    natives = [smoke.photo_like(rng, *smoke.NATIVE_SIZES[
        i % len(smoke.NATIVE_SIZES)]) for i in range(smoke.CANVAS_IMAGES)]
    canvas, sizes = image_ops.pack_canvas(natives)
    c = torch.from_numpy(canvas).to(dev)
    hw = torch.from_numpy(sizes).to(dev)
    B, Hc, Wc, _ = c.shape
    wx = image_ops._resample_weights(hw[:, 1], Wc, S)
    wy = image_ops._resample_weights(hw[:, 0], Hc, S)
    x = c.permute(0, 3, 1, 2).float().reshape(B, 3 * Hc, Wc)
    tmp = image_ops._exact_pass(x, wx).reshape(B, 3, Hc, -1)
    for name, fn in (
            ("weights, both axes", lambda: (
                image_ops._resample_weights(hw[:, 1], Wc, S),
                image_ops._resample_weights(hw[:, 0], Hc, S))),
            ("uint8 to f32", lambda: c.permute(0, 3, 1, 2).float()),
            ("horizontal pass", lambda: image_ops._exact_pass(x, wx)),
            ("vertical pass", lambda: image_ops._exact_pass(
                tmp.transpose(2, 3), wy[:, None])),
            ("normalize", lambda: image_ops.normalize_nchw(tmp[..., :S])),
            ("resize_normalize_nchw", lambda: image_ops.resize_normalize_nchw(
                c, hw, S))):
        print(f"canvas resize, {B} images ({Hc}x{Wc} canvas to {S}), "
              f"{name}: {smoke.time_ms(fn):.3f} ms [{card}]")

    n = smoke.TRAINER_MICRO
    p = {k: torch.from_numpy(v).to(dev) for k, v in
         augment.sample_train_params(rng, sizes[:n], S).items()}
    crop = augment._resized_crop_u8f(c[:n], p["crop"], S)
    ops = p["op_idx"][:, 0], p["op_apply"][:, 0], p["affine"][:, 0], \
        p["factor"][:, 0]
    for name, fn in (
            ("crop-resize", lambda: augment._resized_crop_u8f(
                c[:n], p["crop"], S)),
            ("the LUT candidates (autocontrast, equalize, brightness)",
             lambda: (augment._autocontrast_lut(crop),
                      augment._equalize_lut(crop),
                      augment._apply_lut(crop, augment._brightness_lut(
                          ops[3])))),
            ("the sharpness candidate", lambda: augment._sharpness(
                crop, ops[3])),
            ("the warp candidate", lambda: augment._affine_bilinear(
                crop, ops[2])),
            ("one RandAugment stage", lambda: augment._randaug_stage(
                crop, *ops)),
            ("augment_train_batch", lambda: augment.augment_train_batch(
                c[:n], p, S))):
        print(f"train augment, {n} images ({Hc}x{Wc} canvas to {S}), "
              f"{name}: {smoke.time_ms(fn):.3f} ms [{card}]")
    del c, hw, wx, wy, x, tmp, crop

    cfg, spec, batch, gen = smoke.device_pretrain_inputs(dev)
    wid = batch["text_word_ids"]
    def draw():
        return text_masking.mlm_draws(wid.shape, gen, spec.vocab_size, True)

    draws = draw()
    core = smoke.time_ms(lambda: text_masking.apply_mlm(
        batch["text_ids"], wid < 0, draws, cfg["mlm_prob"], 103,
        word_ids=wid))
    print(f"whole-word masking of {tuple(wid.shape)}: the draws "
          f"{smoke.time_ms(draw):.3f} ms, the core {core:.3f} ms [{card}]")
    runs = smoke.device_pretrain_runs(spec, dev, 4 + 2 * PREPROCESS_TURNS)
    label = f"VLMo pretrain @{spec.image_size} step, {len(wid)} pairs"
    for which, (state, step) in runs.items():
        trace(f"{label}, {which} preprocessing",
              lambda: step(state, batch), card)
    times = {k: [] for k in runs}
    for i in range(PREPROCESS_TURNS):
        for which in (list(runs) if i % 2 else list(runs)[::-1]):
            state, step = runs[which]
            state, _, ms = smoke.timed_step(step, state, batch)
            runs[which] = (state, step)
            times[which].append(ms)
    for which, ms in times.items():
        print(f"{label}, {which} preprocessing: median "
              f"{float(np.median(ms)):.1f} ms, min {min(ms):.1f}, max "
              f"{max(ms):.1f} ({PREPROCESS_TURNS} steps in turns: "
              f"{[round(m, 1) for m in ms]}) [{card}]")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k7", action="store_true",
                        help="run K7's phase split alone")
    parser.add_argument("--variants", nargs="*", metavar="KERNEL",
                        help="run K1, K2, K7, K8, K14, K15, K10 and K11 (or "
                             "the kernels named) beside their rejected "
                             "variants alone")
    parser.add_argument("--c8", action="store_true",
                        help="fault C8's two repairs side by side alone")
    parser.add_argument("--int8", action="store_true",
                        help="the int8 windows alone")
    parser.add_argument("--vl", action="store_true",
                        help="the fused VL pass's windows alone")
    parser.add_argument("--objectives", action="store_true",
                        help="the training objectives' step windows alone")
    parser.add_argument("--preprocess", action="store_true",
                        help="the device-side preprocessing's parts and "
                             "the pretrain step with it, alone")
    parser.add_argument("--parent", type=Path, metavar="TREE",
                        help="with --variants: K10 and K11 beside those of "
                             "the tree at TREE (another checkout's root)")
    parser.add_argument("--digests", type=Path, metavar="TREE",
                        help="the output digests of K2, K7, K8, K10, K11, "
                             "K12, K14 and K15 beside those of the tree at "
                             "TREE alone")
    opts = parser.parse_args()
    dev = require_cuda()
    card = smoke.card_line()
    print(card)
    if opts.c8:
        c8_repairs(dev, card)
        return
    if opts.digests is not None:
        parent_digests(opts.digests, dev, card)
        return
    if opts.variants is not None:
        variants(dev, card, opts.variants or [k for k in SOURCES if k != "K9b"],
                 opts.parent)
        return
    if opts.vl:
        vl_windows(dev, card)
        return
    if opts.objectives:
        objective_windows(dev, card)
        return
    if opts.preprocess:
        preprocess_windows(dev, card)
        return
    if not opts.int8:
        k7_phases(dev, card)
    if opts.k7:
        return

    cfg = build_config(*smoke.CONFIG)
    spec = make_model_spec(cfg)
    base = smoke.seeded_params(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    text_b, image_b, tiids, iids = smoke.synthetic_eval_set(spec, dev, gen)
    if opts.int8:
        int8_windows(base, text_b, image_b, tiids, iids, card)
        return
    params = eval_cast_params(base, spec, cfg)
    trace("eval", lambda: compute_irtr_recall(params, spec, text_b, image_b,
                                              tiids, iids), card)
    for fusion in FUSIONS:
        trace(f"image tower, fusion {fusion}", lambda: extract_features(
            params, spec, image_b, "image", fusion=fusion), card)
    int8_windows(base, text_b, image_b, tiids, iids, card)

    cfg224 = build_config(*smoke.CONFIG_224)
    spec224 = make_model_spec(cfg224)
    params224 = eval_cast_params(smoke.seeded_params(spec224, dev), spec224,
                                 cfg224)
    sets224 = smoke.synthetic_eval_set(spec224, dev, gen, smoke.N_IMAGES_224)
    trace("eval @224", lambda: compute_irtr_recall(params224, spec224,
                                                   *sets224), card)
    del params224, sets224
    # the f30k @224 fine-tune step: K11 forward in every image block (the
    # plain VJP backward), K13 in every block
    cfg224t = build_config(*smoke.CONFIG_224, overrides=dict(
        per_device_batch_size=smoke.MICRO_BATCH,
        batch_size=2 * smoke.MICRO_BATCH, warmup_steps=0,
        pallas_attention=True))
    state, step = build_train_step(cfg224t, spec224, master_params(
        smoke.seeded_params(spec224, dev)), 10)
    batch224 = smoke.synthetic_train_batch(spec224, accum_steps(cfg224t),
                                           dev, gen)
    holder = [state]

    def step224():
        holder[0] = step(holder[0], batch224)[0]
    trace("train @224 (kernels)", step224, card)
    del state, step, holder, batch224

    train_cfg = smoke.train_config(kernels=True)
    batch = smoke.synthetic_train_batch(spec, accum_steps(train_cfg), dev,
                                        gen)
    for label, kernels, level in (
            ("kernels", True, "0"),
            ("kernels, train_fusion full", True, "full"),
            ("plain", False, "0")):
        state, step = build_train_step(smoke.train_config(kernels), spec,
                                       master_params(base), 10,
                                       train_fusion=level)
        holder = [state]

        def one_step():
            holder[0] = step(holder[0], batch)[0]
        trace(f"train ({label})", one_step, card)
        del state, step, holder
    del base, params

    cfg_l = build_config(*smoke.CONFIG_L)
    spec_l = make_model_spec(cfg_l)
    base_l = smoke.seeded_params(spec_l, dev)
    params_l = eval_cast_params(base_l, spec_l, cfg_l)
    images = [{"image": torch.randn(smoke.L_IMAGES, 3, spec_l.image_size,
                                    spec_l.image_size, device=dev,
                                    generator=gen)}]
    ids, masks = smoke.synthetic_captions(spec_l, smoke.L_CAPTIONS, dev, gen)
    per = smoke.L_CAPTIONS // smoke.L_IMAGES
    eval_set = ([{"text_ids": ids, "text_masks": masks}], images,
                np.repeat(np.arange(smoke.L_IMAGES), per),
                np.arange(smoke.L_IMAGES))
    trace("eval ViT-L", lambda: compute_irtr_recall(params_l, spec_l,
                                                    *eval_set), card)
    for fusion in ("tail", "mega"):
        trace(f"image tower ViT-L, fusion {fusion}", lambda: extract_features(
            params_l, spec_l, images, "image", fusion=fusion), card)
    del params_l
    cfg_l8 = build_config(*smoke.CONFIG_L, overrides=dict(eval_int8=True))
    spec_l8 = make_model_spec(cfg_l8)
    params_l8 = eval_cast_params(base_l, spec_l8, cfg_l8)
    trace("eval ViT-L int8", lambda: compute_irtr_recall(params_l8, spec_l8,
                                                         *eval_set), card)
    del params_l8
    tcfg = build_config(*smoke.CONFIG_L, overrides=dict(
        per_device_batch_size=smoke.L_MICRO, batch_size=smoke.L_MICRO,
        warmup_steps=0, pallas_attention=True))
    mb = {k: v[0] for k, v in smoke.synthetic_train_batch(
        spec_l, 1, dev, gen, micro=smoke.L_MICRO).items()}
    state, step = build_train_step(tcfg, spec_l, master_params(base_l), 10)
    holder = [state]

    def one_step_l():
        holder[0] = step(holder[0], mb)[0]
    trace("train ViT-L (kernels)", one_step_l, card)
    del state, step, holder, base_l
    vl_windows(dev, card)


if __name__ == "__main__":
    main()
