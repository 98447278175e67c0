#!/usr/bin/env python3
"""Where the device time goes on the port's main paths (needs one NVIDIA
GPU):

    python3 chip_profile.py

Traces, with ``torch.profiler`` (CPU and CUDA activities), one warm call
of each window at ``chip_smoke.py``'s shapes and seeded inputs:
  * ``eval``: ``compute_irtr_recall`` over 64 images and 320 captions;
  * ``eval int8``: the same in the W8A8 int8 eval mode (``eval_int8``:
    K14 → K2 → K15 per image block);
  * ``eval @224``: the Flickr30k @224 eval over 70 images (batches of 32,
    32 and 6: K11, K11, K10 in every block) and 350 captions;
  * ``image tower, fusion <route>``: ``extract_features`` over the 64
    images under each eval-block route ("pair" K1 → K2 → K4 → K5, "tail"
    K1 → K2 → K3, "qkv" K8 → K3, "mega" K7);
  * ``train (kernels)`` / ``train (kernels, train_fusion full)`` /
    ``train (plain)``: one optimizer step (2 micro-batches of 32 pairs) on
    the kernel path, on the kernel path under the training fusion "full"
    (K1 and K6 in every block) and on the plain path (K9's three CUDA
    kernels, D + dq, dk/dv + dbias partials and the partial sum, show
    separately);
  * ``eval ViT-L`` / ``train ViT-L (kernels)``: the ViT-L @384 width
    (C=1024, 16 heads, MLP 4096, 24 layers): ``compute_irtr_recall`` over
    32 images and 64 captions, and one optimizer step of one micro-batch of
    8 pairs on the kernel path.
For each window it prints the host wall time, the device busy time (the
union of the device kernels' intervals), the idle share (1 − busy / wall)
and the kernels with the most device time.

``python3 chip_profile.py --variants`` runs only this: K1 and K2 beside
design variants that their sources rejected, each built from a patched
copy of ``vl_merging_tpu_torch/csrc`` into ``build/variants/`` (one nvcc
per variant, all at once) and timed in turns with the built kernel at
``chip_smoke.py``'s main-path shapes (B=32, N=577; C=768 and 1024, 12 and
16 heads): K1 without its cluster of two CTAs sharing each W tile by TMA
multicast, K1 releasing its ring stages at cluster scope, K2 without the
ping-pong of its two consumer warpgroups, and K2 with a whole 64-key last
key tile.

First, K7's phase split (``python3 chip_profile.py --k7`` runs it alone):
one traced launch of K7 (``block_eval(..., trace=...)``) at
``chip_smoke.py``'s main-path shapes (B=32, N=577) gives, per CTA, the time
in phase 1 (K8's body over (element, head) items), at the grid barrier,
in phase 2 (K3's body over 64-row blocks) and at the second barrier, and
the items and blocks each CTA took; beside it K7's grid against the SMs,
K7 untraced and traced, and the staged K8 and K3 at the same shapes with
their time per wave of resident blocks.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, master_params
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.device import require_cuda
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall, \
    extract_features
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import _build
from vl_merging_tpu_torch.ops import fused_block as fb_ops
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
    K8 and K3 (see the module's docstring)."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    inputs = smoke.kernel_inputs(dev, gen)
    inputs.update(smoke.fusion_inputs(inputs))
    args = inputs["block_eval"]
    B, N = args[0].shape[:2]
    heads = args[8]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = fb_ops.block_eval_grid()
    clusters = grid // 4
    k7_ms = smoke.time_ms(lambda: fb_ops.block_eval(*args))
    counters = torch.zeros(grid, 8, dtype=torch.int64, device=dev)

    def traced():
        counters.zero_()
        fb_ops.block_eval(*args, trace=counters)
    traced_ms = smoke.time_ms(traced)
    traced()
    torch.cuda.synchronize()
    t = counters.cpu().numpy().astype(np.float64)
    ms = t[:, :4] / 1e6
    items, blocks = t[:, 4], t[:, 5]
    span = (t[:, 7].max() - t[:, 6].min()) / 1e6
    print(f"== K7 phases (B={B}, N={N}): grid {grid} CTAs ({clusters} "
          f"clusters of 4) on {sms} SMs, {sms - grid} SMs idle; K7 "
          f"{k7_ms:.4f} ms, traced {traced_ms:.4f} ms, traced span "
          f"{span:.4f} ms [{card}]")
    for i, label in enumerate(("phase 1 (K8's body)", "barrier 1",
                               "phase 2 (K3's body)", "barrier 2")):
        print(f"   {label:22s} per CTA: mean {ms[:, i].mean():.4f} ms, "
              f"min {ms[:, i].min():.4f}, max {ms[:, i].max():.4f}")
    print(f"   phase 1: {int(items.sum())} (element, head) items, "
          f"{int(items.min())}-{int(items.max())} per CTA, "
          f"{(ms[:, 0] / items).mean():.4f} ms per item")
    print(f"   phase 2: {math.ceil(B * N / 64)} 64-row blocks over "
          f"{clusters} clusters, {int(blocks.min())}-{int(blocks.max())} "
          f"per CTA, {(ms[:, 2] / np.maximum(blocks, 1)).mean():.4f} ms per "
          f"block")
    k8_ms = smoke.time_ms(
        lambda: fb_ops.ln_qkv_attention(*inputs["ln_qkv_attention"]))
    k3_ms = smoke.time_ms(
        lambda: fb_ops.proj_mlp_tail(*inputs["proj_mlp_tail"]))
    k8_waves = math.ceil(B * heads / sms)
    k3_waves = math.ceil(math.ceil(B * N / 64) / clusters)
    print(f"   staged: K8 {k8_ms:.4f} ms ({B * heads} blocks, one per SM "
          f"at a time: {k8_waves} waves, {k8_ms / k8_waves:.4f} ms per "
          f"wave); K3 {k3_ms:.4f} ms ({math.ceil(B * N / 64)} clusters, "
          f"{clusters} resident: {k3_waves} waves, "
          f"{k3_ms / k3_waves:.4f} ms per wave) [{card}]")


# name: (source, the C function it exports, [(text, replacement)])
VARIANTS = {
    "K1 without the cluster (CL = 1: W read once per 128 rows)": (
        "ln_linear.cu", "vlm_ln_linear",
        [("constexpr int CL = 2;", "constexpr int CL = 1;")]),
    "K1 releasing its stages with cluster-scope semantics": (
        "ln_linear.cu", "vlm_ln_linear",
        [("hop::mbar_arrive_remote(&empty[s], r)",
          "hop::mbar_arrive_cluster(&empty[s], r)")]),
    "K2 without the warpgroups' ping-pong": (
        "packed_attention_fwd.cu", "vlm_packed_attention",
        [("  hop::named_sync(1 + (threadIdx.x >> 7), 256);\n}", "}"),
         ("  hop::named_arrive(2 - (threadIdx.x >> 7), 256);\n}", "}"),
         ("  if (wg == 1) hop::named_arrive(1, 256);", ""),
         ("  if (wg == 0) hop::named_sync(1, 256);", "")]),
    "K2 with a whole 64-key last tile": (
        "packed_attention_fwd.cu", "vlm_packed_attention",
        [("  const int w_last = N - (nkt - 1) * BKV > 32 ? 64 : "
          "N - (nkt - 1) * BKV > 16 ? 32 : 16;", "  const int w_last = 64;")]),
}


def build_variants() -> dict:
    """Each variant's C function, from a patched copy of csrc/ built with
    nvcc (all at once) into build/variants/<i>/."""
    root = _build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, (name, (source, _, patches)) in enumerate(VARIANTS.items()):
        d = root / str(i)
        shutil.copytree(_build.CSRC, d)
        text = (d / source).read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in "
                                   f"{source}")
            text = text.replace(old, new)
        (d / source).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / source), str(d / "tensor_map.cu"),
             "-ldl"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        export = VARIANTS[name][1]
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), export)
        fn.argtypes = list(_build._SIGNATURES[export])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def variants(dev, card: str) -> None:
    """K1 and K2 against their rejected variants, in turns (built,
    variant, variant, built), through the same C entry."""
    fns = build_variants()
    lib = _build.library()
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for c in (smoke.C, smoke.C_L):
        x = torch.randn(smoke.IMAGE_BATCH * smoke.N, c, device=dev,
                        generator=gen).bfloat16()
        lw, lb = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        w = (0.02 * torch.randn(3 * c, c, device=dev, generator=gen)).bfloat16()
        b = torch.zeros(3 * c, device=dev)
        y = torch.empty(x.shape[0], 3 * c, device=dev, dtype=torch.bfloat16)
        calls[f"K1 at C={c}"] = ("vlm_ln_linear", (
            x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w.data_ptr(),
            b.data_ptr(), y.data_ptr(), x.shape[0], c, 3 * c, fb_ops.LN_EPS,
            stream), (x, lw, lb, w, b, y))
    for heads in (smoke.HEADS, smoke.HEADS_L):
        qkv = torch.randn(smoke.IMAGE_BATCH, smoke.N, 3 * 64 * heads,
                          device=dev, generator=gen).bfloat16()
        bias = torch.randn(heads, smoke.N, smoke.N, device=dev, generator=gen)
        mask = torch.ones(smoke.IMAGE_BATCH, smoke.N, dtype=torch.int32,
                          device=dev)
        mask[-1, 500:] = 0
        out = torch.empty(smoke.IMAGE_BATCH, smoke.N, 64 * heads, device=dev,
                          dtype=torch.bfloat16)
        calls[f"K2 at {heads} heads"] = ("vlm_packed_attention", (
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None, smoke.IMAGE_BATCH, smoke.N, heads, 64 ** -0.5, stream),
            (qkv, bias, mask, out))
    for name, fn in fns.items():
        export = VARIANTS[name][1]
        for shape, (entry, args, _) in calls.items():
            if entry != export:
                continue
            built = getattr(lib, entry)

            def run(f):
                _build.check(f(*args), entry)
            times = [smoke.time_ms(lambda: run(f))
                     for f in (built, fn, fn, built)]
            print(f"variants: {shape}: built {times[0]:.4f} / "
                  f"{times[3]:.4f} ms, {name} {times[1]:.4f} / "
                  f"{times[2]:.4f} ms [{card}]")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k7", action="store_true",
                        help="run K7's phase split alone")
    parser.add_argument("--variants", action="store_true",
                        help="run K1 and K2 beside their rejected variants "
                             "alone")
    opts = parser.parse_args()
    dev = require_cuda()
    card = smoke.card_line()
    print(card)
    if opts.variants:
        variants(dev, card)
        return
    k7_phases(dev, card)
    if opts.k7:
        return

    cfg = build_config(*smoke.CONFIG)
    spec = make_model_spec(cfg)
    base = smoke.seeded_params(spec, dev)
    params = eval_cast_params(base, spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    text_b, image_b, tiids, iids = smoke.synthetic_eval_set(spec, dev, gen)
    trace("eval", lambda: compute_irtr_recall(params, spec, text_b, image_b,
                                              tiids, iids), card)
    for fusion in FUSIONS:
        trace(f"image tower, fusion {fusion}", lambda: extract_features(
            params, spec, image_b, "image", fusion=fusion), card)
    cfg8 = build_config(*smoke.CONFIG, overrides=dict(eval_int8=True))
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(base, spec8, cfg8)
    trace("eval int8", lambda: compute_irtr_recall(
        params8, spec8, text_b, image_b, tiids, iids), card)
    del params8

    cfg224 = build_config(*smoke.CONFIG_224)
    spec224 = make_model_spec(cfg224)
    params224 = eval_cast_params(smoke.seeded_params(spec224, dev), spec224,
                                 cfg224)
    sets224 = smoke.synthetic_eval_set(spec224, dev, gen, smoke.N_IMAGES_224)
    trace("eval @224", lambda: compute_irtr_recall(params224, spec224,
                                                   *sets224), card)
    del params224, sets224

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
    trace("eval ViT-L", lambda: compute_irtr_recall(
        params_l, spec_l, [{"text_ids": ids, "text_masks": masks}], images,
        np.repeat(np.arange(smoke.L_IMAGES), per),
        np.arange(smoke.L_IMAGES)), card)
    del params_l
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


if __name__ == "__main__":
    main()
