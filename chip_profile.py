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
    kernels, statistics + dq, dk/dv + dbias partials and the partial sum,
    show separately).
For each window it prints the host wall time, the device busy time (the
union of the device kernels' intervals), the idle share (1 − busy / wall)
and the kernels with the most device time.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, master_params
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.device import require_cuda
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall, \
    extract_features
from vl_merging_tpu_torch.models.spec import make_model_spec
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


def main() -> None:
    dev = require_cuda()
    card = smoke.card_line()
    print(card)

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


if __name__ == "__main__":
    main()
