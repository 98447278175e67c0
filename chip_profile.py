#!/usr/bin/env python3
"""Where the device time goes on the port's main paths (needs one NVIDIA
GPU):

    python3 chip_profile.py

Traces, with ``torch.profiler`` (CPU and CUDA activities), one warm call
of each window at ``chip_smoke.py``'s shapes and seeded inputs:
  * ``eval``: ``compute_irtr_recall`` over 64 images and 320 captions;
  * ``train (kernels)`` / ``train (plain)``: one optimizer step (2
    micro-batches of 32 pairs) on the kernel path and on the plain path
    (K9's three CUDA kernels, statistics + dq, dk/dv + dbias partials and
    the partial sum, show separately).
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
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall
from vl_merging_tpu_torch.models.spec import make_model_spec
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

    train_cfg = smoke.train_config(kernels=True)
    batch = smoke.synthetic_train_batch(spec, accum_steps(train_cfg), dev,
                                        gen)
    for kernels in (True, False):
        state, step = build_train_step(smoke.train_config(kernels), spec,
                                       master_params(base), 10)
        holder = [state]

        def one_step():
            holder[0] = step(holder[0], batch)[0]
        trace(f"train ({'kernels' if kernels else 'plain'})", one_step, card)
        del state, step, holder


if __name__ == "__main__":
    main()
