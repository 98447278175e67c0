"""LR schedules: linear warmup + polynomial or cosine decay (port of
``vl_merging_tpu/train/schedule.py``).

Matches transformers' get_polynomial_decay_schedule_with_warmup /
get_cosine_schedule_with_warmup, which the reference steps per optimizer
step (reference: src/vilt/modules/vilt_utils.py:339-354).  Each schedule
maps an optimizer step (int) to a learning rate (float).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def polynomial_with_warmup(base_lr: float, warmup_steps: int, max_steps: int,
                           end_lr: float = 0.0,
                           power: float = 1.0) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        if step > max_steps:
            return end_lr
        remaining = 1.0 - (step - warmup_steps) / max(max_steps - warmup_steps,
                                                      1)
        return (base_lr - end_lr) * remaining ** power + end_lr
    return fn


def cosine_with_warmup(base_lr: float, warmup_steps: int, max_steps: int,
                       num_cycles: float = 0.5) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return base_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
    return fn


def resolve_warmup_steps(warmup_steps, max_steps: int) -> int:
    """float warmup = fraction of max_steps (vilt_utils.py:332-334)."""
    if isinstance(warmup_steps, float):
        return int(max_steps * warmup_steps)
    return int(warmup_steps)


def make_schedule(cfg: dict, max_steps: int) -> Schedule:
    warmup = resolve_warmup_steps(cfg["warmup_steps"], max_steps)
    if cfg["decay_power"] == "cosine":
        return cosine_with_warmup(cfg["learning_rate"], warmup, max_steps)
    return polynomial_with_warmup(
        cfg["learning_rate"], warmup, max_steps,
        end_lr=cfg["end_lr"], power=float(cfg["decay_power"]))
