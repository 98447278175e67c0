"""The trainer's step wiring (port of ``Trainer._build_step``,
``vl_merging_tpu/train/loop.py:257-266``, as one function).

The JAX package's ``Trainer.fit`` loop, its data modules, validation and
checkpointing are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..models.spec import ModelSpec, Params
from . import train_step as ts
from .optimizer import make_optimizer
from .schedule import make_schedule

WORLD_SIZE = 1  # the port trains on one device (multi-device: ROADMAP A7)


def accum_steps(cfg: Dict) -> int:
    """Micro-batches per optimizer step: the config's global batch over the
    per-device batch times the device count (the JAX Trainer's rule)."""
    per_dev = cfg["per_device_batch_size"]
    if per_dev <= 0:
        raise ValueError(
            "per_device_batch_size must be set (> 0); it is the "
            "reference's per_gpu_batchsize")
    return max(1, cfg["batch_size"] // (per_dev * WORLD_SIZE))


def build_train_step(cfg: Dict, spec: ModelSpec, params: Params,
                     max_steps: int) -> Tuple[ts.TrainState, Callable]:
    """(state, step_fn) for ``max_steps`` optimizer steps over ``params``,
    which must be f32 masters (``ckpt/convert.master_params``); step_fn
    updates them in place.  Each step takes a batch with a leading
    ``accum_steps(cfg)`` micro-batch axis when that is above 1."""
    sched = make_schedule(cfg, max_steps)
    optimizer = make_optimizer(params, cfg, max_steps, sched)
    state = ts.init_train_state(params, optimizer, seed=cfg["seed"])
    step_fn = ts.make_train_step(cfg, spec, optimizer,
                                 dp_scale=1.0 / WORLD_SIZE,
                                 accum_steps=accum_steps(cfg))
    return state, step_fn
