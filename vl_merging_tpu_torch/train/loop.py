"""The trainer's step wiring (port of ``Trainer._build_step``,
``vl_merging_tpu/train/loop.py:257-266``, as one function).

The JAX package's ``Trainer.fit`` loop, its data modules, validation and
checkpointing are not ported yet (ROADMAP item "Trainer, CLI, data and
distribution").
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..models.spec import ModelSpec, Params
from . import train_step as ts
from .optimizer import make_optimizer
from .schedule import make_schedule

# the port trains on one device (multi-device: ROADMAP item "Trainer, CLI,
# data and distribution")
WORLD_SIZE = 1


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
                     max_steps: int, *, train_fusion: str = "0",
                     mim_label_fn: Optional[Callable] = None
                     ) -> Tuple[ts.TrainState, Callable]:
    """(state, step_fn) for ``max_steps`` optimizer steps over ``params``,
    which must be f32 masters (``ckpt/convert.master_params``); step_fn
    updates them in place.  Each step takes a batch with a leading
    ``accum_steps(cfg)`` micro-batch axis when that is above 1.
    ``train_fusion`` ("0", "tail" or "full") is the training fusion level
    and ``mim_label_fn`` the MIM labels' source
    (``train_step.make_train_step``)."""
    sched = make_schedule(cfg, max_steps)
    optimizer = make_optimizer(params, cfg, max_steps, sched)
    state = ts.init_train_state(params, optimizer, seed=cfg["seed"])
    step_fn = ts.make_train_step(cfg, spec, optimizer,
                                 dp_scale=1.0 / WORLD_SIZE,
                                 accum_steps=accum_steps(cfg),
                                 train_fusion=train_fusion,
                                 mim_label_fn=mim_label_fn)
    return state, step_fn
