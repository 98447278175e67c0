"""The training step (port of ``vl_merging_tpu/train/train_step.py``).

One call runs the forward over a batch, the task losses in reference
order, their sum, the backward and the optimizer update (reference:
src/vilt/modules/vilt_module.py:1467-1530, vilt_utils.py:225-359).

Parameters are f32 masters (``ckpt/convert.master_params``); the layers
cast each weight to the compute dtype (``spec.torch_compute_dtype``) where
it is used, exactly where the JAX package's ``linear``/``layer_norm``
cast, so no autocast is involved.  The gradients are f32, and the update
is added to the masters in place (no second copy of the params).

Gradient accumulation (the reference's accumulate_grad_batches,
run.py:210-212) is a Python loop over the leading micro-batch axis of the
batch: gradients and losses are summed, then divided by the number of
micro-batches, as the JAX package's ``lax.scan`` does.

Randomness (text dropout, stochastic depth) comes from the state's
``torch.Generator``.  Not carried over from the JAX package: the TPU's
``unsafe_rbg`` PRNG (``_fast_rng``), and the in-graph augmentation and MLM
masking hooks (``device_augment``, ``device_mlm``: ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..models.spec import ModelSpec, Params
from . import objectives
from .optimizer import AdamW, OptState

# the tasks of the JAX package's compute_losses that the port does not
# run yet, with the ROADMAP item that brings each
_NOT_PORTED = {
    "mlm": "A6 (@224 pretrain objectives)",
    "mim": "A6 (@224 pretrain objectives) and A10 (dVAE)",
    "ifm": "A6 (@224 pretrain objectives)",
    "itm": "A6 (@224 pretrain objectives)",
    "image_only_mim": "A6 and A10 (dVAE)",
    "text_only_mlm": "A6 (@224 pretrain objectives)",
    "vqa": "A4 (fused VL pass) and A6",
    "nlvr2": "A4 (fused VL pass) and A6",
    "img_cls": "A6",
}


@dataclasses.dataclass
class TrainState:
    params: Params               # f32 masters, leaves that require grad
    opt_state: OptState
    step: int
    generator: torch.Generator   # dropout and stochastic-depth draws


def _resolve_kernels(cfg: Dict, spec: ModelSpec) -> bool:
    """The kernel switch of the step (the JAX package's _resolve_pallas):
    ``pallas_attention=None`` means auto, on at image_len ≥ 577 (@384+),
    where the JAX package turns its packed attention kernels on."""
    flag = cfg.get("pallas_attention", None)
    if flag is None:
        return spec.image_len >= 577
    return bool(flag)


def active_tasks(cfg: Dict) -> Tuple[str, ...]:
    """Tasks with loss weight ≥ 1 (reference vilt_utils.py:218-222)."""
    return tuple(k for k, v in cfg["loss_names"].items() if v >= 1)


def compute_losses(params: Params, spec: ModelSpec, cfg: Dict, batch: Dict,
                   generator: torch.Generator, *,
                   kernels: bool = True) -> Dict:
    """Training-mode task dispatch in reference order
    (vilt_module.py:1467-1523); the port runs irtr and raises for every
    other task."""
    if cfg["tasks"] is not None and any(k in batch for k in ("v", "l", "vl")):
        raise NotImplementedError(
            "mixed single/multi-modal batches are not ported yet: ROADMAP A6")
    tasks = active_tasks(cfg)
    for task in tasks:
        if task in _NOT_PORTED:
            raise NotImplementedError(
                f"the {task} objective is not ported yet: ROADMAP "
                f"{_NOT_PORTED[task]}")
    out: Dict = {}
    if "irtr" in tasks:
        out.update(objectives.compute_irtr(params, spec, batch, train=True,
                                           generator=generator,
                                           kernels=kernels))
    return out


# Contrastive losses carry the reference's DDP 1/world gradient factor
# (see objectives.py module docstring).
_DP_SCALED_LOSSES = ("ifm_loss", "irtr_loss")


def total_loss(out: Dict, dp_scale: float = 1.0) -> torch.Tensor:
    """Σ of every *_loss key (vilt_module.py:1525-1530)."""
    total = 0.0
    for k, v in out.items():
        if k.endswith("_loss"):
            total = total + (v * dp_scale if k in _DP_SCALED_LOSSES else v)
    return total


def scalar_metrics(out: Dict) -> Dict[str, torch.Tensor]:
    """Keep 0-d tensors only (drop logits, other large arrays and plain
    Python counts), detached."""
    return {k: v.detach() for k, v in out.items()
            if isinstance(v, torch.Tensor) and v.ndim == 0}


def loss_and_grads(params: Params, spec: ModelSpec, cfg: Dict, batch: Dict,
                   generator: torch.Generator, *, kernels: bool,
                   dp_scale: float = 1.0):
    """(loss, scalar metrics, f32 grads) of one micro-batch.  A param that
    the loss does not reach gets a zero gradient, as under jax.grad."""
    out = compute_losses(params, spec, cfg, batch, generator,
                         kernels=kernels)
    loss = total_loss(out, dp_scale)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
    return loss.detach(), scalar_metrics(out), {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, grads)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ leaf²) over every leaf (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tree.values()))))


def make_train_step(cfg: Dict, spec: ModelSpec, optimizer: AdamW, *,
                    dp_scale: float = 1.0, accum_steps: int = 1
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Build the train step.

    With ``accum_steps > 1`` the batch must have a leading (accum, micro,
    …) layout; gradients are averaged over micro-steps before one
    optimizer update — semantics of Lightning's accumulate_grad_batches.
    The kernel switch is ``_resolve_kernels(cfg, spec)``."""
    kernels = _resolve_kernels(cfg, spec)

    def micro(state: TrainState, batch: Dict):
        return loss_and_grads(state.params, spec, cfg, batch,
                              state.generator, kernels=kernels,
                              dp_scale=dp_scale)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if accum_steps == 1:
            loss, metrics, grads = micro(state, batch)
        else:
            loss, grads = 0.0, None
            for i in range(accum_steps):
                mb_loss, metrics, mb_grads = micro(
                    state, {k: v[i] for k, v in batch.items()})
                loss = loss + mb_loss
                if grads is None:
                    grads = mb_grads
                else:
                    torch._foreach_add_(list(grads.values()),
                                        [mb_grads[k] for k in grads])
            torch._foreach_div_(list(grads.values()), accum_steps)
            loss = loss / accum_steps
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        with torch.no_grad():
            torch._foreach_add_([state.params[k] for k in updates],
                                list(updates.values()))
        metrics = dict(metrics, total_loss=loss, grad_norm=global_norm(grads))
        return TrainState(state.params, opt_state, state.step + 1,
                          state.generator), metrics

    return step


def init_train_state(params: Params, optimizer: AdamW,
                     seed: int = 0) -> TrainState:
    """The state of step 0 over ``params``, which must be the f32 masters
    (``ckpt/convert.master_params``): the step updates them in place.
    The generator lives on the params' device."""
    device = next(iter(params.values())).device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0,
                      generator=torch.Generator(device=device).manual_seed(
                          seed))
