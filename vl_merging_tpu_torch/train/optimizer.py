"""Optimizer with the reference's 4 param groups (port of
``vl_merging_tpu/train/optimizer.py``).

(decay, no-decay) × (base-lr, head-lr·lr_mult) — reference
src/vilt/modules/vilt_utils.py:225-321.  no-decay = biases + every
LayerNorm flavor (incl. per-expert norms); head groups = downstream
classifiers plus optional expert subsets (all_{mlp,vl,v,l}_mult), with
their own weight_decay_custom_modules.

The update is a function over the param dict, the same chain as the JAX
package's optax chain (torch AdamW's update):
  p ← p − group_lr · (adam_dir + wd_group · p)
``AdamW.update`` returns the updates and the new state and leaves the
params alone; the train step adds the updates to its f32 masters in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models.spec import Params
from .schedule import Schedule

B1, EPS = 0.9, 1e-8  # Adam's first-moment decay and epsilon (optimizer.py:82)

NO_DECAY_SUBSTRINGS = (
    "bias",
    "LayerNorm.bias", "LayerNorm.weight",
    "norm.bias", "norm.weight",
    "norm1.bias", "norm1.weight",
    "norm2.bias", "norm2.weight",
    "norm.v.bias", "norm.v.weight",
    "norm.l.bias", "norm.l.weight",
    "norm.vl.bias", "norm.vl.weight",
)


def head_names(cfg: Dict) -> tuple:
    names = ["vqa_classifier", "nlvr2_classifier", "img_cls_classifier"]
    if cfg["all_mlp_mult"]:
        names.append("mlp")
    if cfg["all_vl_mult"]:
        names += ["attn.vl", "mlp.vl", "mlp_vl"]
    if cfg["all_v_mult"]:
        names += ["attn.v", "mlp.v"]
    if cfg["all_l_mult"]:
        names += ["attn.l", "mlp.l"]
    return tuple(names)


def is_no_decay(name: str) -> bool:
    return any(nd in name for nd in NO_DECAY_SUBSTRINGS)


def param_masks(params: Params, cfg: Dict) -> Dict[str, Dict[str, bool]]:
    heads = head_names(cfg)

    def is_head(name):
        return any(h in name for h in heads)

    return {
        "decay_base": {k: (not is_no_decay(k)) and (not is_head(k))
                       for k in params},
        "decay_head": {k: (not is_no_decay(k)) and is_head(k) for k in params},
        "head": {k: is_head(k) for k in params},
    }


@dataclasses.dataclass
class OptState:
    count: int                    # optimizer steps taken
    mu: Dict[str, torch.Tensor]   # Adam's first moments
    nu: Dict[str, torch.Tensor]   # Adam's second moments


@dataclasses.dataclass
class AdamW:
    """Adam, masked decoupled weight decay, the learning-rate schedule and
    the head lr multiplier, in that order (optax.scale_by_adam,
    add_decayed_weights ×2, scale_by_schedule, the lr_mult scale)."""
    b2: float
    weight_decay: float
    weight_decay_head: float
    lr_mult: float
    schedule: Schedule
    masks: Dict[str, Dict[str, bool]]

    def init(self, params: Params) -> OptState:
        def zeros():
            return {k: torch.zeros_like(v, dtype=torch.float32)
                    for k, v in params.items()}
        return OptState(0, zeros(), zeros())

    def update(self, grads: Params, state: OptState, params: Params):
        """(updates, new state) for one optimizer step; ``grads`` f32.  The
        arithmetic runs as multi-tensor (``torch._foreach_*``) ops over all
        leaves at once, in optax's order of operations."""
        keys = list(grads)
        g = [grads[k] for k in keys]
        p = [params[k].detach() for k in keys]
        count = state.count + 1
        mu = torch._foreach_mul(g, 1 - B1)
        torch._foreach_add_(mu, torch._foreach_mul(
            [state.mu[k] for k in keys], B1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            [state.nu[k] for k in keys], self.b2))
        # bias corrections and the learning rate as f32 scalars, as optax
        f32 = torch.float32
        c1 = float(1 - torch.tensor(B1, dtype=f32) ** count)
        c2 = float(1 - torch.tensor(self.b2, dtype=f32) ** count)
        lr = float(torch.tensor(-self.schedule(state.count), dtype=f32))
        u = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(u, den)
        for mask, wd in (("decay_base", self.weight_decay),
                         ("decay_head", self.weight_decay_head)):
            idx = [i for i, k in enumerate(keys) if self.masks[mask][k]]
            if idx:
                torch._foreach_add_([u[i] for i in idx], torch._foreach_mul(
                    [p[i] for i in idx], wd))
        torch._foreach_mul_(u, lr)
        heads = [u[i] for i, k in enumerate(keys) if self.masks["head"][k]]
        if self.lr_mult != 1.0 and heads:
            torch._foreach_mul_(heads, self.lr_mult)
        return dict(zip(keys, u)), OptState(count, dict(zip(keys, mu)),
                                            dict(zip(keys, nu)))


def make_optimizer(params: Params, cfg: Dict, max_steps: int,
                   schedule_fn: Schedule) -> AdamW:
    """The reference's AdamW over its 4 param groups.  ``max_steps`` is
    held by ``schedule_fn``; it stays in the signature of the JAX
    package's make_optimizer."""
    del max_steps
    if cfg["optim_type"] != "adamw":
        raise NotImplementedError(
            f"optim_type {cfg['optim_type']!r}: only adamw (every reference "
            f"config's) is ported; adam and sgd wait for ROADMAP A6")
    return AdamW(b2=cfg["beta_2"], weight_decay=cfg["weight_decay"],
                 weight_decay_head=cfg["weight_decay_custom_modules"],
                 lr_mult=float(cfg["lr_mult"]), schedule=schedule_fn,
                 masks=param_masks(params, cfg))
