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

Over a process group (``parallel.Mesh``) each rank runs the step on its
row share of the global batch.  The losses are the ranks' shares
(``objectives.py``); after the micro-batch accumulation the f32 gradients
are averaged over the group (``parallel.mesh.average_grads``), or, under
``use_sharded_training``, reduce-scattered to the shards that each rank
updates (``reduce_grads``; the full params are gathered for the pass).
The reported metrics are the global batch's on every rank
(``reduce_metrics``), and the step equals one process's over the global
batch with the same ``dp_scale``.

Randomness (text dropout, stochastic depth, ITM's hard negatives, the
device MLM masks) comes from the state's ``torch.Generator``, seeded alike
on every rank (the draws are rank-invariant: ``models/layers.rank_rand``).
Not carried over from the JAX package: the TPU's ``unsafe_rbg`` PRNG
(``_fast_rng``).

Device-side preprocessing, per micro-batch before the losses, as the JAX
package's ``loss_fn`` does: under ``device_augment`` the uint8
``image_canvas`` and the host-sampled ``aug_*`` params
(``attach_augment_params``) become the normalized train image
(``ops/augment.augment_train_batch``); under ``device_mlm`` the
collator's ``text_word_ids`` become ``text_ids_mlm`` / ``text_labels_mlm``
(``ops/text_masking``).  The eval step applies ``device_mlm`` only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.spec import ModelSpec, Params
from ..ops.augment import augment_train_batch, sample_train_params
from ..ops.text_masking import apply_mlm, mlm_draws
from ..parallel import host
from ..parallel.mesh import (Mesh, average_grads, gather_params,
                             global_sq_norm, make_mesh, reduce_grads)
from . import objectives
from .optimizer import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    params: Params               # f32 masters, leaves that require grad
    opt_state: OptState
    step: int
    generator: torch.Generator   # dropout and stochastic-depth draws
    # sharded training: each param's shard axis (None: replicated) over
    # the mesh's fsdp ranks; params and optimizer moments are the shards
    shardings: Optional[Dict[str, Optional[int]]] = None
    mesh: Optional[Mesh] = None

    def full_params(self) -> Params:
        """The full params: under sharded training the shards gathered
        (a collective every rank reaches), else ``params``."""
        if self.shardings is None:
            return self.params
        return gather_params(self.params, self.shardings, self.mesh)


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
                   generator: Optional[torch.Generator], *,
                   train: bool = True, kernels: bool = True,
                   train_fusion: str = "0",
                   mim_label_fn: Optional[Callable] = None) -> Dict:
    """Task dispatch in reference order (vilt_module.py:1467-1523; the JAX
    package's train_step.py:77-138).  A mixed single/multi-modal batch
    (``cfg["tasks"]`` set, a dict of sub-batches ``{"v", "l", "vl"}``) runs
    image_only_mim on "v", text_only_mlm on "l" and the rest on "vl".
    MIM's labels are ``mim_label_fn(batch)`` (the dVAE's codebook ids of
    ``image_target``: ``dvae.make_mim_label_fn``), else the batch's
    ``mim_labels``.  ``train=False`` is the eval-mode forward of the eval
    step and the gram pass (``train/gram.py``; the JAX package's
    gram.py:36-58): no dropout, no stochastic depth, the eval blocks.
    ``train_fusion`` is the training fusion level of every block ("0",
    "tail" or "full"; ``mome._block_fast_train``).  itm samples its hard
    negatives from ifm's logits, so it needs ifm (``ValueError``)."""
    tasks = active_tasks(cfg)
    route = dict(train=train, generator=generator, kernels=kernels,
                 train_fusion=train_fusion)
    out: Dict = {}

    def mim_labels(b):
        return mim_label_fn(b) if mim_label_fn is not None \
            else b["mim_labels"]

    if cfg["tasks"] is not None and any(k in batch for k in ("v", "l", "vl")):
        if "v" in batch and "image_only_mim" in tasks:
            out.update(objectives.compute_mim_image_only(
                params, spec, batch["v"], mim_labels=mim_labels(batch["v"]),
                **route))
        if "l" in batch and "text_only_mlm" in tasks:
            out.update(objectives.compute_mlm_text_only(
                params, spec, batch["l"], **route))
        if "vl" not in batch:
            return out
        batch = batch["vl"]

    if "mlm" in tasks:
        out.update(objectives.compute_mlm(
            params, spec, batch, vl_mlm_weight=cfg["vl_mlm_weight"], **route))
    if "mim" in tasks:
        out.update(objectives.compute_mim(
            params, spec, batch, mim_labels=mim_labels(batch), **route))
    if "ifm" in tasks:
        out.update(objectives.compute_ifm(
            params, spec, batch, ifm_weight=cfg["ifm_weight"], **route))
    if "irtr" in tasks:
        out.update(objectives.compute_irtr(params, spec, batch, **route))
    if "itm" in tasks:
        if "ifm_i2t_logits" not in out:
            raise ValueError(
                "itm requires ifm in loss_names: hard negatives are sampled "
                "from ifm's similarity logits (reference "
                "vilt_module.py:1509-1510)")
        out.update(objectives.compute_itm_hardneg(
            params, spec, batch, out["ifm_i2t_logits"], out["ifm_t2i_logits"],
            **route))
    if "vqa" in tasks:
        out.update(objectives.compute_vqa(params, spec, batch, **route))
    if "img_cls" in tasks:
        out.update(objectives.compute_img_cls(params, spec, batch, **route))
    if "nlvr2" in tasks:
        out.update(objectives.compute_nlvr2(params, spec, batch, **route))
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


# metrics summed over the ranks (each rank counts its own rows)
_TALLIES = ("_correct", "_count", "_score_sum")


def reduce_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The global batch's metrics on every rank: the tallies summed over
    the ranks, every other metric (the losses, the logit scales) averaged
    (each rank's loss is its share, ``objectives.py``); f32.  In one
    process the metrics as they are."""
    world = host.get_world_size()
    if world == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = host.all_reduce_(torch.stack([metrics[k].float() for k in keys]))
    tally = torch.tensor([k.endswith(_TALLIES) for k in keys],
                         device=vals.device)
    return dict(zip(keys, torch.where(tally, vals, vals / world).unbind()))


def _per_task(fn, batch: Dict) -> Dict:
    """``fn(sub_batch, task)`` over a mixed batch's {"v", "l", "vl"}
    sub-batches, or ``fn(batch, None)``."""
    if any(t in batch for t in ("v", "l", "vl")):
        return {t: fn(b, t) for t, b in batch.items()}
    return fn(batch, None)


def device_mlm_batch(cfg: Dict, spec: ModelSpec, batch: Dict,
                     generator: torch.Generator) -> Dict:
    """``text_ids_mlm`` / ``text_labels_mlm`` derived on the batch's device
    (``device_mlm``) from the collator's RNG-free ``text_word_ids`` (-1 on
    special and padding tokens): ``ops/text_masking.apply_mlm`` with its
    draws from ``generator``.  A mixed {"v", "l", "vl"} batch masks each
    sub-batch that has word ids, "vl" with ``vl_mlm_prob`` and the others
    with ``mlm_prob`` (MultiMTDataModule's host convention)."""
    mask_id = cfg.get("mask_token_id")
    if mask_id is None:
        raise ValueError("device_mlm=True needs mask_token_id (the "
                         "Trainer resolves it from the tokenizer)")
    whole = cfg["whole_word_masking"]

    def one(b, task):
        if not isinstance(b, dict) or "text_word_ids" not in b:
            return b
        wid = b["text_word_ids"]
        prob = cfg["vl_mlm_prob"] if task == "vl" else cfg["mlm_prob"]
        draws = mlm_draws(wid.shape, generator, spec.vocab_size, whole)
        ids_mlm, labels = apply_mlm(b["text_ids"], wid < 0, draws, prob,
                                    mask_id, word_ids=wid if whole else None)
        return dict(b, text_ids_mlm=ids_mlm, text_labels_mlm=labels)

    return _per_task(one, batch)


def attach_augment_params(batch: Dict, cfg: Dict,
                          rng: np.random.RandomState) -> Dict:
    """The host side of ``device_augment``: every scalar random choice of
    the train image pipeline (crop boxes by torchvision's rejection loop,
    flip coins, RandAugment op ids and magnitudes) sampled from ``rng``
    (the Trainer's stream) for a loaded micro-batch, attached as ``aug_*``
    arrays in place of ``image_sizes``; the pixel work happens on the card
    (``device_augment_batch``)."""
    def one(b, task):
        if not isinstance(b, dict) or "image_sizes" not in b:
            return b
        b = dict(b)
        params = sample_train_params(rng, b.pop("image_sizes"),
                                     cfg["image_size"])
        b.update({f"aug_{k}": v for k, v in params.items()})
        return b

    return _per_task(one, batch)


def device_augment_batch(cfg: Dict, batch: Dict) -> Dict:
    """The normalized (B, 3, S, S) train ``image`` derived on the batch's
    device (``device_augment``) from the uint8 ``image_canvas`` and the
    ``aug_*`` params (``ops/augment.augment_train_batch``); the canvas and
    the params leave the batch."""
    def one(b, task):
        if not isinstance(b, dict) or "image_canvas" not in b:
            return b
        params = {k[4:]: v for k, v in b.items() if k.startswith("aug_")}
        img = augment_train_batch(b["image_canvas"], params,
                                  cfg["image_size"])
        rest = {k: v for k, v in b.items()
                if k != "image_canvas" and not k.startswith("aug_")}
        return dict(rest, image=img)

    return _per_task(one, batch)


def preprocess(cfg: Dict, spec: ModelSpec, batch: Dict,
               generator: Optional[torch.Generator], *,
               train: bool = True) -> Dict:
    """The device-side preprocessing of one micro-batch, where the JAX
    package's step applies it: the augment (training only), then the MLM
    masking, each under its config flag."""
    if train and cfg.get("device_augment"):
        batch = device_augment_batch(cfg, batch)
    if cfg.get("device_mlm"):
        if generator is None:
            raise ValueError("device_mlm draws its masks from a generator")
        batch = device_mlm_batch(cfg, spec, batch, generator)
    return batch


def loss_and_grads(params: Params, spec: ModelSpec, cfg: Dict, batch: Dict,
                   generator: torch.Generator, *, kernels: bool,
                   dp_scale: float = 1.0, train_fusion: str = "0",
                   mim_label_fn: Optional[Callable] = None):
    """(loss, scalar metrics, f32 grads) of one micro-batch, after its
    device-side preprocessing (``preprocess``).  A param that the loss
    does not reach gets a zero gradient, as under jax.grad.  Over a
    process group the contrastive losses' gradient takes ``dp_scale`` ×
    the group's size, which the step's average over the ranks divides
    back (the loss returned carries ``dp_scale``)."""
    batch = preprocess(cfg, spec, batch, generator)
    out = compute_losses(params, spec, cfg, batch, generator,
                         kernels=kernels, train_fusion=train_fusion,
                         mim_label_fn=mim_label_fn)
    world = host.get_world_size()
    loss = total_loss(out, dp_scale * world)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
    if world != 1:
        loss = total_loss(out, dp_scale)
    return loss.detach(), scalar_metrics(out), {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, grads)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ leaf²) over every leaf (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tree.values()))))


def micro_batch(batch: Dict, i: int) -> Dict:
    """Micro-batch ``i`` of a batch with a leading micro-batch axis; a
    mixed batch's sub-batches each by theirs."""
    return {k: micro_batch(v, i) if isinstance(v, dict) else v[i]
            for k, v in batch.items()}


def make_train_step(cfg: Dict, spec: ModelSpec, optimizer: Optimizer, *,
                    dp_scale: float = 1.0, accum_steps: int = 1,
                    train_fusion: str = "0",
                    mim_label_fn: Optional[Callable] = None,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Build the train step.

    With ``accum_steps > 1`` the batch must have a leading (accum, micro,
    …) layout; gradients are averaged over micro-steps before one
    optimizer update — semantics of Lightning's accumulate_grad_batches.
    The kernel switch is ``_resolve_kernels(cfg, spec)``; ``train_fusion``
    ("0", "tail" or "full") is the training fusion level, the JAX
    package's ``VLM_TPU_TRAIN_FUSION``; ``mim_label_fn`` gives MIM its
    labels (``compute_losses``).  ``mesh`` (default: the process group,
    ``parallel.make_mesh()``) is the group the gradients are reduced
    over; a state with ``shardings`` is stepped sharded."""
    kernels = _resolve_kernels(cfg, spec)
    mesh = mesh or make_mesh()

    def micro(params: Params, state: TrainState, batch: Dict):
        return loss_and_grads(params, spec, cfg, batch,
                              state.generator, kernels=kernels,
                              dp_scale=dp_scale, train_fusion=train_fusion,
                              mim_label_fn=mim_label_fn)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        if state.shardings is not None:
            params = {k: v if state.shardings[k] is None
                      else v.requires_grad_()
                      for k, v in state.full_params().items()}
        if accum_steps == 1:
            loss, metrics, grads = micro(params, state, batch)
        else:
            loss, grads = 0.0, None
            for i in range(accum_steps):
                mb_loss, metrics, mb_grads = micro(
                    params, state, micro_batch(batch, i))
                loss = loss + mb_loss
                if grads is None:
                    grads = mb_grads
                else:
                    torch._foreach_add_(list(grads.values()),
                                        [mb_grads[k] for k in grads])
            torch._foreach_div_(list(grads.values()), accum_steps)
            loss = loss / accum_steps
        if state.shardings is not None:
            grads = reduce_grads(grads, state.shardings, mesh)
            grad_norm = global_sq_norm(grads, state.shardings, mesh).sqrt()
        else:
            average_grads(grads, mesh)
            grad_norm = global_norm(grads)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        with torch.no_grad():
            torch._foreach_add_([state.params[k] for k in updates],
                                list(updates.values()))
        metrics = dict(reduce_metrics(dict(metrics, total_loss=loss)),
                       grad_norm=grad_norm)
        return dataclasses.replace(state, opt_state=opt_state,
                                   step=state.step + 1), metrics

    return step


def make_eval_step(cfg: Dict, spec: ModelSpec,
                   mim_label_fn: Optional[Callable] = None
                   ) -> Callable[[Params, Dict, Optional[torch.Generator]],
                                 Dict[str, torch.Tensor]]:
    """The validation step (the JAX package's ``make_eval_step``):
    ``compute_losses(..., train=False)`` under the step's kernel switch
    (``_resolve_kernels``), then ``scalar_metrics``, the global batch's
    (``reduce_metrics``); no gradient.  The generator feeds ITM's
    hard-negative draws and, under ``device_mlm``, the masks."""
    kernels = _resolve_kernels(cfg, spec)

    @torch.no_grad()
    def eval_step(params: Params, batch: Dict,
                  generator: Optional[torch.Generator]):
        batch = preprocess(cfg, spec, batch, generator, train=False)
        out = compute_losses(params, spec, cfg, batch, generator,
                             train=False, kernels=kernels,
                             mim_label_fn=mim_label_fn)
        return reduce_metrics(scalar_metrics(out))

    return eval_step


def init_train_state(params: Params, optimizer: Optimizer,
                     seed: int = 0, shardings=None,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """The state of step 0 over ``params``, which must be the f32 masters
    (``ckpt/convert.master_params``; under sharded training this rank's
    shards of them, with their ``shardings`` over ``mesh``): the step
    updates them in place.  The generator lives on the params' device."""
    device = next(iter(params.values())).device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0,
                      generator=torch.Generator(device=device).manual_seed(
                          seed), shardings=shardings, mesh=mesh)
