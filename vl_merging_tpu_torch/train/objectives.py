"""Training objectives (port of ``vl_merging_tpu/train/objectives.py``):
MLM (fused and text-only), MIM (fused and image-only), the two-branch
contrastive ifm, ITM with hard negatives, irtr, and the VQA, NLVR2 and
ImageNet heads, each in training and in eval mode.

The JAX package writes each loss over the global batch under ``jit`` and
lets XLA insert the cross-replica gathers.  The port runs one process per
device and gathers explicitly (``parallel/host.py``); each rank's losses
are its share of the global ones, such that their mean over the ranks is
the global loss, and the mean of the ranks' gradients (the data-parallel
step's all-reduce) is the one-process gradient over the global batch:

  * ifm and irtr gather the cls features of every rank through
    ``all_gather_with_grad``, whose backward keeps this rank's rows of the
    gradient: every rank computes the same full-batch loss, and each
    rank's parameters see it through its own features only (the
    reference's gather); the logit scales, which every rank applies alike
    after the gather, take 1/world of their gradient on each rank
    (``grad_share``; the reference's DDP gives them the full gradient);
  * ITM draws its hard negatives over the global similarity matrix (the
    same draw on every rank, from the shared generator), gathers the
    negative pool (images, ids, masks; no gradient) and keeps its rows;
  * the masked means (MLM's tokens, MIM's patches) divide by the global
    count (an all-reduce of the counts), times the world size, because
    the masks leave a different count on each rank;
  * the dense row means (ITM, VQA, NLVR2, ImageNet) are the rank's mean
    over its equal share of the rows.

The ``*_correct`` and ``*_count`` tallies count this rank's rows, so their
sum over the ranks is the global one (``train_step.reduce_metrics``).

Gradient-scale parity note (as in the JAX package): the reference
backprops the full-batch contrastive loss only through local features and
DDP averages gradients, so its effective ifm/irtr gradient is
grad(L_full) / world_size; ``train_step.total_loss``'s ``dp_scale``
reproduces that factor in one process, and the gather with the gradient
average reproduces it over ranks.

Dynamic-shape ops of the reference (boolean indexing of masked patches,
per-sample Python loops) are masked dense reductions, as in the JAX
package: the same math with static shapes.  Every objective takes the
routing of its passes (``kernels``, ``train_fusion``) and, in training,
draws its randomness from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..evaluation.downstream import nlvr2_logits
from ..models import model
from ..models.spec import ModelSpec, Params
from ..parallel import host

IGNORE_INDEX = -100   # the MLM labels of unmasked tokens


def _masked_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total`` over the count of the global batch (at least 1): this
    rank's share of a masked mean, scaled by the world size so that the
    ranks' mean is the global mean; in one process total / count."""
    world = host.get_world_size()
    count = host.all_reduce_(count.detach().float().clone())
    return total / count.clamp_min(1.0) * world


def _ce_ignore_index(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-entropy with ignore_index semantics: the f32 log-softmax, the
    mean over valid targets (``_masked_mean``).  Returns (loss,
    correct_count, valid_count)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logits = logits.float()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    count = valid.sum()
    loss = _masked_mean(nll.sum(), count)
    correct = ((logits.argmax(-1) == safe) & valid).sum()
    return loss, correct, count


def _ce_dense(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain mean cross-entropy with integer labels (f32 logits)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


# --------------------------------------------------------------------------
# MLM (objectives.py:88-143)
# --------------------------------------------------------------------------

def compute_mlm(params: Params, spec: ModelSpec, batch: Dict, *,
                vl_mlm_weight: float = 1.0, train: bool = False,
                generator: Optional[torch.Generator] = None,
                kernels: bool = True, train_fusion: str = "0") -> Dict:
    """MLM over the fused pass of the masked text (``text_ids_mlm``)
    against ``text_labels_mlm`` (-100 off the masked tokens)."""
    infer = model.infer(params, spec, batch, mask_text=True, train=train,
                        generator=generator, kernels=kernels,
                        train_fusion=train_fusion)
    logits = model.mlm_head(params, infer["text_feats"])
    loss, correct, count = _ce_ignore_index(logits, infer["text_labels"])
    return {"mlm_loss": loss * vl_mlm_weight,
            "mlm_correct": correct, "mlm_count": count}


def compute_mlm_text_only(params: Params, spec: ModelSpec, batch: Dict, *,
                          train: bool = False,
                          generator: Optional[torch.Generator] = None,
                          kernels: bool = True,
                          train_fusion: str = "0") -> Dict:
    """MLM over the text tower alone (the all-in-one pretrain's "l"
    batch)."""
    infer = model.infer_text_ft(params, spec, batch, mask_text=True,
                                train=train, generator=generator,
                                kernels=kernels, train_fusion=train_fusion)
    logits = model.mlm_head(params, infer["text_feats"])
    loss, correct, count = _ce_ignore_index(logits, infer["text_labels"])
    return {"text_only_mlm_loss": loss,
            "text_only_mlm_correct": correct, "text_only_mlm_count": count}


# --------------------------------------------------------------------------
# MIM (objectives.py:18-85): a masked dense mean, not a boolean gather
# --------------------------------------------------------------------------

def _mim_loss(params: Params, image_feats: torch.Tensor,
              mim_labels: torch.Tensor, masked_pos: torch.Tensor):
    """Cross-entropy over the dVAE codebook at the masked patches: the f32
    log-softmax of the ``mim_head`` logits (B, P, 8192), its mean over the
    masked positions."""
    logits = model.mim_head(params, image_feats[:, 1:]).float()
    labels = mim_labels.long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[
        ..., 0]
    m = masked_pos.float()
    loss = _masked_mean((nll * m).sum(), m.sum())
    correct = ((logits.argmax(-1) == labels) & masked_pos).sum()
    return loss, correct, m.sum()


def compute_mim(params: Params, spec: ModelSpec, batch: Dict, *,
                mim_labels: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                kernels: bool = True, train_fusion: str = "0") -> Dict:
    """MIM over the fused pass with the patches of ``image_masked_pos``
    masked; ``mim_labels`` (B, P) are the dVAE codebook ids of the target
    view (``dvae.make_mim_label_fn``; reference objectives.py:27-29)."""
    masked = batch["image_masked_pos"].bool()
    infer = model.infer(params, spec, batch, bool_masked_pos=masked,
                        train=train, generator=generator, kernels=kernels,
                        train_fusion=train_fusion)
    loss, correct, count = _mim_loss(params, infer["image_feats"],
                                     mim_labels, masked)
    return {"mim_loss": loss, "mim_correct": correct, "mim_count": count}


def compute_mim_image_only(params: Params, spec: ModelSpec, batch: Dict, *,
                           mim_labels: torch.Tensor, train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           kernels: bool = True,
                           train_fusion: str = "0") -> Dict:
    """MIM over the image tower alone (the all-in-one pretrain's "v"
    batch)."""
    masked = batch["image_masked_pos"].bool()
    infer = model.infer_image_ft(params, spec, batch, bool_masked_pos=masked,
                                 train=train, generator=generator,
                                 kernels=kernels, train_fusion=train_fusion)
    loss, correct, count = _mim_loss(params, infer["image_feats"],
                                     mim_labels, masked)
    return {"image_only_mim_loss": loss, "image_only_mim_correct": correct,
            "image_only_mim_count": count}


# --------------------------------------------------------------------------
# Contrastive (ifm, objectives.py:248-369; irtr, :372-443)
# --------------------------------------------------------------------------

def _info_nce(image_feats, text_feats,
              logit_scale) -> Tuple[torch.Tensor, ...]:
    """Symmetric InfoNCE over the global batch (every rank's features,
    ``all_gather_with_grad``; the logit scale through ``grad_share``); f32
    logits (global B × B)."""
    image_feats = host.all_gather_with_grad(image_feats)
    text_feats = host.all_gather_with_grad(text_feats)
    logit_scale = host.grad_share(logit_scale)
    logits_i2t = logit_scale * (image_feats @ text_feats.T).float()
    logits_t2i = logits_i2t.T
    labels = torch.arange(image_feats.shape[0], device=image_feats.device)
    loss = 0.5 * (_ce_dense(logits_i2t, labels)
                  + _ce_dense(logits_t2i, labels))
    return loss, logits_i2t, logits_t2i, labels


def _hits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).sum()


def _rank_hits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``_hits`` over this rank's rows of global logits."""
    rows = host.process_rows(logits.shape[0])
    return _hits(logits[rows], labels[rows])


def compute_ifm(params: Params, spec: ModelSpec, batch: Dict, *,
                ifm_weight: float = 1.0, train: bool = False,
                generator: Optional[torch.Generator] = None,
                kernels: bool = True, train_fusion: str = "0") -> Dict:
    """ifm: InfoNCE between the pretrain towers' cls features (scale
    ``logit_scale``) and between their vlffn re-runs' (``logit_vl_scale``),
    combined as (ifm_weight·L_b + L_vl) / 2.  The i2t and t2i logits of
    the first stay in the output: ITM samples its negatives from them."""
    route = dict(train=train, generator=generator, kernels=kernels,
                 train_fusion=train_fusion)
    infer_imag = model.infer_image(params, spec, batch, **route)
    infer_text = model.infer_text(params, spec, batch, **route)
    scale = params["logit_scale"].exp()
    vl_scale = params["logit_vl_scale"].exp()
    loss_b, i2t, t2i, labels = _info_nce(
        infer_imag["cls_feats"], infer_text["cls_feats"], scale)
    loss_vl, vl_i2t, vl_t2i, _ = _info_nce(
        infer_imag["cls_vlffn_feats"], infer_text["cls_vlffn_feats"],
        vl_scale)
    n = infer_imag["cls_feats"].shape[0]
    return {
        "ifm_loss": (ifm_weight * loss_b + loss_vl) * 0.5,
        "ifm_i2t_logits": i2t, "ifm_t2i_logits": t2i,
        "ifm_i2t_correct": _rank_hits(i2t, labels), "ifm_i2t_count": n,
        "ifm_t2i_correct": _rank_hits(t2i, labels), "ifm_t2i_count": n,
        "ifm_vl_i2t_correct": _rank_hits(vl_i2t, labels),
        "ifm_vl_i2t_count": n,
        "ifm_vl_t2i_correct": _rank_hits(vl_t2i, labels),
        "ifm_vl_t2i_count": n,
        "ifm_logit_scale": scale, "ifm_logit_vl_scale": vl_scale,
    }


def compute_irtr(params: Params, spec: ModelSpec, batch: Dict, *,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 kernels: bool = True, train_fusion: str = "0") -> Dict:
    """irtr (objectives.py:372-443): ITC InfoNCE between the image and text
    towers' cls features, with the learned logit scale.  ``train_fusion``
    is the training fusion level of both towers' blocks."""
    route = dict(train=train, generator=generator, kernels=kernels,
                 train_fusion=train_fusion)
    infer_imag = model.infer_image_ft(params, spec, batch, **route)
    infer_text = model.infer_text_ft(params, spec, batch, **route)
    scale = params["logit_scale"].exp()
    loss, i2t, t2i, labels = _info_nce(
        infer_imag["cls_feats"], infer_text["cls_feats"], scale)
    n = infer_imag["cls_feats"].shape[0]
    return {
        "irtr_loss": loss,
        "irtr_i2t_correct": _rank_hits(i2t, labels), "irtr_i2t_count": n,
        "irtr_t2i_correct": _rank_hits(t2i, labels), "irtr_t2i_count": n,
        "irtr_logit_scale": scale,
    }


# --------------------------------------------------------------------------
# ITM with hard negatives (objectives.py:146-245)
# --------------------------------------------------------------------------

def sample_hard_negatives(sim_i2t: torch.Tensor, sim_t2i: torch.Tensor,
                          generator: Optional[torch.Generator]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hard negatives of each pair: for each text an image index drawn
    from the softmax of its row of ``sim_t2i``, for each image a text
    index from its row of ``sim_i2t``, the diagonal (the pair itself) at
    -inf (the reference's multinomial over softmax(sim) with a zeroed
    diagonal).  No gradient flows through the draw.  Returns (negative
    image per text, negative text per image), each (B,) long on the sims'
    device."""
    bsz = sim_i2t.shape[0]
    eye = torch.eye(bsz, dtype=torch.bool, device=sim_i2t.device)

    def draw(sim):
        probs = torch.softmax(sim.detach().float().masked_fill(
            eye, float("-inf")), dim=1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    neg_img = draw(sim_t2i)
    return neg_img, draw(sim_i2t)


def compute_itm_hardneg(params: Params, spec: ModelSpec, batch: Dict,
                        sim_i2t: torch.Tensor, sim_t2i: torch.Tensor, *,
                        train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        kernels: bool = True,
                        train_fusion: str = "0") -> Dict:
    """ITM: the fused pass over the positive pairs, over each text with
    its hard-negative image and over each image with its hard-negative
    text (``sample_hard_negatives`` on ifm's logits), the ITM head on the
    3B cls features against labels [1]·B + [0]·2B.  Without a generator
    (the eval and the gram pass) the negatives come from a generator
    seeded 0, as the JAX package's draw from PRNGKey(0).  Under a process
    group the sims are the global batch's: every rank makes the same
    global draw, keeps its rows' negatives and takes them from the
    gathered pool of every rank's images and texts."""
    bsz = batch["text_ids"].shape[0]
    if generator is None:
        generator = torch.Generator(sim_i2t.device).manual_seed(0)
    route = dict(train=train, generator=generator, kernels=kernels,
                 train_fusion=train_fusion)
    infer_pos = model.infer(params, spec, batch, **route)
    rows = host.process_rows(sim_i2t.shape[0])
    neg_img, neg_txt = (idx[rows] for idx in sample_hard_negatives(
        sim_i2t, sim_t2i, generator))
    pool = {k: host.all_gather_rows(batch[k])
            for k in ("image", "text_ids", "text_masks")}
    infer_img_neg = model.infer(params, spec,
                                dict(batch, image=pool["image"][neg_img]),
                                **route)
    infer_txt_neg = model.infer(params, spec, dict(
        batch, text_ids=pool["text_ids"][neg_txt],
        text_masks=pool["text_masks"][neg_txt]), **route)
    cls = torch.cat([infer_pos["cls_feats"], infer_img_neg["cls_feats"],
                     infer_txt_neg["cls_feats"]], dim=0)
    logits = model.itm_head(params, cls).float()
    labels = torch.cat([torch.ones(bsz, dtype=torch.long),
                        torch.zeros(2 * bsz, dtype=torch.long)]).to(
        logits.device)
    return {"itm_loss": _ce_dense(logits, labels),
            "itm_correct": _hits(logits, labels),
            "itm_count": labels.shape[0]}


# --------------------------------------------------------------------------
# Downstream heads (objectives.py:446-569)
# --------------------------------------------------------------------------

def compute_vqa(params: Params, spec: ModelSpec, batch: Dict, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                kernels: bool = True, train_fusion: str = "0") -> Dict:
    """VQA (objectives.py:446-489): BCE-with-logits × label_size against
    the dense soft targets ``vqa_targets`` (B, label_size), and the VQA
    score sum, the soft score of each argmax answer (gadgets/my_metrics.py
    VQAScore)."""
    out = model.infer(params, spec, batch, train=train, generator=generator,
                      kernels=kernels, train_fusion=train_fusion)
    logits = model.vqa_head(params, out["cls_feats"]).float()
    targets = batch["vqa_targets"].float()
    bce = logits.clamp_min(0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    score = targets.gather(1, logits.argmax(-1)[:, None]).sum()
    return {"vqa_loss": bce.mean() * targets.shape[1],
            "vqa_score_sum": score, "vqa_count": logits.shape[0],
            "vqa_logits": logits}


def compute_nlvr2(params: Params, spec: ModelSpec, batch: Dict, *,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  kernels: bool = True, train_fusion: str = "0") -> Dict:
    """NLVR2 (objectives.py:543-567): cross-entropy of the paired pass's
    logits (``evaluation/downstream.nlvr2_logits``) against ``answers``."""
    logits = nlvr2_logits(params, spec, batch, train=train,
                          generator=generator, kernels=kernels,
                          train_fusion=train_fusion)
    labels = batch["answers"].long()
    return {"nlvr2_loss": _ce_dense(logits, labels),
            "nlvr2_correct": _hits(logits, labels),
            "nlvr2_count": labels.shape[0], "nlvr2_logits": logits}


def compute_img_cls(params: Params, spec: ModelSpec, batch: Dict, *,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    kernels: bool = True, train_fusion: str = "0") -> Dict:
    """ImageNet classification (the JAX package's ``compute_img_cls``): the
    head over the image tower's mean token feature, cross-entropy against
    ``class_label``."""
    infer = model.infer_image_ft(params, spec, batch, train=train,
                                 generator=generator, kernels=kernels,
                                 train_fusion=train_fusion)
    logits = model.img_cls_head(params,
                                infer["image_feats"].mean(dim=1)).float()
    labels = batch["class_label"].long()
    return {"img_cls_loss": _ce_dense(logits, labels),
            "img_cls_correct": _hits(logits, labels),
            "img_cls_count": labels.shape[0]}
