"""Training objectives (port of ``vl_merging_tpu/train/objectives.py``:
the irtr fine-tune loss, and the VQA and NLVR2 objectives in eval mode).

The JAX package writes each loss over the global batch under ``jit`` and
lets XLA insert the cross-replica gathers; the port runs on one device, so
the batch it is given is the global batch.  A multi-device step will need
autograd-aware gathers of the contrastive features (ROADMAP item
"Trainer, CLI, data and distribution").

Gradient-scale parity note (as in the JAX package): the reference
backprops the full-batch contrastive loss only through local features and
DDP averages gradients, so its effective irtr gradient is
grad(L_full) / world_size; ``train_step.total_loss``'s ``dp_scale``
reproduces that factor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..evaluation.downstream import nlvr2_logits
from ..models import model
from ..models.spec import ModelSpec, Params


def _ce_dense(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain mean cross-entropy with integer labels (f32 logits)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def _info_nce(image_feats, text_feats,
              logit_scale) -> Tuple[torch.Tensor, ...]:
    """Symmetric InfoNCE over the batch; f32 logits."""
    logits_i2t = logit_scale * (image_feats @ text_feats.T).float()
    logits_t2i = logits_i2t.T
    labels = torch.arange(image_feats.shape[0], device=image_feats.device)
    loss = 0.5 * (_ce_dense(logits_i2t, labels)
                  + _ce_dense(logits_t2i, labels))
    return loss, logits_i2t, logits_t2i, labels


def compute_irtr(params: Params, spec: ModelSpec, batch: Dict, *,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 kernels: bool = True, train_fusion: str = "0") -> Dict:
    """irtr (objectives.py:372-443): ITC InfoNCE between the image and text
    towers' cls features, with the learned logit scale.  ``train_fusion``
    is the training fusion level of both towers' blocks."""
    infer_imag = model.infer_image_ft(params, spec, batch, train=train,
                                      generator=generator, kernels=kernels,
                                      train_fusion=train_fusion)
    infer_text = model.infer_text_ft(params, spec, batch, train=train,
                                     generator=generator, kernels=kernels,
                                     train_fusion=train_fusion)
    scale = params["logit_scale"].exp()
    loss, i2t, t2i, labels = _info_nce(
        infer_imag["cls_feats"], infer_text["cls_feats"], scale)
    n = labels.shape[0]
    return {
        "irtr_loss": loss,
        "irtr_i2t_correct": (i2t.argmax(-1) == labels).sum(),
        "irtr_i2t_count": n,
        "irtr_t2i_correct": (t2i.argmax(-1) == labels).sum(),
        "irtr_t2i_count": n,
        "irtr_logit_scale": scale,
    }


def compute_vqa(params: Params, spec: ModelSpec, batch: Dict, *,
                kernels: bool = True) -> Dict:
    """VQA (objectives.py:446-489), eval mode: BCE-with-logits × label_size
    against the dense soft targets ``vqa_targets`` (B, label_size), and
    the VQA score sum, the soft score of each argmax answer
    (gadgets/my_metrics.py VQAScore)."""
    out = model.infer(params, spec, batch, kernels=kernels)
    logits = model.vqa_head(params, out["cls_feats"]).float()
    targets = batch["vqa_targets"].float()
    bce = logits.clamp_min(0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    score = targets.gather(1, logits.argmax(-1)[:, None]).sum()
    return {"vqa_loss": bce.mean() * targets.shape[1],
            "vqa_score_sum": score, "vqa_count": logits.shape[0],
            "vqa_logits": logits}


def compute_nlvr2(params: Params, spec: ModelSpec, batch: Dict, *,
                  kernels: bool = True) -> Dict:
    """NLVR2 (objectives.py:543-567), eval mode: cross-entropy of the
    paired pass's logits (``evaluation/downstream.nlvr2_logits``) against
    ``answers``."""
    logits = nlvr2_logits(params, spec, batch, kernels=kernels)
    labels = batch["answers"].long()
    return {"nlvr2_loss": _ce_dense(logits, labels),
            "nlvr2_correct": (logits.argmax(-1) == labels).sum(),
            "nlvr2_count": labels.shape[0], "nlvr2_logits": logits}
