"""Training objectives (port of ``vl_merging_tpu/train/objectives.py``,
the irtr fine-tune loss).

The JAX package writes each loss over the global batch under ``jit`` and
lets XLA insert the cross-replica gathers; the port runs on one device, so
the batch it is given is the global batch.  A multi-device step will need
autograd-aware gathers of the contrastive features (ROADMAP A7).

Gradient-scale parity note (as in the JAX package): the reference
backprops the full-batch contrastive loss only through local features and
DDP averages gradients, so its effective irtr gradient is
grad(L_full) / world_size; ``train_step.total_loss``'s ``dp_scale``
reproduces that factor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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
