"""Image-text retrieval evaluation, ITC recall (port of
``vl_merging_tpu/evaluation/retrieval.py``).

Ranking is pure ITC cosine, as in the reference
(src/vilt/modules/objectives.py:572-710): both towers run over their
batches, the (images x texts) score matrix is formed in f32, and top-k
recall is taken both ways, all on the features' device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from ..models import model
from ..models.spec import ModelSpec, Params


@torch.no_grad()
def extract_features(params: Params, spec: ModelSpec, batches: Iterable[Dict],
                     kind: str, *, kernels: bool = True,
                     int8_gelu: str = "poly",
                     qk_int8: bool = False,
                     fusion: str = "tail") -> torch.Tensor:
    """Run one single-modality tower over ``batches``; returns the stacked
    ``cls_feats`` (N, hs).  The rel-pos bias is gathered once per call.
    ``int8_gelu`` and ``qk_int8`` reach the int8 eval blocks, ``fusion``
    the eval blocks' route (``mome._block_fast``); the JAX package reads
    them from ``VLM_TPU_I8_GELU``, ``VLM_TPU_I8_QK`` and its fusion gates
    (``VLM_TPU_FUSE_PROJ_MLP``, ``VLM_TPU_FUSE_LN_QKV_ATTN``,
    ``VLM_TPU_FUSE_EVAL_BLOCK``)."""
    if kind == "text":
        run, bias_kind = model.infer_text_ft, "text"
    elif kind == "image":
        run, bias_kind = model.infer_image_ft, "image"
    else:
        raise ValueError(kind)
    bias = None
    feats = []
    for b in batches:
        if bias is None:
            true_length = b["text_ids"].shape[1] if (
                kind == "text" and spec.max_vl_text_len is not None) else None
            bias = model.precompute_bias(params, spec, bias_kind, true_length)
        feats.append(run(params, spec, b, rel_bias=bias, kernels=kernels,
                         int8_gelu=int8_gelu, qk_int8=qk_int8,
                         fusion=fusion)["cls_feats"])
    return torch.cat(feats, dim=0)


def _itc_scores(img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    return img.float() @ txt.float().T


def _top_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of each row's k largest scores; ties go to the lower index,
    as jax.lax.top_k breaks them."""
    return torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]


def _hit_rate(hit: torch.Tensor) -> torch.Tensor:
    """The share of hits, rounded as the JAX package's ``jnp.mean`` (XLA
    multiplies the f32 sum by the f32 reciprocal of the count), so that
    equal hits give equal recall floats (10 of 12: 0.83333337, where
    sum / count gives 0.83333331)."""
    return hit.float().sum() * (1.0 / hit.numel())


def _topk_ids(scores: torch.Tensor, ids_rows: torch.Tensor,
              ids_cols: torch.Tensor, ks=(1, 5, 10)) -> Dict[str, torch.Tensor]:
    """For each k: hit rates in both directions.

    scores: (I, T) = image @ text.T; ids_rows: (I,) image ids;
    ids_cols: (T,) the image id each text belongs to."""
    out = {}
    # text retrieval (per image, rank texts)
    kmax_t = min(max(ks), scores.shape[1])
    cand_t = ids_cols[_top_indices(scores, kmax_t)]
    for k in ks:
        hit = (cand_t[:, :min(k, kmax_t)] == ids_rows[:, None]).any(dim=1)
        out[f"tr_r{k}"] = _hit_rate(hit)
    # image retrieval (per text, rank images)
    kmax_i = min(max(ks), scores.shape[0])
    cand_i = ids_rows[_top_indices(scores.T, kmax_i)]
    for k in ks:
        hit = (cand_i[:, :min(k, kmax_i)] == ids_cols[:, None]).any(dim=1)
        out[f"ir_r{k}"] = _hit_rate(hit)
    return out


def retrieval_recall(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                     iids: np.ndarray, tiids: np.ndarray) -> Dict[str, float]:
    """ITC-cosine recall@{1,5,10} both directions (objectives.py:684-710)."""
    dev = img_feats.device
    out = _topk_ids(_itc_scores(img_feats, txt_feats),
                    torch.as_tensor(np.asarray(iids), device=dev),
                    torch.as_tensor(np.asarray(tiids), device=dev))
    return {k: float(v) for k, v in out.items()}


def compute_irtr_recall(params: Params, spec: ModelSpec,
                        text_batches: List[Dict], image_batches: List[Dict],
                        tiids: np.ndarray, iids: np.ndarray, *,
                        itm_rerank_topk: int = 0,
                        kernels: bool = True, int8_gelu: str = "poly",
                        qk_int8: bool = False,
                        fusion: str = "tail") -> Dict[str, float]:
    """Full recall pipeline over preloaded batches.

    Batches may be padded past the true counts; features are sliced back
    to ``len(tiids)`` / ``len(iids)`` rows here."""
    if itm_rerank_topk:
        raise NotImplementedError(
            "ITM reranking needs the fused VL pass, not ported yet: "
            "ROADMAP A4")
    txt = extract_features(params, spec, text_batches, "text",
                           kernels=kernels, int8_gelu=int8_gelu,
                           qk_int8=qk_int8, fusion=fusion)[:len(tiids)]
    img = extract_features(params, spec, image_batches, "image",
                           kernels=kernels, int8_gelu=int8_gelu,
                           qk_int8=qk_int8, fusion=fusion)[:len(iids)]
    return retrieval_recall(img, txt, iids, tiids)
