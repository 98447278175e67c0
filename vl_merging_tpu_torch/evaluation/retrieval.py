"""Image-text retrieval evaluation, ITC recall (port of
``vl_merging_tpu/evaluation/retrieval.py``).

Ranking is pure ITC cosine, as in the reference
(src/vilt/modules/objectives.py:572-710): both towers run over their
batches, the (images x texts) score matrix is formed in f32, and top-k
recall is taken both ways, all on the features' device.  An opt-in ITM
rerank (``itm_rerank_topk``) rescores each query's top-k ITC candidates
with the ITM head over the fused VL pass (``model.infer``).

Over a process group each batch a rank passes is its row share of a
global batch (``parallel.process_rows``): the towers run on the shares,
their features are gathered in rank order (each global batch's rows in
their order), and every rank forms the same score matrix and recall.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..models import model
from ..models.mome import LayerBias
from ..models.spec import ModelSpec, Params
from ..parallel import host


@torch.no_grad()
def extract_features(params: Params, spec: ModelSpec, batches: Iterable[Dict],
                     kind: str, *, kernels: bool = True,
                     int8_gelu: str = "poly",
                     qk_int8: bool = False,
                     fusion: str = "tail") -> torch.Tensor:
    """Run one single-modality tower over ``batches``; returns the stacked
    ``cls_feats`` (N, hs), over a process group every rank's rows of each
    batch in rank order.  The rel-pos bias is gathered once per call.
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
        feats.append(host.all_gather_rows(run(
            params, spec, b, rel_bias=bias, kernels=kernels,
            int8_gelu=int8_gelu, qk_int8=qk_int8,
            fusion=fusion)["cls_feats"]))
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


@torch.no_grad()
def itm_rerank_scores(params: Params, spec: ModelSpec,
                      text_ids: torch.Tensor, text_masks: torch.Tensor,
                      images: torch.Tensor, itc_scores: torch.Tensor,
                      topk: int, *, axis: int, pair_batch: int = 64,
                      rel_bias: Optional[Sequence[LayerBias]] = None,
                      kernels: bool = True, int8_gelu: str = "poly",
                      qk_int8: bool = False,
                      fusion: str = "tail") -> torch.Tensor:
    """Rescore the top-k ITC candidates with the ITM head
    (``vl_merging_tpu/evaluation/retrieval.py:itm_rerank_scores``).

    axis=1: per image, rerank its top-k texts (text retrieval); axis=0:
    per text, rerank its top-k images (image retrieval).  Returns the
    scores with each query's candidates at 1e4·(ITM log-probability of a
    match), every other entry at its ITC score − 1e8, so reranked
    candidates strictly dominate.  Candidates are the top k with ties to
    the lower index (``_top_indices``, as ``jax.lax.top_k``); the queries
    are padded to whole chunks of ``max(1, pair_batch // topk)`` (the pad
    reranks query 0's first candidate and is dropped); each chunk is one
    fused pass over chunk·topk pairs (the JAX package's ``lax.scan``
    step).  ``rel_bias``: ``model.fused_layer_biases`` for the texts'
    length, gathered here when None; the routing arguments reach every
    block."""
    qsc = itc_scores.float()
    if axis == 0:
        qsc = qsc.T
    elif axis != 1:
        raise ValueError(f"axis {axis}")
    chunk = max(1, pair_batch // topk)
    cand = _top_indices(qsc, topk)                            # (Q, k)
    n_query = qsc.shape[0]
    pad = (-n_query) % chunk
    dev = cand.device
    cand_p = torch.cat([cand, cand.new_zeros((pad, topk))])
    qids = torch.cat([torch.arange(n_query, device=dev),
                      torch.zeros(pad, dtype=torch.long, device=dev)])
    if rel_bias is None:
        rel_bias = model.fused_layer_biases(params, spec, text_ids.shape[1])
    s = []
    for q_idx, flat in zip(qids.split(chunk), cand_p.split(chunk)):
        flat = flat.reshape(-1)                               # (chunk·k,)
        if axis == 1:                                         # texts
            ti, tm = text_ids[flat], text_masks[flat]
            im = images[q_idx].repeat_interleave(topk, dim=0)
        else:                                                 # images
            ti = text_ids[q_idx].repeat_interleave(topk, dim=0)
            tm = text_masks[q_idx].repeat_interleave(topk, dim=0)
            im = images[flat]
        out = model.infer(params, spec, {"text_ids": ti, "text_masks": tm},
                          image=im, rel_bias=rel_bias, kernels=kernels,
                          int8_gelu=int8_gelu, qk_int8=qk_int8,
                          fusion=fusion)
        logits = model.itm_head(params, out["cls_feats"])
        s.append(torch.log_softmax(logits.float(), dim=-1)[:, 1])
    s = torch.cat(s).reshape(-1, topk)[:n_query]              # (Q, k)
    new = torch.full_like(qsc, float("-inf"))
    new[torch.arange(n_query, device=dev)[:, None], cand] = 1e4 * s
    new = torch.where(torch.isfinite(new), new, qsc - 1e8)
    return new if axis == 1 else new.T


def compute_irtr_recall(params: Params, spec: ModelSpec,
                        text_batches: List[Dict], image_batches: List[Dict],
                        tiids: np.ndarray, iids: np.ndarray, *,
                        itm_rerank_topk: int = 0,
                        kernels: bool = True, int8_gelu: str = "poly",
                        qk_int8: bool = False,
                        fusion: str = "tail") -> Dict[str, float]:
    """Full recall pipeline over preloaded batches.

    ``itm_rerank_topk > 0`` reranks each direction's top-k ITC candidates
    with the ITM head (``itm_rerank_scores``; the fused pass's bias is
    gathered once for both directions); 0 keeps the reference's pure ITC
    ranking.  Batches may be padded past the true counts; features are
    sliced back to ``len(tiids)`` / ``len(iids)`` rows here."""
    n_txt, n_img = len(tiids), len(iids)
    route = dict(kernels=kernels, int8_gelu=int8_gelu, qk_int8=qk_int8,
                 fusion=fusion)
    txt = extract_features(params, spec, text_batches, "text",
                           **route)[:n_txt]
    img = extract_features(params, spec, image_batches, "image",
                           **route)[:n_img]
    if not itm_rerank_topk:
        return retrieval_recall(img, txt, iids, tiids)
    scores = _itc_scores(img, txt)

    def rows(batches, key, n):
        return torch.cat([host.all_gather_rows(b[key]) for b in batches])[:n]

    # every rank reranks every query, over the gathered inputs
    text_ids = rows(text_batches, "text_ids", n_txt)
    text_masks = rows(text_batches, "text_masks", n_txt)
    images = rows(image_batches, "image", n_img)
    bias = model.fused_layer_biases(params, spec, text_ids.shape[1])
    dev = scores.device
    ids_i = torch.as_tensor(np.asarray(iids), device=dev)
    ids_t = torch.as_tensor(np.asarray(tiids), device=dev)
    out = {}
    for axis, prefix in ((1, "tr"), (0, "ir")):
        reranked = itm_rerank_scores(
            params, spec, text_ids, text_masks, images, scores,
            itm_rerank_topk, axis=axis, rel_bias=bias, **route)
        hits = _topk_ids(reranked, ids_i, ids_t)
        out.update({k: float(v) for k, v in hits.items()
                    if k.startswith(prefix)})
    return {f"{d}_r{k}": out[f"{d}_r{k}"] for k in (1, 5, 10)
            for d in ("tr", "ir")}
