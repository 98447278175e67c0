"""Downstream eval: VQA answers and submission, the NLVR2 paired pass and
its dev/test split (port of ``vl_merging_tpu/evaluation/downstream.py``).

reference: src/vilt/modules/objectives.py:724-769 (the VQA submission)
and :543-567 (the NLVR2 table_name split).  Both run the fused VL pass
(``model.infer``) on the card unless the caller's tensors lie on the CPU,
with the routing arguments (``kernels``, ``fusion``, ``int8_gelu``,
``qk_int8``) carried to every block.  The rel-pos bias of the fused pass
is gathered once per call (``model.fused_layer_biases``).

Over a process group each rank predicts its loader share's questions;
the submission is one json, merged by rank 0 from the ranks' files in the
shared output directory after a barrier (the reference's per-rank json,
barrier and rank-0 glob, objectives.py:742-769).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from ..models import model
from ..models.spec import ModelSpec, Params
from ..parallel import host


class _Biases:
    """The fused pass's per-layer biases, gathered once per text length."""

    def __init__(self, params: Params, spec: ModelSpec):
        self.params, self.spec, self.by_len = params, spec, {}

    def __call__(self, text_len: int):
        if text_len not in self.by_len:
            self.by_len[text_len] = model.fused_layer_biases(
                self.params, self.spec, text_len)
        return self.by_len[text_len]


def vqa_logits(params: Params, spec: ModelSpec, batch: Dict, *,
               rel_bias=None, kernels: bool = True, int8_gelu: str = "poly",
               qk_int8: bool = False, fusion: str = "tail") -> torch.Tensor:
    """The VQA head over the fused pass's cls features (B, label_size)."""
    out = model.infer(params, spec, batch, rel_bias=rel_bias,
                      kernels=kernels, int8_gelu=int8_gelu, qk_int8=qk_int8,
                      fusion=fusion)
    return model.vqa_head(params, out["cls_feats"])


def _json_id(qid):
    if isinstance(qid, (np.integer, np.floating)) or (
            isinstance(qid, torch.Tensor) and qid.ndim == 0):
        return qid.item()  # json-serializable
    return qid


@torch.no_grad()
def vqa_predictions(params: Params, spec: ModelSpec, batches: Iterable[Dict],
                    id2answer: Dict[int, str], scan_k: int = 1, *,
                    kernels: bool = True, int8_gelu: str = "poly",
                    qk_int8: bool = False,
                    fusion: str = "tail") -> List[Dict]:
    """Per-question {"question_id", "answer"} records, the answer the
    argmax of the VQA logits (objectives.py:724-735).

    ``scan_k`` > 1 groups ``scan_k`` consecutive feeds of one signature
    (keys, shapes, dtypes) and fetches their answers to the host once per
    group; a group cut short by a change of signature or the end of the
    batches is fetched batch by batch.  The JAX package runs a group as
    one ``lax.scan`` dispatch; here it is a loop over the group, and every
    ``scan_k`` gives the same records.  A feed is a batch's
    ``text_ids``, ``text_masks`` and ``image``; ``qid`` holds its question
    ids.  Over a process group each rank passes its own share of the
    questions and gets their records (``write_vqa_submission`` merges
    them)."""
    route = dict(kernels=kernels, int8_gelu=int8_gelu, qk_int8=qk_int8,
                 fusion=fusion)
    biases = _Biases(params, spec)
    rets: List[Dict] = []

    def preds_of(feed):
        return vqa_logits(params, spec, feed,
                          rel_bias=biases(feed["text_ids"].shape[1]),
                          **route).argmax(dim=-1)

    def emit(qids, preds):
        for qid, pred in zip(qids, preds.tolist()):
            # .get: a partial vocab (fixtures) may miss ids
            rets.append({"question_id": _json_id(qid),
                         "answer": id2answer.get(int(pred), "")})

    def flush(buf):
        if scan_k > 1 and len(buf) == scan_k:
            preds = torch.stack([preds_of(f) for f, _ in buf]).cpu()
            for (_, qids), p in zip(buf, preds):
                emit(qids, p)
        else:
            for feed, qids in buf:
                emit(qids, preds_of(feed).cpu())
        buf.clear()

    def sig(feed):
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feed.items()))

    buf: List = []
    for b in batches:
        feed = {k: v for k, v in b.items()
                if k in ("text_ids", "text_masks", "image")}
        if buf and sig(feed) != sig(buf[0][0]):
            flush(buf)              # shape change (loader tail): per-batch
        buf.append((feed, b["qid"]))
        if len(buf) == max(scan_k, 1):
            flush(buf)
    if buf:
        flush(buf)
    return rets


def write_vqa_submission(rets: List[Dict], model_name: str,
                         output_dir: str) -> str:
    """Write the submission json, ``{output_dir}/vqa_submit_{model_name}
    .json`` (objectives.py:742-769), and return its path.  Over a process
    group every rank writes its records to a per-rank json in the shared
    ``output_dir``, a barrier orders the writes, and rank 0 merges them in
    rank order into the one submission, each question once (the sampler
    wrap-pads the last global batch with questions from the start), and
    removes them; the other ranks return ""."""
    os.makedirs(output_dir, exist_ok=True)
    world = host.get_world_size()
    if world > 1:
        def rank_path(r):
            return os.path.join(output_dir,
                                f"vqa_submit_{model_name}_rank{r}.json")

        with open(rank_path(host.get_rank()), "w") as fp:
            json.dump(rets, fp)
        host.synchronize()
        if not host.is_main_process():
            return ""
        merged = {}
        for r in range(world):
            with open(rank_path(r)) as fp:
                for rec in json.load(fp):
                    merged.setdefault(rec["question_id"], rec)
            os.remove(rank_path(r))
        rets = list(merged.values())
    path = os.path.join(output_dir, f"vqa_submit_{model_name}.json")
    with open(path, "w") as fp:
        json.dump(rets, fp, indent=4)
    return path


def nlvr2_logits(params: Params, spec: ModelSpec, batch: Dict, *,
                 rel_bias=None, kernels: bool = True,
                 int8_gelu: str = "poly", qk_int8: bool = False,
                 fusion: str = "tail", train: bool = False,
                 generator=None, train_fusion: str = "0") -> torch.Tensor:
    """The NLVR2 paired pass (JAX ``train/objectives.compute_nlvr2``,
    ``bench.py:run_nlvr2``): the fused pass over the caption with the
    first image (``image_0``, token type 1) and with the second
    (``image_1``, token type 2), their cls features concatenated, the
    NLVR2 head; (B, 2) f32 logits.  ``train``, ``generator`` and
    ``train_fusion`` make it the fine-tune's training forward (each pass
    draws its own dropout and stochastic depth)."""
    route = dict(rel_bias=rel_bias, kernels=kernels, int8_gelu=int8_gelu,
                 qk_int8=qk_int8, fusion=fusion, train=train,
                 generator=generator, train_fusion=train_fusion)
    i1 = model.infer(params, spec, batch, image_token_type_idx=1, **route)
    i2 = model.infer(params, spec, batch, image_token_type_idx=2, **route)
    cls = torch.cat([i1["cls_feats"], i2["cls_feats"]], dim=-1)
    return model.nlvr2_head(params, cls).float()


@torch.no_grad()
def nlvr2_predictions(params: Params, spec: ModelSpec,
                      batches: Iterable[Dict], *, kernels: bool = True,
                      int8_gelu: str = "poly", qk_int8: bool = False,
                      fusion: str = "tail") -> torch.Tensor:
    """The NLVR2 answer (argmax of ``nlvr2_logits``) of every pair of
    ``batches``, in order, on the batches' device."""
    biases = _Biases(params, spec)
    return torch.cat([nlvr2_logits(
        params, spec, b, rel_bias=biases(b["text_ids"].shape[1]),
        kernels=kernels, int8_gelu=int8_gelu, qk_int8=qk_int8,
        fusion=fusion).argmax(dim=-1) for b in batches])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def nlvr2_split_update(accumulator, logits, labels,
                       table_names: Sequence[str]) -> None:
    """Split per-sample accuracy into dev/test by table_name
    (objectives.py:543-567); zero-count updates keep the key set the same
    in every split."""
    correct = np.argmax(_host(logits), -1) == _host(labels)
    for split in ("dev", "test"):
        idx = [i for i, n in enumerate(table_names) if split in n]
        accumulator.update({
            f"{split}_nlvr2_correct": float(correct[idx].sum()) if idx
            else 0.0,
            f"{split}_nlvr2_count": float(len(idx)),
        })
