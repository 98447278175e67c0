"""Metric accumulation and the checkpoint-selection scalar (port of
``vl_merging_tpu/evaluation/metrics.py``).

Replaces torchmetrics' Accuracy/Scalar/VQAScore (reference:
src/vilt/gadgets/my_metrics.py) and the epoch wrap-up (reference:
src/vilt/modules/vilt_utils.py:56-207).  The steps return sums and counts
over their batch, so accumulation is plain host-side adds.

``the_metric`` sums one value per active task: the VQA score, the NLVR2
TEST accuracy (a reference last-assignment quirk, vilt_utils.py:119-143),
irtr t2i accuracy, itm accuracy, ifm vl_t2i accuracy, generic accuracy
otherwise, plus ir_r1 + tr_r1 when retrieval recall is given.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

from ..parallel import host


class MetricAccumulator:
    """Accumulates scalar metric outputs across steps.

    Keys ending in _correct/_count/_score_sum are summed; *_loss and other
    scalars are averaged over updates (reference Scalar = running mean)."""

    def __init__(self):
        self.sums = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    def update(self, metrics: Dict[str, object]) -> None:
        for k, v in metrics.items():
            v = float(v)
            self.sums[k] += v
            if not k.endswith(("_correct", "_count", "_score_sum")):
                self.counts[k] += 1

    def accuracy(self, name: str) -> Optional[float]:
        num = self.sums.get(f"{name}_correct")
        den = self.sums.get(f"{name}_count")
        if num is None or not den:
            return None
        return num / den

    def mean(self, name: str) -> Optional[float]:
        if name not in self.sums or not self.counts.get(name):
            return None
        return self.sums[name] / self.counts[name]

    def cross_process_reduce(self, keys) -> None:
        """Sum the named host-side tallies across processes (the JAX
        package's reduction of tallies fed from each process's loader
        share, such as the NLVR2 split).  The steps' metrics are already
        the global batch's on every process (``train_step.
        reduce_metrics``) and must not be summed again.  Every process
        passes the same keys; an absent key counts as 0.  One process: a
        no-op."""
        if host.get_world_size() == 1:
            return
        summable = {k: self.sums.get(k, 0.0) for k in sorted(keys)}
        self.sums.update(host.reduce_dict(summable, average=False))

    def compute(self) -> Dict[str, float]:
        out = {}
        seen = set()
        for k in self.sums:
            if k.endswith("_correct"):
                base = k[: -len("_correct")]
                acc = self.accuracy(base)
                if acc is not None:
                    out[f"{base}_accuracy"] = acc
                seen.update({k, f"{base}_count"})
            elif k.endswith("_score_sum"):
                base = k[: -len("_score_sum")]
                den = self.sums.get(f"{base}_count")
                if den:
                    out[f"{base}_score"] = self.sums[k] / den
                seen.update({k, f"{base}_count"})
        for k in self.sums:
            if k in seen or k.endswith("_count"):
                continue
            out[k] = self.mean(k)
        return out

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()


def the_metric(loss_names: Dict[str, float], computed: Dict[str, float],
               recall: Optional[Dict[str, float]] = None) -> float:
    """Checkpoint-selection scalar (vilt_utils.py:56-207)."""
    total = 0.0
    if recall:
        total += recall.get("ir_r1", 0.0) + recall.get("tr_r1", 0.0)
    for name, weight in loss_names.items():
        if weight < 1:
            continue
        if name == "vqa":
            v = computed.get("vqa_score")
        elif name == "nlvr2":
            # reference quirk (vilt_utils.py:119-143): in the val phase the
            # value is reassigned to the TEST-split accuracy after the dev
            # one before ``the_metric += value``
            v = computed.get("test_nlvr2_accuracy",
                             computed.get("dev_nlvr2_accuracy",
                                          computed.get("nlvr2_accuracy")))
        elif name == "irtr":
            v = computed.get("irtr_t2i_accuracy")
        elif name == "ifm":
            v = computed.get("ifm_vl_t2i_accuracy")
        elif name in ("mppd", "mpfr"):
            v = None
        else:
            v = computed.get(f"{name}_accuracy")
        if v is not None:
            total += v
    return total
