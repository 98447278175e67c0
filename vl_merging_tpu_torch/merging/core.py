"""Checkpoint merging suite: interpolation, task-vector arithmetic, RegMean
(port of ``vl_merging_tpu/merging/core.py``, the same host arithmetic).

Pure functions on flat ``{name: np.ndarray}`` state dicts, operating over the
same per-layer key templates as the reference
(reference: src/vilt/modules/vilt_module.py:366-746).  Merging is a pytree
transform — no model, device, or framework state involved — so results are
bit-identical to the reference's torch CPU arithmetic for interpolation and
task vectors, and LAPACK-identical for RegMean's float64 solve.

Semantics per layer i (vilt_module.py:395-404, 555-567, 665-678):
  * below ``vlffn_start_layer_index`` the expert set is ["v","l"];
  * at/above it, ["v","l","vl"], optionally restricted by the active loss
    when ``only_activate_used_experts`` (irtr→["v","l"], vqa/nlvr2→["vl"]).
Non-block keys and LayerScale gammas pass through unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]

# [expert-key template, merged-key template]
# reference vilt_module.py:376-384 (identical lists at :543-551, :650-658)
LAYER_ORDERS = [
    ["transformer.blocks.{}.attn.{}.qkv.weight", "transformer.blocks.{}.attn.qkv.weight"],
    ["transformer.blocks.{}.attn.{}.proj.{}", "transformer.blocks.{}.attn.proj.{}"],
    ["transformer.blocks.{}.attn.{}.{}", "transformer.blocks.{}.attn.{}"],
    ["transformer.blocks.{}.mlp.{}.fc1.{}", "transformer.blocks.{}.mlp.fc1.{}"],
    ["transformer.blocks.{}.mlp.{}.fc2.{}", "transformer.blocks.{}.mlp.fc2.{}"],
    ["transformer.blocks.{}.norm1.{}.{}", "transformer.blocks.{}.norm1.{}"],
    ["transformer.blocks.{}.norm2.{}.{}", "transformer.blocks.{}.norm2.{}"],
]


def modalities_for_layer(
    i: int,
    vlffn_start_layer_index: int,
    loss_names: Dict[str, float],
    only_activate_used_experts: bool = False,
) -> List[str]:
    if i < vlffn_start_layer_index:
        return ["v", "l"]
    if only_activate_used_experts:
        if loss_names.get("irtr", 0) > 0:
            return ["v", "l"]
        if loss_names.get("vqa", 0) > 0:
            return ["vl"]
        if loss_names.get("nlvr2", 0) > 0:
            return ["vl"]
    return ["v", "l", "vl"]


def _passthrough(state_dict: StateDict) -> StateDict:
    """Keys outside transformer blocks + LayerScale gammas
    (vilt_module.py:370-374)."""
    return {k: v for k, v in state_dict.items()
            if "transformer.blocks." not in k or "gamma" in k}


def _param_names(template_pair, i):
    """Yield (expert_name_fn, merged_name) pairs for one template at layer i."""
    expert_t, merged_t = template_pair
    if "qkv" in expert_t:
        yield (lambda m: expert_t.format(i, m)), merged_t.format(i)
    elif "attn" in expert_t and "proj" not in expert_t:
        for n in ("q_bias", "v_bias"):
            yield (lambda m, n=n: expert_t.format(i, m, n)), merged_t.format(i, n)
    else:
        for n in ("weight", "bias"):
            yield (lambda m, n=n: expert_t.format(i, m, n)), merged_t.format(i, n)


def merge_weights(
    state_dict: StateDict,
    *,
    num_layers: int,
    vlffn_start_layer_index: int,
    loss_names: Dict[str, float],
    merge_ratio: float = 0.5,
    only_activate_used_experts: bool = False,
) -> StateDict:
    """Interpolation merging (vilt_module.py:533-638).

    2 experts: w = r·w_v + (1−r)·w_l; 3 experts: (2/3)r·w_v + (2/3)(1−r)·w_l
    + (1/3)·w_vl; 1 expert: copy.  Falls back to the existing merged weight
    when an expert key is absent.
    """
    new = _passthrough(state_dict)
    for i in range(num_layers):
        mods = modalities_for_layer(i, vlffn_start_layer_index, loss_names,
                                    only_activate_used_experts)
        if len(mods) == 1:
            ratios = {mods[0]: 1}
        elif len(mods) == 3:
            ratios = {"v": (2 / 3) * merge_ratio,
                      "l": (2 / 3) * (1 - merge_ratio),
                      "vl": 1 / 3}
        else:
            ratios = {"v": merge_ratio, "l": 1 - merge_ratio}

        for pair in LAYER_ORDERS:
            for name_fn, merged_name in _param_names(pair, i):
                acc = 0
                for m in mods:
                    name = name_fn(m)
                    if name in state_dict:
                        acc = acc + ratios[m] * state_dict[name]
                    else:
                        acc = state_dict[merged_name]
                        break
                new[merged_name] = acc
    return new


def sum_task_vectors(
    state_dict: StateDict,
    central_weight: StateDict,
    *,
    num_layers: int,
    vlffn_start_layer_index: int,
    loss_names: Dict[str, float],
    sum_lambda: float = 1.0,
    only_activate_used_experts: bool = False,
) -> StateDict:
    """Modality arithmetic around a separately loaded central checkpoint
    (vilt_module.py:640-746).

    The reference aliases the central tensor (`later_weight =
    central_weight[later_name]`) and updates it **in place**, so each
    modality's task vector is taken against the already-updated value — a
    sequential lerp, not a sum:

        t ← t + λ·(w_m − t)   for each modality m, starting from t = w_central

    (with λ=1 this collapses to the *last* expert's weights).  Replicated
    exactly; verified bit-identical against the executed reference code in
    tests/test_reference_parity.py.
    """
    new = _passthrough(state_dict)
    for i in range(num_layers):
        mods = modalities_for_layer(i, vlffn_start_layer_index, loss_names,
                                    only_activate_used_experts)
        if len(mods) == 1:
            ratios = {mods[0]: 1}
        else:
            ratios = {m: sum_lambda for m in mods}

        for pair in LAYER_ORDERS:
            for name_fn, merged_name in _param_names(pair, i):
                acc = central_weight[merged_name].copy()
                for m in mods:
                    name = name_fn(m)
                    if name in state_dict:
                        acc = acc + ratios[m] * (state_dict[name] - acc)
                    else:
                        acc = state_dict[merged_name]
                        break
                new[merged_name] = acc
    return new


def scale_gram(G: np.ndarray, scaling_for_non_diag: float) -> np.ndarray:
    """Dampen off-diagonal gram entries (vilt_module.py:388-392)."""
    diag = np.diag(np.diag(G))
    return scaling_for_non_diag * G + (1 - scaling_for_non_diag) * diag


class _TorchLinalg:
    """float64 matmul/inverse through torch CPU.

    The reference computes RegMean with torch CPU LAPACK/BLAS; numpy's
    OpenBLAS produces ulp-level differences in dgemm/getri, which breaks the
    bit-identical-merged-checkpoint contract.  The JAX package falls back
    to numpy when torch is missing; the port always has torch."""

    @staticmethod
    def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (torch.from_numpy(np.ascontiguousarray(a))
                @ torch.from_numpy(np.ascontiguousarray(b))).numpy()

    @staticmethod
    def inv(a: np.ndarray) -> np.ndarray:
        return torch.inverse(
            torch.from_numpy(np.ascontiguousarray(a))).numpy()


def regmean(
    state_dict: StateDict,
    gram_matrices: Dict[str, np.ndarray],
    *,
    num_layers: int,
    vlffn_start_layer_index: int,
    loss_names: Dict[str, float],
    scaling_for_non_diag: float = 1.0,
) -> StateDict:
    """RegMean merging (vilt_module.py:366-531).

    Matmul weights: w = (Σ_t w_t G_t)(Σ_t G_t)^{-1} in float64, where G_t is
    the cached input gram of expert t; biases and LayerNorm parameters are
    simple-averaged.  Note the reference's expert-set rule here hard-codes
    the only_activate_used_experts behavior for irtr/vqa (vilt_module.py:
    397-404) — replicated exactly.
    """
    new = _passthrough(state_dict)
    la = _TorchLinalg

    def layer_mods(i):
        if i < vlffn_start_layer_index:
            return ["v", "l"]
        if loss_names.get("irtr", 0) > 0:
            return ["v", "l"]
        if loss_names.get("vqa", 0) > 0:
            return ["vl"]
        return ["v", "l", "vl"]

    def gram_merge(i, mods, expert_t, merged_name, gram_suffix):
        # Mirrors the reference control flow exactly, including its quirk:
        # an expert key missing AFTER a partial gram accumulation leaves
        # summed_gram non-empty, so the fallback merged weight still gets
        # multiplied by inv(partial gram).  (In the reference that
        # mixed-dtype matmul raises; here the fallback is cast to f64 — the
        # only reachable divergence, and one the reference cannot execute.)
        summed_gram: Optional[np.ndarray] = None
        acc = 0
        for m in mods:
            name = (expert_t.format(i, m) if gram_suffix == ".qkv.weight"
                    else expert_t.format(i, m, "weight"))
            gram_name = name.replace(gram_suffix, "")
            if name in state_dict:
                if gram_name not in gram_matrices:
                    continue
                G = scale_gram(
                    np.asarray(gram_matrices[gram_name], np.float64),
                    scaling_for_non_diag)
                summed_gram = G if summed_gram is None else summed_gram + G
                acc = acc + la.matmul(state_dict[name].astype(np.float64), G)
            else:
                acc = state_dict[merged_name]
                break
        if summed_gram is None:
            new[merged_name] = acc
        else:
            new[merged_name] = la.matmul(
                np.asarray(acc, np.float64), la.inv(summed_gram))

    def avg_merge(i, mods, expert_t, merged_name, n):
        # Reference quirk kept: on a missing expert key the loop breaks with
        # the fallback weight but does NOT reset the count, so the fallback
        # is divided by however many experts were summed before the break
        # (vilt_module.py:441-457 — `num_valid_modality` survives the break).
        acc = 0
        count = 0
        for m in mods:
            name = expert_t.format(i, m, n)
            if name in state_dict:
                acc = acc + state_dict[name]
                count += 1
            else:
                acc = state_dict[merged_name]
                break
        new[merged_name] = acc if count == 0 else acc / count

    for i in range(num_layers):
        mods = layer_mods(i)
        for pair in LAYER_ORDERS:
            expert_t, merged_t = pair
            if "qkv" in expert_t:
                gram_merge(i, mods, expert_t, merged_t.format(i), ".qkv.weight")
            elif "attn" in expert_t and "proj" not in expert_t:
                for n in ("q_bias", "v_bias"):
                    avg_merge(i, mods, expert_t, merged_t.format(i, n), n)
            elif "mlp" in expert_t or "proj" in expert_t:
                gram_merge(i, mods, expert_t, merged_t.format(i, "weight"),
                           ".weight")
                avg_merge(i, mods, expert_t, merged_t.format(i, "bias"), "bias")
            else:  # norms
                for n in ("weight", "bias"):
                    avg_merge(i, mods, expert_t, merged_t.format(i, n), n)
    return new
