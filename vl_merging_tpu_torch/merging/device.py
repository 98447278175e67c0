"""Merging on the card: the interpolation, task-vector and RegMean
transforms over a FLEET of checkpoints held in device memory (port of
``vl_merging_tpu/merging/device.py``).

The host path (``merging/core.py``) stays the contract surface: its NumPy
and torch-CPU arithmetic is bit-identical to the reference, and
``merge.py`` uses it.  This module is the fast path for sweeps: K
checkpoints × R ratios merged by torch ops on the card with every
intermediate resident there.  The math is the same elementwise lerp per
key; ratios are f32 on the card where the host rounds its f64 Python
ratios once, so each member matches the host path within 4 f32 ulp at
operand scale (``tests/test_torch_port_merging.py``).

Layout: a fleet is a flat ``{name: torch.Tensor}`` dict whose leaves carry
a leading fleet axis (K, *param_shape), built by ``stack_checkpoints``.
The transforms are elementwise, so broadcasting over the leading axis is
the vmap; ``merge_ratio`` / ``sum_lambda`` may be a scalar or a (K,)
vector (one value per fleet member), which is how a ratio sweep of one
checkpoint runs.

Every division here divides by a tensor: PyTorch's CUDA kernels divide by
a Python scalar as a multiply by its f32 reciprocal, which is not the
IEEE quotient the host path takes (faults C9 and C10 of the int8 path).

The JAX package computes all of this outside any Pallas kernel, so the
port runs library ops (``torch.linalg.solve`` for RegMean).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import require_cuda
from .core import LAYER_ORDERS, _param_names, _passthrough, \
    modalities_for_layer

Fleet = Dict[str, torch.Tensor]


def _device(device) -> torch.device:
    """``device`` as given, else the card (``require_cuda``, which also
    turns TF32 off, so every f32 product here is a full f32 product)."""
    return require_cuda() if device is None else torch.device(device)


def stack_checkpoints(state_dicts: Sequence[Dict[str, np.ndarray]],
                      device=None) -> Fleet:
    """Stack K same-keyed checkpoints into one fleet on ``device`` (the
    card unless given): one host stack and one copy per key."""
    dev = _device(device)
    keys = state_dicts[0].keys()
    for sd in state_dicts[1:]:
        if sd.keys() != keys:
            missing = set(keys) ^ set(sd.keys())
            raise ValueError(f"fleet checkpoints disagree on keys: {missing}")
    return {k: torch.from_numpy(np.stack([np.asarray(sd[k])
                                          for sd in state_dicts])).to(dev)
            for k in keys}


def _ratio(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A 0-d or (K,) f32 ratio broadcast against (K, ...) in x's dtype."""
    if r.ndim == 0:
        return r.to(x.dtype)
    return r.reshape(r.shape + (1,) * (x.ndim - 1)).to(x.dtype)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32), device=like.device)


def _merge_tree(state: Fleet, central: Optional[Fleet], merge_ratio,
                sum_lambda, *, kind: str, num_layers: int,
                vlffn_start_layer_index: int, loss_names: Dict[str, float],
                only_activate_used_experts: bool) -> Fleet:
    """The body of both transforms: the host path's control flow (key
    presence decides the fallback, as in ``core.merge_weights`` /
    ``core.sum_task_vectors``), f32 ratio arithmetic on the card."""
    any_leaf = next(iter(state.values()))
    one = _f32(1.0, any_leaf)
    if kind == "interp":
        r = _f32(merge_ratio, any_leaf)
        # (2/3)·r as f32(2/3) · r: the constants rounded on the host once,
        # as the JAX device path rounds them, no division on the card
        two_thirds = _f32(2 / 3, any_leaf)
        interp = {1: None,
                  2: {"v": r, "l": one - r},
                  3: {"v": two_thirds * r, "l": two_thirds * (one - r),
                      "vl": _f32(1 / 3, any_leaf)}}
    else:
        lam = _f32(sum_lambda, any_leaf)
    new = _passthrough(state)
    for i in range(num_layers):
        mods = modalities_for_layer(i, vlffn_start_layer_index, loss_names,
                                    only_activate_used_experts)
        for pair in LAYER_ORDERS:
            for name_fn, merged_name in _param_names(pair, i):
                if any(name_fn(m) not in state for m in mods):
                    # reference fallback: keep the existing merged weight
                    new[merged_name] = state[merged_name]
                    continue
                if kind == "interp":
                    ratios = interp[len(mods)] or {mods[0]: one}
                    acc = None
                    for m in mods:
                        w = state[name_fn(m)]
                        term = _ratio(w, ratios[m]) * w
                        acc = term if acc is None else acc + term
                else:  # task-vector sequential lerp (core.sum_task_vectors)
                    step = one if len(mods) == 1 else lam
                    acc = central[merged_name]
                    for m in mods:
                        w = state[name_fn(m)]
                        acc = acc + _ratio(w, step) * (w - acc)
                new[merged_name] = acc
    return new


@torch.no_grad()
def merge_weights_device(state: Fleet, *, num_layers: int,
                         vlffn_start_layer_index: int,
                         loss_names: Dict[str, float],
                         merge_ratio=0.5,
                         only_activate_used_experts: bool = False) -> Fleet:
    """Interpolation merging on the fleet's device
    (``core.merge_weights`` semantics); ``merge_ratio`` a scalar or a (K,)
    vector for a per-member ratio sweep."""
    return _merge_tree(state, None, merge_ratio, None, kind="interp",
                       num_layers=num_layers,
                       vlffn_start_layer_index=vlffn_start_layer_index,
                       loss_names=loss_names,
                       only_activate_used_experts=only_activate_used_experts)


@torch.no_grad()
def sum_task_vectors_device(state: Fleet, central: Fleet, *, num_layers: int,
                            vlffn_start_layer_index: int,
                            loss_names: Dict[str, float],
                            sum_lambda=1.0,
                            only_activate_used_experts: bool = False
                            ) -> Fleet:
    """Task-vector merging on the fleet's device (``core.sum_task_vectors``
    semantics: the reference's sequential in-place lerp, not a sum)."""
    return _merge_tree(state, central, None, sum_lambda, kind="task_vector",
                       num_layers=num_layers,
                       vlffn_start_layer_index=vlffn_start_layer_index,
                       loss_names=loss_names,
                       only_activate_used_experts=only_activate_used_experts)


def ratio_sweep(state_dict: Dict[str, np.ndarray], ratios: Sequence[float],
                *, device=None, **kw) -> Fleet:
    """Sweep merge_ratio over one checkpoint at once: the checkpoint copied
    to the device once and broadcast to an (R, ...) fleet (a view, as the
    JAX package's tiled copies are equal), the ratios as the (R,)
    vector."""
    fleet = {k: v.expand(len(ratios), *v.shape[1:])
             for k, v in stack_checkpoints([state_dict], device).items()}
    return merge_weights_device(
        fleet, merge_ratio=np.asarray(list(ratios), np.float32), **kw)


def _regmean_tree(state: Fleet, grams: Fleet, *, num_layers: int,
                  vlffn_start_layer_index: int, loss_names: Dict[str, float],
                  scaling_for_non_diag: float) -> Fleet:
    """RegMean's control flow exactly as ``core.regmean`` (its hard-coded
    expert set, the partial-gram and missing-key fallbacks, the count that
    survives the break); f32 ``solve`` where the host takes the f64
    inverse."""
    new = _passthrough(state)

    def layer_mods(i):
        if i < vlffn_start_layer_index:
            return ["v", "l"]
        if loss_names.get("irtr", 0) > 0:
            return ["v", "l"]
        if loss_names.get("vqa", 0) > 0:
            return ["vl"]
        return ["v", "l", "vl"]

    def scale_g(G):
        G = G.float()
        diag = torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))
        return scaling_for_non_diag * G + (1 - scaling_for_non_diag) * diag

    def gram_merge(i, mods, expert_t, merged_name, gram_suffix):
        summed_gram = None
        acc = None
        for m in mods:
            name = (expert_t.format(i, m) if gram_suffix == ".qkv.weight"
                    else expert_t.format(i, m, "weight"))
            gram_name = name.replace(gram_suffix, "")
            if name in state:
                if gram_name not in grams:
                    continue
                G = scale_g(grams[gram_name])
                summed_gram = G if summed_gram is None else summed_gram + G
                term = torch.matmul(state[name].float(), G)
                acc = term if acc is None else acc + term
            else:
                acc = state[merged_name]
                break
        if summed_gram is None:
            new[merged_name] = acc
        else:
            # w = acc @ inv(ΣG), solved as ΣGᵀ wᵀ = accᵀ (f32, batched)
            sol = torch.linalg.solve(summed_gram.mT, acc.float().mT)
            new[merged_name] = sol.mT

    def avg_merge(i, mods, expert_t, merged_name, n):
        acc = None
        count = 0
        for m in mods:
            name = expert_t.format(i, m, n)
            if name in state:
                acc = state[name] if acc is None else acc + state[name]
                count += 1
            else:
                acc = state[merged_name]
                break
        new[merged_name] = acc if count == 0 else acc / acc.new_tensor(count)

    for i in range(num_layers):
        mods = layer_mods(i)
        for expert_t, merged_t in LAYER_ORDERS:
            if "qkv" in expert_t:
                gram_merge(i, mods, expert_t, merged_t.format(i),
                           ".qkv.weight")
            elif "attn" in expert_t and "proj" not in expert_t:
                for n in ("q_bias", "v_bias"):
                    avg_merge(i, mods, expert_t, merged_t.format(i, n), n)
            elif "mlp" in expert_t or "proj" in expert_t:
                gram_merge(i, mods, expert_t, merged_t.format(i, "weight"),
                           ".weight")
                avg_merge(i, mods, expert_t, merged_t.format(i, "bias"),
                          "bias")
            else:  # norms
                for n in ("weight", "bias"):
                    avg_merge(i, mods, expert_t, merged_t.format(i, n), n)
    return new


@torch.no_grad()
def regmean_device(state: Fleet, gram_matrices: Fleet, *, num_layers: int,
                   vlffn_start_layer_index: int,
                   loss_names: Dict[str, float],
                   scaling_for_non_diag: float = 1.0) -> Fleet:
    """RegMean on the fleet's device: w = (Σ wG)(ΣG)⁻¹ per matmul weight,
    biases and norms simple-averaged, over the whole fleet (gram leaves
    may carry the fleet axis too).

    f32 numerics: a batched ``torch.linalg.solve``, not the host path's
    f64 inverse, with TF32 off on the card (``require_cuda``).  Use it to
    sweep fleets and scalings, then run the chosen setting through
    ``core.regmean`` for the bit-identical contract checkpoint; its drift
    from the host path grows with the condition number of the summed
    grams."""
    if next(iter(state.values())).is_cuda:
        require_cuda()
    return _regmean_tree(state, gram_matrices, num_layers=num_layers,
                         vlffn_start_layer_index=vlffn_start_layer_index,
                         loss_names=loss_names,
                         scaling_for_non_diag=float(scaling_for_non_diag))
