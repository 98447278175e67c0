"""Gram-matrix caching for RegMean (port of ``vl_merging_tpu/train/gram.py``).

One validation pass accumulating per-module input grams ΣXᵀX
(reference: src/cache_gram_matrices.py:141-357) through the taps of
``models/taps.py``, over the eval-mode forward
(``train_step.compute_losses(train=False)``).  The reference hook casts
each module input to float64 BEFORE the matmul
(cache_gram_matrices.py:251-252), so parity needs the per-batch gram
itself in f64: ``precision="f64_host"`` (the default) captures the raw
activations, widens a bf16 one to f32 on its device (exact), copies it to
the host and forms xᵀx in f64 through torch CPU, the dgemm the JAX package
and a torch-hook oracle take, so equal activations give bit-equal grams.
``precision="f32_device"`` keeps the per-batch gram in f32 on the
activations' device and accumulates in f64 on the host: faster, for
self-produced grams consumed by our own regmean.  Grams are saved as a
torch .pth keyed by reference module names, so caches interop both ways.

The gram pass routes as the eval does with a tap active
(``models/mome.py``): the attention kernels stay (K2 in every @384 image
block), the fused eval blocks and K13 are off.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..ckpt.io import save_torch_checkpoint
from ..models.spec import ModelSpec, Params
from ..models.taps import (CaptureTap, GramTap, MOE_GRAM_SUFFIXES,
                           UFO_GRAM_SUFFIXES, active_tap)
from .train_step import compute_losses


def _gram_suffixes(cfg: Dict):
    return MOE_GRAM_SUFFIXES if cfg["use_moe"] else UFO_GRAM_SUFFIXES


def make_gram_step(cfg: Dict, spec: ModelSpec
                   ) -> Callable[[Params, Dict], Dict[str, torch.Tensor]]:
    """The f32 gram step: one eval-mode forward under a ``GramTap``; returns
    the per-module f32 grams of the batch on the activations' device."""
    suffixes = _gram_suffixes(cfg)

    @torch.no_grad()
    def fn(params: Params, batch: Dict) -> Dict[str, torch.Tensor]:
        tap = GramTap(suffixes)
        with active_tap(tap):
            compute_losses(params, spec, cfg, batch, None, train=False,
                           kernels=True)
        return tap.grams

    return fn


def make_capture_step(cfg: Dict, spec: ModelSpec
                      ) -> Callable[[Params, Dict], Dict[str, list]]:
    """The capture step: one eval-mode forward under a ``CaptureTap``;
    returns each module's raw inputs (the reference-parity path)."""
    suffixes = _gram_suffixes(cfg)

    @torch.no_grad()
    def fn(params: Params, batch: Dict) -> Dict[str, list]:
        tap = CaptureTap(suffixes)
        with active_tap(tap):
            compute_losses(params, spec, cfg, batch, None, train=False,
                           kernels=True)
        return tap.activations

    return fn


def gram_f64(act: torch.Tensor) -> np.ndarray:
    """Reference hook math on one module input: flatten to (B·L, D), widen
    to float64 on the host, xᵀx through torch CPU, so the dgemm matches a
    torch-hook oracle bit for bit (cache_gram_matrices.py:246-254).  A bf16
    input is widened to f32 on its own device first (exact; numpy has no
    bf16)."""
    if act.dtype == torch.bfloat16:
        act = act.float()
    flat = act.reshape(-1, act.shape[-1]).cpu().contiguous()
    flat = flat.to(torch.float64)
    return torch.matmul(flat.T, flat).numpy()


def cache_gram_matrices(
    params: Params, spec: ModelSpec, cfg: Dict,
    val_batches: Iterable[Dict], *, limit_batches: Optional[int] = None,
    precision: str = "f64_host",
) -> Dict[str, np.ndarray]:
    """Accumulate grams over a validation epoch; returns a float64 host dict.

    precision="f64_host" (default): per-call f64(x)ᵀf64(x) on the host like
    the reference hooks.  precision="f32_device": per-batch f32 gram on the
    activations' device, f64 accumulation on the host (faster,
    approximate)."""
    acc: Dict[str, np.ndarray] = {}
    if precision == "f32_device":
        step = make_gram_step(cfg, spec)
        for i, batch in enumerate(val_batches):
            if limit_batches is not None and i >= limit_batches:
                break
            for name, g in step(params, batch).items():
                g64 = g.cpu().numpy().astype(np.float64)
                acc[name] = acc.get(name, 0.0) + g64
        return acc

    if precision != "f64_host":
        raise ValueError(f"unknown gram precision {precision!r}")
    step = make_capture_step(cfg, spec)
    for i, batch in enumerate(val_batches):
        if limit_batches is not None and i >= limit_batches:
            break
        for name, acts in step(params, batch).items():
            for a in acts:
                g = gram_f64(a)
                acc[name] = acc.get(name, 0.0) + g
    return acc


def save_gram_matrices(grams: Dict[str, np.ndarray], path: str) -> None:
    """A plain (no Lightning envelope) torch .pth of the f64 grams."""
    save_torch_checkpoint(grams, path, lightning_envelope=False)
