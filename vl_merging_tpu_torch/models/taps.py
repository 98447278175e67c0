"""Activation taps: the functional stand-in for forward hooks (port of
``vl_merging_tpu/models/taps.py``).

The reference registers torch forward hooks on expert Linears to
accumulate per-layer input gram matrices XᵀX for RegMean
(reference: src/cache_gram_matrices.py:246-281).  The port's blocks are
functions, not modules, so ``models/mome.py`` calls ``tap_add(name, x)`` at
the module-input points the JAX package taps, and a tap made active by
``active_tap`` (a ``contextvars`` variable, as in the JAX package) sees
them.  While a tap is active the blocks leave the fused kernels that would
hide a tapped input (``mome._block_fast``, ``_block_fast_train`` and K13);
the attention kernels stay (``mome._attend``).  No tap active: the calls
do nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence

import torch

_ACTIVE_TAP: contextvars.ContextVar = contextvars.ContextVar(
    "vlm_torch_tap", default=None)


class GramTap:
    """Accumulates Σ xᵀx per tapped module over one forward, in f32 on the
    tensor's own device.

    Grams include every token position (padding too) — same as the
    reference's hooks, which see the raw (B, L, D) module inputs."""

    def __init__(self, suffixes: Sequence[str]):
        self.suffixes = tuple(suffixes)
        self.grams: Dict[str, torch.Tensor] = {}

    def wants(self, name: str) -> bool:
        return any(name.endswith(s) for s in self.suffixes)

    def add(self, name: str, x: torch.Tensor) -> None:
        if not self.wants(name):
            return
        flat = x.detach().reshape(-1, x.shape[-1]).float()
        gram = flat.T @ flat
        if name in self.grams:
            self.grams[name] = self.grams[name] + gram
        else:
            self.grams[name] = gram


class CaptureTap:
    """Captures raw module-input activations (the reference's
    get_middle_representation / hook_input path,
    cache_gram_matrices.py:240-262) for offline analysis."""

    def __init__(self, suffixes: Sequence[str]):
        self.suffixes = tuple(suffixes)
        self.activations: Dict[str, List[torch.Tensor]] = {}

    def wants(self, name: str) -> bool:
        return any(name.endswith(s) for s in self.suffixes)

    def add(self, name: str, x: torch.Tensor) -> None:
        if not self.wants(name):
            return
        self.activations.setdefault(name, []).append(x.detach())


def tap_add(name: str, x: torch.Tensor) -> None:
    tap = _ACTIVE_TAP.get()
    if tap is not None:
        tap.add(name, x)


def tapping() -> bool:
    """Whether a tap is active (the blocks then take the tappable path)."""
    return _ACTIVE_TAP.get() is not None


@contextlib.contextmanager
def active_tap(tap: Optional[GramTap]):
    token = _ACTIVE_TAP.set(tap)
    try:
        yield tap
    finally:
        _ACTIVE_TAP.reset(token)


MOE_GRAM_SUFFIXES = (
    # reference cache_gram_matrices.py:264-274
    "mlp.fc1", "mlp.fc2",
    "mlp.v.fc1", "mlp.l.fc1", "mlp.vl.fc1",
    "mlp.v.fc2", "mlp.l.fc2", "mlp.vl.fc2",
    "attn", "attn.v", "attn.l", "attn.vl",
    "attn.proj", "attn.v.proj", "attn.l.proj", "attn.vl.proj",
)

UFO_GRAM_SUFFIXES = (
    # reference cache_gram_matrices.py:276
    "mlp.fc1", "mlp.fc2", "attn.proj", "norm1", "norm2",
)
