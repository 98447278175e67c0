"""Bicubic 2-D resize, torch ``F.interpolate(mode='bicubic')`` (port of
``vl_merging_tpu/ckpt/bicubic.py``).

The reference uses it to rescale the image block of the shared
relative-position bias table when changing input resolution (reference:
src/vilt/modules/vilt_module.py:797-804, 863-866).  The JAX package routes
through torch CPU whenever torch is importable, for bit-identity with the
reference; the port always has torch, so the JAX package's NumPy fallback
has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


def bicubic_resize(arr: np.ndarray, out_hw) -> np.ndarray:
    """Resize the last two axes of ``arr`` to ``out_hw`` with torch CPU's
    bicubic (align_corners=False, A = -0.75, border clamping)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    squeeze = 0
    while t.ndim < 4:           # F.interpolate wants (N, C, H, W)
        t = t.unsqueeze(0)
        squeeze += 1
    out = torch.nn.functional.interpolate(
        t, size=tuple(out_hw), mode="bicubic")
    for _ in range(squeeze):
        out = out.squeeze(0)
    return out.numpy()
