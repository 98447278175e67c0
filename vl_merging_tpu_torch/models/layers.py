"""Primitive layers: torch-layout linear, layernorm, gelu (port of
``vl_merging_tpu/models/layers.py``, eval only).

Rounding follows the JAX package: ``linear`` rounds the product to the
compute dtype before adding the bias in that dtype, and ``layer_norm``
takes its statistics in float32 and returns the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W.T + b with torch-layout W=(out, in), in ``dtype`` (default:
    x's dtype)."""
    if dtype is not None:
        x = x.to(dtype)
    y = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the trailing dim, computed in f32 for stability."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, matching torch nn.GELU's default."""
    return F.gelu(x)
