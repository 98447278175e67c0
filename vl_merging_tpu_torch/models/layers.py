"""Primitive layers: torch-layout linear, layernorm, gelu, dropout, drop_path
(port of ``vl_merging_tpu/models/layers.py``).

Rounding follows the JAX package: ``linear`` rounds the product to the
compute dtype before adding the bias in that dtype, and ``layer_norm``
takes its statistics in float32 and returns the input dtype.

Random draws are rank-invariant (``rank_rand``): under a process group a
rank draws the global batch's values and keeps its own rows, so the ranks
of a data-parallel step draw what one process draws over the global
batch (as the JAX package's partitionable threefry does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import host


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
    """Exact (erf) GELU, torch nn.GELU's default (the JAX package's
    ``layers.gelu``)."""
    return F.gelu(x)


def rank_rand(shape, generator: torch.Generator, axis: int = 0
              ) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` on the generator's device for
    this rank's rows of the global batch: the draw of the global shape
    (``shape[axis]`` × the world size along ``axis``), this rank's
    contiguous block of it along ``axis``.  In one process, the draw of
    ``shape``."""
    world = host.get_world_size()
    if world == 1:
        return torch.rand(shape, generator=generator, device=generator.device)
    full = list(shape)
    full[axis] *= world
    u = torch.rand(full, generator=generator, device=generator.device)
    return u.narrow(axis, host.get_rank() * shape[axis], shape[axis])


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Elementwise dropout with a mask drawn from ``generator``
    (``rank_rand`` over the leading batch axis); the identity unless
    training with a generator and rate > 0."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = rank_rand(x.shape, generator).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              train: bool) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample and
    scale the kept ones by 1/keep (timm DropPath); the identity unless
    training with a generator and rate > 0."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = rank_rand(shape, generator).to(x.device) < keep
    return x * (mask.to(x.dtype) / keep)
