"""Fused MLP (fc1 → GELU → fc2): kernel K13 and its plain twins (port of
``vl_merging_tpu/ops/mlp.py``).

  * ``reference_mlp``        — the plain composition: products rounded to
                               x's dtype, exact-erf GELU (the JAX package's
                               XLA path, and the function whose autograd
                               is ``fused_mlp``'s backward);
  * ``mlp_kernel_reference`` — the plain twin of K13, rounding where the
                               kernel does;
  * ``mlp_kernel``           — K13, ``csrc/mlp.cu``, on CUDA tensors;
  * ``fused_mlp``            — the differentiable entry point: K13 (or its
                               twin, on CPU tensors) forward, the autograd
                               VJP of ``reference_mlp`` recomputed from the
                               saved inputs as the backward (the JAX
                               package's ``_pallas_mlp_diff``).

Weights stay in torch layout (fc1 (H, C), fc2 (C, H)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_block import _HIDDEN_CHUNK, _WIDTHS  # K13 runs K3's MLP body


def reference_mlp(x, w1, b1, w2, b2):
    """Plain path; x: (..., C).  fc1 is rounded to x's dtype before its
    bias, the exact-erf GELU runs in x's dtype, fc2 likewise
    (``vl_merging_tpu/ops/mlp.py:reference_mlp``)."""
    dt = x.dtype
    h = F.gelu(F.linear(x, w1.to(dt)) + b1.to(dt))
    return F.linear(h, w2.to(dt)) + b2.to(dt)


def _erf_approx(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz–Stegun 7.1.26 rational erf (|err| ≤ 1.5e-7), the erf of
    the TPU kernel and of K13."""
    p = 0.3275911
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _erf_gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf_approx(x * (2.0 ** -0.5)))


def mlp_kernel_reference(x, w1, b1, w2, b2):
    """Plain twin of K13 with the kernel's rounding points: fc1 of operands
    in x's dtype accumulated in f32, + b1 in f32, the A&S-erf GELU in f32,
    the hidden rounded to x's dtype, fc2 accumulated in f32, + b2 in f32,
    one rounding of the output."""
    dt = x.dtype
    h = F.linear(x.float(), w1.to(dt).float()) + b1.float()
    h = _erf_gelu(h).to(dt)
    o = F.linear(h.float(), w2.to(dt).float()) + b2.float()
    return o.to(dt)


def mlp_kernel(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """K13: y = fc2(GELU(fc1(x))) with the (M, H) hidden kept on chip;
    x: (B, N, C) bf16 on the current CUDA device.  On CPU tensors it runs
    ``mlp_kernel_reference``."""
    if not x.is_cuda:
        return mlp_kernel_reference(x, w1, b1, w2, b2)
    B, N, C = x.shape
    H = w1.shape[0]
    if C not in _WIDTHS or H % _HIDDEN_CHUNK:
        raise ValueError(f"mlp kernel takes C in {_WIDTHS} and hidden % "
                         f"{_HIDDEN_CHUNK} == 0; got C={C}, hidden={H}")
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    b1, b2 = b1.float(), b2.float()
    dev = x.device
    _build.expect(x, "x", torch.bfloat16, (B, N, C), dev)
    _build.expect(w1, "w1", torch.bfloat16, (H, C), dev)
    _build.expect(w2, "w2", torch.bfloat16, (C, H), dev)
    _build.expect(b1, "b1", torch.float32, (H,), dev)
    _build.expect(b2, "b2", torch.float32, (C,), dev)
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check(lib.vlm_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B * N, C, H,
        _build.stream_handle(dev)), "mlp")
    mlp_kernel.launches += 1
    return out


mlp_kernel.launches = 0


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return mlp_kernel(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = reference_mlp(*inputs)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if n else None for n in needs)


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """Differentiable MLP through K13: the kernel forward, and the autograd
    VJP of ``reference_mlp`` at the saved inputs as the backward
    (``vl_merging_tpu/ops/mlp.py:_bwd``).  As in the JAX package, forward
    and backward are different compositions of the same function."""
    return _FusedMLP.apply(x, w1, b1, w2, b2)
