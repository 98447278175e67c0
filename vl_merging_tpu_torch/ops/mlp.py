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
from .attention import recompute_vjp
from .fused_block import require_kernel  # K13 runs K3's MLP body


def reference_mlp(x, w1, b1, w2, b2, on_hidden=None):
    """Plain path; x: (..., C).  fc1 is rounded to x's dtype before its
    bias, the exact-erf GELU runs in x's dtype, fc2 likewise
    (``vl_merging_tpu/ops/mlp.py:reference_mlp``).  ``on_hidden``, when
    given, is called with the GELU output (fc2's input)."""
    dt = x.dtype
    h = F.gelu(F.linear(x, w1.to(dt)) + b1.to(dt))
    if on_hidden is not None:
        on_hidden(h)
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


# Clip-saturated odd-polynomial gelus, the fma-only activations of the int8
# MLP (K15): erf(x/√2) ≈ u·P(u²) with u = clip(x, −T, T)/T, the
# coefficients c₀.. in ascending odd powers of u summing to 1, so the
# clipped tails are exactly gelu(x) = x and 0.  Copied from
# ``vl_merging_tpu/ops/mlp.py:64-137``: degree 19 (the int8 default, max
# |Δ| 4.7e-5 against exact erf-gelu), 11 (8.2e-4) and 13 (1.75e-4).
_GELU_POLY_T = 4.5
_GELU_POLY_COEF = (
    3.590282846823918, -12.10273623182234, 36.461995337755816,
    -85.03475787176419, 152.33199218079585, -204.54489822051983,
    196.73375743149893, -126.45531926658512, 48.21324671368246,
    -8.1935629198655)
_GELU_POLY11_T = 3.5
_GELU_POLY11_COEF = (
    2.781156562, -5.458430753, 8.694525338, -8.887355099,
    5.116006695, -1.245902743)
_GELU_POLY13_T = 3.95
_GELU_POLY13_COEF = (
    3.144041517, -7.974838082, 16.980673852, -24.785977463,
    23.048449174, -12.161256715, 2.748907717)


def _clipped_poly_gelu(x: torch.Tensor, t: float, coef) -> torch.Tensor:
    """Clip, then Horner in u² in f32, one rounding per operation."""
    u = torch.clamp(x, -t, t) * (1.0 / t)
    u2 = u * u
    p = torch.full_like(u2, coef[-1])
    for c in coef[-2::-1]:
        p = p * u2 + c
    return 0.5 * x * (1.0 + u * p)


def poly_gelu(x: torch.Tensor) -> torch.Tensor:
    """Degree-19 fma-only gelu, the int8 MLP's default."""
    return _clipped_poly_gelu(x, _GELU_POLY_T, _GELU_POLY_COEF)


def poly11_gelu(x: torch.Tensor) -> torch.Tensor:
    """Degree-11 fma-only gelu (5 Horner steps)."""
    return _clipped_poly_gelu(x, _GELU_POLY11_T, _GELU_POLY11_COEF)


def poly13_gelu(x: torch.Tensor) -> torch.Tensor:
    """Degree-13 fma-only gelu (6 Horner steps)."""
    return _clipped_poly_gelu(x, _GELU_POLY13_T, _GELU_POLY13_COEF)


# the int8 MLP's activations by name (``gelu=`` of ops/int8.py), in the
# order of the kernel's switch (csrc/proj_mlp_tail_i8.cu)
GELUS = {"poly": poly_gelu, "poly11": poly11_gelu, "poly13": poly13_gelu,
         "erf": _erf_gelu}


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
    require_kernel("mlp", C, H)
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
        return recompute_vjp(reference_mlp, ctx.saved_tensors,
                             ctx.needs_input_grad, g)


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """Differentiable MLP through K13: the kernel forward, and the autograd
    VJP of ``reference_mlp`` at the saved inputs as the backward
    (``vl_merging_tpu/ops/mlp.py:_bwd``).  As in the JAX package, forward
    and backward are different compositions of the same function."""
    return _FusedMLP.apply(x, w1, b1, w2, b2)
