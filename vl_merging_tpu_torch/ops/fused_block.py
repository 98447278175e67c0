"""Fused eval-block kernels (port of ``vl_merging_tpu/ops/fused_block.py``,
staged route).

  * ``ln_linear``     — y = LN(x)·Wᵀ + b (pre-norm + qkv), kernel K1,
                        ``csrc/ln_linear.cu``
  * ``proj_mlp_tail`` — proj + LayerScale + residual + LN2 + MLP +
                        LayerScale + residual, kernel K3,
                        ``csrc/proj_mlp_tail.cu``
  * ``fused_eval_block`` — a whole eval block as K1 → K2 → K3.

Each wrapper launches its CUDA kernel on CUDA tensors, or raises for
inputs the kernel does not take; on CPU tensors it runs its plain twin
(``*_reference``), which computes with the kernel's rounding points: LN
statistics in f32 with eps 1e-6, operands rounded to the activation dtype,
f32 accumulation and f32 bias/LayerScale/residual arithmetic.  Weights use
torch layout (out, in).  ``<wrapper>.launches`` counts kernel launches.

Reference semantics: vision_transformer.py:489-530 (LayerScale residuals),
:272-296 (Mlp), :831 (eps=1e-6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.layers import layer_norm
from . import _build
from .attention import packed_attention

LN_EPS = 1e-6
_HIDDEN_CHUNK = 128           # proj_mlp_tail walks the MLP hidden in chunks
_QKV_TILE = 384               # ln_linear's output tile width
_WIDTHS = (768,)              # model widths the kernels are instantiated for


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a·Wᵀ in f32 of operands rounded to a's dtype (torch layout W)."""
    return F.linear(a.float(), w.to(a.dtype).float())


def ln_linear_reference(x, ln_w, ln_b, w, b):
    """Plain twin of K1: bf16(LN(x)) · Wᵀ in f32, + b in f32, rounded."""
    xn = layer_norm(x, ln_w, ln_b, eps=LN_EPS)
    return (_mm(xn, w) + b.float()).to(x.dtype)


def ln_linear(x: torch.Tensor, ln_w, ln_b, w, b) -> torch.Tensor:
    """y = LN(x) @ Wᵀ + b; x: (B, N, C), w: (O, C) torch layout."""
    if not x.is_cuda:
        return ln_linear_reference(x, ln_w, ln_b, w, b)
    B, N, C = x.shape
    O = w.shape[0]
    if C not in _WIDTHS or O % _QKV_TILE:
        raise ValueError(f"ln_linear kernel takes C in {_WIDTHS} and "
                         f"O % {_QKV_TILE} == 0; got C={C}, O={O}")
    w = w.to(x.dtype)
    ln_w, ln_b, b = ln_w.float(), ln_b.float(), b.float()
    dev = x.device
    _build.expect(x, "x", torch.bfloat16, (B, N, C), dev)
    _build.expect(w, "w", torch.bfloat16, (O, C), dev)
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C), ("b", b, O)):
        _build.expect(t, name, torch.float32, (n,), dev)
    y = torch.empty((B, N, O), dtype=x.dtype, device=dev)
    lib = _build.library()
    _build.check(lib.vlm_ln_linear(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), B * N, C, O, LN_EPS,
        _build.stream_handle(dev)), "ln_linear")
    ln_linear.launches += 1
    return y


ln_linear.launches = 0


def proj_mlp_tail_reference(ctx, wp, bp, gamma1, res, ln_w, ln_b, w1, b1,
                            w2, b2, gamma2):
    """Plain twin of K3, with its rounding points: x', LN2(x') and
    gelu(fc1) are rounded to the activation dtype; everything else is
    f32."""
    dt = ctx.dtype
    y = _mm(ctx, wp) + bp.float()
    x1 = (res.float() + y * gamma1.float()).to(dt)
    xn = layer_norm(x1, ln_w, ln_b, eps=LN_EPS)
    h = F.gelu(_mm(xn, w1) + b1.float()).to(dt)
    y2 = _mm(h, w2) + b2.float()
    return (x1.float() + y2 * gamma2.float()).to(dt)


def proj_mlp_tail(ctx: torch.Tensor, wp, bp, gamma1, res, ln_w, ln_b, w1, b1,
                  w2, b2, gamma2) -> torch.Tensor:
    """y = x' + γ2 ⊙ fc2(GELU(fc1(LN(x')))) with
    x' = res + γ1 ⊙ (ctx @ Wpᵀ + bp): the whole post-attention half of a
    block, with x' and the MLP hidden kept on chip."""
    if not ctx.is_cuda:
        return proj_mlp_tail_reference(ctx, wp, bp, gamma1, res, ln_w, ln_b,
                                       w1, b1, w2, b2, gamma2)
    B, N, C = ctx.shape
    H = w1.shape[0]
    if C not in _WIDTHS or H % _HIDDEN_CHUNK:
        raise ValueError(f"proj_mlp_tail kernel takes C in {_WIDTHS} and "
                         f"hidden % {_HIDDEN_CHUNK} == 0; got C={C}, "
                         f"hidden={H}")
    wp, w1, w2 = (w.to(ctx.dtype) for w in (wp, w1, w2))
    vecs = [t.float() for t in (bp, gamma1, ln_w, ln_b, b1, b2, gamma2)]
    dev = ctx.device
    _build.expect(ctx, "ctx", torch.bfloat16, (B, N, C), dev)
    _build.expect(res, "res", torch.bfloat16, (B, N, C), dev)
    _build.expect(wp, "wp", torch.bfloat16, (C, C), dev)
    _build.expect(w1, "w1", torch.bfloat16, (H, C), dev)
    _build.expect(w2, "w2", torch.bfloat16, (C, H), dev)
    for name, t in zip(("bp", "gamma1", "ln_w", "ln_b", "b1", "b2", "gamma2"),
                       vecs):
        _build.expect(t, name, torch.float32, (H if name == "b1" else C,),
                      dev)
    bp, gamma1, ln_w, ln_b, b1, b2, gamma2 = vecs
    out = torch.empty_like(ctx)
    lib = _build.library()
    _build.check(lib.vlm_proj_mlp_tail(
        ctx.data_ptr(), res.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        gamma1.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma2.data_ptr(),
        out.data_ptr(), B * N, C, H, LN_EPS, _build.stream_handle(dev)),
        "proj_mlp_tail")
    proj_mlp_tail.launches += 1
    return out


proj_mlp_tail.launches = 0


def fused_eval_block(x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask, scale,
                     num_heads, wp, bp, gamma1, ln2_w, ln2_b, w1, b1, w2,
                     b2, gamma2):
    """One whole eval transformer block as the staged pipeline
    ln_linear (K1) → packed_attention (K2) → proj_mlp_tail (K3).  The
    JAX package's single-kernel megakernel and LN+qkv+attention routes are
    not ported yet (ROADMAP B)."""
    qkv = ln_linear(x, ln1_w, ln1_b, w_qkv, qkv_bias)
    ctx = packed_attention(qkv, bias, mask, scale, num_heads)
    return proj_mlp_tail(ctx, wp, bp, gamma1, x, ln2_w, ln2_b, w1, b1, w2,
                         b2, gamma2)
