"""W8A8 int8 eval kernels and their plain twins (port of
``vl_merging_tpu/ops/int8.py``).

Scheme: symmetric per-output-channel int8 weights (amax/127 over the f32
master, clipped to ±127), symmetric per-token dynamic int8 activations
(``attention.quant_rows``, shared with K12: amax/127, no clip), s8·s8→s32
products, dequantised as ((acc · s) · ws) + b in f32.  Attention keeps f32
logits unless the opt-in int8-QK mode (``qk_int8``) runs K12.

  * ``ln_linear_i8``     — f32 LN → quantise → int8 qkv projection,
                           kernel K14, ``csrc/ln_linear_i8.cu``
  * ``proj_mlp_tail_i8`` — int8 proj + LayerScale + residual + LN2 +
                           int8 MLP + LayerScale + residual, kernel K15,
                           ``csrc/proj_mlp_tail_i8.cu``
  * ``fused_eval_block_i8`` — a whole eval block as K14 → K2 (or K12) →
                           K15; ``ref_fused_eval_block_i8`` is the same
                           block through the plain twins.

Each wrapper launches its CUDA kernel on CUDA tensors, or raises for
inputs the kernel does not take; on CPU tensors it runs its plain twin
(``ref_*``).  ``<wrapper>.launches`` counts kernel launches.  The MLP's
activation is the ``gelu`` argument, a name of ``mlp.GELUS`` ("poly", the
degree-19 polynomial, by default); the JAX package reads it from
``VLM_TPU_I8_GELU`` and the int8-QK switch from ``VLM_TPU_I8_QK``, the
port from explicit arguments.  The JAX package's row block (``BLOCK_M``)
and its M ≥ 512 gate are TPU tile sizes: the kernels take any row count.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Tuple

import torch

from ..models.layers import layer_norm
from . import _build
from .attention import int8_matmul, packed_attention, \
    packed_attention_i8qk, packed_attention_reference, \
    packed_attention_i8qk_reference, quant_rows
from .fused_block import require_kernel
from .mlp import GELUS

LN_EPS = 1e-6
_QKV_TILE = 256        # ln_linear_i8's output tile width
_I8_GROUP = 1          # ln_linear_i8: column tiles per unit of work

# params-dict key suffixes of the quantized companions of a ".weight" key
INT8_SUFFIX = "::int8"
SCALE_SUFFIX = "::scale8"

_QUANT_KEY_RE = re.compile(
    r"transformer\.blocks\.\d+\."
    r"(attn(\.(v|l|vl))?\.(qkv|proj)|mlp(\.(v|l|vl))?\.fc[12])\.weight$")


def quantize_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (O, C) torch layout →
    (int8 (O, C), f32 scale (O,)), from the master in f32; round half to
    even, clipped to ±127."""
    w32 = torch.as_tensor(w).float()
    amax = w32.abs().amax(dim=1)
    # divided by a tensor: PyTorch's CUDA kernels divide by a Python scalar
    # as a multiply by its f32 reciprocal, which can round a scale one ulp
    # off the IEEE quotient the JAX package takes (fault C10)
    scale = amax.clamp_min(1e-12) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_eval_params(params: Dict, keys=None) -> Dict:
    """Add int8 companions for every block projection weight (or the
    explicit ``keys``); the originals stay."""
    out = dict(params)
    for k in (keys if keys is not None else list(params)):
        if keys is None and not _QUANT_KEY_RE.match(k):
            continue
        out[k + INT8_SUFFIX], out[k + SCALE_SUFFIX] = \
            quantize_weight(params[k])
    return out


def _dot_i8(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., C) int8 @ (O, C) int8ᵀ → (..., O) int32, exact."""
    return int8_matmul(q, wq.t())


def _ln_f32(x, ln_w, ln_b):
    """LN with f32 statistics, left in f32 (no rounding before the
    quantizer)."""
    return layer_norm(x.float(), ln_w, ln_b, eps=LN_EPS)


def _dequant(acc, s, ws):
    return acc.float() * s * ws.float()


def ref_ln_linear_i8(x, ln_w, ln_b, wq, wscale, b):
    """Plain twin of K14: f32 LN → per-token int8 → s8·s8→s32 →
    ((acc · s) · ws) + b in f32, rounded to x's dtype."""
    q, s = quant_rows(_ln_f32(x, ln_w, ln_b))
    return (_dequant(_dot_i8(q, wq), s, wscale) + b.float()).to(x.dtype)


def ref_proj_mlp_tail_i8(ctx, pq, ps, bp, gamma1, res, ln_w, ln_b, w1q, w1s,
                         b1, w2q, w2s, b2, gamma2, *, gelu: str = "poly"):
    """Plain twin of K15: x1 = dt(res + (dequant(quant(ctx)·pqᵀ) + bp)·γ1);
    h = gelu(dequant(quant(LN2(x1))·w1qᵀ) + b1) in f32, quantized per token
    over its whole width; out = dt(x1 + (dequant(quant(h)·w2qᵀ) + b2)·γ2)."""
    act = GELUS[gelu]
    q, s = quant_rows(ctx.float())
    y = (_dequant(_dot_i8(q, pq), s, ps) + bp.float()) * gamma1.float()
    x1 = (res.float() + y).to(ctx.dtype)
    q1, s1 = quant_rows(_ln_f32(x1, ln_w, ln_b))
    h = act(_dequant(_dot_i8(q1, w1q), s1, w1s) + b1.float())
    q2, s2 = quant_rows(h)
    y2 = (_dequant(_dot_i8(q2, w2q), s2, w2s) + b2.float()) * gamma2.float()
    return (x1.float() + y2).to(ctx.dtype)


@functools.cache
def ln_linear_i8_grid(C: int) -> int:
    """The CTAs of K14's persistent grid at width C: as many whole
    clusters of two as the card holds at once.  Queried once per process
    and width."""
    return _build.library().vlm_ln_linear_i8_grid(C)


def ln_linear_i8_plan(M: int, O: int, grid: int,
                      group: int = _I8_GROUP) -> Tuple[int, int]:
    """K14's work at M rows and O columns on ``grid`` CTAs: its units (a
    pair of 128-row blocks x ``group`` column tiles of 256) and its rounds
    (the most column tiles a cluster of two takes)."""
    units = -(-M // 256) * (O // _QKV_TILE // group)
    return units, -(-units // max(1, grid // 2)) * group


def ln_linear_i8(x: torch.Tensor, ln_w, ln_b, wq, wscale, b, *,
                 group: int = _I8_GROUP) -> torch.Tensor:
    """K14: y = dequant(quant(LN(x)) @ wqᵀ) + b; x (B, N, C), wq int8 (O, C),
    wscale (O,).  The LN output stays in f32 up to the quantizer.
    ``group``: column tiles of 256 per unit of work (a divisor of O/256)."""
    if not x.is_cuda:
        return ref_ln_linear_i8(x, ln_w, ln_b, wq, wscale, b)
    B, N, C = x.shape
    O = wq.shape[0]
    require_kernel("ln_linear_i8", C)
    if O % _QKV_TILE:
        raise ValueError(f"ln_linear_i8 kernel takes O % {_QKV_TILE} == 0; "
                         f"got O={O}")
    ln_w, ln_b, wscale, b = (t.float() for t in (ln_w, ln_b, wscale, b))
    dev = x.device
    _build.expect(x, "x", torch.bfloat16, (B, N, C), dev)
    _build.expect(wq, "wq", torch.int8, (O, C), dev)
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C),
                       ("wscale", wscale, O), ("b", b, O)):
        _build.expect(t, name, torch.float32, (n,), dev)
    y = torch.empty((B, N, O), dtype=x.dtype, device=dev)
    lib = _build.library()
    _build.check(lib.vlm_ln_linear_i8(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(),
        wscale.data_ptr(), b.data_ptr(), y.data_ptr(), B * N, C, O,
        ln_linear_i8_grid(C), group, LN_EPS, _build.stream_handle(dev)),
        "ln_linear_i8")
    ln_linear_i8.launches += 1
    return y


ln_linear_i8.launches = 0


def proj_mlp_tail_i8(ctx: torch.Tensor, pq, ps, bp, gamma1, res, ln_w, ln_b,
                     w1q, w1s, b1, w2q, w2s, b2, gamma2, *,
                     gelu: str = "poly") -> torch.Tensor:
    """K15: the post-attention half of an int8 block (``ref_proj_mlp_tail_i8``)
    with x1, LN2 and the MLP hidden kept on chip."""
    if gelu not in GELUS:
        raise ValueError(f"gelu {gelu!r}: one of {sorted(GELUS)}")
    if not ctx.is_cuda:
        return ref_proj_mlp_tail_i8(ctx, pq, ps, bp, gamma1, res, ln_w, ln_b,
                                    w1q, w1s, b1, w2q, w2s, b2, gamma2,
                                    gelu=gelu)
    B, N, C = ctx.shape
    H = w1q.shape[0]
    require_kernel("proj_mlp_tail_i8", C, H)
    names = ("ps", "bp", "gamma1", "ln_w", "ln_b", "w1s", "b1", "w2s", "b2",
             "gamma2")
    vecs = [t.float() for t in (ps, bp, gamma1, ln_w, ln_b, w1s, b1, w2s, b2,
                                gamma2)]
    dev = ctx.device
    _build.expect(ctx, "ctx", torch.bfloat16, (B, N, C), dev)
    _build.expect(res, "res", torch.bfloat16, (B, N, C), dev)
    _build.expect(pq, "pq", torch.int8, (C, C), dev)
    _build.expect(w1q, "w1q", torch.int8, (H, C), dev)
    _build.expect(w2q, "w2q", torch.int8, (C, H), dev)
    for name, t in zip(names, vecs):
        _build.expect(t, name, torch.float32,
                      (H if name in ("w1s", "b1") else C,), dev)
    ps, bp, gamma1, ln_w, ln_b, w1s, b1, w2s, b2, gamma2 = vecs
    out = torch.empty_like(ctx)
    lib = _build.library()
    _build.check(lib.vlm_proj_mlp_tail_i8(
        ctx.data_ptr(), res.data_ptr(), pq.data_ptr(), ps.data_ptr(),
        bp.data_ptr(), gamma1.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        w2s.data_ptr(), b2.data_ptr(), gamma2.data_ptr(), out.data_ptr(),
        B * N, C, H, list(GELUS).index(gelu), LN_EPS,
        _build.stream_handle(dev)), "proj_mlp_tail_i8")
    proj_mlp_tail_i8.launches += 1
    return out


proj_mlp_tail_i8.launches = 0


def _block_i8(stages, x, ln1_w, ln1_b, qkv_q, qkv_s, qkv_bias, bias, mask,
              scale, num_heads, pq, ps, bp, gamma1, ln2_w, ln2_b, w1q, w1s,
              b1, w2q, w2s, b2, gamma2, gelu, qk_int8):
    qkv_fn, attn_fn, attn_i8qk_fn, tail_fn = stages
    qkv = qkv_fn(x, ln1_w, ln1_b, qkv_q, qkv_s, qkv_bias)
    ctx = (attn_i8qk_fn if qk_int8 else attn_fn)(qkv, bias, mask, scale,
                                                  num_heads)
    return tail_fn(ctx, pq, ps, bp, gamma1, x, ln2_w, ln2_b, w1q, w1s, b1,
                   w2q, w2s, b2, gamma2, gelu=gelu)


def fused_eval_block_i8(*args, gelu: str = "poly", qk_int8: bool = False):
    """One eval transformer block with int8 projections:
    ln_linear_i8 (K14) → packed_attention (K2), or packed_attention_i8qk
    (K12) when ``qk_int8`` → proj_mlp_tail_i8 (K15).  Arguments as
    ``vl_merging_tpu/ops/int8.py:fused_eval_block_i8``: x, ln1_w, ln1_b,
    qkv_q, qkv_s, qkv_bias, bias, mask, scale, num_heads, pq, ps, bp,
    gamma1, ln2_w, ln2_b, w1q, w1s, b1, w2q, w2s, b2, gamma2."""
    return _block_i8((ln_linear_i8, packed_attention, packed_attention_i8qk,
                      proj_mlp_tail_i8), *args, gelu, qk_int8)


def ref_fused_eval_block_i8(*args, gelu: str = "poly",
                            qk_int8: bool = False):
    """``fused_eval_block_i8`` through the plain twins, on any device (the
    int8 plain path that ``chip_smoke.py`` holds the kernels against)."""
    return _block_i8((ref_ln_linear_i8, packed_attention_reference,
                      packed_attention_i8qk_reference, ref_proj_mlp_tail_i8),
                     *args, gelu, qk_int8)
