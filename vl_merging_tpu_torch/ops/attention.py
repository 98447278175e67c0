"""Attention: the plain reference and the packed-qkv kernels (port of
``vl_merging_tpu/ops/attention.py``).

``reference_attention`` is the plain path (the text tower and every block
off the kernel route use it).  ``packed_attention`` is kernel K2,
``csrc/packed_attention.cu``: attention read straight from the packed
(B, N, 3C) qkv projection, writing the context as (B, N, C).
``packed_attention_bwd`` is kernel K9, ``csrc/packed_attention_bwd.cu``:
its backward, (dqkv, dbias summed over the batch).
``packed_fused_attention`` joins them into one differentiable function
(the JAX package's ``_packed_attention_diff``).  On CPU tensors each
wrapper runs its plain twin (``packed_attention_reference``, the JAX
package's ``_packed_reference``; ``packed_attention_bwd_reference``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIM = 64  # the only head width packed_attention's kernel takes


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
    scale: float, logits_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """q, k, v: (B, H, N, d); bias: (H, N, N) f32; mask: (B, N), 1 = valid.

    q is scaled in its own dtype; logits are the f32-accumulated q·kᵀ
    (rounded to ``logits_dtype``), plus the bias, with masked keys at -inf;
    softmax in f32; probabilities are cast to q's dtype and contracted
    with v in f32, rounded to q's dtype (reference
    vision_transformer.py:346-358)."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) \
        .to(logits_dtype)
    if bias is not None:
        s = s + bias[None].to(logits_dtype)
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def packed_attention_reference(qkv, bias, mask, scale: float,
                               num_heads: int) -> torch.Tensor:
    """Plain twin of K2: split the packed qkv into heads and run
    ``reference_attention``; (B, N, 3C) → (B, N, C)."""
    B, N, threeC = qkv.shape
    q, k, v = qkv.split(threeC // 3, dim=-1)
    out = reference_attention(_heads(q, num_heads), _heads(k, num_heads),
                              _heads(v, num_heads), bias, mask, scale)
    return out.transpose(1, 2).reshape(B, N, threeC // 3)


def packed_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor, scale: float,
                     num_heads: int) -> torch.Tensor:
    """Fused attention over packed qkv (B, N, 3C) → context (B, N, C), with
    an f32 (H, N, N) additive bias and a (B, N) key mask.  The kernel
    takes any N (it masks the ragged edge itself) and head_dim 64."""
    if not qkv.is_cuda:
        return packed_attention_reference(qkv, bias, mask, scale, num_heads)
    B, N, threeC = qkv.shape
    C = threeC // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"packed_attention kernel takes head_dim "
                         f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    bias = bias.float()
    mask = mask.to(torch.int32)
    dev = qkv.device
    _build.expect(qkv, "qkv", torch.bfloat16, (B, N, 3 * C), dev)
    _build.expect(bias, "bias", torch.float32, (num_heads, N, N), dev)
    _build.expect(mask, "mask", torch.int32, (B, N), dev)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    lib = _build.library()
    _build.check(lib.vlm_packed_attention(
        qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, N, num_heads, float(scale), _build.stream_handle(dev)),
        "packed_attention")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0


def packed_attention_bwd_reference(qkv, bias, mask, g, scale: float,
                                   num_heads: int):
    """Plain twin of K9 with its rounding points
    (``vl_merging_tpu/ops/attention.py:_packed_bwd_kernel``): q pre-scaled
    in its dtype, f32 softmax of the biased and masked logits (0 on a row
    with no valid key), dv = cast(p)ᵀ·g, ds = p ⊙ (dp − Σ dp ⊙ p) in f32,
    dq = cast(ds)·k · scale, dk = cast(ds)ᵀ·q, all products accumulated
    in f32.  Returns (dqkv (B, N, 3C) in qkv's dtype, dbias (H, N, N) f32
    summed over the batch)."""
    B, N, threeC = qkv.shape
    C = threeC // 3
    dt = qkv.dtype
    q, k, v = (_heads(t, num_heads) for t in qkv.split(C, dim=-1))
    qs = q * torch.tensor(scale, dtype=dt)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) + \
        bias[None].float()
    valid = mask > 0
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None, None], p, 0.0)
    gh = _heads(g, num_heads).float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds16 = ds.to(dt).float()
    dq = torch.matmul(ds16, k.float()) * scale
    dk = torch.matmul(ds16.transpose(-1, -2), qs.float())
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, N, C)
                      for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(dt), ds.sum(0)


def packed_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: torch.Tensor, g: torch.Tensor, scale: float,
                         num_heads: int):
    """K9: the backward of ``packed_attention`` → (dqkv (B, N, 3C),
    dbias (H, N, N) f32 summed over the batch).  ``g`` is the context
    gradient (B, N, C), contiguous; the kernel takes any N and head_dim
    64, reads a copy of the bias whose rows are padded to whole 64-key
    tiles (aligned pairs: a 16 MB copy at N = 577, 12 heads), and sums
    dbias over at most four batch groups whose partials it adds in a
    fixed order (no atomics)."""
    if not qkv.is_cuda:
        return packed_attention_bwd_reference(qkv, bias, mask, g, scale,
                                              num_heads)
    B, N, threeC = qkv.shape
    C = threeC // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"packed_attention_bwd kernel takes head_dim "
                         f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    bias = bias.float()
    mask = mask.to(torch.int32)
    dev = qkv.device
    _build.expect(qkv, "qkv", torch.bfloat16, (B, N, 3 * C), dev)
    _build.expect(bias, "bias", torch.float32, (num_heads, N, N), dev)
    _build.expect(mask, "mask", torch.int32, (B, N), dev)
    _build.expect(g, "g", torch.bfloat16, (B, N, C), dev)
    ldb = -(-N // 64) * 64
    bias_rows = F.pad(bias, (0, ldb - N))
    lib = _build.library()
    groups = lib.vlm_packed_attention_bwd_groups(B)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((num_heads, N, N), dtype=torch.float32, device=dev)
    stats = torch.empty((3, B, num_heads, N), dtype=torch.float32,
                        device=dev)
    part = dbias if groups == 1 else torch.empty(
        (groups, num_heads, N, N), dtype=torch.float32, device=dev)
    _build.check(lib.vlm_packed_attention_bwd(
        qkv.data_ptr(), bias_rows.data_ptr(), mask.data_ptr(), g.data_ptr(),
        dqkv.data_ptr(), dbias.data_ptr(), stats.data_ptr(), part.data_ptr(),
        B, N, num_heads, ldb, groups, float(scale), _build.stream_handle(dev)),
        "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    return dqkv, dbias


packed_attention_bwd.launches = 0


class _PackedFusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, num_heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.scale, ctx.num_heads = scale, num_heads
        return packed_attention(qkv, bias, mask, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = packed_attention_bwd(qkv, bias, mask, g.contiguous(),
                                           ctx.scale, ctx.num_heads)
        return dqkv, dbias.to(bias.dtype), None, None, None


def packed_fused_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: torch.Tensor, scale: float,
                           num_heads: int) -> torch.Tensor:
    """Differentiable packed attention: K2 forward, K9 backward (their
    twins on CPU tensors).  Gradients reach qkv and the bias; the mask
    gets none."""
    return _PackedFusedAttention.apply(qkv, bias, mask, scale, num_heads)
