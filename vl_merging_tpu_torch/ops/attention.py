"""Attention: the plain reference and the packed-qkv kernel (port of
``vl_merging_tpu/ops/attention.py``).

``reference_attention`` is the plain path (the text tower and every block
off the kernel route use it).  ``packed_attention`` is kernel K2,
``csrc/packed_attention.cu``: attention read straight from the packed
(B, N, 3C) qkv projection, writing the context as (B, N, C).  On CPU
tensors it runs its plain twin ``packed_attention_reference`` (the JAX
package's ``_packed_reference``).
"""

from __future__ import annotations

from typing import Optional

import torch

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
