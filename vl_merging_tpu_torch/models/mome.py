"""MoME (Mixture-of-Modality-Experts) transformer block, eval only (port of
``vl_merging_tpu/models/mome.py``).

Numerics follow the reference: BEiT-style qkv bias (learnable q/v bias,
frozen zero k bias; vision_transformer.py:332-337), fp32 attention logits
with additive relative-position bias and -inf padding mask
(vision_transformer.py:346-355), LayerScale residuals (gamma_1/gamma_2).

Ported: block types V and L (single-modality sequences), for which every
routing mode (plain, separate_plain, moe) reduces to one expert per
module.  Routing follows the JAX package: a block whose sequence is long
enough goes through the fused kernels (``_block_fast``: K1 → K2 → K3);
everything else runs the plain composition here.  ``kernels=False``
forces the plain composition everywhere (the JAX package's non-Pallas
path).  Type VL (the fused VL pass, with its split-per-modality
recursion and per-half experts) comes with ROADMAP A4.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import reference_attention
from ..ops.fused_block import fused_eval_block
from .layers import gelu, layer_norm, linear
from .spec import BlockSpec, ModelSpec, Params, L, V

LN_EPS = 1e-6  # partial(nn.LayerNorm, eps=1e-6); vision_transformer.py:831

# Shortest sequence routed to the fused kernels.  256 is the JAX
# package's routing (mome.py:237, ops/attention.py PACKED_MIN_N), kept for
# parity: the image tower (577 tokens @384) takes the kernels and the text
# tower (40 tokens) the plain path.  It is not an H100 measurement.
KERNEL_MIN_N = 256


def _qkv_bias(params: Params, prefix: str) -> torch.Tensor:
    q_bias = params[f"{prefix}.q_bias"]
    return torch.cat([q_bias, torch.zeros_like(q_bias),
                      params[f"{prefix}.v_bias"]])


def attention(params: Params, prefix: str, x: torch.Tensor,
              mask: Optional[torch.Tensor], rel_bias: Optional[torch.Tensor],
              num_heads: int, logits_dtype=torch.float32) -> torch.Tensor:
    """Multi-head self-attention with fp32 logits (plain path).

    x: (B, N, C); mask: (B, N) 1=valid; rel_bias: (heads, N, N) fp32.
    reference: vision_transformer.py:329-363."""
    B, N, C = x.shape
    head_dim = C // num_heads
    qkv = linear(x, params[f"{prefix}.qkv.weight"], _qkv_bias(params, prefix),
                 dtype=x.dtype)
    qkv = qkv.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    out = reference_attention(qkv[0], qkv[1], qkv[2], rel_bias, mask,
                              head_dim ** -0.5, logits_dtype=logits_dtype)
    out = out.transpose(1, 2).reshape(B, N, C)
    return linear(out, params[f"{prefix}.proj.weight"],
                  params[f"{prefix}.proj.bias"], dtype=x.dtype)


def mlp(params: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """fc1 → GELU → fc2 (dropout rate is 0 in eval)."""
    h = gelu(linear(x, params[f"{prefix}.fc1.weight"],
                    params[f"{prefix}.fc1.bias"], dtype=x.dtype))
    return linear(h, params[f"{prefix}.fc2.weight"],
                  params[f"{prefix}.fc2.bias"], dtype=x.dtype)


_TASK_OF_TYPE = {V: "v", L: "l"}


def _expert(b: BlockSpec, type_id: int, which: str) -> str:
    """Name suffix of the expert a type-V or type-L sequence routes
    through ("" for a shared module): one attention, MLP or LN call."""
    experts = {"attn": b.attn_experts, "mlp": b.mlp_experts,
               "norm1": b.norm1_experts, "norm2": b.norm2_experts}[which]
    return f".{_TASK_OF_TYPE[type_id]}" if experts else ""


def _ln(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, params[f"{name}.weight"], params[f"{name}.bias"],
                      eps=LN_EPS)


def _block_fast(params, spec, b, x, mask, rel_bias, type_id, *,
                kernels: bool):
    """Whole eval block through the fused kernels (ops/fused_block.py):
    LN1+qkv → packed attention → proj+LayerScale+residual+LN2+MLP+
    LayerScale+residual.  Returns None when the kernels are off, the
    sequence is shorter than KERNEL_MIN_N, or the attention is not the
    f32-logit, head_dim-64, biased and masked form the kernel computes.

    The JAX package also requires N % 16 == 0 and an even head count
    (TPU sublane and head-pair tiling); the CUDA kernels mask the ragged
    sequence edge and take one head per block, so neither applies."""
    N = x.shape[1]
    if (not kernels or N < KERNEL_MIN_N or rel_bias is None or mask is None
            or spec.attention_logits_dtype != "f32"
            or spec.hidden_size // spec.num_heads != 64):
        return None
    p = f"transformer.blocks.{b.index}"
    ap = f"{p}.attn{_expert(b, type_id, 'attn')}"
    mp = f"{p}.mlp{_expert(b, type_id, 'mlp')}"
    n1 = f"{p}.norm1{_expert(b, type_id, 'norm1')}"
    n2 = f"{p}.norm2{_expert(b, type_id, 'norm2')}"
    return fused_eval_block(
        x, params[f"{n1}.weight"], params[f"{n1}.bias"],
        params[f"{ap}.qkv.weight"], _qkv_bias(params, ap), rel_bias, mask,
        spec.head_dim ** -0.5, spec.num_heads, params[f"{ap}.proj.weight"],
        params[f"{ap}.proj.bias"], params[f"{p}.gamma_1"],
        params[f"{n2}.weight"], params[f"{n2}.bias"],
        params[f"{mp}.fc1.weight"], params[f"{mp}.fc1.bias"],
        params[f"{mp}.fc2.weight"], params[f"{mp}.fc2.bias"],
        params[f"{p}.gamma_2"])


def block_forward(params: Params, spec: ModelSpec, b: BlockSpec,
                  x: torch.Tensor, mask: Optional[torch.Tensor],
                  rel_bias: Optional[torch.Tensor], type_id: int, *,
                  kernels: bool = True) -> torch.Tensor:
    """One MoME eval block over a single-modality sequence, type V or L
    (vision_transformer.py:683-691 dispatch; plain :525-530,
    separate_plain and moe experts :560-654 reduce to one expert per
    module for one modality)."""
    if type_id not in _TASK_OF_TYPE:
        raise NotImplementedError(
            "type-VL blocks (the fused VL pass) are not ported yet: "
            "ROADMAP A4")
    fast = _block_fast(params, spec, b, x, mask, rel_bias, type_id,
                       kernels=kernels)
    if fast is not None:
        return fast

    p = f"transformer.blocks.{b.index}"
    ldt = torch.bfloat16 if spec.attention_logits_dtype == "bf16" \
        else torch.float32
    x_ = _ln(params, f"{p}.norm1{_expert(b, type_id, 'norm1')}", x)
    branch = attention(params, f"{p}.attn{_expert(b, type_id, 'attn')}", x_,
                       mask, rel_bias, spec.num_heads, logits_dtype=ldt)
    x = x + params[f"{p}.gamma_1"].to(branch.dtype) * branch
    x_ = _ln(params, f"{p}.norm2{_expert(b, type_id, 'norm2')}", x)
    branch = mlp(params, f"{p}.mlp{_expert(b, type_id, 'mlp')}", x_)
    return x + params[f"{p}.gamma_2"].to(branch.dtype) * branch
