"""MoME (Mixture-of-Modality-Experts) transformer block (port of
``vl_merging_tpu/models/mome.py``).

Numerics follow the reference: BEiT-style qkv bias (learnable q/v bias,
frozen zero k bias; vision_transformer.py:332-337), fp32 attention logits
with additive relative-position bias and -inf padding mask
(vision_transformer.py:346-355), LayerScale residuals (gamma_1/gamma_2),
and, in training, stochastic depth folded into the LayerScale as a
per-sample (2, B) scale.

Ported: block types V and L (single-modality sequences), for which every
routing mode (plain, separate_plain, moe) reduces to one expert per
module.  Routing follows the JAX package under its kernel flag
(``kernels``):
  * eval: a block whose sequence is long enough goes through the fused
    eval kernels (``_block_fast``: K1 → K2 → K3);
  * otherwise (every training block, and the short text blocks of the
    eval) the block is composed of LN, the qkv projection, attention
    (``packed_fused_attention``, K2 forward + K9 backward, when the
    sequence is long enough; the plain path otherwise), the proj
    projection, LN and the MLP (``fused_mlp``, K13, when the block has
    at least ``MLP_MIN_ROWS`` rows; the plain path otherwise).
``kernels=False`` forces the plain composition everywhere (the JAX
package's non-Pallas path).  Type VL (the fused VL pass, with its
split-per-modality recursion and per-half experts) comes with ROADMAP A4.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import packed_fused_attention, reference_attention
from ..ops.fused_block import fused_eval_block
from ..ops.mlp import fused_mlp, reference_mlp
from .layers import layer_norm, linear
from .spec import BlockSpec, ModelSpec, Params, L, V

LN_EPS = 1e-6  # partial(nn.LayerNorm, eps=1e-6); vision_transformer.py:831

# Shortest sequence routed to the attention kernels.  256 is the JAX
# package's routing (mome.py:237, ops/attention.py PACKED_MIN_N), kept for
# parity: the image tower (577 tokens @384) takes the kernels and the text
# tower (40 tokens) the plain path.  It is not an H100 measurement.
KERNEL_MIN_N = 256
# Fewest rows (B·N) routed to the MLP kernel K13: the JAX package's row
# gate (ops/mlp.py:_kernel_ok, BLOCK_M), kept for parity; its VMEM term is
# a TPU limit and does not carry over.  The text blocks of the eval (64
# captions x 40 tokens) and of training (32 x 40) pass it.
MLP_MIN_ROWS = 256


def _qkv_bias(params: Params, prefix: str) -> torch.Tensor:
    q_bias = params[f"{prefix}.q_bias"]
    return torch.cat([q_bias, torch.zeros_like(q_bias),
                      params[f"{prefix}.v_bias"]])


def _attention_kernel_ok(spec: ModelSpec, N: int, mask, rel_bias,
                         kernels: bool) -> bool:
    """Whether a block's attention takes the packed kernels: on under the
    kernel flag for sequences of at least KERNEL_MIN_N tokens in the
    f32-logit, head_dim-64, biased and masked form the kernels compute.
    The JAX package also requires N % 16 == 0 and an even head count (TPU
    sublane and head-pair tiling); the CUDA kernels mask the ragged
    sequence edge and take one head per block, so neither applies."""
    return (kernels and N >= KERNEL_MIN_N and rel_bias is not None
            and mask is not None and spec.attention_logits_dtype == "f32"
            and spec.hidden_size // spec.num_heads == 64)


def attention(params: Params, spec: ModelSpec, prefix: str, x: torch.Tensor,
              mask: Optional[torch.Tensor], rel_bias: Optional[torch.Tensor],
              *, kernels: bool) -> torch.Tensor:
    """Multi-head self-attention with fp32 logits, differentiable.

    x: (B, N, C); mask: (B, N) 1=valid; rel_bias: (heads, N, N) fp32.
    reference: vision_transformer.py:329-363."""
    B, N, C = x.shape
    H = spec.num_heads
    scale = spec.head_dim ** -0.5
    qkv = linear(x, params[f"{prefix}.qkv.weight"], _qkv_bias(params, prefix),
                 dtype=x.dtype)
    if _attention_kernel_ok(spec, N, mask, rel_bias, kernels):
        out = packed_fused_attention(qkv, rel_bias, mask, scale, H)
    else:
        ldt = torch.bfloat16 if spec.attention_logits_dtype == "bf16" \
            else torch.float32
        qkv = qkv.reshape(B, N, 3, H, spec.head_dim).permute(2, 0, 3, 1, 4)
        out = reference_attention(qkv[0], qkv[1], qkv[2], rel_bias, mask,
                                  scale, logits_dtype=ldt)
        out = out.transpose(1, 2).reshape(B, N, C)
    return linear(out, params[f"{prefix}.proj.weight"],
                  params[f"{prefix}.proj.bias"], dtype=x.dtype)


def mlp(params: Params, prefix: str, x: torch.Tensor, *,
        kernels: bool) -> torch.Tensor:
    """fc1 → GELU → fc2 (dropout rate is 0 in every reference config):
    through K13 under the kernel flag when the block has at least
    MLP_MIN_ROWS rows (mome.py:103-116 with ops/mlp.py:209-225)."""
    args = (x, params[f"{prefix}.fc1.weight"], params[f"{prefix}.fc1.bias"],
            params[f"{prefix}.fc2.weight"], params[f"{prefix}.fc2.bias"])
    if kernels and x.shape[0] * x.shape[1] >= MLP_MIN_ROWS:
        return fused_mlp(*args)
    return reference_mlp(*args)


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
    LayerScale+residual.  Returns None when the attention does not take
    the kernels (``_attention_kernel_ok``)."""
    if not _attention_kernel_ok(spec, x.shape[1], mask, rel_bias, kernels):
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


def _residual(x: torch.Tensor, branch: torch.Tensor, gamma: torch.Tensor,
              dp_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x + γ ⊙ branch; with a per-sample stochastic-depth scale (B,), the
    scale is folded into γ as one (B, 1, C) operand (mome.py:445-453)."""
    g = gamma.to(branch.dtype)
    if dp_scale is None:
        return x + g * branch
    return x + branch * (dp_scale[:, None, None].to(branch.dtype) * g)


def block_forward(params: Params, spec: ModelSpec, b: BlockSpec,
                  x: torch.Tensor, mask: Optional[torch.Tensor],
                  rel_bias: Optional[torch.Tensor], type_id: int, *,
                  kernels: bool = True, train: bool = False,
                  dp_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MoME block over a single-modality sequence, type V or L
    (vision_transformer.py:683-691 dispatch; plain :525-530,
    separate_plain and moe experts :560-654 reduce to one expert per
    module for one modality).  ``dp_scale``: the block's (2, B)
    stochastic-depth scales in training (``model._dp_scale_table``), or
    None."""
    if type_id not in _TASK_OF_TYPE:
        raise NotImplementedError(
            "type-VL blocks (the fused VL pass) are not ported yet: "
            "ROADMAP A4")
    if not train:
        fast = _block_fast(params, spec, b, x, mask, rel_bias, type_id,
                           kernels=kernels)
        if fast is not None:
            return fast
        dp_scale = None
    p = f"transformer.blocks.{b.index}"
    x_ = _ln(params, f"{p}.norm1{_expert(b, type_id, 'norm1')}", x)
    branch = attention(params, spec, f"{p}.attn{_expert(b, type_id, 'attn')}",
                       x_, mask, rel_bias, kernels=kernels)
    x = _residual(x, branch, params[f"{p}.gamma_1"],
                  None if dp_scale is None else dp_scale[0])
    x_ = _ln(params, f"{p}.norm2{_expert(b, type_id, 'norm2')}", x)
    branch = mlp(params, f"{p}.mlp{_expert(b, type_id, 'mlp')}", x_,
                 kernels=kernels)
    return _residual(x, branch, params[f"{p}.gamma_2"],
                     None if dp_scale is None else dp_scale[1])
