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
module, and type VL (the fused [text; image] sequence of ``model.infer``,
``vl_merging_tpu/models/mome.py:125-221, :401-427``): a block without a vl
expert that attends per modality (separate_plain, moe with
self_attn_for_single_mode) runs its text half as a type-L block and its
image half as a type-V block; a deep block with vl experts (or shared
modules) runs the joint sequence through one expert per module, like a
type-V block; the rest (ln_moe's per-half LayerNorms, moe's "both
attention experts over all tokens") take the composed path with their
per-half experts.  Routing follows the JAX package under its kernel flag
(``kernels``):
  * eval: a block whose sequence is long enough goes through the fused
    eval kernels (``_block_fast``: by the route ``fusion`` names, "pair"
    K1 → K2 → K4 → K5, "tail" K1 → K2 → K3, "qkv" K8 → K3 or "mega" K7;
    in the W8A8 int8 eval, when the params carry int8 companions, K14 →
    K2 or K12 → K15, and ``fusion`` must be "tail");
  * training under the training fusion (``train_fusion`` "tail" or
    "full", ``_block_fast_train``, whatever ``kernels`` says, as in the
    JAX package): LN1 + qkv (through K1 under "full"), the attention as
    below, and the post-attention half through K6 with the
    stochastic-depth scales folded into per-element gammas;
  * otherwise (every other training block, and the blocks of the eval
    too short for ``_block_fast``) the block is composed of LN, the qkv
    projection, attention (``_attend``: ``packed_fused_attention``, K2
    forward + K9 backward, at ``KERNEL_MIN_N`` tokens or more; else
    ``fused_attention``, K11 or K10 forward, at ``SPLIT_MIN_N`` tokens or
    more, as every block of a @224 image tower; the plain path below),
    the proj projection, LN and the MLP (``fused_mlp``, K13, when the
    block has at least ``MLP_MIN_ROWS`` rows; the plain path otherwise).
``kernels=False`` forces the plain composition everywhere (the JAX
package's non-Pallas path) except under the training fusion.  A
width-specific kernel (K1, K3–K8, K13–K15) is taken only at a width it is
built for (``ops.fused_block.kernel_takes``): the default route and the
training fusion fall back to the plain ops elsewhere, an opt-in route
raises (``eval_route_built``), as a pure function of shapes.  Under a
gram tap (``models/taps.py``) the blocks take the composed path, the
attention kernels included, and tap the module inputs the JAX package
taps; the eval and training fusions and K13 stay off.  The port does not
pad a fused sequence per segment (the JAX package's TPU sublane pad): a
split block's halves are the text and image tokens themselves, each
routed by its own length.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..ops.attention import HEAD_DIM, fused_attention, \
    packed_fused_attention
from ..ops.fused_block import check_fusion, check_train_fusion, \
    fused_eval_block, kernel_takes, ln_linear_train, proj_mlp_tail_train, \
    require_kernel, tail_reference
from ..ops.int8 import INT8_SUFFIX, SCALE_SUFFIX, fused_eval_block_i8
from ..ops.mlp import fused_mlp, reference_mlp
from .layers import layer_norm, linear
from .spec import BlockSpec, ModelSpec, Params, L, V, VL
from .taps import tap_add, tapping

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


# The width-specific kernels of each eval-block route (beside its attention
# kernel, K2 or, inside K8 and K7, their own), and of the int8 eval block.
ROUTE_KERNELS = {"pair": ("ln_linear", "linear_residual", "mlp_tail"),
                 "tail": ("ln_linear", "proj_mlp_tail"),
                 "qkv": ("ln_qkv_attention", "proj_mlp_tail"),
                 "mega": ("block_eval",)}
INT8_KERNELS = ("ln_linear_i8", "proj_mlp_tail_i8")


def eval_route_built(C: int, hidden: int, fusion: str,
                     int8: bool = False) -> bool:
    """Whether an eval block of width C and MLP hidden ``hidden`` whose
    attention takes the kernels goes through them by the route ``fusion``
    (or the int8 block): True when every width-specific kernel of the
    route is built for the width (``ops.fused_block.kernel_takes``).  The
    default route "tail" is False otherwise, and the block takes the
    plain composition, as the JAX package takes XLA where its kernels'
    shape gates fail (C=192 of the vit-tiny configs).  An opt-in route
    (another ``fusion``, or the int8 eval) whose kernel is not built for
    the width raises ``ValueError`` naming the kernel and the width, before
    any launch: the port never switches a chosen route silently."""
    names = INT8_KERNELS if int8 else ROUTE_KERNELS[fusion]
    missing = [k for k in names if not kernel_takes(k, C, hidden)]
    if not missing:
        return True
    if fusion == "tail" and not int8:
        return False
    require_kernel(missing[0], C, hidden)
    return False  # unreachable: require_kernel raised


def _mlp_kernel_ok(C: int, hidden: int, rows: int, kernels: bool) -> bool:
    """Whether an MLP takes K13: under the kernel flag, at MLP_MIN_ROWS
    rows or more, at a width and hidden K13 is built for."""
    return kernels and rows >= MLP_MIN_ROWS and kernel_takes("mlp", C, hidden)


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


def _attend(spec: ModelSpec, qkv: torch.Tensor, mask: Optional[torch.Tensor],
            rel_bias: Optional[torch.Tensor], *,
            kernels: bool) -> torch.Tensor:
    """The attention context (B, N, C) of a packed qkv (B, N, 3C),
    differentiable (``vl_merging_tpu/models/mome.py:74-95``): the packed
    kernels K2/K9 when ``_attention_kernel_ok``, else ``fused_attention``
    over the split (B, H, N, d) views, which takes K11 or K10 under the
    kernel flag for f32 logits, head_dim 64 and N >= SPLIT_MIN_N, and the
    plain path otherwise."""
    B, N, threeC = qkv.shape
    H = spec.num_heads
    scale = spec.head_dim ** -0.5
    if _attention_kernel_ok(spec, N, mask, rel_bias, kernels):
        return packed_fused_attention(qkv, rel_bias, mask, scale, H)
    ldt = torch.bfloat16 if spec.attention_logits_dtype == "bf16" \
        else torch.float32
    q, k, v = qkv.reshape(B, N, 3, H, spec.head_dim).permute(2, 0, 3, 1, 4)
    out = fused_attention(q, k, v, rel_bias, mask, scale,
                          kernels=kernels and spec.head_dim == HEAD_DIM,
                          logits_dtype=ldt)
    return out.transpose(1, 2).reshape(B, N, threeC // 3)


def attention(params: Params, spec: ModelSpec, prefix: str, x: torch.Tensor,
              mask: Optional[torch.Tensor], rel_bias: Optional[torch.Tensor],
              *, kernels: bool) -> torch.Tensor:
    """Multi-head self-attention with fp32 logits, differentiable.

    x: (B, N, C); mask: (B, N) 1=valid; rel_bias: (heads, N, N) fp32.
    reference: vision_transformer.py:329-363.  Gram taps: the module input
    (post-LN) as ``prefix``, the context as ``prefix.proj``
    (``vl_merging_tpu/models/mome.py:64, :97``)."""
    tap_add(prefix, x)
    qkv = linear(x, params[f"{prefix}.qkv.weight"], _qkv_bias(params, prefix),
                 dtype=x.dtype)
    out = _attend(spec, qkv, mask, rel_bias, kernels=kernels)
    tap_add(f"{prefix}.proj", out)
    return linear(out, params[f"{prefix}.proj.weight"],
                  params[f"{prefix}.proj.bias"], dtype=x.dtype)


def mlp(params: Params, prefix: str, x: torch.Tensor, *,
        kernels: bool) -> torch.Tensor:
    """fc1 → GELU → fc2 (dropout rate is 0 in every reference config):
    through K13 under the kernel flag when the block has at least
    MLP_MIN_ROWS rows and K13 is built for its width and hidden
    (mome.py:103-116 with ops/mlp.py:209-225, ``_mlp_kernel_ok``).  Under
    a gram tap it is ``reference_mlp`` with the fc1 input and the GELU
    output tapped as ``prefix.fc1`` and ``prefix.fc2`` (mome.py:112-120)."""
    args = (x, params[f"{prefix}.fc1.weight"], params[f"{prefix}.fc1.bias"],
            params[f"{prefix}.fc2.weight"], params[f"{prefix}.fc2.bias"])
    if tapping():
        tap_add(f"{prefix}.fc1", x)
        return reference_mlp(
            *args, on_hidden=lambda h: tap_add(f"{prefix}.fc2", h))
    if _mlp_kernel_ok(x.shape[-1], args[1].shape[0], x.shape[0] * x.shape[1],
                      kernels):
        return fused_mlp(*args)
    return reference_mlp(*args)


_TASK_OF_TYPE = {V: "v", L: "l", VL: "vl"}


def _expert(b: BlockSpec, type_id: int, which: str) -> Optional[str]:
    """Name suffix of the expert a sequence of ``type_id`` routes through
    in one attention, MLP or LN call ("" for a shared module); None when a
    fused (VL) sequence without a vl expert needs the per-modality experts
    of both halves (``vl_merging_tpu/models/mome.py:_single_expert_suffix``)."""
    experts = {"attn": b.attn_experts, "mlp": b.mlp_experts,
               "norm1": b.norm1_experts, "norm2": b.norm2_experts}[which]
    if not experts:
        return ""
    if type_id in (V, L) or b.has_vl:
        return f".{_TASK_OF_TYPE[type_id]}"
    return None


def _block_names(b: BlockSpec, type_id: int) -> Optional[Tuple[str, ...]]:
    """The block's prefix and the names of its attention, MLP, norm1 and
    norm2 experts for a whole-block fusion, or None when a fused sequence
    needs per-half experts (``_expert``)."""
    sfx = [_expert(b, type_id, w) for w in ("attn", "mlp", "norm1", "norm2")]
    if None in sfx:
        return None
    p = f"transformer.blocks.{b.index}"
    return (p,) + tuple(f"{p}.{w}{x}" for w, x in zip(
        ("attn", "mlp", "norm1", "norm2"), sfx))


def _ln(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    tap_add(name, x)  # gram tap: the norm's input (mome.py:129)
    return layer_norm(x, params[f"{name}.weight"], params[f"{name}.bias"],
                      eps=LN_EPS)


def _halves(x: torch.Tensor, text_len: int):
    """The text and image halves of a fused (B, N, ...) sequence, each
    contiguous, as the kernels take their operands."""
    return x[:, :text_len].contiguous(), x[:, text_len:].contiguous()


def apply_ln(params: Params, p: str, base: str, b: BlockSpec, type_id: int,
             x: torch.Tensor, text_len: int) -> torch.Tensor:
    """The block's LayerNorm ``base`` ("norm1" or "norm2"): shared, one
    expert, or, on a fused input without a vl expert, the l and v experts
    each over its half (mome.py:134-146), each half tapped by its own
    name."""
    sfx = _expert(b, type_id, base)
    if sfx is not None:
        return _ln(params, f"{p}.{base}{sfx}", x)
    return torch.cat([_ln(params, f"{p}.{base}.l", x[:, :text_len]),
                      _ln(params, f"{p}.{base}.v", x[:, text_len:])], dim=1)


def _block_fast(params, spec, b, x, mask, rel_bias, type_id, *,
                kernels: bool, int8_gelu: str = "poly",
                qk_int8: bool = False, fusion: str = "tail"):
    """Whole eval block through the fused kernels (ops/fused_block.py):
    LN1+qkv → packed attention → proj+LayerScale+residual+LN2+MLP+
    LayerScale+residual, by the route ``fusion`` names
    (``fused_eval_block``; the JAX package reads it from its module
    gates); with ``spec.eval_int8`` and the int8 companions of
    ``quantize_eval_params`` in params, the int8 block of ops/int8.py
    (mome.py:258-275, taken before any fusion gate is read), whose MLP
    activation is ``int8_gelu`` and whose attention is K12 when
    ``qk_int8``; it has one route, so ``fusion`` must be "tail" there.
    Returns None when the attention does not take the kernels
    (``_attention_kernel_ok``), when a fused sequence needs per-half
    experts (``_expert``), or when the default route's kernels are not
    built for the block's width (``eval_route_built``, which raises for an
    opt-in route)."""
    if not _attention_kernel_ok(spec, x.shape[1], mask, rel_bias, kernels):
        return None
    names = _block_names(b, type_id)
    if names is None:
        return None
    p, ap, mp, n1, n2 = names
    scale = spec.head_dim ** -0.5
    int8 = spec.eval_int8 and f"{ap}.qkv.weight{INT8_SUFFIX}" in params
    if int8 and fusion != "tail":
        raise ValueError(f"fusion {fusion!r}: the int8 eval block has one "
                         f"route, 'tail'")
    if not eval_route_built(x.shape[-1], params[f"{mp}.fc1.weight"].shape[0],
                            fusion, int8):
        return None
    if int8:

        def qw(name):
            return (params[f"{name}.weight{INT8_SUFFIX}"],
                    params[f"{name}.weight{SCALE_SUFFIX}"])

        return fused_eval_block_i8(
            x, params[f"{n1}.weight"], params[f"{n1}.bias"], *qw(f"{ap}.qkv"),
            _qkv_bias(params, ap), rel_bias, mask, scale, spec.num_heads,
            *qw(f"{ap}.proj"), params[f"{ap}.proj.bias"],
            params[f"{p}.gamma_1"], params[f"{n2}.weight"],
            params[f"{n2}.bias"], *qw(f"{mp}.fc1"), params[f"{mp}.fc1.bias"],
            *qw(f"{mp}.fc2"), params[f"{mp}.fc2.bias"],
            params[f"{p}.gamma_2"], gelu=int8_gelu, qk_int8=qk_int8)
    return fused_eval_block(
        x, params[f"{n1}.weight"], params[f"{n1}.bias"],
        params[f"{ap}.qkv.weight"], _qkv_bias(params, ap), rel_bias, mask,
        scale, spec.num_heads, params[f"{ap}.proj.weight"],
        params[f"{ap}.proj.bias"], params[f"{p}.gamma_1"],
        params[f"{n2}.weight"], params[f"{n2}.bias"],
        params[f"{mp}.fc1.weight"], params[f"{mp}.fc1.bias"],
        params[f"{mp}.fc2.weight"], params[f"{mp}.fc2.bias"],
        params[f"{p}.gamma_2"], fusion=fusion)


def _block_fast_train(params, spec, b, x, mask, rel_bias, type_id, dp_scale,
                      *, kernels: bool, train_fusion: str):
    """A training block through the training fusion
    (``vl_merging_tpu/models/mome.py:292-372``): LN1 + qkv through
    ``ln_linear_train`` (K1 forward) under "full", the plain LN → linear
    under "tail"; the attention as ``attention`` dispatches it
    (``_attend``); the whole post-attention half through
    ``proj_mlp_tail_train`` (K6 forward) with γ1, γ2 and the block's
    stochastic-depth scales folded into per-element effective gammas
    (B, 1, C), unit scales without a dp table (the JAX package's
    mome.py:312-315).  The backwards recompute the unfused composition,
    so the gradients are the unfused path's.  At a width K1 or K6 is not
    built for (``kernel_takes``), that step is its plain composition
    (``tail_reference``: the function K6's backward differentiates), as
    the JAX package's ``proj_mlp_tail_train`` takes ``_tail_reference``
    where its shape gate fails.  Returns None where a fused sequence needs
    per-half experts (``_expert``)."""
    names = _block_names(b, type_id)
    if names is None:
        return None
    p, ap, mp, n1, n2 = names
    if dp_scale is None:
        dp_scale = torch.ones((2, x.shape[0]), dtype=torch.float32,
                              device=x.device)
    C, H = x.shape[-1], params[f"{mp}.fc1.weight"].shape[0]
    if train_fusion == "full" and kernel_takes("ln_linear", C):
        qkv = ln_linear_train(x, params[f"{n1}.weight"], params[f"{n1}.bias"],
                              params[f"{ap}.qkv.weight"],
                              _qkv_bias(params, ap))
    else:
        qkv = linear(_ln(params, n1, x), params[f"{ap}.qkv.weight"],
                     _qkv_bias(params, ap), dtype=x.dtype)
    ctx = _attend(spec, qkv, mask, rel_bias, kernels=kernels)

    def g_eff(s: int, gamma: str) -> torch.Tensor:
        return dp_scale[s][:, None, None].to(x.dtype) * \
            params[gamma].to(x.dtype)

    tail = proj_mlp_tail_train if kernel_takes("tail_train", C, H) \
        else tail_reference
    return tail(
        ctx, params[f"{ap}.proj.weight"], params[f"{ap}.proj.bias"],
        g_eff(0, f"{p}.gamma_1"), x, params[f"{n2}.weight"],
        params[f"{n2}.bias"], params[f"{mp}.fc1.weight"],
        params[f"{mp}.fc1.bias"], params[f"{mp}.fc2.weight"],
        params[f"{mp}.fc2.bias"], g_eff(1, f"{p}.gamma_2"))


def _residual(x: torch.Tensor, branch: torch.Tensor, gamma: torch.Tensor,
              dp_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x + γ ⊙ branch; with a per-sample stochastic-depth scale (B,), the
    scale is folded into γ as one (B, 1, C) operand (mome.py:445-453)."""
    g = gamma.to(branch.dtype)
    if dp_scale is None:
        return x + g * branch
    return x + branch * (dp_scale[:, None, None].to(branch.dtype) * g)


def _attn_part(params: Params, spec: ModelSpec, p: str, b: BlockSpec,
               x: torch.Tensor, mask, rel_bias, type_id: int, text_len: int,
               *, kernels: bool) -> torch.Tensor:
    """LN1 + attention, the branch before its residual (mome.py:150-183):
    one attention expert (or the shared one) over the sequence; for a
    fused sequence without a vl expert, both the l and v experts over all
    tokens, the text half of the first and the image half of the second
    (moe without self_attn_for_single_mode, vision_transformer.py:
    639-649)."""
    x_ = apply_ln(params, p, "norm1", b, type_id, x, text_len)
    sfx = _expert(b, type_id, "attn")
    if sfx is not None:
        return attention(params, spec, f"{p}.attn{sfx}", x_, mask, rel_bias,
                         kernels=kernels)
    ot = attention(params, spec, f"{p}.attn.l", x_, mask, rel_bias,
                   kernels=kernels)
    oi = attention(params, spec, f"{p}.attn.v", x_, mask, rel_bias,
                   kernels=kernels)
    return torch.cat([ot[:, :text_len], oi[:, text_len:]], dim=1)


def _mlp_part(params: Params, p: str, b: BlockSpec, x: torch.Tensor,
              type_id: int, text_len: int, *, kernels: bool) -> torch.Tensor:
    """LN2 + MLP, the branch before its residual (mome.py:186-208): one MLP
    expert (or the shared one), or, for a fused sequence without a vl
    expert, the l and v experts each over its half."""
    x_ = apply_ln(params, p, "norm2", b, type_id, x, text_len)
    sfx = _expert(b, type_id, "mlp")
    if sfx is not None:
        return mlp(params, f"{p}.mlp{sfx}", x_, kernels=kernels)
    xt, xi = _halves(x_, text_len)
    return torch.cat([mlp(params, f"{p}.mlp.l", xt, kernels=kernels),
                      mlp(params, f"{p}.mlp.v", xi, kernels=kernels)], dim=1)


# A layer's rel-pos bias: one (H, N, N) tensor over the block's sequence,
# or, for a split VL block, the (text, image) pair of its sub-blocks,
# gathered apart (``model.fused_layer_biases``) so that each is contiguous.
LayerBias = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def splits(b: BlockSpec, type_id: int) -> bool:
    """Whether a block runs a fused sequence as its text half (type L) and
    image half (type V): a block without a vl expert that attends per
    modality (separate_plain, moe self_attn_for_single_mode, moe without
    attention experts under separate_inference; mome.py:406-427)."""
    return type_id == VL and not b.has_vl and b.self_attn_single


def _split_bias(rel_bias: Optional[LayerBias], text_len: int):
    if rel_bias is None:
        return None, None
    if isinstance(rel_bias, tuple):
        return rel_bias
    return (rel_bias[:, :text_len, :text_len].contiguous(),
            rel_bias[:, text_len:, text_len:].contiguous())


def block_forward(params: Params, spec: ModelSpec, b: BlockSpec,
                  x: torch.Tensor, mask: Optional[torch.Tensor],
                  rel_bias: Optional[LayerBias], type_id: int, *,
                  kernels: bool = True, train: bool = False,
                  dp_scale: Optional[torch.Tensor] = None,
                  int8_gelu: str = "poly",
                  qk_int8: bool = False,
                  fusion: str = "tail",
                  train_fusion: str = "0",
                  text_len: Optional[int] = None) -> torch.Tensor:
    """One MoME block (vision_transformer.py:683-691 dispatch; plain
    :525-530, separate_plain :560-605 and moe :607-654).  ``dp_scale``:
    the block's (2, B) stochastic-depth scales in training
    (``model._dp_scale_table``), or None.  ``int8_gelu`` and ``qk_int8``
    reach the int8 eval block, ``fusion`` (one of
    ``ops.fused_block.FUSIONS``) the eval block's route (``_block_fast``),
    ``train_fusion`` (one of ``ops.fused_block.TRAIN_FUSIONS``) the
    training block's (``_block_fast_train`` unless "0"; the JAX package
    reads it from ``VLM_TPU_TRAIN_FUSION``).

    Type VL: the text tokens lead; ``text_len`` is inferred from the shape
    when not given (``spec.max_text_len``, or what the image leaves of a
    vl-truncated sequence; mome.py:401-404).  ``rel_bias`` of a split
    block (``splits``) may be the (text, image) pair of its sub-blocks
    (``LayerBias``); a (H, N, N) tensor is sliced and copied here."""
    check_fusion(fusion)
    check_train_fusion(train_fusion)
    if type_id == VL and text_len is None:
        text_len = spec.max_text_len
        if x.shape[1] != text_len + spec.image_len:
            text_len = x.shape[1] - spec.image_len
    kw = dict(kernels=kernels, train=train, dp_scale=dp_scale,
              int8_gelu=int8_gelu, qk_int8=qk_int8, fusion=fusion,
              train_fusion=train_fusion)
    if splits(b, type_id):
        # the text half as a type-L block, the image half as a type-V one:
        # modality-local attention, the same γ and stochastic-depth scales
        bt, bi = _split_bias(rel_bias, text_len)
        (xt, xi), (mt, mi) = _halves(x, text_len), (
            (None, None) if mask is None else _halves(mask, text_len))
        return torch.cat([block_forward(params, spec, b, xt, mt, bt, L, **kw),
                          block_forward(params, spec, b, xi, mi, bi, V, **kw)],
                         dim=1)
    # a gram tap needs the tapped inputs: no whole-block fusion under it
    # (mome.py:235, :310); the attention kernels stay
    fuse = not tapping()
    if train and train_fusion != "0" and fuse:
        fast = _block_fast_train(params, spec, b, x, mask, rel_bias, type_id,
                                 dp_scale, kernels=kernels,
                                 train_fusion=train_fusion)
        if fast is not None:
            return fast
    if not train:
        fast = _block_fast(params, spec, b, x, mask, rel_bias, type_id,
                           kernels=kernels, int8_gelu=int8_gelu,
                           qk_int8=qk_int8, fusion=fusion) if fuse else None
        if fast is not None:
            return fast
        dp_scale = None
    p = f"transformer.blocks.{b.index}"
    branch = _attn_part(params, spec, p, b, x, mask, rel_bias, type_id,
                        text_len, kernels=kernels)
    x = _residual(x, branch, params[f"{p}.gamma_1"],
                  None if dp_scale is None else dp_scale[0])
    branch = _mlp_part(params, p, b, x, type_id, text_len, kernels=kernels)
    return _residual(x, branch, params[f"{p}.gamma_2"],
                     None if dp_scale is None else dp_scale[1])
