"""Fused eval-block kernels (port of ``vl_merging_tpu/ops/fused_block.py``
and of ``ops/attention.py:ln_qkv_attention``).

  * ``ln_linear``        — y = LN(x)·Wᵀ + b (pre-norm + qkv), kernel K1,
                           ``csrc/ln_linear.cu``
  * ``linear_residual``  — y = res + γ ⊙ (x·Wᵀ + b) (proj + LayerScale +
                           residual), kernel K4, ``csrc/linear_residual.cu``
  * ``mlp_tail``         — y = x + γ ⊙ fc2(GELU(fc1(LN(x)))), kernel K5,
                           ``csrc/mlp_tail.cu``
  * ``proj_mlp_tail``    — proj + LayerScale + residual + LN2 + MLP +
                           LayerScale + residual, kernel K3,
                           ``csrc/proj_mlp_tail.cu`` (or K4 → K5)
  * ``ln_qkv_attention`` — LN1 + qkv projection + attention in one launch,
                           kernel K8, ``csrc/ln_qkv_attention.cu`` (K1's
                           and K2's code as two roles of one persistent
                           grid, the packed qkv handed over through L2)
  * ``block_eval``       — a whole eval block in one launch, kernel K7,
                           ``csrc/block_eval.cu``
  * ``tail_train``       — ``proj_mlp_tail`` with per-element gammas
                           (B, 1, C) (LayerScale times each element's
                           stochastic-depth scale), kernel K6,
                           ``csrc/tail_train.cu``; with
                           ``proj_mlp_tail_train`` (K6 forward, the
                           autograd VJP of ``tail_reference`` backward) and
                           ``ln_linear_train`` (K1 forward, the VJP of the
                           plain LN → linear backward) it is the training
                           fusion, ``train_fusion`` "tail" or "full"
                           (``TRAIN_FUSIONS``; the JAX package's
                           ``VLM_TPU_TRAIN_FUSION``);
  * ``fused_eval_block`` — a whole eval block by one of four routes,
                           ``fusion`` (the JAX package's module gates
                           ``_FUSE_WHOLE_TAIL``, ``_FUSE_EVAL_BLOCK`` and
                           ``attention._FUSE_LN_QKV_ATTN``; ``bench.py``'s
                           names): "pair" K1 → K2 → K4 → K5, "tail" (the
                           default) K1 → K2 → K3, "qkv" K8 → K3, "mega" K7.

Each wrapper launches its CUDA kernel on CUDA tensors, or raises for
inputs the kernel does not take; on CPU tensors it runs its plain twin
(``*_reference``), which computes with the kernel's rounding points: LN
statistics in f32 with eps 1e-6, operands rounded to the activation dtype,
f32 accumulation and f32 bias/LayerScale/residual arithmetic.  The four
routes round at the same points, so their twins agree bit for bit.
Weights use torch layout (out, in).  ``<wrapper>.launches`` counts kernel
launches.

Reference semantics: vision_transformer.py:489-530 (LayerScale residuals),
:272-296 (Mlp), :831 (eps=1e-6).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import layer_norm, linear
from . import _build
from .attention import HEAD_DIM, packed_attention, \
    packed_attention_reference, recompute_vjp

LN_EPS = 1e-6
_HIDDEN_CHUNK = 128           # the MLP body walks the hidden in chunks
# ln_linear's output tile width at each model width it is built for: O
# must be a multiple of it (K1's 128 x 256 tiles; qkv: O = 3C = 2304, 3072)
_QKV_TILE = {768: 256, 1024: 256}
# The model widths each width-specific kernel is built for (the CUDA
# entries' ``switch (C)``): every one at the ViT-B and ViT-L widths.
# The attention kernels (K2, K9, K10, K11, K12) take any head count at
# head_dim 64 and are gated by ``models/mome._attention_kernel_ok``.
KERNEL_WIDTHS = {
    "ln_linear": (768, 1024), "proj_mlp_tail": (768, 1024),
    "linear_residual": (768, 1024), "mlp_tail": (768, 1024),
    "tail_train": (768, 1024), "mlp": (768, 1024),
    "ln_qkv_attention": (768, 1024), "block_eval": (768, 1024),
    "ln_linear_i8": (768, 1024), "proj_mlp_tail_i8": (768, 1024),
}
# the kernels that run an MLP, whose gate also reads the MLP hidden
_MLP_KERNELS = frozenset({"proj_mlp_tail", "mlp_tail", "block_eval",
                          "tail_train", "mlp", "proj_mlp_tail_i8"})
# K8's split of its grid between its two roles (``ln_qkv_attention_split``):
# per CTA, the time of one 64-deep k-step of K1's 128 x 256 tile and of one
# 64-key tile of K2's 128-query-row item, in µs, as K8's two roles take
# them side by side at B=32, N=577, C=768 on an H100 80GB HBM3 at 700 W
# (chip_profile.py --variants K8, its trace: the K1 role 22-23 tiles of 12
# k-steps in 0.40 ms on 58 CTAs, the K2 role 25-26 items of 10 key tiles
# in 0.40 ms of its 74 CTAs' time not spent waiting).  Only their ratio is
# read.
_K8_STEP_US, _K8_KEY_TILE_US = 1.47, 1.55
# K8's K1 role: column tiles of 256 per unit of work dealt to its CTA pairs
_K8_UNIT = 1
# K7's scratches: bb batch elements at a time, their packed qkv and context
# (bb·N·3C + bb·N·C bf16) within this many bytes (the H100's L2 holds 50 MB)
_SCRATCH_BYTES = 32 << 20
_BODY_ROWS = 64               # the rows of a block of the MLP body (K7's phase C)
FUSIONS = ("pair", "tail", "qkv", "mega")
# training-fusion levels: "0" off, "tail" the post-attention half through
# K6, "full" also LN1 + qkv through K1
TRAIN_FUSIONS = ("0", "tail", "full")


def kernel_takes(name: str, C: int, hidden: int = 0) -> bool:
    """Whether the width-specific kernel ``name`` (a key of
    ``KERNEL_WIDTHS``) takes model width C and, if it runs an MLP, MLP
    hidden ``hidden``: the JAX package's own shape gate (``_shapes_ok``,
    ``mlp._kernel_ok`` and ``proj_mlp_tail_train``'s check: C and the
    hidden multiples of 128; their VMEM terms are TPU limits and do not
    carry over) intersected with the widths the kernel is built for.  A
    pure function of shapes: the port's routing asks it before any
    launch."""
    return (C % 128 == 0 and C in KERNEL_WIDTHS[name]
            and (name not in _MLP_KERNELS or hidden % _HIDDEN_CHUNK == 0))


def require_kernel(name: str, C: int, hidden: int = 0) -> None:
    """Raise ``ValueError`` naming the kernel and the width unless
    ``kernel_takes(name, C, hidden)``."""
    if not kernel_takes(name, C, hidden):
        raise ValueError(
            f"kernel {name} is not built for C={C}"
            + (f", hidden={hidden}: it takes C in {KERNEL_WIDTHS[name]} and "
               f"a hidden that is a multiple of {_HIDDEN_CHUNK}"
               if name in _MLP_KERNELS else
               f": it takes C in {KERNEL_WIDTHS[name]}"))


def check_fusion(fusion: str) -> None:
    if fusion not in FUSIONS:
        raise ValueError(f"fusion {fusion!r}: one of {FUSIONS}")


def check_train_fusion(train_fusion: str) -> None:
    if train_fusion not in TRAIN_FUSIONS:
        raise ValueError(f"train_fusion {train_fusion!r}: one of "
                         f"{TRAIN_FUSIONS}")


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a·Wᵀ in f32 of operands rounded to a's dtype (torch layout W)."""
    return F.linear(a.float(), w.to(a.dtype).float())


def ln_linear_reference(x, ln_w, ln_b, w, b):
    """Plain twin of K1: bf16(LN(x)) · Wᵀ in f32, + b in f32, rounded."""
    xn = layer_norm(x, ln_w, ln_b, eps=LN_EPS)
    return (_mm(xn, w) + b.float()).to(x.dtype)


def require_qkv_tile(C: int, O: int) -> None:
    """Raise ``ValueError`` unless K1 takes model width C and O output
    columns: C a width it is built for, O a whole number of its tiles."""
    require_kernel("ln_linear", C)
    if O % _QKV_TILE[C]:
        raise ValueError(f"ln_linear kernel takes O % {_QKV_TILE[C]} == 0 "
                         f"at C={C}; got O={O}")


def ln_linear(x: torch.Tensor, ln_w, ln_b, w, b) -> torch.Tensor:
    """y = LN(x) @ Wᵀ + b; x: (B, N, C), w: (O, C) torch layout."""
    if not x.is_cuda:
        return ln_linear_reference(x, ln_w, ln_b, w, b)
    B, N, C = x.shape
    O = w.shape[0]
    require_qkv_tile(C, O)
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


def linear_residual_reference(x, w, b, gamma, res):
    """Plain twin of K4: res + γ ⊙ (x·Wᵀ + b) in f32, rounded once."""
    y = _mm(x, w) + b.float()
    return (res.float() + y * gamma.float()).to(x.dtype)


def linear_residual(x: torch.Tensor, w, b, gamma, res) -> torch.Tensor:
    """y = res + γ ⊙ (x @ Wᵀ + b); x, res: (B, N, C), w: (O, C), O = C."""
    if not x.is_cuda:
        return linear_residual_reference(x, w, b, gamma, res)
    B, N, C = x.shape
    O = w.shape[0]
    require_kernel("linear_residual", C)
    if O != C:
        raise ValueError(f"linear_residual kernel takes O == C; got C={C}, "
                         f"O={O}")
    w = w.to(x.dtype)
    b, gamma = b.float(), gamma.float()
    dev = x.device
    _build.expect(x, "x", torch.bfloat16, (B, N, C), dev)
    _build.expect(w, "w", torch.bfloat16, (O, C), dev)
    _build.expect(res, "res", torch.bfloat16, (B, N, O), dev)
    _build.expect(b, "b", torch.float32, (O,), dev)
    _build.expect(gamma, "gamma", torch.float32, (O,), dev)
    y = torch.empty((B, N, O), dtype=x.dtype, device=dev)
    lib = _build.library()
    _build.check(lib.vlm_linear_residual(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
        res.data_ptr(), y.data_ptr(), B * N, C, O,
        _build.stream_handle(dev)), "linear_residual")
    linear_residual.launches += 1
    return y


linear_residual.launches = 0


def mlp_tail_reference(x, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Plain twin of K5: LN(x) and gelu(fc1) rounded to x's dtype (exact
    erf, as K3's and K5's erff), everything else f32, rounded once."""
    dt = x.dtype
    xn = layer_norm(x, ln_w, ln_b, eps=LN_EPS)
    h = F.gelu(_mm(xn, w1) + b1.float()).to(dt)
    y = _mm(h, w2) + b2.float()
    return (x.float() + y * gamma.float()).to(dt)


def mlp_tail(x: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2,
             gamma) -> torch.Tensor:
    """y = x + γ ⊙ fc2(GELU(fc1(LN(x)))) with the MLP hidden kept on chip;
    x: (B, N, C)."""
    if not x.is_cuda:
        return mlp_tail_reference(x, ln_w, ln_b, w1, b1, w2, b2, gamma)
    B, N, C = x.shape
    H = w1.shape[0]
    require_kernel("mlp_tail", C, H)
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    vecs = [t.float() for t in (ln_w, ln_b, b1, b2, gamma)]
    dev = x.device
    _build.expect(x, "x", torch.bfloat16, (B, N, C), dev)
    _build.expect(w1, "w1", torch.bfloat16, (H, C), dev)
    _build.expect(w2, "w2", torch.bfloat16, (C, H), dev)
    for name, t in zip(("ln_w", "ln_b", "b1", "b2", "gamma"), vecs):
        _build.expect(t, name, torch.float32, (H if name == "b1" else C,),
                      dev)
    ln_w, ln_b, b1, b2, gamma = vecs
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check(lib.vlm_mlp_tail(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
        out.data_ptr(), B * N, C, H, LN_EPS, _build.stream_handle(dev)),
        "mlp_tail")
    mlp_tail.launches += 1
    return out


mlp_tail.launches = 0


def proj_mlp_tail_reference(ctx, wp, bp, gamma1, res, ln_w, ln_b, w1, b1,
                            w2, b2, gamma2):
    """Plain twin of K3, with its rounding points: x', LN2(x') and
    gelu(fc1) are rounded to the activation dtype; everything else is
    f32.  It is K4's twin followed by K5's, as K3 equals K4 → K5."""
    x1 = linear_residual_reference(ctx, wp, bp, gamma1, res)
    return mlp_tail_reference(x1, ln_w, ln_b, w1, b1, w2, b2, gamma2)


def proj_mlp_tail(ctx: torch.Tensor, wp, bp, gamma1, res, ln_w, ln_b, w1, b1,
                  w2, b2, gamma2, *, fusion: str = "tail") -> torch.Tensor:
    """y = x' + γ2 ⊙ fc2(GELU(fc1(LN(x')))) with
    x' = res + γ1 ⊙ (ctx @ Wpᵀ + bp): the whole post-attention half of a
    block, with x' and the MLP hidden kept on chip (K3); under
    ``fusion="pair"`` the split pair K4 → K5, which stores x' in bf16
    where K3 rounds it on chip (the same numbers)."""
    check_fusion(fusion)
    if fusion == "pair":
        x1 = linear_residual(ctx, wp, bp, gamma1, res)
        return mlp_tail(x1, ln_w, ln_b, w1, b1, w2, b2, gamma2)
    if not ctx.is_cuda:
        return proj_mlp_tail_reference(ctx, wp, bp, gamma1, res, ln_w, ln_b,
                                       w1, b1, w2, b2, gamma2)
    B, N, C = ctx.shape
    H = w1.shape[0]
    require_kernel("proj_mlp_tail", C, H)
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


def ln_qkv_attention_reference(x, ln_w, ln_b, w_qkv, qkv_bias, bias, mask,
                               scale, num_heads):
    """Plain twin of K8: K1's twin, then K2's (the qkv slices rounded to
    x's dtype where K1 stores them, q scaled in that dtype, f32 logits,
    bias, mask and softmax, the context rounded)."""
    qkv = ln_linear_reference(x, ln_w, ln_b, w_qkv, qkv_bias)
    return packed_attention_reference(qkv, bias, mask, scale, num_heads)


def _block_attention_inputs(name, x, ln_w, ln_b, w_qkv, qkv_bias, bias, mask,
                            num_heads):
    """Checks and casts the inputs K7 and K8 share; raises for what their
    kernels do not take."""
    B, N, C = x.shape
    require_kernel(name, C)
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"{name} kernel takes head_dim {HEAD_DIM}; got "
                         f"C={C}, heads={num_heads}")
    w_qkv = w_qkv.to(x.dtype)
    ln_w, ln_b, qkv_bias, bias = (t.float() for t in (ln_w, ln_b, qkv_bias,
                                                      bias))
    mask = mask.to(torch.int32)
    dev = x.device
    _build.expect(x, "x", torch.bfloat16, (B, N, C), dev)
    _build.expect(w_qkv, "w_qkv", torch.bfloat16, (3 * C, C), dev)
    _build.expect(ln_w, "ln_w", torch.float32, (C,), dev)
    _build.expect(ln_b, "ln_b", torch.float32, (C,), dev)
    _build.expect(qkv_bias, "qkv_bias", torch.float32, (3 * C,), dev)
    _build.expect(bias, "bias", torch.float32, (num_heads, N, N), dev)
    _build.expect(mask, "mask", torch.int32, (B, N), dev)
    return ln_w, ln_b, w_qkv, qkv_bias, bias, mask


@functools.cache
def ln_qkv_attention_grid(C: int) -> int:
    """The CTAs K8 launches at width C: as many whole clusters of two as
    the card holds at once (its handoff needs every CTA resident).
    Queried once per process and width."""
    return _build.library().vlm_ln_qkv_attention_grid(C)


def ln_qkv_attention_split(grid: int, B: int, N: int, C: int,
                           heads: int) -> int:
    """K8's CTAs that run K1's role (the rest of ``grid`` run K2's): an
    even share of the grid in proportion to that role's work, its 128-row
    x 256-column tiles times their 64-deep k-steps, against the K2 role's,
    its (element, 128 query rows, head) items times their 64-key tiles, at
    the per-unit times ``_K8_STEP_US`` and ``_K8_KEY_TILE_US``; at least
    one cluster of two for each role.  A pure function of shapes."""
    w1 = -(-B * N // 128) * (3 * C // 256) * (C // 64) * _K8_STEP_US
    w2 = B * heads * -(-N // 128) * -(-N // 64) * _K8_KEY_TILE_US
    return min(max(2 * round(grid / 2 * w1 / (w1 + w2)), 2), grid - 2)


def ln_qkv_attention(x: torch.Tensor, ln_w, ln_b, w_qkv, qkv_bias, bias,
                     mask, scale: float, num_heads: int, *,
                     split: Optional[int] = None, unit: int = _K8_UNIT,
                     delay_ns: int = 0,
                     trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ctx = attention(LN(x)·W_qkvᵀ + b) over x (B, N, C), with an f32
    (H, N, N) additive bias and a (B, N) key mask, in one launch (K8): K1's
    tiles on ``split`` CTAs (``ln_qkv_attention_split``), storing the
    packed qkv in a scratch, and K2's items on the rest, each element's
    once its rows are published.  The kernel takes head_dim 64 and any N.
    ``unit``: the K1 role's column tiles per unit of work (a divisor of
    3C/256); ``delay_ns`` (a test's): every K1 tile's stores held back that
    long; ``trace`` (a profiler's): a zeroed int64
    (``ln_qkv_attention_grid(C)``, 4) tensor on the device that receives
    each CTA's first and last time stamp (ns), its K2 role's ns waiting for
    elements, and its units (``csrc/ln_qkv_attention.cu``)."""
    if not x.is_cuda:
        return ln_qkv_attention_reference(x, ln_w, ln_b, w_qkv, qkv_bias,
                                          bias, mask, scale, num_heads)
    B, N, C = x.shape
    ln_w, ln_b, w_qkv, qkv_bias, bias, mask = _block_attention_inputs(
        "ln_qkv_attention", x, ln_w, ln_b, w_qkv, qkv_bias, bias, mask,
        num_heads)
    dev = x.device
    grid = ln_qkv_attention_grid(C)
    if grid < 4:
        raise RuntimeError(f"ln_qkv_attention: the card holds {grid // 2} "
                           f"clusters of K8's CTAs at once; it needs two")
    if split is None:
        split = ln_qkv_attention_split(grid, B, N, C, num_heads)
    qkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=dev)
    # the counters of the handoff (per element, per 128-row block) and the
    # rows' LN statistics
    done = torch.empty(B + -(-B * N // 128), dtype=torch.int32, device=dev)
    stats = torch.empty(2 * B * N, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check(lib.vlm_ln_qkv_attention(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w_qkv.data_ptr(),
        qkv_bias.data_ptr(), bias.data_ptr(), mask.data_ptr(),
        qkv.data_ptr(), done.data_ptr(), stats.data_ptr(), out.data_ptr(),
        0 if trace is None else trace.data_ptr(), B, N, num_heads,
        grid, split, unit, delay_ns, float(scale), LN_EPS,
        _build.stream_handle(dev)), "ln_qkv_attention")
    ln_qkv_attention.launches += 1
    return out


ln_qkv_attention.launches = 0


def block_eval_reference(x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask, scale,
                         num_heads, wp, bp, gamma1, ln2_w, ln2_b, w1, b1, w2,
                         b2, gamma2):
    """Plain twin of K7: the staged twins in sequence (K1, K2, K3)."""
    ctx = ln_qkv_attention_reference(x, ln1_w, ln1_b, w_qkv, qkv_bias, bias,
                                     mask, scale, num_heads)
    return proj_mlp_tail_reference(ctx, wp, bp, gamma1, x, ln2_w, ln2_b, w1,
                                   b1, w2, b2, gamma2)


def block_eval_chunk(B: int, N: int, C: int, clusters: int) -> int:
    """K7's chunk: the bb batch elements whose packed qkv and context
    (bb·N·3C + bb·N·C bf16) fit ``_SCRATCH_BYTES``, taking the fewest
    rounds of 64-row body blocks (its longest phase) over ``clusters``
    resident clusters, summed over the chunks; the largest such bb on a
    tie.  A pure function of shapes."""
    most = max(1, min(B, _SCRATCH_BYTES // (4 * N * C * 2)))

    def rounds(nb: int) -> int:
        blocks = -(-nb * N // _BODY_ROWS)
        return -(-blocks // max(1, clusters))

    def total(bb: int) -> int:
        full, rest = divmod(B, bb)
        return full * rounds(bb) + (rounds(rest) if rest else 0)

    return min(range(1, most + 1), key=lambda bb: (total(bb), -bb))


def block_eval(x: torch.Tensor, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask,
               scale, num_heads, wp, bp, gamma1, ln2_w, ln2_b, w1, b1, w2,
               b2, gamma2, *, trace: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """One whole eval block in one launch (K7), per chunk of
    ``block_eval_chunk`` batch elements: K1's LN1 + qkv tiles into a
    scratch, a grid-wide barrier, K2's attention items into a second
    scratch, a barrier, the MLP body's post-attention half per 64-row
    block (K3's), a barrier.  ``trace`` (a profiler's): a zeroed int64
    (``block_eval_grid(C)``, 12) tensor on the device that receives each
    CTA's phase trace (``csrc/block_eval.cu``: ns in phases A, B and C
    and at the barrier after each; K1 tiles of its pair, K2 items, body
    blocks; first and last stamp; chunks)."""
    if not x.is_cuda:
        return block_eval_reference(x, ln1_w, ln1_b, w_qkv, qkv_bias, bias,
                                    mask, scale, num_heads, wp, bp, gamma1,
                                    ln2_w, ln2_b, w1, b1, w2, b2, gamma2)
    B, N, C = x.shape
    H = w1.shape[0]
    require_kernel("block_eval", C, H)
    ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask = _block_attention_inputs(
        "block_eval", x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask,
        num_heads)
    wp, w1, w2 = (w.to(x.dtype) for w in (wp, w1, w2))
    vecs = [t.float() for t in (bp, gamma1, ln2_w, ln2_b, b1, b2, gamma2)]
    dev = x.device
    _build.expect(wp, "wp", torch.bfloat16, (C, C), dev)
    _build.expect(w1, "w1", torch.bfloat16, (H, C), dev)
    _build.expect(w2, "w2", torch.bfloat16, (C, H), dev)
    for name, t in zip(("bp", "gamma1", "ln2_w", "ln2_b", "b1", "b2",
                        "gamma2"), vecs):
        _build.expect(t, name, torch.float32, (H if name == "b1" else C,),
                      dev)
    bp, gamma1, ln2_w, ln2_b, b1, b2, gamma2 = vecs
    grid = block_eval_grid(C)
    bb = block_eval_chunk(B, N, C, grid // 4)
    scratch = torch.empty((bb, N, 4 * C), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check(lib.vlm_block_eval(
        x.data_ptr(), ln1_w.data_ptr(), ln1_b.data_ptr(), w_qkv.data_ptr(),
        qkv_bias.data_ptr(), bias.data_ptr(), mask.data_ptr(), wp.data_ptr(),
        bp.data_ptr(), gamma1.data_ptr(), ln2_w.data_ptr(), ln2_b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        gamma2.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        0 if trace is None else trace.data_ptr(), B, N, num_heads, H, bb,
        grid, float(scale), LN_EPS, _build.stream_handle(dev)), "block_eval")
    block_eval.launches += 1
    return out


block_eval.launches = 0


@functools.cache
def block_eval_grid(C: int) -> int:
    """The CTAs K7 launches at width C: as many whole clusters of four as
    the card holds at once (its grid-wide barriers need every CTA
    resident).  Queried once per process and width."""
    return _build.library().vlm_block_eval_grid(C)


def fused_eval_block(x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask, scale,
                     num_heads, wp, bp, gamma1, ln2_w, ln2_b, w1, b1, w2,
                     b2, gamma2, *, fusion: str = "tail"):
    """One whole eval transformer block by the route ``fusion`` names
    (``vl_merging_tpu/ops/fused_block.py:fused_eval_block`` with its
    module gates): "pair" K1 → K2 → K4 → K5, "tail" K1 → K2 → K3, "qkv"
    K8 → K3, "mega" K7.  All four round at the same points."""
    check_fusion(fusion)
    attn = (x, ln1_w, ln1_b, w_qkv, qkv_bias, bias, mask, scale, num_heads)
    if fusion == "mega":
        return block_eval(*attn, wp, bp, gamma1, ln2_w, ln2_b, w1, b1, w2, b2,
                          gamma2)
    if fusion == "qkv":
        ctx = ln_qkv_attention(*attn)
    else:
        qkv = ln_linear(x, ln1_w, ln1_b, w_qkv, qkv_bias)
        ctx = packed_attention(qkv, bias, mask, scale, num_heads)
    return proj_mlp_tail(ctx, wp, bp, gamma1, x, ln2_w, ln2_b, w1, b1, w2, b2,
                         gamma2, fusion=fusion)


# --------------------------------------------------------------------------
# The training fusion (vl_merging_tpu/ops/fused_block.py:275-425): kernel
# forwards, backwards that recompute the unfused composition, so that
# gradients are the unfused path's autograd at the same inputs.
# --------------------------------------------------------------------------

def ln_linear_train_reference(x, ln_w, ln_b, w, b):
    """The unfused LN → linear of the training blocks (the JAX package's
    ``_ln_linear_ref``): LN rounded to x's dtype, the product rounded,
    the bias added in x's dtype."""
    return linear(layer_norm(x, ln_w, ln_b, eps=LN_EPS), w, b, dtype=x.dtype)


class _LnLinearTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, b):
        ctx.save_for_backward(x, ln_w, ln_b, w, b)
        return ln_linear(x, ln_w, ln_b, w, b)

    @staticmethod
    def backward(ctx, g):
        return recompute_vjp(ln_linear_train_reference, ctx.saved_tensors,
                             ctx.needs_input_grad, g)


def ln_linear_train(x, ln_w, ln_b, w, b) -> torch.Tensor:
    """Differentiable LN1 + qkv for the training forward
    (``vl_merging_tpu/ops/fused_block.py:ln_linear_train``): K1 (its twin
    on CPU tensors) forward, the autograd VJP of
    ``ln_linear_train_reference`` at the saved inputs backward."""
    return _LnLinearTrain.apply(x, ln_w, ln_b, w, b)


def tail_train_reference(ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1, w2, b2,
                         g2):
    """Plain twin of K6: K3's twin (``proj_mlp_tail_reference``, the same
    rounding points) with g1 and g2 the (B, 1, C) effective gammas, each
    element's rows scaled by its own."""
    return proj_mlp_tail_reference(ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1,
                                   w2, b2, g2)


def tail_train(ctx: torch.Tensor, wp, bp, g1, res, ln_w, ln_b, w1, b1, w2,
               b2, g2) -> torch.Tensor:
    """K6: ``proj_mlp_tail`` over ctx, res (B, N, C) with per-element
    gammas g1, g2 (B, 1, C); row r of the flattened rows reads the gammas
    of element r // N."""
    if not ctx.is_cuda:
        return tail_train_reference(ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1,
                                    w2, b2, g2)
    B, N, C = ctx.shape
    H = w1.shape[0]
    require_kernel("tail_train", C, H)
    for name, g in (("g1", g1), ("g2", g2)):
        if tuple(g.shape) != (B, 1, C):
            raise ValueError(f"tail_train: {name} of shape {tuple(g.shape)}, "
                             f"expected {(B, 1, C)}")
    g1, g2 = (g.reshape(B, C).float().contiguous() for g in (g1, g2))
    wp, w1, w2 = (w.to(ctx.dtype) for w in (wp, w1, w2))
    vecs = [t.float() for t in (bp, ln_w, ln_b, b1, b2)]
    dev = ctx.device
    _build.expect(ctx, "ctx", torch.bfloat16, (B, N, C), dev)
    _build.expect(res, "res", torch.bfloat16, (B, N, C), dev)
    _build.expect(wp, "wp", torch.bfloat16, (C, C), dev)
    _build.expect(w1, "w1", torch.bfloat16, (H, C), dev)
    _build.expect(w2, "w2", torch.bfloat16, (C, H), dev)
    _build.expect(g1, "g1", torch.float32, (B, C), dev)
    _build.expect(g2, "g2", torch.float32, (B, C), dev)
    for name, t in zip(("bp", "ln_w", "ln_b", "b1", "b2"), vecs):
        _build.expect(t, name, torch.float32, (H if name == "b1" else C,),
                      dev)
    bp, ln_w, ln_b, b1, b2 = vecs
    out = torch.empty_like(ctx)
    lib = _build.library()
    _build.check(lib.vlm_tail_train(
        ctx.data_ptr(), res.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        g1.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g2.data_ptr(),
        out.data_ptr(), B * N, N, C, H, LN_EPS, _build.stream_handle(dev)),
        "tail_train")
    tail_train.launches += 1
    return out


tail_train.launches = 0


def tail_reference(ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1, w2, b2, g2):
    """The unfused post-attention half of a training block, exactly as the
    unfused train path computes it (the JAX package's ``_tail_reference``):
    the proj output rounded to the block dtype before the multiply by the
    (B, 1, C) effective γ1 in that dtype, the residual in that dtype, LN2,
    ``reference_mlp`` (exact erf) and the γ2 residual likewise."""
    from .mlp import reference_mlp

    y = linear(ctx, wp, bp, dtype=ctx.dtype)
    x1 = res + y * g1.to(y.dtype)
    y2 = reference_mlp(layer_norm(x1, ln_w, ln_b, eps=LN_EPS), w1, b1, w2, b2)
    return x1 + y2 * g2.to(y2.dtype)


class _TailTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return tail_train(*args)

    @staticmethod
    def backward(ctx, g):
        return recompute_vjp(tail_reference, ctx.saved_tensors,
                             ctx.needs_input_grad, g)


def proj_mlp_tail_train(ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1, w2, b2,
                        g2) -> torch.Tensor:
    """Differentiable post-attention half of a training block
    (``vl_merging_tpu/ops/fused_block.py:proj_mlp_tail_train``): K6 (its
    twin on CPU tensors) forward, the autograd VJP of ``tail_reference`` at
    the saved inputs backward.  As in the JAX package, forward and backward
    are different compositions of the same function."""
    return _TailTrain.apply(ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1, w2, b2,
                            g2)
