"""Attention: the plain reference and the packed-qkv kernels (port of
``vl_merging_tpu/ops/attention.py``).

``reference_attention`` is the plain path (the text tower and every block
off the kernel route use it).  ``packed_attention`` is kernel K2,
``csrc/packed_attention_fwd.cu``: attention read straight from the packed
(B, N, 3C) qkv projection, writing the context as (B, N, C).
``packed_attention_bwd`` is kernel K9, ``csrc/packed_attention_bwd.cu``:
its backward, (dqkv, dbias summed over the batch).
``packed_fused_attention`` joins them into one differentiable function
(the JAX package's ``_packed_attention_diff``).  ``packed_attention_i8qk``
is kernel K12, ``csrc/packed_attention_i8qk.cu`` (K2's device code with
its int8 q·kᵀ policy): QKᵀ as s8·s8→s32 on
per-(token, head) int8 q and k (``quant_rows``, the quantizer of every
int8 kernel), for the int8 eval's opt-in int8-QK mode; eval only.  On
CPU tensors each wrapper runs its plain twin (``packed_attention_reference``,
the JAX package's ``_packed_reference``; ``packed_attention_bwd_reference``;
``packed_attention_i8qk_reference``, its ``_packed_reference_i8qk``).

The split layout: ``split_attention`` is kernel K10 and
``split_attention_bb`` kernel K11, ``csrc/split_attention.cu``: attention
over q, k, v of shape (B, H, N, 64), read through strides (K2's device
code over 4-D tensor maps), so the (B, H, N, 64) views of a packed qkv
need no copy.  Their plain twin is
``split_attention_reference`` (``reference_attention`` with f32 logits,
the rounding points of the JAX package's ``_mha_kernel``).
``fused_attention`` is the JAX package's dispatcher: the plain path below
``SPLIT_MIN_N`` tokens, for bf16 logits or without the kernel flag, else
K11 or K10 forward (``_pallas_dispatch``'s choice) and the autograd VJP of
``reference_attention`` as the backward (``_pad_bwd``).
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIM = 64  # the only head width the attention kernels take
# Shortest sequence fused_attention sends to the split kernels, and the
# longest K11 takes (else K10): the JAX package's routing
# (ops/attention.py MIN_PALLAS_N and _pallas_dispatch, whose block_b = 4
# fits the TPU's VMEM for N <= 640), kept for parity.  Neither is an H100
# measurement.
SPLIT_MIN_N = 128
SPLIT_BB = 4
SPLIT_BB_MAX_N = 640


def _f32_aligned(bias: torch.Tensor) -> torch.Tensor:
    """The f32 bias as the kernels read it: contiguous and 16-byte aligned.
    A layer's slice of the (L, H, N, N) table is aligned only when H·N·N is
    a multiple of 4 (not at H = 3, N = 197 or 577: the vit-tiny towers),
    and is copied then."""
    bias = bias.float().contiguous()
    return bias if bias.data_ptr() % 16 == 0 else bias.clone()


def recompute_vjp(fn: Callable, saved: Sequence[torch.Tensor],
                  needs: Sequence[bool], g: torch.Tensor, *extra):
    """The autograd VJP of ``fn(*saved, *extra)`` at the saved inputs, for
    a backward that recomputes the plain composition: one gradient (or
    None) per saved tensor, as ``needs`` asks."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = fn(*inputs, *extra)
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], g))
    return tuple(next(grads) if n else None for n in needs)


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


def packed_attention_stats_reference(qkv, bias, mask, scale: float,
                                     num_heads: int) -> torch.Tensor:
    """The softmax statistics of K2's training launch, plainly: each query
    row's max m of the biased, masked f32 logits and its sum
    l = Σ exp(s - m) over the valid keys, as a (2, B, H, N) f32 tensor
    (m = -inf and l = 0 on a row with no valid key)."""
    B, N, threeC = qkv.shape
    C = threeC // 3
    q, k, _ = (_heads(t, num_heads) for t in qkv.split(C, dim=-1))
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) + \
        bias[None].float()
    s = s.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    m = s.amax(-1)
    l = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None]) \
        .sum(-1)
    return torch.stack([m, l])


def packed_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor, scale: float, num_heads: int, *,
                     with_stats: bool = False):
    """Fused attention over packed qkv (B, N, 3C) → context (B, N, C), with
    an f32 (H, N, N) additive bias and a (B, N) key mask.  The kernel
    takes any N (it masks the ragged edge itself) and head_dim 64.  With
    ``with_stats`` (the training launch) it returns (context, stats), stats
    the (2, B, H, N) f32 softmax max and sum of every query row that K9
    reads (``packed_attention_stats_reference`` on CPU tensors)."""
    if not qkv.is_cuda:
        out = packed_attention_reference(qkv, bias, mask, scale, num_heads)
        if with_stats:
            return out, packed_attention_stats_reference(qkv, bias, mask,
                                                         scale, num_heads)
        return out
    B, N, threeC = qkv.shape
    C = threeC // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"packed_attention kernel takes head_dim "
                         f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    bias = _f32_aligned(bias)
    mask = mask.to(torch.int32)
    dev = qkv.device
    _build.expect(qkv, "qkv", torch.bfloat16, (B, N, 3 * C), dev)
    _build.expect(bias, "bias", torch.float32, (num_heads, N, N), dev)
    _build.expect(mask, "mask", torch.int32, (B, N), dev)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    stats = torch.empty((2, B, num_heads, N), dtype=torch.float32,
                        device=dev) if with_stats else None
    lib = _build.library()
    _build.check(lib.vlm_packed_attention(
        qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
        0 if stats is None else stats.data_ptr(), B, N, num_heads,
        float(scale), _build.stream_handle(dev)), "packed_attention")
    packed_attention.launches += 1
    packed_attention.launches_at[N] += 1
    return (out, stats) if with_stats else out


# launches, in all and by sequence length
packed_attention.launches = 0
packed_attention.launches_at = collections.Counter()


def quant_rows(x32: torch.Tensor):
    """Per-row symmetric int8 over the trailing dim: f32 (..., n) →
    (int8 (..., n), f32 scale (..., 1)), scale = max(amax, 1e-8)/127 and
    q = round-half-even(x · (1/scale)), no clip: |x/scale| ≤ 127 by
    construction (``vl_merging_tpu/ops/int8.py:_quant_rows``,
    ``attention.py:_quant_last_i8``).  The quantizer of K12, K14 and
    K15."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: PyTorch's CUDA kernels divide by a CPU scalar as a
    # multiply by its f32 reciprocal, which can round the scale differently
    scale = amax.clamp_min(1e-8) / amax.new_tensor(127.0)
    return torch.round(x32 * (1.0 / scale)).to(torch.int8), scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 @ int8 → int32 for the plain twins.  ``torch.matmul`` of
    int8 tensors returns int8 and wraps, so the CPU multiplies in int32;
    on the card, which has no general int32 matmul, in float64, exact for
    sums below 2⁵³ (|Σ| ≤ 127²·K)."""
    if a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.int(), b.int())


def packed_attention_i8qk_reference(qkv, bias, mask, scale: float,
                                    num_heads: int) -> torch.Tensor:
    """Plain twin of K12 (``vl_merging_tpu/ops/attention.py:
    _packed_reference_i8qk``): q and k quantized per (token, head) row of
    64, logits = (si · (sq·scale)) · skᵀ in f32, + bias, masked keys at
    -inf, f32 softmax, probabilities in qkv's dtype contracted with v in
    f32; (B, N, 3C) → (B, N, C)."""
    B, N, threeC = qkv.shape
    C = threeC // 3
    q, k, v = (_heads(t, num_heads) for t in qkv.split(C, dim=-1))
    qi, sq = quant_rows(q.float())
    ki, sk = quant_rows(k.float())
    si = int8_matmul(qi, ki.transpose(-1, -2))
    s = si.float() * (sq * scale) * sk.transpose(-1, -2)
    s = s + bias[None].float()
    s = s.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, N, C)


def packed_attention_i8qk(qkv: torch.Tensor, bias: torch.Tensor,
                          mask: torch.Tensor, scale: float,
                          num_heads: int) -> torch.Tensor:
    """K12: ``packed_attention`` with QKᵀ as s8·s8→s32 on per-(token, head)
    int8 q and k, the opt-in int8-QK mode of the int8 eval.  Eval only:
    it has no backward and raises on a qkv that requires grad."""
    if qkv.requires_grad:
        raise ValueError("packed_attention_i8qk is eval only (no backward)")
    if not qkv.is_cuda:
        return packed_attention_i8qk_reference(qkv, bias, mask, scale,
                                               num_heads)
    B, N, threeC = qkv.shape
    C = threeC // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"packed_attention_i8qk kernel takes head_dim "
                         f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    bias = _f32_aligned(bias)
    mask = mask.to(torch.int32)
    dev = qkv.device
    _build.expect(qkv, "qkv", torch.bfloat16, (B, N, 3 * C), dev)
    _build.expect(bias, "bias", torch.float32, (num_heads, N, N), dev)
    _build.expect(mask, "mask", torch.int32, (B, N), dev)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    lib = _build.library()
    _build.check(lib.vlm_packed_attention_i8qk(
        qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, N, num_heads, float(scale), _build.stream_handle(dev)),
        "packed_attention_i8qk")
    packed_attention_i8qk.launches += 1
    return out


packed_attention_i8qk.launches = 0


def packed_attention_bwd_reference(qkv, bias, mask, g, stats,
                                   scale: float, num_heads: int):
    """Plain twin of K9 with its rounding points
    (``vl_merging_tpu/ops/attention.py:_packed_bwd_kernel``): q pre-scaled
    in its dtype, the biased and masked f32 logits s, p = exp(s - m)/l from
    the forward's softmax statistics ``stats`` (m, l: (2, B, H, N) f32;
    p = 0 on a row with l = 0, no valid key), dv = cast(p)ᵀ·g,
    ds = p ⊙ (dp − D) in f32 with D = Σ_k dp ⊙ p in f32 (0 where p = 0),
    dq = cast(ds)·k · scale, dk = cast(ds)ᵀ·q, all products accumulated
    in f32.  Returns (dqkv (B, N, 3C) in qkv's dtype, dbias
    (H, N, N) f32 summed over the batch)."""
    B, N, threeC = qkv.shape
    C = threeC // 3
    dt = qkv.dtype
    q, k, v = (_heads(t, num_heads) for t in qkv.split(C, dim=-1))
    qs = q * torch.tensor(scale, dtype=dt)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) + \
        bias[None].float()
    s = s.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    m, l = stats[0].float(), stats[1].float()
    live = (l > 0)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, m[..., None], 0.0))
                    / torch.where(live, l[..., None], 1.0), 0.0)
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
                         mask: torch.Tensor, g: torch.Tensor,
                         stats: torch.Tensor, scale: float, num_heads: int):
    """K9: the backward of ``packed_attention`` → (dqkv (B, N, 3C),
    dbias (H, N, N) f32 summed over the batch).  ``g`` is the context
    gradient (B, N, C), contiguous, and ``stats`` the (2, B, H, N) softmax
    statistics of the forward's training launch.
    The kernel takes any N and head_dim 64, reads a copy of the bias whose
    rows are padded to whole 64-key tiles (aligned pairs: a 16 MB copy at
    N = 577, 12 heads), and sums dbias over at most four batch groups whose
    partials (rows padded to 4 floats) it adds in a fixed order (no
    atomics)."""
    if not qkv.is_cuda:
        return packed_attention_bwd_reference(qkv, bias, mask, g, stats,
                                              scale, num_heads)
    B, N, threeC = qkv.shape
    C = threeC // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"packed_attention_bwd kernel takes head_dim "
                         f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    bias = _f32_aligned(bias)
    mask = mask.to(torch.int32)
    dev = qkv.device
    _build.expect(qkv, "qkv", torch.bfloat16, (B, N, 3 * C), dev)
    _build.expect(bias, "bias", torch.float32, (num_heads, N, N), dev)
    _build.expect(mask, "mask", torch.int32, (B, N), dev)
    _build.expect(g, "g", torch.bfloat16, (B, N, C), dev)
    _build.expect(stats, "stats", torch.float32, (2, B, num_heads, N), dev)
    ldb = -(-N // 64) * 64
    bias_rows = F.pad(bias, (0, ldb - N))
    lib = _build.library()
    groups = lib.vlm_packed_attention_bwd_groups(B)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((num_heads, N, N), dtype=torch.float32, device=dev)
    # m and l from the forward, and a plane for the kernel's D
    st = torch.cat([stats, torch.empty_like(stats[:1])])
    part = torch.empty((groups, num_heads, N, -(-N // 4) * 4),
                       dtype=torch.float32, device=dev)
    _build.check(lib.vlm_packed_attention_bwd(
        qkv.data_ptr(), bias_rows.data_ptr(), mask.data_ptr(), g.data_ptr(),
        dqkv.data_ptr(), dbias.data_ptr(), st.data_ptr(),
        part.data_ptr(), B, N, num_heads, ldb, groups, float(scale),
        _build.stream_handle(dev)), "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    packed_attention_bwd.launches_at[N] += 1
    return dqkv, dbias


# launches, in all and by sequence length
packed_attention_bwd.launches = 0
packed_attention_bwd.launches_at = collections.Counter()


class _PackedFusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, num_heads):
        out, stats = packed_attention(qkv, bias, mask, scale, num_heads,
                                      with_stats=True)
        ctx.save_for_backward(qkv, bias, mask, stats)
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask, stats = ctx.saved_tensors
        dqkv, dbias = packed_attention_bwd(qkv, bias, mask, g.contiguous(),
                                           stats, ctx.scale, ctx.num_heads)
        return dqkv, dbias.to(bias.dtype), None, None, None


def packed_fused_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: torch.Tensor, scale: float,
                           num_heads: int) -> torch.Tensor:
    """Differentiable packed attention: K2 forward (its training launch,
    which also keeps each query row's softmax statistics), K9 backward
    (their twins on CPU tensors).  Gradients reach qkv and the bias; the
    mask gets none."""
    return _PackedFusedAttention.apply(qkv, bias, mask, scale, num_heads)


def split_attention_reference(q, k, v, bias, mask, scale: float):
    """Plain twin of K10 and K11 (``vl_merging_tpu/ops/attention.py:
    _mha_kernel``): q scaled in its dtype, f32 logits + the f32 bias, masked
    keys at -inf, f32 softmax, probabilities cast to q's dtype and
    contracted with v in f32, rounded; (B, H, N, d) in and out."""
    return reference_attention(q, k, v, bias, mask, scale)


@functools.cache
def _split_strides(entry: str, q_shape, k_shape, v_shape, q_stride,
                   k_stride, v_stride, dtypes, devices, bias_shape,
                   mask_shape) -> tuple:
    """The 12 strides K10 and K11 take, (element, head, token) of q, k, v
    and the (B, N, H, 64) output seen as (B, H, N, 64), once the layout is
    checked: bf16 q, k, v of one shape (B, H, N, 64) with a contiguous head
    dim and positive strides that are multiples of 8 (16-byte rows for the
    tensor maps), an f32 bias (H, N, N) and an int32 mask (B, N), all on
    one device.  Cached per layout (it depends on no value); a layout that
    fails raises each time."""
    B, H, N, d = q_shape
    if d != HEAD_DIM:
        raise ValueError(f"{entry}: the kernel takes head_dim {HEAD_DIM}; "
                         f"got {d}")
    want = (B, H, N, d)
    for name, shape, stride, dtype in zip(("q", "k", "v"),
                                          (q_shape, k_shape, v_shape),
                                          (q_stride, k_stride, v_stride),
                                          dtypes):
        if dtype != torch.bfloat16 or tuple(shape) != want:
            raise ValueError(f"{entry}: {name} is {dtype} {tuple(shape)}; "
                             f"the kernel takes bf16 {want}")
        if stride[3] != 1 or any(s <= 0 or s % 8 for s in stride[:3]):
            raise ValueError(f"{entry}: {name} needs a contiguous head dim "
                             f"and positive strides that are multiples of "
                             f"8; got strides {stride}")
    if tuple(bias_shape) != (H, N, N) or tuple(mask_shape) != (B, N):
        raise ValueError(f"{entry}: bias {tuple(bias_shape)} and mask "
                         f"{tuple(mask_shape)}; the kernel takes {(H, N, N)} "
                         f"and {(B, N)}")
    if len(set(devices)) != 1:
        raise ValueError(f"{entry}: q, k, v, bias and mask on more than "
                         f"one of the devices {devices}")
    return (*q_stride[:3], *k_stride[:3], *v_stride[:3],
            N * H * d, d, H * d)


def _split_launch(entry: str, q, k, v, bias, mask, scale: float):
    """Check what K10 and K11 take, launch ``entry`` and return the
    context (B, H, N, 64) with the strides of a transposed (B, N, H, 64)
    tensor, so that ``.transpose(1, 2).reshape(B, N, C)`` needs no copy.
    What depends only on the layout is checked once per layout
    (``_split_strides``); a call checks the device and the 16-byte
    alignment of its pointers."""
    if bias.dtype != torch.float32 or not bias.is_contiguous() or \
            bias.data_ptr() % 16:
        bias = _f32_aligned(bias)
    if mask.dtype != torch.int32 or not mask.is_contiguous():
        mask = mask.to(torch.int32).contiguous()
    dev = q.device
    strides = _split_strides(
        entry, q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
        (q.dtype, k.dtype, v.dtype),
        (dev, k.device, v.device, bias.device, mask.device), bias.shape,
        mask.shape)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{entry}: {dev} is not the current CUDA device")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{entry}: q, k and v need 16-byte aligned starts")
    B, H, N, d = q.shape
    out = torch.empty_strided((B, H, N, d), (*strides[9:], 1), dtype=q.dtype,
                              device=dev)
    _build.check(getattr(_build.library(), entry)(
        *ptrs, bias.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N, H,
        *strides, float(scale), _build.stream_handle(dev)), entry)
    return out


def split_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, mask: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K10: attention over (B, H, N, 64) q, k, v (strides that are
    multiples of 8, a contiguous head dim) with an f32 (H, N, N) bias and a
    (B, N) key mask: K2's persistent kernel over 4-D tensor maps of q, k
    and v, so the same bits as K2 on the same values."""
    if not q.is_cuda:
        return split_attention_reference(q, k, v, bias, mask, scale)
    out = _split_launch("vlm_split_attention", q, k, v, bias, mask, scale)
    split_attention.launches += 1
    return out


split_attention.launches = 0


def split_attention_bb(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, mask: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """K11: ``split_attention`` for a batch that is a multiple of
    SPLIT_BB = 4 (the JAX package's ``block_b``), its own entry and launch
    count.  It runs K10's kernel: on the H100 a layer's bias stays in L2
    and K10's element-fastest items already run the CTAs that share a bias
    tile together (``csrc/split_attention.cu``).  The same bits as K10."""
    if not q.is_cuda:
        return split_attention_reference(q, k, v, bias, mask, scale)
    if q.shape[0] % SPLIT_BB:
        raise ValueError(f"split_attention_bb takes a batch that is a "
                         f"multiple of {SPLIT_BB}; got {q.shape[0]}")
    out = _split_launch("vlm_split_attention_bb", q, k, v, bias, mask, scale)
    split_attention_bb.launches += 1
    return out


split_attention_bb.launches = 0


def _split_dispatch(q, k, v, bias, mask, scale: float) -> torch.Tensor:
    """K11 for a batch that is a multiple of SPLIT_BB with N <=
    SPLIT_BB_MAX_N, else K10 (the JAX package's ``_pallas_dispatch``)."""
    B, _, N, _ = q.shape
    if B % SPLIT_BB == 0 and N <= SPLIT_BB_MAX_N:
        return split_attention_bb(q, k, v, bias, mask, scale)
    return split_attention(q, k, v, bias, mask, scale)


class _SplitFusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale = scale
        return _split_dispatch(q, k, v, bias, mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        grads = recompute_vjp(reference_attention, (q, k, v, bias),
                              ctx.needs_input_grad[:4], g, mask, ctx.scale)
        return grads + (None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    mask: Optional[torch.Tensor], scale: float, *,
                    kernels: bool,
                    logits_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Attention over split (B, H, N, d) q, k, v, differentiable
    (``vl_merging_tpu/ops/attention.py:fused_attention``): the plain path
    without the kernel flag, below SPLIT_MIN_N tokens or for bf16 logits;
    else K11 or K10 (their twin on CPU tensors) forward, with a zero bias
    and an all-ones mask where none is given, and the autograd VJP of
    ``reference_attention`` at the saved inputs as the backward (the JAX
    package's ``_pad_bwd``).  The mask gets no gradient."""
    B, H, N, _ = q.shape
    if not kernels or N < SPLIT_MIN_N or logits_dtype != torch.float32:
        return reference_attention(q, k, v, bias, mask, scale,
                                   logits_dtype=logits_dtype)
    if bias is None:
        bias = torch.zeros((H, N, N), dtype=torch.float32, device=q.device)
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.float32, device=q.device)
    return _SplitFusedAttention.apply(q, k, v, bias.float(), mask, scale)
