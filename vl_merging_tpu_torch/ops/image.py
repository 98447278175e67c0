"""Device-side image preprocessing: the PIL-parity bicubic square resize and
the inception normalization (port of ``vl_merging_tpu/ops/image.py``).

Decoded NATIVE-size uint8 images ride to the card on one zero-padded
canvas (``pack_canvas``), and the PIL algorithm runs there as two batched
f32 products whose weight matrices are computed on the card from each
image's (h, w): one code path covers every native size up to the canvas.

Algorithm parity (reference square_transform.py:10-17 → PIL
``Image.resize(..., BICUBIC)``): separable resampling with the a=-0.5
cubic kernel, support scaled by the downscale ratio (antialias), the
per-output-pixel integer window, weights normalized over the window and
quantized to 22 bits as PIL's 8-bit path does, and a round+clip to uint8
BETWEEN the horizontal and vertical passes.  The weights follow Pillow's
double arithmetic step for step and the sums are exact integers, so the
bytes are PIL's (held byte for byte by
``tests/test_torch_port_preprocess.py``).  The JAX package computes its
weights and sums in f32 and is within ≥99.7% of PIL's bytes; the port is
as close to it.

The products must run in true f32: TF32 rounds the weights' halves that
keep them exact (``device.require_cuda`` turns it off for matmuls).
Every quotient that must be the IEEE one divides by a tensor, because
PyTorch's CUDA kernels divide by a CPU scalar as a multiply by its
reciprocal.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# PIL's 8bpc weight precision (Resample.c PRECISION_BITS), and the split of
# a quantized weight into the halves that the exact products take
_BITS, _HALF = 22, 11


def _cubic_filter(x: torch.Tensor) -> torch.Tensor:
    """PIL bicubic kernel (a = -0.5), support 2 (decode.cc:70-77)."""
    a = -0.5
    x = x.abs()
    v1 = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    v2 = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return torch.where(x < 1.0, v1, torch.where(x < 2.0, v2,
                                                torch.zeros_like(x)))


def _resample_weights(in_size: torch.Tensor, in_max: int, out_size: int,
                      offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, out_size, in_max) dense PIL resample matrices for the per-image
    input lengths ``in_size`` (B,) on a canvas axis of ``in_max`` pixels,
    f32 multiples of 2^-22; ``offset`` (B,) resamples the segment
    [offset, offset + in_size) of the canvas (crop-then-resize as one
    matrix).

    Pillow's own double arithmetic, step for step (Resample.c
    precompute_coeffs and normalize_coeffs_8bpc): scale = in / out,
    filterscale = max(scale, 1), support = 2·filterscale, center =
    (xx + 0.5)·scale, the window [trunc(center - support + 0.5),
    trunc(center + support + 0.5)) clipped to the image, each weight
    filter((x - center + 0.5)·(1/filterscale)), their sum over the window
    left to right, each weight divided by it, and quantized to 22 bits
    half away from zero.  Only the window's taps are evaluated (at most
    2·support + 1 of them, support ≤ 2·max(in_max, out)/out), then
    scattered into the dense matrix.  The quantized weights are PIL's, so
    with the exact sums of ``_exact_pass`` the resize is PIL's bytes.
    (The JAX package evaluates them in f32, as exact-int numerators over
    one f32 division, which resolves the weights that fall on a
    quantization tie one way or the other.)"""
    dev = in_size.device
    f64 = torch.float64
    n = in_size.to(f64)[:, None, None]                       # B,1,1
    scale = n / n.new_tensor(float(out_size))
    filterscale = torch.clamp(scale, min=1.0)
    support = 2.0 * filterscale
    xx = torch.arange(out_size, dtype=f64, device=dev)[None, :, None]
    center = (xx + 0.5) * scale                              # B,O,1
    ss = n.new_tensor(1.0) / filterscale
    xmin = torch.clamp(torch.trunc(center - support + 0.5), min=0.0)
    xmax = torch.minimum(torch.trunc(center + support + 0.5), n)
    taps = 4 * max(in_max, out_size) // out_size + 2
    x = xmin + torch.arange(taps, dtype=f64, device=dev)     # B,O,K
    inside = x < xmax
    w = torch.where(inside, _cubic_filter((x - center + 0.5) * ss), 0.0)
    ww = w[..., :1]
    for t in range(1, taps):                  # Pillow's ww += w, in order
        ww = ww + w[..., t:t + 1]
    w = torch.where(ww != 0.0, w / torch.where(ww != 0.0, ww, 1.0), w)
    k = torch.trunc(w * float(1 << _BITS) + torch.sign(w) * 0.5)
    if offset is not None:
        x = x + offset.to(f64)[:, None, None]
    dense = torch.zeros(x.shape[:2] + (in_max,), dtype=torch.float32,
                        device=dev)
    # each canvas column takes one tap at most; the taps past the window
    # add 0 (their column clamped onto the canvas)
    return dense.scatter_add_(2, x.long().clamp(max=in_max - 1),
                              (k / k.new_tensor(float(1 << _BITS))).float())


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """PIL rounding: clip(floor(v + 0.5), 0, 255) (decode.cc:114-116)."""
    return torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)


def _exact_pass(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """PIL's integer resample of one axis: clip8((2^21 + Σ k·x) >> 22) with
    k = w·2^22 the quantized weights, x (..., M, K) bytes and w (..., N, K)
    (the batch dims broadcast); (..., M, N) f32 bytes.

    The sums run as f32 products that are exact: k = kh·2^11 + kl with
    |kl| ≤ 2^10, and x·[kh; kl]ᵀ is one product whose every partial sum is
    an integer below 2^24 (Σ|kh|·255 ≤ 2^20 for normalized weights,
    Σ|kl|·255 ≤ taps·2^18 for windows of under 64 taps), so its order
    does not matter; the two halves are joined in int32.  (An f32 sum of
    w·x rounds, which resolves pixels that land on PIL's .5 ties by
    rounding noise.)  The operands stay exact only in true f32: TF32
    rounds kh."""
    k = w * w.new_tensor(float(1 << _BITS))
    kh = torch.round(k / k.new_tensor(float(1 << _HALF)))
    kl = k - kh * (1 << _HALF)
    prod = torch.matmul(x, torch.cat([kh, kl], dim=-2).transpose(-1, -2))
    hi, lo = prod.split(w.shape[-2], dim=-1)
    # |Σ k·x| ≤ 255·Σ|k| < 2^31 and |hi| < 2^20: the join fits int32
    total = (hi.int() << _HALF) + lo.int() + (1 << (_BITS - 1))
    return torch.clamp(total >> _BITS, 0, 255).float()


def _two_pass(canvas: torch.Tensor, wx: torch.Tensor,
              wy: torch.Tensor) -> torch.Tensor:
    """The separable resample of a (B, Hc, Wc, 3) uint8 canvas by per-image
    weights wx (B, S, Wc) and wy (B, S, Hc), PIL's uint8 round between the
    passes: (B, 3, S, S) f32 holding integers in [0, 255]."""
    B, Hc, Wc, _ = canvas.shape
    x = canvas.permute(0, 3, 1, 2).float().reshape(B, 3 * Hc, Wc)
    tmp = _exact_pass(x, wx).reshape(B, 3, Hc, -1)          # B,3,Hc,S
    # the vertical pass on the transposed intermediate: (S, Hc) rows
    out = _exact_pass(tmp.transpose(2, 3), wy[:, None])      # B,3,S(x),S(y)
    return out.transpose(2, 3)


def resize_u8f(canvas: torch.Tensor, sizes: torch.Tensor,
               out_size: int) -> torch.Tensor:
    """The bicubic square resize of each canvas image by its own (h, w):
    (B, 3, out_size, out_size) f32 holding the resized bytes."""
    _, Hc, Wc, _ = canvas.shape
    wx = _resample_weights(sizes[:, 1], Wc, out_size)        # B,S,Wc
    wy = _resample_weights(sizes[:, 0], Hc, out_size)        # B,S,Hc
    return _two_pass(canvas, wx, wy)


def pil_resize_bicubic_u8(canvas: torch.Tensor, sizes: torch.Tensor,
                          out_size: int) -> torch.Tensor:
    """PIL-parity bicubic square resize on the canvas's device.

    canvas: (B, Hc, Wc, 3) uint8, native-size images top-left-anchored on
    a zero-padded canvas; sizes: (B, 2) int rows of (h, w).  Returns
    (B, out_size, out_size, 3) uint8."""
    return resize_u8f(canvas, sizes, out_size).permute(0, 2, 3, 1) \
        .to(torch.uint8).contiguous()


def normalize_nchw(u8f: torch.Tensor) -> torch.Tensor:
    """Inception normalization of byte values: (x / 255 - 0.5) / 0.5, each
    quotient the IEEE one (divided by tensors)."""
    x = u8f / u8f.new_tensor(255.0)
    return (x - 0.5) / x.new_tensor(0.5)


def resize_normalize_nchw(canvas: torch.Tensor, sizes: torch.Tensor,
                          out_size: int) -> torch.Tensor:
    """Square resize + inception normalize, NCHW: the whole eval image path
    (square_transform.py:10-17), uint8 in, (B, 3, S, S) f32 out."""
    return normalize_nchw(resize_u8f(canvas, sizes, out_size))


def pack_canvas(images: Sequence[np.ndarray],
                canvas_hw: Optional[Tuple[int, int]] = None,
                round_to: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: stack variable-size HWC uint8 arrays onto one
    zero-padded canvas.  Returns (canvas (B, Hc, Wc, 3) uint8, sizes
    (B, 2) int32).  ``round_to`` buckets the canvas dims, so batches of
    similar native sizes share a shape."""
    hs = [im.shape[0] for im in images]
    ws = [im.shape[1] for im in images]
    if canvas_hw is None:
        rt = round_to
        canvas_hw = (-(-max(hs) // rt) * rt, -(-max(ws) // rt) * rt)
    Hc, Wc = canvas_hw
    canvas = np.zeros((len(images), Hc, Wc, 3), np.uint8)
    for i, im in enumerate(images):
        canvas[i, :im.shape[0], :im.shape[1]] = im
    sizes = np.stack([np.asarray(hs, np.int32),
                      np.asarray(ws, np.int32)], axis=1)
    return canvas, sizes
