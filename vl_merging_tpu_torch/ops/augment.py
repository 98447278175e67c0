"""Device-side train-time image augmentation: RandomResizedCrop + HFlip +
RandAugment(2, 7) + inception normalize (port of
``vl_merging_tpu/ops/augment.py``).

The reference's ``square_transform_randaug`` pipeline
(square_transform.py:20-30: RandomResizedCrop(scale 0.5-1.0, bicubic) →
RandomHorizontalFlip → RandomAugment(2, 7) over a 10-op list → inception
normalize) with every SCALAR random choice sampled on the host
(``sample_train_params``: crop boxes by torchvision's rejection loop,
coin flips, op ids, signed magnitudes; a few bytes an image) and every
PIXEL touched on the card once: the native-size uint8 canvas crosses the
link, and crop-resize, flip, both RandAugment stages and the
normalization run batched over the images (``augment_train_batch``).
There is no data-dependent host control flow: every image computes each
stage's three candidates (a 256-entry LUT lookup, a 3x3-smooth blend, a
bilinear warp) and selects by its op id, the JAX package's semantics.
Images are (B, 3, S, S) f32 holding exact integers in [0, 255] (the
stand-in for PIL's uint8) from the crop on.

Numerics parity (held against PIL and the JAX package by
``tests/test_torch_port_preprocess.py``):
  - Equalize / Brightness / Sharpness: byte-exact against PIL.  Equalize
    is PIL's integer LUT ((step//2 + cumsum(hist))//step), its histogram
    a ``scatter_add_`` (integer, exact); Brightness and Sharpness blends
    replicate Blend.c's C-float truncation, each multiply and add rounded
    on its own (no fused op); the SMOOTH pre-filter rounds half-up on the
    interior with the borders copied.
  - AutoContrast: the exact-rational LUT clip((ix-lo)*255 // (hi-lo)),
    byte-exact against the JAX package (PIL's double LUT lands one ulp
    under an exact integer on some (lo, hi): max |Δ| 1).
  - Shear / Translate / Rotate: PIL's affine: source coordinates
    a·(x+0.5) + b·(y+0.5) + c (products and sums rounded one at a time),
    fill 128 outside [0, W)x[0, H) of the unshifted coordinate, 2x2 taps
    clamped to the image, the value truncated toward zero.  f32 (PIL:
    double) flips the odd truncation tie: ≥99% of bytes exact.
  - Crop+resize: ``ops/image.py``'s resize (PIL's bytes) with the crop
    folded into the resample weights' offsets.
  - Oversized natives: images larger than the staging canvas are
    pre-downscaled on the host to fit (``data/arrow_dataset.py``), so the
    crop resamples a canvas-sized image, not the native one.

Reference: src/vilt/transforms/square_transform.py:20-30,
src/vilt/transforms/randaugment.py:310-339.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .image import _resample_weights, _two_pass, normalize_nchw

# Op vocabulary: indices are a contract between the host sampler and the
# device ops (order = reference square_transform.py:27-28)
OPS = ("Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
       "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
_IDENTITY, _AUTOCONTRAST, _EQUALIZE, _BRIGHTNESS, _SHARPNESS = range(5)
_SHEAR_X, _SHEAR_Y, _TRANSLATE_X, _TRANSLATE_Y, _ROTATE = range(5, 10)

_MAX_LEVEL = 10
_TRANSLATE_CONST = 10.0  # absolute pixels (reference randaugment.py:286)
# SMOOTH's 3x3 kernel (center 5) over 13, each weight the IEEE f32 quotient
_SMOOTH = (np.asarray([1, 1, 1, 1, 5, 1, 1, 1, 1], np.float32)
           / np.float32(13.0))


# --------------------------------------------------------------------------
# Host-side parameter sampling (scalar randomness only, no pixel work)
# --------------------------------------------------------------------------

def _rotate_coeffs(deg: float, w: int, h: int):
    """PIL ``Image.rotate(expand=False)``'s inverse-affine matrix (rotation
    about the image center)."""
    angle = -math.radians(deg)
    m = [math.cos(angle), math.sin(angle), 0.0,
         -math.sin(angle), math.cos(angle), 0.0]
    cx, cy = w / 2.0, h / 2.0
    m[2] = cx - (m[0] * cx + m[1] * cy)
    m[5] = cy - (m[3] * cx + m[4] * cy)
    return m


def sample_train_params(rng: np.random.RandomState, sizes, out_size: int,
                        n: int = 2, m: int = 7,
                        scale=(0.5, 1.0)) -> Dict[str, np.ndarray]:
    """Every random choice of the train pipeline for a batch, from ``rng``.

    sizes: (B, 2) native (h, w) rows.  Returns the arrays
    ``augment_train_batch`` consumes: crop boxes (y, x, h, w)
    (torchvision RandomResizedCrop.get_params with its 10-try rejection
    loop), flip flags, per-stage op ids, apply coins and enhance factors,
    and per-stage affine coefficients (identity rows for the non-warp
    ops; signed magnitudes per reference randaugment.py level_to_args)."""
    from ..data.transforms import random_resized_crop_params

    B = len(sizes)
    S = out_size
    crop = np.zeros((B, 4), np.int32)
    for i, (h, w) in enumerate(np.asarray(sizes)):
        x, y, cw, ch = random_resized_crop_params(
            int(w), int(h), scale=scale, rand=rng)
        crop[i] = (y, x, ch, cw)
    flip = rng.random_sample(B) < 0.5

    op_idx = rng.randint(0, len(OPS), (B, n)).astype(np.int32)
    op_apply = rng.random_sample((B, n)) <= 0.5
    enh = np.float32((m / _MAX_LEVEL) * 1.8 + 0.1)
    factor = np.full((B, n), enh, np.float32)

    affine = np.zeros((B, n, 6), np.float32)
    affine[..., 0] = 1.0
    affine[..., 4] = 1.0
    sign = np.where(rng.random_sample((B, n)) < 0.5, -1.0, 1.0)
    shear_v = (m / _MAX_LEVEL) * 0.3 * sign
    trans_v = (m / _MAX_LEVEL) * _TRANSLATE_CONST * sign
    rot_v = (m / _MAX_LEVEL) * 30.0 * sign
    for i in range(B):
        for s in range(n):
            op = op_idx[i, s]
            if op == _SHEAR_X:
                affine[i, s, 1] = shear_v[i, s]
            elif op == _SHEAR_Y:
                affine[i, s, 3] = shear_v[i, s]
            elif op == _TRANSLATE_X:
                affine[i, s, 2] = trans_v[i, s]
            elif op == _TRANSLATE_Y:
                affine[i, s, 5] = trans_v[i, s]
            elif op == _ROTATE:
                affine[i, s] = _rotate_coeffs(rot_v[i, s], S, S)
    return {"crop": crop, "flip": flip, "op_idx": op_idx,
            "op_apply": op_apply, "factor": factor, "affine": affine}


# --------------------------------------------------------------------------
# Device ops: (B, 3, H, W) f32 images of exact integers in [0, 255]
# --------------------------------------------------------------------------

def _identity_lut(img: torch.Tensor) -> torch.Tensor:
    B = img.shape[0]
    return torch.arange(256, dtype=torch.int32, device=img.device) \
        .expand(B, 3, 256)


def _autocontrast_lut(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, 256) int32 LUT, PIL ``ImageOps.autocontrast(cutoff=0)``:
    clip((ix - lo) * 255 // (hi - lo)) with lo / hi the channel's min and
    max; the identity where hi == lo."""
    lo = img.amin(dim=(2, 3)).to(torch.int32)[..., None]     # B,3,1
    hi = img.amax(dim=(2, 3)).to(torch.int32)[..., None]
    ix = _identity_lut(img)
    span = hi - lo
    scaled = torch.clamp((ix - lo) * 255 // torch.clamp(span, min=1), 0, 255)
    return torch.where(span <= 0, ix, scaled)


def _equalize_lut(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, 256) int32 LUT, PIL ``ImageOps.equalize``, byte-exact:
    step = (n - count(last nonzero bin)) // 255;
    lut[i] = (step//2 + cumsum_excl(h)[i]) // step (the identity if step
    is 0 or fewer than two bins are nonzero)."""
    B = img.shape[0]
    idx = img.reshape(B, 3, -1).long()
    h = torch.zeros(B, 3, 256, dtype=torch.int32, device=img.device)
    h.scatter_add_(2, idx, torch.ones_like(idx, dtype=torch.int32))
    ix = _identity_lut(img)
    nonzero = h > 0
    n_nonzero = nonzero.sum(dim=2, keepdim=True)
    last = torch.where(nonzero, ix, 0).amax(dim=2, keepdim=True)
    step = (h.sum(dim=2, keepdim=True) - h.gather(2, last.long())) // 255
    csum = torch.cumsum(h, dim=2, dtype=torch.int32) - h     # exclusive
    lut = torch.clamp((step // 2 + csum) // torch.clamp(step, min=1), 0, 255)
    return torch.where((step == 0) | (n_nonzero <= 1), ix, lut)


def _brightness_lut(factor: torch.Tensor) -> torch.Tensor:
    """(B, 3, 256) int32 LUT, PIL ``ImageEnhance.Brightness`` (a blend with
    black: C-float truncation, Blend.c), byte-exact."""
    ix = torch.arange(256, dtype=torch.float32, device=factor.device)
    lut = torch.clamp(torch.trunc(ix * factor.float()[:, None]), 0, 255)
    return lut.to(torch.int32)[:, None].expand(-1, 3, -1)


def _apply_lut(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Each channel of each image through its own 256-entry LUT (a
    gather)."""
    B, _, H, W = img.shape
    out = lut.gather(2, img.reshape(B, 3, H * W).long())
    return out.reshape(B, 3, H, W).float()


def _sharpness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ``ImageEnhance.Sharpness``, byte-exact: SMOOTH 3x3 (center 5,
    /13, rounded half-up) on the interior with the borders copied, then
    the C-float truncating blend."""
    H, W = img.shape[2:]
    k = torch.from_numpy(_SMOOTH).to(img.device)
    acc = torch.zeros_like(img)
    i = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + k[i] * torch.roll(img, (-dy, -dx), dims=(2, 3))
            i += 1
    deg = torch.clamp(torch.trunc(acc + 0.5), 0.0, 255.0)
    ry = torch.arange(H, device=img.device)[:, None]
    rx = torch.arange(W, device=img.device)[None, :]
    interior = (ry > 0) & (ry < H - 1) & (rx > 0) & (rx < W - 1)
    deg = torch.where(interior, deg, img)
    f = factor.float()[:, None, None, None]
    out = torch.trunc(deg + f * (img - deg))
    return torch.clamp(out, 0.0, 255.0)


def _affine_bilinear(img: torch.Tensor, coeffs: torch.Tensor,
                     fill: float = 128.0) -> torch.Tensor:
    """PIL ``Image.transform(AFFINE, BILINEAR, fillcolor=128)`` in f32, one
    (6,) row of coefficients an image: source coordinates at the output
    pixels' centers, the fill outside [0, W)x[0, H) of the unshifted
    coordinate, the 2x2 taps clamped, the value truncated."""
    B, _, H, W = img.shape
    dev = img.device
    c = coeffs.float()[:, :, None, None]                     # B,6,1,1
    a, b, c_, d, e, f = c.unbind(1)                          # B,1,1 each
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    xs0 = a * xs + b * ys + c_                               # B,H,W
    ys0 = d * xs + e * ys + f
    inside = (xs0 >= 0) & (xs0 < W) & (ys0 >= 0) & (ys0 < H)
    xin = xs0 - 0.5
    yin = ys0 - 0.5
    x0 = torch.floor(xin)
    y0 = torch.floor(yin)
    fx = (xin - x0)[:, None]                                 # B,1,H,W
    fy = (yin - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    xa, xb = x0i.clamp(0, W - 1), (x0i + 1).clamp(0, W - 1)
    ya, yb = y0i.clamp(0, H - 1), (y0i + 1).clamp(0, H - 1)
    flat = img.reshape(B, 3, H * W)

    def tap(yi, xi):
        at = (yi * W + xi).reshape(B, 1, H * W).long().expand(-1, 3, -1)
        return flat.gather(2, at).reshape(B, 3, H, W)

    v = (tap(ya, xa) * (1 - fx) * (1 - fy) + tap(ya, xb) * fx * (1 - fy)
         + tap(yb, xa) * (1 - fx) * fy + tap(yb, xb) * fx * fy)
    v = torch.clamp(torch.trunc(v), 0.0, 255.0)
    return torch.where(inside[:, None], v, torch.full_like(v, fill))


def _randaug_stage(img: torch.Tensor, op: torch.Tensor, apply: torch.Tensor,
                   coeffs: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """One RandAugment stage, branchless: the LUT candidate (identity /
    autocontrast / equalize / brightness share one lookup), the sharpness
    candidate and the affine candidate (identity coefficients reproduce
    the input exactly), selected by each image's op id and its p=0.5
    coin."""
    o = op.long()[:, None, None]
    lut = _identity_lut(img)
    lut = torch.where(o == _AUTOCONTRAST, _autocontrast_lut(img), lut)
    lut = torch.where(o == _EQUALIZE, _equalize_lut(img), lut)
    lut = torch.where(o == _BRIGHTNESS, _brightness_lut(factor), lut)
    y_lut = _apply_lut(img, lut)
    y_sharp = _sharpness(img, factor)
    y_warp = _affine_bilinear(img, coeffs)
    o = o[..., None]
    out = torch.where(o == _SHARPNESS, y_sharp,
                      torch.where(o >= _SHEAR_X, y_warp, y_lut))
    return torch.where(apply.bool()[:, None, None, None], out, img)


def _resized_crop_u8f(canvas: torch.Tensor, box: torch.Tensor,
                      out_size: int) -> torch.Tensor:
    """PIL crop + bicubic resize of each (Hc, Wc, 3) uint8 canvas image by
    its box (y, x, h, w): ``ops/image.py``'s two passes with the crop
    folded into the weights.  (B, 3, S, S) f32 bytes."""
    _, Hc, Wc, _ = canvas.shape
    box = box.to(torch.int32)
    wx = _resample_weights(box[:, 3], Wc, out_size, offset=box[:, 1])
    wy = _resample_weights(box[:, 2], Hc, out_size, offset=box[:, 0])
    return _two_pass(canvas, wx, wy)


# --------------------------------------------------------------------------
# Batch entry point
# --------------------------------------------------------------------------

def augment_bytes(canvas: torch.Tensor, params: Dict[str, torch.Tensor],
                  out_size: int) -> torch.Tensor:
    """RandomResizedCrop (bicubic) → HFlip → the RandAugment stages, before
    the normalization: (B, 3, S, S) f32 bytes."""
    x = _resized_crop_u8f(canvas, params["crop"], out_size)
    x = torch.where(params["flip"].bool()[:, None, None, None],
                    x.flip(-1), x)
    for s in range(params["op_idx"].shape[1]):
        x = _randaug_stage(x, params["op_idx"][:, s], params["op_apply"][:, s],
                           params["affine"][:, s], params["factor"][:, s])
    return x


def augment_train_batch(canvas: torch.Tensor, params: Dict[str, torch.Tensor],
                        out_size: int) -> torch.Tensor:
    """The whole train image path on the canvas's device: RandomResizedCrop
    (bicubic) → HFlip → the RandAugment stages → inception normalize.

    canvas: (B, Hc, Wc, 3) uint8 native-size images on a zero-padded
    canvas; params: ``sample_train_params``'s arrays as tensors on the
    same device.  Returns (B, 3, S, S) f32."""
    return normalize_nchw(augment_bytes(canvas, params, out_size))
