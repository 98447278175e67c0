"""Image transforms: square resize, RandAugment, MIM two-view pipelines.

PIL + NumPy re-implementation of the reference's torchvision pipelines
(reference: src/vilt/transforms/square_transform.py:10-66,
src/vilt/transforms/randaugment.py:310-339).  Outputs are CHW float32
arrays, inception-normalized ((x-0.5)/0.5); the MIM second view is
logit-laplace mapped for the DALL-E dVAE
(reference: src/dall_e/utils.py:46-57).

Registry mirrors `_transforms` (reference src/vilt/transforms/__init__.py).
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

DVAE_LOGIT_LAPLACE_EPS = 0.1


def to_chw_float(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def inception_normalize(chw: np.ndarray) -> np.ndarray:
    return (chw - 0.5) / 0.5


def map_pixels(chw: np.ndarray) -> np.ndarray:
    """Logit-laplace range mapping for the dVAE input."""
    return (1 - 2 * DVAE_LOGIT_LAPLACE_EPS) * chw + DVAE_LOGIT_LAPLACE_EPS


# --------------------------------------------------------------------------
# RandAugment (2 ops, magnitude 7, p=0.5 each) over the reference's 10-op list
# --------------------------------------------------------------------------

_MAX_LEVEL = 10
_TRANSLATE_CONST = 10  # ABSOLUTE pixels (reference randaugment.py:286)


def _enhance_factor(level: int) -> float:
    # brightness/sharpness strength: deterministic (level/10)·1.8 + 0.1
    # (reference enhance_level_to_args, randaugment.py:208-211 — no sign
    # flip; at M=7 this is always 1.36)
    return (level / _MAX_LEVEL) * 1.8 + 0.1


def _shear_arg(level: int) -> float:
    # (reference shear_level_to_args, randaugment.py:214-220)
    return (level / _MAX_LEVEL) * 0.3 * random.choice([-1, 1])


def _translate_arg(level: int, extent: int) -> float:
    # translate_const=10 ABSOLUTE pixels, not a fraction of the image
    # (reference translate_level_to_args + randaugment.py:286)
    del extent
    return (level / _MAX_LEVEL) * float(_TRANSLATE_CONST) * \
        random.choice([-1, 1])


def _rotate_arg(level: int) -> float:
    # (reference rotate_level_to_args, randaugment.py:258-265)
    return (level / _MAX_LEVEL) * 30.0 * random.choice([-1, 1])


def _apply_op(img: Image.Image, name: str, level: int) -> Image.Image:
    if name == "Identity":
        return img
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    if name == "Brightness":
        return ImageEnhance.Brightness(img).enhance(_enhance_factor(level))
    if name == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(_enhance_factor(level))
    if name == "ShearX":
        return img.transform(img.size, Image.AFFINE,
                             (1, _shear_arg(level), 0, 0, 1, 0),
                             resample=Image.BILINEAR, fillcolor=(128,) * 3)
    if name == "ShearY":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0, _shear_arg(level), 1, 0),
                             resample=Image.BILINEAR, fillcolor=(128,) * 3)
    if name == "TranslateX":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, _translate_arg(level, img.size[0]),
                              0, 1, 0),
                             resample=Image.BILINEAR, fillcolor=(128,) * 3)
    if name == "TranslateY":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0, 0, 1,
                              _translate_arg(level, img.size[1])),
                             resample=Image.BILINEAR, fillcolor=(128,) * 3)
    if name == "Rotate":
        return img.rotate(_rotate_arg(level), resample=Image.BILINEAR,
                          fillcolor=(128,) * 3)
    raise ValueError(name)


RANDAUG_OPS = ("Identity", "AutoContrast", "Equalize", "Brightness",
               "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
               "Rotate")


class RandomAugment:
    """N random ops at magnitude M, each applied with p=0.5
    (reference randaugment.py:310-333)."""

    def __init__(self, n: int = 2, m: int = 7, ops=RANDAUG_OPS):
        self.n, self.m, self.ops = n, m, ops

    def __call__(self, img: Image.Image) -> Image.Image:
        for name in np.random.choice(self.ops, self.n):
            if random.random() <= 0.5:
                img = _apply_op(img, str(name), self.m)
        return img


# --------------------------------------------------------------------------
# Geometric primitives
# --------------------------------------------------------------------------

def random_resized_crop_params(
    w: int, h: int, scale: Tuple[float, float],
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    rand=None,
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params semantics.  ``rand``
    (optional np.random.RandomState) replaces the global `random` module
    for deterministic sampling (the in-graph augment path,
    ops/augment.sample_train_params)."""
    if rand is None:
        uniform, randint = random.uniform, random.randint
    else:
        uniform = rand.uniform
        randint = lambda a, b: int(rand.randint(a, b + 1))  # noqa: E731
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * uniform(*scale)
        aspect = math.exp(uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = randint(0, w - cw)
            y = randint(0, h - ch)
            return x, y, cw, ch
    # fallback: center crop at clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


# --------------------------------------------------------------------------
# Pipelines
# --------------------------------------------------------------------------

class SquareTransform:
    """Deterministic eval transform: bicubic resize to (S,S) + normalize."""

    def __init__(self, size: int = 224):
        self.size = size

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = img.resize((self.size, self.size), resample=Image.BICUBIC)
        return inception_normalize(to_chw_float(img))

    def transform_bytes(self, jpeg: bytes) -> Optional[np.ndarray]:
        """Fused native JPEG decode+resize+normalize (runtime/decode.cc);
        None when the buffer isn't JPEG or the native lib is unavailable."""
        if not (len(jpeg) > 3 and jpeg[:3] == b"\xff\xd8\xff"):
            return None
        from .. import runtime

        if not runtime.available():
            return None
        return runtime.decode_resize_batch([jpeg], self.size,
                                           num_threads=1)[0]


class SquareTransformRandaug:
    """Train transform: RandomResizedCrop(0.5-1.0) + HFlip + RandAugment(2,7)."""

    def __init__(self, size: int = 224):
        self.size = size
        self.randaug = RandomAugment(2, 7)

    def __call__(self, img: Image.Image) -> np.ndarray:
        x, y, cw, ch = random_resized_crop_params(*img.size, scale=(0.5, 1.0))
        img = img.crop((x, y, x + cw, y + ch)).resize(
            (self.size, self.size), resample=Image.BICUBIC)
        if random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = self.randaug(img)
        return inception_normalize(to_chw_float(img))


class _TwoPicBase:
    """Shared crop → (model view, dVAE view) logic
    (reference random_crop_two_pics.py via square_transform.py:45-66)."""

    def __init__(self, size: int, second_size: int,
                 scale: Tuple[float, float]):
        self.size, self.second_size, self.scale = size, second_size, scale

    def crop_two(self, img: Image.Image):
        x, y, cw, ch = random_resized_crop_params(*img.size, scale=self.scale)
        box = (x, y, x + cw, y + ch)
        v1 = img.crop(box).resize((self.size, self.size),
                                  resample=Image.BICUBIC)
        v2 = img.crop(box).resize((self.second_size, self.second_size),
                                  resample=Image.LANCZOS)
        return v1, v2

    def finish(self, v1, v2):
        return (inception_normalize(to_chw_float(v1)),
                map_pixels(to_chw_float(v2)))


class SquareTransformMim(_TwoPicBase):
    def __init__(self, size=224, second_size=112):
        super().__init__(size, second_size, scale=(1.0, 1.0))

    def __call__(self, img: Image.Image):
        return self.finish(*self.crop_two(img))


class SquareTransformRandaugMim(_TwoPicBase):
    def __init__(self, size=224, second_size=112):
        super().__init__(size, second_size, scale=(0.5, 1.0))
        self.randaug = RandomAugment(2, 7)

    def __call__(self, img: Image.Image):
        if random.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = self.randaug(img)
        return self.finish(*self.crop_two(img))


# --------------------------------------------------------------------------
# Legacy ViLT/pixelbert pipeline (vestigial in the reference — SURVEY §2.12:
# no current named config uses it; ported for inventory completeness.
# Variable-resolution outputs are consumed by the dynamic-patch path,
# models/distilled.py)
# --------------------------------------------------------------------------

def min_max_resize(img: Image.Image, shorter: int = 800,
                   longer: int = 1333) -> Image.Image:
    """Reference transforms/utils.py:MinMaxResize (:5-26): scale the short
    side to ``shorter``, cap the long side at ``longer``, snap both down
    to multiples of 32, bicubic."""
    w, h = img.size
    scale = shorter / min(w, h)
    if h < w:
        newh, neww = shorter, scale * w
    else:
        newh, neww = scale * h, shorter
    if max(newh, neww) > longer:
        scale = longer / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    newh, neww = int(newh + 0.5), int(neww + 0.5)
    newh, neww = newh // 32 * 32, neww // 32 * 32
    return img.resize((neww, newh), resample=Image.BICUBIC)


def _flip_sign(v: float) -> float:
    # the legacy ops draw ONE uniform for the sign (randaug.py:13-60);
    # call order matters for seeded parity with the executed reference
    return -v if random.random() > 0.5 else v


def _lr_shear_x(img, v):
    return img.transform(img.size, Image.AFFINE,
                         (1, _flip_sign(v), 0, 0, 1, 0))


def _lr_shear_y(img, v):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, 0, _flip_sign(v), 1, 0))


def _lr_translate_x_abs(img, v):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, _flip_sign(v), 0, 1, 0))


def _lr_translate_y_abs(img, v):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, 0, 0, 1, _flip_sign(v)))


def _lr_rotate(img, v):
    return img.rotate(_flip_sign(v))


def _lr_solarize_add(img, addition, threshold=128):
    # reference randaug.py:83-90 (its np.int predates numpy 1.24; int64
    # on linux — the math is exact either way after the clip)
    arr = np.clip(np.asarray(img).astype(np.int64) + addition,
                  0, 255).astype(np.uint8)
    return ImageOps.solarize(Image.fromarray(arr), threshold)


# (op, minval, maxval) — EXACTLY the reference's augment_list()
# (randaug.py:183-201, the active efficientnet-policy list), same order so
# seeded random.choices picks the same ops
_LEGACY_AUGS = [
    (lambda img, v: ImageOps.autocontrast(img), 0, 1),
    (lambda img, v: ImageOps.equalize(img), 0, 1),
    (_lr_rotate, 0, 30),
    (lambda img, v: ImageOps.posterize(img, max(1, int(v))), 0, 4),
    (lambda img, v: ImageOps.solarize(img, v), 0, 256),
    (_lr_solarize_add, 0, 110),
    (lambda img, v: ImageEnhance.Color(img).enhance(v), 0.1, 1.9),
    (lambda img, v: ImageEnhance.Contrast(img).enhance(v), 0.1, 1.9),
    (lambda img, v: ImageEnhance.Brightness(img).enhance(v), 0.1, 1.9),
    (lambda img, v: ImageEnhance.Sharpness(img).enhance(v), 0.1, 1.9),
    (_lr_shear_x, 0.0, 0.3),
    (_lr_shear_y, 0.0, 0.3),
    (_lr_translate_x_abs, 0.0, 100),
    (_lr_translate_y_abs, 0.0, 100),
]


class LegacyRandAugment:
    """reference transforms/randaug.py:RandAugment (:257-269): n uniform
    op choices, magnitude mapped as m/30 of each op's range."""

    def __init__(self, n: int = 2, m: int = 9):
        self.n, self.m = n, m

    def __call__(self, img: Image.Image) -> Image.Image:
        ops = random.choices(_LEGACY_AUGS, k=self.n)
        for op, minval, maxval in ops:
            val = (float(self.m) / 30) * float(maxval - minval) + minval
            img = op(img, val)
        return img


class PixelbertTransform:
    """reference transforms/pixelbert.py:pixelbert_transform (:9-17)."""

    def __init__(self, size: int = 800):
        self.shorter = size
        self.longer = int((1333 / 800) * size)

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = min_max_resize(img, self.shorter, self.longer)
        return inception_normalize(to_chw_float(img))


class PixelbertTransformRandaug(PixelbertTransform):
    """pixelbert_transform_randaug (:20-30): RandAugment(2, 9) FIRST
    (inserted at index 0), then the deterministic tail."""

    def __init__(self, size: int = 800):
        super().__init__(size)
        self.randaug = LegacyRandAugment(2, 9)

    def __call__(self, img: Image.Image) -> np.ndarray:
        return super().__call__(self.randaug(img))


_TRANSFORMS = {
    "pixelbert": PixelbertTransform,
    "pixelbert_randaug": PixelbertTransformRandaug,
    "square_transform": SquareTransform,
    "square_transform_randaug": SquareTransformRandaug,
}
_MIM_TRANSFORMS = {
    "square_transform_mim": SquareTransformMim,
    "square_transform_randaug_mim": SquareTransformRandaugMim,
}


def keys_to_transforms(keys: List[str], size: int):
    return [_TRANSFORMS[k](size=size) for k in keys]


def keys_to_transforms_for_mim(keys: List[str], size: int, second_size: int):
    return [_MIM_TRANSFORMS[k](size=size, second_size=second_size)
            for k in keys]
