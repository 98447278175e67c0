"""BEiT block-wise masking for MIM.

Random rectangles (aspect 0.3–3.3, 16..max patches each) until at least
``num_masking_patches`` of the window's patches are masked
(reference: src/vilt/datasets/masking_generator.py:28-91).
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np


class MaskingGenerator:
    def __init__(
        self,
        input_size,
        num_masking_patches: int,
        min_num_patches: int = 16,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask_block(self, mask: np.ndarray, max_mask_patches: int) -> int:
        delta = 0
        for _ in range(10):
            target_area = random.uniform(self.min_num_patches,
                                         max_mask_patches)
            aspect = math.exp(random.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = random.randint(0, self.height - h)
                left = random.randint(0, self.width - w)
                num_masked = mask[top:top + h, left:left + w].sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    mask[top:top + h, left:left + w] = 1
                    delta = h * w - num_masked
            if delta > 0:
                break
        return int(delta)

    def __call__(self) -> np.ndarray:
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(self.num_masking_patches - mask_count,
                                   self.max_num_patches)
            delta = self._mask_block(mask, max_mask_patches)
            if delta == 0:
                break
            mask_count += delta
        return mask


class MaskingGenerator3D:
    """BEiT block-wise masking over (frames, height, width) for video MIM
    (reference: src/vilt/datasets/masking_generator.py:165-235 — the
    second, operative definition; selected by tsv_dataset.py:95 when
    ``size_frame > 1`` with ``num_masking_patches = num_mask_patches *
    size_frame``).

    Each attempt draws a 2D rectangle plus a random temporal extent
    [t_start, t_end) and masks the whole slab.  Two reference quirks are
    kept: the overlap acceptance test compares the *2D* block area
    ``h*w`` (not the slab volume) against the already-masked slab count,
    and the per-attempt RNG call order (area, aspect, top, left,
    t_start, t_end) is identical so seeded masks are bit-equal.
    """

    def __init__(
        self,
        input_size,
        size_frame: int,
        num_masking_patches: int,
        min_num_patches: int = 4,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.size_frame = size_frame
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask_block(self, mask: np.ndarray, max_mask_patches: int) -> int:
        delta = 0
        for _ in range(10):
            target_area = random.uniform(self.min_num_patches,
                                         max_mask_patches)
            aspect = math.exp(random.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = random.randint(0, self.height - h)
                left = random.randint(0, self.width - w)
                t_start = random.randint(0, self.size_frame - 1)
                t_end = random.randint(t_start + 1, self.size_frame)
                slab = mask[t_start:t_end, top:top + h, left:left + w]
                num_masked = slab.sum()
                # reference quirk: acceptance compares the 2D area h*w,
                # not the slab volume (masking_generator.py:208-214)
                if 0 < h * w - num_masked <= max_mask_patches:
                    delta = int((slab == 0).sum())
                    slab[...] = 1
            if delta > 0:
                break
        return delta

    def __call__(self) -> np.ndarray:
        mask = np.zeros((self.size_frame, self.height, self.width),
                        dtype=np.int64)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(self.num_masking_patches - mask_count,
                                   self.max_num_patches)
            delta = self._mask_block(mask, max_mask_patches)
            if delta == 0:
                break
            mask_count += delta
        return mask
