"""Relative-position index buffers and per-layer bias lookup (port of
``vl_merging_tpu/models/relpos.py``, single-modality kinds).

One bias table is shared across all layers: shape
``(num_relative_distance + text_num_relative_distance + 2, heads * layers)``.
Image tokens use BEiT 2-D window buckets; text tokens use clipped 1-D
distances offset past the image range (reference:
src/vilt/modules/vilt_module.py:123-214).  The index builders are NumPy,
computed once per shape.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .spec import ModelSpec


@functools.lru_cache(maxsize=None)
def image_relative_position_index(window: int) -> np.ndarray:
    """BEiT window index, (window²+1, window²+1); vilt_module.py:143-164."""
    num_relative_distance = (2 * window - 1) * (2 * window - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))           # 2, Wh, Ww
    coords_flat = coords.reshape(2, -1)                      # 2, Wh*Ww
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)            # N, N, 2
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    index = np.zeros((window * window + 1,) * 2, dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_relative_distance - 3   # cls → token
    index[0:, 0] = num_relative_distance - 2   # token → cls
    index[0, 0] = num_relative_distance - 1    # cls → cls
    return index


@functools.lru_cache(maxsize=None)
def text_relative_position_index(
    max_text_len: int, max_text_len_of_initckpt: int, window: int
) -> np.ndarray:
    """1-D clipped text distances offset past the image buckets;
    vilt_module.py:166-178."""
    num_relative_distance = (2 * window - 1) * (2 * window - 1) + 3
    text_num_relative_distance = 2 * max_text_len_of_initckpt
    all_num = num_relative_distance + text_num_relative_distance + 2

    ids = np.arange(max_text_len - 1)
    rel = ids[None, :] - ids[:, None]
    min_distance = 2 - max_text_len_of_initckpt
    rel = rel - min_distance + (num_relative_distance + 2)
    index = np.zeros((max_text_len,) * 2, dtype=np.int64)
    index[1:, 1:] = rel
    index[0, 0:] = all_num - 3
    index[0:, 0] = all_num - 2
    index[0, 0] = all_num - 1
    return index


def text_index(spec: ModelSpec, true_length: Optional[int] = None) -> np.ndarray:
    idx = text_relative_position_index(
        spec.max_text_len, spec.max_text_len_of_initckpt, spec.window)
    if true_length is not None:
        idx = idx[:true_length, :true_length]
    return idx


def image_index(spec: ModelSpec) -> np.ndarray:
    return image_relative_position_index(spec.window)


def per_layer_bias(table: torch.Tensor, index: np.ndarray, num_layers: int,
                   num_heads: int) -> torch.Tensor:
    """Gather the shared table into per-layer (heads, N, N) biases.

    Matches ``F.embedding(index, table).permute(2,0,1)`` then
    ``torch.chunk(num_layers, dim=0)`` (vilt_module.py:1061-1064, 1128):
    the (heads*layers) trailing dim is chunked into layer-major groups.
    Returns a contiguous (layers, heads, N, N) float32 tensor on the
    table's device, so each layer's slice is contiguous too.
    """
    n = index.shape[0]
    idx = torch.as_tensor(index, dtype=torch.long, device=table.device)
    gathered = table.float()[idx]                          # N, N, H*L
    return gathered.permute(2, 0, 1).reshape(num_layers, num_heads, n, n) \
        .contiguous()
