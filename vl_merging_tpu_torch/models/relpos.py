"""Relative-position index buffers and per-layer bias lookup (port of
``vl_merging_tpu/models/relpos.py``: the image, text and fused kinds, and
the video helpers of the frame configs; the port's paths keep
``num_frames=1``).

One bias table is shared across all layers: shape
``(num_relative_distance + text_num_relative_distance + 2, heads * layers)``.
Image tokens use BEiT 2-D window buckets; text tokens use clipped 1-D
distances offset past the image range; the two cross-modal directions of
the fused [text; image] sequence get dedicated buckets (reference:
src/vilt/modules/vilt_module.py:123-214).  The index builders are NumPy,
computed once per shape.  The JAX package's ``fused_index_padded`` (its
per-segment pad for the TPU's sublanes) is not carried over: the port
does not pad.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

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


@functools.lru_cache(maxsize=None)
def text_image_relative_position_index(
    max_text_len: int, max_text_len_of_initckpt: int, window: int,
    vl_text_len: Optional[int] = None,
) -> np.ndarray:
    """Fused [text; image] index; cross-modal entries use 2 dedicated
    buckets (vilt_module.py:180-208).  ``vl_text_len`` truncates the text
    rows/cols (max_vl_text_len)."""
    num_relative_distance = (2 * window - 1) * (2 * window - 1) + 3
    max_imag_len = window * window + 1
    t_index = text_relative_position_index(
        max_text_len, max_text_len_of_initckpt, window)
    i_index = image_relative_position_index(window)

    t = max_text_len if vl_text_len is None else min(vl_text_len, max_text_len)
    t2i = np.full((t, max_imag_len), num_relative_distance, dtype=np.int64)
    i2t = np.full((max_imag_len, t), num_relative_distance + 1, dtype=np.int64)

    top = np.concatenate([t_index[:t, :t], t2i], axis=1)
    bottom = np.concatenate([i2t, i_index], axis=1)
    return np.concatenate([top, bottom], axis=0)


def fused_index(spec: ModelSpec,
                text_len: Optional[int] = None) -> np.ndarray:
    """Index of the fused pass (type_id=2): the vl-truncated variant when
    max_vl_text_len is set (vilt_module.py:1125), or, given ``text_len``,
    the one of that many text tokens (the same index wherever the JAX
    package's ``fused_index`` fits the sequence)."""
    return text_image_relative_position_index(
        spec.max_text_len, spec.max_text_len_of_initckpt, spec.window,
        spec.max_vl_text_len if text_len is None else text_len)


def text_index(spec: ModelSpec, true_length: Optional[int] = None) -> np.ndarray:
    idx = text_relative_position_index(
        spec.max_text_len, spec.max_text_len_of_initckpt, spec.window)
    if true_length is not None:
        idx = idx[:true_length, :true_length]
    return idx


def image_index(spec: ModelSpec) -> np.ndarray:
    return image_relative_position_index(spec.window)


@functools.lru_cache(maxsize=None)
def video_relative_position_index(window: int, num_frames: int) -> np.ndarray:
    """The image index tiled across frames (vilt_module.py:222):
    ``relative_position_index.repeat(F, F)`` (torch repeat = tile)."""
    return np.tile(image_relative_position_index(window),
                   (num_frames, num_frames))


@functools.lru_cache(maxsize=None)
def text_video_relative_position_index(
    max_text_len: int, max_text_len_of_initckpt: int, window: int,
    num_frames: int, vl_text_len: Optional[int] = None,
) -> np.ndarray:
    """The fused [text; F frames] index (vilt_module.py:219-229, 251-261):
    the cross-modal entries take the single-frame fused index's two
    buckets, the image block is the frame-tiled video index."""
    num_relative_distance = (2 * window - 1) * (2 * window - 1) + 3
    vid_len = (window * window + 1) * num_frames
    t_index = text_relative_position_index(
        max_text_len, max_text_len_of_initckpt, window)
    v_index = video_relative_position_index(window, num_frames)

    t = max_text_len if vl_text_len is None else min(vl_text_len, max_text_len)
    t2i = np.full((t, vid_len), num_relative_distance, dtype=np.int64)
    i2t = np.full((vid_len, t), num_relative_distance + 1, dtype=np.int64)

    top = np.concatenate([t_index[:t, :t], t2i], axis=1)
    bottom = np.concatenate([i2t, v_index], axis=1)
    return np.concatenate([top, bottom], axis=0)


@functools.lru_cache(maxsize=None)
def temporal_relative_position_index(window: int,
                                     num_frames: int) -> np.ndarray:
    """Frame-distance buckets tiled over the patch positions
    (vilt_module.py:233-240): ids in [0, 2F); torch ``.repeat`` = tile."""
    ids = np.arange(num_frames)
    rel = ids[None, :] - ids[:, None]
    rel = rel - rel.min()
    max_imag_len = window * window + 1
    return np.tile(rel, (max_imag_len, max_imag_len)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def mask_for_combining_temporal(window: int, num_frames: int) -> np.ndarray:
    """The block-diagonal same-frame mask, (1, F·N_img, F·N_img)
    (vilt_module.py:244-248): eye(F) repeat_interleaved by N_img both
    ways."""
    n = window * window + 1
    return np.kron(np.eye(num_frames), np.ones((n, n)))[None]


def per_layer_bias(table: torch.Tensor, index: np.ndarray, num_layers: int,
                   num_heads: int,
                   layers: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Gather the shared table into per-layer (heads, N, N) biases.

    Matches ``F.embedding(index, table).permute(2,0,1)`` then
    ``torch.chunk(num_layers, dim=0)`` (vilt_module.py:1061-1064, 1128):
    the (heads*layers) trailing dim is chunked into layer-major groups.
    Returns a contiguous (layers, heads, N, N) float32 tensor on the
    table's device, so each layer's slice is contiguous too.  ``layers``
    gathers only those layers' columns, in that order (len(layers), heads,
    N, N): the layers of a fused pass that read this index.
    """
    n = index.shape[0]
    if layers is not None:
        cols = [l * num_heads + h for l in layers for h in range(num_heads)]
        table = table[:, torch.as_tensor(cols, device=table.device)]
        num_layers = len(layers)
    idx = torch.as_tensor(index, dtype=torch.long, device=table.device)
    gathered = table.float()[idx]                          # N, N, H*L
    return gathered.permute(2, 0, 1).reshape(num_layers, num_heads, n, n) \
        .contiguous()
