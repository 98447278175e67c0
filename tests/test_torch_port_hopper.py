"""Host-side Python of the Hopper designs of K1, K7, K10 and K11, on the CPU.

K1 takes O in whole 256-column tiles (``ops/fused_block.require_qkv_tile``,
asked before any launch); K7 takes its batch in chunks whose scratch fits
the L2 (``ops/fused_block.block_eval_chunk``); K10 and K11 take q, k and v
through the strides their 4-D tensor maps need, checked once per layout
(``ops/attention._split_strides``).  The kernels themselves run only on
the card (tests/test_torch_port_cuda.py).
"""

import pytest

from vl_merging_tpu_torch.ops import fused_block as TF
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("C,O", [(768, 2304), (1024, 3072), (768, 256)])
def test_require_qkv_tile_takes_whole_tiles(C, O):
    TF.require_qkv_tile(C, O)


@pytest.mark.parametrize("C,O", [(768, 2304 + 128), (1024, 3072 - 64),
                                 (768, 384)])
def test_require_qkv_tile_raises_on_a_partial_tile(C, O):
    with pytest.raises(ValueError, match="O % 256 == 0"):
        TF.require_qkv_tile(C, O)


@pytest.mark.parametrize("C", [192, 512])
def test_require_qkv_tile_raises_on_an_unbuilt_width(C):
    with pytest.raises(ValueError, match="not built for C="):
        TF.require_qkv_tile(C, 3 * C)


@pytest.mark.parametrize("B,N,clusters", [(32, 577, 30), (32, 577, 33),
                                          (3, 577, 30), (1, 40, 30),
                                          (64, 577, 16), (32, 197, 30)])
def test_block_eval_chunk_fits_the_scratch(B, N, clusters):
    """K7's chunk: bb elements whose packed qkv and context (bb·N·4C bf16)
    fit the scratch, no fewer rounds of 64-row body blocks than any other
    bb that fits, the largest such bb."""
    C = 768
    bb = TF.block_eval_chunk(B, N, C, clusters)
    assert 1 <= bb <= B
    assert bb * N * 4 * C * 2 <= TF._SCRATCH_BYTES

    def rounds(k):
        return sum(-(-(-(-min(k, B - c0) * N // 64)) // clusters)
                   for c0 in range(0, B, k))
    fits = [k for k in range(1, B + 1) if k * N * 4 * C * 2 <= TF._SCRATCH_BYTES]
    best = min(rounds(k) for k in fits)
    assert rounds(bb) == best
    assert bb == max(k for k in fits if rounds(k) == best)


def test_block_eval_chunk_at_the_main_path():
    """32 images @384 on the H100's 30 clusters of four: chunks of 9, 9, 9
    and 5 elements, 11 rounds of body blocks."""
    assert TF.block_eval_chunk(32, 577, 768, 30) == 9


def _split_layout(B, N, H, qkv_views=True, bias_shape=None):
    """The arguments ``_split_strides`` takes for q, k, v of (B, H, N, 64):
    the views of a packed qkv (as the towers hand them over) or contiguous
    tensors, on meta tensors (shapes and strides only)."""
    import torch

    if qkv_views:
        qkv = torch.empty(B, N, 3 * H * 64, dtype=torch.bfloat16,
                          device="meta")
        q, k, v = qkv.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (torch.empty(B, H, N, 64, dtype=torch.bfloat16,
                               device="meta") for _ in range(3))
    dev = torch.device("cuda", 0)
    return (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
            (q.dtype, k.dtype, v.dtype), (dev,) * 5,
            bias_shape or (H, N, N), (B, N))


@pytest.mark.parametrize("B,N,H", [(6, 197, 12), (32, 197, 12),
                                   (4, 577, 16), (3, 40, 3)])
@pytest.mark.parametrize("qkv_views", [True, False])
def test_split_strides_of_the_towers_views(B, N, H, qkv_views):
    """K10/K11 read q, k, v through (element, head, token) strides, the
    packed qkv's views without a copy, and write a (B, N, H, 64) output
    seen as (B, H, N, 64)."""
    from vl_merging_tpu_torch.ops import attention as TA

    got = TA._split_strides("vlm_split_attention",
                            *_split_layout(B, N, H, qkv_views))
    C = H * 64
    if qkv_views:
        want_qkv = (N * 3 * C, 64, 3 * C) * 3
    else:
        want_qkv = (H * N * 64, N * 64, 64) * 3
    assert got == want_qkv + (N * C, 64, C)


def test_split_strides_raise_on_what_the_kernels_do_not_take():
    """A head dim other than 64, a stride that is not a positive multiple
    of 8 (the tensor maps' 16-byte rows), a head dim that is not
    contiguous, another dtype, a bias or mask of another shape, or tensors
    on two devices: ValueError before any launch."""
    import torch

    from vl_merging_tpu_torch.ops import attention as TA

    entry = "vlm_split_attention"
    good = list(_split_layout(4, 197, 12))
    for i, value, match in (
            (0, torch.Size((4, 12, 197, 32)), "head_dim 64"),
            (3, (197 * 2304, 64, 2300, 1), "multiples of 8"),
            (4, (197 * 2304, 64, 0, 1), "multiples of 8"),
            (5, (197 * 2304, 1, 2304, 64), "contiguous head dim"),
            (6, (torch.bfloat16, torch.float16, torch.bfloat16), "bf16"),
            (8, (12, 197, 196), "bias"),
            (9, (4, 196), "mask"),
            (7, (torch.device("cuda", 0),) * 4 + (torch.device("cpu"),),
             "devices")):
        args = list(good)
        args[i] = value
        with pytest.raises(ValueError, match=match):
            TA._split_strides(entry, *args)
