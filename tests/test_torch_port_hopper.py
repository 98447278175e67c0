"""Host-side Python of the Hopper designs of K1 and K7, on the CPU.

K1 takes O in whole 256-column tiles (``ops/fused_block.require_qkv_tile``,
asked before any launch); K7 takes its batch in chunks whose scratch fits
the L2 (``ops/fused_block.block_eval_chunk``).  The kernels themselves run
only on the card (tests/test_torch_port_cuda.py).
"""

import pytest

from vl_merging_tpu_torch.ops import fused_block as TF


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
