"""Host-side Python of the Hopper design of K1, on the CPU.

K1 takes O in whole 256-column tiles (``ops/fused_block.require_qkv_tile``,
asked before any launch).  The kernels themselves run only on the card
(tests/test_torch_port_cuda.py).
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
