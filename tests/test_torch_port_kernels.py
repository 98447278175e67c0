"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper (ln_linear K1, packed_attention K2,
proj_mlp_tail K3) runs its plain twin; here the twins are held against
the JAX kernels run in Pallas interpret mode, on the same numpy inputs.
In f32 the tolerance is atol = rtol = 2e-5 (summation order only; the
JAX kernels' A&S erf differs from exact erf by <= 1.5e-7).  In bf16 both
sides round at the same points, so they differ only where a value lies
within f32 summation noise of a bf16 rounding boundary: one bf16 ulp
(relative 2^-7 at most).

The CUDA kernels themselves run only on an NVIDIA GPU:
tests/test_torch_port_cuda.py holds them against their twins there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu.ops import attention as A
from vl_merging_tpu.ops import fused_block as F
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = 2.0 ** -7


@pytest.fixture()
def interpret_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU,
    as tests/test_fused_block.py does."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    monkeypatch.setattr(F.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(F, "BLOCK_M", 8)
    monkeypatch.setattr(A, "_INTERPRET", True)


def _arrays(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shp) * s).astype(np.float32) for shp, s in shapes]


def _pair(arrs, dtypes):
    """The same arrays as JAX and as CPU torch tensors, each cast to its
    dtype (``None`` keeps f32)."""
    jx, th = [], []
    for a, dt in zip(arrs, dtypes):
        jx.append(jnp.asarray(a).astype(jnp.bfloat16 if dt == "bf16"
                                        else jnp.float32))
        th.append(torch.from_numpy(a).to(torch.bfloat16 if dt == "bf16"
                                         else torch.float32))
    return jx, th


def _assert_close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max() / 64)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_linear_twin_matches_jax_kernel(interpret_kernels, dtype):
    _check_ln_linear(dtype, 9)  # N odd => the JAX kernel's row padding


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_linear_twin_matches_jax_kernel_ragged_rows(interpret_kernels,
                                                       dtype):
    """130 rows: past a whole number of K1's 128-row blocks."""
    _check_ln_linear(dtype, 65)


def _check_ln_linear(dtype, N):
    B, C, O = 2, 128, 384
    arrs = _arrays(0, [((B, N, C), 0.5), ((C,), 1.0), ((C,), 0.5),
                       ((O, C), 0.05), ((O,), 0.5)])
    (x, lnw, lnb, w, b), (tx, tlnw, tlnb, tw, tb) = _pair(
        arrs, [dtype, None, None, dtype, None])
    want = F.ln_linear(x, lnw, lnb, w, b, use_pallas=True)
    got = TF.ln_linear(tx, tlnw, tlnb, tw, tb)
    assert got.dtype == tx.dtype and got.shape == (B, N, O)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_proj_mlp_tail_twin_matches_jax_kernel(interpret_kernels, dtype):
    B, N, C, H = 2, 9, 128, 512
    arrs = _arrays(1, [((B, N, C), 0.5), ((C, C), 0.05), ((C,), 0.5),
                       ((C,), 0.1), ((B, N, C), 0.5), ((C,), 1.0),
                       ((C,), 0.5), ((H, C), 0.05), ((H,), 0.5),
                       ((C, H), 0.05), ((C,), 0.5), ((C,), 0.1)])
    dts = [dtype, dtype, None, None, dtype, None, None, dtype, None, dtype,
           None, None]
    jargs, targs = _pair(arrs, dts)
    want = F.proj_mlp_tail(*jargs, use_pallas=True)
    got = TF.proj_mlp_tail(*targs)
    assert got.dtype == targs[0].dtype and got.shape == (B, N, C)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_twin_matches_jax_kernel(interpret_kernels, dtype):
    _check_packed_attention(dtype, 32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_twin_matches_jax_kernel_ragged_keys(
        interpret_kernels, dtype):
    """129 tokens: one query row past K2's 128-row item and one key past
    its two 64-key tiles."""
    _check_packed_attention(dtype, 129)


def _check_packed_attention(dtype, N):
    B, H, d = 2, 2, 64
    C = H * d
    qkv_a, bias_a = _arrays(2, [((B, N, 3 * C), 1.0), ((H, N, N), 1.0)])
    mask_a = np.ones((B, N), np.int32)
    mask_a[0, 20:] = 0          # padded keys in one sample
    mask_a[1, [3, 7, 30]] = 0   # scattered masked keys in the other
    (qkv, bias), (tqkv, tbias) = _pair([qkv_a, bias_a], [dtype, None])
    scale = d ** -0.5
    want = A._pallas_packed_attention(qkv, bias, jnp.asarray(mask_a), scale,
                                      H)
    got = TA.packed_attention(tqkv, tbias, torch.from_numpy(mask_a), scale, H)
    assert got.dtype == tqkv.dtype and got.shape == (B, N, C)
    _assert_close(got, want, dtype)


def test_packed_attention_reads_packed_columns():
    """The twin reads q/k/v at column offsets 0/C/2C and head h at h·64
    (the (B, N, 3, H, d) order of the qkv projection): permuting heads in
    all three thirds permutes the context's heads the same way."""
    B, N, H, d = 1, 16, 3, 64
    C = H * d
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B, N, 3 * C, generator=g)
    bias = torch.randn(H, N, N, generator=g)
    mask = torch.ones(B, N, dtype=torch.int32)
    perm = [2, 0, 1]
    cols = torch.cat([torch.arange(t * C + h * d, t * C + (h + 1) * d)
                      for t in range(3) for h in perm])
    out = TA.packed_attention(qkv, bias, mask, d ** -0.5, H)
    out_p = TA.packed_attention(qkv[..., cols], bias[perm], mask, d ** -0.5,
                                H)
    want = out.reshape(B, N, H, d)[:, :, perm].reshape(B, N, C)
    torch.testing.assert_close(out_p, want, atol=0, rtol=0)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors a wrapper runs its twin and launches nothing."""
    before = (TF.ln_linear.launches, TA.packed_attention.launches,
              TF.proj_mlp_tail.launches)
    x = torch.randn(1, 4, 64)
    TF.ln_linear(x, torch.ones(64), torch.zeros(64), torch.randn(128, 64),
                 torch.zeros(128))
    assert (TF.ln_linear.launches, TA.packed_attention.launches,
            TF.proj_mlp_tail.launches) == before
