"""The port's CUDA kernels against their plain twins, on the card.

Each kernel (K1 ln_linear, K2 packed_attention, K3 proj_mlp_tail) runs at
its main-path widths (N = 577 tokens, C = 768, 12 heads, MLP 3072) in bf16
and is held against its plain PyTorch twin on the same inputs.  K1 and K3
round at the same points as their twins, so they agree to 2 bf16 ulps
(f32 summation order can move a value across a rounding boundary, and
the twin's erf differs from CUDA's erff in the last ulp).  K2 casts
exp(s - running max) to bf16 before normalising where the twin casts
the normalised probabilities, and adds the bias inside the f32
accumulation of q·kᵀ, so it gets 4 ulps.

This file imports no JAX (the machine with the card has none), so it runs
without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA device every test skips.
"""

import pytest
import torch

from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF

BF16_ULP = 2.0 ** -7


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from vl_merging_tpu_torch.device import require_cuda

    return require_cuda()


def _bf16_close(got, want, ulps=2):
    err = (got.float() - want.float()).abs()
    bound = ulps * BF16_ULP * (want.float().abs() + want.float().abs().mean())
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
def test_ln_linear_kernel_matches_twin_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, N, C, O = 2, 577, 768, 2304
    x = torch.randn(B, N, C, device=cuda_device, generator=g).bfloat16()
    lnw = 1 + 0.1 * torch.randn(C, device=cuda_device, generator=g)
    lnb = 0.1 * torch.randn(C, device=cuda_device, generator=g)
    w = (0.02 * torch.randn(O, C, device=cuda_device, generator=g)).bfloat16()
    b = 0.1 * torch.randn(O, device=cuda_device, generator=g)
    n = TF.ln_linear.launches
    got = TF.ln_linear(x, lnw, lnb, w, b)
    assert TF.ln_linear.launches == n + 1
    _bf16_close(got, TF.ln_linear_reference(x, lnw, lnb, w, b))


@pytest.mark.cuda
def test_packed_attention_kernel_matches_twin_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, N, H = 2, 577, 12
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=cuda_device, generator=g).bfloat16()
    bias = torch.randn(H, N, N, device=cuda_device, generator=g)
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[1, 500:] = 0
    got = TA.packed_attention(qkv, bias, mask, 0.125, H)
    want = TA.packed_attention_reference(qkv, bias, mask, 0.125, H)
    _bf16_close(got, want, ulps=4)


@pytest.mark.cuda
def test_proj_mlp_tail_kernel_matches_twin_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, N, C, Hd = 2, 577, 768, 3072

    def r(*shape, s=1.0, bf16=False):
        t = s * torch.randn(*shape, device=cuda_device, generator=g)
        return t.bfloat16() if bf16 else t

    args = (r(B, N, C, bf16=True), r(C, C, s=0.02, bf16=True), r(C, s=0.1),
            r(C, s=0.1), r(B, N, C, bf16=True), 1 + r(C, s=0.1), r(C, s=0.1),
            r(Hd, C, s=0.02, bf16=True), r(Hd, s=0.1),
            r(C, Hd, s=0.02, bf16=True), r(C, s=0.1), r(C, s=0.1))
    _bf16_close(TF.proj_mlp_tail(*args), TF.proj_mlp_tail_reference(*args))
