"""The port's CUDA kernels against their plain twins, on the card.

Each kernel (K1 ln_linear, K2 packed_attention, K3 proj_mlp_tail, K9
packed_attention_bwd, K13 mlp) runs at its main-path widths (N = 577
tokens, C = 768, 12 heads, MLP 3072) in bf16 and is held against its
plain PyTorch twin on the same inputs.  K1, K3 and K13 round at the same
points as their twins, so they agree to 2 bf16 ulps (f32 summation order
can move a value across a rounding boundary, and erf differs in the last
f32 ulp).  K2 casts exp(s - running max) to bf16 before normalising where
the twin casts the normalised probabilities, and adds the bias inside the
f32 accumulation of q·kᵀ, so it gets 4 ulps.  K9 rounds ds and p to bf16
where its twin does, but a ds that lands on the other side of a rounding
boundary moves the dq and dk sums it enters: 4 ulps of the output plus
4 ulps of the output's mean magnitude; its f32 dbias is held to a
relative norm error of 1e-3.

This file imports no JAX (the machine with the card has none), so it runs
without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA device every test skips.
"""

import pytest
import torch

from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.ops import mlp as TM

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


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(2, 577), (5, 577), (5, 40)])
def test_packed_attention_bwd_kernel_matches_twin_on_card(cuda_device, B, N):
    """B = 5 splits the batch into 3 dbias groups (2 + 2 + 1); N = 40 is a
    single query tile; sample 0 has no valid key and the last one a
    ragged mask."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    H = 12
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=cuda_device, generator=g).bfloat16()
    bias = torch.randn(H, N, N, device=cuda_device, generator=g)
    gout = torch.randn(B, N, C, device=cuda_device, generator=g).bfloat16()
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[0] = 0
    mask[-1, N - 30:] = 0
    n = TA.packed_attention_bwd.launches
    dqkv, dbias = TA.packed_attention_bwd(qkv, bias, mask, gout, 0.125, H)
    assert TA.packed_attention_bwd.launches == n + 1
    want_dqkv, want_dbias = TA.packed_attention_bwd_reference(
        qkv, bias, mask, gout, 0.125, H)
    assert not dqkv[0].float().any()
    _bf16_close(dqkv, want_dqkv, ulps=4)
    rel = float((dbias - want_dbias).norm() / want_dbias.norm())
    assert rel < 1e-3, rel
    again = TA.packed_attention_bwd(qkv, bias, mask, gout, 0.125, H)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1280, 2560 + 7])
def test_mlp_kernel_matches_twin_on_card(cuda_device, M):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    C, Hd = 768, 3072

    def r(*shape, s=1.0, bf16=False):
        t = s * torch.randn(*shape, device=cuda_device, generator=g)
        return t.bfloat16() if bf16 else t

    args = (r(1, M, C, bf16=True), r(Hd, C, s=0.02, bf16=True),
            r(Hd, s=0.1), r(C, Hd, s=0.02, bf16=True), r(C, s=0.1))
    n = TM.mlp_kernel.launches
    got = TM.mlp_kernel(*args)
    assert TM.mlp_kernel.launches == n + 1
    _bf16_close(got, TM.mlp_kernel_reference(*args))


@pytest.mark.cuda
def test_fused_wrappers_backward_on_card(cuda_device):
    """The autograd wrappers run K2/K9 and K13 on the card and hand back
    gradients of the plain route's shapes; g arrives non-contiguous."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, N, H = 2, 577, 12
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=cuda_device,
                      generator=g).bfloat16().requires_grad_()
    bias = torch.randn(H, N, N, device=cuda_device,
                       generator=g).requires_grad_()
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    out = TA.packed_fused_attention(qkv, bias, mask, 0.125, H)
    n = TA.packed_attention_bwd.launches
    gout = torch.randn(B, C, N, device=cuda_device, generator=g).bfloat16()
    dqkv, dbias = torch.autograd.grad(out, (qkv, bias), gout.transpose(1, 2))
    assert TA.packed_attention_bwd.launches == n + 1
    assert dqkv.shape == qkv.shape and dbias.dtype == torch.float32
    x = torch.randn(B, N, C, device=cuda_device,
                    generator=g).bfloat16().requires_grad_()
    w1 = (0.02 * torch.randn(4 * C, C, device=cuda_device,
                             generator=g)).requires_grad_()
    b1 = torch.zeros(4 * C, device=cuda_device, requires_grad=True)
    w2 = (0.02 * torch.randn(C, 4 * C, device=cuda_device,
                             generator=g)).requires_grad_()
    b2 = torch.zeros(C, device=cuda_device, requires_grad=True)
    y = TM.fused_mlp(x, w1, b1, w2, b2)
    grads = torch.autograd.grad(y.float().square().sum(), (x, w1, b1, w2, b2))
    assert [t.dtype for t in grads] == [torch.bfloat16] + [torch.float32] * 4
    assert all(bool(torch.isfinite(t).all()) for t in grads)
