"""The port's CUDA kernels against their plain twins, on the card.

Each kernel (K1 ln_linear, K2 packed_attention, K3 proj_mlp_tail, K9
packed_attention_bwd, K13 mlp, and the int8 eval's K12
packed_attention_i8qk, K14 ln_linear_i8, K15 proj_mlp_tail_i8) runs at
its main-path widths (N = 577
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
relative norm error of 1e-3.  The int8 kernels quantize exactly as their
twins do and sum their s8·s8 products exactly in s32; what differs is
the f32 LayerNorm statistics' summation order (K14, K15), which can move
a quantized value across a rounding tie, and K2's softmax (K12): K14 is
held to 2 ulps, K15 and K12 to 4.  The eval block's fusion kernels: K4
linear_residual and K5 mlp_tail round where their twins do (K3's two
halves), 2 ulps; K8 ln_qkv_attention runs K1's and K2's code and equals
K1 → K2 bit for bit, within 4 ulps of its twin (K2's softmax); K7
block_eval runs K1's, K2's and K3's code and equals K1 → K2 → K3 bit for
bit, within 4 ulps of its twin.
The image tower takes the launches of the route ``fusion`` names.  The
split-layout attention, K10 split_attention and K11 split_attention_bb,
runs K2's device code over strided q, k, v: 4 ulps, and the two give the
same bits, K2's bits on the packed qkv whose views they read;
K6 tail_train is K3 with per-element gammas, 2 ulps, and K3's bits when
every element's gammas are K3's.  A @224 image tower layer takes K11 or
K10; a training block under ``train_fusion`` takes K6 (and K1 under
"full").

The fused VL pass: K2 over joint text + image lengths (N = 617, 941)
with caption padding inside the key range, K2's training launch and K9
at N = 617 (at 12 heads and at the ViT-L VQA's 16), K7 and K8 at N =
617, and one full-width VL block, split and joint, against the plain
path.

Distribution: two ranks on the one card under gloo, their step's loss
and averaged gradients against one process's over the global batch, and
the step at world 1 under NCCL bit-equal to the step without a group.

Fault C10: ``ops/int8.quantize_weight`` gives on the card the CPU's int8
weights and scales bit for bit.  The merging suite on the card:
``merging/device.py`` against the port's host merging (4 ulp, and the
JAX package's 5e-5 pin for ``regmean_device``), and towers under a gram
tap launching K2 alone.

This file imports no JAX (the machine with the card has none), so it runs
without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA device every test skips.
"""

import pytest
import torch

from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.ops import int8 as TI
from vl_merging_tpu_torch.ops import mlp as TM
from torch_port_threads import one_torch_thread  # noqa: F401

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
@pytest.mark.parametrize("C", [768, 1024])
@pytest.mark.parametrize("M", [1, 1280, 3 * 577, 32 * 577])
def test_ln_linear_tile_edges_on_card(cuda_device, M, C):
    """K1's 128 x 256 tiles, two 128-row blocks a cluster sharing each W
    tile: M = 1 (the cluster's second CTA holds no row), 1280 (a text
    batch: a partial wave), 3·577 and 32·577 (the last block ragged), at
    O = 3C; within 2 ulps of the twin, and two launches agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(M + C)
    O = 3 * C
    x = torch.randn(1, M, C, device=cuda_device, generator=g).bfloat16()
    lnw = 1 + 0.1 * torch.randn(C, device=cuda_device, generator=g)
    lnb = 0.1 * torch.randn(C, device=cuda_device, generator=g)
    w = (0.02 * torch.randn(O, C, device=cuda_device, generator=g)).bfloat16()
    b = 0.1 * torch.randn(O, device=cuda_device, generator=g)
    got = TF.ln_linear(x, lnw, lnb, w, b)
    _bf16_close(got, TF.ln_linear_reference(x, lnw, lnb, w, b))
    assert torch.equal(TF.ln_linear(x, lnw, lnb, w, b), got)


@pytest.mark.cuda
def test_ln_linear_raises_before_launch_on_a_partial_tile(cuda_device):
    C, O = 768, 2304 + 128
    x = torch.zeros(1, 8, C, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(O, C, device=cuda_device, dtype=torch.bfloat16)
    n = TF.ln_linear.launches
    with pytest.raises(ValueError, match="O % 256 == 0"):
        TF.ln_linear(x, torch.ones(C, device=cuda_device),
                     torch.zeros(C, device=cuda_device), w,
                     torch.zeros(O, device=cuda_device))
    assert TF.ln_linear.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("N", [40, 65, 129, 300, 577])
def test_packed_attention_tile_edges_on_card(cuda_device, N, H):
    """K2 at the edges of its 128-query-row items and 64-key tiles (the
    last one 16, 32 or 64 keys wide), reading a layer's slice of an
    (L, H, N, N) bias table that starts 4 bytes past a 16-byte boundary
    (fault C6).  Element 0 has a ragged mask, element 1 scattered masked
    keys, element 2 no valid key.  The training launch's context is
    bit-equal to the eval launch's; its statistics are within 1e-5 of the
    plain ones, m = -inf and l = 0 on element 2; the context of elements 0
    and 1 within 4 ulps of the twin."""
    g = torch.Generator(device=cuda_device).manual_seed(100 * N + H)
    B, C, L = 3, 64 * H, 2
    qkv = torch.randn(B, N, 3 * C, device=cuda_device, generator=g).bfloat16()
    flat = torch.randn(L * H * N * N + 1, device=cuda_device, generator=g)
    bias = flat[1:].view(L, H, N, N)[1]
    assert bias.data_ptr() % 16 != 0
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[0, N - N // 3:] = 0
    mask[1, ::3] = 0
    mask[2] = 0
    n = TA.packed_attention.launches
    ctx, stats = TA.packed_attention(qkv, bias, mask, 0.125, H,
                                     with_stats=True)
    ctx_eval = TA.packed_attention(qkv, bias, mask, 0.125, H)
    assert TA.packed_attention.launches == n + 2
    assert torch.equal(ctx.nan_to_num(), ctx_eval.nan_to_num())
    want = TA.packed_attention_reference(qkv, bias, mask, 0.125, H)
    _bf16_close(ctx[:2], want[:2], ulps=4)
    ref = TA.packed_attention_stats_reference(qkv, bias, mask, 0.125, H)
    assert bool((stats[0, 2] == float("-inf")).all())
    assert bool((stats[1, 2] == 0).all())
    err = (stats[:, :2] - ref[:, :2]).abs() / (1 + ref[:, :2].abs())
    assert float(err.max()) <= 1e-5, float(err.max())


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
    """K9 fed K2's training launch's softmax statistics (its context held
    bit-equal to the eval launch's), against its twin fed the plain
    forward's statistics (D = Σ_k dp ⊙ p in f32 on both): B = 5 splits the
    batch
    into 3 dbias groups (2 + 2 + 1); N = 40 is a single query tile; sample
    0 has no valid key (l = 0: p = 0, zero gradients, a finite dbias) and
    the last one a ragged mask."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    H = 12
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=cuda_device, generator=g).bfloat16()
    bias = torch.randn(H, N, N, device=cuda_device, generator=g)
    gout = torch.randn(B, N, C, device=cuda_device, generator=g).bfloat16()
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[0] = 0
    mask[-1, N - 30:] = 0
    # K2's training launch: the context and the softmax statistics K9 reads
    o, stats = TA.packed_attention(qkv, bias, mask, 0.125, H,
                                   with_stats=True)
    assert torch.equal(o.nan_to_num(), TA.packed_attention(
        qkv, bias, mask, 0.125, H).nan_to_num())  # the eval launch's bits
    ref = TA.packed_attention_stats_reference(qkv, bias, mask, 0.125, H)
    assert bool((stats[1, 0] == 0).all()) and bool((stats[1, 1:] > 0).all())
    torch.testing.assert_close(stats[:, 1:], ref[:, 1:], rtol=1e-5,
                               atol=1e-5)
    n = TA.packed_attention_bwd.launches
    dqkv, dbias = TA.packed_attention_bwd(qkv, bias, mask, gout, stats,
                                          0.125, H)
    assert TA.packed_attention_bwd.launches == n + 1
    # the twin reads the plain forward's statistics, so that its p is the
    # plain softmax: the plain backward throughout
    want_dqkv, want_dbias = TA.packed_attention_bwd_reference(
        qkv, bias, mask, gout, ref, 0.125, H)
    assert not dqkv[0].float().any()
    _bf16_close(dqkv, want_dqkv, ulps=4)
    rel = float((dbias - want_dbias).norm() / want_dbias.norm())
    assert rel < 1e-3, rel
    assert bool(torch.isfinite(dbias).all())
    again = TA.packed_attention_bwd(qkv, bias, mask, gout, stats, 0.125, H)
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


def _int8_tail_args(dev, g, B, N, C=768, Hd=3072):
    def r(*shape, s=1.0, bf16=False):
        t = s * torch.randn(*shape, device=dev, generator=g)
        return t.bfloat16() if bf16 else t

    pq, ps = TI.quantize_weight(r(C, C, s=0.02))
    w1q, w1s = TI.quantize_weight(r(Hd, C, s=0.02))
    w2q, w2s = TI.quantize_weight(r(C, Hd, s=0.02))
    return (r(B, N, C, bf16=True), pq, ps, r(C, s=0.1), r(C, s=0.1),
            r(B, N, C, bf16=True), 1 + r(C, s=0.1), r(C, s=0.1), w1q, w1s,
            r(Hd, s=0.1), w2q, w2s, r(C, s=0.1), r(C, s=0.1))


@pytest.mark.cuda
def test_ln_linear_i8_kernel_matches_twin_on_card(cuda_device):
    """M = 3·577 rows, not a multiple of the 128-row block; two launches
    agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    B, N, C, O = 3, 577, 768, 2304
    x = torch.randn(B, N, C, device=cuda_device, generator=g).bfloat16()
    lnw = 1 + 0.1 * torch.randn(C, device=cuda_device, generator=g)
    lnb = 0.1 * torch.randn(C, device=cuda_device, generator=g)
    wq, ws = TI.quantize_weight(
        0.02 * torch.randn(O, C, device=cuda_device, generator=g))
    b = 0.1 * torch.randn(O, device=cuda_device, generator=g)
    n = TI.ln_linear_i8.launches
    got = TI.ln_linear_i8(x, lnw, lnb, wq, ws, b)
    assert TI.ln_linear_i8.launches == n + 1
    _bf16_close(got, TI.ref_ln_linear_i8(x, lnw, lnb, wq, ws, b))
    assert torch.equal(TI.ln_linear_i8(x, lnw, lnb, wq, ws, b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 100, 3 * 577 + 5])
def test_ln_linear_i8_ragged_rows_and_a_zero_row_on_card(cuda_device, M):
    """K14's 128 x 256 tiles, two 128-row blocks a cluster: M < 128 (the
    cluster's second CTA holds no row) and M % 128 != 0, with an all-zero
    row of x among them (its LN statistics at the eps floor), within 2 ulps
    of the twin; two launches agree bit for bit, and units of 3 column
    tiles give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(27)
    C, O = 768, 2304
    x = torch.randn(1, M, C, device=cuda_device, generator=g).bfloat16()
    x[0, M // 2] = 0
    lnw = 1 + 0.1 * torch.randn(C, device=cuda_device, generator=g)
    lnb = 0.1 * torch.randn(C, device=cuda_device, generator=g)
    wq, ws = TI.quantize_weight(
        0.02 * torch.randn(O, C, device=cuda_device, generator=g))
    b = 0.1 * torch.randn(O, device=cuda_device, generator=g)
    got = TI.ln_linear_i8(x, lnw, lnb, wq, ws, b)
    _bf16_close(got, TI.ref_ln_linear_i8(x, lnw, lnb, wq, ws, b))
    assert torch.equal(TI.ln_linear_i8(x, lnw, lnb, wq, ws, b), got)
    assert torch.equal(TI.ln_linear_i8(x, lnw, lnb, wq, ws, b, group=3), got)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["poly", "poly11", "poly13", "erf"])
def test_proj_mlp_tail_i8_kernel_matches_twin_on_card(cuda_device, gelu):
    """M = 3·577 rows, not a multiple of the 64-row block; every gelu;
    two launches agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    args = _int8_tail_args(cuda_device, g, 3, 577)
    n = TI.proj_mlp_tail_i8.launches
    got = TI.proj_mlp_tail_i8(*args, gelu=gelu)
    assert TI.proj_mlp_tail_i8.launches == n + 1
    _bf16_close(got, TI.ref_proj_mlp_tail_i8(*args, gelu=gelu), ulps=4)
    assert torch.equal(TI.proj_mlp_tail_i8(*args, gelu=gelu), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 577), (1, 40)])
def test_proj_mlp_tail_i8_at_the_amax_floors_on_card(cuda_device, B, N):
    """K15 with rows of context all zero (the quantizer's amax floor: a
    scale of 1e-8/127 and int8 zeros), in the first and the last, ragged
    64-row block, against its twin within 4 ulps."""
    g = torch.Generator(device=cuda_device).manual_seed(24)
    args = list(_int8_tail_args(cuda_device, g, B, N))
    ctx = args[0].clone()
    ctx[0, :3] = 0
    ctx[-1, -1] = 0
    args[0] = ctx
    got = TI.proj_mlp_tail_i8(*args)
    assert bool(torch.isfinite(got).all())
    _bf16_close(got, TI.ref_proj_mlp_tail_i8(*args), ulps=4)


def _i8qk_inputs(dev, seed, B, N, H):
    """K12's qkv (B, N, 3·64H) bf16 with the quantizer's edge rows, and an
    (H, N, N) bias.  Token 0's q and k rows of head 0 are (k + 1/2)·2⁻⁶
    with an amax of 127·2⁻⁶, so that the scale is 2⁻⁶ exactly and every
    x / scale lands on a rounding tie; the last token's q row of the last
    head and token N // 2's k row of head 1 are zeros (amax 0: the scale
    1e-8/127)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=dev, generator=g)
    ties = torch.randint(-60, 61, (2, 64), device=dev, generator=g) + 0.5
    ties[:, 0] = 127
    qkv[:, 0, :64] = ties[0] / 64
    qkv[:, 0, C:C + 64] = ties[1] / 64
    qkv[:, -1, C - 64:C] = 0
    qkv[:, N // 2, C + 64:C + 128] = 0
    return qkv.bfloat16(), torch.randn(H, N, N, device=dev, generator=g)


def _close_where_defined(got, want, ulps):
    """NaN exactly where the twin is NaN (0/0: a sample with no valid key),
    within ``ulps`` bf16 ulps elsewhere."""
    nan = want.float().isnan()
    assert torch.equal(got.float().isnan(), nan)
    _bf16_close(got[~nan], want[~nan], ulps=ulps)


# K12's card cases: every last-key-tile width (N = 1, 16, 17, 64, 65,
# 197, 577, 901: 16, 16, 32, 64, 16, 16, 16, 64 keys, and 1-row tails),
# head counts 3, 12, 16, batches 1, 6, 32
I8QK_N = [1, 16, 17, 64, 65, 197, 577, 901]
I8QK_H = [3, 12, 16]
I8QK_B = [1, 6, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("B", I8QK_B)
@pytest.mark.parametrize("H", I8QK_H)
@pytest.mark.parametrize("N", I8QK_N)
def test_packed_attention_i8qk_kernel_matches_twin_on_card(cuda_device, N, H,
                                                           B):
    """K12 (K2's device code, int8 q·kᵀ) within 4 ulps of its twin: a
    ragged mask on element 0, no valid key on the last element (B > 1),
    rows on the quantizer's rounding ties and rows of zeros."""
    qkv, bias = _i8qk_inputs(cuda_device, 1000 * N + 10 * H + B, B, N, H)
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[0, N - N // 3:] = 0
    if B > 1:
        mask[-1] = 0
    n = TA.packed_attention_i8qk.launches
    got = TA.packed_attention_i8qk(qkv, bias, mask, 0.125, H)
    assert TA.packed_attention_i8qk.launches == n + 1
    want = TA.packed_attention_i8qk_reference(qkv, bias, mask, 0.125, H)
    _close_where_defined(got, want, ulps=4)


@pytest.mark.cuda
def test_packed_attention_i8qk_is_deterministic_on_card(cuda_device):
    """Two launches of K12 on the same inputs agree bit for bit."""
    B, N, H = 32, 577, 12
    qkv, bias = _i8qk_inputs(cuda_device, 8, B, N, H)
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[-1, 500:] = 0
    got = TA.packed_attention_i8qk(qkv, bias, mask, 0.125, H)
    assert torch.equal(TA.packed_attention_i8qk(qkv, bias, mask, 0.125, H),
                       got)


@pytest.mark.cuda
def test_packed_attention_i8qk_raises_on_a_qkv_requiring_grad_on_card(
        cuda_device):
    """K12 is eval only: a qkv that requires grad raises before any
    launch."""
    B, N, H = 2, 65, 12
    qkv, bias = _i8qk_inputs(cuda_device, 9, B, N, H)
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    n = TA.packed_attention_i8qk.launches
    with pytest.raises(ValueError, match="eval only"):
        TA.packed_attention_i8qk(qkv.clone().requires_grad_(), bias, mask,
                                 0.125, H)
    assert TA.packed_attention_i8qk.launches == n


def _block_args(dev, g, B, N, C=768, H=12, Hd=3072):
    def r(*shape, s=1.0, bf16=False):
        t = s * torch.randn(*shape, device=dev, generator=g)
        return t.bfloat16() if bf16 else t

    mask = torch.ones(B, N, dtype=torch.int32, device=dev)
    mask[-1, N - 70:] = 0
    return (r(B, N, C, bf16=True), 1 + r(C, s=0.1), r(C, s=0.1),
            r(3 * C, C, s=0.02, bf16=True), r(3 * C, s=0.1), r(H, N, N), mask,
            0.125, H, r(C, C, s=0.02, bf16=True), r(C, s=0.1), r(C, s=0.1),
            1 + r(C, s=0.1), r(C, s=0.1), r(Hd, C, s=0.02, bf16=True),
            r(Hd, s=0.1), r(C, Hd, s=0.02, bf16=True), r(C, s=0.1),
            r(C, s=0.1))


@pytest.mark.cuda
def test_linear_residual_and_mlp_tail_kernels_match_twins_on_card(
        cuda_device):
    """K4 and K5 at M = 3·577 rows (not a multiple of their row blocks);
    K4 → K5 within 2 ulps of K3 on the same inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    args = _block_args(cuda_device, g, 3, 577)
    ctx = args[0]
    wp, bp, g1, lnw, lnb, w1, b1, w2, b2, g2 = args[9:]
    res = torch.randn(ctx.shape, device=cuda_device, generator=g).bfloat16()
    n = (TF.linear_residual.launches, TF.mlp_tail.launches)
    x1 = TF.linear_residual(ctx, wp, bp, g1, res)
    _bf16_close(x1, TF.linear_residual_reference(ctx, wp, bp, g1, res))
    out = TF.mlp_tail(x1, lnw, lnb, w1, b1, w2, b2, g2)
    _bf16_close(out, TF.mlp_tail_reference(x1, lnw, lnb, w1, b1, w2, b2, g2))
    assert (TF.linear_residual.launches, TF.mlp_tail.launches) == \
        (n[0] + 1, n[1] + 1)
    k3 = TF.proj_mlp_tail(ctx, wp, bp, g1, res, lnw, lnb, w1, b1, w2, b2, g2)
    _bf16_close(out, k3)
    assert torch.equal(TF.proj_mlp_tail(ctx, wp, bp, g1, res, lnw, lnb, w1,
                                        b1, w2, b2, g2, fusion="pair"), out)


def _bits(t):
    """A bf16 tensor's bits (a NaN equals the same NaN: the 0/0 context of
    a row with no valid key)."""
    return t.view(torch.int16)


def _staged_k1_k2(args):
    x, lnw, lnb, w, b, bias, mask, scale, H = args
    return TA.packed_attention(TF.ln_linear(x, lnw, lnb, w, b), bias, mask,
                               scale, H)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 577), (2, 300)])
def test_ln_qkv_attention_kernel_matches_twin_on_card(cuda_device, B, N):
    """K8 against its twin (K1's then K2's) and bit-equal to the K1 → K2
    kernels, whose device code it runs; a ragged key mask; two launches
    agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    args = _block_args(cuda_device, g, B, N)[:9]
    n = TF.ln_qkv_attention.launches
    got = TF.ln_qkv_attention(*args)
    assert TF.ln_qkv_attention.launches == n + 1
    _bf16_close(got, TF.ln_qkv_attention_reference(*args), ulps=4)
    assert torch.equal(got, _staged_k1_k2(args))
    assert torch.equal(TF.ln_qkv_attention(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,dead", [(2, 901, 768, False),
                                        (3, 577, 1024, False),
                                        (3, 577, 768, True)])
def test_ln_qkv_attention_equals_k1_k2_on_card(cuda_device, B, N, C, dead):
    """K8 bit-equal to K1 → K2 at N = 901 (the @480 image tower, beyond
    the 640 keys the design before took), at the ViT-L width (C = 1024, 16
    heads), and on a batch whose sample 1 has no valid key (its rows 0/0
    in both); within 4 ulps of its twin on the live rows."""
    g = torch.Generator(device=cuda_device).manual_seed(25)
    args = list(_block_args(cuda_device, g, B, N, C=C, H=C // 64)[:9])
    if dead:
        args[6] = args[6].clone()
        args[6][1] = 0
    got = TF.ln_qkv_attention(*args)
    assert torch.equal(_bits(got), _bits(_staged_k1_k2(args)))
    live = args[6].any(dim=1)
    _bf16_close(got[live], TF.ln_qkv_attention_reference(*args)[live], ulps=4)


@pytest.mark.cuda
def test_ln_qkv_attention_handoff_holds_under_delay_on_card(cuda_device):
    """K8's two roles meet only through the per-element counters: with
    every K1-role tile's stores held back (the entry's test-only delay), on
    the fewest K1-role CTAs and in units of whole row pairs, the K2 role
    would read unwritten qkv rows if an item did not wait for its element;
    every launch gives the bits of K1 → K2."""
    g = torch.Generator(device=cuda_device).manual_seed(26)
    args = _block_args(cuda_device, g, 4, 577)[:9]
    want = _staged_k1_k2(args)
    for split, unit, delay in ((2, 9, 20000), (60, 1, 5000), (2, 3, 10000),
                               (60, 3, 0)):
        for _ in range(3):
            got = TF.ln_qkv_attention(*args, split=split, unit=unit,
                                      delay_ns=delay)
            assert torch.equal(got, want), (split, unit, delay)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 577), (2, 300)])
def test_block_eval_kernel_matches_twin_on_card(cuda_device, B, N):
    """K7 against its twin and bit-equal to the K1 → K2 → K3 kernels; two
    launches agree bit for bit, and so does a traced one, whose per-CTA
    trace counts each of K1's pair tiles (128 rows x 128 of the 2304 qkv
    columns) once per CTA of its pair, every K2 (element, 64 query rows,
    head) item once and every 64-row body block once per CTA of its
    cluster, over the chunks of ``block_eval_chunk``."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    args = _block_args(cuda_device, g, B, N)
    n = TF.block_eval.launches
    got = TF.block_eval(*args)
    assert TF.block_eval.launches == n + 1
    _bf16_close(got, TF.block_eval_reference(*args), ulps=4)
    assert torch.equal(got, TF.fused_eval_block(*args))
    assert torch.equal(TF.block_eval(*args), got)
    grid = TF.block_eval_grid(768)
    trace = torch.zeros(grid, 12, dtype=torch.int64, device=cuda_device)
    assert torch.equal(TF.block_eval(*args, trace=trace), got)
    t = trace.cpu()
    bb = TF.block_eval_chunk(B, N, 768, grid // 4)
    chunks = [min(bb, B - c0) * N for c0 in range(0, B, bb)]
    pairs = sum(-(-m // 128) for m in chunks)   # K1's 128-row tiles of a pair
    assert int(t[:, 6].sum()) == 2 * pairs * (3 * 768 // 128)
    assert int(t[:, 7].sum()) == B * 12 * -(-N // 64)
    assert int(t[:, 8].sum()) == 4 * sum(-(-m // 64) for m in chunks)
    assert bool((t[:, 11] == len(chunks)).all())
    assert bool((t[:, :6] >= 0).all()) and bool((t[:, 10] >= t[:, 9]).all())


@pytest.mark.cuda
def test_image_tower_routes_launch_their_kernels_on_card(cuda_device):
    """One ViT-B/16 @384 layer (577 tokens), two images: each ``fusion``
    launches its route's kernels once per layer, and the four routes'
    features agree (cosine 0.9999)."""
    from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
        params_from_numpy
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models import model
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    cfg = build_config("task_finetune_irtr_coco_square_randaug_base_image384",
                       "ufo", overrides=dict(num_layers=1))
    spec = make_model_spec(cfg)
    gen = torch.Generator().manual_seed(12)
    params = eval_cast_params(params_from_numpy(init_params(spec, gen),
                                                cuda_device), spec, cfg)
    image = {"image": torch.randn(2, 3, 384, 384, generator=gen).to(
        cuda_device)}
    kernels = {"ln_linear": TF.ln_linear, "packed_attention":
               TA.packed_attention, "proj_mlp_tail": TF.proj_mlp_tail,
               "linear_residual": TF.linear_residual, "mlp_tail":
               TF.mlp_tail, "ln_qkv_attention": TF.ln_qkv_attention,
               "block_eval": TF.block_eval}
    routes = {"pair": {"ln_linear", "packed_attention", "linear_residual",
                       "mlp_tail"},
              "tail": {"ln_linear", "packed_attention", "proj_mlp_tail"},
              "qkv": {"ln_qkv_attention", "proj_mlp_tail"},
              "mega": {"block_eval"}}
    feats = {}
    for fusion, used in routes.items():
        before = {k: f.launches for k, f in kernels.items()}
        with torch.no_grad():
            feats[fusion] = model.infer_image_ft(params, spec, image,
                                                 fusion=fusion)["cls_feats"]
        launched = {k: f.launches - before[k] for k, f in kernels.items()}
        assert launched == {k: int(k in used) for k in kernels}, fusion
        cos = torch.nn.functional.cosine_similarity(
            feats[fusion].float(), feats["pair"].float(), dim=-1)
        assert float(cos.min()) >= 0.9999, (fusion, float(cos.min()))


def _split_args(dev, g, B, N, H=12, dead=False, joint=False):
    """q, k, v as the (B, H, N, 64) views of a packed qkv (as the towers
    hand them to the split kernels), an f32 bias and a ragged key mask, or
    with ``joint`` the fused pass's joint mask (zeros inside the key
    range); with ``dead``, element 0 has no valid key."""
    qkv = torch.randn(B, N, 3 * H * 64, device=dev, generator=g).bfloat16()
    q, k, v = qkv.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4)
    bias = torch.randn(H, N, N, device=dev, generator=g)
    if joint:
        mask = _joint_mask(dev, g, B, N)
    else:
        mask = torch.ones(B, N, dtype=torch.int32, device=dev)
        mask[-1, N // 2:] = 0
    if dead:
        mask[0] = 0
    return q, k, v, bias, mask, 0.125


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,dead,joint", [(8, 197, 12, False, False),
                                              (4, 577, 12, False, False),
                                              (4, 130, 12, False, False),
                                              (6, 197, 12, False, False),
                                              (32, 197, 12, False, False),
                                              (8, 197, 16, False, False),
                                              (4, 197, 12, True, False),
                                              (32, 237, 12, False, True),
                                              (30, 237, 12, False, True)])
def test_split_attention_kernels_match_twin_on_card(cuda_device, B, N, H,
                                                    dead, joint):
    """K10 and K11 on strided views of a packed qkv against their twin
    (4 ulps: K2's softmax rounding), equal to each other bit for bit (the
    same kernel); contiguous inputs give the same bits; a sample with no
    valid key stores 0/0, as K2 does; K11 refuses a batch that is not a
    multiple of 4.  At a ragged batch (6: the @224 eval's last), K10's
    rows equal K11's over the next multiple of 4 whose first elements they
    are.  ``joint``: the @224 fused pass's 40 + 197 tokens under the joint
    mask, at the pretrain's 32 pairs (K11) and the VQA step's 30 (K10)."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    args = _split_args(cuda_device, g, B, N, H, dead, joint)
    if joint:
        assert bool((args[4][:, :40] == 0).any())
    n = (TA.split_attention.launches, TA.split_attention_bb.launches)
    k10 = TA.split_attention(*args)
    assert k10.shape == args[0].shape
    live = slice(1 if dead else 0, B)
    _bf16_close(k10[live],
                TA.split_attention_reference(*args)[live], ulps=4)
    if dead:
        assert bool(k10[0].isnan().all())
    dense = [t.contiguous() for t in args[:3]]
    assert torch.equal(TA.split_attention(*dense, *args[3:]).nan_to_num(),
                       k10.nan_to_num())
    if B % 4 == 0:
        k11 = TA.split_attention_bb(*args)
        assert torch.equal(k10.nan_to_num(), k11.nan_to_num())
        with pytest.raises(ValueError, match="multiple of 4"):
            TA.split_attention_bb(*(t[:3] for t in args[:3]), args[3],
                                  args[4][:3], args[5])
        assert (TA.split_attention.launches,
                TA.split_attention_bb.launches) == (n[0] + 2, n[1] + 1)
    else:
        wide = _split_args(cuda_device, g, -(-B // 4) * 4, N, H,
                           joint=joint)
        head = (*(t[:B] for t in wide[:3]), wide[3], wide[4][:B], wide[5])
        assert torch.equal(TA.split_attention(*head),
                           TA.split_attention_bb(*wide)[:B])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H", [(6, 197, 12), (32, 197, 12),
                                   (4, 197, 16), (3, 577, 12), (2, 40, 3),
                                   (3, 197, 3)])
def test_split_attention_equals_packed_k2_on_card(cuda_device, B, N, H):
    """K10 and K11 run K2's device code: on the (B, H, N, 64) views of a
    packed qkv they give K2's bits on that qkv (any N), element 0 with no
    valid key (0/0) included.  The bias is layer 1's slice of an (L, H, N,
    N) table; at H = 3, N = 197 it starts off a 16-byte boundary and the
    wrappers copy it (fault C6)."""
    g = torch.Generator(device=cuda_device).manual_seed(7 * N + H)
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=cuda_device, generator=g).bfloat16()
    bias = torch.randn(2, H, N, N, device=cuda_device, generator=g)[1]
    assert (bias.data_ptr() % 16 != 0) == (H * N * N % 4 != 0)
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[0] = 0
    mask[-1, N - N // 3:] = 0
    q, k, v = qkv.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4)
    want = TA.packed_attention(qkv, bias, mask, 0.125, H)
    assert bool(want[0].isnan().all())
    kernels = [TA.split_attention]
    if B % 4 == 0:
        kernels.append(TA.split_attention_bb)
    for kernel in kernels:
        got = kernel(q, k, v, bias, mask, 0.125).transpose(1, 2).reshape(
            B, N, C)
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), \
            kernel.__name__
        assert bool(got[0].isnan().all())
    _bf16_close(want[1:], TA.packed_attention_reference(
        qkv, bias, mask, 0.125, H)[1:], ulps=4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 577), (5, 40)])
def test_tail_train_kernel_matches_twin_on_card(cuda_device, B, N):
    """K6 with per-element gammas against its twin (2 ulps, as K3), at
    row counts whose 32-row blocks straddle elements; with every element's
    gammas equal to K3's γ, K3's bits."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    args = list(_block_args(cuda_device, g, B, N)[9:])
    wp, bp, g1, lnw, lnb, w1, b1, w2, b2, g2 = args
    ctx, res = (torch.randn(B, N, 768, device=cuda_device,
                            generator=g).bfloat16() for _ in range(2))
    keep = 0.9
    dp = (torch.rand(2, B, device=cuda_device, generator=g) < keep).float() \
        / keep
    ge1, ge2 = (dp[i][:, None, None].bfloat16() * gam.bfloat16()
                for i, gam in enumerate((g1, g2)))
    n = TF.tail_train.launches
    got = TF.tail_train(ctx, wp, bp, ge1, res, lnw, lnb, w1, b1, w2, b2, ge2)
    assert TF.tail_train.launches == n + 1
    _bf16_close(got, TF.tail_train_reference(ctx, wp, bp, ge1, res, lnw, lnb,
                                             w1, b1, w2, b2, ge2))
    u1, u2 = (gam.bfloat16().float() for gam in (g1, g2))
    uniform = TF.tail_train(ctx, wp, bp, u1.expand(B, 1, -1), res, lnw, lnb,
                            w1, b1, w2, b2, u2.expand(B, 1, -1))
    assert torch.equal(uniform, TF.proj_mlp_tail(ctx, wp, bp, u1, res, lnw,
                                                 lnb, w1, b1, w2, b2, u2))


@pytest.mark.cuda
def test_train_fusion_launches_and_gradients_on_card(cuda_device):
    """One block at 577 tokens, B = 2, in training: "tail" launches K6 (and
    K2, K9), "full" K1 too; gradients within cosine 0.999 of level "0"."""
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.ckpt.convert import master_params, \
        params_from_numpy
    from vl_merging_tpu_torch.models import mome
    from vl_merging_tpu_torch.models.spec import V, init_params, \
        make_model_spec

    cfg = build_config("task_finetune_irtr_coco_square_randaug_base_image384",
                       "ufo", overrides=dict(num_layers=1))
    spec = make_model_spec(cfg)
    gen = torch.Generator().manual_seed(15)
    params = master_params(params_from_numpy(init_params(spec, gen),
                                             cuda_device))
    g = torch.Generator(device=cuda_device).manual_seed(16)
    x = torch.randn(2, 577, 768, device=cuda_device, generator=g).bfloat16()
    bias = torch.randn(12, 577, 577, device=cuda_device, generator=g)
    mask = torch.ones(2, 577, dtype=torch.int32, device=cuda_device)
    dp = torch.tensor([[1.0, 0.0], [1 / 0.9, 1 / 0.9]], device=cuda_device)
    cot = torch.randn(2, 577, 768, device=cuda_device, generator=g).bfloat16()
    leaves = [k for k in params if k.startswith("transformer.blocks.0.")]
    grads = {}
    for level in ("0", "tail", "full"):
        n = (TF.tail_train.launches, TF.ln_linear.launches)
        out = mome.block_forward(params, spec, spec.blocks[0], x, mask, bias,
                                 V, train=True, dp_scale=dp,
                                 train_fusion=level)
        gs = torch.autograd.grad((out.float() * cot.float()).sum(),
                                 [params[k] for k in leaves],
                                 allow_unused=True)
        grads[level] = torch.cat([t.flatten() for t in gs if t is not None])
        assert (TF.tail_train.launches - n[0],
                TF.ln_linear.launches - n[1]) == \
            {"0": (0, 0), "tail": (1, 0), "full": (1, 1)}[level]
    for level in ("tail", "full"):
        cos = torch.nn.functional.cosine_similarity(
            grads[level].double(), grads["0"].double(), dim=0)
        assert float(cos) >= 0.999, (level, float(cos))


@pytest.mark.cuda
def test_image_tower_at_224_takes_the_split_kernels_on_card(cuda_device):
    """One ViT-B/16 @224 layer (197 tokens): a batch of 4 launches K11
    once, a batch of 2 K10 once, and no packed kernel; features within
    cosine 0.999 of the plain path's."""
    from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
        params_from_numpy
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models import model
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    cfg = build_config("task_finetune_irtr_f30k_square_randaug_base", "ufo",
                       overrides=dict(num_layers=1))
    spec = make_model_spec(cfg)
    gen = torch.Generator().manual_seed(17)
    params = eval_cast_params(params_from_numpy(init_params(spec, gen),
                                                cuda_device), spec, cfg)
    images = torch.randn(4, 3, 224, 224, generator=gen).to(cuda_device)
    counters = (TA.split_attention, TA.split_attention_bb,
                TA.packed_attention, TF.ln_linear)
    for batch, want in ((4, (0, 1, 0, 0)), (2, (1, 0, 0, 0))):
        before = [f.launches for f in counters]
        with torch.no_grad():
            got = model.infer_image_ft(params, spec,
                                       {"image": images[:batch]})["cls_feats"]
            plain = model.infer_image_ft(params, spec,
                                         {"image": images[:batch]},
                                         kernels=False)["cls_feats"]
        assert tuple(f.launches - b for f, b in zip(counters, before)) == want
        cos = torch.nn.functional.cosine_similarity(got.float(),
                                                    plain.float(), dim=-1)
        assert float(cos.min()) >= 0.999, float(cos.min())


def _tail_args(dev, g, B, N, C, Hd):
    """K3's inputs at width C: ctx, Wp, bp, γ1, res, LN2, W1, b1, W2, b2,
    γ2."""
    def r(*shape, s=1.0, bf16=False):
        t = s * torch.randn(*shape, device=dev, generator=g)
        return t.bfloat16() if bf16 else t

    return (r(B, N, C, bf16=True), r(C, C, s=0.02, bf16=True), r(C, s=0.1),
            r(C, s=0.1), r(B, N, C, bf16=True), 1 + r(C, s=0.1), r(C, s=0.1),
            r(Hd, C, s=0.02, bf16=True), r(Hd, s=0.1),
            r(C, Hd, s=0.02, bf16=True), r(C, s=0.1), r(C, s=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ln_linear", "proj_mlp_tail", "mlp",
                                    "tail_train", "linear_residual",
                                    "mlp_tail"])
def test_width_1024_kernels_match_twins_on_card(cuda_device, kernel):
    """ViT-L width (C = 1024, MLP 4096, 16 heads): K1, K3, K13, K6, K4 and
    K5 against their twins at 3·577 rows (not a multiple of 64), within the
    tolerance they keep at 768 (2 ulps)."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    B, N, C, Hd = 3, 577, 1024, 4096
    ctx, wp, bp, g1, res, lnw, lnb, w1, b1, w2, b2, g2 = _tail_args(
        cuda_device, g, B, N, C, Hd)
    if kernel == "ln_linear":
        w = (0.02 * torch.randn(3 * C, C, device=cuda_device,
                                generator=g)).bfloat16()
        b = 0.1 * torch.randn(3 * C, device=cuda_device, generator=g)
        args, fn, twin = (ctx, lnw, lnb, w, b), TF.ln_linear, \
            TF.ln_linear_reference
    elif kernel == "proj_mlp_tail":
        args = (ctx, wp, bp, g1, res, lnw, lnb, w1, b1, w2, b2, g2)
        fn, twin = TF.proj_mlp_tail, TF.proj_mlp_tail_reference
    elif kernel == "mlp":
        args, fn, twin = (ctx, w1, b1, w2, b2), TM.mlp_kernel, \
            TM.mlp_kernel_reference
    elif kernel == "tail_train":
        dp = torch.tensor([1 / 0.9, 0.0, 1 / 0.9], device=cuda_device)
        ge1, ge2 = (dp[:, None, None].bfloat16() * gam.bfloat16()
                    for gam in (g1, g2))
        args = (ctx, wp, bp, ge1, res, lnw, lnb, w1, b1, w2, b2, ge2)
        fn, twin = TF.tail_train, TF.tail_train_reference
    elif kernel == "linear_residual":
        args, fn, twin = (ctx, wp, bp, g1, res), TF.linear_residual, \
            TF.linear_residual_reference
    else:
        args = (res, lnw, lnb, w1, b1, w2, b2, g2)
        fn, twin = TF.mlp_tail, TF.mlp_tail_reference
    n = fn.launches
    got = fn(*args)
    assert fn.launches == n + 1
    _bf16_close(got, twin(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [768, 1024])
def test_mlp_body_bit_equalities_on_card(cuda_device, C):
    """Every kernel on the shared MLP body computes each element with the
    same instructions in the same order: K4 → K5 equals K3, and K6 with
    every element's gammas equal to K3's γ equals K3, bit for bit (K7 at
    768: test_block_eval_kernel_matches_twin_on_card)."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    B, N = 3, 577
    ctx, wp, bp, g1, res, lnw, lnb, w1, b1, w2, b2, g2 = _tail_args(
        cuda_device, g, B, N, C, 4 * C)
    u1, u2 = (gam.bfloat16().float() for gam in (g1, g2))
    k3 = TF.proj_mlp_tail(ctx, wp, bp, u1, res, lnw, lnb, w1, b1, w2, b2, u2)
    k45 = TF.mlp_tail(TF.linear_residual(ctx, wp, bp, u1, res), lnw, lnb, w1,
                      b1, w2, b2, u2)
    k6 = TF.tail_train(ctx, wp, bp, u1.expand(B, 1, C), res, lnw, lnb, w1,
                       b1, w2, b2, u2.expand(B, 1, C))
    assert torch.equal(k45, k3)
    assert torch.equal(k6, k3)


@pytest.mark.cuda
def test_block_eval_equals_the_staged_kernels_on_card(cuda_device):
    """K7 (K1's, K2's and the MLP body's device code, in one cooperative
    launch of clusters) equals K1 → K2 → K3, the kernels whose code it runs,
    bit for bit, and K8 → K3 (K8 runs K1's and K2's code too)."""
    g = torch.Generator(device=cuda_device).manual_seed(22)
    args = _block_args(cuda_device, g, 3, 577)
    got = TF.block_eval(*args)
    assert torch.equal(got, TF.fused_eval_block(*args, fusion="tail"))
    assert torch.equal(got, TF.fused_eval_block(*args, fusion="qkv"))


@pytest.mark.cuda
def test_vit_large_block_takes_k1_k2_k3_on_card(cuda_device):
    """One ViT-L @384 layer (C = 1024, 16 heads, MLP 4096, 577 tokens), two
    images, through ``_block_fast``: K1, K2 and K3 once each and nothing
    else; the features within cosine 0.999 of the plain path; the opt-in
    "mega" route launches K7 once and nothing else, its features bit-equal
    to the default route's."""
    from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
        params_from_numpy
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models import model
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    cfg = build_config("task_finetune_irtr_f30k_square_randaug_large_image384",
                       "ufo", overrides=dict(num_layers=1))
    spec = make_model_spec(cfg)
    assert (spec.hidden_size, spec.num_heads, spec.image_len) == \
        (1024, 16, 577)
    gen = torch.Generator().manual_seed(23)
    params = eval_cast_params(params_from_numpy(init_params(spec, gen),
                                                cuda_device), spec, cfg)
    image = {"image": torch.randn(2, 3, 384, 384, generator=gen).to(
        cuda_device)}
    kernels = {"ln_linear": TF.ln_linear, "packed_attention":
               TA.packed_attention, "proj_mlp_tail": TF.proj_mlp_tail,
               "mlp": TM.mlp_kernel, "tail_train": TF.tail_train,
               "block_eval": TF.block_eval}
    before = {k: f.launches for k, f in kernels.items()}
    with torch.no_grad():
        got = model.infer_image_ft(params, spec, image)["cls_feats"]
        plain = model.infer_image_ft(params, spec, image,
                                     kernels=False)["cls_feats"]
    launched = {k: f.launches - before[k] for k, f in kernels.items()}
    assert launched == {"ln_linear": 1, "packed_attention": 1,
                        "proj_mlp_tail": 1, "mlp": 0, "tail_train": 0,
                        "block_eval": 0}
    cos = torch.nn.functional.cosine_similarity(got.float(), plain.float(),
                                                dim=-1)
    assert float(cos.min()) >= 0.999, float(cos.min())
    before = {k: f.launches for k, f in kernels.items()}
    with torch.no_grad():
        mega = model.infer_image_ft(params, spec, image,
                                    fusion="mega")["cls_feats"]
    launched = {k: f.launches - before[k] for k, f in kernels.items()}
    assert launched == {"ln_linear": 0, "packed_attention": 0,
                        "proj_mlp_tail": 0, "mlp": 0, "tail_train": 0,
                        "block_eval": 1}
    assert torch.equal(mega, got)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 100, 3 * 577 + 5])
def test_ln_linear_i8_at_1024_matches_twin_on_card(cuda_device, M):
    """K14 at the ViT-L width (C = 1024, O = 3072; two W stages beside the
    128 KB resident operand): M < 128, a ragged M and an all-zero row of x,
    within 2 ulps of the twin; two launches and units of 3 column tiles
    give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    C, O = 1024, 3072
    x = torch.randn(1, M, C, device=cuda_device, generator=g).bfloat16()
    x[0, M // 2] = 0
    lnw = 1 + 0.1 * torch.randn(C, device=cuda_device, generator=g)
    lnb = 0.1 * torch.randn(C, device=cuda_device, generator=g)
    wq, ws = TI.quantize_weight(
        0.02 * torch.randn(O, C, device=cuda_device, generator=g))
    b = 0.1 * torch.randn(O, device=cuda_device, generator=g)
    n = TI.ln_linear_i8.launches
    got = TI.ln_linear_i8(x, lnw, lnb, wq, ws, b)
    assert TI.ln_linear_i8.launches == n + 1
    _bf16_close(got, TI.ref_ln_linear_i8(x, lnw, lnb, wq, ws, b))
    assert torch.equal(TI.ln_linear_i8(x, lnw, lnb, wq, ws, b), got)
    assert torch.equal(TI.ln_linear_i8(x, lnw, lnb, wq, ws, b, group=3), got)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["poly", "poly11", "poly13", "erf"])
def test_proj_mlp_tail_i8_at_1024_matches_twin_on_card(cuda_device, gelu):
    """K15 at the ViT-L width (C = 1024, MLP 4096; halved ring stages, fc2
    as two m64n128 products), M = 3·577 rows with rows of context all zero
    in the first and the last, ragged 64-row block; every gelu, within 4
    ulps of the twin; two launches agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(32)
    args = list(_int8_tail_args(cuda_device, g, 3, 577, C=1024, Hd=4096))
    ctx = args[0].clone()
    ctx[0, :3] = 0
    ctx[-1, -1] = 0
    args[0] = ctx
    n = TI.proj_mlp_tail_i8.launches
    got = TI.proj_mlp_tail_i8(*args, gelu=gelu)
    assert TI.proj_mlp_tail_i8.launches == n + 1
    assert bool(torch.isfinite(got).all())
    _bf16_close(got, TI.ref_proj_mlp_tail_i8(*args, gelu=gelu), ulps=4)
    assert torch.equal(TI.proj_mlp_tail_i8(*args, gelu=gelu), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 577), (2, 300)])
def test_block_eval_at_1024_matches_twin_and_staged_kernels_on_card(
        cuda_device, B, N):
    """K7 at the ViT-L width (C = 1024, 16 heads, MLP 4096) against its
    twin within 4 ulps, bit-equal to K1 → K2 → K3 and to K8 → K3; two
    launches agree bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(33)
    args = _block_args(cuda_device, g, B, N, C=1024, H=16, Hd=4096)
    n = TF.block_eval.launches
    got = TF.block_eval(*args)
    assert TF.block_eval.launches == n + 1
    _bf16_close(got, TF.block_eval_reference(*args), ulps=4)
    assert torch.equal(got, TF.fused_eval_block(*args, fusion="tail"))
    assert torch.equal(got, TF.fused_eval_block(*args, fusion="qkv"))
    assert torch.equal(TF.block_eval(*args), got)


def _mask_beyond_0_1(dev, B, N):
    """A key mask with -1 and 2 entries beside 0 and 1, cast to int32 as
    the wrappers cast it: a key is valid where its entry is > 0."""
    mask = torch.ones(B, N, dtype=torch.int32, device=dev)
    mask[0, 10:40] = -1
    mask[0, 40:60] = 2
    mask[-1, N - 50:] = 0
    mask[-1, :20] = -1
    return mask


@pytest.mark.cuda
def test_packed_attention_bwd_counts_only_positive_mask_entries_on_card(
        cuda_device):
    """Fault C7: K9 treats a key whose mask entry is -1 as masked and one of
    2 as valid, as its twin (and K2, and the JAX kernel) do: dqkv within 4
    ulps and dbias within 1e-3 of the twin fed the plain statistics."""
    g = torch.Generator(device=cuda_device).manual_seed(34)
    B, N, H = 3, 577, 12
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, device=cuda_device, generator=g).bfloat16()
    bias = torch.randn(H, N, N, device=cuda_device, generator=g)
    gout = torch.randn(B, N, C, device=cuda_device, generator=g).bfloat16()
    mask = _mask_beyond_0_1(cuda_device, B, N)
    _, stats = TA.packed_attention(qkv, bias, mask, 0.125, H, with_stats=True)
    ref = TA.packed_attention_stats_reference(qkv, bias, mask, 0.125, H)
    dqkv, dbias = TA.packed_attention_bwd(qkv, bias, mask, gout, stats,
                                          0.125, H)
    want_dqkv, want_dbias = TA.packed_attention_bwd_reference(
        qkv, bias, mask, gout, ref, 0.125, H)
    _bf16_close(dqkv, want_dqkv, ulps=4)
    rel = float((dbias - want_dbias).norm() / want_dbias.norm())
    assert rel < 1e-3, rel


@pytest.mark.cuda
@pytest.mark.parametrize("B", I8QK_B)
@pytest.mark.parametrize("H", I8QK_H)
@pytest.mark.parametrize("N", I8QK_N)
def test_packed_attention_i8qk_counts_only_positive_mask_entries_on_card(
        cuda_device, N, H, B):
    """Fault C7: K12 treats a key whose mask entry is -1 as masked and one
    of 2 as valid, as its twin does: within 4 ulps (NaN where a sample has
    no valid key, as the twin)."""
    qkv, bias = _i8qk_inputs(cuda_device, 35 + 1000 * N + 10 * H + B, B, N,
                             H)
    mask = torch.ones(B, N, dtype=torch.int32, device=cuda_device)
    mask[0, N // 6:N // 3] = -1
    mask[0, N // 3:N // 2] = 2
    mask[-1, N - N // 4:] = 0
    mask[-1, :N // 8] = -1
    got = TA.packed_attention_i8qk(qkv, bias, mask, 0.125, H)
    want = TA.packed_attention_i8qk_reference(qkv, bias, mask, 0.125, H)
    _close_where_defined(got, want, ulps=4)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [
    "task_finetune_irtr_coco_square_randaug_base_image384",
    "task_finetune_irtr_f30k_square_randaug_large_image384"])
def test_quantize_weight_on_card_is_bit_equal_to_cpu(cuda_device, config):
    """Fault C10: every qkv, proj, fc1 and fc2 weight of the seeded ViT-B
    and ViT-L towers quantizes on the card to the CPU's int8 values and
    scales, bit for bit (the scale is amax / 127 divided as IEEE, not a
    multiply by f32(1/127))."""
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    spec = make_model_spec(build_config(config, "ufo"))
    params = init_params(spec, torch.Generator().manual_seed(40))
    keys = [k for k in params if TI._QUANT_KEY_RE.match(k)]
    assert len(keys) == 4 * spec.num_layers
    for k in keys:
        q, s = TI.quantize_weight(params[k])
        qd, sd = TI.quantize_weight(params[k].to(cuda_device))
        assert torch.equal(qd.cpu(), q), k
        assert torch.equal(sd.cpu().view(torch.int32), s.view(torch.int32)), k


def _expert_state(seed, hs=16, mlp=32, layers=4, vl_from=2):
    """A synthetic all_moe state dict with the reference key layout."""
    import numpy as np

    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    sd = {"transformer.norm.weight": f32(hs)}
    for i in range(layers):
        p = f"transformer.blocks.{i}"
        for t in ("v", "l", "vl") if i >= vl_from else ("v", "l"):
            sd.update({f"{p}.attn.{t}.qkv.weight": f32(3 * hs, hs),
                       f"{p}.attn.{t}.q_bias": f32(hs),
                       f"{p}.attn.{t}.v_bias": f32(hs),
                       f"{p}.attn.{t}.proj.weight": f32(hs, hs),
                       f"{p}.attn.{t}.proj.bias": f32(hs),
                       f"{p}.mlp.{t}.fc1.weight": f32(mlp, hs),
                       f"{p}.mlp.{t}.fc1.bias": f32(mlp),
                       f"{p}.mlp.{t}.fc2.weight": f32(hs, mlp),
                       f"{p}.mlp.{t}.fc2.bias": f32(hs)})
            for norm in ("norm1", "norm2"):
                sd[f"{p}.{norm}.{t}.weight"] = f32(hs)
                sd[f"{p}.{norm}.{t}.bias"] = f32(hs)
        sd[f"{p}.gamma_1"] = f32(hs)
    return sd


@pytest.mark.cuda
def test_device_merging_on_card_matches_host(cuda_device):
    """merging/device.py on the card against the port's host merging:
    every fleet member of merge_weights_device (every expert-set rule),
    sum_task_vectors_device and ratio_sweep within 4 f32 ulp at operand
    scale; regmean_device within the JAX package's pin of 5e-5 relative
    drift from the host f64 regmean (well-conditioned grams)."""
    import numpy as np

    from vl_merging_tpu_torch.merging import core, device

    kw = dict(num_layers=4, vlffn_start_layer_index=2)
    sds = [_expert_state(s) for s in range(3)]
    central = core.merge_weights(_expert_state(9), loss_names={"itm": 1},
                                 **kw)

    def close(fleet, hosts):
        assert set(fleet) == set(hosts[0])
        for k, v in fleet.items():
            got = v.cpu().double().numpy()
            for j, h in enumerate(hosts):
                tol = 4 * np.spacing(np.float32(max(np.abs(h[k]).max(), 1)))
                assert np.abs(got[j] - h[k]).max() <= tol, (k, j)

    fleet = device.stack_checkpoints(sds)
    assert fleet["transformer.norm.weight"].is_cuda
    for loss, used in (({"itm": 1}, False), ({"irtr": 1}, True),
                       ({"vqa": 1}, True)):
        close(device.merge_weights_device(
            fleet, loss_names=loss, merge_ratio=0.3,
            only_activate_used_experts=used, **kw),
            [core.merge_weights(sd, loss_names=loss, merge_ratio=0.3,
                                only_activate_used_experts=used, **kw)
             for sd in sds])
    close(device.sum_task_vectors_device(
        fleet, device.stack_checkpoints([central] * 3), loss_names={"itm": 1},
        sum_lambda=0.4, **kw),
        [core.sum_task_vectors(sd, dict(central), loss_names={"itm": 1},
                               sum_lambda=0.4, **kw) for sd in sds])
    ratios = [0.0, 0.3, 2 / 3, 1.0]
    close(device.ratio_sweep(sds[0], ratios, loss_names={"itm": 1}, **kw),
          [core.merge_weights(sds[0], loss_names={"itm": 1}, merge_ratio=r,
                              **kw) for r in ratios])
    rng = np.random.RandomState(7)
    grams = {}
    for i in range(4):
        for t in ("v", "l", "vl") if i >= 2 else ("v", "l"):
            for mod, d in ((f"attn.{t}", 16), (f"attn.{t}.proj", 16),
                           (f"mlp.{t}.fc1", 16), (f"mlp.{t}.fc2", 32)):
                X = rng.randn(64, d)
                grams[f"transformer.blocks.{i}.{mod}"] = X.T @ X
    host = core.regmean(sds[0], grams, loss_names={"itm": 1},
                        scaling_for_non_diag=0.9, **kw)
    got = device.regmean_device(
        device.stack_checkpoints(sds[:1]),
        {k: torch.from_numpy(v).float().to(cuda_device)
         for k, v in grams.items()},
        loss_names={"itm": 1}, scaling_for_non_diag=0.9, **kw)
    for k, h in host.items():
        rel = np.abs(got[k][0].cpu().double().numpy() - h).max() / max(
            np.abs(h).max(), 1.0)
        assert rel < 5e-5, (k, rel)


@pytest.mark.cuda
def test_tapped_towers_launch_k2_only_on_card(cuda_device):
    """One all_moe ViT-B/16 @384 layer, two images and 64 captions: untapped,
    the image block launches K1, K2, K3 and the text block K13; under a gram
    tap, the image block K2 alone and the text block nothing, the taps see
    every module input, and the features stay within cosine 0.999 of the
    untapped towers'."""
    from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models import model, taps
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    cfg = build_config("task_finetune_irtr_coco_square_randaug_base_image384",
                       "all_moe", overrides=dict(num_layers=1))
    spec = make_model_spec(cfg)
    gen = torch.Generator().manual_seed(41)
    params = params_from_numpy(init_params(spec, gen), cuda_device)
    batch = {"image": torch.randn(2, 3, 384, 384, generator=gen).to(
                 cuda_device),
             "text_ids": torch.randint(1000, spec.vocab_size, (64, 40),
                                       generator=gen).to(cuda_device),
             "text_masks": torch.ones(64, 40, dtype=torch.int32,
                                      device=cuda_device)}
    kernels = {"ln_linear": TF.ln_linear, "packed_attention":
               TA.packed_attention, "proj_mlp_tail": TF.proj_mlp_tail,
               "mlp": TM.mlp_kernel}

    def towers():
        before = {k: f.launches for k, f in kernels.items()}
        with torch.no_grad():
            img = model.infer_image_ft(params, spec, batch)["cls_feats"]
            txt = model.infer_text_ft(params, spec, batch)["cls_feats"]
        return img, txt, {k: f.launches - before[k]
                          for k, f in kernels.items()}

    img, txt, launched = towers()
    assert launched == {"ln_linear": 1, "packed_attention": 1,
                        "proj_mlp_tail": 1, "mlp": 1}
    tap = taps.GramTap(taps.MOE_GRAM_SUFFIXES)
    with taps.active_tap(tap):
        timg, ttxt, tlaunched = towers()
    assert tlaunched == {"ln_linear": 0, "packed_attention": 1,
                         "proj_mlp_tail": 0, "mlp": 0}
    assert set(tap.grams) == {f"transformer.blocks.0.{m.format(e)}"
                              for e in "vl" for m in (
                                  "attn.{}", "attn.{}.proj", "mlp.{}.fc1",
                                  "mlp.{}.fc2")}
    for a, b in ((timg, img), (ttxt, txt)):
        cos = torch.nn.functional.cosine_similarity(a.float(), b.float(),
                                                    dim=-1)
        assert float(cos.min()) >= 0.999, float(cos.min())


def _joint_mask(dev, g, B, N, T=40):
    """The fused pass's key mask, [text_masks, ones]: captions of 5 to T
    valid tokens, so caption padding leaves zeros inside the key range."""
    lengths = torch.randint(5, T + 1, (B, 1), device=dev, generator=g)
    text = (torch.arange(T, device=dev)[None] < lengths).to(torch.int32)
    return torch.cat([text, torch.ones(B, N - T, dtype=torch.int32,
                                       device=dev)], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [617, 941])
def test_packed_attention_with_a_joint_mask_on_card(cuda_device, N):
    """K2 over a joint text + image sequence (40 + 577 at @384, 40 + 901 at
    VQA @480) whose key mask has zeros inside the sequence: within 4 ulps
    of its twin, and two launches agree bit for bit."""
    _joint_k2_matches_twin(cuda_device, N, 12, seed=50 + N)


@pytest.mark.cuda
def test_packed_attention_at_16_heads_with_a_joint_mask_on_card(
        cuda_device):
    """K2 at the ViT-L VQA's joint layers: 16 heads over 40 + 577 tokens
    under the joint mask, within 4 ulps of its twin, two launches bit for
    bit."""
    _joint_k2_matches_twin(cuda_device, 617, 16, seed=60)


def _joint_k2_matches_twin(dev, N, H, seed, B=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * 64 * H, device=dev, generator=g).bfloat16()
    bias = torch.randn(H, N, N, device=dev, generator=g)
    mask = _joint_mask(dev, g, B, N)
    assert bool((mask[:, :40] == 0).any())
    got = TA.packed_attention(qkv, bias, mask, 0.125, H)
    _bf16_close(got, TA.packed_attention_reference(qkv, bias, mask, 0.125, H),
                ulps=4)
    assert torch.equal(TA.packed_attention(qkv, bias, mask, 0.125, H), got)


@pytest.mark.cuda
def test_packed_attention_bwd_with_a_joint_mask_on_card(cuda_device):
    """K2's training launch and K9 over a joint sequence of 40 + 577
    tokens (the @384 fused pass's deep layers) under the joint mask, with
    zeros inside the key range, and a sample whose keys are all masked:
    the statistics within 1e-5 of the plain ones, K9 within 4 ulps of its
    twin fed the plain forward's statistics, dbias within 1e-3 relative
    and finite, the dead sample's gradient zero, and two launches bit for
    bit."""
    _joint_k9_matches_twin(cuda_device, 12, seed=53)


@pytest.mark.cuda
def test_packed_attention_bwd_at_16_heads_with_a_joint_mask_on_card(
        cuda_device):
    """K2's training launch and K9 at the ViT-L VQA's joint layers: 16
    heads over 40 + 577 tokens under the joint mask, a dead sample, by
    the bounds of the 12-head case."""
    _joint_k9_matches_twin(cuda_device, 16, seed=63)


def _joint_k9_matches_twin(dev, H, seed, B=5, N=617):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * 64 * H, device=dev, generator=g).bfloat16()
    bias = torch.randn(H, N, N, device=dev, generator=g)
    gout = torch.randn(B, N, 64 * H, device=dev, generator=g).bfloat16()
    mask = _joint_mask(dev, g, B, N)
    mask[0] = 0
    assert bool((mask[1:, :40] == 0).any())
    o, stats = TA.packed_attention(qkv, bias, mask, 0.125, H,
                                   with_stats=True)
    assert torch.equal(o.nan_to_num(), TA.packed_attention(
        qkv, bias, mask, 0.125, H).nan_to_num())
    ref = TA.packed_attention_stats_reference(qkv, bias, mask, 0.125, H)
    assert bool((stats[1, 0] == 0).all()) and bool((stats[1, 1:] > 0).all())
    torch.testing.assert_close(stats[:, 1:], ref[:, 1:], rtol=1e-5,
                               atol=1e-5)
    dqkv, dbias = TA.packed_attention_bwd(qkv, bias, mask, gout, stats,
                                          0.125, H)
    want_dqkv, want_dbias = TA.packed_attention_bwd_reference(
        qkv, bias, mask, gout, ref, 0.125, H)
    assert not dqkv[0].float().any()
    _bf16_close(dqkv, want_dqkv, ulps=4)
    assert bool(torch.isfinite(dbias).all())
    rel = float((dbias - want_dbias).norm() / want_dbias.norm())
    assert rel < 1e-3, rel
    again = TA.packed_attention_bwd(qkv, bias, mask, gout, stats, 0.125, H)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


@pytest.mark.cuda
def test_k7_and_k8_at_the_joint_length_on_card(cuda_device):
    """At N = 617 with the joint mask: K8 bit-equal to K1 → K2 and K7 to
    K1 → K2 → K3, whose device code they run."""
    g = torch.Generator(device=cuda_device).manual_seed(52)
    args = list(_block_args(cuda_device, g, 3, 617))
    args[6] = _joint_mask(cuda_device, g, 3, 617)
    assert torch.equal(_bits(TF.ln_qkv_attention(*args[:9])),
                       _bits(_staged_k1_k2(args[:9])))
    assert torch.equal(_bits(TF.block_eval(*args)),
                       _bits(TF.fused_eval_block(*args, fusion="tail")))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1])
def test_vl_block_on_card(cuda_device, layer):
    """One full-width NLVR2 @384 ufo block over a fused sequence of 8
    pairs (40 + 577 tokens, caption padding inside): layer 0 splits into
    its text half (plain attention, K13 over 8·40 rows) and its image half
    (K1, K2, K3), layer 1 (a deep block) runs the 617 joint tokens through
    K1, K2, K3; within cosine 0.9999 of the plain path per token."""
    from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
        params_from_numpy
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models import model, mome
    from vl_merging_tpu_torch.models.spec import VL, init_params, \
        make_model_spec

    cfg = build_config("task_finetune_nlvr2_square_randaug_base_image384",
                       "ufo", overrides=dict(num_layers=2,
                                             vlffn_start_layer_index=1))
    spec = make_model_spec(cfg)
    gen = torch.Generator().manual_seed(53)
    host = init_params(spec, gen)
    host["relative_position_bias_table"] = torch.randn(
        host["relative_position_bias_table"].shape, generator=gen)
    params = eval_cast_params(params_from_numpy(host, cuda_device), spec, cfg)
    g = torch.Generator(device=cuda_device).manual_seed(54)
    x = torch.randn(8, 617, 768, device=cuda_device, generator=g).bfloat16()
    mask = _joint_mask(cuda_device, g, 8, 617)
    bias = model.fused_layer_biases(params, spec, 40)[layer]
    b = spec.blocks[layer]
    assert mome.splits(b, VL) == (layer == 0)
    kernels = {"ln_linear": TF.ln_linear, "packed_attention":
               TA.packed_attention, "proj_mlp_tail": TF.proj_mlp_tail,
               "mlp": TM.mlp_kernel}
    before = {k: f.launches for k, f in kernels.items()}
    with torch.no_grad():
        got = mome.block_forward(params, spec, b, x, mask, bias, VL)
        want = mome.block_forward(params, spec, b, x, mask, bias, VL,
                                  kernels=False)
    launched = {k: f.launches - before[k] for k, f in kernels.items()}
    assert launched == {"ln_linear": 1, "packed_attention": 1,
                        "proj_mlp_tail": 1, "mlp": int(layer == 0)}
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(),
                                                dim=-1)
    assert bool(torch.isfinite(got).all())
    assert float(cos.min()) >= 0.9999, float(cos.min())


@pytest.mark.cuda
def test_trainer_fit_step_on_card(cuda_device, tmp_path):
    """One ``Trainer.fit`` step on the card (no ``use_cpu``), over COCO
    arrows written here at 384 px, at the ViT-B/16 width (2 layers): the
    step's image blocks take K2 and K9 and every block's MLP K13, the
    final validation K1-K3 and K13; a finite loss; the checkpoints."""
    import io
    import json
    import os

    import numpy as np
    import pyarrow as pa
    from PIL import Image

    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.data import MTDataModule, write_tiny_vocab
    from vl_merging_tpu_torch.train.loop import Trainer

    words = ["a", "dog", "cat", "plays", "on", "the", "red", "mat"]
    vocab = write_tiny_vocab(str(tmp_path / "vocab.txt"), words)
    rng = np.random.RandomState(0)
    for split in ("train", "val", "test"):
        images = []
        for _ in range(8):
            buf = io.BytesIO()
            Image.fromarray((rng.rand(384, 384, 3) * 255).astype(np.uint8)
                            ).save(buf, format="JPEG")
            images.append(buf.getvalue())
        caps = [[" ".join(rng.choice(words, 5)) for _ in range(2)]
                for _ in images]
        table = pa.Table.from_arrays(
            [pa.array(images), pa.array(caps),
             pa.array([str(i) for i in range(8)]), pa.array([split] * 8)],
            names=["image", "caption", "image_id", "split"])
        with pa.OSFile(str(tmp_path / f"coco_caption_karpathy_{split}.arrow"),
                       "wb") as sink:
            with pa.RecordBatchFileWriter(sink, table.schema) as w:
                w.write_table(table)
    cfg = build_config(
        "task_finetune_irtr_coco_square_randaug_base_image384", "ufo",
        overrides=dict(num_layers=2, vlffn_start_layer_index=1,
                       data_root=str(tmp_path), tokenizer=vocab,
                       log_dir=str(tmp_path / "logs"),
                       per_device_batch_size=8, batch_size=8, max_steps=1,
                       warmup_steps=0, num_workers=2))
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda"
    kernels = (TA.packed_attention, TA.packed_attention_bwd, TM.mlp_kernel,
               TF.ln_linear, TF.proj_mlp_tail)
    for k in kernels:
        k.launches = 0
    trainer.fit(MTDataModule(cfg))
    assert trainer.state.step == 1
    assert [k.launches > 0 for k in kernels] == [True] * len(kernels)
    assert TA.packed_attention_bwd.launches == 2    # 2 image blocks
    with open(trainer.logger.path) as f:
        last = [json.loads(line) for line in f][-1]
    assert np.isfinite(last["val/irtr_loss"]) and "val/the_metric" in last
    ck = os.path.join(trainer.log_dir, "checkpoints")
    for f in ("last/weights.ckpt", "last/state.pt", "best/weights.ckpt"):
        assert os.path.exists(os.path.join(ck, f))


# the distribution tests' model: the COCO irtr @384 config at the ViT-B/16
# width, 2 layers (the image blocks take K2 and K9, every MLP K13)
DIST_OVER = dict(num_layers=2, vlffn_start_layer_index=1,
                 per_device_batch_size=4, batch_size=8, warmup_steps=0)


def _dist_setup(dev):
    """(cfg, spec, f32 params, the 8 pairs of a global batch) from seeds."""
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    cfg = build_config(
        "task_finetune_irtr_coco_square_randaug_base_image384", "ufo",
        overrides=DIST_OVER)
    spec = make_model_spec(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in init_params(spec, gen).items()}
    n, T = 8, spec.max_text_len
    batch = {"image": torch.randn(n, 3, spec.image_size, spec.image_size,
                                  generator=gen).to(dev),
             "text_ids": torch.randint(1000, spec.vocab_size, (n, T),
                                       generator=gen).to(dev),
             "text_masks": (torch.arange(T)[None] < torch.randint(
                 8, T + 1, (n, 1), generator=gen)).int().to(dev)}
    return cfg, spec, params, batch


def _world2_rank(rank, store, out):
    """One rank of ``test_world2_gloo_step_on_card``: the step's loss and
    averaged gradients over this rank's 4 of the 8 pairs."""
    from vl_merging_tpu_torch import parallel
    from vl_merging_tpu_torch.ckpt.convert import master_params
    from vl_merging_tpu_torch.device import rank_device
    from vl_merging_tpu_torch.parallel.mesh import average_grads, make_mesh
    from vl_merging_tpu_torch.train import train_step

    dev = rank_device("cuda:0")
    parallel.initialize("gloo", init_method=f"file://{store}", world_size=2,
                        rank=rank)
    cfg, spec, params, batch = _dist_setup(dev)
    rows = parallel.process_rows(8)
    loss, metrics, grads = train_step.loss_and_grads(
        master_params(params), spec, cfg, {k: v[rows] for k, v in
                                           batch.items()},
        torch.Generator(dev).manual_seed(1), kernels=True, dp_scale=0.5)
    average_grads(grads, make_mesh())
    metrics = train_step.reduce_metrics(metrics)
    if rank == 0:
        torch.save({"loss": float(metrics["irtr_loss"]),
                    "grads": {k: v.cpu() for k, v in grads.items()}}, out)
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_world2_gloo_step_on_card(cuda_device, tmp_path):
    """Two ranks on cuda:0 under gloo (the kernels built here first, so
    the ranks only load them): the irtr loss and the averaged gradients
    of their step over 4 pairs each against one process's over the 8 at
    dp_scale 1/2 (same params and draws): the loss within 5e-3 relative,
    the gradients at global cosine 0.999 (bf16 activations summed in
    another order)."""
    import torch.multiprocessing as mp

    from vl_merging_tpu_torch.ckpt.convert import master_params
    from vl_merging_tpu_torch.ops import _build
    from vl_merging_tpu_torch.train import train_step

    _build.library()
    cfg, spec, params, batch = _dist_setup(cuda_device)
    _, metrics, want = train_step.loss_and_grads(
        master_params(params), spec, cfg, batch,
        torch.Generator(cuda_device).manual_seed(1), kernels=True,
        dp_scale=0.5)
    out = str(tmp_path / "rank0.pt")
    mp.start_processes(_world2_rank, args=(str(tmp_path / "store"), out),
                       nprocs=2, join=True, start_method="spawn")
    got = torch.load(out, weights_only=True)
    loss = float(metrics["irtr_loss"])
    assert abs(got["loss"] - loss) <= 5e-3 * abs(loss), (got["loss"], loss)
    dot = sum((got["grads"][k].double() * want[k].cpu().double()).sum()
              for k in want)
    norm = torch.sqrt(sum(v.double().square().sum() for v in
                          got["grads"].values()) * sum(
        v.cpu().double().square().sum() for v in want.values()))
    assert float(dot / norm) >= 0.999, float(dot / norm)


@pytest.mark.cuda
def test_world1_nccl_step_is_the_step_without_a_group(cuda_device, tmp_path):
    """The train step at world 1 under NCCL gives the params and metrics
    of the same step without a process group, bit for bit."""
    from vl_merging_tpu_torch import parallel
    from vl_merging_tpu_torch.ckpt.convert import master_params
    from vl_merging_tpu_torch.train.loop import build_train_step

    cfg, spec, params, batch = _dist_setup(cuda_device)
    feed = {k: v.reshape(2, 4, *v.shape[1:]) for k, v in batch.items()}
    runs = []
    for group in (False, True):
        if group:
            assert parallel.initialize(
                "nccl", init_method=f"file://{tmp_path / 'store'}",
                world_size=1, rank=0)
        try:
            state, step = build_train_step(cfg, spec, master_params(params),
                                           10)
            state, metrics = step(state, feed)
            runs.append((state.params, metrics))
        finally:
            if group:
                assert torch.distributed.get_backend() == "nccl"
                torch.distributed.destroy_process_group()
    (p0, m0), (p1, m1) = runs
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
