"""The port's split-layout attention (K10 ``split_attention``, K11
``split_attention_bb``, ``fused_attention``) and the @224 retrieval eval
that reaches it, against the JAX package on the CPU in f32.

On CPU tensors K10 and K11 run their plain twin
(``split_attention_reference``).  It is held against the JAX kernels
``_mha_kernel`` and ``_mha_kernel_bb`` run through a
``pallas_call(interpret=True)`` built here as tests/test_ops.py builds it
(N padded to 128 with masked keys, as ``_pallas_attention`` pads), at
N = 197 with masked keys: atol = rtol = 2e-5 (f32 summation order).
``fused_attention``'s backward is the autograd VJP of
``reference_attention`` at the saved inputs, so its gradients equal that
autograd bit for bit.

Routing (the fault ROADMAP logs as C3): every block of a @224 image
tower (197 tokens, below the packed kernels' 256) sends its attention to
K11 when the batch is a multiple of 4 and to K10 otherwise under
``kernels=True``, as the JAX eval does under ``pallas_attention(True)``
(vl_merging_tpu/models/mome.py:74-95 with ops/attention.py:775-838);
``kernels=False`` to neither.  The tiny @224 tower (ufo, hidden 128, 2
heads of 64, 2 layers) and ``compute_irtr_recall`` match the JAX eval:
atol 2e-5, rtol 1e-4, identical R@{1,5,10}.  The CUDA kernels themselves
run only on the card (tests/test_torch_port_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import random_arrays
from vl_merging_tpu.config import build_config
from vl_merging_tpu.evaluation import retrieval as jretrieval
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.ops import attention as A
from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
from vl_merging_tpu_torch.evaluation import retrieval
from vl_merging_tpu_torch.models import model
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=2e-5, rtol=2e-5)
TOWER_TOL = dict(atol=2e-5, rtol=1e-4)


def _interpret_split(q, k, v, bias, mask, scale, block_b):
    """``_mha_kernel`` (block_b 1) or ``_mha_kernel_bb`` through
    pallas_call in interpret mode, padded as ``_pallas_attention`` pads."""
    from jax.experimental import pallas as pl

    B, H, N, d = q.shape
    Np = A._round_up(N, 128)
    q, k, v = (jnp.pad(x, ((0, 0), (0, 0), (0, Np - N), (0, 0)))
               for x in (q, k, v))
    bias = jnp.pad(bias, ((0, 0), (0, Np - N), (0, Np - N)))
    mask = jnp.pad(mask, ((0, 0), (0, Np - N)))[:, None, :]
    kernel = A._mha_kernel_bb if block_b > 1 else A._mha_kernel
    rows = pl.BlockSpec((block_b, 1, Np, d), lambda h, b: (b, h, 0, 0))
    out = pl.pallas_call(
        functools.partial(kernel, scale=scale),
        out_shape=jax.ShapeDtypeStruct((B, H, Np, d), q.dtype),
        grid=(H, B // block_b),
        in_specs=[rows, rows, rows,
                  pl.BlockSpec((1, Np, Np), lambda h, b: (h, 0, 0)),
                  pl.BlockSpec((block_b, 1, Np), lambda h, b: (b, 0, 0))],
        out_specs=rows,
        interpret=True,
    )(q, k, v, bias, mask)
    return out[:, :, :N]


def _split_inputs(B, N=197, H=2, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, N, 64).astype(np.float32) for _ in range(3))
    bias = rng.randn(H, N, N).astype(np.float32)
    mask = np.ones((B, N), np.int32)
    mask[0, 150:] = 0          # ragged key masks
    mask[-1, 3:40] = 0
    return q, k, v, bias, mask


@pytest.mark.parametrize("block_b", [1, 4])
def test_split_twin_matches_jax_kernel(block_b):
    """K10's (block_b 1) and K11's (block_b 4) twin against _mha_kernel and
    _mha_kernel_bb in interpret mode, N = 197, masked keys."""
    arrays = _split_inputs(4)
    want = _interpret_split(*map(jnp.asarray, arrays), 0.125, block_b)
    wrapper = TA.split_attention_bb if block_b > 1 else TA.split_attention
    n = wrapper.launches
    got = wrapper(*map(torch.from_numpy, arrays), 0.125)
    assert wrapper.launches == n            # the twin, not the kernel
    assert got.shape == (4, 2, 197, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_fused_attention_grads_equal_reference_autograd(monkeypatch):
    """fused_attention(kernels=True) at N >= SPLIT_MIN_N: forward the split
    twin, gradients the autograd of reference_attention, bit for bit; the
    mask gets none.  Without the flag, below SPLIT_MIN_N or with bf16
    logits it is reference_attention itself."""
    arrays = _split_inputs(3, N=TA.SPLIT_MIN_N + 2, seed=1)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        *arrays[0].shape).astype(np.float32))
    results = []
    for fn in (functools.partial(TA.fused_attention, kernels=True),
               TA.reference_attention):
        q, k, v, bias = (torch.from_numpy(a).requires_grad_()
                         for a in arrays[:4])
        mask = torch.from_numpy(arrays[4])
        out = fn(q, k, v, bias, mask, 0.125)
        results.append((out,) + torch.autograd.grad(out, (q, k, v, bias), g))
    for got, want in zip(*results):
        assert torch.equal(got, want)
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    ones = torch.ones(3, q.shape[2], dtype=torch.int32)
    zeros = torch.zeros(2, q.shape[2], q.shape[2])
    assert torch.equal(TA.fused_attention(q, k, v, None, None, 0.125,
                                          kernels=True),
                       TA.reference_attention(q, k, v, zeros, ones, 0.125))
    calls = _spy_split(monkeypatch)
    short = tuple(t[:, :, :TA.SPLIT_MIN_N - 1] for t in (q, k, v))
    for qkv, kwargs in (((q, k, v), dict(kernels=False)),
                        ((q, k, v), dict(kernels=True,
                                         logits_dtype=torch.bfloat16)),
                        (short, dict(kernels=True))):
        ldt = kwargs.get("logits_dtype", torch.float32)
        assert torch.equal(
            TA.fused_attention(*qkv, None, None, 0.125, **kwargs),
            TA.reference_attention(*qkv, None, None, 0.125, logits_dtype=ldt))
    assert calls == []


def tiny224_cfg():
    return build_config("task_finetune_irtr_f30k_square_randaug_base", "ufo",
                        overrides=dict(hidden_size=128, num_heads=2,
                                       num_layers=2, max_text_len=8,
                                       max_text_len_of_initckpt=16,
                                       vlffn_start_layer_index=1,
                                       precision="f32"))


@pytest.fixture(scope="module")
def tiny224():
    """(JAX spec, port spec, JAX params, port params) of the @224 spec."""
    cfg = tiny224_cfg()
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    assert spec.image_len == 197
    arrays = random_arrays(jspec, 3)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jspec, spec, jparams, params_from_numpy(arrays, "cpu")


def _spy_split(monkeypatch):
    """Record which split kernel each attention call takes (its batch)."""
    calls = []
    for name in ("split_attention", "split_attention_bb"):
        real = getattr(TA, name)

        def spy(q, *a, _real=real, _name=name, **kw):
            calls.append((_name, q.shape[0]))
            return _real(q, *a, **kw)
        monkeypatch.setattr(TA, name, spy)
    return calls


def test_image_tower_at_224_takes_the_split_kernels(tiny224, monkeypatch):
    """Each of the @224 tower's blocks (197 tokens) calls K11's twin at
    B % 4 == 0 and K10's otherwise under kernels=True, neither under
    kernels=False; the text tower (8 tokens) neither."""
    jspec, spec, jparams, params = tiny224
    images = torch.from_numpy(np.random.RandomState(4).randn(
        4, 3, 224, 224).astype(np.float32))
    calls = _spy_split(monkeypatch)
    model.infer_image_ft(params, spec, {"image": images})
    assert calls == [("split_attention_bb", 4)] * spec.num_layers
    calls.clear()
    model.infer_image_ft(params, spec, {"image": images[:3]})
    assert calls == [("split_attention", 3)] * spec.num_layers
    calls.clear()
    model.infer_image_ft(params, spec, {"image": images}, kernels=False)
    model.infer_text_ft(params, spec, {
        "text_ids": torch.zeros(4, 8, dtype=torch.int64),
        "text_masks": torch.ones(4, 8, dtype=torch.int32)})
    assert calls == []


def test_tower_and_recall_at_224_match_jax(tiny224, monkeypatch):
    """The @224 image tower (a batch of 4 through K11's twin, a ragged
    batch of 2 through K10's) and compute_irtr_recall against the JAX
    eval."""
    jspec, spec, jparams, params = tiny224
    rng = np.random.RandomState(5)
    images = rng.randn(6, 3, 224, 224).astype(np.float32)
    text_ids = rng.randint(0, 30522, (12, 8)).astype(np.int32)
    text_masks = np.ones((12, 8), np.int32)
    text_masks[::3, 5:] = 0
    tiids, iids = np.repeat(np.arange(6), 2), np.arange(6)
    calls = _spy_split(monkeypatch)
    jimages = [{"image": jnp.asarray(images[s])}
               for s in (slice(0, 4), slice(4, 6))]
    timages = [{"image": torch.from_numpy(images[s])}
               for s in (slice(0, 4), slice(4, 6))]
    np.testing.assert_allclose(
        retrieval.extract_features(params, spec, timages, "image").numpy(),
        np.asarray(jretrieval.extract_features(jparams, jspec, jimages,
                                               "image")), **TOWER_TOL)
    want = jretrieval.compute_irtr_recall(
        jparams, jspec, [{"text_ids": jnp.asarray(text_ids),
                          "text_masks": jnp.asarray(text_masks)}],
        jimages, tiids, iids)
    got = retrieval.compute_irtr_recall(
        params, spec, [{"text_ids": torch.from_numpy(text_ids),
                        "text_masks": torch.from_numpy(text_masks)}],
        timages, tiids, iids)
    assert got == want
    assert sorted(set(calls)) == [("split_attention", 2),
                                  ("split_attention_bb", 4)]
