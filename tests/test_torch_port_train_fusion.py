"""The port's training fusion (``train_fusion`` "tail" / "full": K6
``tail_train`` under ``proj_mlp_tail_train``, K1 under
``ln_linear_train``) against the JAX package's
(``VLM_TPU_TRAIN_FUSION``), on the CPU.

On CPU tensors K6 runs its plain twin (``tail_train_reference``: K3's twin
with per-element gammas), held against the JAX kernel
``_tail_train_kernel`` run through ``_tail_train_pallas`` in interpret mode
(``_INTERPRET`` patched as tests/test_train_fusion.py does), in f32 (atol
= rtol = 2e-5: summation order, and the JAX kernel's A&S erf differs from
exact erf by <= 1.5e-7) and bf16 (both round at the same points: one bf16
ulp relative plus 1/64 of an ulp of the largest output, the slice-1
tolerance).  The backwards recompute the unfused compositions
(``tail_reference``, ``ln_linear_train_reference``), so the fused ops'
gradients equal the autograd of those compositions bit for bit; the
compositions match the JAX package's at f32 tolerance.

Block level: loss and gradients of ``mome.block_forward`` under "tail"
and "full" against "0" at tests/test_train_fusion.py's tolerances (loss
atol 2e-4, rtol 2e-5; gradients atol 2e-4, rtol 2e-3).  The irtr train
step under "full" with a non-uniform drop-path table against JAX
``make_train_step`` with ``_TRAIN_FUSION`` patched: loss, every gradient
and the params after 2 steps at tests/test_torch_port_train.py's
tolerances (atol 1e-5, rtol 1e-4; params atol lr/4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import _capture_grads, _close, _tiny_cfg, \
    _train_inputs
from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.ops import fused_block as F
from vl_merging_tpu.train import init_train_state as jinit_train_state
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import make_train_step as jmake_train_step
from vl_merging_tpu_torch.ckpt.convert import master_params, \
    params_from_numpy, params_to_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.models import mome, model
from vl_merging_tpu_torch.models.spec import V, make_model_spec
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import train_step
from vl_merging_tpu_torch.train.loop import build_train_step
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny specs' width (128) stands in for a width the kernels are
    built for (``fused_block.KERNEL_WIDTHS``): on CPU tensors every wrapper
    runs its twin, which takes any width, so the kernel routes run here."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


def _tail_arrays(seed, B=2, N=10, C=128, H=512):
    """ctx, wp, bp, g1, res, ln_w, ln_b, w1, b1, w2, b2, g2 with (B, 1, C)
    gammas, at tests/test_train_fusion.py's shapes (N = 10: the JAX kernel
    pads to 16, the port does not)."""
    rng = np.random.RandomState(seed)
    shapes = [((B, N, C), 0.5, 0), ((C, C), 0.05, 0), ((C,), 0.5, 0),
              ((B, 1, C), 0.1, 0), ((B, N, C), 0.5, 0), ((C,), 0.1, 1),
              ((C,), 0.5, 0), ((H, C), 0.05, 0), ((H,), 0.5, 0),
              ((C, H), 0.05, 0), ((C,), 0.5, 0), ((B, 1, C), 0.1, 0)]
    return [(rng.randn(*s) * sc + m).astype(np.float32) for s, sc, m in shapes]


# activations, weights and gammas in the test's dtype; f32 vectors
_TAIL_X = (0, 1, 3, 4, 7, 9, 11)


def _pair(arrays, dtype, x_idx):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = [jnp.asarray(a).astype(jdt if i in x_idx else jnp.float32)
          for i, a in enumerate(arrays)]
    th = [torch.from_numpy(a).to(tdt if i in x_idx else torch.float32)
          for i, a in enumerate(arrays)]
    return jx, th


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tail_train_twin_matches_jax_kernel(monkeypatch, dtype):
    monkeypatch.setattr(F, "_INTERPRET", True)
    jargs, targs = _pair(_tail_arrays(0), dtype, _TAIL_X)
    want = np.asarray(F._tail_train_pallas(*jargs).astype(jnp.float32))
    n = TF.tail_train.launches
    got = TF.tail_train(*targs)
    assert TF.tail_train.launches == n          # the twin, not the kernel
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max() / 64)


def _grads_equal(fused, unfused, args, cot):
    """fused's gradients equal unfused's autograd bit for bit; returns
    them."""
    out = []
    for fn in (fused, unfused):
        leaves = [t.clone().requires_grad_() for t in args]
        y = fn(*leaves)
        out.append((y,) + torch.autograd.grad(y, leaves, cot))
    for i, (a, b) in enumerate(zip(*out)):
        assert torch.equal(a, b) if i else a.shape == b.shape, f"arg {i - 1}"
    return out[0][1:]


def test_proj_mlp_tail_train_grads():
    """proj_mlp_tail_train: gradients = autograd of tail_reference, bit for
    bit; tail_reference and those gradients match the JAX package's
    _tail_reference and its VJP."""
    arrays = _tail_arrays(1)
    args = [torch.from_numpy(a) for a in arrays]
    cot_a = np.random.RandomState(2).randn(*arrays[0].shape).astype(
        np.float32)
    got = _grads_equal(TF.proj_mlp_tail_train, TF.tail_reference, args,
                       torch.from_numpy(cot_a))
    jargs = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(TF.tail_reference(*args).numpy(),
                               np.asarray(F._tail_reference(*jargs)),
                               **F32_TOL)
    want = jax.jit(jax.grad(lambda *a: (F._tail_reference(*a) * cot_a).sum(),
                            argnums=tuple(range(12))))(*jargs)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, err_msg=f"arg {i}")


def test_ln_linear_train_forward_and_grads(monkeypatch):
    """ln_linear_train: forward K1's twin against the JAX kernel in
    interpret mode, gradients = autograd of ln_linear_train_reference bit
    for bit and = the JAX package's VJP at f32 tolerance."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(F, "BLOCK_M", 8)
    rng = np.random.RandomState(3)
    B, N, C, O = 2, 9, 128, 384
    arrays = [(rng.randn(*s) * sc + m).astype(np.float32) for s, sc, m in
              (((B, N, C), 1.0, 0), ((C,), 0.1, 1), ((C,), 0.5, 0),
               ((O, C), 0.05, 0), ((O,), 0.5, 0))]
    jargs = [jnp.asarray(a) for a in arrays]
    args = [torch.from_numpy(a) for a in arrays]
    np.testing.assert_allclose(TF.ln_linear_train(*args).numpy(),
                               np.asarray(F.ln_linear_train(*jargs)),
                               **F32_TOL)
    cot_a = rng.randn(B, N, O).astype(np.float32)
    got = _grads_equal(TF.ln_linear_train, TF.ln_linear_train_reference,
                       args, torch.from_numpy(cot_a))
    want = jax.grad(lambda *a: (F.ln_linear_train(*a) * cot_a).sum(),
                    argnums=tuple(range(5)))(*jargs)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, err_msg=f"arg {i}")


def test_block_forward_train_fusion_levels_match_unfused(monkeypatch):
    """mome.block_forward in training at each level, with a rel-pos bias,
    a ragged mask and per-element dp scales: loss and gradients of "tail"
    and "full" against "0"; "tail" runs K6's twin once per block, "full"
    K1's too, "0" neither."""
    cfg = _tiny_cfg(build_config)
    spec = make_model_spec(cfg)
    arrays, _ = _train_inputs(jmake_spec(cfg))
    params = master_params(params_from_numpy(arrays, "cpu"))
    b = spec.blocks[0]
    rng = np.random.RandomState(6)
    B, N, C = 2, 10, 128
    x = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
    bias = torch.from_numpy(rng.randn(spec.num_heads, N, N).astype(
        np.float32))
    mask = torch.ones(B, N, dtype=torch.int32)
    mask[1, 7:] = 0
    dp = torch.from_numpy(rng.uniform(0.5, 1.5, (2, B)).astype(np.float32))
    cot = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
    calls = []
    for name in ("tail_train_reference", "ln_linear_reference"):
        real = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    leaves = [k for k in params if k.startswith("transformer.blocks.0.")]
    results = {}
    for level in ("0", "tail", "full"):
        calls.clear()
        xl = x.clone().requires_grad_()
        out = mome.block_forward(params, spec, b, xl, mask, bias, V,
                                 train=True, dp_scale=dp, train_fusion=level)
        loss = (out * cot).sum()
        results[level] = (loss.detach(), torch.autograd.grad(
            loss, [xl] + [params[k] for k in leaves], allow_unused=True))
        want = {"0": [], "tail": ["tail_train_reference"],
                "full": ["ln_linear_reference", "tail_train_reference"]}
        assert calls == want[level], level
    base_loss, base = results["0"]
    for level in ("tail", "full"):
        loss, grads = results[level]
        np.testing.assert_allclose(float(loss), float(base_loss), atol=2e-4,
                                   rtol=2e-5, err_msg=level)
        for name, a, g in zip(["x"] + leaves, base, grads):
            assert (a is None) == (g is None), name
            if a is not None:
                np.testing.assert_allclose(g.numpy(), a.numpy(), atol=2e-4,
                                           rtol=2e-3,
                                           err_msg=f"{level} {name}")
    with pytest.raises(ValueError, match="train_fusion"):
        mome.block_forward(params, spec, b, x, mask, bias, V, train=True,
                           train_fusion="half")


def test_irtr_train_step_fused_matches_jax(monkeypatch):
    """Two optimizer steps of 2 micro-batches under train_fusion "full",
    with the same non-uniform (L, 2, B) drop-path table on both sides (so
    K6's per-element gammas differ within a batch): the loss and every
    gradient of step 1, and every param after step 2."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    monkeypatch.setattr(F, "_TRAIN_FUSION", "full")
    jcfg, cfg = (_tiny_cfg(b, drop_rate=0.1)
                 for b in (jbuild_config, build_config))
    jspec, spec = jmake_spec(jcfg), make_model_spec(cfg)
    arrays, batch = _train_inputs(jspec)
    table = np.asarray([[[1.0, 0.0, 1 / 0.9, 1 / 0.9],
                         [1 / 0.9, 1 / 0.9, 0.0, 1.0]],
                        [[0.0, 1 / 0.9, 1 / 0.9, 0.0],
                         [1 / 0.9, 0.0, 1 / 0.9, 1 / 0.9]]], np.float32)
    monkeypatch.setattr(jmodel, "_dp_scale_table",
                        lambda spec, rng, train, batch:
                        jnp.asarray(table) if train else None)
    monkeypatch.setattr(jmodel, "dropout", lambda x, *a: x)
    monkeypatch.setattr(model, "_dp_scale_table", functools.partial(
        model._dp_scale_table, table=table))
    monkeypatch.setattr(model, "dropout", lambda x, *a, **k: x)

    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jopt = jmake_optimizer(jparams, jcfg, 10, jmake_schedule(jcfg, 10))
    jstate = jinit_train_state(jparams, _capture_grads(jopt), seed=0)
    jstep = jmake_train_step(jcfg, jspec, _capture_grads(jopt),
                             accum_steps=2, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jm1 = jstep(jstate, jbatch)
    jgrads = jstate.opt_state[1]
    jstate, jm2 = jstep(jstate, jbatch)

    calls = []
    for name in ("tail_train_reference", "ln_linear_reference"):
        real = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    params = master_params(params_from_numpy(arrays, "cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = [train_step.loss_and_grads(
        params, spec, cfg, {k: v[i] for k, v in tbatch.items()},
        torch.Generator().manual_seed(0), kernels=False,
        train_fusion="full")[2] for i in (0, 1)]
    state, step = build_train_step(cfg, spec, params, 10, train_fusion="full")
    state, m1 = step(state, tbatch)
    state, m2 = step(state, tbatch)
    # 6 micro-batches x 2 towers x 2 layers, each through K1's and K6's twins
    assert calls.count("tail_train_reference") == 24
    assert calls.count("ln_linear_reference") == 24

    for m, jm in ((m1, jm1), (m2, jm2)):
        for key in ("total_loss", "irtr_loss", "grad_norm"):
            _close(m[key], jm[key], err_msg=key)
    for k in jgrads:
        _close((grads[0][k] + grads[1][k]) / 2, jgrads[k],
               err_msg=f"grad {k}")
    got = params_to_numpy(state.params)
    for k in arrays:
        np.testing.assert_allclose(got[k], np.asarray(jstate.params[k]),
                                   atol=cfg["learning_rate"] / 4, rtol=1e-4,
                                   err_msg=f"param {k}")
