"""The port's training slice against the JAX package, on the CPU.

Kernels: the twins of K9 (``packed_attention_bwd_reference``) and K13
(``mlp_kernel_reference``) against the JAX package's Pallas kernels run in
interpret mode, and the autograd of ``packed_fused_attention`` and
``fused_mlp`` against the JAX package's VJPs.  The irtr train step: loss,
every gradient and the params after two optimizer steps against JAX
``make_train_step`` on a tiny ufo spec (2 layers, C 128, 2 heads of 64,
64-px images, 8 text tokens) in f32, with the same numpy inputs on both
sides; once without stochastic depth and once with the same (L, 2, B)
drop-path table fed to both.

Tolerances: in f32 both sides compute the same functions and differ by
summation order (and, in K13's twin, the A&S erf's ≤ 1.5e-7): atol 1e-5,
rtol 1e-4 unless stated.  In bf16 both round at the same points; a value
within f32 noise of a bf16 rounding boundary may round the other way,
which moves an output by one bf16 ulp (2^-7 relative), and a ds that
rounds the other way moves dq and dk by a few ulps of their largest
entries: rtol 2^-6, atol 2^-6 · max|want|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu.ops import attention as A
from vl_merging_tpu.ops import mlp as M
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import make_train_step as jmake_train_step
from vl_merging_tpu.train import init_train_state as jinit_train_state
from vl_merging_tpu.train import optimizer as joptimizer
from vl_merging_tpu_torch.ckpt.convert import master_params, \
    params_from_numpy, params_to_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.models import layers, model
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import mlp as TM
from vl_merging_tpu_torch.train import optimizer, schedule, train_step
from vl_merging_tpu_torch.train.loop import build_train_step

F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = 2.0 ** -6


def _close(got, want, dtype="f32", err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, err_msg=err_msg, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                                   atol=BF16_TOL * np.abs(want).max(),
                                   err_msg=err_msg)


def _pair(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _attention_inputs(B, N=128, H=2, seed=0):
    rng = np.random.RandomState(seed)
    C = 64 * H
    qkv = rng.randn(B, N, 3 * C).astype(np.float32)
    bias = rng.randn(H, N, N).astype(np.float32)
    g = rng.randn(B, N, C).astype(np.float32)
    mask = np.ones((B, N), np.int32)
    mask[-1, 100:] = 0          # a ragged key mask
    return qkv, bias, mask, g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B", [2, 3])
def test_packed_attention_bwd_twin_matches_jax_kernel(monkeypatch, dtype, B):
    """(a) K9's twin against _packed_bwd_kernel in interpret mode; sample 0
    has every key masked (p = 0 there, so its gradients are zero and
    dbias stays finite), the last sample a ragged mask."""
    monkeypatch.setattr(A, "_INTERPRET", True)
    H, scale = 2, 64 ** -0.5
    qkv_a, bias_a, mask, g_a = _attention_inputs(B, H=H)
    mask[0] = 0
    (qkv, g), (tqkv, tg) = _pair([qkv_a, g_a], dtype)
    dqkv, dbias = A._pallas_packed_attention_bwd(
        qkv, jnp.asarray(bias_a), jnp.asarray(mask), g, scale, H)
    got_dqkv, got_dbias = TA.packed_attention_bwd(
        tqkv, torch.from_numpy(bias_a), torch.from_numpy(mask), tg, scale, H)
    assert got_dqkv.dtype == tqkv.dtype and got_dbias.dtype == torch.float32
    assert bool(torch.isfinite(got_dbias).all())
    assert not got_dqkv[0].float().any()
    _close(got_dqkv, dqkv, dtype, "dqkv")
    _close(got_dbias, dbias, dtype, "dbias")


def test_packed_fused_attention_grads_match_jax_vjp():
    """(b) packed_fused_attention's autograd against JAX _packed_bwd (the
    VJP of the XLA composition off the TPU), f32; the mask gets none."""
    H, scale = 2, 64 ** -0.5
    qkv_a, bias_a, mask, g_a = _attention_inputs(3, N=40, H=H, seed=1)
    res = (jnp.asarray(qkv_a), jnp.asarray(bias_a), jnp.asarray(mask))
    want_dqkv, want_dbias, want_dmask = A._packed_bwd(scale, H, 4, res,
                                                     jnp.asarray(g_a))
    tqkv = torch.from_numpy(qkv_a).requires_grad_()
    tbias = torch.from_numpy(bias_a).requires_grad_()
    out = TA.packed_fused_attention(tqkv, tbias, torch.from_numpy(mask),
                                    scale, H)
    _close(out, A._packed_reference(*res, scale, H), err_msg="forward")
    dqkv, dbias = torch.autograd.grad(out, (tqkv, tbias),
                                      torch.from_numpy(g_a))
    _close(dqkv, want_dqkv, err_msg="dqkv")
    _close(dbias, want_dbias, err_msg="dbias")
    assert not np.asarray(want_dmask).any()


def _pallas_interpret_mlp(x2d, w1, b1, w2, b2, block_m=16):
    """_mlp_kernel (ops/mlp.py) through pallas_call in interpret mode, on
    row blocks as _pallas_mlp cuts them."""
    from jax.experimental import pallas as pl

    Mr, C = x2d.shape
    H = w1.shape[0]
    return pl.pallas_call(
        M._mlp_kernel,
        out_shape=jax.ShapeDtypeStruct((Mr, C), x2d.dtype),
        grid=(Mr // block_m,),
        in_specs=[pl.BlockSpec((block_m, C), lambda m: (m, 0)),
                  pl.BlockSpec((H, C), lambda m: (0, 0)),
                  pl.BlockSpec((H,), lambda m: (0,)),
                  pl.BlockSpec((C, H), lambda m: (0, 0)),
                  pl.BlockSpec((C,), lambda m: (0,))],
        out_specs=pl.BlockSpec((block_m, C), lambda m: (m, 0)),
        interpret=True,
    )(x2d, w1, b1, w2, b2)


def _mlp_inputs(seed, B=2, N=16, C=128, H=512):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * sc).astype(np.float32) for s, sc in
            (((B, N, C), 1.0), ((H, C), 0.05), ((H,), 0.5), ((C, H), 0.05),
             ((C,), 0.5))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_kernel_twin_matches_jax_kernel(dtype):
    """(c) K13's twin against _mlp_kernel in interpret mode."""
    x, w1, b1, w2, b2 = _mlp_inputs(2)
    (jx, jw1, jw2), (tx, tw1, tw2) = _pair([x, w1, w2], dtype)
    want = _pallas_interpret_mlp(jx.reshape(-1, x.shape[-1]), jw1,
                                 jnp.asarray(b1), jw2, jnp.asarray(b2))
    got = TM.mlp_kernel(tx, tw1, torch.from_numpy(b1), tw2,
                        torch.from_numpy(b2))
    assert got.dtype == tx.dtype and TM.mlp_kernel.launches == 0
    _close(got.reshape(-1, x.shape[-1]), want, dtype)


def test_fused_mlp_grads_match_jax_bwd():
    """(d) fused_mlp's backward against the JAX package's _bwd (the VJP of
    reference_mlp at the saved inputs), f32."""
    arrays = _mlp_inputs(3)
    g = np.random.RandomState(4).randn(*arrays[0].shape).astype(np.float32)
    want = M._bwd(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = TM.fused_mlp(*inputs)
    _close(out, M.reference_mlp(*map(jnp.asarray, arrays)), err_msg="fwd")
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        _close(a, b, err_msg=name)


def _tiny_cfg(build, **overrides):
    return build("task_finetune_irtr_coco_square_randaug_base_image384",
                 "ufo", overrides=dict(
                     dict(hidden_size=128, num_heads=2, num_layers=2,
                          image_size=64, patch_size=16, max_text_len=8,
                          max_text_len_of_initckpt=16,
                          vlffn_start_layer_index=1, precision="f32",
                          per_device_batch_size=4, batch_size=8,
                          learning_rate=1e-4, warmup_steps=0),
                     **overrides))


def test_param_masks_and_schedules_match_jax():
    """(e) the four param groups and the lr schedules equal the JAX
    package's."""
    cfg = _tiny_cfg(build_config, all_v_mult=True, all_mlp_mult=True)
    names = list(jparam_shapes(jmake_spec(cfg)))
    names += ["vqa_classifier.0.weight", "transformer.blocks.1.norm.v.bias"]
    assert optimizer.param_masks(dict.fromkeys(names), cfg) == \
        joptimizer.param_masks(dict.fromkeys(names), cfg)
    assert optimizer.NO_DECAY_SUBSTRINGS == joptimizer.NO_DECAY_SUBSTRINGS
    steps = np.arange(0, 23)
    for overrides in (dict(warmup_steps=0.1), dict(warmup_steps=3),
                      dict(decay_power="cosine", warmup_steps=4),
                      dict(decay_power=2, end_lr=1e-6, warmup_steps=0)):
        c = _tiny_cfg(build_config, **overrides)
        got = [schedule.make_schedule(c, 20)(int(s)) for s in steps]
        want = jax.vmap(jmake_schedule(c, 20))(jnp.asarray(steps))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-12, err_msg=str(overrides))


def _capture_grads(inner: optax.GradientTransformation):
    """An optax transformation that applies ``inner`` and keeps the
    gradients it was given in its state."""
    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)
    return optax.GradientTransformation(init, update)


def _train_inputs(jspec, B=4, accum=2):
    rng = np.random.RandomState(5)
    arrays = {}
    for k, shape in jparam_shapes(jspec).items():
        v = rng.randn(*shape)
        if k == "relative_position_bias_table":
            pass
        elif k == "logit_scale":
            v = np.log(1 / 0.07)
        elif len(shape) == 1:
            v = 0.1 * v + (1.0 if "norm" in k.lower() and
                           k.endswith(".weight") else 0.0)
        else:
            v = 0.05 * v
        arrays[k] = np.asarray(v, np.float32)
    masks = np.ones((accum, B, 8), np.int32)
    masks[:, :, 5:] = rng.randint(0, 2, (accum, B, 3))
    batch = {"image": rng.randn(accum, B, 3, 64, 64).astype(np.float32),
             "text_ids": rng.randint(0, 30522, (accum, B, 8)).astype(np.int32),
             "text_masks": masks}
    return arrays, batch


@pytest.mark.parametrize("drop_path", ["off", "table"])
def test_irtr_train_step_matches_jax(monkeypatch, drop_path):
    """(f) Two optimizer steps of 2 micro-batches each: the loss and every
    gradient of step 1, and every param after step 2."""
    cfg_over = dict(drop_rate=0.1 if drop_path == "table" else 0.0)
    jcfg, cfg = _tiny_cfg(jbuild_config, **cfg_over), \
        _tiny_cfg(build_config, **cfg_over)
    jspec, spec = jmake_spec(jcfg), make_model_spec(cfg)
    arrays, batch = _train_inputs(jspec)
    if drop_path == "table":
        # one (L, 2, B) table for every pass on both sides; the text
        # embedding's dropout draws are not comparable, so it is off
        table = np.asarray([[[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]],
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

    params = master_params(params_from_numpy(arrays, "cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = [train_step.loss_and_grads(
        params, spec, cfg, {k: v[i] for k, v in tbatch.items()},
        torch.Generator().manual_seed(0), kernels=False)[2] for i in (0, 1)]
    state, step = build_train_step(cfg, spec, params, 10)
    state, m1 = step(state, tbatch)
    state, m2 = step(state, tbatch)

    for m, jm in ((m1, jm1), (m2, jm2)):
        for key in ("total_loss", "irtr_loss", "grad_norm",
                    "irtr_logit_scale"):
            _close(m[key], jm[key], err_msg=key)
    assert set(jgrads) == set(grads[0])
    for k in jgrads:
        _close((grads[0][k] + grads[1][k]) / 2, jgrads[k],
               err_msg=f"grad {k}")
    got = params_to_numpy(state.params)
    assert state.step == 2 and set(got) == set(arrays)
    # Adam's direction mu/(sqrt(nu) + 1e-8) turns f32 noise in a gradient
    # near 0 into an update of up to ±lr: params get atol lr/4
    for k in arrays:
        np.testing.assert_allclose(got[k], np.asarray(jstate.params[k]),
                                   atol=cfg["learning_rate"] / 4, rtol=1e-4,
                                   err_msg=f"param {k}")
    for k in ("relative_position_bias_table", "logit_scale",
              "transformer.blocks.1.attn.q_bias"):
        assert not np.array_equal(got[k], arrays[k]), k


def test_kernel_route_twins_match_plain_route(monkeypatch):
    """With the kernel gates at 0 every block's attention and MLP take the
    differentiable kernel wrappers (on the CPU: their twins); loss and
    gradients equal the plain route's."""
    cfg = _tiny_cfg(build_config, drop_rate=0.0)
    spec = make_model_spec(cfg)
    arrays, batch = _train_inputs(jmake_spec(cfg))
    mb = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    params = master_params(params_from_numpy(arrays, "cpu"))
    gen = torch.Generator().manual_seed(0)
    loss_p, _, grads_p = train_step.loss_and_grads(params, spec, cfg, mb, gen,
                                                   kernels=False)
    from vl_merging_tpu_torch.models import mome

    monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    calls = []
    for mod, name in ((TA, "packed_attention_bwd_reference"),
                      (TM, "mlp_kernel_reference")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    loss_k, _, grads_k = train_step.loss_and_grads(params, spec, cfg, mb, gen,
                                                   kernels=True)
    # 2 layers x 2 towers of K13 twins, 2 x 2 K9 twin backwards
    assert calls.count("mlp_kernel_reference") == 4
    assert calls.count("packed_attention_bwd_reference") == 4
    _close(loss_k, loss_p.numpy())
    for k in grads_p:
        _close(grads_k[k], grads_p[k].numpy(), err_msg=k)


def test_train_step_contracts():
    """Other tasks name their ROADMAP item; drop_path and dropout draw
    from the generator with keep/rate semantics; the kernel switch is on
    at @384."""
    cfg = _tiny_cfg(build_config, loss_names={"irtr": 1, "itm": 1})
    with pytest.raises(NotImplementedError, match="itm objective.*A6"):
        train_step.compute_losses({}, make_model_spec(cfg), cfg, {}, None)
    full = build_config("task_finetune_irtr_coco_square_randaug_base_image384")
    assert train_step._resolve_kernels(full, make_model_spec(full))
    assert not train_step._resolve_kernels(cfg, make_model_spec(cfg))
    x = torch.ones(4000, 2, 3)
    y = layers.drop_path(x, 0.25, torch.Generator().manual_seed(0), True)
    kept = y[:, 0, 0] != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert (y == y[:, :1, :1]).all() and abs(kept.float().mean() - 0.75) < 0.03
    assert layers.drop_path(x, 0.25, None, True) is x
    z = layers.dropout(x, 0.5, torch.Generator().manual_seed(1), True)
    assert abs((z != 0).float().mean() - 0.5) < 0.02
    assert layers.dropout(x, 0.5, torch.Generator(), False) is x
