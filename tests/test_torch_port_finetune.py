"""The port's fine-tune steps and optimizers against the JAX package, on
the CPU in f32.

One train step each of the NLVR2 (``..._nlvr2_..._image384`` + ufo), VQA
(``..._vqa_..._image384_ufo`` + ufo) and ImageNet (``..._imagenet_...
_image384``) fine-tunes at tiny specs (C=128, 2 heads of 64, 2 layers,
``vlffn_start_layer_index=1``; 64-px images, 17 image tokens; 8 text
tokens, captions of 3 to 8 valid tokens, so the fused passes' key mask
has zeros inside): the loss, every gradient and every param after the
AdamW step against JAX ``compute_losses`` under ``jax.value_and_grad`` and
the JAX package's optax chain, with the same seeded numpy params, batch
and (L, 2, B) stochastic-depth table on both sides (the text dropout
off).  The port runs each step on the plain path, through the twins of
K2 forward and K9 backward (every attention; ``KERNEL_MIN_N`` at 0) and
K13, and so again under ``train_fusion`` "full" (K1's and K6's twins).
The "adam" and "sgd" optimizers against the JAX package's optax chains
over three steps of seeded gradients.

Tolerances: f32 atol 1e-5, rtol 1e-4; params after a step within lr/4
(``test_torch_port_train.py``); the optimizers' updates within 1e-4 of
lr (their f32 arithmetic is optax's, in its order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vl_merging_tpu.config import build_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch.ckpt.convert import master_params, \
    params_from_numpy, params_to_numpy
from vl_merging_tpu_torch.models import model, mome
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import optimizer, schedule, train_step
from vl_merging_tpu_torch.train.loop import build_train_step
from test_torch_port_model import random_arrays
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=1e-5, rtol=1e-4)
SHAPE = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
             patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
             vlffn_start_layer_index=1, precision="f32", drop_rate=0.1,
             per_device_batch_size=4, batch_size=4, learning_rate=1e-4,
             warmup_steps=0)
TASKS = {"nlvr2": ("task_finetune_nlvr2_square_randaug_base_image384",
                   "ufo"),
         "vqa": ("task_finetune_vqa_square_randaug_base_image384_ufo",
                 "ufo"),
         "img_cls": ("task_finetune_imagenet_square_randaug_base_image384",)}
B = 4
TABLE = np.asarray([[[1.0] * B] * 2,
                    [[0.0, 1 / 0.9, 1 / 0.9, 0.0],
                     [1 / 0.9, 0.0, 1 / 0.9, 1 / 0.9]]], np.float32)


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny width (128) stands in for a built width: on CPU tensors
    every wrapper runs its twin, which takes any width."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


@pytest.fixture(autouse=True)
def _tables(monkeypatch):
    """TABLE for every stochastic-depth draw, no text dropout."""
    monkeypatch.setattr(jmodel, "_dp_scale_table",
                        lambda spec, rng, train, batch:
                        jnp.asarray(TABLE) if train else None)
    monkeypatch.setattr(jmodel, "dropout", lambda x, *a: x)
    monkeypatch.setattr(model, "_dp_scale_table", functools.partial(
        model._dp_scale_table, table=TABLE))
    monkeypatch.setattr(model, "dropout", lambda x, *a, **k: x)


@pytest.fixture(params=["plain", "kernel twins", "kernel twins, full"])
def route(request, monkeypatch):
    """(kernels, train_fusion, the twins' calls): the plain path; every
    attention through K2's and K9's twins and every MLP through K13's;
    that under the training fusion "full"."""
    calls = []
    if request.param == "plain":
        return False, "0", calls
    monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    for mod, name in ((TA, "packed_attention_stats_reference"),
                      (TA, "packed_attention_bwd_reference")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    return True, "full" if request.param.endswith("full") else "0", calls


@functools.cache
def setup(task):
    cfg = build_config(*TASKS[task], overrides=dict(SHAPE))
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    return (cfg, jspec, spec, arrays,
            {k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, "cpu"))


def task_batch(task, spec, seed=1) -> dict:
    rng = np.random.RandomState(seed)
    masks = np.ones((B, 8), np.int32)
    for i, m in enumerate(rng.randint(3, 9, B)):
        masks[i, m:] = 0
    b = {"text_ids": rng.randint(1000, 30522, (B, 8)).astype(np.int32),
         "text_masks": masks,
         "image": rng.randn(B, 3, 64, 64).astype(np.float32)}
    if task == "nlvr2":
        b.update(image_0=b["image"], image_1=rng.randn(B, 3, 64, 64).astype(
            np.float32), answers=np.array([0, 1, 1, 0], np.int32))
    elif task == "vqa":
        b["vqa_targets"] = (rng.rand(B, spec.vqav2_label_size) * (
            rng.rand(B, spec.vqav2_label_size) < 0.01)).astype(np.float32)
    else:
        b["class_label"] = rng.randint(0, spec.img_cls_label_size,
                                       B).astype(np.int32)
    return b


def assert_close(got, want, err_msg="", **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               err_msg=err_msg, **(tol or F32_TOL))


@functools.cache
def jax_step(task):
    """(loss, scalar metrics, grads, params after the AdamW step) of the
    JAX package on ``task_batch``: one compile per task, shared by the
    port's routes."""
    cfg, jspec, _, _, jparams, _ = setup(task)
    jb = {k: jnp.asarray(v) for k, v in task_batch(task, jspec).items()}

    def jloss(p):
        out = jtrain_step.compute_losses(p, jspec, cfg, jb,
                                         jax.random.PRNGKey(0), train=True)
        return jtrain_step.total_loss(out), jtrain_step.scalar_metrics(out)
    (want, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    jopt = jmake_optimizer(jparams, cfg, 10, jmake_schedule(cfg, 10))
    updates, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    return want, jmetrics, jgrads, optax.apply_updates(jparams, updates)


@pytest.mark.parametrize("task", list(TASKS))
def test_finetune_step_matches_jax(task, route):
    """One AdamW step: loss, metrics, every gradient, every param after."""
    kernels, fusion, calls = route
    cfg, _, spec, arrays, _, params = setup(task)
    tb = {k: torch.from_numpy(v)
          for k, v in task_batch(task, spec).items()}
    want, jmetrics, jgrads, jnew = jax_step(task)

    gen = torch.Generator().manual_seed(0)
    loss, metrics, grads = train_step.loss_and_grads(
        master_params(params), spec, cfg, tb, gen, kernels=kernels,
        train_fusion=fusion)
    if kernels:
        # the twins ran: K2's training launch and K9 in every block (the
        # NLVR2 pass twice, a split layer's halves apart)
        blocks = {"nlvr2": 2 * 3, "vqa": 3, "img_cls": 2}[task]
        assert calls.count("packed_attention_stats_reference") == blocks
        assert calls.count("packed_attention_bwd_reference") == blocks
    assert_close(loss, want, "loss")
    for k, v in jmetrics.items():
        assert_close(metrics[k], v, k)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert_close(grads[k], jgrads[k], f"grad {k}")

    state, step = build_train_step(cfg, spec, master_params(params), 10,
                                   train_fusion=fusion)
    state, m = step(state, tb)
    assert_close(m["total_loss"], want, "step loss")
    got = params_to_numpy(state.params)
    for k in arrays:
        np.testing.assert_allclose(got[k], np.asarray(jnew[k]),
                                   atol=cfg["learning_rate"] / 4, rtol=1e-4,
                                   err_msg=f"param {k}")
    assert not np.array_equal(got["relative_position_bias_table"],
                              arrays["relative_position_bias_table"])


@pytest.mark.parametrize("optim_type", ["adam", "sgd", "adamw"])
def test_optimizer_matches_optax(optim_type):
    """Three updates of seeded gradients through the port's optimizer and
    the JAX package's optax chain (warmup and decay schedule, a head with
    lr_mult 10, weight decay where the kind has it): equal updates."""
    cfg = build_config(TASKS["vqa"][0], overrides=dict(
        SHAPE, optim_type=optim_type, warmup_steps=2, lr_mult=10,
        weight_decay=0.05))
    rng = np.random.RandomState(2)
    shapes = {"transformer.blocks.0.attn.qkv.weight": (6, 4),
              "transformer.blocks.0.norm1.weight": (4,),
              "vqa_classifier.0.weight": (5, 4),
              "vqa_classifier.0.bias": (5,)}
    arrays = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jopt = jmake_optimizer(jparams, cfg, 10, jmake_schedule(cfg, 10))
    opt = optimizer.make_optimizer(arrays, cfg, 10,
                                   schedule.make_schedule(cfg, 10))
    params = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    jstate, state = jopt.init(jparams), opt.init(params)
    for i in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        jupd, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, jstate, jparams)
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in
                                 grads.items()}, state, params)
        for k in shapes:
            assert_close(upd[k], jupd[k], f"step {i} {k}",
                         atol=1e-4 * cfg["learning_rate"], rtol=1e-5)
            params[k] += upd[k]
        jparams = optax.apply_updates(jparams, jupd)
    assert state.count == 3 and (optim_type == "sgd") == (state.nu == {})
