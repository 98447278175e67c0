"""Four named configs that no other test of the port names, shrunk in width
and depth but keeping what sets each apart, against the JAX package on
the CPU in f32:

  * ``task_finetune_vqa_square_randaug_large_image384_ufo`` + ufo (ViT-L
    VQA): its width and 16 heads of dim 64 (C=1024: the attention kernels
    take head dim 64 only), 4 layers with ``vlffn_start_layer_index`` at
    depth − 3 (one split layer, three joint), the VQA head; the MLP at
    ratio 1 and a vocabulary of 1024 keep it small;
  * ``task_finetune_imagenet_square_randaug_base_image224``: the 224-px
    image of 197 tokens and the ``img_cls`` head;
  * ``task_finetune_irtr_msrvtt_frame_square_randaug_base`` + ufo: one
    frame (``num_frames`` 1) and its losses, irtr + ifm + itm;
  * ``task_mlm_itm_ifm_square_randaug_base_vl`` + all_moe (the dry run's
    full-width config): ``tasks=["vl"]``, ``max_vl_text_len=40`` and
    captions of 40 tokens.

Each runs on the plain routing and on the kernel-twin routing (the
thresholds at 0, as ``test_torch_port_vl.py``: every attention through
K2's twin and K9's, every MLP through K13's, the eval blocks through
K1-K3's), ImageNet also on the @224 routing as it stands (K11's twin at
197 tokens, K13's).  The forward (the task's features and head) within
``TOWER_TOL`` (atol 2e-5, rtol 1e-4); the losses and every gradient of
``compute_losses`` within f32 atol 1e-5, rtol 1e-4 (the ladder of
``test_torch_port_train.py``), with one (L, 2, B) stochastic-depth table
on both sides, no text dropout and, for itm, the JAX package's hard
negatives fed through ``sample_hard_negatives``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import random_arrays
from test_torch_port_pretrain import assert_close, feed_negatives, \
    jax_grads, jax_negatives, jtree, port_grads, ttree
from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.models import model, mome
from vl_merging_tpu_torch.models.spec import VL, make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.ops import mlp as TM
from vl_merging_tpu_torch.train import train_step
from torch_port_threads import one_torch_thread  # noqa: F401

TOWER_TOL = dict(atol=2e-5, rtol=1e-4)
B = 4
SHAPE = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
             patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
             vlffn_start_layer_index=1, precision="f32", drop_rate=0.1,
             per_device_batch_size=B, batch_size=B, warmup_steps=0)
# name -> (named configs, overrides over SHAPE)
CONFIGS = {
    "vit_l_vqa": (("task_finetune_vqa_square_randaug_large_image384_ufo",
                   "ufo"),
                  dict(hidden_size=1024, num_heads=16, num_layers=4,
                       vlffn_start_layer_index=1, mlp_ratio=1,
                       vocab_size=1024, vqav2_label_size=24)),
    "imagenet_224": (("task_finetune_imagenet_square_randaug_base_image224",),
                     dict(image_size=224, img_cls_label_size=24)),
    "msrvtt_frame": (("task_finetune_irtr_msrvtt_frame_square_randaug_base",
                      "ufo"), {}),
    "base_vl": (("task_mlm_itm_ifm_square_randaug_base_vl", "all_moe"),
                dict(max_text_len=40, max_text_len_of_initckpt=40)),
}
# the twins each routing runs, counted
TWINS = (("packed_attention_reference", TA),
         ("packed_attention_stats_reference", TA),
         ("packed_attention_bwd_reference", TA),
         ("split_attention_reference", TA),
         ("mlp_kernel_reference", TM),
         ("proj_mlp_tail_reference", TF))


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny width (128) stands in for a built width: on CPU tensors
    every wrapper runs its twin, which takes any width."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


def table(spec):
    """One (L, 2, B) stochastic-depth table: layer 0 keeps every sample,
    the others keep 0.9."""
    rng = np.random.RandomState(7)
    t = np.ones((spec.num_layers, 2, B), np.float32)
    t[1:] = np.where(rng.rand(spec.num_layers - 1, 2, B) < 0.9, 1 / 0.9, 0)
    return t


@pytest.fixture
def tables(monkeypatch, request):
    """The config's table for every stochastic-depth draw of both
    packages, no text dropout."""
    name = request.node.callspec.params["name"]
    t = table(setup(name)[2])
    monkeypatch.setattr(jmodel, "_dp_scale_table",
                        lambda spec, rng, train, batch:
                        jnp.asarray(t) if train else None)
    monkeypatch.setattr(jmodel, "dropout", lambda x, *a: x)
    monkeypatch.setattr(model, "_dp_scale_table", functools.partial(
        model._dp_scale_table, table=t))
    monkeypatch.setattr(model, "dropout", lambda x, *a, **k: x)


@functools.cache
def setup(name):
    """(cfg, JAX spec, port spec, JAX params, port params)."""
    names, over = CONFIGS[name]
    over = dict(SHAPE, **over)
    cfg = build_config(*names, overrides=over)
    assert jbuild_config(*names, overrides=over) == cfg
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    return (cfg, jspec, spec, {k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, "cpu"))


def batch(name, spec) -> dict:
    """The config's seeded batch: captions of 3 (5 for base_vl) to all
    valid tokens, so the fused passes' key masks have zeros inside."""
    rng = np.random.RandomState(3)
    T, size = spec.max_text_len, spec.image_size
    masks = np.ones((B, T), np.int32)
    for i, m in enumerate(rng.randint(T // 8 + 2, T + 1, B)):
        masks[i, m:] = 0
    ids = rng.randint(0, spec.vocab_size, (B, T)).astype(np.int32)
    b = {"text_ids": ids, "text_masks": masks,
         "image": rng.randn(B, 3, size, size).astype(np.float32)}
    if name == "vit_l_vqa":
        b["vqa_targets"] = (rng.rand(B, spec.vqav2_label_size) * (
            rng.rand(B, spec.vqav2_label_size) < 0.2)).astype(np.float32)
    elif name == "imagenet_224":
        b = {"image": b["image"], "class_label": rng.randint(
            0, spec.img_cls_label_size, B).astype(np.int32)}
    elif name == "base_vl":
        picked = (rng.rand(B, T) < 0.3) & (masks > 0)
        picked[:, 1] = True
        b.update(text_ids_mlm=np.where(picked, 103, ids).astype(np.int32),
                 text_labels_mlm=np.where(picked, ids, -100).astype(
                     np.int32))
    return b


def forward(pkg, name, params, spec, b, **route):
    """The config's task forward: the fused pass and its head (VQA,
    base_vl), the image tower's mean feature through ``img_cls``
    (ImageNet), both retrieval towers (MSR-VTT)."""
    m = jmodel if pkg == "jax" else model
    if name == "imagenet_224":
        feats = m.infer_image_ft(params, spec, b, **route)["image_feats"]
        return {"logits": m.img_cls_head(params, feats.mean(1))}
    if name == "msrvtt_frame":
        return {"image": m.infer_image_ft(params, spec, b,
                                          **route)["cls_feats"],
                "text": m.infer_text_ft(params, spec, b,
                                        **route)["cls_feats"]}
    out = m.infer(params, spec, b, **route)
    got = {k: out[k] for k in ("cls_feats", "text_feats", "image_feats")}
    if name == "vit_l_vqa":
        got["logits"] = m.vqa_head(params, out["cls_feats"])
    return got


@functools.cache
def jax_side(name):
    """The JAX package's forward, and (loss, outputs, gradients) of its
    ``compute_losses`` under jit, with the key its itm draws from."""
    cfg, jspec, _, jparams, _ = setup(name)
    b = jtree(batch(name, jspec))
    fwd = jax.jit(lambda p: forward("jax", name, p, jspec, b))(jparams)
    key = jax.random.PRNGKey(5)
    with pytest.MonkeyPatch.context() as patch:
        t = table(jspec)
        patch.setattr(jmodel, "_dp_scale_table",
                      lambda spec, rng, train, batch:
                      jnp.asarray(t) if train else None)
        patch.setattr(jmodel, "dropout", lambda x, *a: x)
        grads = jax_grads(lambda p: jtrain_step.compute_losses(
            p, jspec, cfg, b, key, train=True), jparams)
    return fwd, grads, key


ROUTES = [(n, r) for n in CONFIGS for r in ("plain", "kernel twins")] + [
    ("imagenet_224", "@224 route")]


@pytest.fixture
def twins(monkeypatch):
    """The calls of each twin, by name."""
    calls = {name: 0 for name, _ in TWINS}
    for name, mod in TWINS:
        real = getattr(mod, name)

        def counted(*a, _r=real, _n=name, **k):
            calls[_n] += 1
            return _r(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("name,routing", ROUTES)
def test_config_matches_jax(name, routing, twins, tables, monkeypatch):
    cfg, jspec, spec, _, params = setup(name)
    if routing == "kernel twins":
        monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
        monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    kernels = routing != "plain"
    want_fwd, want, key = jax_side(name)
    tb = ttree(batch(name, spec))

    with torch.no_grad():
        got = forward("port", name, params, spec, tb, kernels=kernels)
    assert set(got) == set(want_fwd)
    for k, v in want_fwd.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   err_msg=k, **TOWER_TOL)
    eval_twins = dict(twins)

    if "itm" in train_step.active_tasks(cfg):
        feed_negatives(monkeypatch, jax_negatives(key, want[1]))
    got = port_grads(lambda p: train_step.compute_losses(
        p, spec, cfg, tb, torch.Generator().manual_seed(0),
        kernels=kernels), params)
    (loss, out, grads), (jloss, jout, jgrads) = got, want
    assert_close(loss, jloss, "total loss")
    for k, v in jout.items():
        if k.endswith(("_loss", "_correct", "_count", "_scale")):
            assert_close(out[k], v, k)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert_close(grads[k], jgrads[k], f"grad {k}")
    train_twins = {k: twins[k] - eval_twins[k] for k in twins}

    # the routing ran the twins it should: none on the plain path
    if routing == "plain":
        assert not any(twins.values()), twins
    elif routing == "@224 route":
        # 197 tokens: K11's twin (4 images) and K13's, no K2 or K9
        assert spec.image_len == 197
        assert eval_twins["split_attention_reference"] == spec.num_layers
        assert train_twins["split_attention_reference"] == spec.num_layers
        assert twins["mlp_kernel_reference"] == 2 * spec.num_layers
        assert not twins["packed_attention_stats_reference"]
    else:
        assert train_twins["packed_attention_stats_reference"] == \
            train_twins["packed_attention_bwd_reference"] > 0
        if name == "vit_l_vqa":
            # a fused pass: the split layers' halves apart, the deep
            # layers over the joint sequence, in the forward and the step
            split = sum(mome.splits(b, VL) for b in spec.blocks)
            assert (split, spec.num_layers - split) == (1, 3)
            passes = 2 * split + spec.num_layers - split
            assert eval_twins["packed_attention_reference"] == passes
            assert train_twins["packed_attention_bwd_reference"] == passes
            assert spec.num_heads == 16


def test_vit_l_vqa_layer_biases_cover_every_layer_and_head():
    """``fused_layer_biases`` of the ViT-L VQA spec: a (H, N, N) bias a
    joint layer and a text and an image one a split layer, at 16 heads,
    the joint one equal to JAX ``precompute_bias``'s."""
    cfg, jspec, spec, jparams, params = setup("vit_l_vqa")
    T = spec.max_text_len
    bias = model.fused_layer_biases(params, spec, T)
    want = jmodel.precompute_bias(jparams, jspec, "fused", T)
    n = T + spec.image_len
    assert tuple(want.shape) == (spec.num_layers, 16, n, n)
    split = [mome.splits(b, VL) for b in spec.blocks]
    assert split == [True, False, False, False]
    for i, s in enumerate(split):
        layer = bias[i]
        if s:
            text, image = layer
            assert text.shape == (16, T, T) and image.shape == (
                16, spec.image_len, spec.image_len)
            np.testing.assert_allclose(text.numpy(),
                                       np.asarray(want[i, :, :T, :T]),
                                       **TOWER_TOL)
            np.testing.assert_allclose(image.numpy(),
                                       np.asarray(want[i, :, T:, T:]),
                                       **TOWER_TOL)
        else:
            np.testing.assert_allclose(layer.numpy(),
                                       np.asarray(want[i]), **TOWER_TOL)
