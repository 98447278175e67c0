"""The partial-MoE architecture modes (``ln_moe``, ``attn_moe``,
``ffn_moe``: the paper's "which modules to keep per modality" study) in the
port against the JAX package, on the CPU in f32.

Each mode is pretrained, then merged into ``ufo``.  Tiny specs (C=128, 2
heads of 64, 2 layers with ``vlffn_start_layer_index=1``, 64-px images in
16-px patches, 8 text tokens) of the irtr fine-tune
(``task_finetune_irtr_coco_square_randaug_base_image384``) and the
pretrain (``task_mlm_itm_ifm_square_randaug_base``) in each mode get one
seeded numpy param dict each, fed to both packages:

  * the irtr loss and every gradient, and the pretrain's mlm, ifm (with
    its vlffn re-runs) and itm (the JAX package's hard negatives fed
    through ``sample_hard_negatives``), against the JAX step; the port on
    the plain path and on its kernels' twins (irtr: K2/K9 and K13 at the
    tiny shapes; pretrain: the @224 route's K11/K10 and K13);
  * the irtr gram pass's grams against the JAX pass's, by name (under
    ``attn_moe`` the shared MLP's grams are ``mlp.fc1`` / ``mlp.fc2``, as
    the JAX taps name them) and within ``GRAM_RTOL`` of the largest entry;
  * ``merge.py`` by interpolation, task arithmetic and RegMean (on the JAX
    grams) into ``ufo``: the merged checkpoints bit-equal to the JAX CLI's
    (each mode's shared modules through ``merging/core``'s fallbacks);
  * ``load_params`` of each merged checkpoint into ``ufo`` and
    ``compute_irtr_recall``: the params bit-equal, the recall equal and
    the features within the towers' tolerance.

The JAX side of each case runs once per module (``functools.cache``).
Tolerances: f32 atol 1e-5, rtol 1e-4 (losses, gradients); towers atol
2e-5, rtol 1e-4; grams 1e-5 of their largest entry.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu import merge as jmerge
from vl_merging_tpu.ckpt import pipeline as jpipeline
from vl_merging_tpu.config import build_config
from vl_merging_tpu.evaluation import retrieval as jretrieval
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu.train import gram as jgram
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch import merge
from vl_merging_tpu_torch.ckpt import io, pipeline
from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
from vl_merging_tpu_torch.evaluation import retrieval
from vl_merging_tpu_torch.models import mome
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import gram, train_step
from test_torch_port_merging import assert_dicts_equal
from test_torch_port_model import random_arrays
from test_torch_port_pretrain import (assert_losses_and_grads, feed_negatives,
                                      jax_grads, jax_negatives, jtree,
                                      pair_batch, port_grads, ttree)
from torch_port_threads import one_torch_thread  # noqa: F401

MODES = ("ln_moe", "attn_moe", "ffn_moe")
IRTR = "task_finetune_irtr_coco_square_randaug_base_image384"
PRETRAIN = "task_mlm_itm_ifm_square_randaug_base"
SHAPE = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
             patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
             vlffn_start_layer_index=1, precision="f32", drop_rate=0.0,
             per_device_batch_size=4, batch_size=4)
GRAM_RTOL = 1e-5
TOWER_TOL = dict(atol=2e-5, rtol=1e-4)
METHODS = {"merge_weights": ["merge_weights=True", "merge_ratio=0.3"],
           "sum_task_vectors": ["sum_task_vectors=True", "sum_lambda=0.5"],
           "regmean": ["regmean=True", "scaling_for_non_diag=0.9"]}


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny width (128) stands in for a built width: on CPU tensors
    every wrapper runs its twin, which takes any width."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


@functools.cache
def setup(task, mode):
    """(cfg, JAX spec, port spec, numpy params, JAX params, port params)."""
    cfg = build_config(task, mode, overrides=SHAPE)
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    return (cfg, jspec, spec, arrays,
            {k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, "cpu"))


KEY = jax.random.PRNGKey(5)


@functools.cache
def jax_step(task, mode):
    """The JAX step's (loss, outputs, gradients) on ``pair_batch(2)``."""
    cfg, jspec, _, _, jparams, _ = setup(task, mode)
    return jax_grads(lambda p: jtrain_step.compute_losses(
        p, jspec, cfg, jtree(pair_batch(2)), KEY, train=True), jparams)


def _route(monkeypatch, task, route):
    """The port's route: the plain path, or its kernels' twins with the
    thresholds at which the tiny shapes take them (irtr's K2/K9 and K13;
    the pretrain's @224 route, K11/K10 and K13); the wrappers' calls are
    counted."""
    if route == "plain":
        return False, None
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    monkeypatch.setattr(*((mome, "KERNEL_MIN_N", 0) if task == IRTR
                          else (TA, "SPLIT_MIN_N", 0)))
    calls = []
    for name in ("packed_fused_attention", "fused_attention", "fused_mlp"):
        real = getattr(mome, name)
        monkeypatch.setattr(mome, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    return True, calls


@pytest.mark.parametrize("route", ["plain", "twins"])
@pytest.mark.parametrize("task", [IRTR, PRETRAIN])
@pytest.mark.parametrize("mode", MODES)
def test_step_losses_and_grads_match_jax(mode, task, route, monkeypatch):
    cfg, jspec, spec, _, _, params = setup(task, mode)
    want = jax_step(task, mode)
    kernels, calls = _route(monkeypatch, task, route)
    if task == PRETRAIN:
        negatives = jax_negatives(KEY, want[1])
        feed_negatives(monkeypatch, negatives)
    got = port_grads(lambda p: train_step.compute_losses(
        p, spec, cfg, ttree(pair_batch(2)),
        torch.Generator().manual_seed(0), kernels=kernels), params)
    assert_losses_and_grads(got, want)
    if calls is not None:
        attn = "packed_fused_attention" if task == IRTR else \
            "fused_attention"
        assert calls.count(attn) > 0 and calls.count("fused_mlp") > 0


def _gram_batches(n=2, b=3):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        masks = np.ones((b, 8), np.int32)
        masks[0, 5:] = 0
        out.append({"image": rng.randn(b, 3, 64, 64).astype(np.float32),
                    "text_ids": rng.randint(0, 30522, (b, 8)).astype(
                        np.int32),
                    "text_masks": masks})
    return out


def _expected_gram_names(mode, num_layers=2):
    """The irtr gram pass's tapped modules: under ``use_moe`` (attn_moe,
    ffn_moe) the reference's MoE list, which names the shared modules as
    ufo does (``attn``, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``) and each
    expert's v and l inputs; ln_moe takes the ufo list, whose norms its
    per-modality LayerNorms do not match."""
    names = {"ln_moe": ("attn.proj", "mlp.fc1", "mlp.fc2"),
             "attn_moe": ("attn.v", "attn.l", "attn.v.proj", "attn.l.proj",
                          "mlp.fc1", "mlp.fc2"),
             "ffn_moe": ("attn", "attn.proj", "mlp.v.fc1", "mlp.l.fc1",
                         "mlp.v.fc2", "mlp.l.fc2")}[mode]
    return {f"transformer.blocks.{i}.{m}" for i in range(num_layers)
            for m in names}


@functools.cache
def jax_grams(mode):
    cfg, jspec, _, _, jparams, _ = setup(IRTR, mode)
    return jgram.cache_gram_matrices(
        jparams, jspec, cfg, [{k: jnp.asarray(v) for k, v in b.items()}
                              for b in _gram_batches()],
        precision="f32_device")


@pytest.mark.parametrize("mode", MODES)
def test_grams_match_jax(mode):
    cfg, _, spec, _, _, params = setup(IRTR, mode)
    want = jax_grams(mode)
    got = gram.cache_gram_matrices(
        params, spec, cfg, [{k: torch.from_numpy(v) for k, v in b.items()}
                            for b in _gram_batches()],
        precision="f32_device")
    assert set(got) == set(want) == _expected_gram_names(mode)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.float64 and g.shape == w.shape
        assert np.abs(g - w).max() <= GRAM_RTOL * np.abs(w).max(), k


@functools.cache
def merged(mode, method, root):
    """Both CLIs' merged checkpoints of the mode's seeded irtr checkpoint
    (the numpy params of ``setup``), as (JAX path, port path)."""
    root = pathlib.Path(root) / mode / method
    root.mkdir(parents=True)
    *_, arrays, _, _ = setup(IRTR, mode)
    ckpt = str(root / "mode.ckpt")
    io.save_torch_checkpoint(arrays, ckpt)
    extra = list(METHODS[method])
    if method == "sum_task_vectors":
        ucfg = build_config(IRTR, "ufo", overrides=SHAPE)
        rng = np.random.RandomState(2)
        central = str(root / "central.ckpt")
        io.save_torch_checkpoint(
            {k: np.asarray(0.02 * rng.randn(*s), np.float32)
             for k, s in jparam_shapes(jmake_spec(ucfg)).items()}, central)
        extra.append(f"central_weight={central!r}")
    if method == "regmean":
        gpath = str(root / "G.pth")
        io.save_torch_checkpoint(jax_grams(mode), gpath,
                                 lightning_envelope=False)
        extra.append(f"gram_matrices={gpath!r}")
    shape = [f"{k}={v!r}" for k, v in SHAPE.items()]
    return tuple(main(["with", IRTR, mode, *shape, f"load_path={ckpt!r}",
                       *extra, f"log_dir={str(root / name)!r}"])
                 for main, name in ((jmerge.main, "jax"),
                                    (merge.main, "port")))


@pytest.fixture(scope="module")
def merge_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("merges"))


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("mode", MODES)
def test_merge_into_ufo_is_bit_equal_to_jax(mode, method, merge_root):
    jout, out = merged(mode, method, merge_root)
    want, got = io.load_torch_checkpoint(jout), io.load_torch_checkpoint(out)
    assert_dicts_equal(got, want)
    ucfg = build_config(IRTR, "ufo", overrides=SHAPE)
    assert set(got) == set(jparam_shapes(jmake_spec(ucfg)))
    # the mode's shared modules come through unchanged (core.py's
    # fallback), its experts are merged
    *_, arrays, _, _ = setup(IRTR, mode)
    shared = {"ln_moe": "attn.qkv.weight", "attn_moe": "mlp.fc1.weight",
              "ffn_moe": "attn.proj.weight"}[mode]
    k = f"transformer.blocks.0.{shared}"
    assert_dicts_equal({k: np.asarray(got[k], np.float32)},
                       {k: arrays[k]})


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("mode", MODES)
def test_merged_model_recall_matches_jax(mode, method, merge_root):
    """``load_params`` into ufo (``test_only``) and the retrieval eval in
    both packages: params bit-equal, recall equal, features within the
    towers' tolerance."""
    outs = merged(mode, method, merge_root)
    cfgs = [build_config(IRTR, "ufo", overrides=dict(
        SHAPE, load_path=out, test_only=True)) for out in outs]
    jspec, spec = jmake_spec(cfgs[0]), make_model_spec(cfgs[1])
    jparams, jmissing, _ = jpipeline.load_params(cfgs[0], jspec)
    params, missing, _ = pipeline.load_params(cfgs[1], spec)
    assert missing == jmissing == []
    assert_dicts_equal({k: v.numpy() for k, v in params.items()},
                       {k: np.asarray(v) for k, v in jparams.items()})
    rng = np.random.RandomState(1)
    n_img, caps = 4, 2
    images = rng.randn(n_img, 3, 64, 64).astype(np.float32)
    ids = rng.randint(0, 30522, (n_img * caps, 8)).astype(np.int32)
    masks = np.ones_like(ids)
    masks[::2, 5:] = 0
    tiids, iids = np.repeat(np.arange(n_img), caps), np.arange(n_img)
    jtext = [{"text_ids": jnp.asarray(ids), "text_masks": jnp.asarray(masks)}]
    jimage = [{"image": jnp.asarray(images)}]
    want = jretrieval.compute_irtr_recall(jparams, jspec, jtext, jimage,
                                          tiids, iids)
    tparams = params_from_numpy(params, "cpu")
    text = [{"text_ids": torch.from_numpy(ids),
             "text_masks": torch.from_numpy(masks)}]
    image = [{"image": torch.from_numpy(images)}]
    got = retrieval.compute_irtr_recall(tparams, spec, text, image,
                                        tiids, iids)
    assert got == {k: float(v) for k, v in want.items()}
    for kind, jb, tb in (("image", jimage, image), ("text", jtext, text)):
        np.testing.assert_allclose(
            retrieval.extract_features(tparams, spec, tb, kind).numpy(),
            np.asarray(jretrieval.extract_features(jparams, jspec, jb, kind)),
            **TOWER_TOL, err_msg=kind)
