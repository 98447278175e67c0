"""The port's gram pass (``models/taps.py``, ``train/gram.py``) against
the JAX package, on the CPU.

A tiny irtr spec (C 128, 2 heads of 64, 2 layers, 64-px images, 8 text
tokens), all_moe and ufo, gets one seeded numpy param dict; both
packages cache grams over the same two batches.  The tapped modules are
the JAX package's, by name and by count; each gram within f32 noise of
the JAX gram (``GRAM_RTOL`` of its largest entry: the activations agree
to the port's f32 tower tolerance, and a gram sums their products) in
both precisions.  ``gram_f64`` of equal activations is bit-equal.  Under a
tap the blocks leave the fused eval block and K13 but keep the packed
attention, and their features stay those of the untapped towers.  Grams
cached by the port feed ``merge.py``'s regmean to the JAX package's
merged checkpoint, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu import merge as jmerge
from vl_merging_tpu.config import build_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import taps as jtaps
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu.train import gram as jgram
from vl_merging_tpu_torch import merge
from vl_merging_tpu_torch.ckpt import io
from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
from vl_merging_tpu_torch.models import model, mome, taps
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import gram
from test_torch_port_merging import assert_dicts_equal
from torch_port_threads import one_torch_thread  # noqa: F401

TASK = "task_finetune_irtr_coco_square_randaug_base_image384"
OVER = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
            patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
            vlffn_start_layer_index=1, precision="f32",
            loss_names={"irtr": 1})
# a gram sums products of activations that agree to ~1e-6 relative
GRAM_RTOL = 1e-5
TOWER_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny width (128) stands in for a built width and every block
    takes the kernel routes (their twins on CPU tensors)."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})
    monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)


def _arrays(cfg, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in jparam_shapes(jmake_spec(cfg)).items():
        v = rng.randn(*shape)
        if len(shape) == 1:
            v = 0.1 * v + (1.0 if "norm" in k.lower() and
                           k.endswith(".weight") else 0.0)
        elif k != "relative_position_bias_table":
            v = 0.02 * v
        out[k] = np.asarray(v, np.float32)
    return out


def _batches(n=2, b=3):
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


@functools.cache
def _setup(mode):
    """(mode, cfg, JAX spec, port spec, numpy params, JAX grams by
    precision): the JAX gram pass runs once per mode."""
    cfg = build_config(TASK, mode, overrides=OVER)
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = _arrays(cfg, 0)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches()]
    want = {p: jgram.cache_gram_matrices(jparams, jspec, cfg, jbatches,
                                         precision=p)
            for p in ("f64_host", "f32_device")}
    return mode, cfg, jspec, spec, arrays, want


@pytest.fixture(params=["all_moe", "ufo"])
def setup(request):
    return _setup(request.param)


def _expected_names(mode, num_layers=2):
    if mode == "all_moe":
        mods = ("attn.{}", "attn.{}.proj", "mlp.{}.fc1", "mlp.{}.fc2")
        return {f"transformer.blocks.{i}.{m.format(e)}"
                for i in range(num_layers) for m in mods for e in "vl"}
    return {f"transformer.blocks.{i}.{m}" for i in range(num_layers)
            for m in ("attn.proj", "mlp.fc1", "mlp.fc2", "norm1", "norm2")}


@pytest.mark.parametrize("precision", ["f64_host", "f32_device"])
def test_grams_match_jax(setup, precision):
    mode, cfg, jspec, spec, arrays, want = setup
    params = params_from_numpy(arrays, "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches()]
    got = gram.cache_gram_matrices(params, spec, cfg, batches,
                                   precision=precision)
    assert set(got) == set(want[precision]) == _expected_names(mode)
    for k, w in want[precision].items():
        g = got[k]
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_array_equal(g, g.T, err_msg=k)
        assert np.abs(g - w).max() <= GRAM_RTOL * np.abs(w).max(), k
    limited = gram.cache_gram_matrices(params, spec, cfg, batches,
                                       limit_batches=1, precision=precision)
    one = gram.cache_gram_matrices(params, spec, cfg, batches[:1],
                                   precision=precision)
    assert_dicts_equal(limited, one)


def test_tap_points_and_gram_f64_match_jax(setup):
    """The same module inputs are captured (names and calls per forward);
    gram_f64 of equal activations is bit-equal, bf16 widened exactly."""
    mode, cfg, jspec, spec, arrays, want = setup
    b = _batches(1)[0]
    jacts = jgram.make_capture_step(cfg, jspec)(
        {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    acts = gram.make_capture_step(cfg, spec)(
        params_from_numpy(arrays, "cpu"),
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert {k: len(v) for k, v in acts.items()} == \
        {k: len(v) for k, v in jacts.items()}
    for k in acts:
        for a, ja in zip(acts[k], jacts[k]):
            assert tuple(a.shape) == ja.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(ja),
                                       **TOWER_TOL, err_msg=k)
            ja = np.asarray(ja)
            assert_dicts_equal({k: gram.gram_f64(torch.from_numpy(ja))},
                               {k: jgram.gram_f64(ja)})
    x = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(0))
    assert_dicts_equal({"g": gram.gram_f64(x.to(torch.bfloat16))},
                       {"g": jgram.gram_f64(jgram._to_numpy_f32_or_wider(
                           jnp.asarray(x.numpy(), jnp.bfloat16)))})
    assert taps.MOE_GRAM_SUFFIXES == jtaps.MOE_GRAM_SUFFIXES
    assert taps.UFO_GRAM_SUFFIXES == jtaps.UFO_GRAM_SUFFIXES


def test_tap_routing_and_features(setup, monkeypatch):
    """Every block of both towers (the kernel threshold at 0) takes the
    fused eval block untapped; under a tap the composed path with the
    packed attention, without the fused eval block or K13; the
    features equal the untapped towers' within the f32 tower tolerance,
    and no tap is left active."""
    mode, cfg, jspec, spec, arrays, want = setup
    params = params_from_numpy(arrays, "cpu")
    calls = []
    for name in ("fused_eval_block", "packed_fused_attention", "fused_mlp"):
        real = getattr(mome, name)
        monkeypatch.setattr(mome, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    L = spec.num_layers

    def towers():
        calls.clear()
        img = model.infer_image_ft(params, spec, b)["cls_feats"]
        txt = model.infer_text_ft(params, spec, b)["cls_feats"]
        return img, txt, sorted(calls)

    img, txt, untapped = towers()
    tap = taps.GramTap(taps.MOE_GRAM_SUFFIXES + taps.UFO_GRAM_SUFFIXES)
    with taps.active_tap(tap):
        assert taps.tapping()
        timg, ttxt, tapped = towers()
    assert not taps.tapping()
    assert untapped == ["fused_eval_block"] * 2 * L
    assert tapped == ["packed_fused_attention"] * 2 * L
    assert tap.grams
    np.testing.assert_allclose(timg.numpy(), img.numpy(), **TOWER_TOL)
    np.testing.assert_allclose(ttxt.numpy(), txt.numpy(), **TOWER_TOL)


def test_port_grams_regmean_merge_matches_jax(tmp_path):
    """Grams cached and saved by the port feed regmean (over the all_moe
    experts) in both packages' merge CLIs: the merged checkpoints equal
    bit for bit."""
    mode, cfg, jspec, spec, arrays, want = _setup("all_moe")
    grams = gram.cache_gram_matrices(
        params_from_numpy(arrays, "cpu"), spec, cfg,
        [{k: torch.from_numpy(v) for k, v in b.items()}
         for b in _batches()])
    gpath = str(tmp_path / "G.pth")
    gram.save_gram_matrices(grams, gpath)
    assert_dicts_equal(io.load_torch_checkpoint(gpath), grams)
    ckpt = str(tmp_path / "moe.ckpt")
    io.save_torch_checkpoint(arrays, ckpt)
    shape = [f"{k}={v!r}" for k, v in OVER.items()]
    outs = [main(["with", TASK, "all_moe", *shape, f"load_path={ckpt!r}",
                  "regmean=True", "scaling_for_non_diag=0.9",
                  f"gram_matrices={gpath!r}",
                  f"log_dir={str(tmp_path / name)!r}"])
            for main, name in ((jmerge.main, "jax"), (merge.main, "port"))]
    merged = [io.load_torch_checkpoint(o) for o in outs]
    assert_dicts_equal(merged[1], merged[0])
    assert merged[1]["transformer.blocks.0.mlp.fc2.weight"].dtype == \
        np.float64
