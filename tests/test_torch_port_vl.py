"""The port's fused VL pass (``models/model.infer``, type-VL blocks in
``models/mome.py``, the fused rel-pos index, the heads) against the JAX
package, on the CPU in f32.

A tiny NLVR2 spec with every head (C=128, 2 heads of 64, 2 layers,
``vlffn_start_layer_index=1``: layer 0 splits or takes per-half experts,
layer 1 is a deep block; 64-px images in 16-px patches, 17 image tokens;
8 text tokens, captions of 3 to 8 valid tokens so that the joint key mask
has zeros inside the sequence) gets one seeded numpy param dict per
routing mode; both packages run it.  Each port case runs twice: with
``kernels=False`` (the plain path) and with the routing thresholds at 0,
so the blocks take the twins of K1-K3 (``_block_fast``) and K13.  The
port must agree with the JAX package to ``TOWER_TOL`` (atol 2e-5, rtol
1e-4, the towers' tolerance); the grams of an all_moe gram pass over
NLVR2 (the vl experts included) to ``GRAM_RTOL`` of the largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu.config import build_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.models import relpos as jrelpos
from vl_merging_tpu.models.mome import pallas_attention
from vl_merging_tpu.train import gram as jgram
from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
from vl_merging_tpu_torch.models import model, mome, relpos
from vl_merging_tpu_torch.models.spec import VL, make_model_spec
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import gram
from test_torch_port_model import random_arrays
from torch_port_threads import one_torch_thread  # noqa: F401

TOWER_TOL = dict(atol=2e-5, rtol=1e-4)
GRAM_RTOL = 1e-5
TASK = "task_finetune_nlvr2_square_randaug_base_image384"
HEADS = {"itm": 1, "mlm": 1, "mim": 1, "vqa": 1, "nlvr2": 1, "img_cls": 1}
# (named configs, overrides) of each routing mode; the last is moe whose
# shallow blocks run both attention experts over all tokens
MODES = {"ufo": (("ufo",), {}), "all_moe": (("all_moe",), {}),
         "ln_moe": (("ln_moe",), {}), "attn_moe": (("attn_moe",), {}),
         "ffn_moe": (("ffn_moe",), {}),
         "moe_both": (("all_moe",), {"self_attn_for_single_mode": False})}
B = 3


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny width (128) stands in for a built width: on CPU tensors
    every wrapper runs its twin, which takes any width."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


def vl_cfg(*modes, task=TASK, **over):
    shape = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
                 patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
                 vlffn_start_layer_index=1, precision="f32",
                 loss_names=HEADS)
    shape.update(over)
    return build_config(task, *modes, overrides=shape)


def vl_inputs(seed=1, n=B, size=64, text_len=8):
    """Seeded images (both NLVR2 images) and captions of 3..text_len
    valid tokens."""
    rng = np.random.RandomState(seed)
    masks = np.ones((n, text_len), np.int32)
    for i, m in enumerate(rng.randint(3, text_len + 1, n)):
        masks[i, m:] = 0
    masks[0, 3:] = 0                      # at least one short caption
    return {"text_ids": rng.randint(0, 30522, (n, text_len)).astype(np.int32),
            "text_masks": masks,
            "image_0": rng.randn(n, 3, size, size).astype(np.float32),
            "image_1": rng.randn(n, 3, size, size).astype(np.float32)}


@functools.cache
def setup(mode, task=TASK, losses=None, **over):
    """(cfg, JAX spec, port spec, numpy params, JAX params, port params) of
    ``task`` in ``mode``: every head, or the losses named in ``losses``."""
    modes, extra = MODES[mode]
    if losses is not None:
        extra = dict(extra, loss_names=dict.fromkeys(losses, 1))
    cfg = vl_cfg(*modes, task=task, **dict(extra, **over))
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    return (cfg, jspec, spec, arrays,
            {k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, "cpu"))


def jinfer(jparams, jspec, batch, **kw):
    """The JAX package's fused pass under ``jit`` (one compile per shape
    beats eager dispatch's compile per op), the keyword arguments static."""
    fn = jax.jit(lambda p, b: jmodel.infer(p, jspec, b, **kw))
    return fn(jparams, jbatch(batch))


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.cache
def jax_infer(mode, idx=1):
    cfg, jspec, *_rest, jparams, _ = setup(mode)
    return jinfer(jparams, jspec, vl_inputs(), image_token_type_idx=idx)


def assert_infer_close(got, want, keys=("cls_feats", "text_feats",
                                        "image_feats", "raw_cls_feats")):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOWER_TOL, err_msg=k)


@pytest.fixture(params=["plain", "kernel twins"])
def routing(request, monkeypatch):
    """kernels=False, or the thresholds at 0 (the K1-K3 and K13 twins)."""
    if request.param == "kernel twins":
        monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
        monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    return dict(kernels=request.param != "plain")


def test_fused_index_matches_jax():
    spec = setup("ufo")[2]
    for vl_len in (None, 5, 8, 20):
        np.testing.assert_array_equal(
            relpos.text_image_relative_position_index(8, 16, 4, vl_len),
            jrelpos.text_image_relative_position_index(8, 16, 4, vl_len))
    fused = relpos.fused_index(spec)
    np.testing.assert_array_equal(fused, jrelpos.fused_index(setup("ufo")[1]))
    # the sub-blocks fused_layer_biases gathers apart
    t = spec.max_text_len
    np.testing.assert_array_equal(fused[:t, :t], relpos.text_index(spec, t))
    np.testing.assert_array_equal(fused[t:, t:], relpos.image_index(spec))


@pytest.mark.parametrize("mode", list(MODES))
def test_infer_matches_jax(mode, routing):
    *_, params = setup(mode)
    got = model.infer(params, setup(mode)[2], tbatch(vl_inputs()), **routing)
    assert_infer_close(got, jax_infer(mode))


def test_infer_second_image_token_type(routing):
    """NLVR2's second pass: token type 2, reading ``image_1``."""
    *_, spec, _, _, params = setup("ufo")
    got = model.infer(params, spec, tbatch(vl_inputs()),
                      image_token_type_idx=2, **routing)
    assert_infer_close(got, jax_infer("ufo", 2))
    torch.testing.assert_close(got["image"],
                               torch.from_numpy(vl_inputs()["image_1"]))


def test_infer_max_vl_text_len_truncation(routing):
    """max_vl_text_len=5: the collator truncates the captions, the fused
    index its text rows/cols; the split point follows from the shape."""
    cfg, jspec, spec, arrays, jparams, params = setup("ufo",
                                                      max_vl_text_len=5)
    b = {k: v[:, :5] if k.startswith("text") else v
         for k, v in vl_inputs().items()}
    assert relpos.fused_index(spec).shape == (5 + spec.image_len,) * 2
    want = jinfer(jparams, jspec, b)
    got = model.infer(params, spec, tbatch(b), **routing)
    assert_infer_close(got, want)
    bias = model.precompute_bias(params, spec, "fused")
    got = model.infer(params, spec, tbatch(b), rel_bias=bias, **routing)
    assert_infer_close(got, want)


def test_unpadded_port_matches_jax_per_segment_pad(monkeypatch):
    """At n = 8 + 257 >= 256 the JAX package under ``pallas_attention``
    pads each half to a multiple of 16 (8 -> 16, 257 -> 272; model.py:
    255-270) and slices the pad off; the port runs 265 tokens unpadded,
    its image halves and joint blocks through the K1-K3 twins."""
    cfg, jspec, spec, arrays, jparams, params = setup("ufo", image_size=256)
    b = vl_inputs(n=2, size=256)
    with pallas_attention(True):   # read while the jit traces
        want = jinfer(jparams, jspec, b)
    calls = []
    real = mome.fused_eval_block
    monkeypatch.setattr(mome, "fused_eval_block", lambda *a, **k:
                        calls.append(a[0].shape[1]) or real(*a, **k))
    got = model.infer(params, spec, tbatch(b))
    assert calls == [spec.image_len, 8 + spec.image_len]
    assert_infer_close(got, want)


# the whole-block and composed calls each mode's two blocks make, with
# the thresholds at 0, on one fused pass: (fused_eval_block rows,
# packed attention calls, K13 calls)
ROUTES = {"ufo": ([8, 17, 25], 0, 0), "all_moe": ([8, 17, 25], 0, 0),
          "attn_moe": ([8, 17, 25], 0, 0), "ffn_moe": ([8, 17, 25], 0, 0),
          "ln_moe": ([25], 1, 1), "moe_both": ([25], 2, 2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_vl_block_routes(mode, monkeypatch):
    """A split block runs its text and image halves as blocks of their
    own, each whole through the eval kernels; a block with vl experts (or
    shared ones) runs the joint sequence so; per-half experts take the
    composed path: ln_moe's shared attention and MLP once, moe's both
    attention experts over all tokens and each MLP expert over its half
    (mome.py:177-183, :201-204)."""
    monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    calls = {"fused_eval_block": [], "packed_fused_attention": [],
             "fused_mlp": []}
    for name, log in calls.items():
        real = getattr(mome, name)
        monkeypatch.setattr(mome, name, lambda *a, _l=log, _r=real, **k:
                            _l.append(a[0].shape[1]) or _r(*a, **k))
    *_, spec, _, _, params = setup(mode)
    model.infer(params, spec, tbatch(vl_inputs()))
    fused, attn, mlps = ROUTES[mode]
    assert calls["fused_eval_block"] == fused
    assert len(calls["packed_fused_attention"]) == attn
    assert len(calls["fused_mlp"]) == mlps
    assert [mome.splits(b, VL) for b in spec.blocks] == \
        [mode not in ("ln_moe", "moe_both"), False]


def test_block_takes_a_joint_bias_or_its_sub_blocks(routing):
    """A split block reads the (text, image) pair of
    ``fused_layer_biases`` or slices a (H, N, N) bias itself: the same
    numbers."""
    *_, spec, _, _, params = setup("ufo")
    b = tbatch(vl_inputs())
    pair = model.fused_layer_biases(params, spec, 8)
    joint = model.precompute_bias(params, spec, "fused")
    assert isinstance(pair[0], tuple) and pair[1].shape == joint[1].shape
    torch.testing.assert_close(pair[0][1], joint[0][:, 8:, 8:])
    torch.testing.assert_close(pair[1], joint[1])
    got = [model.infer(params, spec, b, rel_bias=bias,
                       **routing)["cls_feats"] for bias in (pair, joint)]
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)


@pytest.mark.parametrize("head", ["itm", "mlm", "mim", "vqa", "nlvr2",
                                  "img_cls"])
def test_heads_match_jax(head):
    cfg, jspec, spec, arrays, jparams, params = setup("ufo")
    width = 2 * spec.hidden_size if head == "nlvr2" else spec.hidden_size
    shape = (B, 5, width) if head in ("mlm", "mim") else (B, width)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = getattr(jmodel, f"{head}_head")(jparams, jnp.asarray(x))
    got = getattr(model, f"{head}_head")(params, torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)


def test_vl_grams_match_jax():
    """An all_moe NLVR2 gram pass (the eval-mode paired pass,
    ``compute_losses(train=False)``) taps the JAX package's modules, the
    vl experts of the deep block included, with the same number of calls,
    and its f64 grams agree within GRAM_RTOL of the largest entry."""
    cfg, jspec, spec, arrays, jparams, params = setup("all_moe",
                                                      losses=("nlvr2",))
    b = vl_inputs()
    b["answers"] = np.array([0, 1, 1], np.int32)
    want = jgram.cache_gram_matrices(jparams, jspec, cfg, [jbatch(b)])
    got = gram.cache_gram_matrices(params, spec, cfg, [tbatch(b)])
    assert set(got) == set(want)
    assert {k for k in got if ".vl" in k} == {
        f"transformer.blocks.1.{m}" for m in (
            "attn.vl", "attn.vl.proj", "mlp.vl.fc1", "mlp.vl.fc2")}
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAM_RTOL * np.abs(w).max(), k
    acts = gram.make_capture_step(cfg, spec)(params, tbatch(b))
    jacts = jgram.make_capture_step(cfg, jspec)(jparams, jbatch(b),
                                                jax.random.PRNGKey(0))
    assert {k: len(v) for k, v in acts.items()} == \
        {k: len(v) for k, v in jacts.items()}
