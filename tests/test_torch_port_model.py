"""The port's model slice against the JAX package, on the CPU in f32.

A tiny ufo spec (hidden 128, 2 heads of dim 64, 2 layers, 64px images in
16px patches, 8 text tokens) gets one random numpy param dict, with a
non-zero rel-pos bias table and random biases and LayerScales; both
packages run it.  The image and text towers must agree to atol 2e-5, rtol 1e-4, and the
retrieval eval must return the identical recall dict.  Each tower runs
twice in the port: on its default routing (17 image tokens, below the
kernel threshold: the plain path) and with the threshold at 0, so every
block goes through the fused route's K1 → K2 → K3 twins.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu.config import build_config
from vl_merging_tpu.evaluation import retrieval as jretrieval
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.models import relpos as jrelpos
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    params_from_numpy
from vl_merging_tpu_torch.evaluation import retrieval
from vl_merging_tpu_torch.models import mome, model, relpos
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec, \
    param_shapes

TOWER_TOL = dict(atol=2e-5, rtol=1e-4)
N_IMG, CAPS = 8, 5


def tiny_cfg(*modes, precision="f32"):
    return build_config(*modes, overrides=dict(
        hidden_size=128, num_heads=2, num_layers=2, image_size=64,
        patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
        vlffn_start_layer_index=1, precision=precision,
        loss_names={"irtr": 1}))


def random_arrays(jspec, seed):
    """A numpy param dict for ``jspec``: unit-scale rel-pos table, LN
    scales near 1, random biases and LayerScales, 0.02-scale weights."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in jparam_shapes(jspec).items():
        v = rng.randn(*shape)
        if k == "relative_position_bias_table":
            pass
        elif len(shape) == 1:
            v = 0.1 * v + (1.0 if "norm" in k.lower() and
                           k.endswith(".weight") else 0.0)
        else:
            v = 0.02 * v
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def tiny():
    """(JAX spec, port spec, numpy params, JAX params, port params)."""
    cfg = tiny_cfg("ufo")
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jspec, spec, arrays, jparams, params_from_numpy(arrays, "cpu")


@pytest.fixture(params=["default", "fused"])
def routing(request, monkeypatch):
    if request.param == "fused":
        monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
    return request.param


def _inputs():
    rng = np.random.RandomState(1)
    images = rng.randn(N_IMG, 3, 64, 64).astype(np.float32)
    text_ids = rng.randint(0, 30522, (N_IMG * CAPS, 8)).astype(np.int32)
    text_masks = np.ones((N_IMG * CAPS, 8), np.int32)
    lengths = rng.randint(3, 9, N_IMG * CAPS)
    for i, n in enumerate(lengths):
        text_masks[i, n:] = 0
    return images, text_ids, text_masks


def test_spec_and_param_shapes_match_jax():
    for modes in (("ufo",), ("all_moe",), ()):
        cfg = tiny_cfg(*modes)
        jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
        assert [dataclasses.asdict(b) for b in spec.blocks] == \
            [dataclasses.asdict(b) for b in jspec.blocks]
        assert {f.name: getattr(spec, f.name)
                for f in dataclasses.fields(spec) if f.name != "blocks"} == \
            {f.name: getattr(jspec, f.name)
             for f in dataclasses.fields(jspec) if f.name != "blocks"}
        assert param_shapes(spec) == jparam_shapes(jspec)


def test_init_params_distributions():
    cfg = tiny_cfg("ufo")
    spec = make_model_spec(cfg)
    p = init_params(spec, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        jparam_shapes(jmake_spec(cfg))
    assert all(v.dtype == torch.float32 for v in p.values())
    assert (p["transformer.blocks.0.gamma_1"] == 0.1).all()
    assert (p["relative_position_bias_table"] == 0).all()
    assert (p["transformer.blocks.1.norm1.weight"] == 1).all()
    assert (p["transformer.blocks.1.attn.q_bias"] == 0).all()
    # trunc_normal(0.02) at ±2σ, then the BEiT depth rescale of fc weights
    qkv = p["transformer.blocks.1.attn.qkv.weight"]
    assert qkv.abs().max() <= 0.04 and 0.015 < qkv.std() < 0.02
    fc1 = p["transformer.blocks.1.mlp.fc1.weight"]
    assert fc1.abs().max() <= 0.04 / 2.0 + 1e-7
    torch.testing.assert_close(
        p["logit_scale"], torch.tensor(float(np.log(1 / 0.07))))
    again = init_params(spec, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_relpos_indices_and_bias_match_jax(tiny):
    jspec, spec, arrays, jparams, params = tiny
    for window in (4, 24):
        np.testing.assert_array_equal(
            relpos.image_relative_position_index(window),
            jrelpos.image_relative_position_index(window))
    np.testing.assert_array_equal(
        relpos.text_relative_position_index(40, 196, 24),
        jrelpos.text_relative_position_index(40, 196, 24))
    for kind in ("image", "text"):
        got = model.precompute_bias(params, spec, kind)
        want = jmodel.precompute_bias(jparams, jspec, kind)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_from_numpy_and_eval_cast():
    arrays = {"a.weight": np.ones((2, 3), np.float32),
              "b": np.arange(4, dtype=np.int32),
              "c.weight": np.asarray(jnp.ones((2, 2), jnp.bfloat16))}
    p = params_from_numpy(arrays, "cpu")
    assert p["a.weight"].dtype == torch.float32
    assert p["b"].dtype == torch.int32 and p["b"].tolist() == [0, 1, 2, 3]
    assert p["c.weight"].dtype == torch.bfloat16
    assert params_from_numpy(arrays, "cpu", torch.bfloat16)["b"].dtype == \
        torch.int32

    cfg = tiny_cfg("ufo", precision="bf16")
    spec = make_model_spec(cfg)
    cast = eval_cast_params(init_params(spec), spec, cfg)
    for k, v in cast.items():
        keep = (v.ndim < 2 or "bias_table" in k or not k.endswith(".weight")
                or k.startswith("text_embeddings."))
        assert v.dtype == (torch.float32 if keep else torch.bfloat16), k
    int8_cfg = tiny_cfg("ufo", precision="bf16")
    int8_cfg["eval_int8"] = True
    with pytest.raises(NotImplementedError, match="A5"):
        eval_cast_params({}, make_model_spec(int8_cfg), int8_cfg)


def test_image_tower_matches_jax(tiny, routing):
    jspec, spec, arrays, jparams, params = tiny
    images = _inputs()[0]
    want = jmodel.infer_image_ft(jparams, jspec, {"image": jnp.asarray(images)})
    got = model.infer_image_ft(params, spec,
                               {"image": torch.from_numpy(images)})
    for key in ("cls_feats", "image_feats", "raw_cls_feats"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOWER_TOL, err_msg=key)


def test_moe_expert_towers_match_jax(monkeypatch):
    """all_moe: type-V and type-L sequences take their own attention,
    MLP and LN experts, on both routes."""
    cfg = tiny_cfg("all_moe")
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 2)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    params = params_from_numpy(arrays, "cpu")
    images, text_ids, text_masks = _inputs()
    want_i = jmodel.infer_image_ft(jparams, jspec,
                                   {"image": jnp.asarray(images[:2])})
    want_t = jmodel.infer_text_ft(jparams, jspec, {
        "text_ids": jnp.asarray(text_ids[:4]),
        "text_masks": jnp.asarray(text_masks[:4])})
    for min_n in (mome.KERNEL_MIN_N, 0):
        monkeypatch.setattr(mome, "KERNEL_MIN_N", min_n)
        got_i = model.infer_image_ft(params, spec,
                                     {"image": torch.from_numpy(images[:2])})
        got_t = model.infer_text_ft(params, spec, {
            "text_ids": torch.from_numpy(text_ids[:4]),
            "text_masks": torch.from_numpy(text_masks[:4])})
        np.testing.assert_allclose(got_i["cls_feats"].numpy(),
                                   np.asarray(want_i["cls_feats"]),
                                   **TOWER_TOL)
        np.testing.assert_allclose(got_t["cls_feats"].numpy(),
                                   np.asarray(want_t["cls_feats"]),
                                   **TOWER_TOL)


def test_text_tower_matches_jax(tiny, routing):
    jspec, spec, arrays, jparams, params = tiny
    _, text_ids, text_masks = _inputs()
    want = jmodel.infer_text_ft(jparams, jspec, {
        "text_ids": jnp.asarray(text_ids),
        "text_masks": jnp.asarray(text_masks)})
    got = model.infer_text_ft(params, spec, {
        "text_ids": torch.from_numpy(text_ids),
        "text_masks": torch.from_numpy(text_masks)})
    for key in ("cls_feats", "text_feats", "raw_cls_feats"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOWER_TOL, err_msg=key)


def test_compute_irtr_recall_matches_jax(tiny, routing):
    jspec, spec, arrays, jparams, params = tiny
    images, text_ids, text_masks = _inputs()
    tiids = np.repeat(np.arange(N_IMG), CAPS)
    iids = np.arange(N_IMG)
    half = N_IMG * CAPS // 2
    jtext = [{"text_ids": jnp.asarray(text_ids[s]),
              "text_masks": jnp.asarray(text_masks[s])}
             for s in (slice(0, half), slice(half, None))]
    ttext = [{"text_ids": torch.from_numpy(text_ids[s]),
              "text_masks": torch.from_numpy(text_masks[s])}
             for s in (slice(0, half), slice(half, None))]
    want = jretrieval.compute_irtr_recall(
        jparams, jspec, jtext, [{"image": jnp.asarray(images)}], tiids, iids)
    got = retrieval.compute_irtr_recall(
        params, spec, ttext, [{"image": torch.from_numpy(images)}], tiids,
        iids)
    assert got == want
    with pytest.raises(NotImplementedError, match="A4"):
        retrieval.compute_irtr_recall(
            params, spec, ttext, [{"image": torch.from_numpy(images)}],
            tiids, iids, itm_rerank_topk=5)


def test_recall_ties_break_like_jax_top_k():
    scores = np.array([[1.0, 1.0, 1.0, 0.5], [0.2, 0.9, 0.9, 0.9]],
                      np.float32)
    iids, tiids = np.array([0, 1]), np.array([0, 1, 1, 0])
    want = jretrieval._topk_ids(jnp.asarray(scores), jnp.asarray(iids),
                                jnp.asarray(tiids), ks=(1, 2))
    got = retrieval._topk_ids(torch.from_numpy(scores),
                              torch.from_numpy(iids), torch.from_numpy(tiids),
                              ks=(1, 2))
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def test_fused_route_runs_the_kernel_twins(tiny, monkeypatch):
    """With the threshold at 0 every image block takes _block_fast."""
    jspec, spec, arrays, jparams, params = tiny
    calls = []
    real = mome._block_fast

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(mome, "_block_fast", spy)
    monkeypatch.setattr(mome, "KERNEL_MIN_N", 0)
    model.infer_image_ft(params, spec,
                         {"image": torch.from_numpy(_inputs()[0])})
    assert calls == [True] * spec.num_layers
    calls.clear()
    model.infer_image_ft(params, spec,
                         {"image": torch.from_numpy(_inputs()[0])},
                         kernels=False)
    assert calls == [False] * spec.num_layers


def test_text_mlp_takes_the_mlp_kernel(tiny, monkeypatch):
    """The eval text tower's blocks decline the fused block (N < 256) but
    send their MLP through K13 (on the CPU: its twin) once a block has
    MLP_MIN_ROWS rows, as the JAX eval's fused_mlp does under its Pallas
    flag (ops/mlp.py:209-225); kernels=False keeps the plain MLP."""
    from vl_merging_tpu_torch.ops import mlp as TM

    jspec, spec, arrays, jparams, params = tiny
    _, text_ids, text_masks = _inputs()
    calls = []
    real = TM.mlp_kernel_reference
    monkeypatch.setattr(TM, "mlp_kernel_reference",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    batch = {"text_ids": torch.from_numpy(text_ids),
             "text_masks": torch.from_numpy(text_masks)}
    assert text_ids.size >= mome.MLP_MIN_ROWS
    model.infer_text_ft(params, spec, batch)
    assert calls == [text_ids.shape + (128,)] * spec.num_layers
    calls.clear()
    model.infer_text_ft(params, spec, batch, kernels=False)
    small = {k: v[:mome.MLP_MIN_ROWS // 8 - 1] for k, v in batch.items()}
    model.infer_text_ft(params, spec, small)
    assert calls == []


def test_vl_block_is_not_ported(tiny):
    jspec, spec, arrays, jparams, params = tiny
    x = torch.zeros(1, spec.max_text_len + spec.image_len, 128)
    with pytest.raises(NotImplementedError, match="A4"):
        mome.block_forward(params, spec, spec.blocks[0], x, None, None, 2)
