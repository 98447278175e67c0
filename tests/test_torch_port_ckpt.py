"""The port's checkpoint I/O, surgery, bicubic resize and ingest pipeline
against the JAX package, on the CPU.

Checkpoints are written inside each test (``torch.save`` of a Lightning
envelope, or a plain dict); both packages read them and must return
dicts equal bit for bit, and every surgery path (vlmo, beit with a
shared or per-layer table, self, the expert renames and clones, the
fc_norm rename, the absolute position-embedding resize) gives the JAX
package's dict bit for bit.  ``load_params`` overlays the same values
and reports the same missing and unexpected keys.
"""

import numpy as np
import pytest
import torch

from vl_merging_tpu.ckpt import bicubic as jbicubic
from vl_merging_tpu.ckpt import io as jio
from vl_merging_tpu.ckpt import pipeline as jpipeline
from vl_merging_tpu.ckpt import surgery as jsurgery
from vl_merging_tpu.config import build_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu_torch.ckpt import bicubic, io, pipeline, surgery
from vl_merging_tpu_torch.models.spec import make_model_spec
from test_torch_port_merging import assert_dicts_equal
from torch_port_threads import one_torch_thread  # noqa: F401

TINY = dict(num_layers=2, hidden_size=32, num_heads=2, image_size=32,
            max_text_len=8, max_text_len_of_initckpt=16,
            vlffn_start_layer_index=1, precision="f32")
TASK = "task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl"


def schema_arrays(cfg, seed=0):
    """A seeded numpy dict over the JAX schema of ``cfg``."""
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*shape), np.float32)
            for k, shape in jparam_shapes(jmake_spec(cfg)).items()}


@pytest.mark.parametrize("envelope", [True, False])
def test_checkpoint_io_matches_jax(tmp_path, envelope):
    """A checkpoint written by torch.save (Lightning envelope or plain),
    with f32, f64, int and 0-d entries, reads back equal in both
    packages; each package's writer keeps scalars 0-d, and the port's
    file reads back equal in the JAX reader and vice versa."""
    rng = np.random.RandomState(0)
    sd = {"a.weight": rng.randn(3, 4).astype(np.float32),
          "b.gram": rng.randn(4, 4),
          "c.index": np.arange(6, dtype=np.int64).reshape(2, 3),
          "logit_scale": np.asarray(2.5, np.float32)}
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = str(tmp_path / "in.ckpt")
    torch.save({"state_dict": tensors, "epoch": 3} if envelope else tensors,
               path)
    got, want = io.load_torch_checkpoint(path), jio.load_torch_checkpoint(path)
    assert_dicts_equal(got, want)
    assert_dicts_equal(got, sd)
    for save, load, name in ((io.save_torch_checkpoint,
                              jio.load_torch_checkpoint, "port"),
                             (jio.save_torch_checkpoint,
                              io.load_torch_checkpoint, "jax")):
        out = str(tmp_path / name / "out.ckpt")
        save(sd, out, lightning_envelope=envelope)
        raw = torch.load(out, weights_only=False)
        assert ("state_dict" in raw) == envelope
        assert (raw["state_dict"] if envelope else raw)[
            "logit_scale"].shape == ()
        assert_dicts_equal(load(out), sd)


def test_state_dict_to_params_matches_jax():
    """Non-strict mapping: equal params, the same missing and unexpected
    keys, a (1,) scalar made 0-d, a shape mismatch raised."""
    cfg = build_config(TASK, "ufo", overrides=TINY)
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    sd = schema_arrays(cfg)
    sd.pop("pooler.dense.weight")
    sd["garbage.key"] = np.zeros(3, np.float32)
    sd["logit_scale"] = np.asarray([2.5], np.float32)
    sd["transformer.norm.bias"] = sd["transformer.norm.bias"].astype(
        np.float64)
    params, missing, unexpected = io.state_dict_to_params(sd, spec)
    jparams, jmissing, junexpected = jio.state_dict_to_params(sd, jspec)
    assert missing == jmissing == ["pooler.dense.weight"]
    assert unexpected == junexpected == ["garbage.key"]
    assert all(v.dtype == torch.float32 for v in params.values())
    assert params["logit_scale"].shape == ()
    assert_dicts_equal(io.params_to_state_dict(params),
                       jio.params_to_state_dict(jparams))
    sd["transformer.norm.weight"] = np.zeros(5, np.float32)
    for fn, s in ((io.state_dict_to_params, spec),
                  (jio.state_dict_to_params, jspec)):
        with pytest.raises(ValueError, match="shape mismatch"):
            fn(sd, s)
    bf16 = io.params_to_state_dict(
        {"w": torch.ones(2, 2, dtype=torch.bfloat16)})
    assert bf16["w"].dtype == np.float32


@pytest.mark.parametrize("shape", [(4, 27, 27, 47, 47), (4, 47, 47, 27, 27),
                                   (4, 5, 7, 13, 11), (23, 23, 24, 24)])
def test_bicubic_is_bit_equal_to_jax(shape):
    x = np.random.RandomState(0).randn(*shape[:-2]).astype(np.float32)
    got = bicubic.bicubic_resize(x, shape[-2:])
    want = jbicubic.bicubic_resize(x, shape[-2:])
    assert_dicts_equal({"x": got}, {"x": want})


def _vlmo_case():
    text_rel = 2 * 16
    rows = lambda w: (2 * w - 1) ** 2 + 3 + text_rel + 2   # noqa: E731
    rng = np.random.RandomState(0)
    sd = {"relative_position_bias_table": rng.randn(rows(14), 6).astype(
              np.float32),
          "text_embeddings.position_embeddings.weight": rng.randn(
              40, 8).astype(np.float32),
          "text_embeddings.position_ids": np.arange(40)[None],
          "relative_position_index": np.zeros((5, 5)),
          "text_imag_relative_position_index": np.zeros((3, 3))}
    return "modify_checkpoint_vlmo", sd, dict(
        max_text_len=24, text_num_relative_distance=text_rel,
        target_table_rows=rows(24))


def _beit_sd(per_layer: bool, layers=2, heads=2, hs=8, window=3, seed=0,
             text_rows=16):
    rng = np.random.RandomState(seed)
    src_rows = (2 * window - 1) ** 2 + 3
    sd = {}
    for i in range(layers):
        p = f"transformer.blocks.{i}"
        for k, shape in ((f"{p}.attn.qkv.weight", (3 * hs, hs)),
                         (f"{p}.attn.q_bias", (hs,)),
                         (f"{p}.attn.v_bias", (hs,)),
                         (f"{p}.attn.proj.weight", (hs, hs)),
                         (f"{p}.mlp.fc1.weight", (4 * hs, hs)),
                         (f"{p}.mlp.fc2.bias", (hs,)),
                         (f"{p}.norm1.weight", (hs,)),
                         (f"{p}.norm2.bias", (hs,)),
                         (f"{p}.gamma_1", (hs,))):
            sd[k] = rng.randn(*shape).astype(np.float32)
        if per_layer:
            sd[f"{p}.attn.relative_position_bias_table"] = rng.randn(
                src_rows, heads).astype(np.float32)
            sd[f"{p}.attn.relative_position_index"] = np.zeros((4, 4))
    if not per_layer:
        sd["transformer.rel_pos_bias.relative_position_bias_table"] = \
            rng.randn(src_rows, heads).astype(np.float32)
        sd["transformer.rel_pos_bias.relative_position_index"] = np.zeros(
            (4, 4))
    sd["transformer.fc_norm.weight"] = rng.randn(hs).astype(np.float32)
    sd["transformer.fc_norm.bias"] = rng.randn(hs).astype(np.float32)
    sd["text_embeddings.position_embeddings.weight"] = rng.randn(
        text_rows, hs).astype(np.float32)
    return sd


def _target(window=4, heads=2, layers=2, text_rel=16):
    rows = (2 * window - 1) ** 2 + 3 + text_rel + 2
    return np.random.RandomState(5).randn(rows, heads * layers).astype(
        np.float32)


SURGERY_CASES = {
    "vlmo": _vlmo_case(),
    "beit-shared": ("modify_checkpoint_beit", _beit_sd(False), dict(
        num_layers=2, target_table=_target(), text_num_relative_distance=16,
        use_moe=True, moe_in_attn=True, custom_ln_attn=True,
        custom_ln_ffn=True, use_vision_weights_for_other_modalities=True,
        vlffn_start_layer_index=1)),
    "beit-per-layer": ("modify_checkpoint_beit", _beit_sd(True), dict(
        num_layers=2, target_table=_target(), text_num_relative_distance=16,
        use_moe=True)),
    "self": ("modify_checkpoint_self", _beit_sd(True), dict(
        max_text_len=8, num_layers=2, target_table=_target(),
        text_num_relative_distance=16)),
    "insert-expert-names": ("insert_expert_names", _beit_sd(False), dict(
        moe_in_ffn=True, moe_in_attn=True, custom_ln_attn=True,
        custom_ln_ffn=True)),
    "clone-vision-weights": ("clone_vision_weights", jsurgery.
                             insert_expert_names(_beit_sd(False),
                                                 moe_in_ffn=True,
                                                 moe_in_attn=True),
                             dict(vlffn_start_layer_index=1)),
}


@pytest.mark.parametrize("case", sorted(SURGERY_CASES))
def test_surgery_is_bit_equal_to_jax(case):
    fn, sd, kw = SURGERY_CASES[case]
    got = getattr(surgery, fn)(dict(sd), **kw)
    want = getattr(jsurgery, fn)(dict(sd), **kw)
    assert_dicts_equal(got, want)


def test_in_place_surgery_and_pos_embed_are_bit_equal_to_jax():
    """import_beit_bias_table and rename_fc_norm work in place;
    interpolate_pos_embed resizes an absolute position embedding."""
    for per_layer in (False, True):
        got, want = _beit_sd(per_layer), _beit_sd(per_layer)
        kw = dict(num_layers=2, target_table=_target(),
                  text_num_relative_distance=16)
        surgery.import_beit_bias_table(got, **kw)
        jsurgery.import_beit_bias_table(want, **kw)
        surgery.rename_fc_norm(got)
        jsurgery.rename_fc_norm(want)
        assert_dicts_equal(got, want)
    pe = np.random.RandomState(2).randn(1, 1 + 14 * 14, 8).astype(np.float32)
    for dst in (24 * 24, 14 * 14):
        assert_dicts_equal({"pe": surgery.interpolate_pos_embed(pe, dst)},
                           {"pe": jsurgery.interpolate_pos_embed(pe, dst)})


PIPELINE_CASES = {
    # an all_moe checkpoint merged into a ufo model (training ingest:
    # vlmo surgery, then merge_weights)
    "moe-merge-into-ufo": ("all_moe", "ufo", dict(
        merge_weights=True, merge_ratio=0.5)),
    # the eval ingest skips the vlmo surgery
    "moe-test-only": ("all_moe", "all_moe", dict(test_only=True)),
    # a BEiT image-only checkpoint into all_moe (the pretraining init)
    "beit-into-moe": ("beit", "all_moe", dict(
        use_beit_weight=True, use_vision_weights_for_other_modalities=True)),
    # NLVR2 from a 2-type checkpoint: token types expanded to 3 rows
    "nlvr2-token-types": ("ufo", "ufo", dict(
        loss_names={"nlvr2": 1}, vlffn_start_layer_index=1)),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_load_params_matches_jax(tmp_path, case):
    """The same checkpoint through both pipelines: the same missing and
    unexpected keys, every loaded param equal bit for bit."""
    src, dst, over = PIPELINE_CASES[case]
    if src == "beit":
        sd = _beit_sd(False, hs=32, window=2, text_rows=8)
    else:
        sd = schema_arrays(build_config(TASK, src, overrides=TINY))
    path = str(tmp_path / "src.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    cfg = build_config(TASK, dst, overrides=dict(TINY, load_path=path,
                                                   **over))
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    params, missing, unexpected = pipeline.load_params(cfg, spec)
    jparams, jmissing, junexpected = jpipeline.load_params(cfg, jspec)
    assert missing == jmissing and unexpected == junexpected
    loaded = [k for k in params if k not in missing]
    assert loaded
    assert_dicts_equal({k: params[k].numpy() for k in loaded},
                       {k: np.asarray(jparams[k]) for k in loaded})
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        jparam_shapes(jspec)
    if case == "nlvr2-token-types":
        tt = params["token_type_embeddings.weight"].numpy()
        assert tt.shape[0] == 3 and np.array_equal(tt[2], tt[1])
    again, _, _ = pipeline.load_params(cfg, spec)
    assert all(torch.equal(params[k], again[k]) for k in params)
