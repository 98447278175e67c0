"""The port's merging suite against the JAX package, on the CPU.

Host merging (``merging/core.py``): merge_weights, sum_task_vectors and
regmean give dicts equal bit for bit to the JAX package's on the same
seeded state dicts, fallbacks and quirks included.  Device merging
(``merging/device.py``) on CPU tensors: each fleet member within 4 f32 ulp
at operand scale of the JAX device path and of the port's host path
(the pin of ``tests/test_merging_device.py``); regmean_device within the
JAX pin's relative drift of 5e-5 of the host f64 regmean.  The CLIs:
``merge.py`` and ``convert.py`` write the checkpoints the JAX CLIs write.
The whole flow, merge → ``load_params`` → ``compute_irtr_recall``, holds
the port's features to the JAX flow's at the port's f32 tower tolerance
and its recall equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_merging import (HS, MLP, N_LAYERS, VLFFN_START, make_expert_state,
                          make_merged_state)
from vl_merging_tpu import convert as jconvert
from vl_merging_tpu import merge as jmerge
from vl_merging_tpu.ckpt import pipeline as jpipeline
from vl_merging_tpu.config import build_config
from vl_merging_tpu.evaluation import retrieval as jretrieval
from vl_merging_tpu.merging import core as jcore
from vl_merging_tpu.merging import device as jdevice
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu_torch import convert, merge
from vl_merging_tpu_torch.ckpt import io, pipeline
from vl_merging_tpu_torch.ckpt.convert import params_from_numpy
from vl_merging_tpu_torch.evaluation import retrieval
from vl_merging_tpu_torch.merging import core, device
from vl_merging_tpu_torch.models.spec import make_model_spec
from torch_port_threads import one_torch_thread  # noqa: F401

KW = dict(num_layers=N_LAYERS, vlffn_start_layer_index=VLFFN_START)
PRETRAIN = {"mlm": 1, "itm": 1, "ifm": 1}
TOWER_TOL = dict(atol=2e-5, rtol=1e-4)   # the port's f32 tower tolerance


def assert_dicts_equal(got, want):
    """Same keys, and each array equal bit for bit in the same dtype."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(np.ascontiguousarray(g).reshape(-1).view(
            np.uint8), np.ascontiguousarray(w).reshape(-1).view(np.uint8)), k


def make_grams(seed=7, experts=None):
    rng = np.random.RandomState(seed)
    grams = {}
    for i in range(N_LAYERS):
        tasks = ["v", "l"] if i < VLFFN_START else ["v", "l", "vl"]
        p = f"transformer.blocks.{i}"
        for t in experts or tasks:
            for mod, d in [(f"attn.{t}", HS), (f"attn.{t}.proj", HS),
                           (f"mlp.{t}.fc1", HS), (f"mlp.{t}.fc2", MLP)]:
                X = rng.randn(64, d)
                grams[f"{p}.{mod}"] = (X.T @ X).astype(np.float64)
    return grams


def _missing_expert():
    """A state dict missing the l fc1 of the last layer, with the merged
    keys beside it as the fallback source."""
    sd = make_expert_state(seed=0)
    del sd[f"transformer.blocks.{N_LAYERS - 1}.mlp.l.fc1.weight"]
    sd.update(make_merged_state(seed=9))
    return sd


def _host_cases():
    sd = make_expert_state(seed=0)
    central = make_merged_state(seed=1)
    grams = make_grams()
    only_v = make_grams(seed=3, experts=["v"])
    cases = {}
    for loss in (PRETRAIN, {"irtr": 1}, {"vqa": 1}, {"nlvr2": 1}):
        for used in (False, True):
            cases[f"interp-{next(iter(loss))}-{used}"] = (
                "merge_weights", sd, dict(loss_names=loss, merge_ratio=0.3,
                                          only_activate_used_experts=used))
    # tests/test_merging.py:147: no expert key, the merged weight is kept
    cases["interp-fallback"] = ("merge_weights", make_merged_state(),
                                dict(loss_names={"itm": 1}, merge_ratio=0.25))
    cases["interp-missing-expert"] = ("merge_weights", _missing_expert(),
                                      dict(loss_names=PRETRAIN))
    for lam in (1.0, 0.75):
        cases[f"task-vectors-{lam}"] = (
            "sum_task_vectors", sd, dict(central=central, loss_names=PRETRAIN,
                                         sum_lambda=lam))
    cases["task-vectors-irtr-used"] = (
        "sum_task_vectors", sd, dict(central=central, loss_names={"irtr": 1},
                                     sum_lambda=0.5,
                                     only_activate_used_experts=True))
    for loss in ({"itm": 1}, {"irtr": 1}, {"vqa": 1}):
        cases[f"regmean-{next(iter(loss))}"] = (
            "regmean", sd, dict(gram_matrices=grams, loss_names=loss,
                                scaling_for_non_diag=0.9))
    # tests/test_merging.py:233: an expert without a gram is skipped
    cases["regmean-missing-gram"] = (
        "regmean", sd, dict(gram_matrices=only_v, loss_names={"itm": 1}))
    # the partial-gram fallback (core.py:241-248) and the count surviving
    # the break of avg_merge (core.py:266-270): an expert key missing after
    # a summed gram / an averaged expert
    cases["regmean-partial-gram-fallback"] = (
        "regmean", _missing_expert(), dict(gram_matrices=grams,
                                           loss_names={"itm": 1}))
    sd_nb = dict(_missing_expert())   # the fallback divided by 2 (v, l)
    del sd_nb[f"transformer.blocks.{N_LAYERS - 1}.mlp.vl.fc1.bias"]
    del sd_nb[f"transformer.blocks.{N_LAYERS - 1}.norm1.vl.weight"]
    cases["regmean-avg-count-after-break"] = (
        "regmean", sd_nb, dict(gram_matrices=grams, loss_names={"itm": 1}))
    return cases


HOST_CASES = _host_cases()


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_merging_is_bit_equal_to_jax(case):
    fn, sd, kw = HOST_CASES[case]
    kw = dict(kw)
    # the central checkpoint or the grams: the second positional argument
    extra = [kw.pop(k) for k in ("central", "gram_matrices") if k in kw]
    want = getattr(jcore, fn)(sd, *[dict(a) for a in extra], **kw, **KW)
    got = getattr(core, fn)(sd, *[dict(a) for a in extra], **kw, **KW)
    assert_dicts_equal(got, want)


def test_merging_tables_match_jax():
    """The key templates, the expert-set rule and the gram scaling."""
    assert core.LAYER_ORDERS == jcore.LAYER_ORDERS
    for i in range(N_LAYERS):
        for loss in (PRETRAIN, {"irtr": 1}, {"vqa": 1}, {"nlvr2": 1}):
            for used in (False, True):
                assert core.modalities_for_layer(i, VLFFN_START, loss, used) \
                    == jcore.modalities_for_layer(i, VLFFN_START, loss, used)
    G = make_grams()["transformer.blocks.0.attn.v"]
    assert_dicts_equal({"g": core.scale_gram(G, 0.9)},
                       {"g": jcore.scale_gram(G, 0.9)})


def _within_4_ulp(got, host, label):
    """≤ 4 ulp at the key's operand scale (tests/test_merging_device.py)."""
    h = np.asarray(host)
    tol = 4 * np.spacing(np.float32(max(np.abs(h).max(), 1.0)))
    err = np.abs(np.asarray(got, np.float64) - h).max()
    assert err <= tol, f"{label}: max |Δ| {err} > {tol}"


def _fleet_numpy(fleet):
    return {k: v.numpy() for k, v in fleet.items()}


def _device_cases():
    sds = [make_expert_state(seed=s) for s in range(3)]
    central = make_merged_state(seed=7)
    miss = _missing_expert()
    cases = {}
    for loss, used in ((PRETRAIN, False), ({"vqa": 1}, True),
                       ({"irtr": 1}, True), ({"nlvr2": 1}, True)):
        cases[f"merge-{next(iter(loss))}"] = (
            "merge_weights", sds, None,
            dict(loss_names=loss, merge_ratio=0.3,
                 only_activate_used_experts=used))
    cases["merge-fallback"] = ("merge_weights", [miss, miss], None,
                               dict(loss_names=PRETRAIN))
    for lam in (1.0, 0.4):
        cases[f"task-vectors-{lam}"] = (
            "sum_task_vectors", sds[:2], central,
            dict(loss_names=PRETRAIN, sum_lambda=lam))
    cases["ratio-sweep"] = ("ratio_sweep", sds[:1], None,
                            dict(loss_names=PRETRAIN))
    return cases


DEVICE_CASES = _device_cases()
SWEEP = [0.0, 0.25, 0.5, 0.75, 1.0]


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_merging_on_cpu_within_4_ulp(case):
    """Each fleet member within 4 ulp of the port's host path and of the
    JAX device path."""
    fn, sds, central, kw = DEVICE_CASES[case]
    if fn == "ratio_sweep":
        got = device.ratio_sweep(sds[0], SWEEP, device="cpu", **kw, **KW)
        jgot = jdevice.ratio_sweep(sds[0], SWEEP, **kw, **KW)
        host = [core.merge_weights(sds[0], merge_ratio=r, **kw, **KW)
                for r in SWEEP]
    elif fn == "merge_weights":
        got = device.merge_weights_device(
            device.stack_checkpoints(sds, "cpu"), **kw, **KW)
        jgot = jdevice.merge_weights_device(jdevice.stack_checkpoints(sds),
                                            **kw, **KW)
        host = [core.merge_weights(sd, **kw, **KW) for sd in sds]
    else:
        cfleet = [central] * len(sds)
        got = device.sum_task_vectors_device(
            device.stack_checkpoints(sds, "cpu"),
            device.stack_checkpoints(cfleet, "cpu"), **kw, **KW)
        jgot = jdevice.sum_task_vectors_device(
            jdevice.stack_checkpoints(sds), jdevice.stack_checkpoints(cfleet),
            **kw, **KW)
        host = [core.sum_task_vectors(sd, dict(central), **kw, **KW)
                for sd in sds]
    got = _fleet_numpy(got)
    assert set(got) == set(host[0]) == set(jgot)
    for k in got:
        for j, h in enumerate(host):
            _within_4_ulp(got[k][j], h[k], f"{case} member {j} {k} (host)")
            _within_4_ulp(got[k][j], np.asarray(jgot[k])[j],
                          f"{case} member {j} {k} (JAX device path)")


@pytest.mark.parametrize("drop", [None, "transformer.blocks.0.mlp.v.fc2"])
def test_regmean_device_on_cpu_matches_host(drop):
    """regmean_device (f32 solve) against the host f64 regmean: relative
    drift < 5e-5 (the JAX pin); a dropped gram skips its expert."""
    sd = make_expert_state(seed=0)
    grams = make_grams()
    if drop:
        del grams[drop]
    host = core.regmean(sd, grams, loss_names={"itm": 1},
                        scaling_for_non_diag=0.9, **KW)
    got = device.regmean_device(
        device.stack_checkpoints([sd, sd], "cpu"),
        {k: torch.from_numpy(v).float() for k, v in grams.items()},
        loss_names={"itm": 1}, scaling_for_non_diag=0.9, **KW)
    assert set(got) == set(host)
    for k, h in host.items():
        for j in range(2):
            rel = np.abs(got[k][j].double().numpy() - h).max() / max(
                np.abs(h).max(), 1.0)
            assert rel < 5e-5, f"{k}: rel drift {rel}"


def test_stack_checkpoints_rejects_key_mismatch():
    a, b = make_expert_state(seed=0), make_expert_state(seed=1)
    del b["transformer.norm.weight"]
    with pytest.raises(ValueError, match="transformer.norm.weight"):
        device.stack_checkpoints([a, b], "cpu")
    fleet = device.stack_checkpoints([a, a], "cpu")
    assert fleet["transformer.norm.weight"].shape == (2, HS)


CLI_SHAPE = [f"num_layers={N_LAYERS}", "hidden_size=16", "num_heads=2",
             "image_size=32", "patch_size=16",
             f"vlffn_start_layer_index={VLFFN_START}"]


@pytest.mark.parametrize("method", ["merge_weights", "sum_task_vectors",
                                    "regmean"])
def test_merge_cli_writes_the_jax_checkpoint(tmp_path, method):
    sd = make_expert_state()
    path = str(tmp_path / "ms.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    extra = {"merge_weights": ["merge_weights=True", "merge_ratio=0.3"],
             "sum_task_vectors": ["sum_task_vectors=True", "sum_lambda=0.5"],
             "regmean": ["regmean=True", "scaling_for_non_diag=0.9"]}[method]
    if method == "sum_task_vectors":
        central = str(tmp_path / "central.ckpt")
        io.save_torch_checkpoint(make_merged_state(), central)
        extra.append(f"central_weight={central!r}")
    if method == "regmean":
        grams = str(tmp_path / "G.pth")
        io.save_torch_checkpoint(make_grams(), grams,
                                 lightning_envelope=False)
        extra.append(f"gram_matrices={grams!r}")
    outs = []
    for main, name in ((jmerge.main, "jax"), (merge.main, "port")):
        log_dir = str(tmp_path / name)
        out = main(["with", f"load_path={path!r}", f"log_dir={log_dir!r}",
                    *CLI_SHAPE, *extra])
        outs.append(torch.load(out, weights_only=False)["state_dict"])
    assert_dicts_equal({k: v.numpy() for k, v in outs[1].items()},
                       {k: v.numpy() for k, v in outs[0].items()})


def test_convert_cli_writes_the_jax_checkpoint(tmp_path):
    """The vlmo surgery of a 224 checkpoint for a 384 model, through both
    CLIs: equal files' dicts, bit for bit."""
    cfg_args = ["task_finetune_irtr_coco_square_randaug_base_image384",
                "ufo", "num_layers=2", "hidden_size=32", "num_heads=2",
                "max_text_len=8", "vlffn_start_layer_index=1"]
    spec = make_model_spec(build_config(
        "task_finetune_irtr_coco_square_randaug_base_image384", "ufo",
        overrides=dict(num_layers=2, hidden_size=32, num_heads=2,
                       max_text_len=8, vlffn_start_layer_index=1)))
    rng = np.random.RandomState(0)
    window = 14   # a 224 model's table, rescaled to the 384 model's
    rows = (2 * window - 1) ** 2 + 3 + spec.text_num_relative_distance + 2
    sd = {"relative_position_bias_table": rng.randn(rows, 4).astype(
              np.float32),
          "text_embeddings.position_embeddings.weight": rng.randn(
              40, 32).astype(np.float32),
          "text_embeddings.position_ids": np.arange(40)[None],
          "relative_position_index": np.zeros((5, 5), np.int64),
          "logit_scale": np.asarray(2.5, np.float32)}
    path = str(tmp_path / "in.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    outs = []
    for main, name in ((jconvert.main, "jax"), (convert.main, "port")):
        out = main(["with", *cfg_args, f"load_path={path!r}",
                    f"log_dir={str(tmp_path / name)!r}"])
        outs.append({k: v.numpy() for k, v in torch.load(
            out, weights_only=False)["state_dict"].items()})
    assert_dicts_equal(outs[1], outs[0])
    assert outs[1]["relative_position_bias_table"].shape == (
        spec.all_num_relative_distance, 4)
    assert outs[1]["logit_scale"].shape == ()


def _tiny_moe_checkpoint(tmp_path):
    """A numpy all_moe checkpoint (irtr heads, tiny width) written as a
    Lightning envelope, and the ufo config that loads merged weights."""
    over = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
                patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
                vlffn_start_layer_index=1, precision="f32",
                loss_names={"irtr": 1})
    task = "task_finetune_irtr_coco_square_randaug_base_image384"
    moe = build_config(task, "all_moe", overrides=over)
    rng = np.random.RandomState(0)
    sd = {}
    for k, shape in jparam_shapes(jmake_spec(moe)).items():
        v = rng.randn(*shape)
        if len(shape) == 1:
            v = 0.1 * v + (1.0 if "norm" in k.lower() and
                           k.endswith(".weight") else 0.0)
        elif k != "relative_position_bias_table":
            v = 0.02 * v
        sd[k] = np.asarray(v, np.float32)
    path = str(tmp_path / "moe.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    return task, over, path


@pytest.mark.parametrize("method", ["merge_weights", "sum_task_vectors",
                                    "regmean"])
def test_merge_load_eval_flow_matches_jax(tmp_path, method):
    """all_moe checkpoint → merge.py (each method) → load_params(ufo,
    test_only) → compute_irtr_recall, in both packages: the loaded params
    equal bit for bit, the features within the port's f32 tower
    tolerance, the recall dicts equal."""
    task, over, path = _tiny_moe_checkpoint(tmp_path)
    shape = [f"{k}={v!r}" for k, v in over.items()]
    extra = {"merge_weights": ["merge_weights=True", "merge_ratio=0.5"],
             "sum_task_vectors": ["sum_task_vectors=True", "sum_lambda=0.5"],
             "regmean": ["regmean=True", "scaling_for_non_diag=0.9"]}[method]
    rng = np.random.RandomState(2)
    if method == "sum_task_vectors":
        ufo = build_config(task, "ufo", overrides=over)
        central = str(tmp_path / "central.ckpt")
        io.save_torch_checkpoint(
            {k: np.asarray(0.02 * rng.randn(*shape), np.float32)
             for k, shape in jparam_shapes(jmake_spec(ufo)).items()},
            central)
        extra.append(f"central_weight={central!r}")
    if method == "regmean":
        grams = {}
        for i in range(over["num_layers"]):
            for e in "vl":
                for mod, d in ((f"attn.{e}", 128), (f"attn.{e}.proj", 128),
                               (f"mlp.{e}.fc1", 128), (f"mlp.{e}.fc2", 512)):
                    X = rng.randn(2 * d, d)
                    grams[f"transformer.blocks.{i}.{mod}"] = X.T @ X
        gpath = str(tmp_path / "G.pth")
        io.save_torch_checkpoint(grams, gpath, lightning_envelope=False)
        extra.append(f"gram_matrices={gpath!r}")
    outs = [main(["with", task, "all_moe", *shape, f"load_path={path!r}",
                  *extra, f"log_dir={str(tmp_path / name)!r}"])
            for main, name in ((jmerge.main, "jax"), (merge.main, "port"))]
    cfgs = [build_config(task, "ufo", overrides=dict(
        over, load_path=out, test_only=True)) for out in outs]
    jspec, spec = jmake_spec(cfgs[0]), make_model_spec(cfgs[1])
    jparams, jmissing, junexpected = jpipeline.load_params(cfgs[0], jspec)
    params, missing, unexpected = pipeline.load_params(cfgs[1], spec)
    assert missing == jmissing == [] and unexpected == junexpected
    assert_dicts_equal({k: v.numpy() for k, v in params.items()},
                       {k: np.asarray(v) for k, v in jparams.items()})

    rng = np.random.RandomState(1)
    n_img, caps = 4, 2
    images = rng.randn(n_img, 3, 64, 64).astype(np.float32)
    ids = rng.randint(0, 30522, (n_img * caps, 8)).astype(np.int32)
    masks = np.ones_like(ids)
    masks[::2, 5:] = 0
    tiids, iids = np.repeat(np.arange(n_img), caps), np.arange(n_img)
    want = jretrieval.compute_irtr_recall(
        jparams, jspec, [{"text_ids": jnp.asarray(ids),
                          "text_masks": jnp.asarray(masks)}],
        [{"image": jnp.asarray(images)}], tiids, iids)
    tparams = params_from_numpy(params, "cpu")
    tbatch = [{"text_ids": torch.from_numpy(ids),
               "text_masks": torch.from_numpy(masks)}]
    ibatch = [{"image": torch.from_numpy(images)}]
    got = retrieval.compute_irtr_recall(tparams, spec, tbatch, ibatch,
                                        tiids, iids)
    assert got == {k: float(v) for k, v in want.items()}
    for kind, jb, tb in (("image", [{"image": jnp.asarray(images)}], ibatch),
                         ("text", [{"text_ids": jnp.asarray(ids),
                                    "text_masks": jnp.asarray(masks)}],
                          tbatch)):
        np.testing.assert_allclose(
            retrieval.extract_features(tparams, spec, tb, kind).numpy(),
            np.asarray(jretrieval.extract_features(jparams, jspec, jb, kind)),
            **TOWER_TOL, err_msg=kind)
