"""The port's pretrain objectives against the JAX package, on the CPU in f32.

Tiny specs (C=128, 2 heads of 64, 2 layers with ``vlffn_start_layer_index
=1``: layer 0 splits a fused sequence per modality or runs it through one
block, layer 1 has the vl experts; 64-px images in 16-px patches, 17
image tokens; 8 text tokens, captions of 3 to 8 valid tokens) of
``task_mlm_itm_ifm_square_randaug_base`` + ``all_moe`` and
``task_all_in_one_pretraining``, one seeded numpy param dict each, fed to
both packages.  Each objective's loss and every gradient: mlm,
text_only_mlm, mim, image_only_mim, ifm (both vlffn re-runs) and itm (with
the JAX package's hard negatives fed through ``sample_hard_negatives``);
one whole ``task_all_in_one_pretraining`` step on a mixed {"v", "l",
"vl"} batch whose MIM labels come from a seeded dVAE encoder read from a
file the test writes; the gram pass over the
pretrain config (ifm's towers and re-runs, itm's three fused passes) and
the statistics of ``sample_hard_negatives``.

Stochastic depth is on (drop rate 0.1): both packages take the same
(L, 2, B) table for every pass, so a split block's halves and the re-runs
share its scales; the text dropout's draws are not comparable and are
off.  Each port case runs on the plain path and with the @224 pretrain's
kernels' twins (K11/K10 for every attention, K13 for every MLP).

Tolerances: f32 atol 1e-5, rtol 1e-4; params after a step within lr/4
(``test_torch_port_train.py``); grams within 1e-5 of their largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vl_merging_tpu.config import build_config
from vl_merging_tpu.dvae import encoder as jencoder
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.train import gram as jgram
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import objectives as jobjectives
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch import dvae
from vl_merging_tpu_torch.ckpt.convert import master_params, \
    params_from_numpy, params_to_numpy
from vl_merging_tpu_torch.models import model, mome
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.train import gram, objectives, train_step
from vl_merging_tpu_torch.train.loop import build_train_step
from test_torch_port_model import random_arrays
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=1e-5, rtol=1e-4)
GRAM_RTOL = 1e-5
SHAPE = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
             patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
             vlffn_start_layer_index=1, precision="f32", drop_rate=0.1,
             per_device_batch_size=4, batch_size=4, learning_rate=1e-4,
             warmup_steps=0)
PRETRAIN = ("task_mlm_itm_ifm_square_randaug_base", "all_moe")
# the pretrain config with the heads of every objective (its own have no
# MIM head)
HEADS = dict.fromkeys(("mlm", "text_only_mlm", "mim", "image_only_mim",
                       "ifm", "itm"), 1)
ALL_IN_ONE = ("task_all_in_one_pretraining",)
B = 4
# one (L, 2, B) stochastic-depth table for every pass on both sides:
# layer 0's rate is 0, layer 1 keeps 0.9
TABLE = np.asarray([[[1.0] * B] * 2,
                    [[0.0, 1 / 0.9, 1 / 0.9, 0.0],
                     [1 / 0.9, 0.0, 1 / 0.9, 1 / 0.9]]], np.float32)
# the tiny dVAE encoder: 8 channels, 1 block a group, 64 codes; 32-px
# targets give 4 x 4 = 16 codes, the tiny spec's patches
ENC = dict(n_hid=8, n_blk=1, vocab=64)


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


@pytest.fixture(params=["plain", "split twins"])
def kernels(request, monkeypatch):
    """kernels=False, or the @224 route: K11/K10's twin for every
    attention (SPLIT_MIN_N at 0, below KERNEL_MIN_N), K13's for every
    MLP."""
    if request.param == "plain":
        return False
    monkeypatch.setattr(TA, "SPLIT_MIN_N", 0)
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", 0)
    return True


@functools.cache
def setup(names, **losses):
    """(cfg, JAX spec, port spec, numpy params, JAX params, port params)."""
    over = dict(SHAPE)
    if losses:
        over["loss_names"] = losses
    cfg = build_config(*names, overrides=over)
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    return (cfg, jspec, spec, arrays,
            {k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, "cpu"))


def pair_batch(seed: int, n: int = B) -> dict:
    """Seeded image/caption pairs with MLM ids and labels (about 30% of
    the valid tokens masked, token 1 always), MIM targets (32-px), masked
    patches and codebook labels."""
    rng = np.random.RandomState(seed)
    masks = np.ones((n, 8), np.int32)
    for i, m in enumerate(rng.randint(3, 9, n)):
        masks[i, m:] = 0
    ids = rng.randint(1000, 30522, (n, 8)).astype(np.int32)
    picked = (rng.rand(n, 8) < 0.3) & (masks > 0)
    picked[:, 1] = True
    labels = np.where(picked, ids, -100).astype(np.int32)
    return {"text_ids": ids, "text_masks": masks,
            "text_ids_mlm": np.where(picked, 103, ids).astype(np.int32),
            "text_labels_mlm": labels,
            "image": rng.randn(n, 3, 64, 64).astype(np.float32),
            "image_target": (0.8 * rng.rand(n, 3, 32, 32) + 0.1).astype(
                np.float32),
            "image_masked_pos": rng.rand(n, 16) < 0.4,
            "mim_labels": rng.randint(0, 8192, (n, 16)).astype(np.int32)}


def jtree(b):
    return {k: jtree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in b.items()}


def ttree(b):
    return {k: ttree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in b.items()}


def jax_grads(fn, jparams):
    """(loss, out, grads) of the objective ``fn(params) -> out`` summed as
    the JAX train step sums it, under ``jit``."""
    def loss(p):
        out = fn(p)
        return jtrain_step.total_loss(out), out
    (total, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams)
    return total, out, grads


def port_grads(fn, params):
    """(loss, out, grads) of ``fn(masters) -> out`` through autograd."""
    masters = master_params(params)
    out = fn(masters)
    total = train_step.total_loss(out)
    grads = torch.autograd.grad(total, list(masters.values()),
                                allow_unused=True)
    return total, out, {k: torch.zeros_like(masters[k]) if g is None else g
                        for k, g in zip(masters, grads)}


def assert_close(got, want, err_msg="", **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               err_msg=err_msg, **(tol or F32_TOL))


def assert_losses_and_grads(got, want):
    (loss, out, grads), (jloss, jout, jgrads) = got, want
    assert_close(loss, jloss, "total loss")
    for k, v in jout.items():
        if k.endswith(("_loss", "_correct", "_count", "_scale")):
            assert_close(out[k], v, k)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert_close(grads[k], jgrads[k], f"grad {k}")


def jax_negatives(key, out):
    """The hard negatives the JAX package's ``compute_losses`` draws under
    ``key`` from ifm's logits ``out``: its keys[6] split five ways, the
    categoricals of the second and third (train_step.py:85, :128;
    objectives.py:198-209)."""
    _, r_i, r_t, _, _ = jax.random.split(jax.random.split(key, 12)[6], 5)
    eye = jnp.eye(out["ifm_i2t_logits"].shape[0], dtype=bool)
    w_i2t = jnp.where(eye, -jnp.inf, out["ifm_i2t_logits"])
    w_t2i = jnp.where(eye, -jnp.inf, out["ifm_t2i_logits"])
    return tuple(torch.tensor(np.asarray(jax.random.categorical(
        r, w, axis=1)), dtype=torch.long) for r, w in ((r_i, w_t2i),
                                                      (r_t, w_i2t)))


def feed_negatives(monkeypatch, negatives, want_sims=None):
    """``sample_hard_negatives`` returns ``negatives``; the sims it is
    given are held to ``want_sims`` (i2t, t2i) when given."""
    calls = []

    def fake(sim_i2t, sim_t2i, generator):
        if want_sims is not None:
            assert_close(sim_i2t, want_sims[0], "itm sim_i2t")
            assert_close(sim_t2i, want_sims[1], "itm sim_t2i")
        calls.append(generator)
        return negatives
    monkeypatch.setattr(objectives, "sample_hard_negatives", fake)
    return calls


# name -> (the objective's function name, its extra keyword arguments)
OBJECTIVES = {"mlm": ("compute_mlm", {}),
              "text_only_mlm": ("compute_mlm_text_only", {}),
              "mim": ("compute_mim", {"mim_labels": True}),
              "image_only_mim": ("compute_mim_image_only",
                                 {"mim_labels": True}),
              "ifm": ("compute_ifm", {})}


@functools.cache
def jax_objective(name):
    """The JAX side of ``test_objective_matches_jax``, once per objective
    for both of the port's routes (every test here runs under the same
    ``_tables``)."""
    cfg, jspec, _, _, jparams, _ = setup(PRETRAIN, **HEADS)
    jb = jtree(pair_batch(1))
    fn, extra = OBJECTIVES[name]
    jkw = {"mim_labels": jb["mim_labels"]} if extra else {}
    return jax_grads(lambda p: getattr(jobjectives, fn)(
        p, jspec, jb, train=True, rng=jax.random.PRNGKey(3), **jkw), jparams)


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_objective_matches_jax(name, kernels):
    """Each objective on its own: loss, metrics and every gradient."""
    cfg, jspec, spec, _, jparams, params = setup(PRETRAIN, **HEADS)
    b = pair_batch(1)
    fn, extra = OBJECTIVES[name]
    tb = ttree(b)
    tkw = {"mim_labels": tb["mim_labels"]} if extra else {}
    want = jax_objective(name)
    got = port_grads(lambda p: getattr(objectives, fn)(
        p, spec, tb, train=True, generator=torch.Generator().manual_seed(0),
        kernels=kernels, **tkw), params)
    assert_losses_and_grads(got, want)
    if name == "ifm":
        for k in ("ifm_i2t_logits", "ifm_t2i_logits"):
            assert_close(got[1][k], want[1][k], k)


@functools.cache
def jax_itm_step(seed: int):
    """The JAX side of ``test_itm_with_jax_negatives_matches_jax`` under
    ``PRNGKey(seed)``, once for both of the port's routes."""
    cfg, jspec, _, _, jparams, _ = setup(PRETRAIN, ifm=1, itm=1)
    return jax_grads(lambda p: jtrain_step.compute_losses(
        p, jspec, cfg, jtree(pair_batch(2)), jax.random.PRNGKey(seed),
        train=True), jparams)


def test_itm_with_jax_negatives_matches_jax(monkeypatch, kernels):
    """ifm + itm through ``compute_losses``: the JAX package's hard
    negatives (drawn under its key from its ifm logits) fed through
    ``sample_hard_negatives``, which gets ifm's logits and the step's
    generator; loss and every gradient."""
    cfg, jspec, spec, _, jparams, params = setup(PRETRAIN, ifm=1, itm=1)
    b, key = pair_batch(2), jax.random.PRNGKey(5)
    want = jax_itm_step(5)
    negatives = jax_negatives(key, want[1])
    assert not torch.equal(negatives[0], torch.arange(B))
    gen = torch.Generator().manual_seed(0)
    calls = feed_negatives(monkeypatch, negatives,
                           (want[1]["ifm_i2t_logits"],
                            want[1]["ifm_t2i_logits"]))
    got = port_grads(lambda p: train_step.compute_losses(
        p, spec, cfg, ttree(b), gen, kernels=kernels), params)
    assert calls == [gen]
    assert_losses_and_grads(got, want)


def encoder_arrays(seed: int = 6) -> dict:
    """Seeded numpy weights of a tiny DALL-E encoder (ENC) in the released
    module's names."""
    rng = np.random.RandomState(seed)
    out = {}

    def conv(name, cin, cout, k):
        out[f"{name}.w"] = (rng.randn(cout, cin, k, k) /
                            np.sqrt(cin * k * k)).astype(np.float32)
        out[f"{name}.b"] = (0.01 * rng.randn(cout)).astype(np.float32)

    n = ENC["n_hid"]
    conv("blocks.input", 3, n, 7)
    cin = n
    for g, width in enumerate((n, 2 * n, 4 * n, 8 * n), 1):
        p = f"blocks.group_{g}.block_1"
        if cin != width:
            conv(f"{p}.id_path", cin, width, 1)
        conv(f"{p}.res_path.conv_1", cin, width // 4, 3)
        conv(f"{p}.res_path.conv_2", width // 4, width // 4, 3)
        conv(f"{p}.res_path.conv_3", width // 4, width // 4, 3)
        conv(f"{p}.res_path.conv_4", width // 4, width, 1)
        cin = width
    conv("blocks.output.conv", 8 * n, ENC["vocab"], 1)
    return out


def test_all_in_one_step_matches_jax(monkeypatch, tmp_path):
    """One whole task_all_in_one_pretraining step (``build_train_step``,
    AdamW) on a mixed {"v", "l", "vl"} batch (image_only_mim on "v",
    text_only_mlm on "l", mlm, mim, ifm and itm on "vl") whose MIM labels
    come from a seeded dVAE encoder: its weights written by
    ``torch.save`` and read back by ``dvae.make_mim_label_fn``, the JAX
    package's ``get_codebook_indices`` on the same weights; the losses,
    every gradient and every param after the step.  ``compute_losses``
    reading the batches' ``mim_labels`` instead gives the same losses."""
    cfg, jspec, spec, arrays, jparams, params = setup(ALL_IN_ONE)
    enc = encoder_arrays()
    torch.save({k: torch.from_numpy(v) for k, v in enc.items()},
               tmp_path / "encoder.pkl")
    label_fn = dvae.make_mim_label_fn(str(tmp_path))
    jenc = {k: jnp.asarray(v) for k, v in enc.items()}

    def jlabel(b):
        return jencoder.get_codebook_indices(jenc, b["image_target"],
                                             n_blk_per_group=1)

    b = {"v": pair_batch(8), "l": pair_batch(9), "vl": pair_batch(10)}
    for sub in b.values():
        del sub["mim_labels"]
    for sub in ("v", "vl"):
        got_labels = label_fn(ttree(b[sub]))
        np.testing.assert_array_equal(
            got_labels.numpy(), np.asarray(jlabel(jtree(b[sub]))))
        assert got_labels.shape == (B, 16) and int(got_labels.max()) < 64
    key = jax.random.PRNGKey(11)
    jloss, jout, jgrads = jax_grads(lambda p: jtrain_step.compute_losses(
        p, jspec, cfg, jtree(b), key, train=True, mim_label_fn=jlabel),
        jparams)
    jopt = jmake_optimizer(jparams, cfg, 10, jmake_schedule(cfg, 10))
    updates, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)

    feed_negatives(monkeypatch, jax_negatives(key, jout))
    _, _, grads = train_step.loss_and_grads(
        master_params(params), spec, cfg, ttree(b),
        torch.Generator().manual_seed(0), kernels=False,
        mim_label_fn=label_fn)
    state, step = build_train_step(cfg, spec, master_params(params), 10,
                                   mim_label_fn=label_fn)
    state, metrics = step(state, ttree(b))
    assert_close(metrics["total_loss"], jloss, "total loss")
    for k in ("image_only_mim_loss", "text_only_mlm_loss", "mlm_loss",
              "mim_loss", "ifm_loss", "itm_loss"):
        assert_close(metrics[k], jout[k], k)
    assert_close(metrics["grad_norm"], optax.global_norm(jgrads),
                 "grad norm")
    for k in jgrads:
        assert_close(grads[k], jgrads[k], f"grad {k}")
    got = params_to_numpy(state.params)
    for k in arrays:
        np.testing.assert_allclose(got[k], np.asarray(jnew[k]),
                                   atol=cfg["learning_rate"] / 4, rtol=1e-4,
                                   err_msg=f"param {k}")
    assert not np.array_equal(got["transformer.mask_token"],
                              arrays["transformer.mask_token"])
    tb = ttree(b)
    for sub in ("v", "vl"):
        tb[sub]["mim_labels"] = label_fn(tb[sub])
    with torch.no_grad():
        out = train_step.compute_losses(params, spec, cfg, tb,
                                        torch.Generator().manual_seed(0),
                                        kernels=False)
    for k in ("image_only_mim_loss", "mim_loss", "itm_loss"):
        assert_close(out[k], jout[k], f"{k} from the batches' mim_labels")


def test_pretrain_grams_match_jax(monkeypatch):
    """The gram pass (``train/gram.cache_gram_matrices``, f64 on the host)
    over the all_moe pretrain config in eval mode: mlm's fused pass, ifm's
    towers and vlffn re-runs, itm's three fused passes with the JAX
    package's negatives; the same modules tapped as often, the grams
    within GRAM_RTOL of the largest entry."""
    cfg, jspec, spec, _, jparams, params = setup(PRETRAIN)
    b = pair_batch(12)
    # the JAX pass's key for its first batch (gram.py:95, :114)
    key = jax.random.split(jax.random.PRNGKey(cfg["seed"]))[1]
    ifm = jax.jit(lambda p: jobjectives.compute_ifm(p, jspec, jtree(b)))(
        jparams)
    feed_negatives(monkeypatch, jax_negatives(key, ifm))
    want = jgram.cache_gram_matrices(jparams, jspec, cfg, [jtree(b)])
    got = gram.cache_gram_matrices(params, spec, cfg, [ttree(b)])
    assert set(got) == set(want)
    assert {k for k in got if ".vl" in k} == {
        f"transformer.blocks.1.{m}" for m in (
            "attn.vl", "attn.vl.proj", "mlp.vl.fc1", "mlp.vl.fc2")}
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAM_RTOL * np.abs(w).max(), k


def test_sample_hard_negatives_statistics():
    """20,000 draws at a fixed seed for each row of a 4 x 4 pair of sims:
    never the diagonal, and each row's frequencies within 0.01 of the
    softmax of its off-diagonal sims.  The draws come 100 at a time from
    a block-diagonal batch of 100 copies (-inf off the blocks)."""
    rng = np.random.RandomState(13)
    sims = [torch.from_numpy(rng.randn(B, B).astype(np.float32))
            for _ in range(2)]
    copies, calls = 100, 200
    big = [torch.block_diag(*[s] * copies) for s in sims]
    off = torch.block_diag(*[torch.ones(B, B)] * copies) == 0
    big = [s.masked_fill(off, float("-inf")) for s in big]
    gen = torch.Generator().manual_seed(0)
    counts = [torch.zeros(B, B), torch.zeros(B, B)]
    rows = torch.arange(B * copies)
    for _ in range(calls):
        for c, idx in zip(counts, objectives.sample_hard_negatives(
                big[0], big[1], gen)):
            assert idx.dtype == torch.long and idx.shape == rows.shape
            assert bool((idx // B == rows // B).all())
            c.index_put_((rows % B, idx % B), torch.ones(rows.shape),
                         accumulate=True)
    draws = copies * calls
    eye = torch.eye(B, dtype=torch.bool)
    # the image per text reads sim_t2i, the text per image sim_i2t
    for c, sim in zip(counts, sims[::-1]):
        assert int(c.sum()) == B * draws and not c[eye].any()
        want = torch.softmax(sim.masked_fill(eye, float("-inf")), dim=1)
        assert (c / draws - want).abs().max() <= 0.01
