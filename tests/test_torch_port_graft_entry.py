"""The port's driver entry points (``vl_merging_tpu_torch/graft_entry.py``)
against the JAX package, on the CPU in f32.

  1. ``entry``'s fused forward (ViT-B/16 MoME all_moe at the dry run's
     tiny shapes) against JAX ``model.infer`` on the same numpy params
     (``TOWER_TOL``: atol 2e-5, rtol 1e-4), bit-equal in bf16 on its f32
     masters and on their eval cast, and both entry points refusing to run
     without a card unless the CPU is named;
  2. ``dryrun_multichip(4, device="cpu")`` at the tiny overrides in f32:
     four ranks spawned once for the module on a data 2 × fsdp 2 mesh
     (``tests/torch_port_dist_worker.step_draws``: the JAX package's
     stochastic-depth table and hard negatives in the step, no text
     dropout), while the JAX package's step runs:
       - the first step's losses within 1e-4 relative of JAX
         ``make_train_step`` over the global batch (8 rows) at
         ``dp_scale`` 1/4, its averaged gradients (``kept_states``) within
         atol 1e-5, rtol 1e-4 of the port's one-process gradients, every
         rank holding the shards of the params and moments and nothing of
         the full state, and the stage's three steps timed;
       - the merged ufo state bit-equal to JAX ``merging.core.
         merge_weights`` of the same gathered host state (and its
         digest);
       - the recall, and the merged model's, equal to one process's port
         recall over the global batch, and within ``TOWER_TOL`` of JAX
         ``compute_irtr_recall`` on the same params;
       - the VQA submission one json, equal to one process's.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_distributed import jax_draws
from test_torch_port_pretrain import jax_negatives
from torch_port_dist_worker import fixed_draws, step_draws
from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.evaluation.retrieval import \
    compute_irtr_recall as jcompute_irtr_recall
from vl_merging_tpu.merging import core as jmerging
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch import graft_entry
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    master_params, params_from_numpy, params_to_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.evaluation.downstream import vqa_predictions, \
    write_vqa_submission
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.train import train_step
from torch_port_threads import one_torch_thread  # noqa: F401

WORLD = 4
ROWS = graft_entry.TINY_ROWS * WORLD
LOSS_REL = 1e-4
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
TOWER_TOL = dict(atol=2e-5, rtol=1e-4)
# f32, and the JAX package's threefry key (the negatives are replayed from
# it); both configs are built from the same overrides
OVER = dict(precision="f32", train_rng_impl="threefry")


@pytest.fixture(scope="module")
def setup():
    """(port configs, JAX step config, numpy params, numpy batch, the
    global (L, 2, 8) stochastic-depth table, the JAX step's key)."""
    cfgs = graft_entry.dryrun_configs(WORLD, overrides=OVER)
    jcfg = jbuild_config(graft_entry.DRYRUN_TINY, "all_moe", overrides=dict(
        graft_entry.tiny_overrides(use_sharded_training=True,
                                   per_device_batch_size=graft_entry.TINY_ROWS,
                                   batch_size=ROWS), **OVER))
    assert jcfg == cfgs["step"]
    spec = make_model_spec(cfgs["step"])
    arrays = params_to_numpy(graft_entry.seeded_params(spec, "cpu"))
    batch = {k: v.numpy() for k, v in graft_entry.make_batch(
        spec, ROWS).items()}
    rng = np.random.RandomState(21)
    table = np.ones((spec.num_layers, 2, ROWS), np.float32)
    table[1:] = np.where(rng.rand(spec.num_layers - 1, 2, ROWS) < 0.9,
                         1 / 0.9, 0.0)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    return cfgs, jcfg, arrays, batch, table, key


def jax_inputs(setup):
    _, jcfg, arrays, batch, table, key = setup
    return (jcfg, jmake_spec(jcfg),
            {k: jnp.asarray(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}, table, key)


def jax_step(setup):
    jcfg, jspec, jparams, jbatch, table, _ = jax_inputs(setup)
    with jax_draws(table):
        opt = jmake_optimizer(jparams, jcfg, jcfg["max_steps"],
                              jmake_schedule(jcfg, jcfg["max_steps"]))
        state = jtrain_step.init_train_state(jparams, opt, seed=0)
        step = jtrain_step.make_train_step(jcfg, jspec, opt,
                                           dp_scale=1 / WORLD, donate=False)
        _, metrics = step(state, jbatch)
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def runs(setup):
    """(the four ranks' figures, the JAX step's metrics, the negatives):
    the JAX forward's hard negatives first, then the ranks and the JAX
    step at once."""
    jcfg, jspec, jparams, jbatch, table, key = jax_inputs(setup)
    with jax_draws(table):
        out = jax.jit(lambda p: jtrain_step.compute_losses(
            p, jspec, jcfg, jbatch, key, train=True))(jparams)
    negatives = jax_negatives(key, out)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            graft_entry.dryrun_multichip, WORLD, device="cpu",
            overrides=OVER,
            stage_context=functools.partial(step_draws, table, negatives))
        want = jax_step(setup)
        ranks = ranks.result()
    return ranks, want, negatives


def test_entry_matches_jax():
    over = graft_entry.tiny_overrides(precision="f32")
    fn, (params, batch) = graft_entry.entry(over, device="cpu")
    got = fn(params, batch)
    cfg = jbuild_config(graft_entry.PRETRAIN, "all_moe", overrides=over)
    jspec = jmake_spec(cfg)
    want = jax.jit(lambda p, b: jmodel.infer(p, jspec, b)["cls_feats"])(
        {k: jnp.asarray(v) for k, v in params_to_numpy(params).items()},
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert got.shape == (4, 64) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)


def test_entry_takes_eval_cast_params_bit_equal():
    """``entry`` hands ``model.infer`` f32 masters, as the JAX package's
    does; in bf16 the eval cast of them gives the same features."""
    over = graft_entry.tiny_overrides()
    fn, (params, batch) = graft_entry.entry(over, device="cpu")
    cfg = build_config(graft_entry.PRETRAIN, "all_moe",
                       overrides=dict(over, precision="bf16"))
    spec = make_model_spec(cfg)
    got = fn(params, batch)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 64)
    assert torch.equal(got, fn(eval_cast_params(params, spec, cfg), batch))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_need_a_card_unless_the_cpu_is_named():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry(graft_entry.tiny_overrides())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(WORLD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(WORLD, device="cuda:0",
                                     backend="gloo")


def test_dryrun_step_matches_jax(runs, setup):
    ranks, want, negatives = runs
    cfgs, _, arrays, batch, table, _ = setup
    for r, rank in enumerate(ranks):
        assert rank["mesh"] == (2, 2) and rank["backend"] == "gloo"
        assert set(rank["seconds"]) == set(graft_entry.STAGES)
        step = rank["step"]
        assert step["metrics"] == ranks[0]["step"]["metrics"], r
        keys = [k for k in want if k.endswith("_loss")]
        assert set(keys) >= {"total_loss", "mlm_loss", "itm_loss",
                             "ifm_loss"}
        for k in keys:
            assert abs(step["metrics"][k] - want[k]) <= \
                LOSS_REL * max(1.0, abs(want[k])), (r, k)
        # the state holds its shards of the params and both moments, in
        # storage of their own: about half of the full f32 state
        assert step["held_bytes"] == step["shard_bytes"], r
        assert 0.5 <= step["held_bytes"] / step["full_bytes"] < 0.55, r
        assert step["sharded"] > 0 and step["collective_calls"] > 0
        # the gated step, the timed one, the one inside collective_time
        assert len(step["step_ms"]) == graft_entry.DRYRUN_STEPS
        assert step["timed_ms"] == step["step_ms"][graft_entry.TIMED_STEP]
        assert 0 < step["collective_share"] < 1
    # the averaged gradients against the port's one process over the
    # global batch at dp_scale 1/4, the same draws
    spec = make_model_spec(cfgs["step"])
    with fixed_draws(table, negatives, []):
        _, _, grads = train_step.loss_and_grads(
            master_params(params_from_numpy(arrays, "cpu")), spec,
            cfgs["step"], {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(cfgs["step"]["seed"]),
            kernels=False, dp_scale=1 / WORLD)
    got = ranks[0]["extra"]["step"]["grads"]
    assert set(got) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **GRAD_TOL)
    assert all(rank["extra"]["step"] == {} for rank in ranks[1:])


def host_state(ranks, name):
    """Rank 0's ``name`` state that ``kept_states`` kept in the merge, as
    numpy (no other rank keeps one)."""
    assert all(rank["extra"]["merge"] == {} for rank in ranks[1:])
    return {k: v.numpy() for k, v in ranks[0]["extra"]["merge"][name].items()}


def test_dryrun_merge_matches_jax(runs, setup):
    ranks = runs[0]
    cfg = setup[0]["step"]
    trained = host_state(ranks, "trained")
    want = jmerging.merge_weights(
        trained, num_layers=cfg["num_layers"],
        vlffn_start_layer_index=cfg["vlffn_start_layer_index"],
        loss_names=cfg["loss_names"], merge_ratio=0.5)
    got = host_state(ranks, "merged")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert {r["merged_digest"] for r in ranks} == {
        graft_entry.state_digest(want)}
    # the trained state moved off the seeded params
    moved = sum(not np.array_equal(v, setup[2][k])
                for k, v in trained.items())
    assert set(trained) == set(setup[2]) and moved > len(trained) // 2


def one_process_recall(params, spec, cfg):
    text, image, ids = graft_entry.eval_batches(spec, ROWS, None, "cpu")
    return compute_irtr_recall(eval_cast_params(params, spec, cfg), spec,
                               text, image, ids, ids), (text, image, ids)


def test_dryrun_recall_matches_one_process_and_jax(runs, setup):
    ranks = runs[0]
    cfgs = setup[0]
    cfg = cfgs["step"]
    spec = make_model_spec(cfg)
    trained = host_state(ranks, "trained")
    want, (text, image, ids) = one_process_recall(
        params_from_numpy(trained, "cpu"), spec, cfg)
    assert all(r["recall"] == want for r in ranks)
    jspec = jmake_spec(cfg)
    jrec = jcompute_irtr_recall(
        {k: jnp.asarray(v) for k, v in trained.items()}, jspec,
        [{k: jnp.asarray(v.numpy()) for k, v in text[0].items()}],
        [{k: jnp.asarray(v.numpy()) for k, v in image[0].items()}],
        ids, ids)
    assert set(jrec) == set(want)
    for k, v in jrec.items():
        np.testing.assert_allclose(want[k], v, err_msg=k, **TOWER_TOL)
    # the merged model's
    _, spec_ufo, ufo = graft_entry.merge_to_ufo(trained, cfgs)
    want_m, _ = one_process_recall(ufo, spec_ufo, cfgs["ufo"])
    assert all(r["merged_recall"] == want_m for r in ranks)


def test_dryrun_vqa_submission_equals_one_process(runs, setup, tmp_path):
    ranks = runs[0]
    cfg = setup[0]["vqa"]
    spec = make_model_spec(cfg)
    params = eval_cast_params(graft_entry.seeded_params(spec, "cpu"), spec,
                              cfg)
    rets = vqa_predictions(params, spec,
                           graft_entry.vqa_feeds(spec, ROWS, None, "cpu"),
                           graft_entry.vqa_answers(spec), scan_k=2)
    path = write_vqa_submission(rets, "one", str(tmp_path))
    assert os.path.basename(path) == "vqa_submit_one.json"
    def key(r):
        return r["question_id"]
    got = ranks[0]["submission"]
    assert len(got) == 2 * ROWS and sorted(got, key=key) == rets
    assert got == [r for rank in ranks for r in rank["rets"]]
    assert all(rank["submission"] is None for rank in ranks[1:])
