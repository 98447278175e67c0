"""The port's distribution (``parallel/``, the cross-rank objectives, the
data-parallel and sharded steps, the Trainer over ranks) on two-rank gloo
groups on the CPU, against one process and against the JAX package.

One group per module: ``torch.multiprocessing`` spawns two ranks
(``tests/torch_port_dist_worker.py``, JAX-free, one CPU thread each,
``init_method`` a file store under the test's tmp dir), which run every
case and save their results to files that the tests read.

  1. the averaged gradients and one train step at world 2 (the tiny ufo
     config of
     ``test_train.tiny_cfg``: hidden 32, 2 layers; mlm, itm and ifm; 16
     rows, 8 a rank) against the JAX package's gradients and
     ``make_train_step`` over the 16 rows with ``dp_scale`` 1/2, the same
     stochastic-depth table and ITM negatives on both sides and no text
     dropout: gradients within atol 1e-5, rtol 1e-4 (f32), losses within
     1e-4 relative, params by the ladder of
     ``test_train.test_multi_device_step_equals_single_device`` (bulk
     99.9% within 2e-5 + 2e-4·|a|, all within rtol 2e-3, atol 2e-4);
  2. the data-parallel gradients and step against the port's one-process
     ones over the 16 rows with ``dp_scale`` 1/2, by the same tolerances;
  3. ``use_sharded_training`` at world 2 (an fsdp axis of 2: the state
     holds half of each sharded param, in storage of its own) against the
     data-parallel step,
     and at world 4 on a data 2 × fsdp 2 mesh (a group of its own);
  4. the autograd gather's gradient against the reference semantics on
     a hand-made loss, and ``torch.distributed.nn.functional.all_gather``
     giving world × that;
  5. ``Trainer.recall`` at world 2 equal to one process's;
  6. the VQA submission of ``run.main(test_only)`` at world 2: one json
     equal to one process's (and ``num_devices=1`` refused at world 2);
  7. ``cross_process_reduce``, ``reduce_dict``, ``all_gather_objects``
     and the steps' ``reduce_metrics`` sum (or average) the ranks' values;
  8. checkpoints: rank 0 alone writes, and a fit resumed from its step-2
     checkpoint at world 2 takes the uninterrupted fit's steps 3-4 bit
     for bit;
  9. ``cluster_spec_from_env`` on the env dicts of
     ``test_train.test_cluster_spec_from_env``, and ``_fsdp_spec`` against
     the JAX package's;
 10. ``device_mlm`` at world 2: each rank's masks (whole-word, from the
     collator's word ids, drawn from the step's generator) are its rows of
     one process's masks over the 16 rows, bit for bit, and the step that
     derives them has one process's losses (within 1e-4 relative).
"""

import contextlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from fixtures import make_fixture_root
from test_torch_port_model import random_arrays
from test_torch_port_pretrain import jax_negatives
from test_torch_port_trainer import IRTR, VQA, argv, only_dir, tiny
from test_text_masking import _random_row
from test_train import make_batch, tiny_cfg
from torch_port_dist_worker import fixed_draws, run
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models import model as jmodel
from vl_merging_tpu.parallel import mesh as jmesh
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import train_step as jtrain_step
from vl_merging_tpu_torch import run as port_run
from vl_merging_tpu_torch.ckpt import io as ckpt_io
from vl_merging_tpu_torch.ckpt.convert import master_params, \
    params_from_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.data.datamodule import MTDataModule
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec
from vl_merging_tpu_torch.parallel import mesh
from vl_merging_tpu_torch.train import loop, train_step
from vl_merging_tpu_torch.train.optimizer import make_optimizer
from vl_merging_tpu_torch.train.schedule import make_schedule
from torch_port_threads import one_torch_thread  # noqa: F401

WORLD, ROWS = 2, 16
LOSS_REL = 1e-4
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)   # f32 gradients, as the port's tests
STEP = dict(warmup_steps=0, learning_rate=5e-3, train_rng_impl="threefry",
            loss_names={"mlm": 1, "itm": 1, "ifm": 1},
            per_device_batch_size=ROWS // WORLD, batch_size=ROWS)
RUN_TIMEOUT_S = 240
MLM_OVER = dict(device_mlm=True, mask_token_id=103, whole_word_masking=True)


def draws(num_layers: int):
    """The global (L, 2, 16) stochastic-depth table (layer 0 keeps every
    sample; layer 1 at keep 0.9) and the JAX package's draws."""
    rng = np.random.RandomState(21)
    table = np.ones((num_layers, 2, ROWS), np.float32)
    table[1:] = np.where(rng.rand(num_layers - 1, 2, ROWS) < 0.9,
                         1 / 0.9, 0.0)
    return table


@pytest.fixture(scope="module")
def step_setup():
    """(JAX cfg, port cfg, numpy params, numpy batch, table, JAX step key)."""
    jcfg = tiny_cfg("ufo", **STEP)
    cfg = build_config("ufo", overrides=dict(
        hidden_size=32, num_heads=2, num_layers=2, image_size=32,
        patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
        vlffn_start_layer_index=1, precision="f32", max_steps=100,
        tasks=None, **STEP))
    jspec = jmake_spec(jcfg)
    arrays = random_arrays(jspec, 0)
    batch = {k: np.asarray(v) for k, v in make_batch(jspec, bsz=ROWS,
                                                     seed=3).items()}
    table = draws(jspec.num_layers)
    # the key the JAX step passes compute_losses (threefry, seed 0)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    return jcfg, cfg, arrays, batch, table, key


@contextlib.contextmanager
def jax_draws(table):
    """The JAX package's stochastic depth at ``table``, no text dropout."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jmodel, "_dp_scale_table",
                      lambda spec, rng, train, b: jax.numpy.asarray(table)
                      if train else None)
        patch.setattr(jmodel, "dropout", lambda x, *a: x)
        yield


def jax_inputs(step_setup):
    jcfg, _, arrays, batch, table, key = step_setup
    return (jcfg, jmake_spec(jcfg),
            {k: jax.numpy.asarray(v) for k, v in arrays.items()},
            {k: jax.numpy.asarray(v) for k, v in batch.items()}, table, key)


@pytest.fixture(scope="module")
def jax_forward(step_setup):
    """The JAX package's ifm logits over the 16 rows and its hard
    negatives (the key of its step's ITM draw)."""
    jcfg, jspec, jparams, jbatch, table, key = jax_inputs(step_setup)
    with jax_draws(table):
        out = jax.jit(lambda p: jtrain_step.compute_losses(
            p, jspec, jcfg, jbatch, key, train=True))(jparams)
    return {"logits": (np.asarray(out["ifm_i2t_logits"]),
                       np.asarray(out["ifm_t2i_logits"])),
            "negatives": tuple(n.numpy() for n in jax_negatives(key, out))}


def jax_step(step_setup):
    """The JAX package's gradients and step over the 16 rows at dp_scale
    1/2; the gradients are compiled in a thread beside the step."""
    jcfg, jspec, jparams, jbatch, table, key = jax_inputs(step_setup)
    grad_fn = jax.jit(jax.grad(lambda p, b, k: jtrain_step.total_loss(
        jtrain_step.compute_losses(p, jspec, jcfg, b, k, train=True),
        1 / WORLD)))
    with jax_draws(table), ThreadPoolExecutor(1) as pool:
        grads = pool.submit(lambda: jax.block_until_ready(
            grad_fn(jparams, jbatch, key)))
        sched = jmake_schedule(jcfg, jcfg["max_steps"])
        opt = jmake_optimizer(jparams, jcfg, jcfg["max_steps"], sched)
        state = jtrain_step.init_train_state(jparams, opt, seed=0)
        step = jtrain_step.make_train_step(jcfg, jspec, opt,
                                           dp_scale=1 / WORLD, donate=False)
        state, metrics = step(state, jbatch)
        grads = grads.result()
    return {"params": {k: np.asarray(v) for k, v in state.params.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: np.asarray(v) for k, v in grads.items()}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The fixture arrows and one seeded checkpoint each for irtr and
    VQA."""
    root = make_fixture_root(tmp_path_factory.mktemp("dist_data"))
    d = tmp_path_factory.mktemp("dist_weights")
    weights = {}
    for i, names in enumerate((IRTR, VQA)):
        spec = make_model_spec(build_config(*names, overrides=tiny(root, "")))
        gen = torch.Generator().manual_seed(100 + i)
        params = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
                  for k, v in init_params(spec, gen).items()}
        path = str(d / f"{i}" / "weights.ckpt")
        ckpt_io.save_torch_checkpoint(ckpt_io.params_to_state_dict(params),
                                      path)
        weights[names] = path
    return root, weights


def recall_over(root, weights, log_dir, **over):
    return tiny(root, str(log_dir), load_path=weights[IRTR], use_cpu=True,
                get_recall_metric=True, **over)


def vqa_over(root, weights, log_dir, **over):
    return tiny(root, str(log_dir), load_path=weights[VQA], datasets=["vqa"],
                test_only=True, **over)


@pytest.fixture(scope="module")
def runs(step_setup, jax_forward, data, tmp_path_factory):
    """Both ranks' results of every case (one two-rank group), the JAX
    package's step, and a four-rank group's steps, the three run at
    once."""
    _, cfg, arrays, batch, table, _ = step_setup
    root, weights = data
    tmp = tmp_path_factory.mktemp("dist_run")
    job = {
        "step_cfg": cfg, "arrays": arrays, "batch": batch, "table": table,
        "negatives": jax_forward["negatives"], "irtr": IRTR,
        "recall_over": recall_over(root, weights, tmp / "recall",
                                   num_devices=WORLD),
        "vqa_argv": argv(VQA, vqa_over(root, weights, tmp / "vqa",
                                       num_devices=WORLD), True),
        "vqa_argv_one": argv(VQA, vqa_over(root, weights, tmp / "vqa1",
                                           num_devices=1), True),
        "resume_over": tiny(root, "", load_path=weights[IRTR], use_cpu=True,
                            max_steps=4, per_device_batch_size=2,
                            batch_size=4, drop_rate=0.1,
                            val_check_interval=2, num_devices=WORLD),
        "tmp": str(tmp), "mlm_over": MLM_OVER,
        "mlm_batch": mlm_batch(batch),
    }
    tmp4 = tmp_path_factory.mktemp("dist_run4")
    ctx = start_ranks(WORLD, job, tmp)
    ctx4 = start_ranks(4, job, tmp4, ("steps",))
    try:
        jax_out = jax_step(step_setup)
    finally:
        ranks = join_ranks(ctx, WORLD, tmp)
        ranks4 = join_ranks(ctx4, 4, tmp4)
    return ranks, dict(jax_out, **jax_forward), ranks4


def mlm_batch(batch):
    """The step's batch for device_mlm: the MLM inputs left out, the
    collator's word ids (-1 on special and padding tokens) in."""
    out = {k: v for k, v in batch.items()
           if k not in ("text_ids_mlm", "text_labels_mlm")}
    rng = np.random.RandomState(8)
    rows, length = batch["text_ids"].shape
    out["text_word_ids"] = np.stack([_random_row(rng, length)
                                     for _ in range(rows)])
    return out


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


def start_ranks(world, job, tmp, cases=None):
    """Start the worker's cases on ``world`` ranks.  The job goes through
    a file: a spawned process reads its arguments only once it has
    imported torch, so arguments larger than a pipe's buffer would hold
    each start until then."""
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    return mp.start_processes(
        run, args=(world, str(tmp / "store"), job_path, str(tmp), cases),
        nprocs=world, join=False, start_method="spawn")


def join_ranks(ctx, world, tmp):
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        # join returns as each rank ends, True once all have
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            assert time.monotonic() < deadline, \
                f"the ranks ran past {RUN_TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def case(ranks, name):
    out = [r[name] for r in ranks]
    for r, o in enumerate(out):
        assert not (isinstance(o, dict) and "error" in o), \
            f"rank {r}: {o['error']}"
    return out


def assert_param_close(got, want, msg):
    """``test_multi_device_step_equals_single_device``'s ladder."""
    g = np.asarray(got, np.float32)
    a = np.asarray(want, np.float32)
    ok = np.abs(g - a) <= 2e-5 + 2e-4 * np.abs(a)
    assert ok.mean() >= 0.999, (msg, float(ok.mean()))
    np.testing.assert_allclose(g, a, rtol=2e-3, atol=2e-4, err_msg=msg)


def assert_losses_close(got, want):
    keys = [k for k in want if k.endswith("_loss")]
    assert set(keys) >= {"total_loss", "mlm_loss", "itm_loss", "ifm_loss"}
    for k in keys:
        assert abs(got[k] - want[k]) <= LOSS_REL * max(1.0, abs(want[k])), \
            (k, got[k], want[k])


def assert_grads_close(got, want, msg):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=f"{msg}: grad {k}",
                                   **GRAD_TOL)


def test_world2_step_matches_jax(ranks, jax_ref, step_setup):
    steps = case(ranks, "steps")
    # the averaged gradients, the logit scales' included
    assert_grads_close(steps[0]["grads"], jax_ref["grads"], "world 2 vs JAX")
    got = steps[0]["dp"]
    # both ranks report the global metrics; ITM saw the global sims
    assert steps[1]["dp"]["metrics"] == got["metrics"]
    for g, w in zip(got["sims"], jax_ref["logits"]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    assert_losses_close(got["metrics"], jax_ref["metrics"])
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               jax_ref["metrics"]["grad_norm"], rtol=1e-4)
    for k in ("ifm_i2t_correct", "itm_correct", "mlm_correct"):
        assert got["metrics"][k] == jax_ref["metrics"][k], k
    assert set(got["params"]) == set(jax_ref["params"])
    moved = 0
    for k, want in jax_ref["params"].items():
        assert_param_close(got["params"][k], want, f"world 2 vs JAX: {k}")
        moved += not np.array_equal(want, step_setup[2][k])
    assert moved > 10


def test_data_parallel_matches_one_process(ranks, step_setup, jax_ref):
    """The port's one-process step over the 16 rows at dp_scale 1/2 (the
    same draws) against the data-parallel step at world 2."""
    _, cfg, arrays, batch, table, _ = step_setup
    spec = make_model_spec(cfg)
    params = master_params(params_from_numpy(arrays, "cpu"))
    opt = make_optimizer(params, cfg, cfg["max_steps"],
                         make_schedule(cfg, cfg["max_steps"]))
    state = train_step.init_train_state(params, opt, seed=cfg["seed"])
    step = train_step.make_train_step(cfg, spec, opt, dp_scale=1 / WORLD)
    sims = []
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with fixed_draws(table, jax_ref["negatives"], sims):
        _, _, grads = train_step.loss_and_grads(
            master_params(params_from_numpy(arrays, "cpu")), spec, cfg,
            tbatch, torch.Generator().manual_seed(cfg["seed"]),
            kernels=False, dp_scale=1 / WORLD)
        state, metrics = step(state, tbatch)
    want = {k: float(v) for k, v in metrics.items()}
    steps = case(ranks, "steps")
    assert_grads_close(steps[0]["grads"],
                       {k: v.numpy() for k, v in grads.items()},
                       "world 2 vs one process")
    np.testing.assert_array_equal(steps[1]["grads"]["logit_scale"],
                                  steps[0]["grads"]["logit_scale"])
    got = steps[0]["dp"]
    np.testing.assert_array_equal(got["sims"][0], sims[1][0].numpy())
    assert_losses_close(got["metrics"], want)
    for k, v in state.params.items():
        assert_param_close(got["params"][k], v.detach().numpy(),
                           f"world 2 vs one process: {k}")


def test_sharded_matches_data_parallel(ranks):
    for r, steps in enumerate(case(ranks, "steps")):
        dp, sh = steps["dp"], steps["sharded"]
        assert dp["mesh"] == (2, 1) and sh["mesh"] == (1, 2), r
        halved = [k for k, s in sh["shapes"].items() if s != dp["shapes"][k]]
        # the params with an even axis of 128 or more shard (the word
        # embeddings, 30522 x 32; every fc1 weight and bias, 128 rows);
        # the LayerNorms (32) do not
        assert "text_embeddings.word_embeddings.weight" in halved
        assert all(np.prod(sh["shapes"][k]) * 2 == np.prod(dp["shapes"][k])
                   for k in halved)
        assert halved == [k for k, s in dp["shapes"].items()
                          if any(d >= 128 and d % 2 == 0 for d in s)]
        assert not any("norm" in k.lower() for k in halved)
        # the state holds its shards (params and both moments) and nothing
        # of the full tensors: about half of the data-parallel state's bytes
        for st in (dp, sh):
            assert st["held_bytes"] == 3 * 4 * sum(
                int(np.prod(s)) for s in st["shapes"].values()), r
        assert sh["held_bytes"] < 0.55 * dp["held_bytes"], r
        assert_losses_close(sh["metrics"], dp["metrics"])
        for k, v in dp["params"].items():
            assert_param_close(sh["params"][k], v, f"sharded vs dp: {k}")


def test_sharded_over_data_and_fsdp_axes_at_world_4(runs, step_setup,
                                                     jax_forward):
    """Four ranks (4 rows each): the averaged gradients against one
    process's at dp_scale 1/4, and the sharded step on a data 2 × fsdp 2
    mesh (the fsdp and data subgroups) against the data-parallel step."""
    _, cfg, arrays, batch, table, _ = step_setup
    ranks = runs[2]
    with fixed_draws(table, jax_forward["negatives"], []):
        _, _, want = train_step.loss_and_grads(
            master_params(params_from_numpy(arrays, "cpu")),
            make_model_spec(cfg), cfg,
            {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(cfg["seed"]), kernels=False,
            dp_scale=1 / 4)
    steps = case(ranks, "steps")
    assert_grads_close(steps[0]["grads"], {k: v.numpy()
                                           for k, v in want.items()},
                       "world 4 vs one process")
    for r, s in enumerate(steps):
        assert s["dp"]["mesh"] == (4, 1) and s["sharded"]["mesh"] == (2, 2)
        assert_losses_close(s["sharded"]["metrics"], s["dp"]["metrics"])
        for k, v in s["dp"]["params"].items():
            assert_param_close(s["sharded"]["params"][k], v,
                               f"rank {r}, sharded vs dp: {k}")


def test_autograd_gather_gradient(ranks):
    for r, g in enumerate(case(ranks, "gather")):
        rows = slice(3 * r, 3 * r + 3)
        # d/dx Σ c·g² through this rank's rows only
        want = 2 * g["c"][rows] * g["x"]
        torch.testing.assert_close(g["mine"], want, rtol=0, atol=0)
        torch.testing.assert_close(g["theirs"], WORLD * want, rtol=0, atol=0)
        torch.testing.assert_close(g["gathered"][rows], g["x"])
    assert torch.equal(ranks[0]["gather"]["gathered"],
                       ranks[1]["gather"]["gathered"])


def test_recall_equals_one_process(ranks, data, tmp_path):
    root, weights = data
    cfg = build_config(*IRTR, overrides=recall_over(root, weights, tmp_path))
    trainer = loop.Trainer(cfg)
    want = trainer.recall(MTDataModule(cfg), split="test")
    trainer.logger.close()
    got = case(ranks, "recall")
    assert got[0] == got[1] == want
    assert set(want) == {f"{d}_r{k}" for d in ("ir", "tr")
                         for k in (1, 5, 10)}


def test_vqa_submission_is_one_json(ranks, data, tmp_path):
    root, weights = data
    port_run.main(argv(VQA, vqa_over(root, weights, tmp_path), True))
    with open(os.path.join(only_dir(tmp_path), "vqa_submit_weights.json")) \
            as f:
        want = json.load(f)
    got = case(ranks, "vqa")
    for r in got:
        assert "num_devices=1" in r["refused"] and "2 process" in \
            r["refused"]
    files = sorted(os.listdir(got[0]["log_dir"]))
    assert [f for f in files if f.startswith("vqa_submit")] == \
        ["vqa_submit_weights.json"]
    with open(os.path.join(got[0]["log_dir"], "vqa_submit_weights.json")) \
            as f:
        merged = json.load(f)

    def key(r):
        return r["question_id"]
    assert want and sorted(merged, key=key) == sorted(want, key=key)


def test_metrics_reduce_across_ranks(ranks):
    for r, g in enumerate(case(ranks, "reduce")):
        assert g["world"] == WORLD
        assert g["sums"]["dev_nlvr2_correct"] == 3.0
        assert g["sums"]["dev_nlvr2_count"] == 4.0
        assert g["sums"]["test_nlvr2_count"] == 0.0
        assert g["sums"]["x_loss"] == float(r)   # not a named tally
        assert g["reduce_sum"] == {"a": 1.0, "b": 2.0}
        assert g["reduce_mean"] == {"a": 0.5, "b": 1.0}
        assert g["objects"] == [["r"], ["r", "r"]]
        assert g["metrics"] == {"x_loss": 0.5, "x_correct": 3.0,
                                "x_count": 8.0}
        assert g["rows"] == slice(8 * r, 8 * r + 8)


def test_checkpoint_resume_at_world_2(ranks):
    got = case(ranks, "resume")
    for r, g in enumerate(got):
        assert [s for s, _ in g["whole"]] == [1, 2, 3, 4]
        assert g["first"] + g["rest"] == g["whole"], r
        assert g["step"] == 4 and g["params_equal"], r
    assert got[0]["whole"] == got[1]["whole"]
    # rank 0 writes every checkpoint file, rank 1 none
    assert got[1]["writes"] == []
    assert {"weights.ckpt", "state.pt.tmp"} <= set(got[0]["writes"])


ENVS = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "h:1"},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "3",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.1",
     "MASTER_PORT": "2222"},
    {"OMPI_COMM_WORLD_SIZE": "2"},
    {"OMPI_COMM_WORLD_SIZE": "1"},
    {"WORLD_SIZE": "4", "RANK": "2", "MASTER_ADDR": "node0"},
]


@pytest.mark.parametrize("env", ENVS)
def test_cluster_spec_from_env_matches_jax(env):
    """The JAX package's mapping with its names for torch's: the
    coordinator address as a tcp:// ``init_method``, ``num_processes`` as
    ``world_size``, ``process_id`` as ``rank``; JAX's own coordinator
    variables name no torch group."""
    want = jmesh.cluster_spec_from_env(env)
    got = mesh.cluster_spec_from_env(env)
    if not want:
        assert got is None
    else:
        assert got == dict(init_method=f"tcp://{want['coordinator_address']}",
                           world_size=want["num_processes"],
                           rank=want["process_id"])


@pytest.mark.parametrize("shape", [(), (7,), (128,), (256, 96), (96, 256),
                                   (30522, 32), (3, 768, 768), (127, 4),
                                   (512, 512)])
@pytest.mark.parametrize("fsdp", [1, 2, 4])
def test_fsdp_spec_matches_jax(shape, fsdp):
    spec = tuple(jmesh._fsdp_spec(shape, fsdp))
    want = spec.index(jmesh.FSDP_AXIS) if jmesh.FSDP_AXIS in spec else None
    assert mesh._fsdp_spec(shape, fsdp) == want


def test_device_mlm_at_world2_matches_one_process(ranks, step_setup,
                                                  jax_ref):
    """(10) The ranks' device MLM masks are one process's over the global
    batch, row for row, and the world-2 step's losses one process's at
    dp_scale 1/2 (the same stochastic-depth table and negatives)."""
    _, cfg, arrays, batch, table, _ = step_setup
    cfg = dict(cfg, **MLM_OVER)
    spec = make_model_spec(cfg)
    tbatch = {k: torch.from_numpy(v) for k, v in mlm_batch(batch).items()}
    want = train_step.device_mlm_batch(
        cfg, spec, tbatch, torch.Generator().manual_seed(cfg["seed"]))
    got = case(ranks, "device_mlm")
    for key, name in (("ids_mlm", "text_ids_mlm"),
                      ("labels", "text_labels_mlm")):
        np.testing.assert_array_equal(
            np.concatenate([g[key] for g in got]), want[name].numpy())
    assert (want["text_labels_mlm"] != -100).sum() > 0
    params = master_params(params_from_numpy(arrays, "cpu"))
    opt = make_optimizer(params, cfg, cfg["max_steps"],
                         make_schedule(cfg, cfg["max_steps"]))
    state = train_step.init_train_state(params, opt, seed=cfg["seed"])
    step = train_step.make_train_step(cfg, spec, opt, dp_scale=1 / WORLD)
    with fixed_draws(table, jax_ref["negatives"], []):
        state, metrics = step(state, tbatch)
    assert got[0]["metrics"] == got[1]["metrics"]
    assert_losses_close(got[0]["metrics"],
                        {k: float(v) for k, v in metrics.items()})
