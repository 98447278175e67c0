"""The ranks of ``test_torch_port_distributed.py``: one process each of a
two-rank gloo group on the CPU, started by ``torch.multiprocessing``.

Imports no JAX (the test process does).  ``run`` starts the group from a
file store, runs every case in order on its rank and saves what the test
compares to ``{out_dir}/rank{rank}.pt``: a dict of case name to results,
or to ``{"error": traceback}`` when the case raised (the other cases still
run; a case that raised on one rank only would stall the group's next
collective, so the test bounds the run's time).
"""

import contextlib
import functools
import os
import traceback

import numpy as np
import torch

from vl_merging_tpu_torch.utils.profiling import storage_bytes


def case_gather(rank, world):
    """(4) The autograd gather against the reference semantics on a
    hand-made loss, and ``torch.distributed.nn.functional.all_gather``."""
    import torch.distributed.nn.functional as dnn

    from vl_merging_tpu_torch.parallel import host

    x = (torch.arange(6, dtype=torch.float64).reshape(3, 2) + 10 * rank
         ).requires_grad_()
    c = torch.arange(world * 6, dtype=torch.float64).reshape(world * 3, 2)

    def loss_of(g):
        return (c * g ** 2).sum()

    (mine,) = torch.autograd.grad(loss_of(host.all_gather_with_grad(x)), x)
    (theirs,) = torch.autograd.grad(loss_of(torch.cat(dnn.all_gather(x))), x)
    gathered = host.all_gather_with_grad(x).detach()
    return {"x": x.detach(), "c": c, "mine": mine, "theirs": theirs,
            "gathered": gathered}


def case_reduce(rank, world):
    """(7) ``cross_process_reduce``, ``reduce_dict``, ``all_gather_objects``
    and the steps' ``reduce_metrics``."""
    from vl_merging_tpu_torch.evaluation.metrics import MetricAccumulator
    from vl_merging_tpu_torch.parallel import host
    from vl_merging_tpu_torch.train.train_step import reduce_metrics

    acc = MetricAccumulator()
    acc.update({"dev_nlvr2_correct": float(rank + 1),
                "dev_nlvr2_count": 2.0, "x_loss": float(rank)})
    acc.cross_process_reduce(["dev_nlvr2_correct", "dev_nlvr2_count",
                              "test_nlvr2_count"])
    return {
        "sums": dict(acc.sums),
        "reduce_sum": host.reduce_dict({"a": float(rank), "b": 1.0},
                                       average=False),
        "reduce_mean": host.reduce_dict({"a": float(rank), "b": 1.0}),
        "objects": host.all_gather_objects(["r"] * (rank + 1)),
        "metrics": {k: float(v) for k, v in reduce_metrics({
            "x_loss": torch.tensor(float(rank)),
            "x_correct": torch.tensor(rank + 1),
            "x_count": torch.tensor(4)}).items()},
        "rows": host.process_rows(16),
        "world": host.get_world_size(),
    }


@contextlib.contextmanager
def fixed_draws(table, negatives, sims):
    """The step's draws as the test gives them: ``table`` (the global
    (L, 2, B) stochastic-depth table) for every pass, no text dropout,
    ``negatives`` (the global hard negatives) for ITM, whose sims are
    appended to ``sims``."""
    from vl_merging_tpu_torch.models import model
    from vl_merging_tpu_torch.train import objectives

    saved = (model._dp_scale_table, model.dropout,
             objectives.sample_hard_negatives)

    def negs(sim_i2t, sim_t2i, generator):
        sims.append((sim_i2t.detach().clone(), sim_t2i.detach().clone()))
        return tuple(torch.as_tensor(n) for n in negatives)

    model._dp_scale_table = functools.partial(saved[0], table=table)
    model.dropout = lambda x, *a, **k: x
    objectives.sample_hard_negatives = negs
    try:
        yield
    finally:
        (model._dp_scale_table, model.dropout,
         objectives.sample_hard_negatives) = saved


@contextlib.contextmanager
def step_draws(table, negatives, stage):
    """The context of ``graft_entry.dryrun_multichip``'s stage ``stage``:
    ``fixed_draws`` around the train step, and rank 0's gradients and
    states kept (``graft_entry.kept_states``) in what it yields."""
    from vl_merging_tpu_torch.graft_entry import kept_states

    with kept_states(stage) as extra:
        with fixed_draws(table, negatives, []) if stage == "step" else \
                contextlib.nullcontext():
            yield extra


def case_steps(rank, world, job):
    """(1)-(3) The averaged gradients of the step, and one train step over
    this rank's rows of the global batch, data-parallel and sharded."""
    from vl_merging_tpu_torch.ckpt.convert import master_params, \
        params_from_numpy
    from vl_merging_tpu_torch.models.spec import make_model_spec
    from vl_merging_tpu_torch.parallel import host
    from vl_merging_tpu_torch.parallel.mesh import average_grads, make_mesh
    from vl_merging_tpu_torch.train import train_step
    from vl_merging_tpu_torch.train.loop import build_train_step

    cfg = job["step_cfg"]
    spec = make_model_spec(cfg)
    rows = host.process_rows(len(job["batch"]["text_ids"]))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
             for k, v in job["batch"].items()}
    # the step's averaged gradients
    with fixed_draws(job["table"], job["negatives"], []):
        _, _, grads = train_step.loss_and_grads(
            master_params(params_from_numpy(job["arrays"], "cpu")), spec,
            cfg, batch, torch.Generator().manual_seed(cfg["seed"]),
            kernels=False, dp_scale=1 / world)
    average_grads(grads, make_mesh())
    out = {"grads": {k: v.numpy() for k, v in grads.items()}}
    for name, sharded in (("dp", False), ("sharded", True)):
        c = dict(cfg, use_sharded_training=sharded)
        sims = []
        with fixed_draws(job["table"], job["negatives"], sims):
            state, step = build_train_step(
                c, spec, master_params(params_from_numpy(job["arrays"],
                                                         "cpu")),
                c["max_steps"])
            shapes = {k: tuple(v.shape) for k, v in state.params.items()}
            held = storage_bytes([state.params, state.opt_state.mu,
                                  state.opt_state.nu])
            state, metrics = step(state, batch)
        out[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().numpy().copy()
                       for k, v in state.full_params().items()},
            "shapes": shapes, "held_bytes": held,
            "mesh": (state.mesh.data, state.mesh.fsdp),
            "sims": [s.numpy() for s in sims[0]],
        }
    return out


def case_device_mlm(rank, world, job):
    """(10) The device-side MLM masks of this rank's rows (``device_mlm``,
    drawn from the step's generator), and one data-parallel step that
    derives them."""
    from vl_merging_tpu_torch.ckpt.convert import master_params, \
        params_from_numpy
    from vl_merging_tpu_torch.models.spec import make_model_spec
    from vl_merging_tpu_torch.parallel import host
    from vl_merging_tpu_torch.train import train_step
    from vl_merging_tpu_torch.train.loop import build_train_step

    cfg = dict(job["step_cfg"], **job["mlm_over"])
    spec = make_model_spec(cfg)
    rows = host.process_rows(len(job["batch"]["text_ids"]))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
             for k, v in job["mlm_batch"].items()}
    masked = train_step.device_mlm_batch(
        cfg, spec, batch, torch.Generator().manual_seed(cfg["seed"]))
    with fixed_draws(job["table"], job["negatives"], []):
        state, step = build_train_step(
            cfg, spec, master_params(params_from_numpy(job["arrays"], "cpu")),
            cfg["max_steps"])
        state, metrics = step(state, batch)
    return {"ids_mlm": masked["text_ids_mlm"].numpy(),
            "labels": masked["text_labels_mlm"].numpy(),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def case_recall(rank, world, job):
    """(5) ``Trainer.recall`` at world 2."""
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.data.datamodule import MTDataModule
    from vl_merging_tpu_torch.train.loop import Trainer

    cfg = build_config(*job["irtr"], overrides=job["recall_over"])
    trainer = Trainer(cfg)
    out = trainer.recall(MTDataModule(cfg), split="test")
    trainer.logger.close()
    return out


def case_vqa(rank, world, job):
    """(6) The VQA submission of ``run.main(test_only)`` at world 2, and
    ``num_devices=1`` refused."""
    from vl_merging_tpu_torch import run

    try:
        run.main(job["vqa_argv_one"])
        refused = None
    except ValueError as e:
        refused = str(e)
    trainer = run.main(job["vqa_argv"])
    return {"refused": refused, "log_dir": trainer.log_dir}


def case_resume(rank, world, job):
    """(8) A fit stopped after its step-2 checkpoint and resumed from it
    at world 2 against an uninterrupted 4-step fit; who writes what."""
    from vl_merging_tpu_torch.ckpt import io as ckpt_io
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.data.datamodule import MTDataModule
    from vl_merging_tpu_torch.train import loop

    class Stop(Exception):
        pass

    writes = []

    def fit(log_dir, stop_at=None, **more):
        cfg = build_config(*job["irtr"], overrides=dict(
            job["resume_over"], log_dir=log_dir, **more))
        trainer = loop.Trainer(cfg)
        losses = []

        def build_step(max_steps):
            loop.Trainer._build_step(trainer, max_steps)
            step_fn = trainer.step_fn

            def step(state, feed):
                state, m = step_fn(state, feed)
                losses.append((state.step, m["total_loss"].item()))
                return state, m
            trainer.step_fn = step

        def validate_and_checkpoint(dm, step, final=False):
            loop.Trainer._validate_and_checkpoint(trainer, dm, step, final)
            if step == stop_at:
                raise Stop

        trainer._build_step = build_step
        trainer._validate_and_checkpoint = validate_and_checkpoint
        try:
            trainer.fit(MTDataModule(cfg))
        except Stop:
            pass
        trainer.logger.close()
        return trainer, losses

    save_ckpt, save = ckpt_io.save_torch_checkpoint, torch.save

    def record_ckpt(sd, path):
        writes.append(os.path.basename(path))
        return save_ckpt(sd, path)

    def record_save(obj, path, *a, **k):
        writes.append(os.path.basename(str(path)))
        return save(obj, path, *a, **k)

    ckpt_io.save_torch_checkpoint, torch.save = record_ckpt, record_save
    try:
        whole, whole_losses = fit(os.path.join(job["tmp"], "whole"))
        _, first = fit(os.path.join(job["tmp"], "parts"), stop_at=2)
        resumed, rest = fit(os.path.join(job["tmp"], "parts"),
                            resume_during_pretraining=True)
    finally:
        ckpt_io.save_torch_checkpoint, torch.save = save_ckpt, save
    same = all(torch.equal(resumed.params[k], v)
               for k, v in whole.params.items())
    return {"whole": whole_losses, "first": first, "rest": rest,
            "step": resumed.state.step, "params_equal": same,
            "writes": writes}


CASES = {"gather": case_gather, "reduce": case_reduce}
JOB_CASES = {"steps": case_steps, "recall": case_recall, "vqa": case_vqa,
             "resume": case_resume, "device_mlm": case_device_mlm}


def run(rank, world, init_file, job_path, out_dir, cases=None):
    """Every case (or those named in ``cases``) on this rank, with the job
    that the test saved to ``job_path``."""
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    from vl_merging_tpu_torch import parallel

    parallel.initialize("gloo", use_cpu=True,
                        init_method=f"file://{init_file}",
                        world_size=world, rank=rank)
    out = {}
    for name, fn in list(CASES.items()) + list(JOB_CASES.items()):
        if cases is not None and name not in cases:
            continue
        try:
            out[name] = (fn(rank, world) if name in CASES
                         else fn(rank, world, job))
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
