"""Training orchestration: the fit/validate/test loops (port of
``vl_merging_tpu/train/loop.py``), in one process or one process per
device over a ``torch.distributed`` group.

Replaces the reference's pl.Trainer wiring (reference: src/run.py:141-295)
with an explicit loop: device batches, one train step, periodic
validation with the_metric checkpoint selection (save_top_k=1 + last,
reference run.py:189-195), gradient accumulation derived from the global
batch size (run.py:210-212), resume support, and JSONL logging.

The Trainer runs on the card (``device.rank_device``: ``cuda:
LOCAL_RANK``, or the device the caller names); it runs on the CPU only
when the config says ``use_cpu=True`` (how the JAX package asks, and what
the tests pass).  Over a process group (started before the Trainer, as
``run.py`` does) each rank is one device of the JAX Trainer's mesh, by
its rules: each loader yields this rank's share of a global micro-batch of
``per_device_batch_size`` × world rows, ``accum_steps`` and ``dp_scale``
follow the world size, ``use_sharded_training`` shards params and
optimizer state over an fsdp axis of 2, the recall feeds each rank's row
share of its batches, the validation's host tallies are summed over the
ranks, and rank 0 alone writes the logs and checkpoints.  The Trainer
differs from the JAX one in its resume: the full state is one
``torch.save`` file (``train/checkpointing.py``), and a resumed fit
continues the epoch at the checkpoint's micro-batch, so it takes the
batches the uninterrupted fit takes (the JAX Trainer restarts the epoch).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ckpt import io as ckpt_io
from ..ckpt.convert import eval_cast_params, master_params, \
    params_from_numpy
from ..ckpt.pipeline import load_params
from ..device import rank_device
from ..evaluation.downstream import (nlvr2_logits, nlvr2_split_update,
                                     vqa_predictions, write_vqa_submission)
from ..evaluation.metrics import MetricAccumulator, the_metric
from ..evaluation.retrieval import compute_irtr_recall
from ..models.spec import ModelSpec, Params, make_model_spec
from ..parallel import host
from ..parallel.mesh import (Mesh, broadcast_params, make_mesh,
                             param_shardings, shard_batch, shard_params)
from . import train_step as ts
from .checkpointing import (load_full_params, restore_train_state,
                            save_train_state)
from .optimizer import make_optimizer
from .schedule import make_schedule
from ..utils.logging import EventWriter


ARRAY_KEYS_EXCLUDED = ("text", "qid", "vqa_labels", "vqa_scores",
                       "vqa_answer", "table_name", "iid", "img_index",
                       "cap_index", "raw_index", "replica")


def accum_steps(cfg: Dict, world: Optional[int] = None) -> int:
    """Micro-batches per optimizer step: the config's global batch over the
    per-device batch times the device count (the JAX Trainer's rule; the
    count is ``world``, by default the process group's size)."""
    per_dev = cfg["per_device_batch_size"]
    if not per_dev or per_dev <= 0:
        # the reference makes per_gpu_batchsize mandatory too
        # (config.py:111 "you should define this manually"; run.py:211
        # divides by it)
        raise ValueError(
            "per_device_batch_size must be set (> 0); it is the "
            "reference's per_gpu_batchsize")
    world = host.get_world_size() if world is None else world
    return max(1, cfg["batch_size"] // (per_dev * world))


def fsdp_size(cfg: Dict, world: int) -> int:
    """The fsdp axis of the JAX Trainer's mesh: 2 under
    ``use_sharded_training`` when the device count is even, else 1."""
    return 2 if cfg["use_sharded_training"] and world % 2 == 0 else 1


def build_train_step(cfg: Dict, spec: ModelSpec, params: Params,
                     max_steps: int, *, train_fusion: str = "0",
                     mim_label_fn: Optional[Callable] = None,
                     mesh: Optional[Mesh] = None
                     ) -> Tuple[ts.TrainState, Callable]:
    """(state, step_fn) for ``max_steps`` optimizer steps over ``params``,
    which must be f32 masters (``ckpt/convert.master_params``); step_fn
    updates them in place.  Each step takes a batch with a leading
    ``accum_steps(cfg)`` micro-batch axis when that is above 1.
    ``train_fusion`` ("0", "tail" or "full") is the training fusion level
    and ``mim_label_fn`` the MIM labels' source
    (``train_step.make_train_step``).  ``mesh`` (default: the process
    group with the config's fsdp axis) is the data-parallel group: rank
    0's params are broadcast into every rank's, ``dp_scale`` is 1 / its
    size, and with an fsdp axis above 1 the state holds this rank's
    shards of the params and optimizer moments."""
    mesh = mesh or make_mesh(fsdp=fsdp_size(cfg, host.get_world_size()))
    broadcast_params(params)
    shardings = None
    if mesh.fsdp > 1:
        shardings = param_shardings(params, mesh)
        params = shard_params(params, mesh)
    sched = make_schedule(cfg, max_steps)
    optimizer = make_optimizer(params, cfg, max_steps, sched)
    state = ts.init_train_state(params, optimizer, seed=cfg["seed"],
                                shardings=shardings, mesh=mesh)
    step_fn = ts.make_train_step(cfg, spec, optimizer,
                                 dp_scale=1.0 / mesh.size,
                                 accum_steps=accum_steps(cfg, mesh.size),
                                 train_fusion=train_fusion,
                                 mim_label_fn=mim_label_fn, mesh=mesh)
    return state, step_fn


def pad_to_multiple(batch: Dict, size: int):
    """Pad every batch-leading array up to ``size`` rows by repeating the
    final row; returns ``(padded_batch, n_valid)``.

    Used by the recall so each tower's feeds have one shape.  Repeating a
    real row — instead of zero-filling — keeps the padded rows numerically
    ordinary (an all-zero text_mask row would softmax over -inf).  Callers
    slice outputs back to ``n_valid``.
    """
    n = next(v.shape[0] for v in batch.values()
             if isinstance(v, np.ndarray) and v.ndim >= 1)
    if size <= n:
        return batch, n
    out = {}
    for k, v in batch.items():
        if (isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n
                and v.dtype != object):
            out[k] = np.concatenate(
                [v, np.repeat(v[-1:], size - n, axis=0)], axis=0)
        else:
            out[k] = v
    return out, n


def host_filter(batch: Dict) -> Dict:
    """Numeric host arrays only (python payloads dropped); mixed-task
    batches ({"v": …, "l": …, "vl": …}) recurse per task."""
    feed = {}
    for k, v in batch.items():
        if k in ARRAY_KEYS_EXCLUDED:
            continue
        if isinstance(v, dict):
            feed[k] = host_filter(v)
        elif isinstance(v, np.ndarray) and v.dtype != object:
            feed[k] = v
    return feed


def device_feed(batch: Dict, device) -> Dict:
    """Numeric arrays → tensors on ``device``; python payloads dropped.
    Each keeps its dtype but float64, which becomes float32 (as
    ``jnp.asarray`` gives it in the JAX package): images float32, ids and
    masks int64, MIM positions int32."""
    def put(v):
        t = torch.from_numpy(np.require(v, requirements=("C", "W")))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(device)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else put(v)
                for k, v in d.items()}

    return walk(host_filter(batch))


def vci_to_opt_steps(vci, micro_per_epoch: int, accum_steps: int):
    """Convert ``val_check_interval`` to an optimizer-step cadence.

    Lightning semantics (reference run.py plumbs the raw config value into
    pl.Trainer): a float < 1.0 validates that fraction of the epoch into
    training; 1.0 means epoch-end only (None here — the epoch boundary
    handles it); an int validates every N LOADER batches, which at
    accum_steps micro-batches per optimizer step is N//accum optimizer
    steps."""
    if isinstance(vci, float):
        if vci >= 1.0:
            return None
        return max(1, int(micro_per_epoch * vci) // accum_steps)
    return max(1, int(vci) // accum_steps)


class JsonlLogger:
    """One JSON line of scalars per call, ``{log_dir}/{name}.jsonl``, and
    the same scalars as TensorBoard events under
    ``{log_dir}/tb/{name}/events.out.tfevents.*`` (the JAX package's
    layout, reference run.py:196-199), written by
    ``utils/logging.EventWriter``; a logger with ``write=False`` (the ranks
    other than 0) writes nothing."""

    def __init__(self, log_dir: str, name: str, write: bool = True):
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = self._tb = None
        if write:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(self.path, "a")
            self._tb = EventWriter(os.path.join(log_dir, "tb", name))

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if self._fh is None:
            return
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        for k, v in scalars.items():
            self._tb.add_scalar(k, float(v), step)
        self._tb.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._tb.close()


class Trainer:
    """``device`` names the card (e.g. "cuda:0"; ranks share one card
    only this way); by default ``cuda:LOCAL_RANK``."""

    def __init__(self, cfg: Dict, mim_label_fn=None, device=None):
        self.cfg = cfg
        self.spec: ModelSpec = make_model_spec(cfg)
        world = host.get_world_size()
        self.mesh = make_mesh(num_devices=cfg["num_devices"],
                              fsdp=fsdp_size(cfg, world))
        # the reference's CPU dry-run path (run.py:236-261): only on request
        self.device = (torch.device("cpu") if cfg["use_cpu"]
                       else rank_device(device))
        self.mim_label_fn = mim_label_fn

        params, missing, unexpected = load_params(cfg, self.spec)
        if missing:
            print(f"missing_keys: {missing}")
        if unexpected:
            print(f"unexpected_keys: {unexpected}")
        # f32 masters on the device; the train step updates them in place
        # (under sharded training the state holds this rank's shards of
        # them instead, and ``params`` is None from ``_build_step`` on)
        self.params: Optional[Params] = master_params(
            params_from_numpy(params, self.device))
        del params

        self.accum_steps = accum_steps(cfg, world)
        # this rank's rows of each global micro-batch
        self.local_batch = cfg["per_device_batch_size"]
        self.kernels = ts._resolve_kernels(cfg, self.spec)
        self.eval_fn = ts.make_eval_step(cfg, self.spec,
                                         mim_label_fn=self.mim_label_fn)
        # device_augment's host stream (crop boxes, op choices), offset by
        # the rank so the ranks' draws decorrelate (the JAX Trainer's rule)
        self._aug_rng = np.random.RandomState(
            cfg["seed"] + 7919 * host.get_rank())

        self.exp_name = (f'{cfg["exp_name"]}_seed{cfg["seed"]}'
                         f'_from_{os.path.basename(cfg["load_path"])[:-5]}'
                         if cfg["load_path"] else
                         f'{cfg["exp_name"]}_seed{cfg["seed"]}')
        self.log_dir = os.path.join(cfg["log_dir"], self.exp_name)
        self.logger = JsonlLogger(self.log_dir, "metrics",
                                  write=host.is_main_process())
        self.best_metric = -float("inf")
        # the host's seconds per optimizer step of the last fit, waiting on
        # the loader and on device_feed
        self.host_wait = {"loader_s": 0.0, "feed_s": 0.0, "steps": 0}

    # -- loop construction -------------------------------------------------
    def _resolve_max_steps(self, opt_steps_per_epoch: int) -> int:
        cfg = self.cfg
        if cfg["max_steps"] is not None:
            return cfg["max_steps"]
        return opt_steps_per_epoch * cfg["max_epoch"]

    def gather_params(self) -> Params:
        """The current full params.  Under sharded training the shards
        gathered: a collective that every rank must reach."""
        if self.params is None:
            return self.state.full_params()
        return self.params

    def _build_step(self, max_steps: int):
        self.state, self.step_fn = build_train_step(
            self.cfg, self.spec, self.params, max_steps,
            mim_label_fn=self.mim_label_fn, mesh=self.mesh)
        if self.state.shardings is not None:
            # the state holds this rank's shards: the full masters go
            self.params = None

    def _bind_tokenizer(self, datamodule) -> None:
        """device_mlm: the [MASK] id from the datamodule's tokenizer, unless
        the config names it (bert-base-uncased's 103 without a
        collator)."""
        if self.cfg.get("device_mlm") and \
                self.cfg.get("mask_token_id") is None:
            coll = getattr(datamodule, "mlm_collator", None)
            self.cfg["mask_token_id"] = (
                coll.tokenizer.mask_token_id if coll is not None else 103)

    # -- fit ----------------------------------------------------------------
    def fit(self, datamodule) -> None:
        cfg = self.cfg
        self._bind_tokenizer(datamodule)
        train_loader = datamodule.train_loader(self.local_batch)
        # two step units: the loader yields MICRO-batches; the optimizer
        # advances once per accum_steps of them.  `step`/`max_steps`/
        # val cadence are OPTIMIZER steps; per-epoch loader caps are micro.
        micro_per_epoch = max(1, int(len(train_loader) *
                                     cfg["limit_train_batches"]))
        opt_steps_per_epoch = max(1, micro_per_epoch // self.accum_steps)
        max_steps = self._resolve_max_steps(opt_steps_per_epoch)
        self._build_step(max_steps)
        self._maybe_resume()

        vci_opt = vci_to_opt_steps(cfg["val_check_interval"],
                                   micro_per_epoch, self.accum_steps)

        step = self.state.step
        # a resumed fit starts where the checkpoint's step left the data:
        # each epoch feeds opt_steps_per_epoch optimizer steps (a short
        # tail of micro-batches is dropped at the epoch's end)
        epoch, skip = divmod(step, opt_steps_per_epoch)
        skip *= self.accum_steps
        t_last = time.time()
        train_metrics = MetricAccumulator()
        pending = []  # device-resident per-step metrics; fetched in bulk
        wait = self.host_wait = {"loader_s": 0.0, "feed_s": 0.0, "steps": 0}

        def flush_metrics():
            """ONE host fetch for all buffered steps."""
            if not pending:
                return None
            keys = sorted(pending[0])
            vals = torch.stack(
                [torch.stack([m[k].detach().float() for k in keys])
                 for m in pending]).cpu().numpy()
            for row in vals:
                train_metrics.update(dict(zip(keys, row)))
            pending.clear()
            return dict(zip(keys, vals[-1]))

        done = False
        while not done and epoch < cfg["max_epoch"] * 10:
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch, skip)
            else:
                train_loader.batch_sampler.set_epoch(epoch, skip)
            micro_buf = []
            batches = iter(train_loader)
            i = skip
            skip = 0
            while i < micro_per_epoch:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is not None and cfg.get("device_augment"):
                    # the host side of the device augment: the scalar
                    # draws; the pixels cross the link once, as uint8
                    batch = ts.attach_augment_params(batch, cfg,
                                                     self._aug_rng)
                wait["loader_s"] += time.perf_counter() - t0
                if batch is None:
                    break
                i += 1
                if cfg["fast_dev_run"] and step >= 1:
                    done = True
                    break
                micro_buf.append(batch)
                if len(micro_buf) < self.accum_steps:
                    continue
                t0 = time.perf_counter()
                feed = self._stack_micro(micro_buf)
                wait["feed_s"] += time.perf_counter() - t0
                micro_buf = []

                self.state, metrics = self.step_fn(self.state, feed)
                step += 1
                wait["steps"] += 1
                pending.append(metrics)

                if step % 10 == 0:
                    dt = time.time() - t_last
                    t_last = time.time()
                    scalars = {k: float(v)
                               for k, v in (flush_metrics() or {}).items()}
                    scalars["steps_per_sec"] = 10 / dt
                    self.logger.log(step, scalars)
                    print(f"step {step}/{max_steps} "
                          f"loss={scalars.get('total_loss', 0):.4f} "
                          f"({scalars['steps_per_sec']:.2f} it/s)")

                if step >= max_steps:
                    done = True
                    break
                if vci_opt is not None and step % vci_opt == 0:
                    flush_metrics()
                    self._validate_and_checkpoint(datamodule, step)
            epoch += 1
            if not done or cfg["fast_dev_run"]:
                flush_metrics()
                self._wrapup_train_epoch(train_metrics, step)
                self._validate_and_checkpoint(datamodule, step)
        flush_metrics()
        self._validate_and_checkpoint(datamodule, step, final=True)

    def _stack_micro(self, micro_buf):
        """The optimizer step's feed: one micro-batch as is, or
        (accum, micro, …) stacks (mixed-task feeds nest one dict level per
        task)."""
        if self.accum_steps == 1:
            return device_feed(micro_buf[0], self.device)
        feeds = [host_filter(b) for b in micro_buf]

        def stack(sub):
            return {k: (stack([f[k] for f in sub])
                        if isinstance(sub[0][k], dict) else
                        np.stack([f[k] for f in sub]))
                    for k in sub[0]}

        return device_feed(stack(feeds), self.device)

    def _wrapup_train_epoch(self, acc: MetricAccumulator, step: int) -> None:
        computed = acc.compute()
        if computed:
            self.logger.log(step, {f"train/{k}": v
                                   for k, v in computed.items()
                                   if v is not None})
        acc.reset()

    # -- validation ----------------------------------------------------------
    def _validate_and_checkpoint(self, datamodule, step: int,
                                 final: bool = False) -> None:
        metrics = self.validate(datamodule)
        tm = metrics.get("val/the_metric", 0.0)
        self.logger.log(step, metrics)
        self._save_checkpoint("last")
        if tm >= self.best_metric:
            self.best_metric = tm
            self._save_checkpoint("best")

    @torch.no_grad()
    def validate(self, datamodule) -> Dict[str, float]:
        cfg = self.cfg
        self._bind_tokenizer(datamodule)
        try:
            loader = datamodule.val_loader(self.local_batch)
        except FileNotFoundError:
            return {}
        acc = MetricAccumulator()
        # ITM's hard negatives in eval draw from one stream seeded 0 (the
        # JAX package splits PRNGKey(0) per batch)
        generator = torch.Generator(self.device).manual_seed(0)
        limit = (int(len(loader) * cfg["limit_val_batches"])
                 if cfg["limit_val_batches"] != 1.0 else None)
        params = self.gather_params()
        for i, batch in enumerate(loader):
            if limit is not None and i >= limit:
                break
            # over a process group the sampler wrap-pads the last global
            # batch, so every rank's share has its full rows (the
            # duplicates enter the metrics, as the reference's
            # DistributedSampler wrap does); the JAX Trainer's padding of
            # a global batch to the device count is moot
            feed = device_feed(batch, self.device)
            metrics = self.eval_fn(params, feed, generator)
            # one stacked fetch per batch
            keys = sorted(metrics)
            vals = torch.stack([metrics[k].float() for k in keys]
                               ).cpu().numpy() if keys else []
            metrics = dict(zip(keys, vals))
            if "table_name" in batch and "nlvr2_loss" in metrics:
                lg = nlvr2_logits(params, self.spec, feed,
                                  kernels=self.kernels)
                nlvr2_split_update(acc, lg,
                                   np.asarray(batch["answers"]),
                                   batch["table_name"])
            acc.update(metrics)

        if any("_nlvr2_" in k for k in acc.sums):
            # the only host tallies (fed from each rank's loader share);
            # every step metric is already the global batch's
            acc.cross_process_reduce(
                [f"{s}_nlvr2_{t}" for s in ("dev", "test")
                 for t in ("correct", "count")])
        computed = acc.compute()
        recall = None
        out = {}
        if cfg["get_recall_metric"]:
            # reference computes recall on BOTH splits: val first (logged as
            # recalls/val_avg), then test — the_metric uses the TEST-split
            # r1s (vilt_utils.py:66-79, 101)
            try:
                val_recall = self.recall(datamodule, split="val")
            except FileNotFoundError:
                val_recall = {}
            if val_recall:
                out["recalls/val_avg"] = float(
                    np.mean([val_recall[f"{d}_r{k}"]
                             for d in ("ir", "tr") for k in (1, 5, 10)]))
            recall = self.recall(datamodule, split="test")
            out["recalls/test_avg"] = float(
                np.mean([recall[f"{d}_r{k}"]
                         for d in ("ir", "tr") for k in (1, 5, 10)]))
            computed.update(recall)
        tm = the_metric(cfg["loss_names"], computed, recall)
        out.update({f"val/{k}": v for k, v in computed.items()
                    if v is not None})
        out["val/the_metric"] = tm
        return out

    # -- retrieval recall ----------------------------------------------------
    @torch.no_grad()
    def recall(self, datamodule, split: str = "test") -> Dict[str, float]:
        """Both towers over the split's no-false datasets, in batches of up
        to 256 rows divisible by the world size (the last padded to the
        same shape; features are sliced back to the true counts), each
        rank feeding its row share of every batch (the JAX Trainer's
        rule), then ``compute_irtr_recall``, which gathers the features in
        rank order."""
        dm = datamodule.dms[0]
        make = (dm.make_no_false_val_dset if split == "val"
                else dm.make_no_false_test_dset)
        text_dset = make()
        image_dset = make(image_only=True)
        params = self._eval_cast()

        ndev = self.mesh.size

        def collect(dset):
            bs = min(max(256 // ndev * ndev, ndev),
                     -(-len(dset) // ndev) * ndev)
            batches, ids = [], []
            for start in range(0, len(dset), bs):
                idx = range(start, min(start + bs, len(dset)))
                b = dset.collate([dset[i] for i in idx], dm.mlm_collator)
                ids += list(b["img_index"])
                b, _ = pad_to_multiple(b, bs)
                # ids stay global; each rank feeds its row share
                batches.append(device_feed(shard_batch(host_filter(b),
                                                       self.mesh),
                                           self.device))
            return batches, ids

        text_batches, tiids = collect(text_dset)
        image_batches, iids = collect(image_dset)
        return compute_irtr_recall(
            params, self.spec, text_batches, image_batches,
            np.asarray(tiids), np.asarray(iids),
            itm_rerank_topk=self.cfg["itm_rerank_topk"])

    def _eval_cast(self) -> Params:
        return eval_cast_params(
            {k: v.detach() for k, v in self.gather_params().items()},
            self.spec, self.cfg)

    # -- test ----------------------------------------------------------------
    @torch.no_grad()
    def test(self, datamodule) -> Dict[str, float]:
        cfg = self.cfg
        self._bind_tokenizer(datamodule)
        results: Dict[str, float] = {}
        if cfg["loss_names"]["vqa"] > 0:
            id2answer = getattr(datamodule.dms[0], "id2answer", None)
            if id2answer is not None:
                params = self._eval_cast()

                def feeds():
                    # stream batches through the predictions: the whole
                    # test split on the card at once would not fit
                    for batch in datamodule.test_loader(self.local_batch):
                        feed = device_feed(batch, self.device)
                        feed["qid"] = batch["qid"]
                        yield feed

                rets = vqa_predictions(
                    params, self.spec, feeds(), id2answer,
                    scan_k=int(cfg.get("eval_scan_k", 1)))
                model_name = os.path.basename(cfg["load_path"])[:-5] \
                    if cfg["load_path"] else self.exp_name
                path = write_vqa_submission(rets, model_name, self.log_dir)
                if path:
                    print(f"vqa submission: {path}")
        results.update(self.validate(datamodule))
        return results

    # -- checkpointing -------------------------------------------------------
    def _ckpt_dir(self, tag: str) -> str:
        return os.path.join(self.log_dir, "checkpoints", tag)

    def _save_checkpoint(self, tag: str) -> None:
        """Every rank reaches the gathers of a sharded state; rank 0 alone
        writes, and the ranks leave together (a barrier), so a resume on
        any rank reads whole files."""
        params = self.gather_params()
        if host.is_main_process():
            sd = ckpt_io.params_to_state_dict(params)
            os.makedirs(self._ckpt_dir(tag), exist_ok=True)
            ckpt_io.save_torch_checkpoint(
                sd, os.path.join(self._ckpt_dir(tag), "weights.ckpt"))
            with open(os.path.join(self._ckpt_dir(tag), "meta.json"),
                      "w") as f:
                json.dump({"step": self.state.step,
                           "best_metric": self.best_metric}, f)
        if tag == "last":  # the full-state resume point
            save_train_state(self.state,
                             os.path.join(self._ckpt_dir(tag), "state.pt"))
        host.synchronize()

    def _maybe_resume(self) -> None:
        cfg = self.cfg
        path = None
        if cfg["resume_from"]:
            path = cfg["resume_from"]
        elif cfg["resume_during_pretraining"]:
            cand = os.path.join(self._ckpt_dir("last"), "weights.ckpt")
            if os.path.exists(cand):
                path = cand
        if not path:
            return
        meta_path = os.path.join(os.path.dirname(path), "meta.json")
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        self.best_metric = meta.get("best_metric", self.best_metric)
        # prefer the full state (optimizer, generator) next to the weights
        full = os.path.join(os.path.dirname(path), "state.pt")
        if os.path.isfile(full):
            self.state = restore_train_state(full, self.state)
            print(f"resumed full state from {full} at step {self.state.step}")
            return
        sd = ckpt_io.load_torch_checkpoint(path)
        loaded, _, _ = ckpt_io.state_dict_to_params(sd, self.spec)
        load_full_params(self.state, loaded)
        step = meta.get("step", 0)
        self.state = dataclasses.replace(self.state, step=step)
        print(f"resumed weights from {path} at step {step}")
