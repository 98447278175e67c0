"""Driver entry points: the flagship model's forward and the multi-device
dry run (the port's counterpart of the repository's ``__graft_entry__.py``).

``entry`` returns the fused forward of ViT-B/16 MoME (``all_moe``, bf16)
and its example arguments.  ``dryrun_multichip`` starts a process group of
``n_devices`` ranks (``torch.multiprocessing``, spawned, a file store in a
temporary directory) on a (data, fsdp) mesh and runs on every rank, each
stage on the port's own functions:

  (a) one pretrain step (mlm + ifm + itm with global hard negatives) of
      ``build_train_step``, sharded over the fsdp axis
      (``use_sharded_training``) when it is 2;
  (b) the retrieval recall with the towers' rows sharded over the ranks;
  (c) the trained state gathered to the host, merged into the ufo layout
      (``merging/core.merge_weights``, ratio 0.5), sharded again and
      gathered, and the recall of the merged model;
  (d) VQA predictions over two sharded batches and the submission json,
      written by rank 0 and read back.

Both run on the card unless the caller asks for the CPU (``device="cpu"``);
nothing falls back to the CPU on its own.  ``python -m
vl_merging_tpu_torch.graft_entry [n] [--device cpu]`` runs the dry run.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .ckpt.convert import eval_cast_params, master_params, params_to_numpy
from .config import build_config
from .device import rank_device, require_cuda
from .evaluation.downstream import vqa_predictions, write_vqa_submission
from .evaluation.retrieval import compute_irtr_recall
from .merging.core import merge_weights
from .models import model
from .models.spec import ModelSpec, Params, init_params, make_model_spec, \
    param_shapes
from .parallel import host
from .parallel.mesh import Mesh, gather_params, make_mesh, \
    param_shardings, shard_batch, shard_params
from .train.loop import build_train_step
from .utils.profiling import collective_time, storage_bytes

PRETRAIN = "task_mlm_itm_ifm_square_randaug_base"
DRYRUN_TINY = "task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl"
DRYRUN_FULL = "task_mlm_itm_ifm_square_randaug_base_vl"
VQA = "task_finetune_vqa_square_randaug_base_image384_ufo"
STAGES = ("step", "recall", "merge", "vqa")
# the dry run's train steps: the first gives the stage's metrics, the
# second its time (``TIMED_STEP``), the third runs inside
# ``collective_time`` for the share spent in collectives
DRYRUN_STEPS, TIMED_STEP = 3, 1
# rows a rank: the tiny dry run's (2 a device, as the JAX package's) and
# the full-width one's
TINY_ROWS, FULL_ROWS = 2, 8


def tiny_overrides(**extra) -> Dict:
    """The dry run's tiny shapes (hidden 64, 2 heads, 4 layers, 64-px
    images in 16-px patches, 8 text tokens)."""
    over = dict(
        hidden_size=64, num_heads=2, num_layers=4, image_size=64,
        patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
        vlffn_start_layer_index=2, precision="bf16", warmup_steps=0,
        max_steps=100, max_vl_text_len=None,
    )
    over.update(extra)
    return over


def make_batch(spec: ModelSpec, bsz: int, seed: int = 0
               ) -> Dict[str, torch.Tensor]:
    """A seeded pretrain batch on the CPU: random token ids (unmasked
    inputs, 15% of them as MLM labels), full text masks and normal
    images."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, spec.vocab_size, (bsz, spec.max_text_len))
    labels = np.where(rng.rand(bsz, spec.max_text_len) < 0.15, ids, -100)
    ids = torch.from_numpy(ids.astype(np.int32))
    image = rng.randn(bsz, 3, spec.image_size, spec.image_size)
    return {
        "text_ids": ids,
        "text_ids_mlm": ids.clone(),
        "text_labels_mlm": torch.from_numpy(labels.astype(np.int32)),
        "text_masks": torch.ones(bsz, spec.max_text_len, dtype=torch.int32),
        "image": torch.from_numpy(image.astype(np.float32)),
    }


def seeded_params(spec: ModelSpec, device, seed: int = 0) -> Params:
    """The f32 params of ``init_params`` under ``seed``, on ``device``."""
    params = init_params(spec, torch.Generator().manual_seed(seed))
    return {k: v.to(device) for k, v in params.items()}


def _device(device) -> torch.device:
    """The caller's device: the current card when None (raises without
    one), else the one named."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def entry(overrides: Optional[Dict] = None, device=None):
    """The fused forward on the flagship model (ViT-B/16 MoME all_moe,
    bf16, ``overrides`` over the config): returns (fn, (params, batch)),
    fn(params, batch) -> the cls features of ``model.infer`` over a seeded
    batch of 4.  On the card unless ``device`` names another."""
    dev = _device(device)
    cfg = build_config(PRETRAIN, "all_moe", overrides=dict(
        {"precision": "bf16"}, **(overrides or {})))
    spec = make_model_spec(cfg)
    params = seeded_params(spec, dev)
    batch = {k: v.to(dev) for k, v in make_batch(spec, bsz=4).items()}

    @torch.no_grad()
    def fn(params, batch):
        return model.infer(params, spec, batch)["cls_feats"]

    return fn, (params, batch)


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------

def dryrun_configs(n_devices: int, *, full_width: bool = False,
                   overrides: Optional[Dict] = None) -> Dict[str, Dict]:
    """The dry run's configs: "step" (the pretrain, all_moe, sharded when
    the fsdp axis is 2), "ufo" (the merge's target) and "vqa".  Tiny by
    default (``tiny_overrides``, 2 rows a device); at ``full_width`` the
    base_vl pretrain (ViT-B/16 @224, 12 layers, 40 text tokens; 8 rows a
    device, the attention and MLP kernels on) and VQA @384."""
    fsdp = 2 if n_devices % 2 == 0 else 1
    rows = FULL_ROWS if full_width else TINY_ROWS
    step = dict(use_sharded_training=fsdp > 1, per_device_batch_size=rows,
                batch_size=rows * n_devices)
    if full_width:
        name = DRYRUN_FULL
        base = dict(precision="bf16", warmup_steps=0, max_steps=100,
                    pallas_attention=True)
        vqa = dict(base)
    else:
        name = DRYRUN_TINY
        base = tiny_overrides()
        vqa = tiny_overrides(vqav2_label_size=16, image_size=64)
    extra = overrides or {}
    return {"step": build_config(name, "all_moe",
                                 overrides=dict(base, **step, **extra)),
            "ufo": build_config(name, "ufo",
                                overrides=dict(base, **step, **extra)),
            "vqa": build_config(VQA, overrides=dict(vqa, **extra))}


def state_digest(state: Dict[str, np.ndarray]) -> str:
    """SHA-256 over a host state's names, dtypes, shapes and bytes, in
    name order."""
    h = hashlib.sha256()
    for k in sorted(state):
        v = np.ascontiguousarray(state[k])
        h.update(f"{k}|{v.dtype.str}|{v.shape}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _resharded(params: Params, mesh: Mesh) -> Params:
    """``params`` sharded onto the mesh's fsdp axis and gathered again: the
    full params every rank's towers take, bit-equal to ``params``."""
    axes = param_shardings(params, mesh)
    full = gather_params(shard_params(params, mesh), axes, mesh)
    bad = [k for k, v in params.items() if not torch.equal(full[k], v)]
    if bad:
        raise AssertionError(f"re-sharded params differ: {bad[:4]}")
    return full


def _on(batch: Dict, mesh: Optional[Mesh], dev) -> Dict:
    """This rank's rows of ``batch`` on ``dev`` (all of them when
    ``mesh`` is None)."""
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    return {k: v.to(dev) for k, v in batch.items()}


def eval_batches(spec: ModelSpec, rows: int, mesh: Optional[Mesh], dev,
                 seed: int = 1):
    """The recall's one text and one image batch (this rank's rows of
    ``rows``; all of them when ``mesh`` is None) and the ids of the global
    rows."""
    eb = make_batch(spec, rows, seed=seed)
    text = _on({"text_ids": eb["text_ids"],
                "text_masks": eb["text_masks"]}, mesh, dev)
    image = _on({"image": eb["image"]}, mesh, dev)
    return [text], [image], np.arange(rows)


def vqa_feeds(spec: ModelSpec, n_q: int, mesh: Optional[Mesh], dev,
              batches: int = 2) -> List[Dict]:
    """``batches`` seeded VQA feeds of ``n_q`` questions (this rank's rows
    on ``mesh``; all of them when None) with their global question ids."""
    out = []
    for j in range(batches):
        b = make_batch(spec, n_q, seed=10 + j)
        feed = _on({k: b[k] for k in ("text_ids", "text_masks", "image")},
                   mesh, dev)
        qids = list(range(j * n_q, (j + 1) * n_q))
        feed["qid"] = qids if mesh is None else \
            qids[host.process_rows(n_q)]
        out.append(feed)
    return out


def vqa_answers(spec: ModelSpec) -> Dict[int, str]:
    return {i: f"answer_{i}" for i in range(spec.vqav2_label_size)}


@contextlib.contextmanager
def _no_context(stage: str):
    yield {}


def _host_tensors(tree: Dict) -> Dict[str, torch.Tensor]:
    """``tree`` (tensors or numpy arrays) as CPU tensors: their files load
    fast, where pickled numpy does not."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v.detach().cpu()
            for k, v in tree.items()}


@contextlib.contextmanager
def _wrapped(owner, name: str, wrap: Callable):
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def kept_states(stage: str):
    """A stage context for ``dryrun_multichip(stage_context=...)`` (or one
    to nest in another) that keeps rank 0's states, as CPU tensors, in
    the dict it yields: in "step" the first step's reduced gradients,
    gathered over the fsdp axis ("grads"), as the update takes them; in
    "merge" the trained host state and the merged one ("trained",
    "merged").  Every rank joins the gradients' gather."""
    from .train import train_step

    extra, seen = {}, set()
    main = host.is_main_process()

    def norm_spy(real):                 # the step's norm of the reduced grads
        def norm(grads, *sharding):
            if "grads" not in seen:
                seen.add("grads")
                full = gather_params(grads, *sharding) if sharding else grads
                if main:
                    extra["grads"] = _host_tensors(full)
            return real(grads, *sharding)
        return norm

    def merge_spy(real):
        def merge(host_state, **kwargs):
            merged = real(host_state, **kwargs)
            if main:
                extra.update(trained=_host_tensors(host_state),
                             merged=_host_tensors(merged))
            return merged
        return merge

    spies = {"step": [(train_step, "global_sq_norm", norm_spy),
                      (train_step, "global_norm", norm_spy)],
             "merge": [(sys.modules[__name__], "merge_weights", merge_spy)]}
    with contextlib.ExitStack() as stack:
        for owner, name, spy in spies.get(stage, []):
            stack.enter_context(_wrapped(owner, name, spy))
        yield extra


def _step_stage(cfgs, mesh: Mesh, dev, rows: int, world: int) -> tuple:
    cfg = cfgs["step"]
    spec = make_model_spec(cfg)
    t0 = time.perf_counter()
    # rank 0's seeded params: build_train_step broadcasts them into the
    # other ranks' storage, made in init_params's order
    base = seeded_params(spec, dev) if host.get_rank() == 0 else {
        k: torch.empty(shape, device=dev)
        for k, shape in sorted(param_shapes(spec).items())}
    full_bytes = 3 * 4 * sum(v.numel() for v in base.values())
    t1 = time.perf_counter()
    state, step = build_train_step(cfg, spec, master_params(base),
                                   cfg["max_steps"], mesh=mesh)
    _sync(dev)
    setup = {"params": t1 - t0, "build": time.perf_counter() - t1}
    del base
    trees = (state.params, state.opt_state.mu, state.opt_state.nu)
    held = storage_bytes(trees)
    shards = sum(v.numel() * v.element_size() for t in trees
                 for v in t.values())
    batch = _on(make_batch(spec, rows * world), mesh, dev)
    step_ms, first = [], None
    for i in range(DRYRUN_STEPS):
        timed = collective_time(dev) if i == DRYRUN_STEPS - 1 else \
            contextlib.nullcontext()
        _sync(dev)
        t0 = time.perf_counter()
        with timed as spent:
            state, metrics = step(state, batch)
            _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for k, v in metrics.items()
                   if k.endswith("_loss")):
            raise FloatingPointError(f"a loss is not finite: {metrics}")
        first = first or metrics
    out = {"metrics": first, "step_ms": step_ms,
           "timed_ms": step_ms[TIMED_STEP],
           "collective_ms": spent["ms"], "collective_calls": spent["calls"],
           "collective_share": spent["ms"] / step_ms[-1],
           "held_bytes": held, "shard_bytes": shards,
           "full_bytes": full_bytes,
           "sharded": sum(a is not None for a in
                          (state.shardings or {}).values()),
           "params": len(state.params), "setup_s": setup}
    return state, spec, out


def _recall(params: Params, spec: ModelSpec, cfg: Dict, rows: int,
            mesh: Mesh, dev) -> Dict[str, float]:
    text, image, ids = eval_batches(spec, rows, mesh, dev)
    rec = compute_irtr_recall(eval_cast_params(params, spec, cfg), spec,
                              text, image, ids, ids)
    if not all(0.0 <= v <= 1.0 for v in rec.values()):
        raise AssertionError(f"recall out of [0, 1]: {rec}")
    return rec


def merge_to_ufo(host_state: Dict[str, np.ndarray], cfgs) -> tuple:
    """The ufo state merged from ``host_state`` (ratio 0.5), and the
    ufo params (every ufo key, f32) made of it."""
    cfg = cfgs["step"]
    merged = merge_weights(
        host_state, num_layers=cfg["num_layers"],
        vlffn_start_layer_index=cfg["vlffn_start_layer_index"],
        loss_names=cfg["loss_names"], merge_ratio=0.5)
    spec_ufo = make_model_spec(cfgs["ufo"])
    keys = param_shapes(spec_ufo)
    missing = [k for k in keys if k not in merged]
    if missing:
        raise KeyError(f"the merged state lacks ufo keys: {missing[:5]}")
    return merged, spec_ufo, {
        k: torch.from_numpy(np.ascontiguousarray(merged[k], np.float32))
        for k in keys}


def dryrun_rank(rank: int, n_devices: int, tmp: str, opts: Dict) -> None:
    """One rank of ``dryrun_multichip``: starts its group from the file
    store in ``tmp``, runs the stages and saves its figures to
    ``{tmp}/rank{rank}.pt``."""
    from . import parallel

    entered = time.time()
    world = n_devices
    if opts["device"] is not None and \
            torch.device(opts["device"]).type == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        if opts["device"] is None:
            os.environ["LOCAL_RANK"] = str(rank)
        dev = rank_device(opts["device"])
    parallel.initialize(opts["backend"], init_method=f"file://{tmp}/store",
                        world_size=world, rank=rank)
    cfgs = dryrun_configs(world, full_width=opts["full_width"],
                          overrides=opts["overrides"])
    fsdp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(num_devices=world, fsdp=fsdp)
    rows = (FULL_ROWS if opts["full_width"] else TINY_ROWS) * world
    context = opts["stage_context"] or _no_context
    main = host.is_main_process()
    out = {"rank": rank, "world": world, "mesh": (mesh.data, mesh.fsdp),
           "device": str(dev), "backend": torch.distributed.get_backend(),
           "seconds": {}, "extra": {},
           "clock": {"entered": entered, "ready": time.time()}}
    tag = f"dryrun_multichip({world})"

    def stage(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        with context(name) as extra:
            got = fn()
            _sync(dev)
        out["seconds"][name] = time.perf_counter() - t0
        out["extra"][name] = extra if isinstance(extra, dict) else {}
        return got

    # (a) the pretrain step
    state, spec, out["step"] = stage("step", lambda: _step_stage(
        cfgs, mesh, dev, rows // world, world))
    if main:
        print(f"{tag}: mesh={{'data': {mesh.data}, 'fsdp': {mesh.fsdp}}} "
              f"total_loss={out['step']['metrics']['total_loss']:.3f} ok",
              flush=True)

    # (b) the recall, the towers' rows sharded over the ranks
    full = {k: v.detach() for k, v in state.full_params().items()}
    del state
    out["recall"] = rec = stage("recall", lambda: _recall(
        full, spec, cfgs["step"], rows, mesh, dev))
    if main:
        print(f"{tag}: sharded recall ir_r1={rec['ir_r1']:.3f} "
              f"tr_r1={rec['tr_r1']:.3f} ok", flush=True)

    # (c) gather to the host, merge into ufo, shard again, recall
    def merge_stage():
        merged, spec_ufo, ufo = merge_to_ufo(params_to_numpy(full), cfgs)
        params = _resharded({k: v.to(dev) for k, v in ufo.items()}, mesh)
        rec = _recall(params, spec_ufo, cfgs["ufo"], rows, mesh, dev)
        return merged, rec

    merged, rec = stage("merge", merge_stage)
    del full
    out["merged_recall"] = rec
    out["merged_digest"] = state_digest(merged)
    if main:
        print(f"{tag}: merged-ufo sharded recall ir_r1={rec['ir_r1']:.3f} "
              f"tr_r1={rec['tr_r1']:.3f} ok", flush=True)

    # (d) VQA predictions over two sharded batches, the submission
    def vqa_stage():
        cfg = cfgs["vqa"]
        spec_vqa = make_model_spec(cfg)
        params = eval_cast_params(
            _resharded(seeded_params(spec_vqa, dev), mesh), spec_vqa, cfg)
        n_q = rows
        rets = vqa_predictions(params, spec_vqa,
                               vqa_feeds(spec_vqa, n_q, mesh, dev),
                               vqa_answers(spec_vqa), scan_k=2)
        if len(rets) != 2 * n_q // world or not all(r["answer"]
                                                     for r in rets):
            raise AssertionError(f"VQA predictions: {rets[:3]}")
        path = write_vqa_submission(rets, "dryrun",
                                    os.path.join(tmp, "vqa"))
        everyone = [r for part in host.all_gather_objects(rets)
                    for r in part]
        written = None
        if main:
            with open(path) as fp:
                written = json.load(fp)
            if written != everyone:
                raise AssertionError("the submission read back differs "
                                     "from the ranks' predictions")
        return rets, written

    out["rets"], out["submission"] = stage("vqa", vqa_stage)
    if main:
        print(f"{tag}: sharded VQA predict x{len(out['submission'])} + "
              f"submission write ok", flush=True)
    out["clock"]["done"] = time.time()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device=None,
                     backend: Optional[str] = None,
                     overrides: Optional[Dict] = None,
                     full_width: bool = False,
                     stage_context: Optional[Callable] = None
                     ) -> List[Dict]:
    """Run the dry run's stages on ``n_devices`` ranks over a mesh of
    data × fsdp (fsdp 2 when ``n_devices`` is even, else 1); returns the
    ranks' figures in rank order.

    ``device`` None gives each rank ``cuda:LOCAL_RANK`` under NCCL (a rank
    with no card of its own raises); "cuda:0" with ``backend="gloo"``
    puts every rank on that one card; "cpu" runs under gloo on the CPU.
    ``overrides`` go over every config (``dryrun_configs``).  The step
    stage runs ``DRYRUN_STEPS`` steps: its "metrics" are the first's,
    "timed_ms" the second's time, "collective_share" the part of the last
    spent in collectives.  ``clock`` holds each rank's wall-clock stamps
    (spawned, entered, ready, done, joined, loaded).  ``stage_context``, a
    picklable callable, is called in each rank with a stage's name
    (``STAGES``) and gives the context entered around that stage; a dict
    it yields is kept under ``extra[stage]`` (``kept_states`` keeps rank
    0's gradients and states there).  A rank's failure raises here."""
    import torch.multiprocessing as mp

    dev = _device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        from .ops import _build

        _build.build()          # once, before the ranks load it
    opts = dict(device=None if device is None else str(device),
                backend=backend, overrides=overrides,
                full_width=full_width, stage_context=stage_context)
    with tempfile.TemporaryDirectory() as tmp:
        spawned = time.time()
        mp.start_processes(dryrun_rank, args=(n_devices, tmp, opts),
                           nprocs=n_devices, join=True,
                           start_method="spawn")
        joined = time.time()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n_devices)]
    for r in ranks:
        r["clock"].update(spawned=spawned, joined=joined, loaded=time.time())
    return ranks


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=8,
                        help="the number of ranks (default 8)")
    parser.add_argument("--device", default=None,
                        help="cpu, or a card all ranks share (cuda:0); "
                             "default: one card a rank")
    parser.add_argument("--backend", default=None,
                        help="gloo or nccl (default: nccl on cards)")
    parser.add_argument("--full-width", action="store_true",
                        help="the base_vl pretrain at full width")
    args = parser.parse_args(argv)
    ranks = dryrun_multichip(args.n, device=args.device,
                             backend=args.backend,
                             full_width=args.full_width)
    print(f"dryrun_multichip({args.n}): stage seconds of rank 0 "
          + ", ".join(f"{k} {v:.2f}" for k, v in ranks[0]["seconds"].items())
          + f"; step ms {ranks[0]['step']['timed_ms']:.1f} (step "
          f"{TIMED_STEP + 1} of {DRYRUN_STEPS}); "
          f"{ranks[0]['step']['collective_share']:.1%} of step "
          f"{DRYRUN_STEPS} in collectives")


if __name__ == "__main__":
    main()
