"""The process group, the (data, fsdp) layout of its ranks and the
sharding rule of the params (port of ``vl_merging_tpu/parallel/mesh.py``).

The reference trains with DDP over up to 48 GPUs, optionally with
fairscale's ZeRO-2 (reference: src/run.py:204-288).  The JAX package
lays its devices out as a ``("data", "fsdp")`` mesh and lets XLA insert
the collectives its shardings imply.  The port runs one process per
device and makes the collectives explicit on its flat param dict:

  * every rank feeds its row share of each global batch (data
    parallelism); the f32 gradients are averaged over the group after the
    micro-batch accumulation (``average_grads``);
  * with ``use_sharded_training`` the params and the optimizer state rest
    sharded by ``_fsdp_spec`` over the ranks of the fsdp axis: the step
    gathers the full params for the pass (``gather_params``), the
    gradients are reduce-scattered to the shards (``reduce_grads``), and
    each rank updates its shards;
  * the cross-rank objectives gather their features through
    ``host.all_gather_with_grad`` (``train/objectives.py``).

Bootstrap (``initialize``) maps the OpenMPI and torchrun variables to
``init_process_group`` (the reference's OMPI rank discovery, run.py:
70-123).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.spec import Params
from . import host

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
# the gradients' all-reduce runs over flat f32 buckets of at most this many
# elements (128 MiB)
BUCKET_ELEMENTS = 1 << 25


def cluster_spec_from_env(environ=None) -> Optional[Dict[str, object]]:
    """The launcher's environment as ``init_process_group`` arguments
    (``init_method``, ``world_size``, ``rank``), or None when no
    multi-process launch is detected.  The JAX package's rules, by
    priority:

      1. OpenMPI launches: ``OMPI_COMM_WORLD_{SIZE,RANK}``, the rendezvous
         at ``MASTER_ADDR:MASTER_PORT`` with the reference's defaults
         (localhost:12345, run.py:119-123);
      2. torchrun-style ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR``.

    A world size of 1 is not a multi-process launch.  JAX's own
    coordinator variables (``JAX_COORDINATOR_ADDRESS``, Megascale's) name
    no torch group: None."""
    env = os.environ if environ is None else environ
    for size, rank in (("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
                       ("WORLD_SIZE", "RANK")):
        if size in env and int(env[size]) > 1:
            addr = env.get("MASTER_ADDR", "localhost")
            port = int(env.get("MASTER_PORT", 12345))
            return dict(init_method=f"tcp://{addr}:{port}",
                        world_size=int(env[size]),
                        rank=int(env.get(rank, 0)))
    return None


def initialize(backend: Optional[str] = None, *, use_cpu: bool = False,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Start the default process group: from ``init_method``,
    ``world_size`` and ``rank`` when given (``world_size`` 1 included),
    else from the launcher's environment (``cluster_spec_from_env``).
    ``backend`` defaults to NCCL on the card and gloo with ``use_cpu``;
    a caller names gloo to run several ranks on one card (NCCL refuses
    two ranks on one device).  Returns whether a group was started (False:
    one process, nothing to start, or a group already running)."""
    if host.is_distributed():
        return False
    if world_size is not None:
        spec = dict(init_method=init_method or "env://",
                    world_size=world_size, rank=rank or 0)
    else:
        spec = cluster_spec_from_env()
        if spec is None:
            return False
    if backend is None:
        backend = "gloo" if use_cpu or not torch.cuda.is_available() \
            else "nccl"
    dist.init_process_group(backend=backend, **spec)
    return True


initialize_multihost = initialize   # the JAX package's name


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The group's ranks as a (data, fsdp) grid, rank = d · fsdp + f: the
    ranks of one row share their shards, the ranks of one column hold the
    same shard.  ``fsdp_group`` / ``data_group`` are this rank's row and
    column (None: the default group, or one rank)."""
    data: int
    fsdp: int
    rank: int
    fsdp_group: object = None
    data_group: object = None

    @property
    def size(self) -> int:
        return self.data * self.fsdp

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.fsdp


def make_mesh(num_devices: Optional[int] = None, fsdp: int = 1) -> Mesh:
    """The (data, fsdp) mesh over the process group, one device a rank.
    ``num_devices`` (None: the group's size) must be the group's size."""
    world, rank = host.get_world_size(), host.get_rank()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices}, but the process group has "
            f"{world} process(es) of one device each")
    if world % fsdp != 0:
        raise ValueError(f"{world} devices not divisible by fsdp={fsdp}")
    data = world // fsdp
    fsdp_group = data_group = None
    if data > 1 and fsdp > 1:
        # every rank creates every subgroup, in the same order
        for d in range(data):
            g = dist.new_group([d * fsdp + f for f in range(fsdp)])
            if rank // fsdp == d:
                fsdp_group = g
        for f in range(fsdp):
            g = dist.new_group([d * fsdp + f for d in range(data)])
            if rank % fsdp == f:
                data_group = g
    return Mesh(data, fsdp, rank, fsdp_group, data_group)


def batch_sharding(mesh: Mesh) -> int:
    """The axis a batch splits over every rank of the mesh: its rows."""
    return 0


def replicated(mesh: Mesh) -> None:
    """The sharding of a tensor every rank holds whole: no axis."""
    return None


def _fsdp_spec(shape, fsdp_size: int) -> Optional[int]:
    """The axis a param shards over the fsdp ranks: its largest axis
    divisible by the fsdp size and at least 128 long; None (replicated)
    for the small ones (biases, LayerNorms, scalars), whose collectives
    would cost more than their memory saves."""
    if fsdp_size == 1 or not shape:
        return None
    best_axis, best_dim = None, 0
    for i, d in enumerate(shape):
        if d % fsdp_size == 0 and d > best_dim and d >= 128:
            best_axis, best_dim = i, d
    return best_axis


def param_shardings(params: Params, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Each param's shard axis (``_fsdp_spec``), or None."""
    return {k: _fsdp_spec(tuple(v.shape), mesh.fsdp)
            for k, v in params.items()}


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's shard of each param, a copy in storage of its own (a
    view would keep the full tensor alive); the replicated ones as they
    are."""
    axes = param_shardings(params, mesh)
    return {k: v if axes[k] is None else
            v.detach().chunk(mesh.fsdp, dim=axes[k])[mesh.fsdp_index]
            .clone(memory_format=torch.contiguous_format)
            for k, v in params.items()}


def gather_params(shards: Params, axes: Dict[str, Optional[int]],
                  mesh: Mesh) -> Params:
    """The full params from every fsdp rank's shards (no gradient); the
    replicated ones as they are."""
    out = {}
    for k, v in shards.items():
        axis = axes[k]
        if axis is None:
            out[k] = v
            continue
        full = host.all_gather_rows(v.detach().movedim(axis, 0),
                                    mesh.fsdp_group)
        out[k] = full.movedim(0, axis).contiguous()
    return out


def broadcast_params(params: Params, src: int = 0) -> None:
    """Rank ``src``'s params into every rank's, in place."""
    if host.get_world_size() == 1:
        return
    with torch.no_grad():
        for v in params.values():
            host.broadcast_(v, src)


def _all_reduce_mean(tensors, group, world: int) -> None:
    """Average ``tensors`` in place over ``group``, in flat f32 buckets."""
    bucket, size = [], 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        host.all_reduce_(flat, group=group)
        flat.div_(world)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    for t in tensors:
        if size + t.numel() > BUCKET_ELEMENTS and bucket:
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        flush()


def average_grads(grads: Params, mesh: Mesh) -> None:
    """Data parallelism: every gradient averaged over the group, in
    place."""
    if mesh.size > 1:
        _all_reduce_mean(list(grads.values()), None, mesh.size)


def reduce_grads(grads: Params, axes: Dict[str, Optional[int]],
                 mesh: Mesh) -> Params:
    """Sharded training: each full gradient averaged over the group and
    cut to this rank's shard (reduce-scattered over the fsdp ranks, then
    averaged over the data ranks); the replicated ones averaged whole."""
    out, whole = {}, []
    for k, g in grads.items():
        axis = axes[k]
        if axis is None:
            out[k] = g
            whole.append(g)
            continue
        shard = host.reduce_scatter_rows(g.movedim(axis, 0),
                                         mesh.fsdp_group)
        if mesh.data > 1:
            host.all_reduce_(shard, group=mesh.data_group)
        out[k] = shard.div_(mesh.size).movedim(0, axis).contiguous()
    if whole and mesh.size > 1:
        _all_reduce_mean(whole, None, mesh.size)
    return out


def global_sq_norm(tree: Params, axes: Dict[str, Optional[int]],
                   mesh: Mesh) -> torch.Tensor:
    """Σ leaf² over the full tensors that ``tree`` holds sharded by
    ``axes``: the shards' squares summed over the fsdp ranks, the
    replicated leaves counted once."""
    sharded = [v for k, v in tree.items() if axes[k] is not None]
    whole = [v for k, v in tree.items() if axes[k] is None]

    def sq(ts):
        if not ts:
            return torch.zeros((), device=next(iter(tree.values())).device)
        return torch.stack(torch._foreach_norm(ts)).square().sum()

    part = sq(sharded)
    if sharded and mesh.fsdp > 1:
        host.all_reduce_(part, group=mesh.fsdp_group)
    return part + sq(whole)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous row share of a batch that every rank holds
    whole (host arrays or tensors; nested dicts recurse)."""
    return {k: shard_batch(v, mesh) if isinstance(v, dict)
            else global_put(v, mesh) for k, v in batch.items()}


def global_put(arr, mesh: Mesh):
    """This rank's row share of ``arr``, which every rank holds whole (the
    JAX package assembles the global array from such shares)."""
    if mesh.size == 1 or arr is None:
        return arr
    if not isinstance(arr, (np.ndarray, torch.Tensor)):
        return arr
    return arr[host.process_rows(arr.shape[0])]
