"""Process-level distributed utilities on ``torch.distributed`` (port of
``vl_merging_tpu/parallel/host.py``).

Covers the reference's ``dist_utils`` surface (reference:
src/vilt/modules/dist_utils.py:84-224: pickled-object all_gather,
reduce_dict, synchronize, rank queries) and the tensor collectives the
port's data-parallel step, objectives and evals run explicitly (the JAX
package lets XLA insert them from shardings).  Without a process group
every helper is the one-process identity.

Gloo takes CUDA tensors only for broadcast and all_reduce; so under gloo
a collective over CUDA tensors (two ranks sharing one card) goes through
host copies, and every collective of the gloo backend runs on the CPU.
NCCL takes the tensors where they are.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_distributed() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_distributed() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier over the group (the reference's dist.barrier); a no-op in
    one process."""
    if get_world_size() > 1:
        dist.barrier()


def process_rows(n_global_rows: int) -> slice:
    """This process's contiguous row share of a global, world-divisible
    batch (the ``ShardedBatchSampler`` contract: rank r holds rows
    [r·share, (r+1)·share))."""
    share = n_global_rows // get_world_size()
    lo = get_rank() * share
    return slice(lo, lo + share)


# --------------------------------------------------------------------------
# tensor collectives
# --------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
                ) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if get_world_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast of rank ``src``'s ``t``; returns ``t``."""
    if get_world_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on ``t``'s device; no gradient."""
    world = get_world_size(group)
    if world == 1:
        return t
    src = t.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device)


def reduce_scatter_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``t`` (equal shapes, dim 0 divisible by the
    world size), this rank's block of rows of it."""
    world = get_world_size(group)
    if world == 1:
        return t
    src = t.contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // world,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward returns this rank's rows of
    the incoming gradient, and nothing from the other ranks' losses: the
    reference's gather (objectives.py:264-314), under which each rank's
    parameters see the full-batch loss only through its own features."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.rank = x.shape[0], get_rank(group)
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather_rows`` inside the autograd graph (``_GatherRows``).
    Summed over ranks, the parameters' gradients of a loss over the
    gathered rows are the one-process gradient of that loss over the
    global batch.  ``torch.distributed.nn.functional.all_gather`` instead
    sums the gathered rows' gradients over the ranks in its backward,
    which gives each rank world × that share."""
    if get_world_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


class _GradShare(torch.autograd.Function):
    """The identity, whose backward divides the gradient by the world
    size."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.world, None


def grad_share(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, which every rank uses alike in a loss over gathered rows
    (the contrastive losses' logit scales), with 1/world of its gradient:
    summed over the ranks its gradient is the one-process one, as the
    gathered rows' is through ``all_gather_with_grad``."""
    world = get_world_size(group)
    if world == 1:
        return x
    return _GradShare.apply(x, world)


# --------------------------------------------------------------------------
# host objects
# --------------------------------------------------------------------------

def _object_device(group) -> torch.device:
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """Every process's picklable ``obj``, in rank order (reference
    dist_utils.all_gather:84-122): the pickle as a byte tensor, the sizes
    all-gathered, each payload padded to the largest, then gathered."""
    world = get_world_size(group)
    if world == 1:
        return [obj]
    dev = _object_device(group)
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = all_gather_rows(size, group).cpu()
    padded = torch.zeros(int(sizes.max()), dtype=torch.uint8, device=dev)
    padded[:payload.numel()] = payload.to(dev)
    rows = all_gather_rows(padded[None], group).cpu().numpy()
    return [pickle.loads(rows[r, :int(sizes[r])].tobytes())
            for r in range(world)]


def reduce_dict(d: Dict[str, float], average: bool = True,
                group=None) -> Dict[str, float]:
    """Sum (or mean) scalar dicts across processes (reference
    dist_utils.reduce_dict); a key missing on a process counts as 0."""
    if get_world_size(group) == 1:
        return dict(d)
    gathered = all_gather_objects(d, group)
    out: Dict[str, float] = {}
    for g in gathered:
        for k, v in g.items():
            out[k] = out.get(k, 0.0) + float(v)
    if average:
        out = {k: v / len(gathered) for k, v in out.items()}
    return out


def fetch_global(x: torch.Tensor, group=None) -> np.ndarray:
    """The global rows of a row-sharded ``x`` on the host: every rank's
    rows in rank order (the JAX package's gather of a batch-sharded
    output); in one process ``x`` itself."""
    return all_gather_rows(x, group).cpu().numpy()
