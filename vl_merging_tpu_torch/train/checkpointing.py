"""Full training-state checkpointing with ``torch.save`` (port of
``vl_merging_tpu/train/checkpointing.py``, which uses orbax).

The torch-style ``weights.ckpt`` written by the trainer covers interop and
weights-only resume; this module adds full-state save/restore (f32
params + optimizer state + step + the ``torch.Generator``'s state) so a
run resumes exactly — the analogue of Lightning's resume_from_checkpoint
(reference run.py:253,280).

Over a process group the file holds the full state: under sharded
training every rank reaches the gathers of the params and the optimizer
moments, and rank 0 alone writes.  On restore every rank reads the file
and takes its shards.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..parallel import host
from ..parallel.mesh import gather_params
from .optimizer import OptState
from .train_step import TrainState


def _host(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_train_state(state: TrainState, path: str) -> None:
    """One file at ``path``, written whole (a temporary file renamed into
    place) by rank 0; every rank must call it (the gathers of a sharded
    state)."""
    def full(tree):
        if state.shardings is None or not tree:
            return tree
        return gather_params(tree, state.shardings, state.mesh)

    params, mu, nu = (full(t) for t in (state.params, state.opt_state.mu,
                                        state.opt_state.nu))
    if not host.is_main_process():
        return
    payload = {
        "params": _host(params),
        "opt_state": {"count": state.opt_state.count,
                      "mu": _host(mu), "nu": _host(nu)},
        "step": state.step,
        "generator": state.generator.get_state(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _shard_of(template: TrainState, key: str, full: torch.Tensor
              ) -> torch.Tensor:
    """The template's shard of the full tensor ``full`` of param ``key``
    (``full`` itself for a replicated param or an unsharded state)."""
    axis = None if template.shardings is None else template.shardings[key]
    if axis is None:
        return full
    mesh = template.mesh
    return full.chunk(mesh.fsdp, dim=axis)[mesh.fsdp_index]


def load_full_params(template: TrainState, params) -> None:
    """Copy full params (a dict of any subset of the keys) into the
    template's params, each rank its shards."""
    with torch.no_grad():
        for k, v in params.items():
            template.params[k].copy_(_shard_of(template, k, v))


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into the live state: the params are copied into the
    template's tensors (so every holder of them sees the restored
    values), the optimizer moments land on the params' devices, and the
    template's generator takes the saved state.  A sharded template takes
    its shards of the full tensors."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    load_full_params(template, payload["params"])

    def on_device(tree):
        return {k: _shard_of(template, k, v).contiguous().to(
            template.params[k].device) for k, v in tree.items()}

    opt = payload["opt_state"]
    template.generator.set_state(payload["generator"])
    return dataclasses.replace(
        template,
        opt_state=OptState(int(opt["count"]), on_device(opt["mu"]),
                           on_device(opt["nu"])),
        step=int(payload["step"]))
