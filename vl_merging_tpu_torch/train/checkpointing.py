"""Full training-state checkpointing with ``torch.save`` (port of
``vl_merging_tpu/train/checkpointing.py``, which uses orbax).

The torch-style ``weights.ckpt`` written by the trainer covers interop and
weights-only resume; this module adds full-state save/restore (f32
params + optimizer state + step + the ``torch.Generator``'s state) so a
run resumes exactly — the analogue of Lightning's resume_from_checkpoint
(reference run.py:253,280).
"""

from __future__ import annotations

import os

import torch

from .optimizer import OptState
from .train_step import TrainState


def _host(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_train_state(state: TrainState, path: str) -> None:
    """One file at ``path``, written whole (a temporary file renamed into
    place)."""
    payload = {
        "params": _host(state.params),
        "opt_state": {"count": state.opt_state.count,
                      "mu": _host(state.opt_state.mu),
                      "nu": _host(state.opt_state.nu)},
        "step": state.step,
        "generator": state.generator.get_state(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into the live state: the params are copied into the
    template's tensors (so every holder of them sees the restored
    values), the optimizer moments land on the params' devices, and the
    template's generator takes the saved state."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k, v in template.params.items():
            v.copy_(payload["params"][k])

    def on_device(tree):
        return {k: v.to(template.params[k].device) for k, v in tree.items()}

    opt = payload["opt_state"]
    template.generator.set_state(payload["generator"])
    return TrainState(
        params=template.params,
        opt_state=OptState(int(opt["count"]), on_device(opt["mu"]),
                           on_device(opt["nu"])),
        step=int(payload["step"]),
        generator=template.generator,
    )
