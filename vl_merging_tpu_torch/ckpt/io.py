"""Checkpoint I/O: torch ``.ckpt``/``.pth`` files and the param schema
(port of ``vl_merging_tpu/ckpt/io.py``).

Torch files are the interchange format with the reference ecosystem
(released checkpoints, gram caches), read and written through torch CPU.
A state dict on the host is a flat ``{name: np.ndarray}``, as in the JAX
package, so surgery and host merging (``ckpt/surgery.py``,
``merging/core.py``) run the same NumPy arithmetic bit for bit; params
are torch tensors (``ckpt/convert.params_from_numpy``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.spec import ModelSpec, Params, param_shapes
from .convert import params_from_numpy

StateDict = Dict[str, np.ndarray]


def load_torch_checkpoint(path: str) -> StateDict:
    """Load a torch checkpoint to a flat numpy dict; unwraps Lightning's
    ``state_dict`` envelope (reference vilt_module.py:275, 751-755)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out: StateDict = {}
    for k, v in ckpt.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def save_torch_checkpoint(sd: StateDict, path: str,
                          lightning_envelope: bool = True) -> None:
    """Write a torch-readable checkpoint; 0-d entries stay 0-d."""

    def to_tensor(v):
        v = np.asarray(v)
        if v.ndim == 0:
            # np.ascontiguousarray promotes 0-d to 1-d; keep scalars 0-d
            return torch.tensor(v.item(), dtype=torch.from_numpy(
                v.reshape(1).copy()).dtype)
        return torch.from_numpy(np.ascontiguousarray(v).copy())

    tensors = {k: to_tensor(v) for k, v in sd.items()}
    payload = {"state_dict": tensors} if lightning_envelope else tensors
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def state_dict_to_params(
    sd: StateDict, spec: ModelSpec, dtype: torch.dtype = torch.float32,
) -> Tuple[Params, List[str], List[str]]:
    """Map a flat state dict onto the model's param schema.

    Returns (params, missing_keys, unexpected_keys) with the reference's
    ``load_state_dict(strict=False)`` semantics (vilt_module.py:293-295):
    missing keys keep their freshly initialized values at the call site;
    unexpected keys are dropped.  A scalar that came back as (1,) is a
    scalar again; any other shape mismatch raises."""
    shapes = param_shapes(spec)
    arrays: StateDict = {}
    missing, unexpected = [], []
    for name, shape in shapes.items():
        if name in sd:
            v = np.asarray(sd[name])
            if tuple(shape) == () and tuple(v.shape) == (1,):
                v = v.reshape(())  # scalar params may round-trip as (1,)
            if tuple(v.shape) != tuple(shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint {tuple(v.shape)} "
                    f"vs model {tuple(shape)}")
            arrays[name] = v
        else:
            missing.append(name)
    for name in sd:
        if name not in shapes:
            unexpected.append(name)
    return params_from_numpy(arrays, "cpu", dtype), missing, unexpected


def params_to_state_dict(params: Params) -> StateDict:
    """Params (tensors on any device) as a flat numpy dict, each leaf in
    its own dtype (bf16 leaves widened to f32: numpy has no bf16)."""
    return {k: (v.detach().float() if v.dtype == torch.bfloat16
                else v.detach()).cpu().numpy() for k, v in params.items()}
