"""Parameter dicts from arrays, and the one-time eval cast.

The JAX package keeps its params as a flat dict keyed like the reference
state_dict, in torch layout (Linear weight = (out, in)), so moving them
into the port is a per-key copy: no renames, no transposes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..models.spec import ModelSpec, Params


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: the source may be read-only


def params_from_numpy(params: Mapping[str, object],
                      device: torch.device | str,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Copy each array (numpy, or already a tensor) to ``device``.

    ``dtype`` casts the floating-point leaves; None keeps each leaf's
    dtype."""
    out: Params = {}
    for k, v in params.items():
        t = _to_tensor(v)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def eval_cast_params(params: Params, spec: ModelSpec, cfg: Mapping) -> Params:
    """One-time bf16 pre-cast of f32 master params for eval (port of
    ``vl_merging_tpu/train/loop.py:eval_cast_params``).

    When the compute dtype is bf16 every matmul casts its weight per use
    anyway, so pre-casting the ≥2-D ``.weight`` leaves is numerically
    identical and halves weight reads.  Kept f32: 1-D leaves (LN scales
    and biases, gammas), the rel-pos bias tables, and the
    ``text_embeddings.*`` tables, whose LayerNorm runs on the f32 rows
    before the compute-dtype cast (``model.text_embed``)."""
    if spec.eval_int8:
        raise NotImplementedError(
            "eval_int8 (W8A8 eval) is not ported yet: ROADMAP A5")
    if (spec.compute_dtype != "bfloat16"
            or not cfg.get("eval_params_bf16", True)):
        return params
    return {
        k: (v.to(torch.bfloat16)
            if (v.dtype == torch.float32 and v.ndim >= 2
                and k.endswith(".weight")
                and "bias_table" not in k
                and not k.startswith("text_embeddings."))
            else v)
        for k, v in params.items()}
