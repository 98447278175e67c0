"""Parameter dicts to and from arrays, f32 training masters, and the
one-time eval cast.

The JAX package keeps its params as a flat dict keyed like the reference
state_dict, in torch layout (Linear weight = (out, in)), so moving them
into the port and back is a per-key copy: no renames, no transposes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models.spec import ModelSpec, Params
from ..ops.int8 import SCALE_SUFFIX, quantize_eval_params


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

    ``dtype`` casts the floating-point leaves but the f32 scales of int8
    weights (``::scale8``, part of the quantized weight); None keeps each
    leaf's dtype."""
    out: Params = {}
    for k, v in params.items():
        t = _to_tensor(v)
        if (dtype is not None and t.is_floating_point()
                and not k.endswith(SCALE_SUFFIX)):
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """Each tensor as a float32 (floating point) or integer numpy array on
    the host: the port's params in the form the JAX package takes."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            .cpu().numpy() for k, v in params.items()}


def master_params(params: Params) -> Params:
    """f32 training masters: a float32 copy of every leaf (the param
    schema holds floating-point leaves only), each a leaf tensor that
    requires grad, on the leaf's device.  The train
    step updates them in place, so they never alias the caller's
    tensors."""
    return {k: v.detach().to(torch.float32, copy=True).requires_grad_()
            for k, v in params.items()}


def eval_cast_params(params: Params, spec: ModelSpec, cfg: Mapping) -> Params:
    """One-time eval cast of f32 master params (port of
    ``vl_merging_tpu/train/loop.py:eval_cast_params``).

    When the compute dtype is bf16 every matmul casts its weight per use
    anyway, so pre-casting the ≥2-D ``.weight`` leaves is numerically
    identical and halves weight reads.  Kept f32: 1-D leaves (LN scales
    and biases, gammas), the rel-pos bias tables, and the
    ``text_embeddings.*`` tables, whose LayerNorm runs on the f32 rows
    before the compute-dtype cast (``model.text_embed``).

    With ``spec.eval_int8`` (W8A8 eval) the block projection weights also
    get int8 companions (``ops/int8.quantize_eval_params``: ``::int8`` and
    ``::scale8`` keys), quantized from the f32 masters in either branch;
    ``mome._block_fast`` routes a block through the int8 kernels when it
    finds them."""
    if (spec.compute_dtype != "bfloat16"
            or not cfg.get("eval_params_bf16", True)):
        return quantize_eval_params(params) if spec.eval_int8 else params
    out = {
        k: (v.to(torch.bfloat16)
            if (v.dtype == torch.float32 and v.ndim >= 2
                and k.endswith(".weight")
                and "bias_table" not in k
                and not k.startswith("text_embeddings."))
            else v)
        for k, v in params.items()}
    if spec.eval_int8:
        q = quantize_eval_params(params)
        out.update({k: v for k, v in q.items() if k not in params})
    return out
