"""End-to-end checkpoint ingest: load → surgery → merge → params (port of
``vl_merging_tpu/ckpt/pipeline.py``).

Replicates the reference constructor flow (vilt_module.py:269-295 for
training, :345-364 for test/validation-only): pick the surgery path by
checkpoint flavor, then optionally apply one of the three merging methods,
then load non-strictly onto the model schema.  Everything up to the last
step is host NumPy on flat state dicts; the params come out as f32 CPU
tensors, which the caller moves to its device
(``ckpt/convert.params_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..merging import core as merging
from ..models.spec import ModelSpec, Params, init_params
from . import io, surgery


def adapt_state_dict(cfg: Dict, spec: ModelSpec, sd: Dict[str, np.ndarray],
                     *, for_eval: bool = False) -> Dict[str, np.ndarray]:
    """Apply the flavor-appropriate surgery (vilt_module.py:277-282, 349-354).

    For eval (test_only/validation_only) the vlmo path is skipped entirely —
    the reference uses the raw state_dict then.
    """
    common = dict(
        num_layers=spec.num_layers,
        text_num_relative_distance=spec.text_num_relative_distance,
    )
    if cfg["use_beit_weight"]:
        return surgery.modify_checkpoint_beit(
            sd,
            target_table=_target_table(spec),
            use_moe=cfg["use_moe"],
            moe_in_ffn=cfg["in_ffn"],
            moe_in_attn=cfg["in_attn"],
            custom_ln_attn=cfg["use_custom_ln_attn"],
            custom_ln_ffn=cfg["use_custom_ln_ffn"],
            use_vision_weights_for_other_modalities=cfg[
                "use_vision_weights_for_other_modalities"],
            vlffn_start_layer_index=cfg["vlffn_start_layer_index"],
            **common,
        )
    if cfg["use_self_weight"]:
        return surgery.modify_checkpoint_self(
            sd, max_text_len=spec.max_text_len,
            target_table=_target_table(spec), **common)
    if for_eval:
        return dict(sd)
    return surgery.modify_checkpoint_vlmo(
        sd, max_text_len=spec.max_text_len,
        text_num_relative_distance=spec.text_num_relative_distance,
        target_table_rows=spec.all_num_relative_distance)


def apply_merging(cfg: Dict, spec: ModelSpec,
                  sd: Dict[str, np.ndarray],
                  *, for_eval: bool = False) -> Dict[str, np.ndarray]:
    """Dispatch to merge_weights / sum_task_vectors / regmean per config
    (vilt_module.py:284-291; regmean is not applied in the eval path,
    :356-360)."""
    kw = dict(
        num_layers=spec.num_layers,
        vlffn_start_layer_index=cfg["vlffn_start_layer_index"],
        loss_names=cfg["loss_names"],
    )
    if cfg["merge_weights"]:
        return merging.merge_weights(
            sd, merge_ratio=cfg["merge_ratio"],
            only_activate_used_experts=cfg["only_activate_used_experts"], **kw)
    if cfg["sum_task_vectors"]:
        central = io.load_torch_checkpoint(cfg["central_weight"])
        return merging.sum_task_vectors(
            sd, central, sum_lambda=cfg["sum_lambda"],
            only_activate_used_experts=cfg["only_activate_used_experts"], **kw)
    if cfg["regmean"] and not for_eval:
        grams = io.load_torch_checkpoint(cfg["gram_matrices"])
        return merging.regmean(
            sd, grams, scaling_for_non_diag=cfg["scaling_for_non_diag"], **kw)
    return sd


def expand_token_types(sd: Dict[str, np.ndarray],
                       spec: ModelSpec) -> Dict[str, np.ndarray]:
    """NLVR2 fine-tune from a 2-type pretrain checkpoint.

    The reference rebuilds ``token_type_embeddings`` with 3 rows after the
    checkpoint load and copies the loaded row 1 into row 2
    (vilt_module.py:332-337); here the expansion happens on the state dict
    before it is mapped onto the 3-row schema.
    """
    k = "token_type_embeddings.weight"
    if spec.token_type_count == 3 and k in sd and sd[k].shape[0] == 2:
        sd = dict(sd)
        sd[k] = np.concatenate([sd[k], sd[k][1:2]], axis=0)
    return sd


def load_params(
    cfg: Dict, spec: ModelSpec, *, seed: Optional[int] = None,
) -> Tuple[Params, List[str], List[str]]:
    """Build initial params: random init (``models/spec.init_params`` from a
    CPU generator seeded with ``seed``, else ``cfg["seed"]``), then overlay
    the (adapted, merged) checkpoint when ``load_path`` is set.  Returns
    (f32 CPU params, missing, unexpected)."""
    generator = torch.Generator().manual_seed(
        seed if seed is not None else cfg["seed"])
    params = init_params(spec, generator)
    if not cfg["load_path"]:
        return params, [], []

    for_eval = cfg["test_only"] or cfg["validation_only"]
    sd = io.load_torch_checkpoint(cfg["load_path"])
    sd = adapt_state_dict(cfg, spec, sd, for_eval=for_eval)
    sd = apply_merging(cfg, spec, sd, for_eval=for_eval)
    sd = expand_token_types(sd, spec)
    loaded, missing, unexpected = io.state_dict_to_params(sd, spec)
    params.update(loaded)
    return params, missing, unexpected


def _target_table(spec: ModelSpec) -> np.ndarray:
    """Random-init stand-in for the model's bias table; its text rows are the
    'randomly initialized parameters' the beit path keeps
    (vilt_module.py:855).  The reference initializes the table to zeros
    (vilt_module.py:139-140), so zeros it is."""
    return np.zeros(
        (spec.all_num_relative_distance, spec.num_heads * spec.num_layers),
        np.float32)
