"""Checkpoint adaptation / surgery (port of
``vl_merging_tpu/ckpt/surgery.py``, the same NumPy code).

Pure functions on flat ``{name: np.ndarray}`` state dicts replicating the
reference's three checkpoint-ingest paths
(reference: src/vilt/modules/vilt_module.py:749-1059):

  * ``modify_checkpoint_vlmo``  — this framework's own checkpoints: truncate
    text position embeddings, drop index buffers, rescale the image block of
    the rel-pos table when input resolution changes (e.g. 224→384).
  * ``modify_checkpoint_beit``  — BEiT image-only checkpoints: merge
    per-layer or shared bias tables, bicubic-rescale, keep the target's
    randomly initialized text buckets, insert ``.v.`` expert names, clone
    vision weights into l/vl experts.
  * ``modify_checkpoint_self``  — raw (non-Lightning) state dicts with the
    BEiT-table layout.

All functions take/return plain numpy dicts; nothing touches a device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .bicubic import bicubic_resize

StateDict = Dict[str, np.ndarray]

# Exactly the reference's pop_keys list (vilt_module.py:779-781).  Note it
# does NOT include text_embeddings.position_ids (kept, truncated) nor
# vl_text_imag_relative_position_index; the schema filter in io.py drops any
# remaining non-param buffers at load time.
INDEX_BUFFER_KEYS = (
    "relative_position_index",
    "text_relative_position_index",
    "text_imag_relative_position_index",
    "video_relative_position_index",
    "text_video_relative_position_index",
    "temporal_relative_position_index",
    "mask_for_combining_temporal",
)


def _pop_index_buffers(sd: StateDict) -> None:
    for k in INDEX_BUFFER_KEYS:
        sd.pop(k, None)


def _interp_image_block(rel_pos_bias: np.ndarray, src_size: int,
                        dst_size: int) -> np.ndarray:
    """Rescale the (src_size², C) image block to (dst_size², C) with
    torch-equivalent bicubic (vilt_module.py:797-800)."""
    c = rel_pos_bias.shape[1]
    embed = rel_pos_bias.T.reshape(c, src_size, src_size)
    embed = bicubic_resize(embed, (dst_size, dst_size))
    return embed.transpose(1, 2, 0).reshape(-1, c)


def modify_checkpoint_vlmo(
    state_dict: StateDict,
    *,
    max_text_len: int,
    text_num_relative_distance: int,
    target_table_rows: int,
) -> StateDict:
    """Adapt one of our own checkpoints (vilt_module.py:749-806)."""
    sd = dict(state_dict)

    pe = sd.get("text_embeddings.position_embeddings.weight")
    if pe is not None and pe.shape[0] != max_text_len:
        sd["text_embeddings.position_embeddings.weight"] = pe[:max_text_len]
        pid = sd.get("text_embeddings.position_ids")
        if pid is not None:
            sd["text_embeddings.position_ids"] = pid[:, :max_text_len]
    _pop_index_buffers(sd)

    table = sd["relative_position_bias_table"]
    src_num_pos = table.shape[0]
    non_image = text_num_relative_distance + 2 + 3
    src_size = int(round((src_num_pos - non_image) ** 0.5))
    dst_size = int(round((target_table_rows - non_image) ** 0.5))
    if src_size != dst_size:
        extra = table[-non_image:]
        image_part = _interp_image_block(table[:-non_image], src_size, dst_size)
        sd["relative_position_bias_table"] = np.concatenate(
            [image_part, extra], axis=0)
    return sd


def import_beit_bias_table(
    sd: StateDict,
    *,
    num_layers: int,
    target_table: np.ndarray,
    text_num_relative_distance: int,
) -> None:
    """Convert BEiT per-layer or shared rel-pos tables into the fused table
    layout, in place (vilt_module.py:816-881).

    BEiT tables hold only image buckets (+3 cls buckets); the text rows keep
    the target model's (randomly initialized) values.
    """
    shared_key = "transformer.rel_pos_bias.relative_position_bias_table"
    is_pt = shared_key in sd
    is_pt_ft = "transformer.blocks.0.attn.relative_position_bias_table" in sd
    if not (is_pt or is_pt_ft):
        return

    if is_pt:
        rel_pos_bias = sd.pop(shared_key)
        sd.pop("transformer.rel_pos_bias.relative_position_index", None)
    else:
        parts = []
        for i in range(num_layers):
            parts.append(sd.pop(
                f"transformer.blocks.{i}.attn.relative_position_bias_table"))
            sd.pop(f"transformer.blocks.{i}.attn.relative_position_index", None)
        rel_pos_bias = np.concatenate(parts, axis=-1)

    src_num_pos, num_attn_heads = rel_pos_bias.shape
    dst_num_pos, num_layers_heads = target_table.shape
    non_image = text_num_relative_distance + 2 + 3
    src_size = int(round((src_num_pos - 3) ** 0.5))
    dst_size = int(round((dst_num_pos - non_image) ** 0.5))

    extra_tokens = target_table[-(non_image - 3):]   # text buckets: random init
    extra_img = rel_pos_bias[-3:]
    embed = _interp_image_block(rel_pos_bias[:-3], src_size, dst_size)

    if is_pt:
        reps = num_layers_heads // num_attn_heads
        embed = np.tile(embed, (1, reps))
        extra_img = np.tile(extra_img, (1, reps))

    sd["relative_position_bias_table"] = np.concatenate(
        [embed, extra_img, extra_tokens], axis=0)


def insert_expert_names(
    sd: StateDict,
    *,
    moe_in_ffn: bool = False,
    moe_in_attn: bool = False,
    custom_ln_attn: bool = False,
    custom_ln_ffn: bool = False,
) -> StateDict:
    """Rename flat keys to the ``.v.`` expert slots (vilt_module.py:884-938)."""
    def insert(k: str, pos_from_end: int) -> str:
        parts = k.split(".")
        parts.insert(len(parts) - pos_from_end, "v")
        return ".".join(parts)

    out: StateDict = {}
    for k, v in sd.items():
        nk = k
        if moe_in_ffn and "mlp" in k:
            nk = insert(k, 2)
        elif moe_in_attn and "attn" in k:
            nk = insert(k, 1 if ("attn.q_bias" in k or "attn.v_bias" in k) else 2)
        out[nk] = v

    if custom_ln_attn:
        out = {insert(k, 1) if ".norm1" in k else k: v for k, v in out.items()}
    if custom_ln_ffn:
        out = {insert(k, 1) if ".norm2" in k else k: v for k, v in out.items()}
    return out


def clone_vision_weights(
    sd: StateDict, *, vlffn_start_layer_index: int
) -> StateDict:
    """Copy every ``.v.`` expert weight into ``.l.`` (all layers) and ``.vl.``
    (deep layers) (vilt_module.py:940-961)."""
    out: StateDict = {}
    for k, v in sd.items():
        if ".v." in k:
            out[k.replace(".v.", ".l.")] = v
            layer_idx = int(k.split(".")[2])
            if layer_idx >= vlffn_start_layer_index:
                out[k.replace(".v.", ".vl.")] = v
        out[k] = v
    return out


def rename_fc_norm(sd: StateDict) -> None:
    """BEiT ``fc_norm`` → final ``norm`` (vilt_module.py:963-968)."""
    if "transformer.fc_norm.weight" in sd:
        sd["transformer.norm.weight"] = sd.pop("transformer.fc_norm.weight")
        sd["transformer.norm.bias"] = sd.pop("transformer.fc_norm.bias")


def modify_checkpoint_beit(
    state_dict: StateDict,
    *,
    num_layers: int,
    target_table: np.ndarray,
    text_num_relative_distance: int,
    use_moe: bool = False,
    moe_in_ffn: bool = True,
    moe_in_attn: bool = False,
    custom_ln_attn: bool = False,
    custom_ln_ffn: bool = False,
    use_vision_weights_for_other_modalities: bool = False,
    vlffn_start_layer_index: int = 10,
) -> StateDict:
    """Full BEiT ingest pipeline (vilt_module.py:808-972)."""
    sd = dict(state_dict)
    import_beit_bias_table(
        sd, num_layers=num_layers, target_table=target_table,
        text_num_relative_distance=text_num_relative_distance)
    sd = insert_expert_names(
        sd,
        moe_in_ffn=use_moe and moe_in_ffn,
        moe_in_attn=use_moe and moe_in_attn,
        custom_ln_attn=custom_ln_attn,
        custom_ln_ffn=custom_ln_ffn,
    )
    if use_vision_weights_for_other_modalities:
        sd = clone_vision_weights(sd,
                                  vlffn_start_layer_index=vlffn_start_layer_index)
    rename_fc_norm(sd)
    return sd


def modify_checkpoint_self(
    state_dict: StateDict,
    *,
    max_text_len: int,
    num_layers: int,
    target_table: np.ndarray,
    text_num_relative_distance: int,
) -> StateDict:
    """Raw (non-Lightning) state dict with BEiT-layout tables
    (vilt_module.py:974-1059)."""
    sd = dict(state_dict)
    pe = sd.get("text_embeddings.position_embeddings.weight")
    if pe is not None and pe.shape[0] != max_text_len:
        sd["text_embeddings.position_embeddings.weight"] = pe[:max_text_len]
        pid = sd.get("text_embeddings.position_ids")
        if pid is not None:
            sd["text_embeddings.position_ids"] = pid[:, :max_text_len]
    import_beit_bias_table(
        sd, num_layers=num_layers, target_table=target_table,
        text_num_relative_distance=text_num_relative_distance)
    rename_fc_norm(sd)
    return sd


def interpolate_pos_embed(
    pos_embed: np.ndarray, dst_num_patches: int, num_extra_tokens: int = 1,
) -> np.ndarray:
    """Classic absolute position-embedding bicubic resize
    (vilt_module.py:18-42; mostly unused since abs pos-embeds are off).

    pos_embed: (1, extra + src_patches, dim) → (1, extra + dst_patches, dim).
    """
    dim = pos_embed.shape[-1]
    extra = pos_embed[:, :num_extra_tokens]
    patches = pos_embed[0, num_extra_tokens:]
    src_size = int(round(patches.shape[0] ** 0.5))
    dst_size = int(round(dst_num_patches ** 0.5))
    if src_size == dst_size:
        return pos_embed
    grid = patches.reshape(src_size, src_size, dim).transpose(2, 0, 1)
    grid = bicubic_resize(grid, (dst_size, dst_size))
    flat = grid.transpose(1, 2, 0).reshape(1, -1, dim)
    return np.concatenate([extra, flat], axis=1)
