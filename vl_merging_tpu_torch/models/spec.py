"""Static model specification and parameter schema (port of
``vl_merging_tpu/models/spec.py``).

``ModelSpec`` and ``BlockSpec`` are the same frozen dataclasses, built by
the same rules from a config dict, so a spec built here routes exactly as
the JAX one does.  Parameters are a flat dict keyed like the reference
state_dict, in torch layout (Linear weight = (out, in)), which is also the
JAX package's layout: weights cross between the two packages as a per-key
copy (``ckpt/convert.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

V, L, VL = 0, 1, 2  # type_id values: vision / language / fused


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static structure of one MoME block.

    reference: src/vilt/modules/vision_transformer.py:366-493.
    """
    index: int
    kind: str                    # "plain" | "sep_plain" | "moe"
    tasks: Tuple[str, ...]       # () when no architecture mode is active
    attn_experts: bool           # per-modality attention (moe in_attn)
    mlp_experts: bool            # per-modality FFN (moe in_ffn)
    norm1_experts: bool
    norm2_experts: bool
    self_attn_single: bool       # split fused seq per modality in attention
    has_vl: bool                 # "vl" in tasks (deep layer)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    hidden_size: int
    num_heads: int
    num_layers: int
    mlp_ratio: int
    image_size: int
    patch_size: int
    max_text_len: int
    max_text_len_of_initckpt: int
    max_vl_text_len: Optional[int]
    vlffn_start_layer_index: int
    vocab_size: int
    drop_rate: float
    blocks: Tuple[BlockSpec, ...]
    token_type_count: int        # 3 for NLVR2, else 2
    # heads
    use_mlm_head: bool
    use_itm_head: bool
    use_ifm_heads: bool          # dual contrastive projections (pretrain)
    use_irtr_heads: bool         # single contrastive projections (fine-tune)
    use_mim_head: bool
    use_vqa_head: bool
    use_img_cls_head: bool
    use_nlvr2_head: bool
    vqav2_label_size: int
    img_cls_label_size: int
    mim_vocab_size: int
    compute_dtype: str           # "bfloat16" | "float32"
    remat: bool = False
    attention_logits_dtype: str = "f32"  # "f32" parity | "bf16" fast eval
    eval_int8: bool = False
    num_frames: int = 1
    distilled: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def window(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.window * self.window

    @property
    def image_len(self) -> int:
        return self.num_patches + 1  # + cls

    @property
    def num_relative_distance(self) -> int:
        # image buckets (+3 cls buckets); reference vilt_module.py:134
        w = self.window
        return (2 * w - 1) * (2 * w - 1) + 3

    @property
    def text_num_relative_distance(self) -> int:
        # reference vilt_module.py:136
        return 2 * self.max_text_len_of_initckpt

    @property
    def all_num_relative_distance(self) -> int:
        # reference vilt_module.py:137
        return self.num_relative_distance + self.text_num_relative_distance + 2

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32


def _block_spec(cfg: dict, i: int) -> BlockSpec:
    """Replicates run.py:165-184 mode-object construction plus
    Block.__init__ routing (vision_transformer.py:386-493)."""
    use_moe = cfg["use_moe"]
    use_ufo = cfg["use_ufo"]
    use_ln = cfg["use_custom_ln_attn"] or cfg["use_custom_ln_ffn"]

    deep = i >= cfg["vlffn_start_layer_index"]
    tasks: Tuple[str, ...] = ()
    if use_moe or use_ufo or use_ln:
        tasks = ("v", "l", "vl") if deep else ("v", "l")

    in_attn = use_moe and cfg["in_attn"]
    in_ffn = use_moe and cfg["in_ffn"]

    if use_moe:
        kind = "moe"
    elif use_ufo and cfg["separate_inference"]:
        kind = "sep_plain"
    else:
        kind = "plain"

    if kind == "moe" and in_attn:
        self_attn_single = cfg["self_attn_for_single_mode"]
    elif kind == "moe":
        self_attn_single = cfg["separate_inference"]
    else:
        self_attn_single = kind == "sep_plain"

    return BlockSpec(
        index=i,
        kind=kind,
        tasks=tasks,
        attn_experts=in_attn,
        mlp_experts=in_ffn,
        norm1_experts=in_attn or cfg["use_custom_ln_attn"],
        norm2_experts=cfg["use_custom_ln_ffn"],
        self_attn_single=self_attn_single,
        has_vl="vl" in tasks,
    )


def make_model_spec(cfg: dict) -> ModelSpec:
    ln = cfg["loss_names"]
    return ModelSpec(
        hidden_size=cfg["hidden_size"],
        num_heads=cfg["num_heads"],
        num_layers=cfg["num_layers"],
        mlp_ratio=cfg["mlp_ratio"],
        image_size=cfg["image_size"],
        patch_size=cfg["patch_size"],
        max_text_len=cfg["max_text_len"],
        max_text_len_of_initckpt=cfg["max_text_len_of_initckpt"],
        max_vl_text_len=cfg["max_vl_text_len"],
        vlffn_start_layer_index=cfg["vlffn_start_layer_index"],
        vocab_size=cfg["vocab_size"],
        drop_rate=cfg["drop_rate"],
        blocks=tuple(_block_spec(cfg, i) for i in range(cfg["num_layers"])),
        token_type_count=3 if ln["nlvr2"] > 0 else 2,
        use_mlm_head=ln["mlm"] > 0 or ln["text_only_mlm"] > 0,
        use_itm_head=ln["itm"] > 0,
        use_ifm_heads=ln["ifm"] > 0,
        use_irtr_heads=ln["irtr"] > 0,
        use_mim_head=ln["mim"] > 0 or ln["image_only_mim"] > 0,
        use_vqa_head=ln["vqa"] > 0,
        use_img_cls_head=ln["img_cls"] > 0,
        use_nlvr2_head=ln["nlvr2"] > 0,
        vqav2_label_size=cfg["vqav2_label_size"],
        img_cls_label_size=cfg["img_cls_label_size"],
        mim_vocab_size=8192,
        compute_dtype="bfloat16" if cfg["precision"] == "bf16" else "float32",
        remat=cfg["use_remat"],
        attention_logits_dtype=cfg["attention_logits_dtype"],
        eval_int8=cfg["eval_int8"],
        num_frames=cfg["num_frames"],
        distilled="distilled" in cfg["vit"],
    )


# --------------------------------------------------------------------------
# Parameter schema
# --------------------------------------------------------------------------

def _block_param_shapes(spec: ModelSpec, b: BlockSpec) -> Dict[str, Tuple[int, ...]]:
    hs = spec.hidden_size
    mh = int(hs * spec.mlp_ratio)
    p = f"transformer.blocks.{b.index}"
    shapes: Dict[str, Tuple[int, ...]] = {}

    def norm(name: str, expert: bool):
        keys = [f"{name}.{t}" for t in b.tasks] if expert else [name]
        for k in keys:
            shapes[f"{p}.{k}.weight"] = (hs,)
            shapes[f"{p}.{k}.bias"] = (hs,)

    def attn(name: str):
        shapes[f"{p}.{name}.qkv.weight"] = (3 * hs, hs)
        shapes[f"{p}.{name}.q_bias"] = (hs,)
        shapes[f"{p}.{name}.v_bias"] = (hs,)
        shapes[f"{p}.{name}.proj.weight"] = (hs, hs)
        shapes[f"{p}.{name}.proj.bias"] = (hs,)

    def mlp(name: str):
        shapes[f"{p}.{name}.fc1.weight"] = (mh, hs)
        shapes[f"{p}.{name}.fc1.bias"] = (mh,)
        shapes[f"{p}.{name}.fc2.weight"] = (hs, mh)
        shapes[f"{p}.{name}.fc2.bias"] = (hs,)

    norm("norm1", b.norm1_experts)
    if b.attn_experts:
        for t in b.tasks:
            attn(f"attn.{t}")
    else:
        attn("attn")
    norm("norm2", b.norm2_experts)
    if b.mlp_experts:
        for t in b.tasks:
            mlp(f"mlp.{t}")
    else:
        mlp("mlp")
    shapes[f"{p}.gamma_1"] = (hs,)
    shapes[f"{p}.gamma_2"] = (hs,)
    return shapes


def param_shapes(spec: ModelSpec) -> Dict[str, Tuple[int, ...]]:
    hs = spec.hidden_size
    shapes: Dict[str, Tuple[int, ...]] = {}

    # BertEmbeddings (reference vilt_module.py:51-64); position embeddings are
    # present in checkpoints but unused at runtime (rel_pos positioning).
    shapes["text_embeddings.word_embeddings.weight"] = (spec.vocab_size, hs)
    shapes["text_embeddings.position_embeddings.weight"] = (spec.max_text_len, hs)
    shapes["text_embeddings.token_type_embeddings.weight"] = (2, hs)
    shapes["text_embeddings.LayerNorm.weight"] = (hs,)
    shapes["text_embeddings.LayerNorm.bias"] = (hs,)

    shapes["token_type_embeddings.weight"] = (spec.token_type_count, hs)

    shapes["transformer.cls_token"] = (1, 1, hs)
    shapes["transformer.mask_token"] = (1, 1, hs)
    if spec.distilled:
        shapes["transformer.dist_token"] = (1, 1, hs)
        shapes["transformer.pos_embed"] = (1, spec.num_patches + 2, hs)
    shapes["transformer.patch_embed.proj.weight"] = (
        hs, 3, spec.patch_size, spec.patch_size)
    shapes["transformer.patch_embed.proj.bias"] = (hs,)
    for b in spec.blocks:
        shapes.update(_block_param_shapes(spec, b))
    shapes["transformer.norm.weight"] = (hs,)
    shapes["transformer.norm.bias"] = (hs,)

    # One shared relative-position bias table for all layers
    # (reference vilt_module.py:139-140).
    shapes["relative_position_bias_table"] = (
        spec.all_num_relative_distance, spec.num_heads * spec.num_layers)
    shapes["temporal_relative_position_bias_table"] = (
        2 * spec.num_frames, spec.num_heads * spec.num_layers)

    shapes["pooler.dense.weight"] = (hs, hs)
    shapes["pooler.dense.bias"] = (hs,)

    if spec.use_mlm_head:
        shapes["mlm_score.transform.dense.weight"] = (hs, hs)
        shapes["mlm_score.transform.dense.bias"] = (hs,)
        shapes["mlm_score.transform.LayerNorm.weight"] = (hs,)
        shapes["mlm_score.transform.LayerNorm.bias"] = (hs,)
        shapes["mlm_score.decoder.weight"] = (spec.vocab_size, hs)
        shapes["mlm_score.bias"] = (spec.vocab_size,)
    if spec.use_itm_head:
        shapes["itm_score.fc.weight"] = (2, hs)
        shapes["itm_score.fc.bias"] = (2,)
    if spec.use_ifm_heads or spec.use_irtr_heads:
        shapes["ifm_text_proj.fc.weight"] = (hs, hs)
        shapes["ifm_image_proj.fc.weight"] = (hs, hs)
        shapes["logit_scale"] = ()
    if spec.use_ifm_heads:
        shapes["ifm_vl_text_proj.fc.weight"] = (hs, hs)
        shapes["ifm_vl_image_proj.fc.weight"] = (hs, hs)
        shapes["logit_vl_scale"] = ()
    if spec.use_mim_head:
        shapes["mim_score.weight"] = (spec.mim_vocab_size, hs)
        shapes["mim_score.bias"] = (spec.mim_vocab_size,)
    if spec.use_vqa_head:
        shapes["vqa_classifier.0.weight"] = (2 * hs, hs)
        shapes["vqa_classifier.0.bias"] = (2 * hs,)
        shapes["vqa_classifier.1.weight"] = (2 * hs,)
        shapes["vqa_classifier.1.bias"] = (2 * hs,)
        shapes["vqa_classifier.3.weight"] = (spec.vqav2_label_size, 2 * hs)
        shapes["vqa_classifier.3.bias"] = (spec.vqav2_label_size,)
    if spec.use_img_cls_head:
        shapes["img_cls_classifier.weight"] = (spec.img_cls_label_size, hs)
        shapes["img_cls_classifier.bias"] = (spec.img_cls_label_size,)
    if spec.use_nlvr2_head:
        shapes["nlvr2_classifier.0.weight"] = (2 * hs, 2 * hs)
        shapes["nlvr2_classifier.0.bias"] = (2 * hs,)
        shapes["nlvr2_classifier.1.weight"] = (2 * hs,)
        shapes["nlvr2_classifier.1.bias"] = (2 * hs,)
        shapes["nlvr2_classifier.3.weight"] = (2, 2 * hs)
        shapes["nlvr2_classifier.3.bias"] = (2,)
    return shapes


# --------------------------------------------------------------------------
# Initialization (matches reference init distributions)
# --------------------------------------------------------------------------

def _trunc_normal(shape, generator, std=0.02):
    # timm trunc_normal_: truncation at ±2 std
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                       generator=generator)


def _uniform(shape, bound, generator):
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


def init_params(spec: ModelSpec,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random init with the reference's distributions, as float32 CPU
    tensors drawn from ``generator`` (the JAX package's draws cannot be
    reproduced, and need not be: tests pass numpy-made params to both).

    Transformer trunk: trunc_normal(0.02) weights, zero biases, unit LNs,
    then BEiT depth rescale of attn.proj / mlp.fc weights by sqrt(2(i+1))
    (reference vision_transformer.py:895-912).  Heads: normal(0.02)
    (reference objectives.py:713-721).  Conv patch embed keeps the torch
    Conv2d default (kaiming-uniform).  The rel-pos bias tables start at
    zero, as in the reference."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params: Params = {}
    for name, shape in sorted(param_shapes(spec).items()):
        if name.endswith("gamma_1") or name.endswith("gamma_2"):
            val = torch.full(shape, 0.1)  # LayerScale init 0.1
        elif name in ("relative_position_bias_table",
                      "temporal_relative_position_bias_table"):
            val = torch.zeros(shape)
        elif name in ("logit_scale", "logit_vl_scale"):
            val = torch.tensor(float(np.log(1 / 0.07)))
        elif name in ("transformer.cls_token", "transformer.mask_token",
                      "transformer.dist_token", "transformer.pos_embed"):
            val = _trunc_normal(shape, generator)
        elif name == "transformer.patch_embed.proj.weight":
            fan_in = shape[1] * shape[2] * shape[3]
            val = _uniform(shape, float(np.sqrt(6.0 / ((1 + 5) * fan_in))),
                           generator)  # kaiming a=√5
        elif name == "transformer.patch_embed.proj.bias":
            fan_in = 3 * spec.patch_size * spec.patch_size
            val = _uniform(shape, float(1.0 / np.sqrt(fan_in)), generator)
        elif name.endswith("LayerNorm.weight") or (
            ".norm" in name and name.endswith(".weight")) or (
            name.endswith(".weight") and len(shape) == 1):
            val = torch.ones(shape)  # LayerNorm weight
        elif name.endswith("bias"):
            val = torch.zeros(shape)
        elif name.startswith("transformer."):
            val = _trunc_normal(shape, generator)
        else:
            val = 0.02 * torch.randn(shape, generator=generator)
        params[name] = val

    # BEiT depth rescale (vision_transformer.py:897-903)
    for b in spec.blocks:
        scale = float(np.sqrt(2 * (b.index + 1)))
        prefix = f"transformer.blocks.{b.index}."
        for name in list(params):
            if not name.startswith(prefix):
                continue
            tail = name[len(prefix):]
            if ("attn" in tail and "proj" in tail and "bias" not in tail) or (
                "mlp" in tail and "fc" in tail and "bias" not in tail
            ):
                params[name] = params[name] / scale
    return params
