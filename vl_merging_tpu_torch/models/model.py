"""VL-MoME single-modality towers, eval only (port of
``vl_merging_tpu/models/model.py``).

``infer_image_ft`` and ``infer_text_ft`` are the towers the retrieval eval
runs (vilt_module.py:1226-1285, 1378-1464).  Batches are dicts of tensors:
``text_ids`` (B, T) int, ``text_masks`` (B, T) int, ``image``
(B, 3, H, W) float.

The JAX package pads the image sequence 577 → 592 for the TPU's sublanes
(``_seq_pad``); the port runs N = 577 and the kernels mask the ragged
edge themselves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import relpos
from .layers import layer_norm, linear
from .mome import LN_EPS, block_forward
from .spec import L, ModelSpec, Params, V

BERT_LN_EPS = 1e-12  # HF BertConfig default layer_norm_eps


def text_embed(params: Params, spec: ModelSpec,
               text_ids: torch.Tensor) -> torch.Tensor:
    """BertEmbeddings with position_embedding_type="rel_pos": word + bert
    token-type(0) → LayerNorm, on the (f32) table rows, then the cast to
    the compute dtype; absolute positions are NOT added
    (vilt_module.py:51-64)."""
    emb = params["text_embeddings.word_embeddings.weight"][text_ids.long()]
    emb = emb + params["text_embeddings.token_type_embeddings.weight"][0]
    emb = layer_norm(emb, params["text_embeddings.LayerNorm.weight"],
                     params["text_embeddings.LayerNorm.bias"], eps=BERT_LN_EPS)
    return emb.to(spec.torch_compute_dtype)


def visual_embed(params: Params, spec: ModelSpec, image: torch.Tensor):
    """Conv patchify + cls prepend (reference vision_transformer.py:952-991).
    Returns (embeds (B, 1 + P, C), masks (B, 1 + P) int32)."""
    dtype = spec.torch_compute_dtype
    w = params["transformer.patch_embed.proj.weight"].to(dtype)
    x = F.conv2d(image.to(dtype), w, stride=spec.patch_size)
    x = x + params["transformer.patch_embed.proj.bias"].to(dtype)[
        None, :, None, None]
    B = x.shape[0]
    x = x.reshape(B, spec.hidden_size, -1).transpose(1, 2)    # B, P, C
    cls = params["transformer.cls_token"].to(dtype).expand(
        B, 1, spec.hidden_size)
    x = torch.cat([cls, x], dim=1).contiguous()
    masks = torch.ones((B, x.shape[1]), dtype=torch.int32, device=x.device)
    return x, masks


def _final_norm(params: Params, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, params["transformer.norm.weight"],
                      params["transformer.norm.bias"], eps=LN_EPS)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _token_type(params: Params, idx: int, shape_like: torch.Tensor,
                dtype) -> torch.Tensor:
    table = params["token_type_embeddings.weight"].to(dtype)
    return table[idx].expand(*shape_like.shape[:2], table.shape[-1])


def precompute_bias(params: Params, spec: ModelSpec, kind: str,
                    true_length: Optional[int] = None) -> torch.Tensor:
    """Per-layer rel-pos bias (L, H, N, N) f32 for the "image" or "text"
    tower; input-independent, so an eval loop computes it once."""
    if kind == "image":
        index = relpos.image_index(spec)
    elif kind == "text":
        index = relpos.text_index(spec, true_length)
    else:
        raise NotImplementedError(
            f"rel-pos bias kind {kind!r} (fused VL pass) is not ported yet: "
            f"ROADMAP A4")
    return relpos.per_layer_bias(params["relative_position_bias_table"],
                                 index, spec.num_layers, spec.num_heads)


def pooler(params: Params, hidden_states: torch.Tensor) -> torch.Tensor:
    """Tanh-linear over token 0 (heads.py:8-18)."""
    return torch.tanh(linear(hidden_states[:, 0], params["pooler.dense.weight"],
                             params["pooler.dense.bias"]))


def _text_trunk(params: Params, spec: ModelSpec, batch: Dict, *,
                rel_bias: Optional[torch.Tensor] = None,
                kernels: bool = True) -> torch.Tensor:
    """Text tower body of infer_text_ft (vilt_module.py:1226-1285), without
    the vlffn re-run; returns the last hidden state."""
    text_ids = batch["text_ids"]
    text_masks = batch["text_masks"].to(torch.int32)
    x = text_embed(params, spec, text_ids)
    x = x + _token_type(params, 0, x, x.dtype)

    true_length = text_ids.shape[1] if spec.max_vl_text_len is not None \
        else None
    bias = rel_bias if rel_bias is not None else precompute_bias(
        params, spec, "text", true_length)
    for i, b in enumerate(spec.blocks):
        x = block_forward(params, spec, b, x, text_masks, bias[i], L,
                          kernels=kernels)
    return x


def infer_text_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                  rel_bias: Optional[torch.Tensor] = None,
                  kernels: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch text pass (vilt_module.py:1226-1285)."""
    hidden = _text_trunk(params, spec, batch, rel_bias=rel_bias,
                         kernels=kernels)
    lffn = _final_norm(params, hidden)
    cls_feats = None
    if "ifm_text_proj.fc.weight" in params:
        cls_feats = _l2norm(linear(lffn[:, 0],
                                   params["ifm_text_proj.fc.weight"]))
    return {"text_feats": lffn, "cls_feats": cls_feats,
            "raw_cls_feats": hidden[:, 0],
            "text_masks": batch["text_masks"]}


def _image_trunk(params: Params, spec: ModelSpec, image: torch.Tensor, *,
                 rel_bias: Optional[torch.Tensor] = None,
                 kernels: bool = True):
    """Image tower body of infer_image_ft, without the vlffn re-run;
    returns (last hidden state, image masks).  Token type 1 marks the
    (first) image; NLVR2's second image comes with the fused VL pass."""
    x, image_masks = visual_embed(params, spec, image)
    x = x + _token_type(params, 1, x, x.dtype)
    bias = rel_bias if rel_bias is not None else precompute_bias(
        params, spec, "image")
    for i, b in enumerate(spec.blocks):
        x = block_forward(params, spec, b, x, image_masks, bias[i], V,
                          kernels=kernels)
    return x, image_masks


def infer_image_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                   rel_bias: Optional[torch.Tensor] = None,
                   kernels: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch image pass (vilt_module.py:1378-1464)."""
    hidden, image_masks = _image_trunk(params, spec, batch["image"],
                                       rel_bias=rel_bias, kernels=kernels)
    vffn = _final_norm(params, hidden)
    if "ifm_image_proj.fc.weight" in params:
        cls_feats = _l2norm(linear(vffn[:, 0],
                                   params["ifm_image_proj.fc.weight"]))
    else:
        cls_feats = pooler(params, hidden)
    return {"image_feats": vffn, "cls_feats": cls_feats,
            "raw_cls_feats": hidden[:, 0], "image_masks": image_masks}
