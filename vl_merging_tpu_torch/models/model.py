"""VL-MoME single-modality towers (port of
``vl_merging_tpu/models/model.py``).

``infer_image_ft`` and ``infer_text_ft`` are the towers the retrieval eval
and the irtr fine-tune run (vilt_module.py:1226-1285, 1378-1464).  Batches
are dicts of tensors: ``text_ids`` (B, T) int, ``text_masks`` (B, T) int,
``image`` (B, 3, H, W) float.

With ``train=True`` the towers draw their randomness from a
``torch.Generator``: the text embedding's dropout and one (L, 2, B) table
of stochastic-depth scales per tower (``_dp_scale_table``).  The JAX
package's per-block remat (``use_remat``) is numerically a no-op and is
not carried over.

The JAX package pads the image sequence 577 → 592 for the TPU's sublanes
(``_seq_pad``); the port runs N = 577 and the kernels mask the ragged
edge themselves.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import relpos
from .layers import dropout, layer_norm, linear
from .mome import LN_EPS, block_forward
from .spec import L, ModelSpec, Params, V

BERT_LN_EPS = 1e-12  # HF BertConfig default layer_norm_eps


def text_embed(params: Params, spec: ModelSpec, text_ids: torch.Tensor, *,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """BertEmbeddings with position_embedding_type="rel_pos": word + bert
    token-type(0) → LayerNorm → dropout, on the (f32) table rows, then the
    cast to the compute dtype; absolute positions are NOT added
    (vilt_module.py:51-64)."""
    emb = params["text_embeddings.word_embeddings.weight"][text_ids.long()]
    emb = emb + params["text_embeddings.token_type_embeddings.weight"][0]
    emb = layer_norm(emb, params["text_embeddings.LayerNorm.weight"],
                     params["text_embeddings.LayerNorm.bias"], eps=BERT_LN_EPS)
    emb = dropout(emb, spec.drop_rate, generator, train)
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


def _drop_path_rates(spec: ModelSpec):
    # torch.linspace(0, drop_path_rate, depth) (vision_transformer.py:861-863)
    if spec.num_layers == 1:
        return [0.0]
    return [spec.drop_rate * i / (spec.num_layers - 1)
            for i in range(spec.num_layers)]


def _dp_scale_table(spec: ModelSpec, generator: Optional[torch.Generator],
                    train: bool, batch: int, device,
                    table=None) -> Optional[torch.Tensor]:
    """All of a pass's stochastic-depth scales in one draw: (L, 2, B) f32,
    1/keep or 0 per (layer, residual branch, sample) with the layer's keep
    probability (timm DropPath semantics; layer 0 keeps everything).
    None outside training, without a generator, or at drop rate 0.

    ``table`` replaces the draw with given scales of that shape (tests feed
    the JAX package's table through it)."""
    if not train or generator is None or spec.drop_rate <= 0.0:
        return None
    shape = (spec.num_layers, 2, batch)
    if table is not None:
        table = torch.as_tensor(np.asarray(table, np.float32), device=device)
        if tuple(table.shape) != shape:
            raise ValueError(f"dp_scale table of shape {tuple(table.shape)}, "
                             f"expected {shape}")
        return table
    keep = torch.tensor(1.0 - np.asarray(_drop_path_rates(spec), np.float32),
                        device=generator.device)[:, None, None]
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((u < keep).float() / keep).to(device)


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
                kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Text tower body of infer_text_ft (vilt_module.py:1226-1285), without
    the vlffn re-run; returns the last hidden state.  In training the bias
    is gathered here, inside the autograd graph, so that its gradient
    reaches the rel-pos table."""
    text_ids = batch["text_ids"]
    text_masks = batch["text_masks"].to(torch.int32)
    dp = _dp_scale_table(spec, generator, train, text_ids.shape[0],
                         text_ids.device)
    x = text_embed(params, spec, text_ids, train=train, generator=generator)
    x = x + _token_type(params, 0, x, x.dtype)

    true_length = text_ids.shape[1] if spec.max_vl_text_len is not None \
        else None
    bias = rel_bias if rel_bias is not None else precompute_bias(
        params, spec, "text", true_length)
    for i, b in enumerate(spec.blocks):
        x = block_forward(params, spec, b, x, text_masks, bias[i], L,
                          kernels=kernels, train=train,
                          dp_scale=None if dp is None else dp[i])
    return x


def infer_text_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                  rel_bias: Optional[torch.Tensor] = None,
                  kernels: bool = True, train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch text pass (vilt_module.py:1226-1285)."""
    hidden = _text_trunk(params, spec, batch, rel_bias=rel_bias,
                         kernels=kernels, train=train, generator=generator)
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
                 kernels: bool = True, train: bool = False,
                 generator: Optional[torch.Generator] = None):
    """Image tower body of infer_image_ft, without the vlffn re-run;
    returns (last hidden state, image masks).  Token type 1 marks the
    (first) image; NLVR2's second image comes with the fused VL pass.  In
    training the bias is gathered here, inside the autograd graph."""
    x, image_masks = visual_embed(params, spec, image)
    dp = _dp_scale_table(spec, generator, train, x.shape[0], x.device)
    x = x + _token_type(params, 1, x, x.dtype)
    bias = rel_bias if rel_bias is not None else precompute_bias(
        params, spec, "image")
    for i, b in enumerate(spec.blocks):
        x = block_forward(params, spec, b, x, image_masks, bias[i], V,
                          kernels=kernels, train=train,
                          dp_scale=None if dp is None else dp[i])
    return x, image_masks


def infer_image_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                   rel_bias: Optional[torch.Tensor] = None,
                   kernels: bool = True, train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch image pass (vilt_module.py:1378-1464)."""
    hidden, image_masks = _image_trunk(params, spec, batch["image"],
                                       rel_bias=rel_bias, kernels=kernels,
                                       train=train, generator=generator)
    vffn = _final_norm(params, hidden)
    if "ifm_image_proj.fc.weight" in params:
        cls_feats = _l2norm(linear(vffn[:, 0],
                                   params["ifm_image_proj.fc.weight"]))
    else:
        cls_feats = pooler(params, hidden)
    return {"image_feats": vffn, "cls_feats": cls_feats,
            "raw_cls_feats": hidden[:, 0], "image_masks": image_masks}
