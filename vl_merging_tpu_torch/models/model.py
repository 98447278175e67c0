"""VL-MoME towers, the fused VL pass and the task heads (port of
``vl_merging_tpu/models/model.py``).

``infer_image_ft`` and ``infer_text_ft`` are the towers the retrieval eval
and the irtr fine-tune run (vilt_module.py:1226-1285, 1378-1464);
``infer`` is the fused [text; image] pass (vilt_module.py:1071-1156) that
the VQA and NLVR2 evals and the ITM rerank run, eval-mode (its training
forward, and the vlffn re-runs of the towers, come with the pretrain
objectives).  Batches are dicts of tensors: ``text_ids`` (B, T) int,
``text_masks`` (B, T) int, ``image`` (B, 3, H, W) float (NLVR2:
``image_0``, ``image_1``).

With ``train=True`` the towers draw their randomness from a
``torch.Generator``: the text embedding's dropout and one (L, 2, B) table
of stochastic-depth scales per tower (``_dp_scale_table``).  The JAX
package's per-block remat (``use_remat``) is numerically a no-op and is
not carried over.

The JAX package pads the image sequence 577 → 592 for the TPU's sublanes
(``_seq_pad``), and each half of a fused sequence to a multiple of 16
(``infer``); the port runs the tokens as they are (577; 40 + 577 = 617)
and the kernels mask the ragged edges themselves.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import relpos
from .layers import dropout, gelu, layer_norm, linear
from .mome import LN_EPS, LayerBias, block_forward, splits
from .spec import L, ModelSpec, Params, V, VL

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
    tower or the "fused" pass; input-independent, so an eval loop computes
    it once.  ``true_length``: the text length of a "text" or "fused"
    bias (None: the spec's, vl-truncated for "fused" when max_vl_text_len
    is set).  The fused pass itself reads ``fused_layer_biases``."""
    index = {"image": lambda: relpos.image_index(spec),
             "text": lambda: relpos.text_index(spec, true_length),
             "fused": lambda: relpos.fused_index(spec, true_length)}[kind]()
    return relpos.per_layer_bias(params["relative_position_bias_table"],
                                 index, spec.num_layers, spec.num_heads)


def fused_layer_biases(params: Params, spec: ModelSpec,
                       text_len: int) -> List[LayerBias]:
    """The fused pass's rel-pos bias per layer, in the form each block
    reads it (``mome.LayerBias``): a split block (``mome.splits``) the
    pair of its text (H, t, t) and image (H, I, I) sub-blocks, every other
    block the joint (H, t + I, t + I) bias; each contiguous, gathered from
    the index slices (the fused index's text block is ``text_index[:t,
    :t]``, its image block ``image_index``) for only the layers that read
    it, so no layer copies a strided slice of the joint bias.  Gather once
    per eval call: at @480 (ViT-B, ten split layers) the image sub-blocks
    are 390 MB."""
    table = params["relative_position_bias_table"]
    split = [b.index for b in spec.blocks if splits(b, VL)]
    joint = [b.index for b in spec.blocks if not splits(b, VL)]

    def gather(index, layers):
        return relpos.per_layer_bias(table, index, spec.num_layers,
                                     spec.num_heads, layers=layers)

    out: List[LayerBias] = [None] * spec.num_layers
    if split:
        for i, t, v in zip(split,
                           gather(relpos.text_index(spec, text_len), split),
                           gather(relpos.image_index(spec), split)):
            out[i] = (t, v)
    if joint:
        for i, j in zip(joint, gather(relpos.fused_index(spec, text_len),
                                      joint)):
            out[i] = j
    return out


def pooler(params: Params, hidden_states: torch.Tensor) -> torch.Tensor:
    """Tanh-linear over token 0 (heads.py:8-18)."""
    return torch.tanh(linear(hidden_states[:, 0], params["pooler.dense.weight"],
                             params["pooler.dense.bias"]))


def infer(params: Params, spec: ModelSpec, batch: Dict, *,
          image_token_type_idx: int = 1,
          image: Optional[torch.Tensor] = None,
          rel_bias: Optional[Union[torch.Tensor, Sequence[LayerBias]]] = None,
          kernels: bool = True, int8_gelu: str = "poly",
          qk_int8: bool = False, fusion: str = "tail"
          ) -> Dict[str, Optional[torch.Tensor]]:
    """The fused VL pass, type_id=2, eval-mode (vilt_module.py:1071-1156):
    text and image embeddings (the image's token type
    ``image_token_type_idx``: NLVR2's second image is 2, read from
    ``image_1``), concatenated text first with the mask [text_masks, ones]
    (caption padding leaves zeros inside the key range), through every
    block as type VL, final LN and the pooler.  ``rel_bias``: the
    per-layer biases of ``fused_layer_biases`` (gathered here when None),
    or the (L, H, N, N) tensor of ``precompute_bias(..., "fused")``.  The
    routing arguments reach every block (``mome.block_forward``).  The
    JAX package pads each half to a multiple of 16 under its Pallas flag
    (model.py:248-270); the port runs text_len + image_len tokens."""
    dtype = spec.torch_compute_dtype
    text_ids, text_masks = batch["text_ids"], batch["text_masks"]
    if image is None:
        key = f"image_{image_token_type_idx - 1}"
        image = batch[key] if key in batch else batch["image"]
    t_emb = text_embed(params, spec, text_ids)
    i_emb, image_masks = visual_embed(params, spec, image)
    t_emb = t_emb + _token_type(params, 0, t_emb, dtype)
    i_emb = i_emb + _token_type(params, image_token_type_idx, i_emb, dtype)
    x = torch.cat([t_emb, i_emb], dim=1)
    co_masks = torch.cat([text_masks.to(torch.int32), image_masks], dim=1)
    text_len = t_emb.shape[1]
    bias = rel_bias if rel_bias is not None else fused_layer_biases(
        params, spec, text_len)
    for i, b in enumerate(spec.blocks):
        x = block_forward(params, spec, b, x, co_masks, bias[i], VL,
                          kernels=kernels, int8_gelu=int8_gelu,
                          qk_int8=qk_int8, fusion=fusion, text_len=text_len)
    x = _final_norm(params, x)
    return {"text_feats": x[:, :text_len], "image_feats": x[:, text_len:],
            "cls_feats": pooler(params, x), "raw_cls_feats": x[:, 0],
            "image_masks": image_masks, "image": image,
            "text_labels": batch.get("text_labels"), "text_ids": text_ids,
            "text_masks": text_masks}


def _text_trunk(params: Params, spec: ModelSpec, batch: Dict, *,
                rel_bias: Optional[torch.Tensor] = None,
                kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                int8_gelu: str = "poly",
                qk_int8: bool = False,
                fusion: str = "tail",
                train_fusion: str = "0") -> torch.Tensor:
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
                          dp_scale=None if dp is None else dp[i],
                          int8_gelu=int8_gelu, qk_int8=qk_int8,
                          fusion=fusion, train_fusion=train_fusion)
    return x


def infer_text_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                  rel_bias: Optional[torch.Tensor] = None,
                  kernels: bool = True, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  int8_gelu: str = "poly", qk_int8: bool = False,
                  fusion: str = "tail", train_fusion: str = "0"
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch text pass (vilt_module.py:1226-1285).  ``int8_gelu``
    and ``qk_int8`` select the int8 eval block's activation and attention,
    ``fusion`` the eval block's route (``mome._block_fast``; the text
    tower's 40 tokens never reach it), ``train_fusion`` the training
    block's (``mome._block_fast_train``)."""
    hidden = _text_trunk(params, spec, batch, rel_bias=rel_bias,
                         kernels=kernels, train=train, generator=generator,
                         int8_gelu=int8_gelu, qk_int8=qk_int8,
                         fusion=fusion, train_fusion=train_fusion)
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
                 generator: Optional[torch.Generator] = None,
                 int8_gelu: str = "poly", qk_int8: bool = False,
                 fusion: str = "tail", train_fusion: str = "0"):
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
                          dp_scale=None if dp is None else dp[i],
                          int8_gelu=int8_gelu, qk_int8=qk_int8,
                          fusion=fusion, train_fusion=train_fusion)
    return x, image_masks


def infer_image_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                   rel_bias: Optional[torch.Tensor] = None,
                   kernels: bool = True, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   int8_gelu: str = "poly", qk_int8: bool = False,
                   fusion: str = "tail", train_fusion: str = "0"
                   ) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch image pass (vilt_module.py:1378-1464).  ``int8_gelu``
    and ``qk_int8`` select the int8 eval block's activation and attention,
    ``fusion`` the eval block's route: "pair", "tail" (default), "qkv" or
    "mega" (``mome._block_fast``); ``train_fusion`` the training block's:
    "0" (default), "tail" or "full" (``mome._block_fast_train``)."""
    hidden, image_masks = _image_trunk(params, spec, batch["image"],
                                       rel_bias=rel_bias, kernels=kernels,
                                       train=train, generator=generator,
                                       int8_gelu=int8_gelu, qk_int8=qk_int8,
                                       fusion=fusion,
                                       train_fusion=train_fusion)
    vffn = _final_norm(params, hidden)
    if "ifm_image_proj.fc.weight" in params:
        cls_feats = _l2norm(linear(vffn[:, 0],
                                   params["ifm_image_proj.fc.weight"]))
    else:
        cls_feats = pooler(params, hidden)
    return {"image_feats": vffn, "cls_feats": cls_feats,
            "raw_cls_feats": hidden[:, 0], "image_masks": image_masks}


# --------------------------------------------------------------------------
# Heads (reference: src/vilt/modules/heads.py; the JAX package's
# model.py:498-547)
# --------------------------------------------------------------------------

def itm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, params["itm_score.fc.weight"], params["itm_score.fc.bias"])


def mlm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """BertPredictionHeadTransform (dense → gelu → LN) + the decoder
    (heads.py:40-52)."""
    h = gelu(linear(x, params["mlm_score.transform.dense.weight"],
                    params["mlm_score.transform.dense.bias"]))
    h = layer_norm(h, params["mlm_score.transform.LayerNorm.weight"],
                   params["mlm_score.transform.LayerNorm.bias"],
                   eps=BERT_LN_EPS)
    return linear(h, params["mlm_score.decoder.weight"]) + \
        params["mlm_score.bias"]


def mim_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, params["mim_score.weight"], params["mim_score.bias"])


def _classifier(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Linear → LN (eps 1e-5) → GELU → linear: the VQA and NLVR2 heads
    (vilt_module.py:301-309)."""
    h = linear(x, params[f"{name}.0.weight"], params[f"{name}.0.bias"])
    h = gelu(layer_norm(h, params[f"{name}.1.weight"],
                        params[f"{name}.1.bias"], eps=1e-5))
    return linear(h, params[f"{name}.3.weight"], params[f"{name}.3.bias"])


def vqa_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """hs → 2hs → LN → GELU → vqav2_label_size."""
    return _classifier(params, "vqa_classifier", x)


def nlvr2_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """2hs (the two passes' cls features) → 2hs → LN → GELU → 2."""
    return _classifier(params, "nlvr2_classifier", x)


def img_cls_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, params["img_cls_classifier.weight"],
                  params["img_cls_classifier.bias"])
