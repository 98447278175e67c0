"""VL-MoME towers, the fused VL pass and the task heads (port of
``vl_merging_tpu/models/model.py``).

``infer_image_ft`` and ``infer_text_ft`` are the single-branch towers the
retrieval eval and the fine-tunes run (vilt_module.py:1226-1285,
1378-1464); ``infer_image`` and ``infer_text`` the pretrain towers, which
also re-run the deep layers (``vlffn_start_layer_index`` on) as type VL
from the state of the layer before them for the second contrastive head
(vilt_module.py:1159-1223, 1287-1375); ``infer`` is the fused [text;
image] pass (vilt_module.py:1071-1156) of the VQA, NLVR2, MLM, MIM and
ITM objectives and the ITM rerank.  Batches are dicts of tensors:
``text_ids`` (B, T) int, ``text_masks`` (B, T) int, ``image`` (B, 3, H, W)
float (NLVR2: ``image_0``, ``image_1``), and for the masked objectives
``text_ids_mlm`` / ``text_labels_mlm`` and ``image_masked_pos``.

With ``train=True`` every pass draws its randomness from a
``torch.Generator``: the text embedding's dropout and one (L, 2, B) table
of stochastic-depth scales per pass and per re-run
(``_dp_scale_table``), whose (2, B) slice a split block's two halves
share.  Under a process group both are drawn at the global batch and
each rank keeps its rows (``layers.rank_rand``).  The JAX package's
per-block remat (``use_remat``) is numerically a no-op and is not
carried over.  In training the rel-pos bias is
gathered from the table inside the autograd graph on every call, so its
gradient reaches ``relative_position_bias_table``.

The JAX package pads the image sequence 577 → 592 for the TPU's sublanes
(``_seq_pad``), and each half of a fused sequence to a multiple of 16
(``infer``); the port runs the tokens as they are (577; 40 + 577 = 617)
and the kernels mask the ragged edges themselves.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import relpos
from ..parallel import host
from .layers import dropout, gelu, layer_norm, linear, rank_rand
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


def visual_embed(params: Params, spec: ModelSpec, image: torch.Tensor, *,
                 bool_masked_pos: Optional[torch.Tensor] = None):
    """Conv patchify, the MIM mask token in place of every patch that
    ``bool_masked_pos`` (B, P) marks, and the cls prepend (reference
    vision_transformer.py:952-991; model.py:50-79).  Returns (embeds
    (B, 1 + P, C), masks (B, 1 + P) int32)."""
    dtype = spec.torch_compute_dtype
    w = params["transformer.patch_embed.proj.weight"].to(dtype)
    x = F.conv2d(image.to(dtype), w, stride=spec.patch_size)
    x = x + params["transformer.patch_embed.proj.bias"].to(dtype)[
        None, :, None, None]
    B = x.shape[0]
    x = x.reshape(B, spec.hidden_size, -1).transpose(1, 2)    # B, P, C
    if bool_masked_pos is not None:
        wmask = bool_masked_pos[:, :, None].to(dtype)
        x = x * (1 - wmask) + params["transformer.mask_token"].to(dtype) * \
            wmask
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
    None outside training, without a generator, or at drop rate 0.  Under
    a process group ``batch`` is this rank's share and the draw is the
    global batch's (``layers.rank_rand``).

    ``table`` replaces the draw with given scales of the global shape
    (L, 2, B × world size), of which this rank takes its samples (tests
    feed the JAX package's table through it)."""
    if not train or generator is None or spec.drop_rate <= 0.0:
        return None
    shape = (spec.num_layers, 2, batch)
    if table is not None:
        table = torch.as_tensor(np.asarray(table, np.float32), device=device)
        world = host.get_world_size()
        if tuple(table.shape) != (shape[0], 2, batch * world):
            raise ValueError(f"dp_scale table of shape {tuple(table.shape)}, "
                             f"expected {(shape[0], 2, batch * world)}")
        return table[:, :, host.process_rows(batch * world)]
    keep = torch.tensor(1.0 - np.asarray(_drop_path_rates(spec), np.float32),
                        device=generator.device)[:, None, None]
    u = rank_rand(shape, generator, axis=2)
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


def _layer(dp: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
    return None if dp is None else dp[i]


def infer(params: Params, spec: ModelSpec, batch: Dict, *,
          mask_text: bool = False,
          bool_masked_pos: Optional[torch.Tensor] = None,
          image_token_type_idx: int = 1,
          image: Optional[torch.Tensor] = None,
          rel_bias: Optional[Union[torch.Tensor, Sequence[LayerBias]]] = None,
          train: bool = False, generator: Optional[torch.Generator] = None,
          kernels: bool = True, int8_gelu: str = "poly",
          qk_int8: bool = False, fusion: str = "tail",
          train_fusion: str = "0") -> Dict[str, Optional[torch.Tensor]]:
    """The fused VL pass, type_id=2 (vilt_module.py:1071-1156): text and
    image embeddings (the image's token type ``image_token_type_idx``:
    NLVR2's second image is 2, read from ``image_1``), concatenated text
    first with the mask [text_masks, ones] (caption padding leaves zeros
    inside the key range), through every block as type VL, final LN and
    the pooler.  ``mask_text`` reads ``text_ids_mlm`` and
    ``text_labels_mlm`` (MLM), ``bool_masked_pos`` (B, P) swaps the marked
    patches for the mask token (MIM).  ``train``: text dropout and the
    pass's stochastic-depth table from ``generator``, and the training
    block (``train_fusion``).  ``rel_bias``: the per-layer biases of
    ``fused_layer_biases`` (gathered here when None, inside the autograd
    graph), or the (L, H, N, N) tensor of ``precompute_bias(...,
    "fused")``.  The routing arguments reach every block
    (``mome.block_forward``).  The JAX package pads each half to a
    multiple of 16 under its Pallas flag (model.py:248-270); the port
    runs text_len + image_len tokens."""
    dtype = spec.torch_compute_dtype
    mlm = "_mlm" if mask_text else ""
    text_ids, text_masks = batch[f"text_ids{mlm}"], batch["text_masks"]
    if image is None:
        key = f"image_{image_token_type_idx - 1}"
        image = batch[key] if key in batch else batch["image"]
    dp = _dp_scale_table(spec, generator, train, text_ids.shape[0],
                         text_ids.device)
    t_emb = text_embed(params, spec, text_ids, train=train,
                       generator=generator)
    i_emb, image_masks = visual_embed(params, spec, image,
                                      bool_masked_pos=bool_masked_pos)
    t_emb = t_emb + _token_type(params, 0, t_emb, dtype)
    i_emb = i_emb + _token_type(params, image_token_type_idx, i_emb, dtype)
    x = torch.cat([t_emb, i_emb], dim=1)
    co_masks = torch.cat([text_masks.to(torch.int32), image_masks], dim=1)
    text_len = t_emb.shape[1]
    bias = rel_bias if rel_bias is not None else fused_layer_biases(
        params, spec, text_len)
    for i, b in enumerate(spec.blocks):
        x = block_forward(params, spec, b, x, co_masks, bias[i], VL,
                          kernels=kernels, train=train,
                          dp_scale=_layer(dp, i), int8_gelu=int8_gelu,
                          qk_int8=qk_int8, fusion=fusion,
                          train_fusion=train_fusion, text_len=text_len)
    x = _final_norm(params, x)
    return {"text_feats": x[:, :text_len], "image_feats": x[:, text_len:],
            "cls_feats": pooler(params, x), "raw_cls_feats": x[:, 0],
            "image_masks": image_masks, "image": image,
            "text_labels": batch.get(f"text_labels{mlm}"),
            "text_ids": text_ids, "text_masks": text_masks}


def _vlffn_rerun(params: Params, spec: ModelSpec, x: torch.Tensor, mask,
                 bias, dp, route: Dict,
                 text_len: Optional[int]) -> torch.Tensor:
    """Layers ``vlffn_start_layer_index``…L-1 again as type VL from ``x``,
    the state after layer k-1 (vilt_module.py:1190-1192; the JAX package's
    model.py:329-337, :429-439):
    the second contrastive head's branch."""
    for i in range(spec.vlffn_start_layer_index, spec.num_layers):
        x = block_forward(params, spec, spec.blocks[i], x, mask, bias[i], VL,
                          dp_scale=_layer(dp, i), text_len=text_len, **route)
    return x


def _text_trunk(params: Params, spec: ModelSpec, batch: Dict, *,
                mask_text: bool = False, vlffn_rerun: bool = False,
                rel_bias: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                **route) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The text tower's body (vilt_module.py:1159-1285): (last hidden
    state, the vlffn re-run's or None).  The re-run infers its split
    point from the shape, as the JAX package's does (model.py:329-337).
    In training the bias is gathered here, inside the autograd graph, so
    that its gradient reaches the rel-pos table."""
    text_ids = batch["text_ids_mlm" if mask_text else "text_ids"]
    text_masks = batch["text_masks"].to(torch.int32)
    B, dev = text_ids.shape[0], text_ids.device
    dp = _dp_scale_table(spec, generator, train, B, dev)
    dp_vl = _dp_scale_table(spec, generator, train, B, dev) \
        if vlffn_rerun else None
    x = text_embed(params, spec, text_ids, train=train, generator=generator)
    x = x + _token_type(params, 0, x, x.dtype)

    true_length = text_ids.shape[1] if spec.max_vl_text_len is not None \
        else None
    bias = rel_bias if rel_bias is not None else precompute_bias(
        params, spec, "text", true_length)
    route = dict(route, train=train)
    before_vl = None
    for i, b in enumerate(spec.blocks):
        if i == spec.vlffn_start_layer_index:
            before_vl = x
        x = block_forward(params, spec, b, x, text_masks, bias[i], L,
                          dp_scale=_layer(dp, i), **route)
    if before_vl is None:   # vlffn_start_layer_index is the depth: the
        before_vl = x       # re-run starts from the last layer's output
    vlffn = _vlffn_rerun(params, spec, before_vl, text_masks, bias, dp_vl,
                         route, None) if vlffn_rerun else None
    return x, vlffn


def _text_out(params: Params, batch: Dict, hidden: torch.Tensor,
              mask_text: bool) -> Dict:
    lffn = _final_norm(params, hidden)
    cls_feats = None
    if "ifm_text_proj.fc.weight" in params:
        cls_feats = _l2norm(linear(lffn[:, 0],
                                   params["ifm_text_proj.fc.weight"]))
    mlm = "_mlm" if mask_text else ""
    return {"text_feats": lffn, "image_feats": None, "cls_feats": cls_feats,
            "cls_vlffn_feats": None, "raw_cls_feats": hidden[:, 0],
            "text_labels": batch.get(f"text_labels{mlm}"),
            "text_ids": batch[f"text_ids{mlm}"],
            "text_masks": batch["text_masks"]}


def infer_text_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                  mask_text: bool = False,
                  rel_bias: Optional[torch.Tensor] = None,
                  kernels: bool = True, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  int8_gelu: str = "poly", qk_int8: bool = False,
                  fusion: str = "tail", train_fusion: str = "0"
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch text pass (vilt_module.py:1226-1285); ``mask_text``
    reads the MLM ids and labels.  ``int8_gelu`` and ``qk_int8`` select
    the int8 eval block's activation and attention, ``fusion`` the eval
    block's route (``mome._block_fast``; the text tower's 40 tokens never
    reach it), ``train_fusion`` the training block's
    (``mome._block_fast_train``)."""
    hidden, _ = _text_trunk(params, spec, batch, mask_text=mask_text,
                            rel_bias=rel_bias, train=train,
                            generator=generator, kernels=kernels,
                            int8_gelu=int8_gelu, qk_int8=qk_int8,
                            fusion=fusion, train_fusion=train_fusion)
    return _text_out(params, batch, hidden, mask_text)


def infer_text(params: Params, spec: ModelSpec, batch: Dict, *,
               mask_text: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None,
               kernels: bool = True, train_fusion: str = "0"
               ) -> Dict[str, Optional[torch.Tensor]]:
    """The pretrain text pass with the vlffn re-run
    (vilt_module.py:1159-1223): ``cls_feats`` through ``ifm_text_proj``,
    ``cls_vlffn_feats`` through ``ifm_vl_text_proj``, both l2-normed."""
    hidden, vlffn = _text_trunk(params, spec, batch, mask_text=mask_text,
                                vlffn_rerun=True, train=train,
                                generator=generator, kernels=kernels,
                                train_fusion=train_fusion)
    out = _text_out(params, batch, hidden, mask_text)
    out["cls_vlffn_feats"] = _l2norm(linear(
        _final_norm(params, vlffn)[:, 0], params["ifm_vl_text_proj.fc.weight"]))
    return out


def _image_trunk(params: Params, spec: ModelSpec, image: torch.Tensor, *,
                 bool_masked_pos: Optional[torch.Tensor] = None,
                 vlffn_rerun: bool = False,
                 rel_bias: Optional[torch.Tensor] = None,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 **route):
    """The image tower's body (vilt_module.py:1287-1464): (last hidden
    state, the vlffn re-run's or None, image masks).  Token type 1 marks
    the (first) image; NLVR2's second image comes with the fused VL pass.
    The re-run runs the image tokens as a VL sequence with no text
    (``text_len`` 0, as the JAX package passes it: model.py:429-439).  In
    training the bias is gathered here, inside the autograd graph."""
    x, image_masks = visual_embed(params, spec, image,
                                  bool_masked_pos=bool_masked_pos)
    dp = _dp_scale_table(spec, generator, train, x.shape[0], x.device)
    dp_vl = _dp_scale_table(spec, generator, train, x.shape[0], x.device) \
        if vlffn_rerun else None
    x = x + _token_type(params, 1, x, x.dtype)
    bias = rel_bias if rel_bias is not None else precompute_bias(
        params, spec, "image")
    route = dict(route, train=train)
    before_vl = None
    for i, b in enumerate(spec.blocks):
        if i == spec.vlffn_start_layer_index:
            before_vl = x
        x = block_forward(params, spec, b, x, image_masks, bias[i], V,
                          dp_scale=_layer(dp, i), **route)
    if before_vl is None:   # vlffn_start_layer_index is the depth: the
        before_vl = x       # re-run starts from the last layer's output
    vlffn = _vlffn_rerun(params, spec, before_vl, image_masks, bias, dp_vl,
                         route, 0) if vlffn_rerun else None
    return x, vlffn, image_masks


def _image_out(params: Params, hidden: torch.Tensor, image_masks) -> Dict:
    vffn = _final_norm(params, hidden)
    if "ifm_image_proj.fc.weight" in params:
        cls_feats = _l2norm(linear(vffn[:, 0],
                                   params["ifm_image_proj.fc.weight"]))
    else:
        cls_feats = pooler(params, hidden)
    return {"text_feats": None, "image_feats": vffn, "cls_feats": cls_feats,
            "cls_vlffn_feats": None, "raw_cls_feats": hidden[:, 0],
            "image_masks": image_masks}


def infer_image_ft(params: Params, spec: ModelSpec, batch: Dict, *,
                   bool_masked_pos: Optional[torch.Tensor] = None,
                   rel_bias: Optional[torch.Tensor] = None,
                   kernels: bool = True, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   int8_gelu: str = "poly", qk_int8: bool = False,
                   fusion: str = "tail", train_fusion: str = "0"
                   ) -> Dict[str, Optional[torch.Tensor]]:
    """Single-branch image pass (vilt_module.py:1378-1464);
    ``bool_masked_pos`` (B, P) masks patches (image-only MIM).
    ``int8_gelu`` and ``qk_int8`` select the int8 eval block's activation
    and attention, ``fusion`` the eval block's route: "pair", "tail"
    (default), "qkv" or "mega" (``mome._block_fast``); ``train_fusion``
    the training block's: "0" (default), "tail" or "full"
    (``mome._block_fast_train``)."""
    hidden, _, image_masks = _image_trunk(
        params, spec, batch["image"], bool_masked_pos=bool_masked_pos,
        rel_bias=rel_bias, train=train, generator=generator,
        kernels=kernels, int8_gelu=int8_gelu, qk_int8=qk_int8,
        fusion=fusion, train_fusion=train_fusion)
    return _image_out(params, hidden, image_masks)


def infer_image(params: Params, spec: ModelSpec, batch: Dict, *,
                bool_masked_pos: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                kernels: bool = True, train_fusion: str = "0"
                ) -> Dict[str, Optional[torch.Tensor]]:
    """The pretrain image pass with the vlffn re-run
    (vilt_module.py:1287-1375): ``cls_feats`` through ``ifm_image_proj``,
    ``cls_vlffn_feats`` through ``ifm_vl_image_proj``, both l2-normed."""
    hidden, vlffn, image_masks = _image_trunk(
        params, spec, batch["image"], bool_masked_pos=bool_masked_pos,
        vlffn_rerun=True, train=train, generator=generator,
        kernels=kernels, train_fusion=train_fusion)
    out = _image_out(params, hidden, image_masks)
    out["cls_vlffn_feats"] = _l2norm(linear(
        _final_norm(params, vlffn)[:, 0],
        params["ifm_vl_image_proj.fc.weight"]))
    return out


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
