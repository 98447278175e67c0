"""DistilledVisionTransformer: the DeiT dist token and the dynamic-patch
embedding (port of ``vl_merging_tpu/models/distilled.py``).

The reference's legacy ViLT/pixelbert path
(src/vilt/modules/vision_transformer.py:1011-1163) feeds
variable-resolution images, marks the real pixels with a mask,
interpolates the absolute position embeddings per image to its true
(h, w) patch grid, and samples or pads each image's patches to a fixed
``max_image_len``.  As in the JAX package:

* images arrive zero-padded to a fixed (S, S) canvas; each image's true
  grid (h, w) comes from the pixel mask (vision_transformer.py:1032-1035);
* the per-image pos-embed interpolation (bilinear, align_corners=True,
  :1038-1046) is a batched gather at per-image source coordinates;
* the reference's per-image ``torch.multinomial`` loop (:1100-1116) is one
  random-key ranking: every patch gets a uniform key, invalid patches +2
  so they sort last, and ``topk`` keeps ``max_image_len`` (a uniform
  random subset of the valid patches when there are more, else all of
  them padded with masked-out invalid ones);
* ``max_image_len=-1`` (the reference's data-dependent ``eff.max()``,
  :1075-1086) takes the static bound H*W.

The randomness (the ranking keys and the MPP masks, :918-950) is drawn
apart from the computation (``distilled_draws``), so the tests replay the
JAX package's ``jax.random`` draws through the same code.  The blocks run
``mome.block_forward`` (type V, key-padding mask, no relative bias); at
the DeiT lengths (N = 146) they are under ``KERNEL_MIN_N`` and take the
plain attention, and K13 where the rows reach ``MLP_MIN_ROWS``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import layer_norm, rank_rand
from .spec import ModelSpec, Params, V


def _nearest_mask(pix_mask: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """A (B, Hin, Win) pixel mask at the (hp, wp) patch grid, torch
    ``F.interpolate`` nearest: src = floor(dst * in / out)
    (vision_transformer.py:1033)."""
    hin, win = pix_mask.shape[1], pix_mask.shape[2]
    dev = pix_mask.device
    ri = (torch.arange(hp, device=dev) * hin) // hp
    ci = (torch.arange(wp, device=dev) * win) // wp
    return pix_mask[:, ri][:, :, ci]


def _bilinear_pos(spatial_pos: torch.Tensor, h: torch.Tensor,
                  w: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The (P, P, C) pos-embed grid sampled at each image's (h, w) patch
    grid, bilinear with align_corners=True, zero-padded to (hp, wp):
    (B, hp, wp, C) for h, w of shape (B,) (vision_transformer.py:
    1038-1046)."""
    p = spatial_pos.shape[0]
    dev = spatial_pos.device

    def axis_coords(n_out, size):
        # align_corners=True: src = dst * (P-1) / (out-1); out == 1 → 0
        size = size.float()[:, None]
        # divided by a tensor, the IEEE quotient (int / tensor would
        # multiply by the tensor's reciprocal)
        scale = torch.where(size > 1, size.new_tensor(float(p - 1))
                            / torch.clamp(size - 1, min=1),
                            torch.zeros_like(size))
        return torch.arange(n_out, dtype=torch.float32, device=dev) * scale

    sy = axis_coords(hp, h)                                  # B,hp
    sx = axis_coords(wp, w)                                  # B,wp
    y0 = torch.floor(sy).long().clamp(0, p - 1)
    x0 = torch.floor(sx).long().clamp(0, p - 1)
    y1 = (y0 + 1).clamp(max=p - 1)
    x1 = (x0 + 1).clamp(max=p - 1)
    fy = (sy - y0.float())[:, :, None, None]                 # B,hp,1,1
    fx = (sx - x0.float())[:, None, :, None]                 # B,1,wp,1

    def grid(yi, xi):
        return spatial_pos[yi[:, :, None], xi[:, None, :]]  # B,hp,wp,C

    out = (grid(y0, x0) * (1 - fy) * (1 - fx) + grid(y0, x1) * (1 - fy) * fx
           + grid(y1, x0) * fy * (1 - fx) + grid(y1, x1) * fy * fx)
    valid = ((torch.arange(hp, device=dev)[None, :, None] < h[:, None, None])
             & (torch.arange(wp, device=dev)[None, None, :]
                < w[:, None, None]))[..., None]
    return torch.where(valid, out, torch.zeros_like(out))


def distilled_draws(batch: int, n: int, generator: torch.Generator,
                    mask_it: bool = False) -> Dict[str, torch.Tensor]:
    """The randomness of ``distilled_visual_embed`` for ``batch`` images of
    ``n`` patches, from ``generator`` (``rank_rand``): the ranking keys
    and, with ``mask_it``, the MPP masks (15% of the patches selected, 80%
    of those replaced)."""
    u = rank_rand((3 if mask_it else 1, batch, n), generator, axis=1)
    out = {"keys": u[0]}
    if mask_it:
        out["mpp_masked"] = u[1] < 0.15
        out["mpp_replaced"] = u[2] < 0.8
    return out


def mpp_mask_tokens(params: Params, spec: ModelSpec, image: torch.Tensor,
                    feats: torch.Tensor, masked: torch.Tensor,
                    replaced: torch.Tensor):
    """Masked-patch-prediction corruption (vision_transformer.py:918-950):
    the labels are the 255-binned per-patch mean colors where ``masked``
    (B, N) (-100 elsewhere); the embeddings of ``replaced & masked``
    patches become the mask token.  Returns (feats, labels (B, N, 3))."""
    ps = spec.patch_size
    img_unnorm = image * 0.5 + 0.5                           # B,3,S,S
    b, _, s, _ = image.shape
    hp = s // ps
    patch_mean = img_unnorm.reshape(b, 3, hp, ps, hp, ps).mean(dim=(3, 5))
    labels = (patch_mean * 255).to(torch.int32)
    labels = labels.reshape(b, 3, hp * hp).transpose(1, 2)   # B,N,3
    labels = torch.where(masked[..., None], labels,
                         torch.full_like(labels, -100))
    replaced = replaced & masked
    mask_token = params["transformer.mask_token"].to(feats.dtype)
    feats = torch.where(replaced[..., None], mask_token[0], feats)
    return feats, labels


def distilled_visual_embed(params: Params, spec: ModelSpec,
                           image: torch.Tensor, draws: Dict[str, torch.Tensor],
                           *, max_image_len: int = 144,
                           mask_it: bool = False):
    """DeiT visual embedding with dynamic patch sampling.

    image: (B, 3, S, S) float, zero outside each image's true extent
    (top-left anchored, the pixelbert collate); draws: ``distilled_draws``
    (or the JAX package's replayed).  Returns ``(x, x_mask, (patch_index,
    (hp, wp)), label)``: x (B, max_image_len + 2, C) = [cls; dist;
    patches], x_mask marking the real tokens (vision_transformer.py:
    1029-1141), label the MPP labels with a leading -100 row (or None)."""
    dtype = spec.torch_compute_dtype
    ps = spec.patch_size
    b, _, s_h, s_w = image.shape
    hp, wp = s_h // ps, s_w // ps
    n = hp * wp
    if max_image_len is None or max_image_len < 0:
        max_image_len = n
    max_image_len = min(max_image_len, n)
    dev = image.device

    x = F.conv2d(image.to(dtype),
                 params["transformer.patch_embed.proj.weight"].to(dtype),
                 stride=ps)
    x = x + params["transformer.patch_embed.proj.bias"].to(dtype)[
        None, :, None, None]                                 # B,C,hp,wp
    c = x.shape[1]

    pix_mask = image.sum(dim=1) != 0                         # B,S,S
    x_mask = _nearest_mask(pix_mask, hp, wp).to(torch.int32)  # B,hp,wp
    x_h = x_mask.sum(dim=1)[:, 0]                            # B (column 0)
    x_w = x_mask.sum(dim=2)[:, 0]                            # B (row 0)

    pos_table = params["transformer.pos_embed"].float()[0]
    p = spec.window
    spatial_pos = pos_table[2:].reshape(p, p, c)
    pos_embed = _bilinear_pos(spatial_pos, x_h, x_w, hp, wp)
    pos_embed = pos_embed.reshape(b, n, c).to(dtype)

    x = x.reshape(b, c, n).transpose(1, 2)                   # B,N,C
    x_mask_flat = x_mask.reshape(b, n)
    patch_index = torch.stack(torch.meshgrid(
        torch.arange(hp, device=dev), torch.arange(wp, device=dev),
        indexing="ij"), dim=-1).reshape(n, 2).expand(b, n, 2)

    label = None
    if mask_it:
        x, label = mpp_mask_tokens(params, spec, image, x,
                                   draws["mpp_masked"], draws["mpp_replaced"])

    keys = draws["keys"].float() + 2.0 * (1 - x_mask_flat).float()
    sel = torch.topk(-keys, max_image_len, dim=1).indices   # B,K

    def take(a):
        idx = sel.reshape(b, -1, *([1] * (a.ndim - 2)))
        return a.gather(1, idx.expand(-1, -1, *a.shape[2:]))

    x = take(x)
    x_mask_flat = take(x_mask_flat)
    patch_index = take(patch_index)
    pos_embed = take(pos_embed)
    if label is not None:
        label = take(label)
        label = torch.where(x_mask_flat[..., None] == 0,
                            torch.full_like(label, -100), label)
        label = torch.cat([torch.full((b, 1, 3), -100, dtype=label.dtype,
                                      device=dev), label], dim=1)

    cls_tok = params["transformer.cls_token"].to(dtype).expand(b, 1, c)
    dist_tok = params["transformer.dist_token"].to(dtype).expand(b, 1, c)
    x = torch.cat([cls_tok, dist_tok, x], dim=1)
    pos_embed = torch.cat(
        [pos_table[None, :2].to(dtype).expand(b, 2, c), pos_embed], dim=1)
    x = x + pos_embed
    x_mask_flat = torch.cat(
        [torch.ones((b, 2), dtype=x_mask_flat.dtype, device=dev),
         x_mask_flat], dim=1)
    return x, x_mask_flat, (patch_index, (hp, wp)), label


def distilled_forward_features(params: Params, spec: ModelSpec,
                               image: torch.Tensor,
                               draws: Dict[str, torch.Tensor], *,
                               max_image_len: int = 144,
                               mask_it: bool = False, kernels: bool = True):
    """The trunk over the sampled patches: the blocks with the key-padding
    mask and no relative bias (the DeiT path takes absolute position
    embeddings), then the final norm (vision_transformer.py:1148-1158).
    Returns (x, x_mask, label)."""
    from .mome import LN_EPS, block_forward

    x, x_mask, _, label = distilled_visual_embed(
        params, spec, image, draws, max_image_len=max_image_len,
        mask_it=mask_it)
    for blk in spec.blocks:
        x = block_forward(params, spec, blk, x, x_mask, None, V,
                          kernels=kernels)
    x = layer_norm(x, params["transformer.norm.weight"],
                   params["transformer.norm.bias"], eps=LN_EPS)
    return x, x_mask, label
