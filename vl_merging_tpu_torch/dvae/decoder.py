"""The DALL-E discrete VAE's decoder (port of
``vl_merging_tpu/dvae/decoder.py``).

Unused by training (the dVAE is only the MIM tokenizer), it decodes
codebook ids back to pixels (reference: src/dall_e/decoder.py).
Architecture (decoder.py:42-86): a 1×1 input conv vocab → n_init; 4
groups of n blocks (ReLU→1×1→ReLU→3×3→ReLU→3×3→ReLU→3×3, the residual
path scaled by 1/(4n)²; a 1×1 identity conv where the width changes)
with a nearest ×2 upsampling after groups 1–3; ReLU and a 1×1 conv to
2·output_channels (the means and log-scales of the logit-laplace
distribution).  Params: the released module's torch names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .encoder import GROUP_COUNT, Params, block, blocks_per_group, conv, \
    exact_f32, load_flat_params
# the logit-laplace epsilon (reference dall_e/utils.py:46-57)
LOGIT_LAPLACE_EPS = 0.1


def decoder_output(params: Params, z: torch.Tensor) -> torch.Tensor:
    """z: (B, vocab, H, W) one-hot or soft codes → (B, 2·C, 8H, 8W), the
    raw decoder output (decoder.py:88-96); the blocks per group read from
    the param names."""
    n_blk = blocks_per_group(params)
    post_gain = 1.0 / (GROUP_COUNT * n_blk) ** 2
    with exact_f32():
        h = conv(z.float(), params["blocks.input.w"], params["blocks.input.b"])
        for g in range(1, GROUP_COUNT + 1):
            for i in range(1, n_blk + 1):
                h = block(params, f"blocks.group_{g}.block_{i}", h, post_gain)
            if g < GROUP_COUNT:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
        return conv(F.relu(h), params["blocks.output.conv.w"],
                    params["blocks.output.conv.b"])


def unmap_pixels(x: torch.Tensor) -> torch.Tensor:
    """Invert the logit-laplace range mapping (dall_e/utils.py:54-57)."""
    return ((x - LOGIT_LAPLACE_EPS) / (1 - 2 * LOGIT_LAPLACE_EPS)).clamp(
        0.0, 1.0)


@torch.no_grad()
def decode_indices(params: Params, indices: torch.Tensor) -> torch.Tensor:
    """Codebook ids (B, H, W) or (B, H·W) → RGB pixels in [0, 1]
    (B, 3, 8H, 8W): one-hot over the decoder's vocabulary (its input
    conv's width), the decoder, the sigmoid of its first 3 channels,
    ``unmap_pixels`` (modeling_discrete_vae.py:217-221)."""
    if indices.dim() == 2:
        side = int(round(indices.shape[1] ** 0.5))
        indices = indices.reshape(indices.shape[0], side, side)
    vocab = params["blocks.input.w"].shape[1]
    z = F.one_hot(indices.long(), vocab).permute(0, 3, 1, 2).float()
    return unmap_pixels(torch.sigmoid(decoder_output(params, z)[:, :3]))


def load_decoder_params(weight_path: str) -> Params:
    """The decoder's params (``encoder.load_flat_params`` of
    ``decoder.pkl``): a flat {name: tensor} file or the released pickled
    dall_e module, from the file ``weight_path`` or from
    ``weight_path/decoder.pkl`` (the JAX loader's layout), as f32 CPU
    tensors."""
    return load_flat_params(weight_path, "decoder.pkl")
