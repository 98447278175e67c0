"""The DALL-E discrete VAE's encoder, the MIM tokenizer (port of
``vl_merging_tpu/dvae/encoder.py``).

It gives the codebook ids that masked-image modelling predicts: the
reference wraps OpenAI's released dVAE and takes the argmax over the
encoder's logits (reference: src/vilt/modules/modeling_discrete_vae.py:
206-253, src/dall_e/encoder.py).  Architecture: a 7×7 input conv; 4 groups
of n bottleneck blocks (ReLU→3×3→ReLU→3×3→ReLU→3×3→ReLU→1×1, the residual
path scaled by 1/(4n)²; a 1×1 identity conv where the width changes);
a 2×2 max-pool between groups; ReLU and a 1×1 conv to the 8192-way
vocabulary.

Params are a flat {name: tensor} dict with the torch names of the
released module (``blocks.group_1.block_1.res_path.conv_1.w`` …).  The
convolutions run in f32 with TF32 off, so that the card's codebook ids
are the CPU's but for near ties (cuDNN sums in another order).
"""

from __future__ import annotations

import math
import os
import pickle
import re
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from . import released

Params = Dict[str, torch.Tensor]

GROUP_COUNT = 4
DEFAULT_N_HID = 256
DEFAULT_N_BLK = 2
VOCAB_SIZE = 8192

# what waits: the released files themselves (ROADMAP.md, queue A)
_RELEASED = ("the loader reads the released dall_e pickles; the files "
             "themselves are not in the repository")


def exact_f32():
    """A context in which cuDNN convolutions run in f32, not TF32."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A same-padded stride-1 conv of the weight's kernel size."""
    y = F.conv2d(x, w.to(x.dtype), padding=(w.shape[-1] - 1) // 2)
    return y + b.to(x.dtype)[None, :, None, None]


def blocks_per_group(params: Params) -> int:
    """n, the blocks per group, read from the param names."""
    return len({m[1] for k in params
                if (m := re.match(r"blocks\.group_1\.block_(\d+)\.", k))})


def block(params: Params, prefix: str, x: torch.Tensor,
          post_gain: float) -> torch.Tensor:
    idp = conv(x, params[f"{prefix}.id_path.w"],
               params[f"{prefix}.id_path.b"]) \
        if f"{prefix}.id_path.w" in params else x
    h = x
    for i in (1, 2, 3, 4):
        h = conv(F.relu(h), params[f"{prefix}.res_path.conv_{i}.w"],
                 params[f"{prefix}.res_path.conv_{i}.b"])
    return idp + post_gain * h


def encoder_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, S, S) in the logit-laplace range → (B, vocab, S/8, S/8)
    f32 logits; the blocks per group read from the param names."""
    n_blk = blocks_per_group(params)
    post_gain = 1.0 / (GROUP_COUNT * n_blk) ** 2
    with exact_f32():
        h = conv(x.float(), params["blocks.input.w"], params["blocks.input.b"])
        for g in range(1, GROUP_COUNT + 1):
            for i in range(1, n_blk + 1):
                h = block(params, f"blocks.group_{g}.block_{i}", h, post_gain)
            if g < GROUP_COUNT:
                h = F.max_pool2d(h, 2)
        return conv(F.relu(h), params["blocks.output.conv.w"],
                    params["blocks.output.conv.b"])


@torch.no_grad()
def get_codebook_indices(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocabulary logits, flattened to (B, tokens)
    (modeling_discrete_vae.py:223-225)."""
    idx = encoder_logits(params, x).argmax(dim=1)
    return idx.reshape(idx.shape[0], -1)


def init_encoder_params(generator: torch.Generator,
                        n_hid: int = DEFAULT_N_HID,
                        n_blk_per_group: int = DEFAULT_N_BLK,
                        vocab_size: int = VOCAB_SIZE) -> Params:
    """Seeded f32 weights of the released encoder's shapes, drawn from
    ``generator`` on its device: normal with std 1/sqrt(fan_in) (dall_e's
    ``Conv2d`` initialisation), zero biases.  They stand in for the
    released weights, which are not in the repository."""
    dev = generator.device
    params: Params = {}

    def add(name, cin, cout, k):
        params[f"{name}.w"] = torch.randn(
            cout, cin, k, k, generator=generator, device=dev) / \
            math.sqrt(cin * k * k)
        params[f"{name}.b"] = torch.zeros(cout, device=dev)

    add("blocks.input", 3, n_hid, 7)
    cin = n_hid
    for g, width in enumerate((n_hid, 2 * n_hid, 4 * n_hid, 8 * n_hid), 1):
        for i in range(1, n_blk_per_group + 1):
            p = f"blocks.group_{g}.block_{i}"
            if cin != width:
                add(f"{p}.id_path", cin, width, 1)
            hid = width // 4
            add(f"{p}.res_path.conv_1", cin, hid, 3)
            add(f"{p}.res_path.conv_2", hid, hid, 3)
            add(f"{p}.res_path.conv_3", hid, hid, 3)
            add(f"{p}.res_path.conv_4", hid, width, 1)
            cin = width
    add("blocks.output.conv", 8 * n_hid, vocab_size, 1)
    return params


def load_flat_params(weight_path: str, file_name: str) -> Params:
    """The dVAE's params from the file ``weight_path`` or from
    ``weight_path/file_name`` (the JAX loaders' directory layout: the
    reference's discrete_vae_weight_path), as f32 CPU tensors: a flat
    {name: tensor} dict saved by ``torch.save``, or a pickled ``dall_e``
    module (the released ``encoder.pkl`` / ``decoder.pkl``), read without
    the ``dall_e`` package by ``dvae/released.py`` under the names of its
    ``named_parameters()``, as the JAX loaders read it.  Anything else
    raises ``ValueError`` naming the file."""
    path = weight_path
    if os.path.isdir(path):
        path = os.path.join(path, file_name)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a pickled module: weights_only refuses
        return released.load_module_params(path)
    if not isinstance(obj, dict) or not all(
            isinstance(v, torch.Tensor) for v in obj.values()):
        raise ValueError(f"{path}: neither a flat {{name: tensor}} dict nor "
                         f"a pickled dall_e module ({_RELEASED})")
    return {k: v.float() for k, v in obj.items()}


def load_encoder_params(weight_path: str) -> Params:
    """The encoder's params (``load_flat_params`` of ``encoder.pkl``)."""
    return load_flat_params(weight_path, "encoder.pkl")


def make_mim_label_fn(weight_path: str) -> Callable[[Dict], torch.Tensor]:
    """batch → (B, tokens) dVAE codebook ids of ``batch["image_target"]``,
    on its device (the encoder's params are moved there once)."""
    host = load_encoder_params(weight_path)
    on: Dict[torch.device, Params] = {}

    def fn(batch: Dict) -> torch.Tensor:
        x = batch["image_target"]
        if x.device not in on:
            on[x.device] = {k: v.to(x.device) for k, v in host.items()}
        return get_codebook_indices(on[x.device], x)

    return fn
