"""The trainable Gumbel-softmax DiscreteVAE (BEiT/DALLE-pytorch lineage;
port of ``vl_merging_tpu/dvae/discrete.py``).

The reference's trainable discrete VAE (reference:
src/vilt/modules/modeling_discrete_vae.py:79-203), unused at reference
runtime (the released OpenAI dVAE gives the MIM labels).  Functions over a
flat param dict keyed like the reference module's ``state_dict()`` (torch
layouts: Conv2d ``(out, in, kh, kw)``, ConvTranspose2d ``(in, out, kh,
kw)``), so reference checkpoints load as they are.

Encoder: ``num_layers`` × [Conv(4, s2, p1) + ReLU, ResBlock], then a 1×1
conv to ``num_tokens`` logits.  The decoder mirrors it with
ConvTranspose(4, s2, p1).  ``forward`` adds Gumbel noise (from a
generator, or given), mixes the codebook with the (optionally
straight-through) soft one-hot, decodes, and adds the reference's loss:
MSE (or smooth-L1) reconstruction + ``kl_div_loss_weight`` × the
reference's ``F.kl_div(log_uniform, log_qy, 'batchmean',
log_target=True)``, whose ``batchmean`` divides by
``log_uniform.size(0) == 1``: a sum over batch·positions
(modeling_discrete_vae.py:195-198; quirk preserved).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiscreteVAEConfig:
    """Constructor args of the reference DiscreteVAE
    (modeling_discrete_vae.py:80-92)."""
    image_size: int = 256
    num_tokens: int = 512
    codebook_dim: int = 512
    num_layers: int = 3
    hidden_dim: int = 64
    channels: int = 3
    smooth_l1_loss: bool = False
    temperature: float = 0.9
    straight_through: bool = False
    kl_div_loss_weight: float = 0.0

    def get_image_tokens_size(self) -> int:
        # the reference hardcodes //8 (= 2**3 for its default 3 layers)
        return self.image_size // 8


def init_discrete_vae_params(cfg: DiscreteVAEConfig,
                             seed: int = 0) -> Params:
    """Seeded params, the JAX package's draws (numpy ``RandomState(seed)``,
    in its order): torch Conv2d's default kaiming-uniform weights and
    U(±1/√fan_in) biases, a standard normal codebook."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k, transpose=False):
        fan_in = cin * k * k
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        # kaiming a=√5: bound √3 · √(1/3) / √fan_in
        w_bound = math.sqrt(3.0) * math.sqrt(1.0 / 3.0) / math.sqrt(fan_in)
        params[f"{name}.weight"] = rng.uniform(
            -w_bound, w_bound, shape).astype(np.float32)
        bound = 1.0 / math.sqrt(fan_in)
        params[f"{name}.bias"] = rng.uniform(
            -bound, bound, (cout,)).astype(np.float32)

    params["codebook.weight"] = rng.randn(
        cfg.num_tokens, cfg.codebook_dim).astype(np.float32)
    enc_in, dec_in = cfg.channels, cfg.codebook_dim
    for layer in range(cfg.num_layers):
        conv(f"encoder.{2 * layer}.0", enc_in, cfg.hidden_dim, 4)
        conv(f"decoder.{2 * layer}.0", dec_in, cfg.hidden_dim, 4,
             transpose=True)
        for name in (f"encoder.{2 * layer + 1}", f"decoder.{2 * layer + 1}"):
            conv(f"{name}.net.0", cfg.hidden_dim, cfg.hidden_dim, 3)
            conv(f"{name}.net.2", cfg.hidden_dim, cfg.hidden_dim, 3)
            conv(f"{name}.net.4", cfg.hidden_dim, cfg.hidden_dim, 1)
        enc_in = dec_in = cfg.hidden_dim
    conv(f"encoder.{2 * cfg.num_layers}", cfg.hidden_dim, cfg.num_tokens, 1)
    conv(f"decoder.{2 * cfg.num_layers}", cfg.hidden_dim, cfg.channels, 1)
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _conv(x, params: Params, name: str, stride: int = 1, pad: int = 0):
    return F.conv2d(x, params[f"{name}.weight"].to(x.dtype),
                    params[f"{name}.bias"].to(x.dtype), stride=stride,
                    padding=pad)


def _res_block(params: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Conv3→ReLU→Conv3→ReLU→Conv1, residual
    (modeling_discrete_vae.py:64-76)."""
    h = F.relu(_conv(x, params, f"{prefix}.net.0", pad=1))
    h = F.relu(_conv(h, params, f"{prefix}.net.2", pad=1))
    return _conv(h, params, f"{prefix}.net.4") + x


def encoder_logits(params: Params, img: torch.Tensor,
                   cfg: DiscreteVAEConfig) -> torch.Tensor:
    """(B, C, S, S) → (B, num_tokens, S/2^L, S/2^L) codebook logits."""
    h = img
    for layer in range(cfg.num_layers):
        h = F.relu(_conv(h, params, f"encoder.{2 * layer}.0", stride=2,
                         pad=1))
        h = _res_block(params, f"encoder.{2 * layer + 1}", h)
    return _conv(h, params, f"encoder.{2 * cfg.num_layers}")


def _decoder(params: Params, h: torch.Tensor,
             cfg: DiscreteVAEConfig) -> torch.Tensor:
    for layer in range(cfg.num_layers):
        name = f"decoder.{2 * layer}.0"
        h = F.relu(F.conv_transpose2d(
            h, params[f"{name}.weight"].to(h.dtype),
            params[f"{name}.bias"].to(h.dtype), stride=2, padding=1))
        h = _res_block(params, f"decoder.{2 * layer + 1}", h)
    return _conv(h, params, f"decoder.{2 * cfg.num_layers}")


def get_codebook_indices(params: Params, img: torch.Tensor,
                         cfg: DiscreteVAEConfig) -> torch.Tensor:
    """The argmax over the logit channel (modeling_discrete_vae.py:135-139)."""
    return encoder_logits(params, img, cfg).argmax(dim=1)


def get_codebook_probs(params: Params, img: torch.Tensor,
                       cfg: DiscreteVAEConfig) -> torch.Tensor:
    """The softmax over the logit channel (modeling_discrete_vae.py)."""
    return torch.softmax(encoder_logits(params, img, cfg), dim=1)


def decode(params: Params, img_seq: torch.Tensor,
           cfg: DiscreteVAEConfig) -> torch.Tensor:
    """(B, N) codebook ids → (B, C, 8√N, 8√N) images
    (modeling_discrete_vae.py:141-152)."""
    emb = params["codebook.weight"][img_seq.long()]          # (B, N, D)
    b, n, d = emb.shape
    hw = math.isqrt(n)
    return _decoder(params, emb.reshape(b, hw, hw, d).permute(0, 3, 1, 2),
                    cfg)


def _smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def gumbel_noise(shape, generator: torch.Generator, dtype=torch.float32
                 ) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U), U uniform on (0, 1), from
    ``generator`` on its device."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def forward(params: Params, img: torch.Tensor, cfg: DiscreteVAEConfig, *,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None,
            return_loss: bool = False, return_recons: bool = False):
    """The reference forward (modeling_discrete_vae.py:154-203).  The
    Gumbel noise comes from ``generator`` or is given as ``noise`` (the
    logits' shape; tests inject the JAX package's)."""
    if img.shape[-1] != cfg.image_size or img.shape[-2] != cfg.image_size:
        raise ValueError(f"image of shape {tuple(img.shape)}, expected side "
                         f"{cfg.image_size}")
    logits = encoder_logits(params, img, cfg)
    if noise is None:
        if generator is None:
            raise ValueError("forward needs a generator or noise for the "
                             "gumbel sampling")
        noise = gumbel_noise(logits.shape, generator, logits.dtype)
    soft_one_hot = torch.softmax(
        (logits + noise.to(logits.device)) / cfg.temperature, dim=1)
    if cfg.straight_through:
        idx = soft_one_hot.argmax(dim=1, keepdim=True)
        hard = torch.zeros_like(soft_one_hot).scatter_(1, idx, 1.0)
        soft_one_hot = hard - soft_one_hot.detach() + soft_one_hot
    sampled = torch.einsum("bnhw,nd->bdhw", soft_one_hot,
                           params["codebook.weight"].to(soft_one_hot.dtype))
    out = _decoder(params, sampled, cfg)
    if not return_loss:
        return out
    recon = _smooth_l1(img, out) if cfg.smooth_l1_loss else \
        ((img - out) ** 2).mean()
    # the kl term: F.kl_div(log_uniform, log_qy, 'batchmean',
    # log_target=True), whose batchmean divides by log_uniform.size(0) == 1:
    # a sum over batch·positions·vocab (quirk preserved)
    lg = logits.permute(0, 2, 3, 1).reshape(img.shape[0], -1,
                                            cfg.num_tokens)
    qy = torch.softmax(lg, dim=-1)
    log_qy = torch.log(qy + 1e-10)
    kl = (qy * (log_qy - math.log(1.0 / cfg.num_tokens))).sum()
    loss = recon + kl * cfg.kl_div_loss_weight
    if not return_recons:
        return loss
    return loss, out
