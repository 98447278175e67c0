"""The port's dVAE (``vl_merging_tpu_torch/dvae``) against the JAX
package's, on the CPU in f32.

The DALL-E encoder's logits and codebook ids and its decoder's output and
pixels on seeded weights of tiny widths in the released modules' names
(8 channels, 1 or 2 blocks a group); ``load_encoder_params`` and
``make_mim_label_fn`` from a flat file and from a directory holding
``encoder.pkl``, both written by the test, and their refusal of a pickled
module; the trainable DiscreteVAE: its seeded init bit for bit, logits,
codebook ids, ``decode``, and ``forward``'s loss, reconstruction and
gradients with the JAX package's Gumbel noise injected (MSE and
smooth-L1, soft and straight-through, with and without the KL term).

Tolerances: atol 2e-5, rtol 1e-4 (f32, the same convolutions summed in
another order); gradients atol 1e-5, rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vl_merging_tpu.dvae import decoder as jdecoder
from vl_merging_tpu.dvae import discrete as jdiscrete
from vl_merging_tpu.dvae import encoder as jencoder
from vl_merging_tpu_torch import dvae
from vl_merging_tpu_torch.dvae import decoder, discrete, encoder
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def conv_arrays(rng, out, name, cin, cout, k):
    out[f"{name}.w"] = (rng.randn(cout, cin, k, k) /
                        np.sqrt(cin * k * k)).astype(np.float32)
    out[f"{name}.b"] = (0.01 * rng.randn(cout)).astype(np.float32)


@functools.cache
def encoder_arrays(n_blk: int, n_hid: int = 8, vocab: int = 64) -> dict:
    rng = np.random.RandomState(n_blk)
    out = {}
    conv_arrays(rng, out, "blocks.input", 3, n_hid, 7)
    cin = n_hid
    for g, width in enumerate((n_hid, 2 * n_hid, 4 * n_hid, 8 * n_hid), 1):
        for i in range(1, n_blk + 1):
            p = f"blocks.group_{g}.block_{i}"
            if cin != width:
                conv_arrays(rng, out, f"{p}.id_path", cin, width, 1)
            for j, (a, c, k) in enumerate(((cin, width // 4, 3),
                                           (width // 4, width // 4, 3),
                                           (width // 4, width // 4, 3),
                                           (width // 4, width, 1)), 1):
                conv_arrays(rng, out, f"{p}.res_path.conv_{j}", a, c, k)
            cin = width
    conv_arrays(rng, out, "blocks.output.conv", 8 * n_hid, vocab, 1)
    return out


@functools.cache
def decoder_arrays(n_init: int = 8, n_hid: int = 8, vocab: int = 64) -> dict:
    """The released decoder's layout: 1x1 input conv vocab -> n_init;
    groups of widths 8n, 4n, 2n, n; residual convs of kernels 1, 3, 3, 3;
    output conv to 6 channels."""
    rng = np.random.RandomState(7)
    out = {}
    conv_arrays(rng, out, "blocks.input", vocab, n_init, 1)
    cin = n_init
    for g, width in enumerate((8 * n_hid, 4 * n_hid, 2 * n_hid, n_hid), 1):
        p = f"blocks.group_{g}.block_1"
        if cin != width:
            conv_arrays(rng, out, f"{p}.id_path", cin, width, 1)
        for j, (a, c, k) in enumerate(((cin, width // 4, 1),
                                       (width // 4, width // 4, 3),
                                       (width // 4, width // 4, 3),
                                       (width // 4, width, 3)), 1):
            conv_arrays(rng, out, f"{p}.res_path.conv_{j}", a, c, k)
        cin = width
    conv_arrays(rng, out, "blocks.output.conv", n_hid, 6, 1)
    return out


def jparams(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def tparams(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def targets(n=2, side=32, seed=1):
    return (0.8 * np.random.RandomState(seed).rand(n, 3, side, side)
            + 0.1).astype(np.float32)


@pytest.mark.parametrize("n_blk", [1, 2])
def test_encoder_logits_and_indices_match_jax(n_blk):
    """Logits and codebook ids; the blocks per group read from the names."""
    arrays, x = encoder_arrays(n_blk), targets()
    want = np.asarray(jencoder.encoder_logits(jparams(arrays),
                                              jnp.asarray(x), n_blk))
    got = encoder.encoder_logits(tparams(arrays), torch.from_numpy(x))
    assert encoder.blocks_per_group(arrays) == n_blk
    assert got.shape == want.shape == (2, 64, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    top2 = np.sort(want, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3   # no near tie here
    np.testing.assert_array_equal(
        dvae.get_codebook_indices(tparams(arrays), torch.from_numpy(x)),
        np.asarray(jencoder.get_codebook_indices(
            jparams(arrays), jnp.asarray(x), n_blk)))


def test_load_encoder_params_and_label_fn(tmp_path):
    """A flat {name: tensor} file, by its path and by its directory (the
    JAX loader's layout), gives the label function the JAX package's ids;
    a pickled module that is not a dall_e one is refused."""
    arrays = encoder_arrays(1)
    flat = tmp_path / "weights.pt"
    torch.save(tparams(arrays), flat)
    (tmp_path / "dir").mkdir()
    torch.save(tparams(arrays), tmp_path / "dir" / "encoder.pkl")
    for path in (flat, tmp_path / "dir"):
        loaded = dvae.load_encoder_params(str(path))
        assert set(loaded) == set(arrays)
        assert all(torch.equal(loaded[k], torch.from_numpy(v))
                   for k, v in arrays.items())
    x = targets(3, seed=2)
    got = dvae.make_mim_label_fn(str(tmp_path / "dir"))(
        {"image_target": torch.from_numpy(x)})
    want = jencoder.get_codebook_indices(jparams(arrays), jnp.asarray(x), 1)
    assert got.dtype == torch.long and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.save(torch.nn.Conv2d(1, 1, 1), tmp_path / "module.pkl")
    with pytest.raises(ValueError, match="not a pickled dall_e module"):
        dvae.load_encoder_params(str(tmp_path / "module.pkl"))


def test_decoder_matches_jax():
    """The raw output over one-hot codes, and the index → pixel path."""
    arrays = decoder_arrays()
    idx = np.random.RandomState(3).randint(0, 64, (2, 4, 4))
    z = np.array(jax.nn.one_hot(idx, 64, axis=1), np.float32)
    want = np.asarray(jdecoder.decoder_output(jparams(arrays),
                                              jnp.asarray(z), 1))
    got = decoder.decoder_output(tparams(arrays), torch.from_numpy(z))
    assert got.shape == want.shape == (2, 6, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    px = dvae.decode_indices(tparams(arrays),
                             torch.from_numpy(idx.reshape(2, 16)))
    want_px = jdecoder.decode_indices(jparams(arrays), jnp.asarray(idx),
                                      vocab_size=64, n_blk_per_group=1)
    assert px.shape == (2, 3, 32, 32) and 0 <= float(px.min()) and \
        float(px.max()) <= 1
    np.testing.assert_allclose(px.numpy(), np.asarray(want_px), **TOL)


CFG = dict(image_size=16, num_tokens=12, codebook_dim=6, num_layers=2,
           hidden_dim=5, channels=3)


def test_discrete_vae_init_logits_and_decode_match_jax():
    """The seeded init bit for bit; logits, codebook ids and ``decode``."""
    cfg = discrete.DiscreteVAEConfig(**CFG)
    jcfg = jdiscrete.DiscreteVAEConfig(**CFG)
    params = discrete.init_discrete_vae_params(cfg, seed=3)
    want_params = jdiscrete.init_discrete_vae_params(jcfg, seed=3)
    assert set(params) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v), k)
    img = np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32)
    want = np.asarray(jdiscrete.encoder_logits(want_params, jnp.asarray(img),
                                               jcfg))
    got = discrete.encoder_logits(params, torch.from_numpy(img), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        discrete.get_codebook_indices(params, torch.from_numpy(img), cfg),
        np.asarray(jdiscrete.get_codebook_indices(want_params,
                                                  jnp.asarray(img), jcfg)))
    seq = np.random.RandomState(5).randint(0, 12, (2, 16))
    np.testing.assert_allclose(
        discrete.decode(params, torch.from_numpy(seq), cfg).numpy(),
        np.asarray(jdiscrete.decode(want_params, jnp.asarray(seq), jcfg)),
        **TOL)
    assert cfg.get_image_tokens_size() == 2


@pytest.mark.parametrize("smooth_l1,straight_through,kl", [
    (False, False, 0.0), (True, False, 0.5), (False, True, 1.0)])
def test_discrete_vae_forward_matches_jax(smooth_l1, straight_through, kl):
    """``forward`` with the JAX package's Gumbel noise injected: the loss
    (the KL term's batchmean sum quirk included), the reconstruction and
    the gradient of the loss with respect to every param."""
    over = dict(CFG, smooth_l1_loss=smooth_l1,
                straight_through=straight_through, kl_div_loss_weight=kl)
    cfg, jcfg = discrete.DiscreteVAEConfig(**over), \
        jdiscrete.DiscreteVAEConfig(**over)
    want_params = jdiscrete.init_discrete_vae_params(jcfg, seed=6)
    img = jnp.asarray(np.random.RandomState(8).randn(2, 3, 16, 16).astype(
        np.float32))
    noise = jax.random.gumbel(jax.random.PRNGKey(9), (2, 12, 4, 4))

    def jloss(p):
        return jdiscrete.forward(p, img, jcfg, noise=noise, return_loss=True,
                                 return_recons=True)
    (want, want_out), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        want_params)
    params = {k: v.requires_grad_() for k, v in
              discrete.init_discrete_vae_params(cfg, seed=6).items()}
    loss, out = discrete.forward(params, torch.from_numpy(np.asarray(img)),
                                 cfg, noise=torch.from_numpy(np.asarray(
                                     noise)), return_loss=True,
                                 return_recons=True)
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    grads = torch.autograd.grad(loss, list(params.values()))
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   err_msg=k, **GRAD_TOL)
    gen = torch.Generator().manual_seed(0)
    drawn = discrete.forward(params, torch.from_numpy(np.asarray(img)), cfg,
                             generator=gen)
    assert drawn.shape == (2, 3, 16, 16) and bool(torch.isfinite(drawn).all())
