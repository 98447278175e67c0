"""The port's last modules against the JAX package, on the CPU:
``models/distilled.py`` (the DeiT dynamic-patch embedding and trunk, with
the JAX package's ``jax.random`` draws replayed through the port's
deterministic core), relpos's video helpers, ``dvae/discrete.
get_codebook_probs`` and ``dvae/decoder.load_decoder_params``.

Tolerances: the patch selection, masks, patch indices and MPP labels bit
for bit; the embeddings and the trunk's features in f32 at atol 1e-5,
rtol 1e-4 (the same functions summed in another order); the
pos-embed interpolation at atol 2e-6 (the JAX test's bound against
``F.interpolate``); the codebook probabilities at atol 2e-6, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_distilled import _params_with_distilled, _tiny_spec
from vl_merging_tpu.dvae import decoder as jdecoder
from vl_merging_tpu.dvae import discrete as jdiscrete
from vl_merging_tpu.models import distilled as jdistilled
from vl_merging_tpu.models import relpos as jrelpos
from vl_merging_tpu_torch import dvae
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.dvae import discrete
from vl_merging_tpu_torch.models import distilled, relpos
from vl_merging_tpu_torch.models.spec import make_model_spec
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """The JAX test's tiny spec (64-px canvas, 16-px patches, C=32), its
    params with a dist token and a pos-embed, and the port's spec and the
    same params."""
    jspec = _tiny_spec(image_size=64, patch=16)
    jparams = _params_with_distilled(jspec)
    spec = make_model_spec(build_config(
        "task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl",
        overrides=dict(hidden_size=32, num_heads=2, num_layers=2,
                       image_size=64, patch_size=16, max_text_len=8,
                       max_text_len_of_initckpt=16,
                       vlffn_start_layer_index=1, precision="f32",
                       vit="vit_tiny_patch16_224")))
    params = {k: _t(v) for k, v in jparams.items()}
    return jspec, jparams, spec, params


def _images():
    """Two canvases: one image filling 32x48 of 64x64 (6 valid patches),
    one full (16 patches)."""
    rng = np.random.RandomState(3)
    img = np.zeros((2, 3, 64, 64), np.float32)
    img[0, :, :32, :48] = rng.rand(3, 32, 48) + 0.1
    img[1] = rng.rand(3, 64, 64) + 0.1
    return img


def _jax_draws(rng, b, n, mask_it):
    """The draws of JAX ``distilled_visual_embed(rng=rng)``, in its split
    order."""
    out = {}
    if mask_it:
        rng, mk = jax.random.split(rng)
        k1, k2 = jax.random.split(mk)
        out["mpp_masked"] = jax.random.bernoulli(k1, 0.15, (b, n))
        out["mpp_replaced"] = jax.random.bernoulli(k2, 0.8, (b, n))
    out["keys"] = jax.random.uniform(rng, (b, n))
    return {k: _t(v) for k, v in out.items()}


@pytest.mark.parametrize("hin,hp", [(64, 4), (48, 3), (37, 4)])
def test_nearest_mask_equals_jax(hin, hp):
    m = (np.random.RandomState(0).rand(2, hin, hin) > 0.4)
    np.testing.assert_array_equal(
        distilled._nearest_mask(_t(m), hp, hp).numpy(),
        np.asarray(jdistilled._nearest_mask(jnp.asarray(m), hp, hp)))


def test_bilinear_pos_matches_jax():
    """Each image's grid at its own (h, w), batched, against the JAX
    package's per-image function."""
    grid = np.random.RandomState(1).randn(6, 6, 8).astype(np.float32)
    hw = [(5, 6), (1, 3), (6, 6), (3, 2)]
    got = distilled._bilinear_pos(_t(grid), torch.tensor([h for h, _ in hw]),
                                  torch.tensor([w for _, w in hw]), 8, 8)
    for i, (h, w) in enumerate(hw):
        want = jdistilled._bilinear_pos(jnp.asarray(grid), jnp.int32(h),
                                        jnp.int32(w), 8, 8)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=2e-6)


@pytest.mark.parametrize("max_len,mask_it", [(16, False), (9, True),
                                             (-1, True)])
def test_visual_embed_replays_jax_draws(setup, max_len, mask_it):
    jspec, jparams, spec, params = setup
    img = _images()
    key = jax.random.PRNGKey(max_len + 7)
    want = jdistilled.distilled_visual_embed(
        jparams, jspec, jnp.asarray(img), max_image_len=max_len,
        mask_it=mask_it, rng=key)
    draws = _jax_draws(key, 2, 16, mask_it)
    got = distilled.distilled_visual_embed(params, spec, _t(img), draws,
                                           max_image_len=max_len,
                                           mask_it=mask_it)
    (x, m, (pidx, grid), label), (jx, jm, (jpidx, jgrid), jlabel) = got, want
    assert grid == jgrid == (4, 4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jpidx))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    if mask_it:
        np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    else:
        assert label is None and jlabel is None


def test_forward_features_replays_jax_draws(setup):
    jspec, jparams, spec, params = setup
    img = _images()
    key = jax.random.PRNGKey(5)
    jx, jm, jlabel = jdistilled.distilled_forward_features(
        jparams, jspec, jnp.asarray(img), max_image_len=12, mask_it=True,
        rng=key)
    x, m, label = distilled.distilled_forward_features(
        params, spec, _t(img), _jax_draws(key, 2, 16, True),
        max_image_len=12, mask_it=True)
    assert x.shape == (2, 14, 32)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)


def test_draws_select_uniformly_and_deterministically(setup):
    """The port's own draws: the same generator state gives the same
    tokens; a full image over budget keeps 9 distinct valid patches."""
    _, _, spec, params = setup
    img = _t(np.random.RandomState(4).rand(1, 3, 64, 64).astype(np.float32)
             + 0.1)
    outs = [distilled.distilled_visual_embed(
        params, spec, img, distilled.distilled_draws(
            1, 16, torch.Generator().manual_seed(s)), max_image_len=9)
        for s in (0, 0, 1)]
    assert torch.equal(outs[0][0], outs[1][0])
    a = {tuple(r) for r in outs[0][2][0][0].tolist()}
    assert len(a) == 9 and int(outs[0][1].sum()) == 11
    assert a != {tuple(r) for r in outs[2][2][0][0].tolist()}


@pytest.mark.parametrize("window,frames", [(4, 1), (4, 3), (6, 2)])
def test_video_relpos_helpers_equal_jax(window, frames):
    for name, args in (
            ("video_relative_position_index", (window, frames)),
            ("text_video_relative_position_index",
             (8, 16, window, frames)),
            ("text_video_relative_position_index",
             (8, 16, window, frames, 5)),
            ("temporal_relative_position_index", (window, frames)),
            ("mask_for_combining_temporal", (window, frames))):
        got = getattr(relpos, name)(*args)
        want = getattr(jrelpos, name)(*args)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_codebook_probs_match_jax():
    cfg = dict(image_size=16, num_tokens=12, codebook_dim=6, num_layers=2,
               hidden_dim=5, channels=3)
    jcfg = jdiscrete.DiscreteVAEConfig(**cfg)
    jparams = jdiscrete.init_discrete_vae_params(jcfg, seed=3)
    img = np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32)
    want = np.asarray(jdiscrete.get_codebook_probs(jparams, jnp.asarray(img),
                                                   jcfg))
    got = dvae.get_codebook_probs(
        discrete.init_discrete_vae_params(discrete.DiscreteVAEConfig(**cfg),
                                          seed=3), _t(img),
        discrete.DiscreteVAEConfig(**cfg))
    assert got.shape == want.shape == (2, 12, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-4)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)


class DecoderStub(torch.nn.Module):
    """A module whose parameters carry released-decoder names."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.blocks = torch.nn.ParameterDict({
            "w": torch.nn.Parameter(torch.randn(8, 64, 1, 1, generator=g)),
            "b": torch.nn.Parameter(torch.randn(8, generator=g))})


def test_load_decoder_params(tmp_path):
    """A flat {name: tensor} file, by its path and by its directory
    (``decoder.pkl``), loads the values the JAX loader reads from the
    pickled module; the port refuses that module, whose class is not a
    dall_e one."""
    module = DecoderStub()
    torch.save(module, tmp_path / "module.pkl")
    want = jdecoder.load_decoder_params(str(tmp_path / "module.pkl"))
    flat = {k: v.detach() for k, v in module.state_dict().items()}
    torch.save(flat, tmp_path / "flat.pt")
    (tmp_path / "dir").mkdir()
    torch.save(flat, tmp_path / "dir" / "decoder.pkl")
    for path in (tmp_path / "flat.pt", tmp_path / "dir"):
        got = dvae.load_decoder_params(str(path))
        assert set(got) == set(want) == {"blocks.w", "blocks.b"}
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="not a pickled dall_e module"):
        dvae.load_decoder_params(str(tmp_path / "module.pkl"))
