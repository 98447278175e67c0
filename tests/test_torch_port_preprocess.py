"""The port's device-side preprocessing (``ops/image.py``,
``ops/augment.py``, ``ops/text_masking.py`` and the train step's
``device_augment`` / ``device_mlm`` hooks) against the JAX package and
PIL, on the CPU.

Bounds (f32 against PIL's double; the JAX package's own contract is
``tests/test_jax_image.py`` and ``tests/test_augment.py``):
  * resize: the port follows Pillow's double arithmetic for the resample
    weights and sums exactly, so its bytes equal PIL's, byte for byte
    (the JAX test's bound is ≥ 99.7% exact); its weights are within two
    2^-22 quantization steps of the JAX package's f32 weights (≥ 98% of
    them equal: JAX evaluates them in f32 and resolves the weights on a
    quantization tie by its rounding); its bytes ≥ 99.7% equal to JAX's,
    max |Δ| ≤ 2 (JAX's own bound against PIL), and ≥ 98% on the
    64x90 → 96 upscale, where JAX's own bytes are 98.5% PIL's;
  * augment: ``sample_train_params`` bit-equal to JAX's for the same
    RandomState; equalize, brightness, sharpness and the identity warp
    byte-exact against JAX and PIL; autocontrast byte-exact against JAX;
    affine and rotate byte-exact against JAX and against PIL ≥ 99%
    exact, max |Δ| ≤ 2; the whole ``augment_train_batch`` ≥ 99.7% equal
    to JAX's with max |Δ| ≤ 2 (its crop-resize is the resize above), and
    against the host PIL pipeline ≥ 98% exact, max |Δ| ≤ 4;
  * text masking: the JAX package's ``jax.random`` draws replayed through
    the port's core give bit-equal ``text_ids_mlm`` / ``text_labels_mlm``;
  * the step under ``device_augment`` against JAX ``make_train_step`` on
    the images both made: loss and every gradient at atol 1e-5, rtol 1e-4
    (f32, the tolerance of ``tests/test_torch_port_train.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageOps

from fixtures import make_fixture_root
from test_augment import _host_pipeline, _rand_img
from test_jax_image import _photo_like
from test_text_masking import _random_row
from test_torch_port_train import (_capture_grads, _close, _tiny_cfg,
                                   _train_inputs)
from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.ops import augment as jaug
from vl_merging_tpu.ops import image as jimage
from vl_merging_tpu.ops import text_masking as jtm
from vl_merging_tpu.train import init_train_state as jinit_train_state
from vl_merging_tpu.train import make_optimizer as jmake_optimizer
from vl_merging_tpu.train import make_schedule as jmake_schedule
from vl_merging_tpu.train import make_train_step as jmake_train_step
from vl_merging_tpu.train.train_step import \
    _device_augment_batch as jdevice_augment_batch
from vl_merging_tpu.train.train_step import \
    attach_augment_params as jattach_augment_params
from vl_merging_tpu_torch.ckpt.convert import master_params, \
    params_from_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec
from vl_merging_tpu_torch.ops import augment, image, text_masking
from vl_merging_tpu_torch.train import loop, train_step
from vl_merging_tpu_torch.train.loop import build_train_step
from torch_port_threads import one_torch_thread  # noqa: F401


# The JAX package's functions under jit (each traced once per shape),
# except the blends and the warp: XLA fuses their multiplies and adds under
# jit (into FMAs on the CPU), so they run op by op, as the JAX package's
# tests run them against PIL
J_WEIGHTS = jax.jit(jimage._resample_weights, static_argnums=(1, 2))
J_LUT_OPS = {
    "autocontrast": jax.jit(lambda x, f: jaug._apply_lut(
        x, jaug._autocontrast_lut(x))),
    "equalize": jax.jit(lambda x, f: jaug._apply_lut(
        x, jaug._equalize_lut(x))),
    "brightness": jax.jit(lambda x, f: jaug._apply_lut(
        x, jaug._brightness_lut(f))),
    "sharpness": jaug._sharpness}
J_AFFINE = jaug._affine_bilinear
J_CROP = jax.jit(jaug._resized_crop_u8f, static_argnums=(2,))
J_APPLY_MLM = jax.jit(jtm.apply_mlm, static_argnums=(3, 4, 5))
# the op tests' image shape (one trace per JAX function)
OP_HW = (40, 52)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bytes(x):
    """A (B, 3, H, W) f32 byte image as (B, H, W, 3) int64."""
    return x.permute(0, 2, 3, 1).numpy().astype(np.int64)


def _agree(got, want, share, worst, mean=None):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert float((d == 0).mean()) >= share, float((d == 0).mean())
    assert d.max() <= worst, d.max()
    if mean is not None:
        assert float(d.mean()) < mean, float(d.mean())


# --------------------------------------------------------------------------
# ops/image.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("in_size,in_max,out,offset", [
    (320, 320, 384, None), (640, 672, 384, None), (333, 352, 224, None),
    (120, 128, 160, None), (1, 32, 8, None), (50, 96, 48, 17)])
def test_resample_weights_equal_jax(in_size, in_max, out, offset):
    want = np.asarray(J_WEIGHTS(
        jnp.int32(in_size), in_max, out,
        None if offset is None else jnp.int32(offset)))
    got = image._resample_weights(
        torch.tensor([in_size]), in_max, out,
        None if offset is None else torch.tensor([offset]))[0].numpy()
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -21 and float((d == 0).mean()) >= 0.98, \
        (d.max(), float((d == 0).mean()))


@pytest.mark.parametrize("h,w,out", [
    (240, 320, 384), (480, 640, 384), (333, 500, 224), (64, 64, 32),
    (500, 120, 160)])
def test_resize_matches_jax_and_pil(h, w, out):
    img = _photo_like(np.random.RandomState(h + w), h, w)
    canvas, sizes = image.pack_canvas([img])
    got = image.pil_resize_bicubic_u8(_t(canvas), _t(sizes), out)[0].numpy()
    want = np.asarray(jimage.pil_resize_bicubic_u8(canvas, sizes, out))[0]
    _agree(got, want, 0.997, 2)
    pil = np.asarray(Image.fromarray(img).resize((out, out), Image.BICUBIC))
    np.testing.assert_array_equal(got, pil)


def test_batched_resize_normalize_matches_jax():
    """One canvas of mixed native sizes, up- and downscaled: each image by
    its own (h, w); the normalized NCHW output within the resize bound of
    the JAX package's, and the canvas packing equal."""
    rng = np.random.RandomState(0)
    imgs = [_photo_like(rng, 240, 320), _photo_like(rng, 180, 240),
            _photo_like(rng, 300, 200), _photo_like(rng, 64, 90)]
    canvas, sizes = image.pack_canvas(imgs)
    jc, js = jimage.pack_canvas(imgs)
    np.testing.assert_array_equal(canvas, jc)
    np.testing.assert_array_equal(sizes, js)
    got = image.resize_normalize_nchw(_t(canvas), _t(sizes), 96).numpy()
    want = np.asarray(jimage.resize_normalize_nchw(canvas, sizes, 96))
    assert got.shape == want.shape == (4, 3, 96, 96)
    # the port's quotients are IEEE; XLA's CPU code rounds x / 255 and
    # (x - 0.5) / 0.5 otherwise, by an ulp: the bytes are compared
    to_bytes = lambda x: np.round((x * 0.5 + 0.5) * 255.0)  # noqa: E731
    _agree(to_bytes(got), to_bytes(want), 0.98, 2)
    assert np.abs(got - want).max() <= 2 * (2 / 255) + 1e-6
    for i, img in enumerate(imgs):
        pil = np.asarray(Image.fromarray(img).resize((96, 96), Image.BICUBIC))
        np.testing.assert_array_equal(to_bytes(got[i].transpose(1, 2, 0)),
                                      pil)


# --------------------------------------------------------------------------
# ops/augment.py
# --------------------------------------------------------------------------

def test_sample_train_params_bit_equal_jax():
    sizes = np.random.RandomState(1).randint(40, 700, (64, 2))
    got = augment.sample_train_params(np.random.RandomState(9), sizes, 384)
    want = jaug.sample_train_params(np.random.RandomState(9), sizes, 384)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_lut_op(name, img, f):
    return np.asarray(J_LUT_OPS[name](jnp.asarray(img, jnp.float32),
                                      jnp.float32(f)))


def _port_op(name, img, f):
    x = _t(img).permute(2, 0, 1)[None].float()
    factor = torch.tensor([f], dtype=torch.float32)
    if name == "sharpness":
        out = augment._sharpness(x, factor)
    else:
        lut = {"autocontrast": augment._autocontrast_lut,
               "equalize": augment._equalize_lut,
               "brightness": lambda x: augment._brightness_lut(factor)}[
            name](x)
        out = augment._apply_lut(x, lut)
    return _bytes(out)[0]


PIL_OPS = {"equalize": lambda im, f: ImageOps.equalize(im),
           "brightness": lambda im, f: ImageEnhance.Brightness(im).enhance(f),
           "sharpness": lambda im, f: ImageEnhance.Sharpness(im).enhance(f)}


@pytest.mark.parametrize("name", ["autocontrast", "equalize", "brightness",
                                  "sharpness"])
def test_lut_and_sharpness_ops_byte_exact(name):
    rng = np.random.RandomState(2)
    f = 7 / 10 * 1.8 + 0.1
    imgs = [_rand_img(rng, *OP_HW, low_dynamic=bool(i % 2))
            for i in range(6)]
    imgs.append(np.full(OP_HW + (3,), 77, np.uint8))   # one bin
    for img in imgs:
        got = _port_op(name, img, f)
        np.testing.assert_array_equal(got, _jax_lut_op(name, img, f))
        if name in PIL_OPS:
            np.testing.assert_array_equal(
                got, np.asarray(PIL_OPS[name](Image.fromarray(img), f)))


def _warp(img, coeffs):
    x = _t(img).permute(2, 0, 1)[None].float()
    return _bytes(augment._affine_bilinear(
        x, torch.tensor([coeffs], dtype=torch.float32)))[0]


@pytest.mark.parametrize("kind", ["shear_x", "shear_y", "trans_x", "trans_y",
                                  "generic", "rotate"])
def test_affine_matches_pil_and_jax(kind):
    rng = np.random.RandomState(4)
    exact = total = worst = 0
    s = OP_HW[0]
    for _ in range(6):
        img = _rand_img(rng, h=s, w=s)
        v = float(rng.uniform(0.05, 0.3)) * (-1 if rng.rand() < 0.5 else 1)
        t = float(rng.uniform(-7, 7))
        coeffs = {
            "shear_x": (1, v, 0, 0, 1, 0), "shear_y": (1, 0, 0, v, 1, 0),
            "trans_x": (1, 0, t, 0, 1, 0), "trans_y": (1, 0, 0, 0, 1, t),
            "generic": (np.cos(v), np.sin(v), t, -np.sin(v), np.cos(v), t),
            "rotate": jaug._rotate_coeffs(100 * v, s, s)}[kind]
        got = _warp(img, coeffs)
        np.testing.assert_array_equal(got, np.asarray(J_AFFINE(
            jnp.asarray(img, jnp.float32), jnp.asarray(coeffs, jnp.float32))))
        ref = np.asarray(Image.fromarray(img).transform(
            (s, s), Image.AFFINE, tuple(float(c) for c in coeffs),
            resample=Image.BILINEAR, fillcolor=(128,) * 3))
        d = np.abs(ref.astype(np.int64) - got)
        exact += int((d == 0).sum())
        total += d.size
        worst = max(worst, int(d.max()))
    assert exact / total >= 0.99 and worst <= 2
    np.testing.assert_array_equal(_warp(img, (1, 0, 0, 0, 1, 0)), img)


def test_rotate_coeffs_equal_jax():
    for deg in (-21.0, -3.5, 0.0, 12.25):
        assert augment._rotate_coeffs(deg, 384, 384) == \
            jaug._rotate_coeffs(deg, 384, 384)


@pytest.fixture(scope="module")
def augmented():
    """Six native-size images on one canvas, their sampled params, and the
    augment of the port and of the JAX package (48 px)."""
    rng = np.random.RandomState(8)
    imgs = [_rand_img(rng, h=int(rng.randint(56, 100)),
                      w=int(rng.randint(56, 100))) for _ in range(6)]
    canvas, sizes = image.pack_canvas(imgs)
    params = augment.sample_train_params(np.random.RandomState(9), sizes, 48)
    got = augment.augment_train_batch(
        _t(canvas), {k: _t(v) for k, v in params.items()}, 48)
    want = jaug.augment_train_batch(
        jnp.asarray(canvas), {k: jnp.asarray(v) for k, v in params.items()},
        48)
    return imgs, canvas, params, got.numpy(), np.asarray(want)


def test_augment_train_batch_matches_jax_and_host(augmented):
    imgs, _, params, got, want = augmented
    assert got.shape == want.shape == (len(imgs), 3, 48, 48)
    to_bytes = lambda x: np.round((x * 0.5 + 0.5) * 255.0)  # noqa: E731
    _agree(to_bytes(got), to_bytes(want), 0.999, 2)
    exact = total = worst = 0
    for i, img in enumerate(imgs):
        ref = _host_pipeline(img, params["crop"][i], params["flip"][i],
                             params["op_idx"][i], params["op_apply"][i],
                             params["affine"][i], params["factor"][i], 48)
        d = np.abs(ref.astype(np.int64)
                   - to_bytes(got[i].transpose(1, 2, 0)).astype(np.int64))
        exact += int((d == 0).sum())
        total += d.size
        worst = max(worst, int(d.max()))
    assert exact / total >= 0.98 and worst <= 4, (exact / total, worst)


def test_resized_crop_matches_pil_and_jax(augmented):
    imgs, canvas, params, _, _ = augmented
    got = _bytes(augment._resized_crop_u8f(_t(canvas), _t(params["crop"]),
                                           48))
    for i, img in enumerate(imgs):
        want = np.asarray(J_CROP(jnp.asarray(canvas[i]),
                                 jnp.asarray(params["crop"][i]), 48))
        _agree(got[i], want, 0.997, 2)
        y, x, ch, cw = (int(v) for v in params["crop"][i])
        pil = np.asarray(Image.fromarray(img).crop((x, y, x + cw, y + ch))
                         .resize((48, 48), Image.BICUBIC))
        np.testing.assert_array_equal(got[i], pil)


# --------------------------------------------------------------------------
# ops/text_masking.py: JAX's draws replayed through the port's core
# --------------------------------------------------------------------------

def _jax_draws(rng, shape, vocab, whole_word, dtype=jnp.int32):
    """The draws of JAX ``apply_mlm(rng, ...)``, in its split order."""
    k_sel, k_rep, k_rnd, k_tok = jax.random.split(rng, 4)
    if whole_word:
        keys = jax.random.split(k_sel, shape[0])
        sel = {"order_u": np.stack([np.asarray(jax.random.uniform(
            k, (shape[1],))) for k in keys])}
    else:
        sel = {"select_u": np.asarray(jax.random.uniform(k_sel, shape))}
    draws = dict(sel, replace_u=np.asarray(jax.random.uniform(k_rep, shape)),
                 random_u=np.asarray(jax.random.uniform(k_rnd, shape)),
                 random_tok=np.asarray(jax.random.randint(
                     k_tok, shape, 0, vocab, dtype=dtype)))
    return {k: _t(v) for k, v in draws.items()}


def _tie_rows(rng, L=40, n=30):
    """Rows of exactly ``n`` candidate tokens (30 · 0.15 = 4.5 is the
    budget tie: f64 rounds to 4, an f32 round to 5)."""
    rows = []
    for _ in range(4):
        w = np.full(L, -1, np.int32)
        pos, g = 1, 0
        while pos < n + 1:
            ln = min(int(rng.randint(1, 4)), n + 1 - pos)
            w[pos:pos + ln] = g
            pos += ln
            g += 1
        rows.append(w)
    return np.stack(rows)


@pytest.mark.parametrize("whole_word", [True, False])
@pytest.mark.parametrize("prob,ties", [(0.35, False), (0.15, True)])
def test_apply_mlm_replays_jax_bit_equal(whole_word, prob, ties):
    rng = np.random.RandomState(2)
    L, V, MASK = (40 if ties else 24), 1000, 103
    word_ids = (_tie_rows(rng, L) if ties else
                np.stack([_random_row(rng, L) for _ in range(16)]))
    B = len(word_ids)
    ids = rng.randint(5, V, (B, L)).astype(np.int32)
    special = word_ids < 0
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = J_APPLY_MLM(jnp.asarray(ids), jnp.asarray(special), key,
                           prob, V, MASK, jnp.asarray(word_ids)
                           if whole_word else None)
        got = text_masking.apply_mlm(
            _t(ids), _t(special), _jax_draws(key, (B, L), V, whole_word),
            prob, MASK, word_ids=_t(word_ids) if whole_word else None)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if ties and whole_word:   # the f64 budget: 4 tokens of the 30
            assert ((got[1] != -100).sum(1) <= 4).all()


def test_budget_table_is_host_f64():
    t = text_masking.budget_table(40, 0.15)
    assert int(t[30]) == 4 and int(t[0]) == 1 and int(t[10]) == 2
    assert t.tolist() == [min(512, max(1, int(round(n * 0.15))))
                          for n in range(41)]


def test_mlm_draws_and_masks_are_well_formed():
    rng = np.random.RandomState(3)
    B, L, V = 64, 24, 1000
    word_ids = np.stack([_random_row(rng, L) for _ in range(B)])
    ids = _t(rng.randint(5, V, (B, L)))
    g = torch.Generator().manual_seed(0)
    draws = text_masking.mlm_draws((B, L), g, V, whole_word=True)
    assert set(draws) == {"order_u", "replace_u", "random_u", "random_tok"}
    assert int(draws["random_tok"].min()) >= 0 and \
        int(draws["random_tok"].max()) < V
    mlm_ids, labels = text_masking.apply_mlm(
        ids, _t(word_ids < 0), draws, 0.4, 103, word_ids=_t(word_ids))
    masked = labels != -100
    assert masked.any() and not (masked & _t(word_ids < 0)).any()
    assert torch.equal(labels[masked], ids[masked])
    assert torch.equal(mlm_ids[~masked], ids[~masked])


# --------------------------------------------------------------------------
# the train step's hooks
# --------------------------------------------------------------------------

def test_device_augment_step_matches_jax():
    """One micro-batch of 4 native-size images (one upscaled) through the
    step under ``device_augment``: the host draws bit-equal to the JAX
    package's, the augmented images within the augment's bound of JAX's,
    and the loss and every gradient against JAX ``make_train_step`` fed
    the port's augmented images (the JAX package's own images differ from
    them where its f32 resize leaves PIL's bytes)."""
    over = dict(drop_rate=0.0, device_augment=True)
    jcfg, cfg = _tiny_cfg(jbuild_config, drop_rate=0.0), \
        _tiny_cfg(build_config, **over)
    jspec, spec = jmake_spec(jcfg), make_model_spec(cfg)
    arrays, batch = _train_inputs(jspec)
    rng = np.random.RandomState(11)
    imgs = [_photo_like(rng, h, w)
            for h, w in ((70, 90), (96, 60), (40, 50), (88, 88))]
    canvas, sizes = image.pack_canvas(imgs, canvas_hw=(96, 96))
    host = {"image_canvas": canvas, "image_sizes": sizes,
            "text_ids": batch["text_ids"][0],
            "text_masks": batch["text_masks"][0]}
    feed = train_step.attach_augment_params(
        dict(host), cfg, np.random.RandomState(0))
    jfeed = jattach_augment_params(dict(host), dict(jcfg, **over),
                                   np.random.RandomState(0))
    assert set(feed) == set(jfeed) and "image_sizes" not in feed
    for k in feed:
        np.testing.assert_array_equal(feed[k], jfeed[k], err_msg=k)
    tfeed = {k: _t(v) for k, v in feed.items()}
    got = train_step.device_augment_batch(cfg, tfeed)
    assert "image_canvas" not in got and not any(
        k.startswith("aug_") for k in got)
    want = jdevice_augment_batch(
        jcfg, {k: jnp.asarray(v) for k, v in jfeed.items()})["image"]
    to_bytes = lambda x: np.round((x * 0.5 + 0.5) * 255.0)  # noqa: E731
    _agree(to_bytes(got["image"].numpy()), to_bytes(np.asarray(want)),
           0.997, 2)

    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jopt = jmake_optimizer(jparams, jcfg, 10, jmake_schedule(jcfg, 10))
    jstate = jinit_train_state(jparams, _capture_grads(jopt), seed=0)
    jstep = jmake_train_step(jcfg, jspec, _capture_grads(jopt),
                             donate=False)
    jstate, jm = jstep(jstate, {
        "image": jnp.asarray(got["image"].numpy()),
        "text_ids": jnp.asarray(host["text_ids"]),
        "text_masks": jnp.asarray(host["text_masks"])})
    params = master_params(params_from_numpy(arrays, "cpu"))
    loss, metrics, grads = train_step.loss_and_grads(
        params, spec, cfg, tfeed, torch.Generator().manual_seed(0),
        kernels=False)
    _close(loss, jm["total_loss"], err_msg="total_loss")
    jgrads = jstate.opt_state[1]
    assert set(jgrads) == set(grads)
    for k in jgrads:
        _close(grads[k], jgrads[k], err_msg=f"grad {k}")


def test_device_mlm_step_masks_on_the_device():
    """device_mlm: the step derives the MLM inputs from the word ids; the
    mlm loss is finite and differs between steps (the generator
    advances), as the JAX package's test holds."""
    cfg = build_config(
        "task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl", "ufo",
        overrides=dict(hidden_size=64, num_heads=2, num_layers=2,
                       image_size=32, patch_size=16, max_text_len=12,
                       max_text_len_of_initckpt=16, vlffn_start_layer_index=2,
                       precision="f32", device_mlm=True, mask_token_id=103,
                       whole_word_masking=True, warmup_steps=0,
                       per_device_batch_size=4, batch_size=4))
    spec = make_model_spec(cfg)
    rng = np.random.RandomState(0)
    B, L = 4, cfg["max_text_len"]
    batch = {"text_ids": _t(rng.randint(5, spec.vocab_size, (B, L))),
             "text_masks": torch.ones(B, L, dtype=torch.int64),
             "text_word_ids": _t(np.stack([_random_row(rng, L)
                                           for _ in range(B)])),
             "image": _t(rng.randn(B, 3, 32, 32).astype(np.float32))}
    state, step = build_train_step(
        cfg, spec, master_params(init_params(
            spec, torch.Generator().manual_seed(0))), 10)
    state, m1 = step(state, batch)
    _, m2 = step(state, batch)
    assert np.isfinite(float(m1["total_loss"]))
    assert np.isfinite(float(m1["mlm_loss"]))
    assert float(m1["mlm_loss"]) != float(m2["mlm_loss"])
    with pytest.raises(ValueError, match="mask_token_id"):
        train_step.device_mlm_batch(dict(cfg, mask_token_id=None), spec,
                                    batch, torch.Generator())


def test_vlffn_rerun_at_full_depth_matches_jax():
    """With ``vlffn_start_layer_index`` at the depth (the config of the
    device_mlm step above) the vlffn re-run has no layer and starts from
    the last layer's output: both towers' features against the JAX
    package's."""
    from test_torch_port_model import random_arrays
    from vl_merging_tpu.models import model as jmodel
    from vl_merging_tpu_torch.models import model

    over = dict(hidden_size=64, num_heads=2, num_layers=2, image_size=32,
                patch_size=16, max_text_len=12, max_text_len_of_initckpt=16,
                vlffn_start_layer_index=2, precision="f32", drop_rate=0.0)
    names = ("task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl", "ufo")
    jspec = jmake_spec(jbuild_config(*names, overrides=over))
    spec = make_model_spec(build_config(*names, overrides=over))
    arrays = random_arrays(jspec, 3)
    rng = np.random.RandomState(5)
    batch = {"text_ids": rng.randint(5, 1000, (2, 12)),
             "text_masks": np.ones((2, 12), np.int64),
             "image": rng.randn(2, 3, 32, 32).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    tp = params_from_numpy(arrays, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    for jfn, fn in ((jmodel.infer_image, model.infer_image),
                    (jmodel.infer_text, model.infer_text)):
        want = jax.jit(lambda p, b: jfn(p, jspec, b))(jp, jb)
        got = fn(tp, spec, tb, kernels=False)
        for key in ("cls_feats", "cls_vlffn_feats"):
            _close(got[key], want[key], err_msg=key)


def test_mixed_batch_masks_each_sub_batch():
    """A mixed {"v", "l", "vl"} batch: the text sub-batches are masked,
    "vl" at vl_mlm_prob; the image sub-batch passes through."""
    cfg = build_config("task_all_in_one_pretraining", overrides=dict(
        mask_token_id=103, device_mlm=True, mlm_prob=0.4, vl_mlm_prob=0.0001,
        whole_word_masking=False))
    spec = make_model_spec(cfg)
    rng = np.random.RandomState(4)
    text = {"text_ids": _t(rng.randint(5, 1000, (8, 16))),
            "text_word_ids": _t(np.stack([_random_row(rng, 16)
                                          for _ in range(8)]))}
    img = {"image": torch.zeros(2, 3, 8, 8)}
    out = train_step.device_mlm_batch(
        cfg, spec, {"v": img, "l": dict(text), "vl": dict(text)},
        torch.Generator().manual_seed(1))
    assert out["v"] is img
    assert (out["l"]["text_labels_mlm"] != -100).sum() > 10
    assert (out["vl"]["text_labels_mlm"] != -100).sum() == 0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(make_fixture_root(tmp_path_factory.mktemp("preprocess")))


def test_trainer_fits_with_device_augment_and_mlm(root, tmp_path):
    """``Trainer.fit`` with ``device_augment`` and ``device_mlm`` on the
    CPU: the loader's canvases get their host draws, the mask id comes
    from the tokenizer, and two steps of 2 micro-batches run."""
    cfg = build_config("ufo", overrides=dict(
        datasets=["coco"], data_root=root,
        tokenizer=os.path.join(root, "vocab.txt"), log_dir=str(tmp_path),
        hidden_size=32, num_heads=2, num_layers=2, image_size=32,
        patch_size=16, max_text_len=12, max_text_len_of_initckpt=16,
        vlffn_start_layer_index=2, precision="f32", use_cpu=True,
        per_device_batch_size=2, batch_size=4, num_workers=0, max_steps=2,
        warmup_steps=0, device_augment=True, device_mlm=True,
        whole_word_masking=True, canvas_size=96,
        loss_names={"itm": 1, "mlm": 1, "ifm": 1}))
    trainer = loop.Trainer(cfg)
    seen = []
    attach = train_step.attach_augment_params

    def spy(batch, c, rng):
        out = attach(batch, c, rng)
        seen.append(sorted(k for k in out if k.startswith(("aug_", "image"))))
        return out

    train_step.attach_augment_params = spy
    try:
        trainer.fit(loop_datamodule(cfg))
    finally:
        train_step.attach_augment_params = attach
    assert trainer.state.step == 2 and cfg["mask_token_id"] is not None
    assert seen and all(s == ["aug_affine", "aug_crop", "aug_factor",
                              "aug_flip", "aug_op_apply", "aug_op_idx",
                              "image_canvas"] for s in seen)


def loop_datamodule(cfg):
    from vl_merging_tpu_torch.data.datamodule import MTDataModule
    return MTDataModule(cfg)

