"""The port's four eval-block routes (``fusion``: "pair", "tail", "qkv",
"mega") against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run their plain twins: K4
``linear_residual``, K5 ``mlp_tail``, K8 ``ln_qkv_attention`` and K7
``block_eval``.  Here the twins are held against the JAX kernels run in
Pallas interpret mode (``_INTERPRET``, ``default_backend`` and ``BLOCK_M``
patched, as tests/test_torch_port_kernels.py does; the routes' module
gates ``_FUSE_LN_QKV_ATTN`` and ``_FUSE_EVAL_BLOCK`` patched as
tests/test_fused_block.py does), on the same numpy inputs.  Tolerances:
  * f32: atol = rtol = 2e-5 (summation order; the JAX kernels' A&S erf
    differs from exact erf by <= 1.5e-7);
  * bf16: both sides round at the same points, so they differ only where
    a value lies within f32 summation noise of a bf16 rounding boundary:
    one bf16 ulp relative plus 1/64 of an ulp of the largest output (the
    slice-1 tolerance);
  * the four routes' twins, and the port's tower under each route:
    bitwise (the same rounding points, and K3's twin is K4's then K5's);
  * the port's tower under "mega" against the JAX tower under
    ``_FUSE_EVAL_BLOCK``: f32 atol 1e-5, rtol 1e-4, identical R@{1,5,10}.
The K7 and K8 cases use the smallest shapes the JAX gates take
(tests/test_fused_block.py: B = 2, 2 heads, Np = 272, 260 valid keys).
The CUDA kernels themselves run only on the card
(tests/test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vl_merging_tpu.config import build_config
from vl_merging_tpu.evaluation import retrieval as jretrieval
from vl_merging_tpu.models import make_model_spec as jmake_spec
from vl_merging_tpu.models.spec import param_shapes as jparam_shapes
from vl_merging_tpu.ops import attention as A
from vl_merging_tpu.ops import fused_block as F
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    params_from_numpy
from vl_merging_tpu_torch.evaluation import retrieval
from vl_merging_tpu_torch.models import model
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import fused_block as TF
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=2e-5, rtol=2e-5)
TOWER_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny specs' width (128) stands in for a width the kernels are
    built for (``fused_block.KERNEL_WIDTHS``): on CPU tensors every wrapper
    runs its twin, which takes any width, so the kernel routes run here."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


@pytest.fixture()
def interpret_kernels(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(F, "BLOCK_M", 8)
    monkeypatch.setattr(A, "_INTERPRET", True)


def _arrays(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shp) * s + m).astype(np.float32)
            for shp, s, m in shapes]


def _pair(arrs, dtypes):
    """The same arrays as JAX and as CPU torch tensors, each cast to its
    dtype ("bf16", "f32", or None for f32 parameters)."""
    jx, th = [], []
    for a, dt in zip(arrs, dtypes):
        if a.dtype == np.int32:
            jx.append(jnp.asarray(a))
            th.append(torch.from_numpy(a))
            continue
        jx.append(jnp.asarray(a).astype(jnp.bfloat16 if dt == "bf16"
                                        else jnp.float32))
        th.append(torch.from_numpy(a).to(torch.bfloat16 if dt == "bf16"
                                         else torch.float32))
    return jx, th


def _assert_close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max() / 64)


def _tail_arrays(seed, B=2, N=8, C=128, H=512):
    """ctx, wp, bp, γ1, res, ln_w, ln_b, w1, b1, w2, b2, γ2 and their
    dtypes (activations and weights in the test's dtype)."""
    arrs = _arrays(seed, [((B, N, C), 0.5, 0), ((C, C), 0.05, 0),
                          ((C,), 0.5, 0), ((C,), 0.1, 0), ((B, N, C), 0.5, 0),
                          ((C,), 0.1, 1), ((C,), 0.5, 0), ((H, C), 0.05, 0),
                          ((H,), 0.5, 0), ((C, H), 0.05, 0), ((C,), 0.5, 0),
                          ((C,), 0.1, 0)])
    return arrs, ["x", "x", None, None, "x", None, None, "x", None, "x",
                  None, None]


def _block_arrays(seed):
    """The whole-block inputs at the JAX gates' smallest shapes: B = 2,
    2 heads of 64, Np = 272 with 260 valid keys, MLP 512."""
    B, H, Np, C, H1 = 2, 2, 272, 128, 512
    arrs = _arrays(seed, [((B, Np, C), 1.0, 0), ((C,), 0.1, 1),
                          ((C,), 0.05, 0), ((3 * C, C), 0.05, 0),
                          ((3 * C,), 0.05, 0), ((H, Np, Np), 0.5, 0)])
    mask = np.ones((B, Np), np.int32)
    mask[:, 260:] = 0
    tail = _arrays(seed + 1, [((C, C), 0.05, 0), ((C,), 0.05, 0),
                              ((C,), 0.1, 0), ((C,), 0.1, 1), ((C,), 0.05, 0),
                              ((H1, C), 0.05, 0), ((H1,), 0.05, 0),
                              ((C, H1), 0.05, 0), ((C,), 0.05, 0),
                              ((C,), 0.1, 0)])
    head = arrs + [mask]
    dts = ["x", None, None, "x", None, None, None]
    tdts = ["x", None, None, None, None, "x", None, "x", None, None]
    return head, dts, tail, tdts, H


def _dts(dts, dtype):
    return [dtype if d == "x" else None for d in dts]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_residual_twin_matches_jax_kernel(interpret_kernels, dtype):
    arrs, dts = _tail_arrays(0)
    (x, w, b, g, res), (tx, tw, tb, tg, tres) = _pair(
        [arrs[i] for i in (0, 1, 2, 3, 4)],
        _dts([dts[i] for i in (0, 1, 2, 3, 4)], dtype))
    want = F.linear_residual(x, w, b, g, res, use_pallas=True)
    n = TF.linear_residual.launches
    got = TF.linear_residual(tx, tw, tb, tg, tres)
    assert TF.linear_residual.launches == n   # the twin, not the kernel
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_tail_twin_matches_jax_kernel(interpret_kernels, dtype):
    arrs, dts = _tail_arrays(1)
    idx = (4, 5, 6, 7, 8, 9, 10, 11)
    jargs, targs = _pair([arrs[i] for i in idx],
                         _dts([dts[i] for i in idx], dtype))
    want = F.mlp_tail(*jargs, use_pallas=True)
    n = TF.mlp_tail.launches
    got = TF.mlp_tail(*targs)
    assert TF.mlp_tail.launches == n
    assert got.dtype == targs[0].dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_proj_mlp_tail_pair_bit_equals_tail(dtype):
    """Under "pair" proj_mlp_tail runs the K4 → K5 twins, under "tail"
    K3's: bitwise equal on the CPU."""
    arrs, dts = _tail_arrays(2)
    _, targs = _pair(arrs, _dts(dts, dtype))
    pair = TF.proj_mlp_tail(*targs, fusion="pair")
    tail = TF.proj_mlp_tail(*targs)
    assert pair.dtype == targs[0].dtype
    assert torch.equal(pair, tail)
    with pytest.raises(ValueError, match="fusion"):
        TF.proj_mlp_tail(*targs, fusion="whole")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_qkv_attention_twin_matches_jax_kernel(interpret_kernels,
                                                  monkeypatch, dtype):
    monkeypatch.setattr(A, "_FUSE_LN_QKV_ATTN", True)
    head, dts, _, _, H = _block_arrays(3)
    (x, lw, lb, w, b, bias, mask), targs = _pair(head, _dts(dts, dtype))
    want = A.ln_qkv_attention(x, lw, lb, w, b, bias, mask, 0.125, H,
                              use_pallas=True)
    n = TF.ln_qkv_attention.launches
    got = TF.ln_qkv_attention(*targs, 0.125, H)
    assert TF.ln_qkv_attention.launches == n
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_eval_twin_matches_jax_megakernel(interpret_kernels,
                                                monkeypatch, dtype):
    """K7's twin against the megakernel (``_FUSE_EVAL_BLOCK``), and the
    port's four routes' twins bitwise equal to each other."""
    monkeypatch.setattr(F, "_FUSE_EVAL_BLOCK", True)
    head, dts, tail, tdts, H = _block_arrays(4)
    jh, th = _pair(head, _dts(dts, dtype))
    jt, tt = _pair(tail, _dts(tdts, dtype))
    want = F.fused_eval_block(*jh, 0.125, H, *jt, use_pallas=True)
    n = TF.block_eval.launches
    got = TF.block_eval(*th, 0.125, H, *tt)
    assert TF.block_eval.launches == n
    assert got.dtype == th[0].dtype and got.shape == th[0].shape
    _assert_close(got, want, dtype)
    for fusion in TF.FUSIONS:
        assert torch.equal(
            TF.fused_eval_block(*th, 0.125, H, *tt, fusion=fusion), got)


# --------------------------------------------------------------------------
# the image tower under each route, and against the JAX tower
# --------------------------------------------------------------------------

N_IMG, CAPS = 4, 3


def tiny_cfg(precision="f32", num_layers=1, **extra):
    """Image 256 / patch 16: N = 257 tokens (the JAX side pads to 272),
    so every image block reaches the eval kernels on both sides."""
    cfg = build_config("task_finetune_irtr_coco_square_randaug_base_image384",
                       "ufo", overrides=dict(
                           hidden_size=128, num_heads=2,
                           num_layers=num_layers, image_size=256,
                           patch_size=16, max_text_len=8,
                           max_text_len_of_initckpt=16,
                           vlffn_start_layer_index=1, precision=precision,
                           loss_names={"irtr": 1}))
    cfg.update(extra)
    return cfg


def random_arrays(jspec, seed):
    """Unit-scale rel-pos table, LN scales near 1, random biases and
    LayerScales, 0.02-scale weights."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in jparam_shapes(jspec).items():
        v = rng.randn(*shape)
        if len(shape) == 1:
            v = 0.1 * v + (1.0 if "norm" in k.lower() and
                           k.endswith(".weight") else 0.0)
        elif k != "relative_position_bias_table":
            v = 0.02 * v
        out[k] = np.asarray(v, np.float32)
    return out


def test_tower_is_bitwise_equal_under_every_fusion():
    cfg = tiny_cfg(precision="bf16", num_layers=2)
    spec = make_model_spec(cfg)
    params = eval_cast_params(
        params_from_numpy(random_arrays(jmake_spec(cfg), 5), "cpu"), spec,
        cfg)
    images = [{"image": torch.from_numpy(np.random.RandomState(6).randn(
        2, 3, 256, 256).astype(np.float32))}]
    feats = {f: retrieval.extract_features(params, spec, images, "image",
                                           fusion=f) for f in TF.FUSIONS}
    assert feats["tail"].dtype == torch.bfloat16
    for f in TF.FUSIONS:
        assert torch.equal(feats[f], feats["tail"]), f


@pytest.fixture()
def jax_mega_route(monkeypatch, interpret_kernels):
    """The JAX eval under the whole-block gate: report "tpu" (mome.py:
    _block_fast runs only there), run the kernels in interpret mode, and
    retrace the cached feature functions on entry and exit."""
    monkeypatch.setattr(F, "_FUSE_EVAL_BLOCK", True)
    jretrieval._make_image_feature_fn.cache_clear()
    jretrieval._make_text_feature_fn.cache_clear()
    yield
    jretrieval._make_image_feature_fn.cache_clear()
    jretrieval._make_text_feature_fn.cache_clear()


def test_mega_tower_and_recall_match_jax(jax_mega_route):
    cfg = tiny_cfg()
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 7)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    params = params_from_numpy(arrays, "cpu")
    rng = np.random.RandomState(8)
    images = rng.randn(N_IMG, 3, 256, 256).astype(np.float32)
    ids = rng.randint(0, 30522, (N_IMG * CAPS, 8)).astype(np.int32)
    masks = (np.arange(8)[None] < rng.randint(3, 9, (N_IMG * CAPS, 1))) \
        .astype(np.int32)
    tiids, iids = np.repeat(np.arange(N_IMG), CAPS), np.arange(N_IMG)
    halves = (slice(0, N_IMG // 2), slice(N_IMG // 2, None))
    jimg = [{"image": jnp.asarray(images[s])} for s in halves]
    timg = [{"image": torch.from_numpy(images[s])} for s in halves]
    jtxt = [{"text_ids": jnp.asarray(ids), "text_masks": jnp.asarray(masks)}]
    ttxt = [{"text_ids": torch.from_numpy(ids),
             "text_masks": torch.from_numpy(masks)}]

    calls = []
    real = TF.block_eval_reference
    TF.block_eval_reference = lambda *a: calls.append(1) or real(*a)
    try:
        got = retrieval.extract_features(params, spec, timg, "image",
                                         fusion="mega")
        got_r = retrieval.compute_irtr_recall(params, spec, ttxt, timg,
                                              tiids, iids, fusion="mega")
    finally:
        TF.block_eval_reference = real
    assert len(calls) == 2 * len(timg) * spec.num_layers   # K7's twin ran
    want = jretrieval.extract_features(jparams, jspec, jimg, "image")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOWER_TOL)
    want_r = jretrieval.compute_irtr_recall(jparams, jspec, jtxt, jimg,
                                            tiids, iids)
    assert got_r == want_r


def test_fusion_rejects_unknown_values_and_non_tail_int8():
    cfg = tiny_cfg()
    spec = make_model_spec(cfg)
    arrays = random_arrays(jmake_spec(cfg), 9)
    params = params_from_numpy(arrays, "cpu")
    image = {"image": torch.zeros(1, 3, 256, 256)}
    with pytest.raises(ValueError, match="fusion 'fast'"):
        model.infer_image_ft(params, spec, image, fusion="fast")
    cfg8 = dict(cfg, eval_int8=True)
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(params_from_numpy(arrays, "cpu"), spec8, cfg8)
    assert model.infer_image_ft(params8, spec8, image)["cls_feats"] \
        .shape == (1, spec.hidden_size)
    for fusion in ("pair", "qkv", "mega"):
        with pytest.raises(ValueError, match="one route"):
            model.infer_image_ft(params8, spec8, image, fusion=fusion)
