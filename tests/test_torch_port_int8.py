"""The port's W8A8 int8 eval (``ops/int8.py``, K12/K14/K15 twins) against
the JAX package's, on the CPU.

Seeded numpy inputs go through the JAX function and its port.  The JAX
kernels run in Pallas interpret mode (``_INTERPRET`` patched, a small
``BLOCK_M``, as tests/test_int8.py does).  Tolerances:
  * the weight and activation quantizers and the quantized param dicts:
    bitwise;
  * the gelus: the polynomials bitwise against the JAX functions run
    eagerly (one rounding per operation on both sides); the A&S erf gelu
    within atol 5e-7 (torch's and XLA's exp differ in the last ulp);
  * the K14/K15/K12 twins: in f32, atol 1e-6 and rtol 1e-5 (summation
    order; the integer products are exact); in bf16, one bf16 ulp
    relative plus 1/64 of an ulp of the largest output (a value within
    f32 noise of a bf16 rounding boundary; the JAX kernels' XLA fusions
    reorder the f32 gelu arithmetic), and at most 1e-3 of the elements
    off at all; K12's twin, whose output sums bf16 probabilities that may
    round the other way times unit-scale values, to atol and rtol of one
    bf16 ulp at 1 (2⁻⁷; tests/test_int8.py holds the JAX kernel to its
    twin at 0.008);
  * the int8 image tower: in f32 atol 1e-5, rtol 1e-4; in bf16 with the
    int8-QK attention, atol 2e-3 (f32 noise in q or k that moves one
    quantized value moves a logit by a quantization step); identical
    R@{1,5,10} from ``compute_irtr_recall`` in both.
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
from vl_merging_tpu.ops import attention as JA
from vl_merging_tpu.ops import int8 as JI
from vl_merging_tpu.ops import mlp as JM
from vl_merging_tpu.train.loop import eval_cast_params as j_eval_cast
from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    params_from_numpy
from vl_merging_tpu_torch.evaluation import retrieval
from vl_merging_tpu_torch.models import model, mome
from vl_merging_tpu_torch.models.spec import make_model_spec
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.ops import int8 as TI
from vl_merging_tpu_torch.ops import mlp as TM
from torch_port_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=1e-6, rtol=1e-5)
TOWER_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_ULP = 2.0 ** -7
BF16_MISMATCH = 1e-3
JAX_GELUS = {"poly": JM._poly_gelu, "poly11": JM._poly11_gelu,
             "poly13": JM._poly13_gelu, "erf": JM._erf_gelu}


@pytest.fixture(autouse=True)
def _tiny_width_is_built(monkeypatch):
    """The tiny specs' width (128) stands in for a width the kernels are
    built for (``fused_block.KERNEL_WIDTHS``): on CPU tensors every wrapper
    runs its twin, which takes any width, so the kernel routes run here."""
    monkeypatch.setattr(TF, "KERNEL_WIDTHS", {
        k: v + (128,) for k, v in TF.KERNEL_WIDTHS.items()})


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(JI, "_INTERPRET", True)
    monkeypatch.setattr(JI, "BLOCK_M", 16)
    monkeypatch.setattr(JA, "_INTERPRET", True)


def _pair(arrays, dtype):
    """The same numpy arrays as JAX and as CPU torch tensors in dtype."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _assert_close(got: torch.Tensor, want, dtype: str,
                  attention: bool = False):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(g, w, **F32_TOL)
    elif attention:
        np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=BF16_ULP)
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(w).max() / 64)
        assert (g != w).mean() <= BF16_MISMATCH, (g != w).mean()


def tiny_cfg(*modes, precision="f32", image_size=64, num_layers=2):
    cfg = build_config(*modes, overrides=dict(
        hidden_size=128, num_heads=2, num_layers=num_layers,
        image_size=image_size,
        patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
        vlffn_start_layer_index=1, precision=precision,
        loss_names={"irtr": 1}))
    cfg["eval_int8"] = True
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


# --------------------------------------------------------------------------
# quantization, bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("modes,precision", [(("ufo",), "bf16"),
                                             (("all_moe",), "bf16"),
                                             (("ufo",), "f32")])
def test_quantized_params_match_jax_bitwise(modes, precision):
    """quantize_eval_params (through eval_cast_params) picks the same keys
    with the regex and gives bit-identical int8 weights and f32 scales,
    in the bf16 and the f32 branch; a JAX-quantized dict comes through
    params_from_numpy unchanged, also when it casts floating leaves."""
    cfg = tiny_cfg(*modes, precision=precision)
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 0)
    want = j_eval_cast({k: jnp.asarray(v) for k, v in arrays.items()},
                       jspec, cfg)
    got = eval_cast_params(params_from_numpy(arrays, "cpu"), spec, cfg)
    added = sorted(k for k in want if k not in arrays)
    assert added and sorted(k for k in got if k not in arrays) == added
    assert all(TI._QUANT_KEY_RE.match(k.split("::")[0]) for k in added)
    carried = params_from_numpy({k: np.asarray(want[k]) for k in added},
                                "cpu")
    cast = params_from_numpy({k: np.asarray(want[k]) for k in added}, "cpu",
                             torch.bfloat16)
    for k in added:
        w = np.asarray(want[k])
        assert got[k].dtype == (torch.int8 if k.endswith(TI.INT8_SUFFIX)
                                else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        assert carried[k].dtype == cast[k].dtype == got[k].dtype
        assert torch.equal(carried[k], got[k]) and torch.equal(cast[k], got[k])
    for k in arrays:   # and the bf16 cast of the originals
        assert str(got[k].dtype) == f"torch.{np.asarray(want[k]).dtype}", k


def test_quant_rows_and_quantize_weight_match_jax_bitwise():
    """Activation quantizer (per row, no clip; ties, zeros and a zero row
    included) and weight quantizer (per output channel, clipped)."""
    rng = np.random.RandomState(1)
    x = (3 * rng.randn(64, 96)).astype(np.float32)
    x[0] = 0.0
    x[1, :4] = [127.0, 0.5, -0.5, 1.5]   # amax 127: scale 1, exact ties
    q, s = TA.quant_rows(torch.from_numpy(x))
    jq, js = JI._quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    q4, s4 = TA.quant_rows(torch.from_numpy(x.reshape(2, 2, 16, 96)))
    jq4, js4 = JA._quant_last_i8(jnp.asarray(x.reshape(2, 2, 16, 96)))
    np.testing.assert_array_equal(q4.numpy(), np.asarray(jq4))
    np.testing.assert_array_equal(s4.numpy(), np.asarray(js4))
    w = (0.05 * rng.randn(48, 96)).astype(np.float32)
    w[3] = 0.0
    wq, ws = TI.quantize_weight(torch.from_numpy(w))
    jwq, jws = JI.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


@pytest.mark.parametrize("name", sorted(JAX_GELUS))
def test_gelus_match_jax(name):
    x = np.linspace(-12.0, 12.0, 24001).astype(np.float32)
    got = TM.GELUS[name](torch.from_numpy(x)).numpy()
    want = np.asarray(JAX_GELUS[name](jnp.asarray(x)))
    if name == "erf":
        np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the K14 / K15 / K12 twins against the JAX kernels
# --------------------------------------------------------------------------

def _ln_linear_inputs(rng, B=2, N=40, C=128, O=384):
    return [rng.randn(B, N, C).astype(np.float32),
            (1 + 0.1 * rng.randn(C)).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32),
            (0.05 * rng.randn(O, C)).astype(np.float32),
            (0.1 * rng.randn(O)).astype(np.float32)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_linear_i8_twin_matches_jax_kernel(dtype, interpret_kernels):
    x, lnw, lnb, w, b = _ln_linear_inputs(np.random.RandomState(2))
    (jx,), (tx,) = _pair([x], dtype)
    jwq, jws = JI.quantize_weight(jnp.asarray(w))
    wq, ws = TI.quantize_weight(torch.from_numpy(w))
    want = JI.ln_linear_i8(jx, jnp.asarray(lnw), jnp.asarray(lnb), jwq,
                           jws, jnp.asarray(b), use_pallas=True)
    n = TI.ln_linear_i8.launches
    got = TI.ln_linear_i8(tx, torch.from_numpy(lnw), torch.from_numpy(lnb),
                          wq, ws, torch.from_numpy(b))
    assert TI.ln_linear_i8.launches == n   # the twin, not the kernel
    assert got.dtype == tx.dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype,gelu", [("f32", "poly"), ("bf16", "poly"),
                                        ("bf16", "poly11"),
                                        ("bf16", "poly13"), ("bf16", "erf")])
def test_proj_mlp_tail_i8_twin_matches_jax_kernel(dtype, gelu,
                                                  interpret_kernels,
                                                  monkeypatch):
    monkeypatch.setattr(JI, "_GELU", JAX_GELUS[gelu])
    rng = np.random.RandomState(3)
    B, N, C, H = 2, 40, 128, 512

    def r(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)

    (jctx, jres), (tctx, tres) = _pair([r(B, N, C), r(B, N, C)], dtype)
    wp, w1, w2 = r(C, C, s=0.05), r(H, C, s=0.05), r(C, H, s=0.05)
    vecs = dict(bp=r(C, s=0.1), g1=r(C, s=0.1), lnw=1 + r(C, s=0.1),
                lnb=r(C, s=0.1), b1=r(H, s=0.1), b2=r(C, s=0.1),
                g2=r(C, s=0.1))
    J = {k: jnp.asarray(v) for k, v in vecs.items()}
    T = {k: torch.from_numpy(v) for k, v in vecs.items()}
    jq = [JI.quantize_weight(jnp.asarray(w)) for w in (wp, w1, w2)]
    tq = [TI.quantize_weight(torch.from_numpy(w)) for w in (wp, w1, w2)]
    want = JI.proj_mlp_tail_i8(jctx, *jq[0], J["bp"], J["g1"], jres,
                               J["lnw"], J["lnb"], *jq[1], J["b1"], *jq[2],
                               J["b2"], J["g2"], use_pallas=True)
    got = TI.proj_mlp_tail_i8(tctx, *tq[0], T["bp"], T["g1"], tres,
                              T["lnw"], T["lnb"], *tq[1], T["b1"], *tq[2],
                              T["b2"], T["g2"], gelu=gelu)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_linear_i8_twin_matches_jax_reference_at_1024(dtype):
    """K14's twin at the ViT-L width (C = 1024, O = 3072; 48 rows) against
    the JAX package's jnp reference ``ref_ln_linear_i8`` (the oracle of its
    kernel), with the tolerance of the C = 128 case above."""
    x, lnw, lnb, w, b = _ln_linear_inputs(np.random.RandomState(5), B=2,
                                          N=24, C=1024, O=3072)
    (jx,), (tx,) = _pair([x], dtype)
    want = JI.ref_ln_linear_i8(jx, jnp.asarray(lnw), jnp.asarray(lnb),
                               *JI.quantize_weight(jnp.asarray(w)),
                               jnp.asarray(b))
    got = TI.ln_linear_i8(tx, torch.from_numpy(lnw), torch.from_numpy(lnb),
                          *TI.quantize_weight(torch.from_numpy(w)),
                          torch.from_numpy(b))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("gelu", ["poly", "erf"])
def test_proj_mlp_tail_i8_twin_matches_jax_reference_at_1024(gelu,
                                                             monkeypatch):
    """K15's twin at the ViT-L width (C = 1024, MLP 4096; 48 rows, bf16)
    against the JAX package's jnp reference ``ref_proj_mlp_tail_i8``, with
    the tolerance of the C = 128 case above: XLA and torch sum the f32
    LayerNorm statistics in another order, which at this width moves a
    quantized value across a rounding tie in a few rows."""
    monkeypatch.setattr(JI, "_GELU", JAX_GELUS[gelu])
    rng = np.random.RandomState(6)
    B, N, C, H = 2, 24, 1024, 4096

    def r(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)

    (jctx, jres), (tctx, tres) = _pair([r(B, N, C), r(B, N, C)], "bf16")
    wp, w1, w2 = r(C, C, s=0.05), r(H, C, s=0.05), r(C, H, s=0.05)
    vecs = dict(bp=r(C, s=0.1), g1=r(C, s=0.1), lnw=1 + r(C, s=0.1),
                lnb=r(C, s=0.1), b1=r(H, s=0.1), b2=r(C, s=0.1),
                g2=r(C, s=0.1))
    J = {k: jnp.asarray(v) for k, v in vecs.items()}
    T = {k: torch.from_numpy(v) for k, v in vecs.items()}
    jq = [JI.quantize_weight(jnp.asarray(w)) for w in (wp, w1, w2)]
    tq = [TI.quantize_weight(torch.from_numpy(w)) for w in (wp, w1, w2)]
    want = JI.ref_proj_mlp_tail_i8(jctx, *jq[0], J["bp"], J["g1"], jres,
                                   J["lnw"], J["lnb"], *jq[1], J["b1"],
                                   *jq[2], J["b2"], J["g2"])
    got = TI.proj_mlp_tail_i8(tctx, *tq[0], T["bp"], T["g1"], tres,
                              T["lnw"], T["lnb"], *tq[1], T["b1"], *tq[2],
                              T["b2"], T["g2"], gelu=gelu)
    _assert_close(got, want, "bf16")


def _attention_inputs(rng, B=2, N=128, H=2):
    qkv = rng.randn(B, N, 3 * 64 * H).astype(np.float32)
    bias = rng.randn(H, N, N).astype(np.float32)
    mask = np.ones((B, N), np.int32)
    mask[-1, 100:] = 0
    return qkv, bias, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_i8qk_twin_matches_jax(dtype, interpret_kernels):
    """K12's twin against _packed_reference_i8qk and the interpret kernel
    (B=2, N=128, 2 heads of 64, a ragged key mask)."""
    qkv, bias, mask = _attention_inputs(np.random.RandomState(4))
    (jqkv,), (tqkv,) = _pair([qkv], dtype)
    args = (jnp.asarray(bias), jnp.asarray(mask), 0.125, 2)
    targs = (torch.from_numpy(bias), torch.from_numpy(mask), 0.125, 2)
    got = TA.packed_attention_i8qk(tqkv, *targs)
    assert got.shape == (2, 128, 128) and got.dtype == tqkv.dtype
    for want in (JA._packed_reference_i8qk(jqkv, *args),
                 JA._pallas_packed_attention(jqkv, *args, block_b=2,
                                             qk_int8=True)):
        _assert_close(got, want, dtype, attention=True)
    with pytest.raises(ValueError, match="eval only"):
        TA.packed_attention_i8qk(tqkv.requires_grad_(), *targs)


# --------------------------------------------------------------------------
# the int8 image tower and the retrieval eval against the JAX int8 eval
# --------------------------------------------------------------------------

N_IMG, CAPS = 4, 3


@pytest.fixture()
def jax_int8_route(monkeypatch, interpret_kernels):
    """The JAX eval reaches its int8 route only on a TPU backend
    (mome.py:230-234): report "tpu", run every kernel in interpret mode,
    and retrace the cached feature functions on entry and exit."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jretrieval._make_image_feature_fn.cache_clear()
    jretrieval._make_text_feature_fn.cache_clear()
    yield
    jretrieval._make_image_feature_fn.cache_clear()
    jretrieval._make_text_feature_fn.cache_clear()


@pytest.mark.parametrize("precision,qk_int8,tol", [
    ("f32", False, TOWER_TOL), ("bf16", True, dict(atol=2e-3, rtol=0))])
def test_int8_tower_and_recall_match_jax(precision, qk_int8, tol,
                                         jax_int8_route, monkeypatch):
    """Image 256 / patch 16: N = 257 tokens, padded to 272 on the JAX side
    (its sublane pad) and not on the port's; one layer through K14 → K2
    (or K12) → K15 twins.  Text batches stay under 256 rows, so both sides
    run the plain text MLP."""
    monkeypatch.setenv("VLM_TPU_I8_QK", "1" if qk_int8 else "0")
    cfg = tiny_cfg("ufo", precision=precision, image_size=256, num_layers=1)
    jspec, spec = jmake_spec(cfg), make_model_spec(cfg)
    arrays = random_arrays(jspec, 5)
    jparams = j_eval_cast({k: jnp.asarray(v) for k, v in arrays.items()},
                          jspec, cfg)
    params = eval_cast_params(params_from_numpy(arrays, "cpu"), spec, cfg)
    rng = np.random.RandomState(6)
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

    want = jretrieval.extract_features(jparams, jspec, jimg, "image")
    got = retrieval.extract_features(params, spec, timg, "image",
                                     qk_int8=qk_int8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    want_r = jretrieval.compute_irtr_recall(jparams, jspec, jtxt, jimg,
                                            tiids, iids)
    got_r = retrieval.compute_irtr_recall(params, spec, ttxt, timg, tiids,
                                          iids, qk_int8=qk_int8)
    assert got_r == want_r


def test_int8_params_route_through_the_int8_block(monkeypatch):
    """With int8 companions every image block (N ≥ KERNEL_MIN_N) goes
    through fused_eval_block_i8: the K14/K15 twins run and the K1/K3 twins
    do not; qk_int8 swaps the K2 twin for K12's; kernels=False, or params
    without companions, keep the bf16 routes."""
    cfg = tiny_cfg("ufo", image_size=256)
    spec = make_model_spec(cfg)
    arrays = random_arrays(jmake_spec(cfg), 7)
    plain = params_from_numpy(arrays, "cpu")
    params = eval_cast_params(plain, spec, cfg)
    calls = []
    for mod, name in ((TI, "ref_ln_linear_i8"), (TI, "ref_proj_mlp_tail_i8"),
                      (TF, "ln_linear_reference"),
                      (TF, "proj_mlp_tail_reference"),
                      (TA, "packed_attention_reference"),
                      (TA, "packed_attention_i8qk_reference")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    image = {"image": torch.randn(2, 3, 256, 256,
                                  generator=torch.Generator().manual_seed(0))}
    L = spec.num_layers

    def run(p, **kw):
        calls.clear()
        model.infer_image_ft(p, spec, image, **kw)
        return sorted(set(calls)), len(calls)

    assert run(params) == (["packed_attention_reference", "ref_ln_linear_i8",
                            "ref_proj_mlp_tail_i8"], 3 * L)
    assert run(params, qk_int8=True) == (
        ["packed_attention_i8qk_reference", "ref_ln_linear_i8",
         "ref_proj_mlp_tail_i8"], 3 * L)
    assert run(plain) == (["ln_linear_reference", "packed_attention_reference",
                           "proj_mlp_tail_reference"], 3 * L)
    assert run(params, kernels=False) == ([], 0)
    assert mome.KERNEL_MIN_N <= 257
