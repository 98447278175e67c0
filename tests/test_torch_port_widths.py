"""The port's kernels at every named model width (fault C5).

The width-specific kernels are built for some model widths only
(``ops.fused_block.KERNEL_WIDTHS``: each at 768 and 1024), and the port's
routing asks ``kernel_takes`` -- the JAX package's own shape gates
intersected with the built widths -- before any launch, as a pure
function of shapes.  At C=192 (the vit-tiny configs) the default route
takes the plain ops for K1/K3/K13/K6, as the JAX package takes XLA; at
C=1024 (ViT-L) every route takes its kernels; an opt-in route whose
kernel is not built for the width (C=640, which the JAX gates take)
raises ``ValueError`` before any launch.

The routing tests need no card: a recording stub stands in for the kernel
wrappers (on CPU tensors each wrapper runs its plain twin), and one
full-width, one-layer ``block_forward`` of each named config runs at a
small token count, with the routing thresholds set so that it is routed as
the config's image or text block is at its real token count.  Only the K9
statistics test imports JAX, inside the test, to run the JAX package's
backward kernel in interpret mode.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from vl_merging_tpu_torch.config import build_config, named_config_names
from vl_merging_tpu_torch.models import mome
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec, \
    V
from vl_merging_tpu_torch.ops import attention as TA
from vl_merging_tpu_torch.ops import fused_block as TF
from vl_merging_tpu_torch.ops import int8 as TI
from vl_merging_tpu_torch.ops import mlp as TM
from torch_port_threads import one_torch_thread  # noqa: F401

LARGE = "task_finetune_irtr_f30k_square_randaug_large_image384"
TINY = "task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl"
TASKS = [n for n in named_config_names() if n.startswith("task_")]
# the wrappers a block can launch, by module
WRAPPERS = {TF: ("ln_linear", "proj_mlp_tail", "linear_residual", "mlp_tail",
                 "ln_qkv_attention", "block_eval", "tail_train"),
            TA: ("packed_attention", "packed_attention_bwd",
                 "split_attention", "split_attention_bb",
                 "packed_attention_i8qk"),
            TM: ("mlp_kernel",),
            TI: ("ln_linear_i8", "proj_mlp_tail_i8")}
ALIAS = {"mlp_kernel": "mlp"}
# the routing thresholds, as the port sets them
KERNEL_MIN_N, SPLIT_MIN_N = mome.KERNEL_MIN_N, TA.SPLIT_MIN_N
# the eval block's routes (``fused_eval_block``) and the int8 eval block
ROUTES = {"pair": ("ln_linear", "packed_attention", "linear_residual",
                   "mlp_tail"),
          "tail": ("ln_linear", "packed_attention", "proj_mlp_tail"),
          "qkv": ("ln_qkv_attention", "proj_mlp_tail"),
          "mega": ("block_eval",)}
INT8_ROUTE = ("ln_linear_i8", "packed_attention", "proj_mlp_tail_i8")
N, B = 12, 4   # the small block each routing test runs


def _spec(name):
    return make_model_spec(build_config(name, "ufo"))


@functools.lru_cache(maxsize=None)
def _one_layer(name, C=None):
    """A one-layer spec of the named config at full width, or at width C
    (heads of 64) (a small vocabulary: the block does not read it), its
    params, and the int8 eval's spec and params (the int8 companions of
    ``eval_int8``)."""
    width = {} if C is None else dict(hidden_size=C, num_heads=C // 64)
    cfg = build_config(name, "ufo", overrides=dict(num_layers=1,
                                                   vocab_size=64, **width))
    spec = make_model_spec(cfg)
    params = init_params(spec, torch.Generator().manual_seed(0))
    return spec, params, dataclasses.replace(spec, eval_int8=True), \
        TI.quantize_eval_params(params)


def _inputs(spec, seed=0):
    """B sequences of N tokens with a bias and a key mask (sample 0
    ragged)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, N, spec.hidden_size, generator=g)
    bias = 0.1 * torch.randn(spec.num_heads, N, N, generator=g)
    mask = torch.ones(B, N, dtype=torch.int32)
    mask[0, N // 2:] = 0
    return x, bias, mask


def _as_if(monkeypatch, real_n):
    """Route the small block as a block of ``real_n`` tokens is routed:
    the packed attention kernels at KERNEL_MIN_N tokens or more, the split
    ones at SPLIT_MIN_N or more, and K13 at every row count of a real
    batch (32 or more sequences of 40 tokens or more)."""
    monkeypatch.setattr(mome, "KERNEL_MIN_N",
                        N if real_n >= KERNEL_MIN_N else N + 1)
    monkeypatch.setattr(TA, "SPLIT_MIN_N",
                        N if real_n >= SPLIT_MIN_N else N + 1)
    monkeypatch.setattr(mome, "MLP_MIN_ROWS", B * N)


def _launch(recorder, name, *, train=False, fusion="tail", level="0",
            int8=False, C=None):
    """The kernels one block of the named config (at width C, if given)
    launches, forward and, in training, backward; or the ValueError it
    raised."""
    spec, params, spec8, params8 = _one_layer(name, C)
    if int8:
        spec, params = spec8, params8
    x, bias, mask = _inputs(spec)
    recorder.clear()
    x.requires_grad_(train)
    try:
        out = mome.block_forward(params, spec, spec.blocks[0], x, mask, bias,
                                 V, train=train, fusion=fusion,
                                 train_fusion=level)
    except ValueError as e:
        return e
    if train:
        out.float().sum().backward()
        assert bool(torch.isfinite(x.grad).all())
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    return sorted(recorder)


def _expected(spec, real_n, *, train=False, fusion="tail", level="0",
              int8=False):
    """The kernels the port's routing should launch for a block of
    ``real_n`` tokens of this spec, from its documented rules; or the
    name of the unbuilt kernel an opt-in route raises for."""
    C, H = spec.hidden_size, int(spec.hidden_size * spec.mlp_ratio)

    def takes(k):
        return TF.kernel_takes(k, C, H)

    packed = real_n >= KERNEL_MIN_N
    attn = ("packed_attention",) + (("packed_attention_bwd",) if train
                                    else ()) if packed else \
        ("split_attention_bb",) if real_n >= SPLIT_MIN_N else ()
    if train and level != "0":
        return sorted((("ln_linear",) if level == "full" and
                       takes("ln_linear") else ()) + attn +
                      (("tail_train",) if takes("tail_train") else ()))
    if not train and packed:
        route = INT8_ROUTE if int8 else ROUTES[fusion]
        missing = [k for k in route if k in TF.KERNEL_WIDTHS
                   and not takes(k)]
        if not missing:
            return sorted(route)
        if fusion != "tail" or int8:
            return missing[0]
    return sorted(attn + (("mlp",) if takes("mlp") else ()))


@pytest.fixture()
def recorder(monkeypatch):
    """Every kernel wrapper records its name, then runs (its twin, on CPU
    tensors); a wrapper that hands its work to other wrappers (K3's under
    ``fusion="pair"``: K4 then K5) launches nothing itself and is dropped
    from the record."""
    calls = []
    for mod, names in WRAPPERS.items():
        for n in names:
            real = getattr(mod, n)

            def rec(*a, _r=real, _n=ALIAS.get(n, n), **kw):
                i = len(calls)
                calls.append(_n)
                out = _r(*a, **kw)
                if len(calls) > i + 1:
                    del calls[i]
                return out

            for user in (TF, TA, TM, TI, mome):  # wherever it is imported
                if getattr(user, n, None) is real:
                    monkeypatch.setattr(user, n, rec)
    return calls


@pytest.mark.parametrize("name", sorted(TF.KERNEL_WIDTHS))
@pytest.mark.parametrize("C,H", [(192, 768), (768, 3072), (1024, 4096),
                                 (1024, 4000), (640, 2560)])
def test_kernel_takes_is_the_jax_gate_within_built_widths(name, C, H):
    want = C % 128 == 0 and C in TF.KERNEL_WIDTHS[name] and (
        H % 128 == 0 or name not in TF._MLP_KERNELS)
    assert TF.kernel_takes(name, C, H) == want
    if not want:
        with pytest.raises(ValueError, match=f"{name} is not built for C={C}"):
            TF.require_kernel(name, C, H)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", TASKS)
def test_every_named_config_routes_only_to_kernels_built_for_its_width(
        monkeypatch, recorder, name, train):
    """Every named task config x eval/train x fusion x train_fusion (x the
    int8 eval), for its image block and its text block: one full-width
    ``block_forward`` launches exactly the kernels its width takes, every
    width-specific one built for the config's width and hidden; a route
    that cannot honour the width raises before any launch, naming the
    kernel and the width."""
    spec = _spec(name)
    C, H = spec.hidden_size, int(spec.hidden_size * spec.mlp_ratio)
    cases = [dict(train=True, level=lv) for lv in TF.TRAIN_FUSIONS] if train \
        else [dict(fusion=f) for f in TF.FUSIONS] + [dict(int8=True)]
    for real_n in (spec.image_len, spec.max_text_len):
        _as_if(monkeypatch, real_n)
        for case in cases:
            got = _launch(recorder, name, **case)
            want = _expected(spec, real_n, **case)
            if isinstance(got, ValueError):
                assert isinstance(want, str), (real_n, case, got)
                assert f"kernel {want} is not built for C={C}" in str(got)
                assert recorder == [], (case, recorder)
                continue
            assert got == want, (real_n, case)
            for k in got:
                assert k not in TF.KERNEL_WIDTHS or \
                    TF.kernel_takes(k, C, H), (k, C, got)


@pytest.mark.parametrize("train_fusion", TF.TRAIN_FUSIONS)
def test_width_192_takes_the_plain_ops_for_k1_k3_k13_k6(
        monkeypatch, recorder, train_fusion):
    spec = _spec(TINY)
    assert spec.hidden_size == 192
    for real_n in (spec.image_len, spec.max_text_len):
        _as_if(monkeypatch, real_n)
        for train in (False, True):
            got = _launch(recorder, TINY, train=train, level=train_fusion)
            assert not set(got) & {"ln_linear", "proj_mlp_tail", "mlp",
                                   "tail_train"}, got
    # its attention keeps the port's attention gate: the split kernels
    _as_if(monkeypatch, spec.image_len)
    assert _launch(recorder, TINY) == ["split_attention_bb"]
    # and a 577-token block of its width the packed ones, the rest plain
    _as_if(monkeypatch, 577)
    assert _launch(recorder, TINY) == ["packed_attention"]


def test_width_1024_takes_k1_k2_k3_k13_in_the_eval_and_k2_k9_k13_k6_in_training(
        monkeypatch, recorder):
    spec = _spec(LARGE)
    assert (spec.hidden_size, spec.num_heads, spec.image_len) == \
        (1024, 16, 577)
    _as_if(monkeypatch, spec.image_len)
    assert _launch(recorder, LARGE) == \
        sorted(["ln_linear", "packed_attention", "proj_mlp_tail"])
    assert _launch(recorder, LARGE, train=True) == \
        sorted(["packed_attention", "packed_attention_bwd", "mlp"])
    assert _launch(recorder, LARGE, train=True, level="tail") == \
        sorted(["packed_attention", "packed_attention_bwd", "tail_train"])
    assert _launch(recorder, LARGE, train=True, level="full") == \
        sorted(["ln_linear", "packed_attention", "packed_attention_bwd",
                "tail_train"])
    assert _launch(recorder, LARGE, fusion="pair") == \
        sorted(["ln_linear", "packed_attention", "linear_residual",
                "mlp_tail"])
    _as_if(monkeypatch, spec.max_text_len)
    assert _launch(recorder, LARGE) == ["mlp"]


@pytest.mark.parametrize("fusion,int8,kernels", [
    ("mega", False, ["block_eval"]),
    ("tail", True, ["ln_linear_i8", "packed_attention", "proj_mlp_tail_i8"])])
def test_width_1024_opt_in_routes_take_their_kernels(
        monkeypatch, recorder, fusion, int8, kernels):
    """K7, K14 and K15 are built for the ViT-L width: its image block by
    "mega" launches K7 alone, in the int8 eval K14, K2 and K15, and both
    routes are built there."""
    spec = _spec(LARGE)
    _as_if(monkeypatch, spec.image_len)
    assert _launch(recorder, LARGE, fusion=fusion, int8=int8) == \
        sorted(kernels)
    assert mome.eval_route_built(1024, 4096, fusion, int8)


@pytest.mark.parametrize("fusion,int8,kernel", [
    ("mega", False, "block_eval"), ("tail", True, "ln_linear_i8")])
def test_unbuilt_opt_in_routes_raise_naming_kernel_and_width(
        monkeypatch, recorder, fusion, int8, kernel):
    """At C=640 (the JAX gates take it; no kernel is built for it) the
    opt-in routes raise before any launch, naming the kernel and the
    width."""
    _as_if(monkeypatch, 577)
    got = _launch(recorder, LARGE, fusion=fusion, int8=int8, C=640)
    assert isinstance(got, ValueError)
    assert f"kernel {kernel} is not built for C=640" in str(got)
    assert recorder == []
    with pytest.raises(ValueError, match=f"kernel {kernel} is not built"):
        mome.eval_route_built(640, 2560, fusion, int8)


def test_width_1024_qkv_route_takes_k8_and_k3(monkeypatch, recorder):
    """K8 is built for the ViT-L width: its image block by "qkv" launches
    K8 and K3 and nothing else, and the route is built there."""
    spec = _spec(LARGE)
    _as_if(monkeypatch, spec.image_len)
    assert _launch(recorder, LARGE, fusion="qkv") == \
        sorted(["ln_qkv_attention", "proj_mlp_tail"])
    assert mome.eval_route_built(1024, 4096, "qkv")


def test_unbuilt_opt_in_route_raises_before_any_launch(monkeypatch,
                                                       recorder):
    _as_if(monkeypatch, 577)
    spec, params = _one_layer(LARGE, 640)[:2]
    x, bias, mask = _inputs(spec)
    with pytest.raises(ValueError, match="block_eval is not built for "
                                         "C=640"):
        mome.block_forward(params, spec, spec.blocks[0], x, mask, bias, V,
                           fusion="mega")
    assert recorder == []


@pytest.mark.parametrize("name", [LARGE, TINY])
@pytest.mark.parametrize("mode", ["eval", "train0", "train_full"])
def test_block_forward_launches_the_kernels_of_its_width(
        monkeypatch, recorder, name, mode):
    """At C=1024 and at C=192, a 577-token block (forward, and backward in
    training) launches the kernels its width takes and no other, and its
    output is finite and of the input's shape."""
    spec = _one_layer(name)[0]
    _as_if(monkeypatch, 577)
    case = dict(train=mode != "eval",
                level="full" if mode == "train_full" else "0")
    assert _launch(recorder, name, **case) == _expected(spec, 577, **case)


@pytest.mark.parametrize("B", [2, 3])
def test_k9_statistics_twin_matches_jax_backward_kernel(monkeypatch, B):
    """K9's twin, fed the softmax statistics of the port's own
    forward (``packed_attention(..., with_stats=True)``), against the JAX
    package's backward kernel in interpret mode, f32, tiny spec: sample 0
    has every key masked (a row with no valid key: p = 0, zero gradients,
    a finite dbias), the last sample a ragged mask."""
    import jax.numpy as jnp
    from vl_merging_tpu.ops import attention as A

    monkeypatch.setattr(A, "_INTERPRET", True)
    H, N, C, scale = 2, 40, 128, 64 ** -0.5
    rng = np.random.RandomState(B)
    qkv = rng.randn(B, N, 3 * C).astype(np.float32)
    bias = (0.5 * rng.randn(H, N, N)).astype(np.float32)
    g = rng.randn(B, N, C).astype(np.float32)
    mask = np.ones((B, N), np.int32)
    mask[0] = 0
    mask[-1, 25:] = 0
    jd, jb = A._pallas_packed_attention_bwd(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask),
        jnp.asarray(g), scale, H)
    tq, tb, tm, tg = (torch.from_numpy(a) for a in (qkv, bias, mask, g))
    _, stats = TA.packed_attention(tq, tb, tm, scale, H, with_stats=True)
    assert stats.shape == (2, B, H, N) and stats.dtype == torch.float32
    assert bool((stats[1, 0] == 0).all()) and bool((stats[1, 1:] > 0).all())
    dqkv, dbias = TA.packed_attention_bwd(tq, tb, tm, tg, stats, scale, H)
    assert bool(torch.isfinite(dbias).all())
    assert not dqkv[0].any()
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(jd), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(jb), atol=2e-5,
                               rtol=1e-4)


def test_attention_kernels_take_an_aligned_copy_of_a_misaligned_bias_slice():
    """A layer's slice of the (L, H, N, N) rel-pos bias is 16-byte aligned
    only when H·N·N is a multiple of 4: at the vit-tiny widths (H = 3,
    N = 197) the odd layers' slices are not, and the attention wrappers
    hand their kernels an aligned copy with the same values."""
    table = torch.randn(2, 3, 197, 197)
    odd = table[1]
    assert odd.data_ptr() % 16 != 0
    got = TA._f32_aligned(odd)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)
    assert TA._f32_aligned(table[0]).data_ptr() == table[0].data_ptr()
