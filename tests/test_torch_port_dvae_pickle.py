"""The port reads pickled ``dall_e`` modules without the ``dall_e`` package,
as the JAX package reads them with it, on the CPU.

Stand-ins for the released modules: ``nn.Module`` classes with the
released ``Encoder``'s and ``Decoder``'s structure (``dall_e/encoder.py``,
``decoder.py``, ``utils.py``: ``nn.Sequential`` groups of blocks over an
``OrderedDict``, ``Conv2d`` with ``w`` and ``b`` parameters, an identity
path where the width stays, max-pooling or upsampling between groups, a
``torch.device`` attribute), registered as ``dall_e.encoder``,
``dall_e.decoder`` and ``dall_e.utils`` in ``sys.modules`` and saved whole
by ``torch.save`` at a tiny width with seeded weights.  The JAX loaders
read the files with those classes importable; the port's loaders read them
after they are gone from ``sys.modules``.  The dicts are equal name for
name, in ``named_parameters()`` order, and bit for bit; the codebook ids
through both encoders and the pixels through both decoders are equal.
"""

import math
import sys
import types
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vl_merging_tpu.dvae import decoder as jdecoder
from vl_merging_tpu.dvae import encoder as jencoder
from vl_merging_tpu_torch import dvae
from vl_merging_tpu_torch.dvae import released
from torch_port_threads import one_torch_thread  # noqa: F401

N_HID, VOCAB, N_INIT = 8, 64, 16
BLOCKS = (1, 2)   # blocks per group


def _dall_e_modules():
    """The stand-in ``dall_e`` package: {module name: module}."""
    utils = types.ModuleType("dall_e.utils")
    enc = types.ModuleType("dall_e.encoder")
    dec = types.ModuleType("dall_e.decoder")

    class Conv2d(nn.Module):
        def __init__(self, n_in, n_out, kw):
            super().__init__()
            self.n_in, self.n_out, self.kw = n_in, n_out, kw
            self.use_float16 = True
            self.device = torch.device("cpu")
            self.requires_grad = False
            self.w = nn.Parameter(torch.empty(n_out, n_in, kw, kw),
                                  requires_grad=False)
            self.b = nn.Parameter(torch.empty(n_out), requires_grad=False)

    def res_path(convs):
        items = []
        for i, conv in enumerate(convs, 1):
            items += [(f"relu_{i}", nn.ReLU()), (f"conv_{i}", conv)]
        return nn.Sequential(OrderedDict(items))

    class EncoderBlock(nn.Module):
        def __init__(self, n_in, n_out):
            super().__init__()
            hid = n_out // 4
            self.id_path = Conv2d(n_in, n_out, 1) if n_in != n_out \
                else nn.Identity()
            self.res_path = res_path([Conv2d(n_in, hid, 3),
                                      Conv2d(hid, hid, 3),
                                      Conv2d(hid, hid, 3),
                                      Conv2d(hid, n_out, 1)])

    class DecoderBlock(nn.Module):
        def __init__(self, n_in, n_out):
            super().__init__()
            hid = n_out // 4
            self.id_path = Conv2d(n_in, n_out, 1) if n_in != n_out \
                else nn.Identity()
            self.res_path = res_path([Conv2d(n_in, hid, 1),
                                      Conv2d(hid, hid, 3),
                                      Conv2d(hid, hid, 3),
                                      Conv2d(hid, n_out, 3)])

    class Encoder(nn.Module):
        def __init__(self, n_blk):
            super().__init__()
            self.group_count, self.n_hid = 4, N_HID
            self.n_blk_per_group, self.vocab_size = n_blk, VOCAB
            self.device = torch.device("cpu")
            widths = [N_HID, N_HID, 2 * N_HID, 4 * N_HID, 8 * N_HID]
            groups = [("input", Conv2d(3, N_HID, 7))]
            for g in range(1, 5):
                blocks = [(f"block_{i + 1}", EncoderBlock(
                    widths[g - 1] if i == 0 else widths[g], widths[g]))
                    for i in range(n_blk)]
                if g < 4:
                    blocks.append(("pool", nn.MaxPool2d(kernel_size=2)))
                groups.append((f"group_{g}", nn.Sequential(
                    OrderedDict(blocks))))
            groups.append(("output", nn.Sequential(OrderedDict(
                [("relu", nn.ReLU()),
                 ("conv", Conv2d(8 * N_HID, VOCAB, 1))]))))
            self.blocks = nn.Sequential(OrderedDict(groups))

    class Decoder(nn.Module):
        def __init__(self, n_blk):
            super().__init__()
            self.group_count, self.n_init, self.n_hid = 4, N_INIT, N_HID
            self.n_blk_per_group, self.vocab_size = n_blk, VOCAB
            self.device = torch.device("cpu")
            widths = [N_INIT, 8 * N_HID, 4 * N_HID, 2 * N_HID, N_HID]
            groups = [("input", Conv2d(VOCAB, N_INIT, 1))]
            for g in range(1, 5):
                blocks = [(f"block_{i + 1}", DecoderBlock(
                    widths[g - 1] if i == 0 else widths[g], widths[g]))
                    for i in range(n_blk)]
                if g < 4:
                    blocks.append(("upsample", nn.Upsample(
                        scale_factor=2, mode="nearest")))
                groups.append((f"group_{g}", nn.Sequential(
                    OrderedDict(blocks))))
            groups.append(("output", nn.Sequential(OrderedDict(
                [("relu", nn.ReLU()), ("conv", Conv2d(N_HID, 6, 1))]))))
            self.blocks = nn.Sequential(OrderedDict(groups))

    for mod, classes in ((utils, (Conv2d,)),
                         (enc, (EncoderBlock, Encoder)),
                         (dec, (DecoderBlock, Decoder))):
        for cls in classes:
            cls.__module__ = mod.__name__
            cls.__qualname__ = cls.__name__
            setattr(mod, cls.__name__, cls)
    pkg = types.ModuleType("dall_e")
    pkg.utils, pkg.encoder, pkg.decoder = utils, enc, dec
    return {"dall_e": pkg, "dall_e.utils": utils, "dall_e.encoder": enc,
            "dall_e.decoder": dec}


def _seeded(module, seed):
    """Weights of dall_e's initialisation, drawn by numpy from the seed."""
    rng = np.random.RandomState(seed)
    for name, p in module.named_parameters():
        if name.endswith(".w"):
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            v = rng.randn(*p.shape) / math.sqrt(fan_in)
        else:
            v = 0.01 * rng.randn(*p.shape)
        p.data.copy_(torch.from_numpy(v.astype(np.float32)))
    return module


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """{(kind, n_blk): (path, JAX loader's dict)}: each module saved with
    the stand-ins importable and read there by the JAX loader; the
    stand-ins are gone from ``sys.modules`` when the tests run."""
    root = tmp_path_factory.mktemp("dall_e")
    mods = _dall_e_modules()
    sys.modules.update(mods)
    out = {}
    try:
        for n_blk in BLOCKS:
            for kind, cls, load in (
                    ("encoder", mods["dall_e.encoder"].Encoder,
                     jencoder.load_encoder_params),
                    ("decoder", mods["dall_e.decoder"].Decoder,
                     jdecoder.load_decoder_params)):
                d = root / f"{kind}{n_blk}"
                d.mkdir()
                torch.save(_seeded(cls(n_blk), n_blk), d / f"{kind}.pkl")
                out[kind, n_blk] = (d, load(str(d)))
    finally:
        for name in mods:
            del sys.modules[name]
    return out


@pytest.mark.parametrize("n_blk", BLOCKS)
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_port_loader_reads_the_jax_loaders_dict(pickles, kind, n_blk):
    d, want = pickles[kind, n_blk]
    assert not any(m.split(".")[0] == "dall_e" for m in sys.modules)
    load = {"encoder": dvae.load_encoder_params,
            "decoder": dvae.load_decoder_params}[kind]
    for path in (str(d), str(d / f"{kind}.pkl")):
        got = load(path)
        assert list(got) == list(want)
        for k, v in want.items():
            g = got[k].numpy()
            assert g.dtype == v.dtype == np.float32 and g.shape == v.shape
            assert g.tobytes() == v.tobytes(), k
    assert "blocks.group_1.block_1.res_path.conv_1.w" in want
    assert ("blocks.group_1.block_1.id_path.w" in want) == (kind == "decoder")
    assert "dall_e" not in sys.modules


@pytest.mark.parametrize("n_blk", BLOCKS)
def test_codebook_ids_and_pixels_match_jax(pickles, n_blk):
    enc_dir, enc = pickles["encoder", n_blk]
    dec_dir, dec = pickles["decoder", n_blk]
    x = (0.8 * np.random.RandomState(5).rand(3, 3, 32, 32) + 0.1).astype(
        np.float32)
    want = np.asarray(jencoder.get_codebook_indices(
        {k: jnp.asarray(v) for k, v in enc.items()}, jnp.asarray(x),
        n_blk_per_group=n_blk))
    label_fn = dvae.make_mim_label_fn(str(enc_dir))
    got = label_fn({"image_target": torch.from_numpy(x)})
    np.testing.assert_array_equal(got.numpy(), want)
    px_want = np.asarray(jdecoder.decode_indices(
        {k: jnp.asarray(v) for k, v in dec.items()}, jnp.asarray(want),
        vocab_size=VOCAB, n_blk_per_group=n_blk))
    px = dvae.decode_indices(dvae.load_decoder_params(str(dec_dir)),
                             got).numpy()
    assert px.shape == px_want.shape == (3, 3, 32, 32)
    np.testing.assert_allclose(px, px_want, atol=1e-6, rtol=1e-5)


def test_anything_else_is_refused_by_name(tmp_path):
    """A stub without a module's state, and bytes that do not unpickle:
    ``ValueError`` naming the file, no fallback."""
    bad = tmp_path / "encoder.pkl"
    with open(bad, "wb") as fh:
        fh.write(b"not a pickle")
    with pytest.raises(ValueError, match="encoder.pkl"):
        dvae.load_encoder_params(str(tmp_path))
    stub = released._stub("dall_e.encoder", "Encoder")()
    stub.__setstate__({"_parameters": OrderedDict(), "_modules": {
        "blocks": released._stub("dall_e.utils", "Conv2d")()}})
    with pytest.raises(ValueError, match="blocks"):
        released.module_params(stub, str(bad))
