"""The port's data pipeline (``vl_merging_tpu_torch/data``, ``runtime``,
``utils``) against the JAX package's, on the same fixtures.

The port keeps its own copies of the JAX package's JAX-free data modules;
here each copy must give the JAX package's output bit for bit: the
tokenizer, the MLM collators, the 2-D and 3-D masking generators, every
transform (the native JPEG decode included), the caption, VQA, NLVR2 and
ImageNet arrow datasets through ``MTDataModule``'s loaders, the
retrieval datasets, the tsv and video datasets, the sampler and
``MultiMTDataModule``; and the arrow writer.  Python's ``random`` and
numpy's global RNG are reseeded before each side, and the loaders run
with ``num_workers=0`` (one thread): the loader's threads share the
global RNGs."""

import base64
import json
import os
import random
import time

import numpy as np
import pytest
import yaml
from PIL import Image

from fixtures import WORDS, _jpeg_bytes, make_fixture_root
from vl_merging_tpu import runtime as jruntime
from vl_merging_tpu.config import build_config as jbuild_config
from vl_merging_tpu.data import collators as jcollators
from vl_merging_tpu.data import datamodule as jdatamodule
from vl_merging_tpu.data import datasets as jdatasets
from vl_merging_tpu.data import masking_generator as jmasking
from vl_merging_tpu.data import sampler as jsampler
from vl_merging_tpu.data import text as jtext
from vl_merging_tpu.data import transforms as jtransforms
from vl_merging_tpu.data import tsv as jtsv
from vl_merging_tpu.utils import glossary as jglossary
from vl_merging_tpu.utils import write_arrows as jwrite
from vl_merging_tpu_torch import runtime
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.data import collators, datamodule, datasets, \
    masking_generator, sampler, text, transforms
from vl_merging_tpu_torch.utils import glossary, write_arrows
from torch_port_threads import one_torch_thread  # noqa: F401

SEED = 17


def reseed(seed: int = SEED) -> None:
    random.seed(seed)
    np.random.seed(seed)


def both(fn):
    """fn(jax_side=True) and fn(jax_side=False), each after a reseed."""
    reseed()
    j = fn(True)
    reseed()
    return j, fn(False)


def assert_same(j, t, where="out"):
    """Bit-equal, recursively: arrays by dtype, shape and bytes."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), \
            (where, sorted(set(j) ^ set(t)))
        for k in j:
            assert_same(j[k], t[k], f"{where}[{k!r}]")
    elif isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray), where
        assert (j.dtype, j.shape) == (t.dtype, t.shape), \
            (where, j.dtype, t.dtype, j.shape, t.shape)
        if j.dtype == object:
            assert_same(j.tolist(), t.tolist(), where)
        else:
            assert np.ascontiguousarray(j).tobytes() == \
                np.ascontiguousarray(t).tobytes(), where
    elif isinstance(j, (list, tuple)):
        assert type(j) is type(t) and len(j) == len(t), where
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{where}[{i}]")
    else:
        assert type(j) is type(t) and j == t, (where, j, t)


def b64_jpeg(seed: int, size: int = 48) -> str:
    return base64.b64encode(
        _jpeg_bytes(np.random.RandomState(seed), size)).decode("ascii")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_fixture_root(tmp_path_factory.mktemp("port_data"))
    # an imagenet22k-style tsv shard and a text corpus (the mixed tasks)
    rows = [[f"img{i}", '[{"class": "tabby_cat"}]', b64_jpeg(i)]
            for i in range(8)]
    jtsv.write_tsv(rows, os.path.join(root, "imagenet22k_train.tsv"))
    with open(os.path.join(root, "text.txt"), "w") as f:
        for i in range(24):
            f.write(" ".join(np.random.RandomState(i).choice(WORDS, 6))
                    + "\n")
    return root


@pytest.fixture(scope="module")
def toks(root):
    vocab = os.path.join(root, "vocab.txt")
    return jtext.build_tokenizer(vocab), text.build_tokenizer(vocab)


def cfgs(root, **over):
    """The same config for both packages, at the fixtures' tiny size."""
    o = dict(data_root=root, image_size=64, patch_size=16, max_text_len=16,
             max_text_len_of_initckpt=16, num_workers=0, seed=SEED,
             tokenizer=os.path.join(root, "vocab.txt"))
    o.update(over)
    return jbuild_config(overrides=dict(o)), build_config(overrides=dict(o))


# --------------------------------------------------------------------------
# text, collators, masking, transforms
# --------------------------------------------------------------------------

def test_tiny_vocab_and_tokenizer(tmp_path, toks):
    words = WORDS + ["playing", "sleeping"]
    pj, pt = str(tmp_path / "j" / "vocab.txt"), str(tmp_path / "t" /
                                                      "vocab.txt")
    jtext.write_tiny_vocab(pj, words)
    text.write_tiny_vocab(pt, words)
    assert open(pj).read() == open(pt).read()
    jt, tt = toks
    assert (jt.vocab, jt.mask_token_id, jt.pad_token_id, jt.vocab_size) == \
        (tt.vocab, tt.mask_token_id, tt.pad_token_id, tt.vocab_size)
    for s, n in (("a dog plays with the red ball", 16),
                 ("playing " * 12, 8), ("zebra!", 16)):
        assert_same(jt.encode(s, n), tt.encode(s, n))
    assert jt.convert_ids_to_tokens([5, 6, 7]) == \
        tt.convert_ids_to_tokens([5, 6, 7])


@pytest.mark.parametrize("mode", ["standard", "whole_word", "device"])
def test_mlm_collators(toks, mode):
    texts = [" ".join(np.random.RandomState(i).choice(WORDS + ["playing"],
                                                       9))
             for i in range(12)]

    def run(jax_side):
        mod, tok = (jcollators, toks[0]) if jax_side else (collators,
                                                            toks[1])
        coll = mod.MLMCollator(tok, mlm_prob=0.3,
                               whole_word=mode == "whole_word", seed=3,
                               device=mode == "device")
        encs = [tok.encode(t, 16) for t in texts]
        return [coll(encs, 16), coll(encs[:5], 16)]

    assert_same(*both(run))


@pytest.mark.parametrize("dims", [2, 3])
def test_masking_generators(dims):
    def run(jax_side):
        mod = jmasking if jax_side else masking_generator
        if dims == 2:
            gen = mod.MaskingGenerator(8, num_masking_patches=20,
                                       max_num_patches=None,
                                       min_num_patches=4)
        else:
            gen = mod.MaskingGenerator3D(8, 3, num_masking_patches=40,
                                         min_num_patches=4)
        return [gen() for _ in range(6)]

    assert_same(*both(run))


@pytest.mark.parametrize("key", ["square_transform",
                                 "square_transform_randaug", "pixelbert",
                                 "pixelbert_randaug", "square_transform_mim",
                                 "square_transform_randaug_mim"])
def test_transforms(key):
    img = Image.fromarray((np.random.RandomState(5).rand(70, 90, 3) * 255)
                          .astype(np.uint8))

    def run(jax_side):
        mod = jtransforms if jax_side else transforms
        if key.endswith("mim"):
            tr = mod.keys_to_transforms_for_mim([key], size=64,
                                                second_size=32)[0]
        else:
            tr = mod.keys_to_transforms([key], size=64)[0]
        return [tr(img) for _ in range(4)]

    assert_same(*both(run))


def _jax_runtime_available(tries: int = 3) -> bool:
    """The JAX package's native decode: it compiles decode.cc in place at
    first use, so a worker that loads the library while another worker's
    g++ rewrites it records a failed build for its process; such a worker
    builds again (the source and its digest unchanged)."""
    for _ in range(tries):
        if jruntime.available():
            return True
        jruntime._lib, jruntime._build_failed = None, False
        time.sleep(1.0)
    return jruntime.available()


def test_native_decode_matches_the_jax_package():
    """The port builds its own copy of decode.cc into its build/; its
    eval pixels are the JAX package's, bit for bit."""
    jpegs = [_jpeg_bytes(np.random.RandomState(s), 40 + 8 * s)
             for s in range(3)]
    assert runtime.available() and _jax_runtime_available()
    assert runtime.library_path().startswith(runtime.BUILD_DIR)
    for size in (32, 64):
        assert_same(jruntime.decode_resize_batch(jpegs, size),
                    runtime.decode_resize_batch(jpegs, size))
        assert_same(jruntime.decode_resize_batch_u8(jpegs, size),
                    runtime.decode_resize_batch_u8(jpegs, size))
    j, t = both(lambda js: [(jtransforms if js else transforms)
                            .SquareTransform(64).transform_bytes(b)
                            for b in jpegs])
    assert t[0] is not None
    assert_same(j, t)


# --------------------------------------------------------------------------
# the arrow datasets through the loaders, sampler, MultiMT
# --------------------------------------------------------------------------

ARROW_CASES = {
    "coco": dict(datasets=["coco"], loss_names={"irtr": 1}),
    "f30k_mim": dict(datasets=["f30k"],
                     train_transform_keys=["square_transform_randaug_mim"],
                     val_transform_keys=["square_transform_mim"],
                     loss_names={"mim": 1, "itm": 1, "mlm": 1, "ifm": 1},
                     whole_word_masking=True, draw_false_image=1,
                     draw_false_text=1),
    "vqa": dict(datasets=["vqa"], loss_names={"vqa": 1}),
    "nlvr2": dict(datasets=["nlvr2"], loss_names={"nlvr2": 1}),
    "imagenet1k": dict(datasets=["imagenet1k"], loss_names={"img_cls": 1},
                       image_only=True),
}


def loader_batches(mod, cfg, split, batch_size=3):
    dm = mod.MTDataModule(cfg)
    loader = getattr(dm, f"{split}_loader")(batch_size)
    return dm, [b for b in loader]


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("case", sorted(ARROW_CASES))
def test_arrow_loaders(root, case, split):
    jc, tc = cfgs(root, **ARROW_CASES[case])

    def run(jax_side):
        mod = jdatamodule if jax_side else datamodule
        try:
            dm, batches = loader_batches(mod, jc if jax_side else tc, split)
        except FileNotFoundError:
            return None
        return batches, len(dm.dms[0].dataset(split))

    j, t = both(run)
    if split == "train":
        assert j is not None and j[0]
    assert_same(j, t)


def test_vqa_answer_vocabulary(root):
    jc, tc = cfgs(root, **ARROW_CASES["vqa"])
    assert jdatamodule.MTDataModule(jc).dms[0].id2answer == \
        datamodule.MTDataModule(tc).dms[0].id2answer


@pytest.mark.parametrize("split", ["val", "test"])
def test_retrieval_datasets(root, split):
    jc, tc = cfgs(root, datasets=["coco"])

    def run(jax_side):
        dm = (jdatamodule if jax_side else datamodule).MTDataModule(
            jc if jax_side else tc).dms[0]
        make = getattr(dm, f"make_no_false_{split}_dset")
        out = []
        for image_only in (False, True):
            dset = make(image_only=image_only)
            items = [dset[i] for i in range(len(dset))]
            out.append(dset.collate(items, dm.mlm_collator))
        return out

    assert_same(*both(run))


@pytest.mark.parametrize("case", ["single", "shuffled", "tail", "hosts"])
def test_sampler(case):
    kw = dict(single=dict(dataset_len=20, batch_size=4, shuffle=False),
              shuffled=dict(dataset_len=23, batch_size=4, seed=3),
              tail=dict(dataset_len=10, batch_size=4, shuffle=False,
                        drop_last=False),
              hosts=dict(dataset_len=10, batch_size=2, num_hosts=2,
                         host_index=1, shuffle=True, drop_last=False))[case]

    def run(jax_side):
        s = (jsampler if jax_side else sampler).ShardedBatchSampler(**kw)
        out = [len(s), list(s)]
        s.set_epoch(2)
        return out + [list(s)]

    j, t = both(run)
    assert_same(j, t)
    # the port's resume position: an epoch from batch ``start`` on
    s = sampler.ShardedBatchSampler(**kw)
    s.set_epoch(2, 1)
    assert list(s) == t[2][1:] and len(s) == t[0]


def test_multi_mt_datamodule(root):
    common = dict(
        tasks=["v", "l", "vl"],
        datasets=[["imagenet"], ["wikipedia"], ["f30k"]],
        data_roots=[[root], [os.path.join(root, "text.txt")], [root]],
        loss_names={"image_only_mim": 1, "text_only_mlm": 1, "itm": 1,
                    "mlm": 1, "ifm": 1},
        train_transform_keys=["square_transform"],
        val_transform_keys=["square_transform"], image_size=32,
        max_vl_text_len=16)
    # one loader thread per task: a transform drawing from the global RNGs
    # would interleave their draws, so the tasks' transforms draw nothing
    jc, tc = cfgs(root, **common)

    def run(jax_side):
        mod = jdatamodule if jax_side else datamodule
        dm = mod.MultiMTDataModule(jc if jax_side else tc)
        loader = dm.train_loader(4)
        loader.set_epoch(1)
        return len(loader), [b for b in loader]

    j, t = both(run)
    assert j[0] > 0 and set(j[1][0]) == {"v", "l", "vl"}
    assert_same(j, t)


# --------------------------------------------------------------------------
# tsv and video datasets (the fixtures of tests/test_data.py and
# tests/test_mixed_task.py)
# --------------------------------------------------------------------------

def write_tsv_cases(root: str) -> dict:
    """Each tsv dataset's fixture under ``root``; returns its kwargs."""
    # a CCSV-style composite: visual and caption shards, a seq linelist
    seq = []
    for s in range(2):
        vis = [[f"img_{s}_{r}", b64_jpeg(10 * s + r)] for r in range(3)]
        cap = [[f"img_{s}_{r}", json.dumps(
            [{"caption": f"a dog {s} {r} {c}"} for c in range(2)])]
            for r in range(3)]
        jtsv.write_tsv(vis, os.path.join(root, f"vis_{s}.tsv"))
        jtsv.write_tsv(cap, os.path.join(root, f"cap_{s}.tsv"))
        seq += [f"{s}\t{r}\t{c}" for r in range(3) for c in range(2)]
    with open(os.path.join(root, "seq.linelist"), "w") as f:
        f.write("\n".join(seq))
    for split in ("train_cc3m-coco-sbu-vg", "val_cc3m-coco"):
        with open(os.path.join(root, f"{split}.yaml"), "w") as f:
            yaml.safe_dump({"composite": True,
                            "img": ["vis_0.tsv", "vis_1.tsv"],
                            "caption": ["cap_0.tsv", "cap_1.tsv"],
                            "caption_linelist": "seq.linelist"}, f)
    # new_imagenet: class-annotation captions
    vis = [[f"k{r}", b64_jpeg(30 + r)] for r in range(3)]
    cap = [[f"k{r}", json.dumps([{"class": c}])]
           for r, c in enumerate(["dog", "cat", "bird"])]
    jtsv.write_tsv(vis, os.path.join(root, "ni_vis.tsv"))
    jtsv.write_tsv(cap, os.path.join(root, "ni_cap.tsv"))
    with open(os.path.join(root, "train_imagenet-22k_30.yaml"), "w") as f:
        yaml.safe_dump({"img": "ni_vis.tsv", "caption": "ni_cap.tsv"}, f)
    # msrvtt frames and captions; didemo
    rows = [[f"video{i}", "{}"] + [b64_jpeg(40 + i + 7 * j)
                                   for j in range(4)] for i in range(3)]
    jtsv.write_tsv(rows, os.path.join(root, "msrvtt_train.tsv"))
    with open(os.path.join(root, "msrvtt_train.caption.json"), "w") as f:
        json.dump({f"video{i}": [f"a clip {i}", f"again {i}"]
                   for i in range(3)}, f)
    rows = [[f"{100 + i}@flickr", "{}", b64_jpeg(60 + i), b64_jpeg(70 + i)]
            for i in range(3)]
    jtsv.write_tsv(rows, os.path.join(root, "img_didemo.tsv"))
    with open(os.path.join(root, "txt_didemo-retrieval.json"), "w") as f:
        json.dump([{"video": f"{100 + i}@flickr",
                    "caption": [f"moment {i} a", f"moment {i} b"]}
                   for i in range(3)], f)
    common = dict(image_size=32, patch_size=16, max_text_len=12)
    return {
        "ccsv": dict(common, transform_keys=["square_transform_randaug"],
                     split="train"),
        "ccsv_val": dict(common, transform_keys=["square_transform"],
                         split="val", name="ccsv"),
        "new_imagenet": dict(common, transform_keys=["square_transform"],
                             split="train"),
        "imagenet": dict(common, names=["imagenet22k_train"],
                         transform_keys=["square_transform_randaug_mim"],
                         dvae_image_size=16, image_only=True,
                         split="train"),
        "msrvtt": dict(common, transform_keys=["square_transform_randaug"],
                       split="train"),
        "msrvtt_frames_mim": dict(common, transform_keys=[
            "square_transform_mim"], split="train", size_frame=2,
            num_mask_patches=4, min_mask_patches_per_block=1,
            dvae_image_size=16, name="msrvtt"),
        "didemo": dict(common, transform_keys=["square_transform"],
                       split="test"),
    }


@pytest.fixture(scope="module")
def tsv_root(root):
    tsv_dir = os.path.join(root, "tsv")
    os.makedirs(tsv_dir)
    return tsv_dir, write_tsv_cases(tsv_dir)


@pytest.mark.parametrize("case", ["ccsv", "ccsv_val", "new_imagenet",
                                  "imagenet", "msrvtt", "msrvtt_frames_mim",
                                  "didemo"])
def test_tsv_and_video_datasets(tsv_root, toks, case):
    tsv_dir, cases = tsv_root
    kw = dict(cases[case])
    name = kw.pop("name", case)
    data_dir = os.path.dirname(tsv_dir) if case == "imagenet" else tsv_dir

    def run(jax_side):
        tok = toks[0 if jax_side else 1]
        cls = (jdatasets if jax_side else datasets).dataset_class(name)
        ds = cls(data_dir=data_dir, tokenizer=tok, **kw)
        items = [ds[i] for i in range(len(ds))]
        coll = (jcollators if jax_side else collators).MLMCollator(
            tok, seed=1)
        out = [len(ds), items]
        if hasattr(ds, "collate"):
            out.append(ds.collate(items, coll))
        return out

    j, t = both(run)
    assert j[0] > 0
    assert_same(j, t)


# --------------------------------------------------------------------------
# utils: the answer glossary and the arrow writer
# --------------------------------------------------------------------------

def test_glossary_and_arrow_writer(tmp_path):
    for w in ("Dont", "two", "a dog", "yes!", "1,000", "isnt it"):
        assert glossary.normalize_word(w) == jglossary.normalize_word(w)
    assert [write_arrows.get_score(i) for i in range(5)] == \
        [jwrite.get_score(i) for i in range(5)]
    raw = tmp_path / "raw"
    for split in ("train", "val"):
        for c in ("cat", "dog"):
            os.makedirs(raw / split / c)
            for i in range(2):
                (raw / split / c / f"{i}.jpg").write_bytes(
                    _jpeg_bytes(np.random.RandomState(i), 32))
    jwrite.make_arrow_imagenet1k(str(raw), str(tmp_path / "j"))
    write_arrows.make_arrow_imagenet1k(str(raw), str(tmp_path / "t"))
    for split in ("train", "val"):
        name = f"imagenet1k_{split}.arrow"
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
