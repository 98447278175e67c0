"""The port never imports JAX, nor the JAX package, nor reads its files.

The machine with the GPU has no JAX, so importing and running the port
(the retrieval eval, the image tower under each eval-block route and
through the split attention, the int8 retrieval eval, and one irtr train
step without and one with the training fusion; the merging suite:
checkpoint I/O and surgery, the gram pass in both precisions, host and
device merging, the ``merge.py`` and ``convert.py`` CLIs and the merged
checkpoint's ``load_params``; the fused VL pass: VQA answers and their
submission, the NLVR2 paired pass, split and metrics
(``evaluation/downstream.py``, ``evaluation/metrics.py``), the NLVR2 gram
pass over the vl experts and the ITM rerank; the pretrain objectives and
the dVAE: the encoder's weights written and read back as the MIM label
function, an all-in-one pretrain step on a mixed batch, the decoder, the
trainable DiscreteVAE, and steps with the adam and sgd optimizers; the
Trainer, the CLIs and the data pipeline: arrow fixtures written by the
test, one ``Trainer.fit`` step through ``run.py`` on the CPU, the gram CLI
and the native JPEG decode; distribution: a one-rank gloo group, the
data-parallel step through it under ``utils/profiling.trace``; the
device-side preprocessing: the canvas resize, a step under
``device_augment`` and ``device_mlm``; the distilled embed and trunk,
relpos's video helpers, the dVAE's codebook probabilities and decoder
loader and a pickled ``dall_e`` module read without its classes; the
Trainer's TensorBoard events; the driver entry points of
``graft_entry.py``: the flagship forward and the dry run's stages at world
1) must leave ``jax`` (and ``vl_merging_tpu``, whose subpackages import
jax), ``tensorboard`` and ``tensorflow`` out of ``sys.modules``, and an
audit hook sees no file under ``vl_merging_tpu/`` opened (executing a file
by path opens it) or imported.  The check runs in a fresh interpreter
because this test process (tests/conftest.py) imports JAX.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

from torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import os
    import sys

    JAX_PKG = os.path.join(os.getcwd(), "vl_merging_tpu")
    touched = []

    def audit(event, args):
        if event == "import" and args[0].split(".")[0] == "vl_merging_tpu":
            touched.append((event, args[0]))
        elif event == "open" and isinstance(args[0], (str, bytes,
                                                      os.PathLike)):
            path = os.path.abspath(os.fsdecode(args[0]))
            if os.path.commonpath([path, JAX_PKG]) == JAX_PKG:
                touched.append((event, path))

    sys.addaudithook(audit)

    import numpy as np
    import torch

    import vl_merging_tpu_torch.ops._build
    from vl_merging_tpu_torch import device
    from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
        master_params
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.evaluation.retrieval import \
        compute_irtr_recall, extract_features
    from vl_merging_tpu_torch.ops.fused_block import FUSIONS
    from vl_merging_tpu_torch.models import mome
    from vl_merging_tpu_torch.ops import attention, fused_block
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec
    from vl_merging_tpu_torch.train.loop import build_train_step

    cfg = build_config(
        "task_finetune_irtr_coco_square_randaug_base_image384", "ufo",
        overrides=dict(hidden_size=128, num_heads=2, num_layers=2,
                       image_size=64, patch_size=16, max_text_len=8,
                       max_text_len_of_initckpt=16,
                       vlffn_start_layer_index=1, batch_size=4))
    spec = make_model_spec(cfg)
    g = torch.Generator().manual_seed(0)
    params = eval_cast_params(init_params(spec, g), spec, cfg)
    images = torch.randn(4, 3, 64, 64, generator=g)
    ids = torch.randint(0, spec.vocab_size, (8, 8), generator=g)
    masks = torch.ones(8, 8, dtype=torch.int32)
    mome.KERNEL_MIN_N = 0   # every block through the kernels' twins
    mome.MLP_MIN_ROWS = 0
    fused_block.KERNEL_WIDTHS = {   # the twins take the tiny width too
        k: v + (128,) for k, v in fused_block.KERNEL_WIDTHS.items()}
    out = compute_irtr_recall(
        params, spec, [{"text_ids": ids, "text_masks": masks}],
        [{"image": images}], np.repeat(np.arange(4), 2), np.arange(4))
    assert set(out) == {f"{d}_r{k}" for d in ("tr", "ir") for k in (1, 5, 10)}
    assert all(0.0 <= v <= 1.0 for v in out.values())
    for fusion in FUSIONS:   # every eval-block route's twins
        feats = extract_features(params, spec, [{"image": images}], "image",
                                 fusion=fusion)
        assert feats.shape == (4, spec.hidden_size)

    cfg8 = dict(cfg, eval_int8=True)
    spec8 = make_model_spec(cfg8)
    params8 = eval_cast_params(init_params(spec8, g), spec8, cfg8)
    assert any(k.endswith("::int8") for k in params8)
    out8 = compute_irtr_recall(
        params8, spec8, [{"text_ids": ids, "text_masks": masks}],
        [{"image": images}], np.repeat(np.arange(4), 2), np.arange(4),
        qk_int8=True)
    assert set(out8) == set(out)

    cfg.update(pallas_attention=True, per_device_batch_size=4,
               warmup_steps=0)
    state, step = build_train_step(
        cfg, spec, master_params(init_params(spec, g)), 10)
    state, metrics = step(state, {"image": images, "text_ids": ids[:4],
                                  "text_masks": masks[:4]})
    assert state.step == 1 and bool(torch.isfinite(metrics["total_loss"]))

    # the split attention's twins (the @224 route) and the training fusion
    mome.KERNEL_MIN_N = 1 << 30
    attention.SPLIT_MIN_N = 0
    feats = extract_features(params, spec, [{"image": images}], "image")
    assert feats.shape == (4, spec.hidden_size)
    state, step = build_train_step(
        cfg, spec, master_params(init_params(spec, g)), 10,
        train_fusion="full")
    state, metrics = step(state, {"image": images, "text_ids": ids[:4],
                                  "text_masks": masks[:4]})
    assert state.step == 1 and bool(torch.isfinite(metrics["total_loss"]))

    # the merging suite: checkpoints in and out, the gram pass through the
    # taps, host and device merging, the CLIs and the merged checkpoint's
    # ingest
    import contextlib
    import tempfile
    from vl_merging_tpu_torch import convert, merge
    from vl_merging_tpu_torch.ckpt import bicubic, io, pipeline, surgery
    from vl_merging_tpu_torch.merging import core, device as mdevice
    from vl_merging_tpu_torch.models import taps
    from vl_merging_tpu_torch.train import gram

    shape = dict(hidden_size=128, num_heads=2, num_layers=2, image_size=64,
                 patch_size=16, max_text_len=8, max_text_len_of_initckpt=16,
                 vlffn_start_layer_index=1, loss_names={"irtr": 1})
    task = "task_finetune_irtr_coco_square_randaug_base_image384"
    moe_cfg = build_config(task, "all_moe", overrides=shape)
    moe_spec = make_model_spec(moe_cfg)
    moe = init_params(moe_spec, g)
    batch = {"image": images[:2], "text_ids": ids[:2],
             "text_masks": masks[:2]}
    grams = {p: gram.cache_gram_matrices(moe, moe_spec, moe_cfg, [batch],
                                         precision=p)
             for p in ("f64_host", "f32_device")}
    assert set(grams["f64_host"]) == set(grams["f32_device"])
    sd = io.params_to_state_dict(moe)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "moe.ckpt")
        io.save_torch_checkpoint(sd, ckpt)
        gpath = os.path.join(tmp, "G.pth")
        gram.save_gram_matrices(grams["f64_host"], gpath)
        args = ["with", task, "all_moe"] + [
            f"{k}={v!r}" for k, v in shape.items()] + [
            f"load_path={ckpt!r}", f"log_dir={tmp!r}"]
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):   # the CLIs' reports
            out = merge.main(args + ["regmean=True",
                                     f"gram_matrices={gpath!r}"])
            convert.main(args)
        ufo_cfg = build_config(task, "ufo", overrides=dict(
            shape, load_path=out, test_only=True))
        merged, missing, _ = pipeline.load_params(
            ufo_cfg, make_model_spec(ufo_cfg))
        assert missing == [], missing
    kw = dict(num_layers=2, vlffn_start_layer_index=1,
              loss_names={"irtr": 1})
    fleet = mdevice.stack_checkpoints([sd, sd], "cpu")
    mdevice.merge_weights_device(fleet, merge_ratio=[0.3, 0.7], **kw)
    mdevice.sum_task_vectors_device(fleet, mdevice.stack_checkpoints(
        [core.merge_weights(sd, **kw)] * 2, "cpu"), **kw)
    mdevice.ratio_sweep(sd, [0.0, 0.5], device="cpu", **kw)
    mdevice.regmean_device(fleet, {k: torch.from_numpy(v).float() for k, v
                                   in grams["f64_host"].items()}, **kw)
    bicubic.bicubic_resize(np.ones((2, 3, 3), np.float32), (5, 5))
    assert surgery.INDEX_BUFFER_KEYS and taps.MOE_GRAM_SUFFIXES

    # the fused VL pass and the downstream eval: VQA answers and their
    # submission, the NLVR2 paired pass, its split and metrics, the ITM
    # rerank, and the NLVR2 gram pass over the vl experts
    from vl_merging_tpu_torch.evaluation import downstream, metrics
    from vl_merging_tpu_torch.models import model as tmodel
    mome.KERNEL_MIN_N = 0
    vqa_cfg = build_config(
        "task_finetune_vqa_square_randaug_base_image384_ufo", "ufo",
        overrides=dict(shape, loss_names={"vqa": 1}))
    vqa_spec = make_model_spec(vqa_cfg)
    vqa = init_params(vqa_spec, g)
    feed = {"text_ids": ids[:4], "text_masks": masks[:4], "image": images,
            "qid": [1, 2, 3, 4]}
    rets = downstream.vqa_predictions(vqa, vqa_spec, [feed, feed], {},
                                      scan_k=2)
    assert [r["question_id"] for r in rets] == [1, 2, 3, 4] * 2
    with tempfile.TemporaryDirectory() as tmp:
        downstream.write_vqa_submission(rets, "m", tmp)
    nlvr2_cfg = build_config(
        "task_finetune_nlvr2_square_randaug_base_image384", "all_moe",
        overrides=dict(shape, loss_names={"nlvr2": 1}))
    nlvr2_spec = make_model_spec(nlvr2_cfg)
    nlvr2 = init_params(nlvr2_spec, g)
    pair = {"text_ids": ids[:4], "text_masks": masks[:4], "image_0": images,
            "image_1": images.flip(0), "answers": torch.tensor([0, 1, 1, 0])}
    acc = metrics.MetricAccumulator()
    downstream.nlvr2_split_update(
        acc, downstream.nlvr2_logits(nlvr2, nlvr2_spec, pair),
        pair["answers"], ["dev", "test", "dev", "test"])
    assert metrics.the_metric({"nlvr2": 1}, acc.compute()) >= 0.0
    vl_grams = gram.cache_gram_matrices(nlvr2, nlvr2_spec, nlvr2_cfg, [pair])
    assert any(".vl." in k for k in vl_grams)
    itm_cfg = build_config(task, "ufo", overrides=dict(
        shape, loss_names={"irtr": 1, "itm": 1}))
    itm_spec = make_model_spec(itm_cfg)
    out = compute_irtr_recall(
        init_params(itm_spec, g), itm_spec,
        [{"text_ids": ids, "text_masks": masks}], [{"image": images}],
        np.repeat(np.arange(4), 2), np.arange(4), itm_rerank_topk=2)
    assert all(0.0 <= v <= 1.0 for v in out.values())
    assert tmodel.precompute_bias(nlvr2, nlvr2_spec, "fused").ndim == 4

    # the pretrain objectives on a mixed batch, MIM labels from the dVAE
    # encoder's weights written to a file and read back; the decoder, the
    # trainable DiscreteVAE; adam and sgd
    from vl_merging_tpu_torch import dvae
    from vl_merging_tpu_torch.dvae import discrete
    enc = dvae.init_encoder_params(g, n_hid=8, n_blk_per_group=1,
                                   vocab_size=64)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(enc, os.path.join(tmp, "encoder.pkl"))
        label_fn = dvae.make_mim_label_fn(tmp)
    aio_cfg = build_config("task_all_in_one_pretraining", overrides=dict(
        {k: v for k, v in shape.items() if k != "loss_names"},
        per_device_batch_size=4, batch_size=4, warmup_steps=0))
    aio_spec = make_model_spec(aio_cfg)
    labels = torch.full((4, 8), -100)
    labels[:, 1] = ids[:4, 1]
    sub = {"text_ids": ids[:4], "text_ids_mlm": ids[:4],
           "text_labels_mlm": labels, "text_masks": masks[:4],
           "image": images, "image_target": torch.rand(4, 3, 32, 32,
                                                       generator=g),
           "image_masked_pos": torch.rand(4, 16, generator=g) < 0.4}
    state, step = build_train_step(
        aio_cfg, aio_spec, master_params(init_params(aio_spec, g)), 10,
        mim_label_fn=label_fn)
    state, metrics_ = step(state, {"v": sub, "l": sub, "vl": sub})
    assert {"image_only_mim_loss", "text_only_mlm_loss", "mim_loss",
            "itm_loss"} <= set(metrics_)
    assert bool(torch.isfinite(metrics_["total_loss"]))
    for opt in ("adam", "sgd"):
        state, step = build_train_step(
            dict(cfg, optim_type=opt), spec,
            master_params(init_params(spec, g)), 10)
        state, m = step(state, {"image": images, "text_ids": ids[:4],
                                "text_masks": masks[:4]})
        assert bool(torch.isfinite(m["total_loss"]))
    dec = {"blocks.input.w": torch.zeros(8, 64, 1, 1),
           "blocks.input.b": torch.zeros(8),
           "blocks.output.conv.w": torch.zeros(6, 8, 1, 1),
           "blocks.output.conv.b": torch.zeros(6)}
    for i in range(1, 5):
        for j, k in zip((1, 2, 3, 4), (1, 3, 3, 3)):
            name = f"blocks.group_{i}.block_1.res_path.conv_{j}"
            dec[f"{name}.w"] = torch.zeros(8, 8, k, k)
            dec[f"{name}.b"] = torch.zeros(8)
    px = dvae.decode_indices(dec, torch.zeros(1, 4, dtype=torch.long))
    assert px.shape == (1, 3, 16, 16)
    dcfg = discrete.DiscreteVAEConfig(image_size=16, num_tokens=12,
                                      codebook_dim=6, num_layers=2,
                                      hidden_dim=5)
    loss = discrete.forward(discrete.init_discrete_vae_params(dcfg),
                            torch.rand(2, 3, 16, 16, generator=g), dcfg,
                            generator=g, return_loss=True)
    assert bool(torch.isfinite(loss))

    # the Trainer, the CLIs and the data pipeline: arrow fixtures written
    # here (pyarrow, PIL, the port's tiny vocabulary), one Trainer.fit
    # step through run.py on the CPU, the gram CLI, the native decode
    import io as _io
    import pyarrow as pa
    from PIL import Image
    from vl_merging_tpu_torch import cache_gram_matrices, run, runtime
    from vl_merging_tpu_torch.data import datamodule, write_tiny_vocab
    from vl_merging_tpu_torch.utils import write_arrows

    def jpeg(seed):
        buf = _io.BytesIO()
        Image.fromarray((np.random.RandomState(seed).rand(64, 64, 3) * 255)
                        .astype(np.uint8)).save(buf, format="JPEG")
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        words = ["a", "dog", "cat", "plays", "on", "the", "mat"]
        write_tiny_vocab(os.path.join(tmp, "vocab.txt"), words)
        for split in ("train", "val", "test"):
            n = 4
            table = pa.Table.from_arrays(
                [pa.array([jpeg(i) for i in range(n)]),
                 pa.array([[" ".join(words[i:i + 3]), words[i]]
                           for i in range(n)]),
                 pa.array([f"{split}_{i}" for i in range(n)]),
                 pa.array([split] * n)],
                names=["image", "caption", "image_id", "split"])
            write_arrows._write_table(
                {k: table[k].to_pylist() for k in table.column_names},
                os.path.join(tmp, f"coco_caption_karpathy_{split}.arrow"))
        args = ["with", task, "ufo"] + [
            f"{k}={v!r}" for k, v in shape.items()] + [
            f"data_root={tmp!r}", f"log_dir={tmp!r}",
            f"tokenizer={os.path.join(tmp, 'vocab.txt')!r}", "use_cpu=True",
            "per_device_batch_size=4", "batch_size=4", "max_steps=1",
            "num_workers=0", "warmup_steps=0", "get_recall_metric=True"]
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            trainer = run.main(args)
            grams_path = cache_gram_matrices.main(
                ["with", task, "all_moe"] + args[3:] +
                ["representation_name='G'", "gram_precision='f32_device'"])
        assert trainer.state.step == 1 and trainer.device.type == "cpu"
        assert os.path.exists(os.path.join(
            trainer.log_dir, "checkpoints", "last", "state.pt"))
        import glob
        assert glob.glob(os.path.join(trainer.log_dir, "tb", "metrics",
                                      "events.out.tfevents.*"))
        assert os.path.exists(grams_path)
        assert datamodule.MTDataModule is not None
    assert runtime.available()

    # distribution: a one-rank gloo group from a file store, the
    # data-parallel step through it under the profiler's trace
    from vl_merging_tpu_torch import parallel
    from vl_merging_tpu_torch.utils import profiling
    with tempfile.TemporaryDirectory() as tmp:
        assert parallel.initialize("gloo", use_cpu=True,
                                   init_method=f"file://{tmp}/store",
                                   world_size=1, rank=0)
        assert parallel.make_mesh().size == parallel.get_world_size() == 1
        state, step = build_train_step(
            cfg, spec, master_params(init_params(spec, g)), 10)
        with profiling.trace(tmp):
            state, metrics = step(state, {"image": images,
                                          "text_ids": ids[:4],
                                          "text_masks": masks[:4]})
        assert os.path.exists(os.path.join(tmp, "trace.json"))
        assert parallel.reduce_dict({"a": 1.0}) == {"a": 1.0}
        torch.distributed.destroy_process_group()
    timer = profiling.StepTimer()
    timer.tick()
    assert timer.steps_per_sec is None and \
        profiling.device_memory_stats() == {}

    # the device-side preprocessing: the resize, the train augment and the
    # MLM masking, a step under device_augment and device_mlm; the
    # distilled embed and trunk, relpos's video helpers, the dVAE's
    # codebook probabilities and decoder loader
    from vl_merging_tpu_torch.models import distilled, relpos
    from vl_merging_tpu_torch.ops import augment, image, text_masking
    from vl_merging_tpu_torch.train import train_step
    rng = np.random.RandomState(0)
    canvas, sizes = image.pack_canvas(
        [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
         for h, w in ((70, 90), (40, 64), (96, 50), (80, 80))])
    assert image.resize_normalize_nchw(torch.from_numpy(canvas),
                                       torch.from_numpy(sizes), 64) \
        .shape == (4, 3, 64, 64)
    word_ids = torch.tensor([[-1, 0, 1, 1, 2, -1, -1, -1]] * 4)
    host = train_step.attach_augment_params(
        {"image_canvas": canvas, "image_sizes": sizes,
         "text_ids": ids[:4].numpy(), "text_masks": masks[:4].numpy(),
         "text_word_ids": word_ids.numpy()},
        dict(cfg, image_size=64), rng)
    mcfg = dict(cfg, device_augment=True, device_mlm=True,
                mask_token_id=103, whole_word_masking=True,
                loss_names=dict(cfg["loss_names"], mlm=1))
    mspec = make_model_spec(mcfg)
    state, step = build_train_step(
        mcfg, mspec, master_params(init_params(mspec, g)), 10)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
    assert bool(torch.isfinite(m["mlm_loss"])) and \
        bool(torch.isfinite(m["total_loss"]))
    assert text_masking.budget_table(8, 0.15)[4] == 1
    assert augment.OPS[0] == "Identity"
    dspec = make_model_spec(build_config(
        "task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl",
        overrides=dict(shape, vit="vit_deit_tiny_distilled_patch16_224",
                       image_size=64)))
    dparams = init_params(dspec, g)
    x, xm, _ = distilled.distilled_forward_features(
        dparams, dspec, images, distilled.distilled_draws(4, 16, g, True),
        max_image_len=8, mask_it=True)
    assert x.shape == (4, 10, 128)
    assert relpos.text_video_relative_position_index(8, 16, 4, 2).ndim == 2
    probs = discrete.get_codebook_probs(
        discrete.init_discrete_vae_params(dcfg), torch.rand(
            2, 3, 16, 16, generator=g), dcfg)
    assert probs.shape == (2, 12, 4, 4)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dec, os.path.join(tmp, "decoder.pkl"))
        assert set(dvae.load_decoder_params(tmp)) == set(dec)
        # a pickled dall_e module, read once its classes are gone
        import types

        class Conv2d(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w = torch.nn.Parameter(torch.ones(2, 3, 1, 1))
                self.b = torch.nn.Parameter(torch.zeros(2))

        fake = {n: types.ModuleType(n) for n in ("dall_e", "dall_e.utils")}
        Conv2d.__module__, fake["dall_e.utils"].Conv2d = "dall_e.utils", \
            Conv2d
        sys.modules.update(fake)
        torch.save(Conv2d(), os.path.join(tmp, "released.pkl"))
        for n in fake:
            del sys.modules[n]
        assert list(dvae.load_decoder_params(
            os.path.join(tmp, "released.pkl"))) == ["w", "b"]

    # the driver entry points: the flagship forward, and the dry run's
    # rank at world 1 in this process (its stages, a one-rank group)
    from vl_merging_tpu_torch import graft_entry

    fn, args = graft_entry.entry(graft_entry.tiny_overrides(), device="cpu")
    assert fn(*args).shape == (4, 64)
    import contextlib
    import io

    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(printed):
        graft_entry.dryrun_rank(0, 1, tmp, dict(
            device="cpu", backend="gloo", overrides=None, full_width=False,
            stage_context=None))
        ranks = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    assert ranks["mesh"] == (1, 1) and len(ranks["submission"]) == 4
    lines = printed.getvalue().splitlines()
    assert len(lines) == 4 and all(l.endswith(" ok") for l in lines), lines

    assert not touched, touched
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "vl_merging_tpu",
                                           "tensorboard", "tensorflow"))
    assert not leaked, leaked
    print("ok")
""")


def test_port_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"
