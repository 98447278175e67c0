"""The port never imports JAX, nor the JAX package, nor reads its files.

The machine with the GPU has no JAX, so importing and running the port
(the retrieval eval, the image tower under each eval-block route and
through the split attention, the int8 retrieval eval, and one irtr train
step without and one with the training fusion)
must leave ``jax`` (and
``vl_merging_tpu``, whose subpackages import jax) out of
``sys.modules``, and an audit hook sees no file under ``vl_merging_tpu/``
opened (executing a file by path opens it) or imported.  The check runs in a fresh interpreter
because this test process (tests/conftest.py) imports JAX.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

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
    assert not touched, touched
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "vl_merging_tpu"))
    assert not leaked, leaked
    print("ok")
""")


def test_port_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"
