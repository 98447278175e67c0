"""The port never imports JAX, nor the JAX package.

The machine with the GPU has no JAX, so importing and running the port
must leave ``jax`` (and ``vl_merging_tpu``, whose subpackages import jax)
out of ``sys.modules``.  The check runs in a fresh interpreter because
this test process (tests/conftest.py) imports JAX.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch

    import vl_merging_tpu_torch.ops._build
    from vl_merging_tpu_torch import device
    from vl_merging_tpu_torch.ckpt.convert import eval_cast_params
    from vl_merging_tpu_torch.config import build_config
    from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall
    from vl_merging_tpu_torch.models import mome
    from vl_merging_tpu_torch.models.spec import init_params, make_model_spec

    cfg = build_config(
        "task_finetune_irtr_coco_square_randaug_base_image384", "ufo",
        overrides=dict(hidden_size=128, num_heads=2, num_layers=2,
                       image_size=64, patch_size=16, max_text_len=8,
                       max_text_len_of_initckpt=16,
                       vlffn_start_layer_index=1))
    spec = make_model_spec(cfg)
    g = torch.Generator().manual_seed(0)
    params = eval_cast_params(init_params(spec, g), spec, cfg)
    images = torch.randn(4, 3, 64, 64, generator=g)
    ids = torch.randint(0, spec.vocab_size, (8, 8), generator=g)
    masks = torch.ones(8, 8, dtype=torch.int32)
    mome.KERNEL_MIN_N = 0   # every block through the fused route's twins
    out = compute_irtr_recall(
        params, spec, [{"text_ids": ids, "text_masks": masks}],
        [{"image": images}], np.repeat(np.arange(4), 2), np.arange(4))
    assert set(out) == {f"{d}_r{k}" for d in ("tr", "ir") for k in (1, 5, 10)}
    assert all(0.0 <= v <= 1.0 for v in out.values())
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
