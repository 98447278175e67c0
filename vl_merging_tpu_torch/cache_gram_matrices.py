"""Gram-matrix extraction CLI (RegMean phase 1; port of
``vl_merging_tpu/cache_gram_matrices.py``).

    python -m vl_merging_tpu_torch.cache_gram_matrices with task_... all_moe \
        load_path=ckpt.ckpt representation_name=G data_root=...

One validation pass accumulating per-module input grams
(``train/gram.cache_gram_matrices``), saved as
``{log_dir}/{representation_name}.pth`` — byte-compatible with the
reference's gram caches (reference: src/cache_gram_matrices.py:141-357).
The batches are ``per_device_batch_size`` rows (32 when unset) on the
card, or on the CPU with ``use_cpu=True``, in one process.
"""

from __future__ import annotations

import os
import sys

import torch

from .ckpt.convert import params_from_numpy
from .ckpt.pipeline import load_params
from .config import parse_cli
from .data.datamodule import MTDataModule
from .device import require_cuda
from .models.spec import make_model_spec
from .train.gram import cache_gram_matrices, save_gram_matrices
from .train.loop import device_feed
from .utils.logging import print_config, seed_everything


def main(argv=None) -> str:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    seed_everything(cfg["seed"])
    print_config(cfg)

    device = torch.device("cpu") if cfg["use_cpu"] else require_cuda()
    dm = MTDataModule(cfg)
    spec = make_model_spec(cfg)
    params, missing, unexpected = load_params(cfg, spec)
    if missing:
        print(f"missing_keys: {missing}")
    params = params_from_numpy(params, device)

    per_dev = cfg["per_device_batch_size"] or 32
    loader = dm.val_loader(per_dev)
    limit = (None if cfg["limit_val_batches"] == 1.0
             else int(len(loader) * cfg["limit_val_batches"]))

    batches = (device_feed(b, device) for b in loader)
    grams = cache_gram_matrices(params, spec, cfg, batches,
                                limit_batches=limit,
                                precision=cfg["gram_precision"])

    os.makedirs(cfg["log_dir"], exist_ok=True)
    out = os.path.join(cfg["log_dir"], f"{cfg['representation_name']}.pth")
    save_gram_matrices(grams, out)
    print(f"saved {len(grams)} gram matrices to {out}")
    return out


if __name__ == "__main__":
    main()
