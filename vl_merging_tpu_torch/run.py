"""Train/eval CLI (port of ``vl_merging_tpu/run.py``).

Usage mirrors the reference's Sacred CLI (reference: src/run.py:141-295):

    python -m vl_merging_tpu_torch.run with task_finetune_irtr_coco... ufo \
        data_root=/data/arrows per_device_batch_size=16 load_path=ckpt.ckpt

Named configs compose left-to-right; key=value overrides win last.
Dispatches fit / validate / test exactly like the reference
(validation_only / test_only flags).  Runs on the card; ``use_cpu=True``
asks for the CPU.  MIM's labels come from the port's dVAE encoder
(``dvae.make_mim_label_fn``) when ``discrete_vae_weight_path`` is set.

Several processes: launch one per device with torchrun (or OpenMPI, or
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set by
hand); ``main`` starts the process group from that environment
(``parallel.initialize``: NCCL on the card, gloo with ``use_cpu=True``)
before the Trainer, and each rank takes ``cuda:LOCAL_RANK``.  A
``num_devices`` other than the group's size is refused.  Two ranks share
one card only when the caller names it and gloo:
``main(argv, backend="gloo", device="cuda:0")``.
"""

from __future__ import annotations

import sys

from . import parallel
from .config import parse_cli
from .data.datamodule import MTDataModule, MultiMTDataModule
from .train.loop import Trainer
from .utils.logging import print_config, seed_everything


def main(argv=None, *, backend=None, device=None) -> Trainer:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    parallel.initialize(backend, use_cpu=cfg["use_cpu"])
    seed_everything(cfg["seed"])
    print_config(cfg)

    if cfg["tasks"] is not None:
        dm = MultiMTDataModule(cfg)
    else:
        dm = MTDataModule(cfg)

    mim_label_fn = None
    ln = cfg["loss_names"]
    if (ln["mim"] > 0 or ln["image_only_mim"] > 0) and \
            cfg["discrete_vae_weight_path"]:
        from .dvae import make_mim_label_fn
        mim_label_fn = make_mim_label_fn(cfg["discrete_vae_weight_path"])

    trainer = Trainer(cfg, mim_label_fn=mim_label_fn, device=device)
    try:
        if cfg["validation_only"]:
            metrics = trainer.validate(dm)
            trainer.logger.log(0, metrics)   # record standalone evals too
            print(metrics)
        elif cfg["test_only"]:
            metrics = trainer.test(dm)
            trainer.logger.log(0, metrics)
            print(metrics)
        else:
            trainer.fit(dm)
    finally:
        trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
