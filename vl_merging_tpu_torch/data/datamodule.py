"""Datamodules: per-dataset wiring + multitask composition.

Mirrors the reference's BaseDataModule / MTDataModule / MultiMTDataModule
(reference: src/vilt/datamodules/datamodule_base.py:25-244,
multitask_datamodule.py:12-100, multi_multitask_datamodule.py:14-63)
without Lightning: a datamodule builds datasets + tokenizer + collators;
MT concatenates datasets with a shared collate; MultiMT zips one MT per
task type into {"v","l","vl"} dict batches (min-size semantics).

Port of ``vl_merging_tpu/data/datamodule.py``: the sampler takes the
process group's size and this process's rank where the JAX package asks
``jax.process_count()`` / ``process_index()``, so rank r's loader yields
rows [r·share, (r+1)·share) of each global batch.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

from ..parallel import host
from .arrow_dataset import ArrowDataset
from .collators import MLMCollator
from .datasets import dataset_class, TextOnlyDataset
from .loader import ConcatDataset, DataLoader
from .sampler import ShardedBatchSampler
from .text import build_tokenizer


class DataModule:
    """One dataset family (reference BaseDataModule)."""

    def __init__(self, cfg: Dict, name: str, tokenizer=None,
                 data_root: Optional[str] = None,
                 mlm_prob: Optional[float] = None):
        self.cfg = cfg
        self.name = name
        self.data_root = data_root if data_root is not None else \
            cfg["data_root"]
        self.tokenizer = tokenizer or build_tokenizer(cfg["tokenizer"])
        self.mlm_collator = MLMCollator(
            self.tokenizer,
            mlm_prob=mlm_prob if mlm_prob is not None else cfg["mlm_prob"],
            whole_word=cfg["whole_word_masking"],
            seed=cfg["seed"],
            device=cfg.get("device_mlm", False))
        self.cls = dataset_class(name)

    def _common_kwargs(self, split: str) -> Dict:
        cfg = self.cfg
        keys = (cfg["train_transform_keys"] if split == "train"
                else cfg["val_transform_keys"])
        kwargs = dict(
            data_dir=self.data_root,
            transform_keys=keys,
            image_size=cfg["image_size"],
            max_text_len=cfg["max_text_len"],
            max_vl_text_len=cfg["max_vl_text_len"],
            tokenizer=self.tokenizer,
        )
        if self.cls is not TextOnlyDataset:
            kwargs.update(
                patch_size=cfg["patch_size"],
                num_mask_patches=cfg["num_mask_patches"],
                max_mask_patches_per_block=cfg["max_mask_patches_per_block"],
                min_mask_patches_per_block=cfg["min_mask_patches_per_block"],
                dvae_image_size=cfg["dvae_image_size"],
                draw_false_image=cfg["draw_false_image"],
                draw_false_text=cfg["draw_false_text"],
                image_only=cfg["image_only"],
                size_frame=cfg["num_frames"],
            )
            if cfg.get("device_augment") and split == "train" and \
                    issubclass(self.cls, ArrowDataset):
                # in-graph augmentation replaces the host train transform
                kwargs.update(device_augment=True,
                              canvas_size=cfg.get("canvas_size", 640))
        return kwargs

    def dataset(self, split: str):
        return self.cls(split=split, **self._common_kwargs(split))

    def make_no_false_dset(self, split: str, image_only: bool = False):
        """Retrieval-eval datasets without false draws
        (datamodule_base.py:140-176)."""
        kwargs = self._common_kwargs("val")
        kwargs.update(draw_false_image=0, draw_false_text=0,
                      image_only=image_only)
        return self.cls(split=split, **kwargs)

    make_no_false_val_dset = functools.partialmethod(
        make_no_false_dset, "val")
    make_no_false_test_dset = functools.partialmethod(
        make_no_false_dset, "test")

    @property
    def id2answer(self):
        """VQA answer vocabulary (reference vqav2_datamodule.py:19-36).

        Prefers the writer's ``vqav2_ans2label.json``; falls back to
        scanning the train tables' answers/answer_labels columns."""
        if getattr(self, "_id2answer", None) is not None:
            return self._id2answer
        import json
        import os

        path = os.path.join(self.data_root, "vqav2_ans2label.json")
        if os.path.exists(path):
            with open(path) as f:
                ans2label = json.load(f)
            self._id2answer = {v: k for k, v in ans2label.items()}
        else:
            mapping = {}
            for split in ("train", "val"):
                try:
                    ds = self.dataset(split)
                except FileNotFoundError:
                    continue
                answers = ds.table["answers"].to_pylist()
                labels = ds.table["answer_labels"].to_pylist()
                for row_a, row_l in zip(answers, labels):
                    for qa, ql in zip(row_a, row_l):
                        for a, l in zip(qa, ql):
                            mapping[l] = a
            self._id2answer = mapping
        return self._id2answer


class MTDataModule:
    """Concat several datamodules' datasets; shared tokenizer/collate from
    the first (reference multitask_datamodule.py:12-100)."""

    def __init__(self, cfg: Dict, names: Optional[List[str]] = None,
                 data_roots: Optional[List[str]] = None,
                 mlm_prob: Optional[float] = None):
        names = names if names is not None else cfg["datasets"]
        roots = data_roots if data_roots is not None \
            else [cfg["data_root"]] * len(names)
        tok = build_tokenizer(cfg["tokenizer"])
        self.dms = [DataModule(cfg, n, tokenizer=tok, data_root=r,
                               mlm_prob=mlm_prob)
                    for n, r in zip(names, roots)]
        self.cfg = cfg
        self.tokenizer = tok
        self.mlm_collator = self.dms[0].mlm_collator

    def _loader(self, split: str, batch_size: int, shuffle: bool):
        datasets = []
        for dm in self.dms:
            try:
                datasets.append(dm.dataset(split))
            except FileNotFoundError:
                if split == "train":
                    raise
        if not datasets:
            raise FileNotFoundError(f"no {split} data for {self.cfg['datasets']}")
        concat = ConcatDataset(datasets)
        collate = functools.partial(datasets[0].collate,
                                    mlm_collator=self.mlm_collator)
        sampler = ShardedBatchSampler(
            len(concat), batch_size,
            num_hosts=host.get_world_size(), host_index=host.get_rank(),
            shuffle=shuffle, drop_last=shuffle, seed=self.cfg["seed"])
        return DataLoader(concat, sampler, collate,
                          num_workers=self.cfg["num_workers"])

    def train_loader(self, batch_size: int):
        return self._loader("train", batch_size, shuffle=True)

    def val_loader(self, batch_size: int):
        return self._loader("val", batch_size, shuffle=False)

    def test_loader(self, batch_size: int):
        return self._loader("test", batch_size, shuffle=False)


class MultiMTDataModule:
    """One MTDataModule per task type; yields {"v": b, "l": b, "vl": b}
    with min-size semantics (reference multi_multitask_datamodule.py:14-63,
    CombinedLoader(mode="min_size"))."""

    def __init__(self, cfg: Dict):
        assert cfg["tasks"] is not None
        self.tasks = cfg["tasks"]
        self.mts = {}
        for task, names, roots in zip(self.tasks, cfg["datasets"],
                                      cfg["data_roots"]):
            mlm_prob = cfg["vl_mlm_prob"] if task == "vl" else None
            self.mts[task] = MTDataModule(cfg, names=names, data_roots=roots,
                                          mlm_prob=mlm_prob)

    def _combined(self, loaders):
        def gen():
            iters = {t: iter(l) for t, l in loaders.items()}
            while True:
                batch = {}
                try:
                    for t, it in iters.items():
                        batch[t] = next(it)
                except StopIteration:
                    return
                yield batch

        n = min(len(l) for l in loaders.values())
        return _SizedIterable(gen, n, children=tuple(loaders.values()))

    def train_loader(self, batch_size: int):
        return self._combined({t: mt.train_loader(batch_size)
                               for t, mt in self.mts.items()})

    def _eval_loader(self, batch_size: int, split: str):
        loaders = {}
        for t, mt in self.mts.items():
            try:
                loaders[t] = getattr(mt, f"{split}_loader")(batch_size)
            except FileNotFoundError:
                continue
        if not loaders:
            raise FileNotFoundError("no eval data for any task type")
        return self._combined(loaders)

    def val_loader(self, batch_size: int):
        return self._eval_loader(batch_size, "val")

    def test_loader(self, batch_size: int):
        return self._eval_loader(batch_size, "test")


class _SizedIterable:
    def __init__(self, gen_fn, n, children=()):
        self.gen_fn = gen_fn
        self.n = n
        self.children = children

    def set_epoch(self, epoch: int, start: int = 0) -> None:
        """Forward the epoch (and the batch to start from) to every child
        loader's sampler so mixed-task training reshuffles per epoch
        (Trainer.fit calls this; without the forwarding the combined loader
        would replay epoch-0 order forever)."""
        for c in self.children:
            if hasattr(c, "batch_sampler"):
                c.batch_sampler.set_epoch(epoch, start)

    def __len__(self):
        return self.n

    def __iter__(self):
        return self.gen_fn()
