"""Deterministic per-host sharded batch sampling.

Replaces torch DistributedSampler (the reference disables Lightning's
auto-sampler and wires its own, reference: src/vilt/datamodules/
multitask_datamodule.py:48-76, src/run.py:249): an epoch-seeded
permutation, padded to a multiple of (hosts × batch), statically sliced
per host.  Every host sees the same permutation, so the global batch is
consistent without communication.

Port of ``vl_merging_tpu/data/sampler.py``; ``set_epoch`` also takes the
batch to start from, so a resumed fit continues the epoch where the
checkpoint left it.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class ShardedBatchSampler:
    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        num_hosts: int = 1,
        host_index: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
    ):
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.num_hosts = num_hosts
        self.host_index = host_index
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.start = 0

    def set_epoch(self, epoch: int, start: int = 0) -> None:
        """Select ``epoch``'s order; iteration yields its batches from
        batch ``start`` on (a resumed fit's position, ``train/loop.py``);
        ``len`` stays the epoch's batch count."""
        self.epoch = epoch
        self.start = start

    def __len__(self) -> int:
        global_batch = self.batch_size * self.num_hosts
        if self.drop_last:
            return self.dataset_len // global_batch
        return -(-self.dataset_len // global_batch)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = (rng.permutation(self.dataset_len) if self.shuffle
                 else np.arange(self.dataset_len))
        global_batch = self.batch_size * self.num_hosts
        n_batches = len(self)
        if not self.drop_last and self.num_hosts > 1:
            # Multi-host: wrap-pad so every host sees the same batch count
            # (torch DistributedSampler semantics the reference relies on —
            # duplicated tail predictions included).  Single-host instead
            # yields the true short tail: device-divisibility is the eval
            # loop's job (pad_to_multiple + output slicing), and wrapping
            # here would duplicate examples in VQA submissions / metrics.
            pad = n_batches * global_batch - self.dataset_len
            if pad > 0:
                order = np.concatenate([order, order[:pad]])
        for b in range(self.start, n_batches):
            chunk = order[b * global_batch:(b + 1) * global_batch]
            mine = chunk[self.host_index * self.batch_size:
                         (self.host_index + 1) * self.batch_size]
            yield mine.tolist()
