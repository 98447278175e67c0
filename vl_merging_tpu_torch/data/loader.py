"""Threaded prefetching data loader.

Replaces torch DataLoader worker processes for host-side decode/augment
(the hot CPU loop in the reference's pipeline, SURVEY.md §3.1): a thread
pool maps sample fetches per batch, with a small prefetch queue so host
preprocessing overlaps device steps.  PIL/numpy release the GIL for the
heavy parts (JPEG decode, resize), so threads scale adequately; a C++
decode pipeline can swap in underneath without changing this interface.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List


class ConcatDataset:
    """Minimal torch-free ConcatDataset (for MTDataModule)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.offsets = []
        total = 0
        for d in datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, index: int):
        for ds, off in zip(reversed(self.datasets), reversed(self.offsets)):
            if index >= off:
                return ds[index - off]
        raise IndexError(index)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_sampler: Iterable[List[int]],
        collate_fn: Callable,
        num_workers: int = 8,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: List[BaseException] = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for indices in self.batch_sampler:
                        samples = list(pool.map(self.dataset.__getitem__,
                                                indices))
                        q.put(self.collate_fn(samples))
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]
