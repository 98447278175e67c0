"""Profiling and observability (port of
``vl_merging_tpu/utils/profiling.py``).

The reference's only instrumentation is nvidia-smi at startup and a CUDA
peak-memory print (reference: src/run.py:151,
src/cache_gram_matrices.py:351-357).  Here: a ``torch.profiler`` trace
written as a Chrome trace, a step timer with rolling throughput, and the
card's memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

# the tensor collectives of ``parallel/host.py`` that ``collective_time``
# times (every collective of the port goes through one of them)
COLLECTIVES = ("all_reduce_", "broadcast_", "all_gather_rows",
               "reduce_scatter_rows")


@contextlib.contextmanager
def collective_time(device=None):
    """The time (ms) spent inside the process group's collectives
    (``COLLECTIVES``) while the block runs, each call synchronised with
    ``device`` (a CUDA device; None: none) before and after: yields
    {"ms", "calls"}, filled as the block runs."""
    from ..parallel import host

    saved = {name: getattr(host, name) for name in COLLECTIVES}
    spent = {"ms": 0.0, "calls": 0}

    def sync():
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn):
        def call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            spent["ms"] += 1e3 * (time.perf_counter() - t0)
            spent["calls"] += 1
            return out
        return call

    for name, fn in saved.items():
        setattr(host, name, timed(fn))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(host, name, fn)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, where present, CUDA activity) and
    write ``{log_dir}/trace.json``, a Chrome trace (chrome://tracing,
    Perfetto).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling steps/sec over the last ``window`` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self) -> None:
        self._times.append(time.time())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])


def storage_bytes(trees) -> int:
    """The bytes of the distinct storages behind the tensors of ``trees``
    (dicts of tensors; a view counts its whole base)."""
    held = {}
    for tree in trees:
        for v in tree.values():
            st = v.untyped_storage()
            held[st.data_ptr()] = st.nbytes()
    return sum(held.values())


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory statistics (``torch.cuda.memory_stats``: bytes in
    use, peak, and the card's total); empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def print_memory_report() -> None:
    for dev, s in device_memory_stats().items():
        peak = s["peak_bytes_in_use"] / 1024 ** 3
        limit = s["bytes_limit"] / 1024 ** 3
        print(f"{dev}: peak {peak:.2f} GiB / {limit:.2f} GiB")
