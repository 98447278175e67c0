"""Device selection.

The port never falls back to the CPU when a GPU was asked for: a caller
that wants the card calls ``require_cuda()`` and gets an error when there
is none.  CPU tensors are a supported input in their own right (the CPU
tests run the kernels' plain twins on them), never a substitute.  A rank
of a process group takes its own card (``rank_device``).
"""

from __future__ import annotations

import os

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no CUDA device is present.

    Also turns TF32 off for float32 matmuls and cuDNN convolutions, so
    every float32 computation on the card (ITC scores, f32 references,
    an f32 patch convolution) runs in full float32: cuDNN convolutions
    default to TF32, which keeps about three decimal digits."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this path needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def rank_device(name=None) -> torch.device:
    """The card this process runs on, made the current CUDA device.

    ``name`` (e.g. "cuda:0") names it; several ranks share one card only
    this way.  Else it is ``cuda:LOCAL_RANK`` (torchrun's variable, or
    OpenMPI's ``OMPI_COMM_WORLD_LOCAL_RANK``; 0 when neither is set), and
    a local rank with no card of its own raises: ranks are never remapped
    onto another card, and never onto the CPU."""
    require_cuda()
    if name is not None:
        dev = torch.device(name)
        if dev.type != "cuda":
            raise ValueError(f"rank_device names a card, not {name!r}")
        index = 0 if dev.index is None else dev.index
    else:
        index = int(os.environ.get(
            "LOCAL_RANK", os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)))
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"CUDA device {index} asked for, but {count} CUDA device(s) are "
            f"visible; name a device to share one card between ranks")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)
