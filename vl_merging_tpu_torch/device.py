"""Device selection.

The port never falls back to the CPU when a GPU was asked for: a caller
that wants the card calls ``require_cuda()`` and gets an error when there
is none.  CPU tensors are a supported input in their own right (the CPU
tests run the kernels' plain twins on them), never a substitute.
"""

from __future__ import annotations

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
