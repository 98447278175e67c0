"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more call links the objects into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds).  The library lands in ``vl_merging_tpu_torch/build/`` under a
name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file.  The build runs at
the first kernel launch of a process; nothing is built at import.

Every exported function launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions: name -> argument types (each returns a cudaError_t)
_SIGNATURES = {
    "vlm_ln_linear": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "vlm_packed_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "vlm_proj_mlp_tail": (_P,) * 13 + (_I, _I, _I, _F, _P),
    "vlm_mlp": (_P,) * 6 + (_I, _I, _I, _P),
    "vlm_packed_attention_bwd": (_P,) * 8 + (_I,) * 5 + (_F, _P),
    "vlm_packed_attention_bwd_groups": (_I,),
    "vlm_ln_linear_i8": (_P,) * 7 + (_I,) * 5 + (_F, _P),
    "vlm_ln_linear_i8_grid": (_I,),
    "vlm_proj_mlp_tail_i8": (_P,) * 16 + (_I, _I, _I, _I, _F, _P),
    "vlm_packed_attention_i8qk": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "vlm_linear_residual": (_P,) * 6 + (_I, _I, _I, _P),
    "vlm_mlp_tail": (_P,) * 9 + (_I, _I, _I, _F, _P),
    "vlm_ln_qkv_attention": (_P,) * 12 + (_I,) * 7 + (_F, _F, _P),
    "vlm_ln_qkv_attention_grid": (_I,),
    "vlm_block_eval": (_P,) * 20 + (_I,) * 6 + (_F, _F, _P),
    "vlm_block_eval_grid": (_I,),
    "vlm_split_attention": (_P,) * 6 + (_I,) * 15 + (_F, _P),
    "vlm_split_attention_bb": (_P,) * 6 + (_I,) * 15 + (_F, _P),
    "vlm_tail_train": (_P,) * 13 + (_I,) * 4 + (_F, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libvlm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc process per source, all at once, then one link.  nvcc's
    output (ptxas register and spill counts) goes to ``build/nvcc.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc, tmp = _nvcc(), out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{f.stem}.o") for f in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(cu, objs)]
    steps = [(f.name, p.communicate()[0], p.returncode)
             for f, p in zip(cu, procs)]
    if not any(rc for _, _, rc in steps):
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs), "-ldl"],
                              capture_output=True, text=True)
        steps.append(("link", link.stdout + link.stderr, link.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    (BUILD_DIR / "nvcc.log").write_text(
        "".join(f"== {name}\n{log}" for name, log, _ in steps))
    failed = [f"{name} ({rc}):\n{log[-4000:]}" for name, log, rc in steps if rc]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.vlm_error_string.argtypes = [ctypes.c_int]
        lib.vlm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().vlm_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: {msg} ({code})")


def expect(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous, 16-byte
    aligned tensor of ``dtype`` and ``shape`` on ``device``, which must be
    the current CUDA device (the kernels launch there)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {device} is not the current CUDA device")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
