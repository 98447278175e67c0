"""Native runtime: C++ image pipeline bound via ctypes.

Builds ``decode.cc`` on first use (g++ -O3, links libjpeg) and exposes
``decode_resize_batch`` — a multithreaded JPEG→CHW-float32 eval transform
(square resize + inception normalize).  Falls back gracefully: callers
should check ``available()`` and use the PIL path otherwise.

Port of ``vl_merging_tpu/runtime`` with its own copy of ``decode.cc``.
The library lands in the package's git-ignored ``build/`` (where
``ops/_build.py`` puts the CUDA kernels), under a name keyed by a hash of
the source, so an edited source rebuilds; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "decode.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _src_digest() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def library_path() -> str:
    """Where the library built from the current ``decode.cc`` lives."""
    return os.path.join(BUILD_DIR, f"libvlm_decode_{_src_digest()[:16]}.so")


def _build() -> Optional[ctypes.CDLL]:
    """Compile decode.cc → .so, or load the one built from this source.

    The compiler writes a temporary file in ``build/`` that is then renamed
    into place, so processes that build at once each load a whole file.
    -march=native is safe because the artifact is strictly machine-local.
    """
    global _build_failed
    so = library_path()
    if os.path.exists(so):
        try:
            return ctypes.CDLL(so)
        except OSError:
            pass  # foreign binary: rebuild below
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp, "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
        return ctypes.CDLL(so)
    except (subprocess.CalledProcessError, OSError) as e:
        _build_failed = True
        if os.path.exists(tmp):
            os.remove(tmp)
        said = getattr(e, "stderr", b"") or b""
        print(f"[vl_merging_tpu_torch.runtime] native build failed, using "
              f"PIL path: {e} {said.decode(errors='replace')[-400:]}")
        return None


def _self_test(lib: ctypes.CDLL) -> bool:
    """Round-trip a tiny JPEG through the library before trusting it."""
    try:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.new("RGB", (9, 7), (255, 0, 0)).save(buf, format="JPEG")
        data = buf.getvalue()
        out = np.empty((1, 3, 4, 4), np.float32)
        ptrs = (ctypes.c_char_p * 1)(data)
        lens = (ctypes.c_size_t * 1)(len(data))
        rc = lib.vlm_decode_resize_batch(
            ptrs, lens, 1, 4, out.ctypes.data_as(ctypes.POINTER(
                ctypes.c_float)), 1)
        return rc == 0 and np.isfinite(out).all() and out[0, 0].mean() > 0.5
    except Exception:
        return False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.vlm_decode_resize_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ]
                lib.vlm_decode_resize_batch.restype = ctypes.c_int
                lib.vlm_decode_resize_batch_u8.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ]
                lib.vlm_decode_resize_batch_u8.restype = ctypes.c_int
                if not _self_test(lib):
                    print("[vl_merging_tpu_torch.runtime] native self-test "
                          "failed, using PIL path")
                    _build_failed = True
                    lib = None
            _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


def decode_resize_batch(jpeg_buffers: List[bytes], out_size: int,
                        num_threads: int = 8) -> np.ndarray:
    """Batch JPEG bytes → (N, 3, S, S) float32, inception-normalized.

    Matches PIL ``Image.resize(bicubic)`` + ToTensor + (x-0.5)/0.5 (the
    square_transform eval path) to uint8 rounding."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native decode library unavailable")
    n = len(jpeg_buffers)
    out = np.empty((n, 3, out_size, out_size), np.float32)
    arr_ptrs = (ctypes.c_char_p * n)(*jpeg_buffers)
    arr_lens = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_buffers])
    failures = lib.vlm_decode_resize_batch(
        arr_ptrs, arr_lens, n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if failures:
        print(f"[vl_merging_tpu_torch.runtime] {failures} corrupt JPEGs zero-filled")
    return out


def decode_resize_batch_u8(jpeg_buffers: List[bytes], out_size: int,
                           num_threads: int = 8) -> np.ndarray:
    """Batch JPEG bytes → (N, S, S, 3) uint8 — the low-bandwidth feed
    path; device-side ((u8/255)−0.5)/0.5 completes the eval transform
    with 4× less host→device traffic than the f32 variant."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native decode library unavailable")
    n = len(jpeg_buffers)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    arr_ptrs = (ctypes.c_char_p * n)(*jpeg_buffers)
    arr_lens = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_buffers])
    failures = lib.vlm_decode_resize_batch_u8(
        arr_ptrs, arr_lens, n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    if failures:
        print(f"[vl_merging_tpu_torch.runtime] {failures} corrupt JPEGs zero-filled")
    return out
