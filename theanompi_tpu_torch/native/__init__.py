"""The fused host augment pass (C++ through ctypes).

Counterpart of ``theanompi_tpu/native/__init__.py``, with its own copy of
``loader.cc``: the crop + mirror + mean-subtract + cast (+ bc01 → NHWC
transpose) pass over a uint8 image batch, multithreaded, on the host.

The library is built with the system ``g++`` at first use, into
``build/native/`` at the root of the checkout (as ``ops/_kernel_build.py``
builds the CUDA kernels into ``build/kernels/``), under a file name that
carries a digest of the source and the flags: an edited source is rebuilt,
an unchanged one reused, and nothing is written into the package.  A failed
build raises with the compiler's output; there is no silent fallback.  The
NumPy path runs only when ``TMPI_NO_NATIVE=1`` asks for it (the JAX
package's switch); the tests hold the two against each other bit for bit.

ctypes releases the GIL for the call, so the pooled producer of
``models/data/prefetch.py`` augments several batches at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
ABI_VERSION = 1
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

DEFAULT_THREADS = min(16, os.cpu_count() or 1)

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """The library's path: a digest of the source and the flags.  No
    ``-march=native``: a checkout copied to another machine must never
    load a library built for this one's instruction set."""
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"loader-{h.hexdigest()[:16]}.so")


def build(cxx: Optional[str] = None) -> str:
    """Compile ``loader.cc`` unless a current library exists; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on failure.
    The compiler writes a per-process temporary that is installed with an
    atomic ``os.replace``, so concurrent first uses never see half a
    file."""
    cxx = cxx or os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader of "
                           "theanompi_tpu_torch cannot be built (set CXX, or "
                           "TMPI_NO_NATIVE=1 for the NumPy path)")
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, SRC, "-o", tmp],
                           capture_output=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"{cxx} loader.cc failed ({r.returncode}):\n"
                + r.stderr.decode(errors="replace"))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def get_lib():
    """The loaded library, built first if needed; None when
    ``TMPI_NO_NATIVE`` is set.  Raises when the build or the load fails."""
    global _lib
    if os.environ.get("TMPI_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.tmpi_augment_u8.restype = None
            lib.tmpi_augment_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,          # in, out
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, h, w
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # c, crop, nchw
                ctypes.c_void_p, ctypes.c_void_p,          # oy, ox
                ctypes.c_void_p, ctypes.c_void_p,          # flip, mean
                ctypes.c_float, ctypes.c_int,              # mean_scalar, threads
            ]
            lib.tmpi_loader_abi_version.restype = ctypes.c_int
            v = lib.tmpi_loader_abi_version()
            if v != ABI_VERSION:
                raise RuntimeError(f"native loader ABI {v}, expected "
                                   f"{ABI_VERSION}")
            _lib = lib
        return _lib


def is_nchw(x: np.ndarray) -> bool:
    """Layout heuristic for 4-D image batches, shared by both augment paths
    and the batch-file readers: channels-first iff dim 1 looks like a
    channel count and the trailing dim does not."""
    return x.ndim == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3)


def augment_numpy(x, oy, ox, flip, crop, mean, mean_scalar) -> np.ndarray:
    """The NumPy path: per-image offsets and flags (length n), ``mean`` a
    float32 ``[crop, crop, c]`` window or None."""
    n = x.shape[0]
    if is_nchw(x):
        x = x.transpose(0, 2, 3, 1)
    c = x.shape[-1]
    out = np.empty((n, crop, crop, c), np.float32)
    for i in range(n):
        win = x[i, oy[i]:oy[i] + crop, ox[i]:ox[i] + crop, :]
        if flip[i]:
            win = win[:, ::-1, :]
        out[i] = win
    out -= mean if mean is not None else np.float32(mean_scalar)
    return out


def augment_batch(x: np.ndarray, oy, ox, flip, crop: int,
                  mean: Optional[np.ndarray] = None,
                  mean_scalar: float = 0.0,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """Fused crop + mirror + mean-subtract + cast: uint8 batch → float32
    NHWC ``[n, crop, crop, c]``.

    ``x``: uint8 ``[n, h, w, c]`` or ``[n, c, h, w]`` (bc01); ``oy``,
    ``ox``, ``flip``: per-image crop offsets and mirror flags (scalars
    broadcast); ``mean``: a float32 ``[crop, crop, c]`` window indexed by
    OUTPUT position (so a mirrored image subtracts it unmirrored), else
    ``mean_scalar``."""
    if x.dtype != np.uint8 or x.ndim != 4:
        raise ValueError(f"augment_batch takes a uint8 4-D batch, got "
                         f"{x.dtype} {x.shape}")
    n = x.shape[0]
    oy = np.ascontiguousarray(np.broadcast_to(np.asarray(oy, np.int32), (n,)))
    ox = np.ascontiguousarray(np.broadcast_to(np.asarray(ox, np.int32), (n,)))
    flip = np.ascontiguousarray(
        np.broadcast_to(np.asarray(flip, np.uint8), (n,)))
    nchw = is_nchw(x)
    c = x.shape[1] if nchw else x.shape[-1]
    h, w = (x.shape[2], x.shape[3]) if nchw else (x.shape[1], x.shape[2])
    if n and (oy.min() < 0 or ox.min() < 0 or oy.max() + crop > h
              or ox.max() + crop > w):
        raise ValueError(f"crop window +{crop} outside the {h}x{w} images")
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        if mean.shape != (crop, crop, c):
            raise ValueError(f"mean {mean.shape}, expected "
                             f"{(crop, crop, c)}")
    lib = get_lib()
    if lib is None:
        return augment_numpy(x, oy, ox, flip, crop, mean, mean_scalar)
    x = np.ascontiguousarray(x)
    out = np.empty((n, crop, crop, c), np.float32)
    lib.tmpi_augment_u8(
        x.ctypes.data, out.ctypes.data, n, h, w, c, crop, int(nchw),
        oy.ctypes.data, ox.ctypes.data, flip.ctypes.data,
        mean.ctypes.data if mean is not None else None,
        ctypes.c_float(mean_scalar),
        n_threads if n_threads is not None else DEFAULT_THREADS)
    return out
