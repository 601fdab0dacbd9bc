"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into a shared library under ``build/kernels/`` at the root of
the checkout, then opened with ``ctypes``.  No PyTorch headers are included,
so a build takes seconds.  The library's file name carries a digest of its
source and flags: an edited source is rebuilt, an unchanged one is reused.

The build runs at first use, never at import.  A failed build raises; there
is no fallback.  :func:`build` starts one ``nvcc`` per source, all at once,
so callers that need every kernel (``chip_smoke.py``) pay for the slowest
compile only.

:func:`on_card`, :func:`launch` and :func:`route` are what the op modules'
wrappers share: the checks a kernel's tensors must pass, a launch on the
current stream that raises on a refused launch, and the choice between a
kernel and its plain version by device alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    # CUDA_HOME, else the toolkit's default install prefix, else PATH
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of theanompi_tpu_torch cannot be built")
    return found


def library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no current
    library, one ``nvcc`` process each, all started together.  Returns
    ``{name: library path}``; raises with the compiler's output if any
    build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        so = library_path(name)
        out[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, so)
    errors = []
    for name, (p, tmp, so) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, so)     # atomic: a concurrent builder sees whole files
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build([name])[name])
        return _libs[name]


def on_card(name: str, *ts: torch.Tensor) -> torch.device:
    """The one CUDA device of contiguous tensors ``ts``; raises otherwise
    (a kernel wrapper never runs the plain version)."""
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, the kernel takes "
                             f"CUDA tensors (the *_plain version is the CPU "
                             f"path)")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of strides {t.stride()} is not "
                             f"contiguous")
    return dev


def launch(name: str, dev: torch.device, fn, *args) -> None:
    """``fn(*args, stream)`` on ``dev``'s current stream; raises with the
    CUDA error a refused launch returns."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def route(name: str, t: torch.Tensor, plain: Callable,
          kernel: Callable) -> Callable:
    """``kernel`` for a CUDA tensor, ``plain`` for a CPU one, an error for
    any other device: the public ops choose by device alone."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no implementation for device {t.device}")
