"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into a shared library, then opened with ``ctypes``.  No
PyTorch headers are included, so a build takes seconds.  A library's key
(``compile_cache.library_key``) is a digest of its source, the flags and
the toolkit's version (``nvcc --version``): an edited source, or another
toolkit, builds anew; an unchanged one is reused.

Without a compile cache the library lands under ``build/kernels/`` at the
root of the checkout, named by the key.  With one (``use_cache``: the
model's ``compile_cache``, from its config or
``$THEANOMPI_COMPILE_CACHE``) it goes through the cache's ladder: hit,
load fallback, miss (``utils/compile_cache.py``).  Every load is recorded
(:func:`loads`): its rung, its seconds, when it ended.

The build runs at first use, never at import.  A failed build raises; there
is no fallback.  :func:`build` starts one ``nvcc`` per source, all at once,
so callers that need every kernel (``chip_smoke.py``) pay for the slowest
compile only; :func:`prewarm` does the same into a cache.

:func:`on_card`, :func:`launch` and :func:`route` are what the op modules'
wrappers share: the checks a kernel's tensors must pass, a launch on the
current stream that raises on a refused launch, and the choice between a
kernel and its plain version by device alone.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import torch

from ..utils import compile_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_loads: Dict[str, dict] = {}          # name -> this process's load info
_cache = compile_cache.get(None)      # off until use_cache
_toolkits: Dict[tuple, str] = {}


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


def toolkit_version() -> str:
    """The toolkit's version as ``nvcc --version`` prints it (its
    ``release`` and ``Build`` lines), read once per compiler file."""
    nvcc = nvcc_path()
    st = os.stat(nvcc)
    tag = (nvcc, st.st_mtime_ns, st.st_size)
    v = _toolkits.get(tag)
    if v is None:
        r = subprocess.run([nvcc, "--version"], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{nvcc} --version failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
        v = " ".join(ln for ln in lines
                     if "release" in ln or ln.startswith("Build")) or \
            " ".join(lines)
        _toolkits[tag] = v
    return v


def library_key(name: str) -> str:
    """The key of ``csrc/<name>.cu``'s library: source, flags, toolkit."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    return compile_cache.library_key(src, NVCC_FLAGS, toolkit_version())


def library_key_parts(name: str) -> dict:
    """What :func:`library_key` hashes, for the cache's manifest."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    return compile_cache.key_parts(src, NVCC_FLAGS, toolkit_version())


def library_path(name: str) -> str:
    """Where the library goes without a cache (``build/kernels/``)."""
    return os.path.join(BUILD_DIR, f"{name}-{library_key(name)[:16]}.so")


def _nvcc(targets: Dict[str, str]) -> Dict[str, float]:
    """Compile each ``{name: library path}``, one ``nvcc`` each, all
    started together; each output written whole (a temporary file, then a
    rename).  Returns each build's seconds; raises with the compiler's
    output if any fails."""
    t0 = time.time()
    procs = {}
    for name, so in targets.items():
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, so)
    errors, secs = [], {}
    for name, (p, tmp, so) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        secs[name] = time.time() - t0
        if p.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, so)     # atomic: a concurrent builder sees whole files
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no current
    library under ``build/kernels/``, one ``nvcc`` process each, all
    started together.  Returns ``{name: library path}``; raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    out = {name: library_path(name) for name in names}
    _nvcc({n: so for n, so in out.items() if not os.path.exists(so)})
    return out


def use_cache(cache) -> None:
    """Load the libraries not yet loaded through ``cache`` (a
    ``compile_cache.CompileCache``; a disabled one builds into
    ``build/kernels/``).  Process-wide, as the table of loaded libraries
    is: the kernel wrappers load without a model at hand."""
    global _cache
    with _lock:        # islands' threads set it too, and load reads it
        _cache = cache


def _load(name: str, cache):
    lib, info = cache.library(
        name, library_key(name), toolkit_version(),
        build=lambda path: _nvcc({name: path})[name],
        open_lib=ctypes.CDLL, default_path=library_path(name),
        parts=library_key_parts(name))
    info["t_done"] = time.time()
    return lib, info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (through the cache set by :func:`use_cache`)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _libs[name], _loads[name] = _load(name, _cache)
        return _libs[name]


def loads() -> Dict[str, dict]:
    """This process's library loads: name → ``cache`` (the rung),
    ``compile_secs``, ``build_secs`` (nvcc's, when it ran), ``path``,
    ``t_done`` (wall clock)."""
    with _lock:
        return {n: dict(i) for n, i in _loads.items()}


def prewarm(cache, names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Every library (or the named ones) through ``cache``'s ladder, the
    builds all at once; returns each one's info.  Nothing is loaded into
    this process's table of libraries."""
    names = sources() if names is None else list(names)
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        futs = {n: pool.submit(_load, n, cache) for n in names}
        return {n: f.result()[1] for n, f in futs.items()}


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
