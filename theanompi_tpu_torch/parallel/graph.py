"""CUDA graph capture of the train step.

On the card the JAX package's ``jit`` of the whole step has this
counterpart: the step's work is recorded once into a CUDA graph and each
later step is one replay of it, so the host enqueues one launch where the
eager step enqueued thousands.  :class:`StepGraph` holds one captured
callable and what a replay needs besides the graph itself:

* the dropout generators, registered with the graph: a replay reads each
  one's seed as the host set it just before (``manual_seed``), so the
  captured masks are the eager step's bit for bit;
* the launch counts of the hand-written kernels: a wrapper counts one
  launch where it is called, which under capture is once per capture, so
  the capture's counts are taken back and each replay adds them again
  (the launches the graph recorded × replays);
* the refusal: an operation the graph cannot hold (a read back to the
  host, a synchronize, an op that refuses capture) raises
  :class:`CaptureError` naming the operation's line in the step's code.
  Nothing runs the step eagerly instead.  A refused capture gives back
  what it took: the caching allocator stops routing the thread's
  allocations into the graph's private memory pool, and releases the
  pool (a refusal inside the capture, such as a read back, stops it
  before the allocator is told, and every later allocation of the
  process would land in a pool nothing frees), and the thread's current
  stream is the one it had before.

Capture uses CUDA's thread-local mode: the ``para_load`` producer keeps
staging batches on its own thread and stream while the step is captured,
and only the capturing thread is held to what capture allows.

Async islands that are threads of one process (``async_easgd.py``) each
capture a step of their own.  :data:`CAPTURE_LOCK` makes those captures
(with the eager first call before each) one at a time, and holds a
replay's count update: the launch counts are the process's, and a capture
takes back what its own recording added, which another thread's launches
in the same window would spoil.  Replays themselves run concurrently.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Callable, Dict, Sequence

import torch

_TORCH_DIR = os.path.dirname(torch.__file__)
_THIS = os.path.abspath(__file__)


#: One capture at a time in a process, and the launch counts updated
#: under it (see the module docstring).
CAPTURE_LOCK = threading.RLock()


class CaptureError(RuntimeError):
    """The train step cannot be captured into a CUDA graph."""


def kernel_wrappers() -> tuple:
    """Every hand-written kernel's wrapper (each counts its launches in
    ``.launches``)."""
    from ..ops import compress, factor_pack, flash_attention, lrn
    return (lrn.KERNELS + compress.KERNELS + factor_pack.KERNELS
            + flash_attention.KERNELS)


def _origin(exc: BaseException) -> BaseException:
    """The first error of a chain: a failed operation invalidates the
    capture, and ending the capture then raises again."""
    while exc.__context__ is not None:
        exc = exc.__context__
    return exc


def describe(exc: BaseException) -> str:
    """Where a capture failed: the innermost line of the step's code (not
    PyTorch's, not this module's) and the error raised there."""
    first = _origin(exc)
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if not f.filename.startswith(_TORCH_DIR)
              and os.path.abspath(f.filename) != _THIS]
    where = (f"{frames[-1].filename}:{frames[-1].lineno} "
             f"`{frames[-1].line}`") if frames else "an unknown operation"
    msg = str(first).strip().splitlines()[0] if str(first).strip() else ""
    return (f"the train step cannot be captured in a CUDA graph: {where} "
            f"raised {type(first).__name__}: {msg}")


class StepGraph:
    """One captured callable on ``stream`` (the stream its warm-up ran on),
    with the dropout ``generators`` it draws from."""

    def __init__(self, stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        self.stream = stream
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        # the graph's private memory pool, named up front so that a
        # refused capture can give it back (``_abandon``)
        self.pool = torch.cuda.graph_pool_handle()
        # kernel wrapper -> launches one replay makes
        self.launches: Dict[Callable, int] = {}
        # the host seconds the capture took (a graph cannot be saved: a
        # new process captures again, compile_cache's "not storable")
        self.capture_secs: float = 0.0

    def capture(self, fn: Callable):
        """Record ``fn()`` into the graph (nothing runs) and return its
        outputs: tensors a replay rewrites in place."""
        wrappers = kernel_wrappers()
        with CAPTURE_LOCK:
            before = [k.launches for k in wrappers]
            t0 = time.perf_counter()
            prev = torch.cuda.current_stream(self.stream.device)
            try:
                with torch.cuda.graph(self.graph, pool=self.pool,
                                      stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = fn()
            except Exception as e:
                self._abandon(prev)
                raise CaptureError(describe(e)) from e
            finally:
                recorded = [k.launches - n for k, n in zip(wrappers, before)]
                for k, n in zip(wrappers, before):
                    k.launches = n        # a capture launches nothing
                self.capture_secs = time.perf_counter() - t0
        self.launches = {k: n for k, n in zip(wrappers, recorded) if n}
        return out

    def _abandon(self, prev: torch.cuda.Stream) -> None:
        """After a refused capture: ``prev`` current again, and, unless the
        capture's end already did it, the allocator's routing into the
        graph's pool ended and the pool released (the graph, never
        captured, will not release it)."""
        torch.cuda.set_stream(prev)
        dev = self.stream.device.index
        try:
            torch.cuda.memory._cuda_endAllocateToPool(dev, self.pool)
        except RuntimeError:
            return            # the capture's end stopped it; the graph owns
        torch.cuda.memory._cuda_releasePool(dev, self.pool)

    def replay(self) -> None:
        """One replay on the current stream; each kernel's count grows by
        the launches the graph holds."""
        self.graph.replay()
        with CAPTURE_LOCK:
            for k, n in self.launches.items():
                k.launches += n
