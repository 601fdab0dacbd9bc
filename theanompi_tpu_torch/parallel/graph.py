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
  Nothing runs the step eagerly instead.

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
        # kernel wrapper -> launches one replay makes
        self.launches: Dict[Callable, int] = {}

    def capture(self, fn: Callable):
        """Record ``fn()`` into the graph (nothing runs) and return its
        outputs: tensors a replay rewrites in place."""
        wrappers = kernel_wrappers()
        with CAPTURE_LOCK:
            before = [k.launches for k in wrappers]
            try:
                with torch.cuda.graph(self.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = fn()
            except Exception as e:
                raise CaptureError(describe(e)) from e
            finally:
                recorded = [k.launches - n for k, n in zip(wrappers, before)]
                for k, n in zip(wrappers, before):
                    k.launches = n        # a capture launches nothing
        self.launches = {k: n for k, n in zip(wrappers, recorded) if n}
        return out

    def replay(self) -> None:
        """One replay on the current stream; each kernel's count grows by
        the launches the graph holds."""
        self.graph.replay()
        with CAPTURE_LOCK:
            for k, n in self.launches.items():
                k.launches += n
