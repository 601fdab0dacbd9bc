"""PowerSGD's factor products, written straight into zero-padded staging
tiles.

Counterpart of ``theanompi_tpu/ops/factor_pack.py``.  PowerSGD (arXiv:
1905.13727) sends per-leaf low-rank factors ``P = M' Q`` and
``Q' = M'ᵀ P̂``.  Each product is emitted as a ``[rows_pad, rank]`` tile,
``rows_pad = pad_rows(rows)`` a multiple of 8, its pad rows exactly 0, so
the strategy concatenates every leaf's tile into one buffer and reduces
all P factors (and then all Q factors) with one collective: a zero pad row
sums to zero, so each slice equals the leaf's own reduction.

**Orientation.** The JAX package factors its leaf in its own layout,
``M = leaf.reshape(-1, shape[-1])``.  The port keeps the leaf in PyTorch's
layout, where ``A = leaf.reshape(shape[0], -1)`` is ``M`` transposed (with
M's rows permuted, for a conv).  So :func:`matmul_pack` takes a
``transpose`` flag and computes ``Aᵀ q`` (P) or ``A p`` (Q') from the one
contiguous ``A``: ``A.T.contiguous()`` would copy fc6's 411 MB every step.

Two implementations, chosen by the tensors' device alone:

* :func:`matmul_pack_plain` — ``torch.matmul`` and a zero pad, the jnp
  oracle ``matmul_pack_jnp`` in torch ops; what a CPU tensor runs.
* :func:`matmul_pack_cuda` — the hand-written Hopper kernel B9 of
  ``csrc/factor_pack.cu``; counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _kernel_build

_SUBLANE = 8


def pad_rows(rows: int) -> int:
    """Staging row count for a factor with ``rows`` true rows."""
    return -(-rows // _SUBLANE) * _SUBLANE


def _shapes(name: str, a: torch.Tensor, q: torch.Tensor,
            rows_pad: Optional[int], transpose: bool):
    """(out rows, rows_pad) of ``(Aᵀ if transpose else A) @ q``."""
    if a.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {a.dtype} and {q.dtype}")
    if a.dim() != 2 or q.dim() != 2:
        raise ValueError(f"{name}: takes 2-D operands, got "
                         f"{tuple(a.shape)} and {tuple(q.shape)}")
    inner, rows = (a.shape[0], a.shape[1]) if transpose else \
        (a.shape[1], a.shape[0])
    if q.shape[0] != inner:
        raise ValueError(f"{name}: {'Aᵀ' if transpose else 'A'} of "
                         f"{tuple(a.shape)} times q of {tuple(q.shape)}")
    rows_pad = pad_rows(rows) if rows_pad is None else int(rows_pad)
    if rows_pad < rows or rows_pad % _SUBLANE:
        raise ValueError(f"{name}: rows_pad {rows_pad} for {rows} rows (a "
                         f"multiple of {_SUBLANE}, at least the rows)")
    return rows, rows_pad


def matmul_pack_plain(a: torch.Tensor, q: torch.Tensor,
                      rows_pad: Optional[int] = None,
                      transpose: bool = False) -> torch.Tensor:
    """``(a.T if transpose else a) @ q`` zero-padded to ``[rows_pad,
    rank]`` (``matmul_pack_jnp``)."""
    rows, rows_pad = _shapes("matmul_pack_plain", a, q, rows_pad, transpose)
    p = (a.t() if transpose else a) @ q
    return F.pad(p, (0, 0, 0, rows_pad - rows))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _kernel_build.load("factor_pack")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.matmul_pack.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.matmul_pack.restype = ctypes.c_int
    return lib


def matmul_pack_cuda(a: torch.Tensor, q: torch.Tensor,
                     rows_pad: Optional[int] = None,
                     transpose: bool = False) -> torch.Tensor:
    """Kernel B9: the product of a contiguous CUDA ``a`` (or its transpose,
    read in place) and ``q``, stored as a ``[rows_pad, rank]`` tile whose
    pad rows are 0."""
    _, rows_pad = _shapes("matmul_pack_cuda", a, q, rows_pad, transpose)
    dev = _kernel_build.on_card("matmul_pack_cuda", a, q)
    rank = q.shape[1]
    out = torch.empty((rows_pad, rank), dtype=torch.float32, device=dev)
    _kernel_build.launch("matmul_pack_cuda", dev, _lib().matmul_pack,
                         a.data_ptr(), q.data_ptr(), out.data_ptr(),
                         a.shape[0], a.shape[1], rank, rows_pad,
                         int(transpose))
    matmul_pack_cuda.launches += 1
    return out


# launch count: the wrapper adds one where it launches its kernel
matmul_pack_cuda.launches = 0

KERNELS = (matmul_pack_cuda,)


def matmul_pack(a: torch.Tensor, q: torch.Tensor,
                rows_pad: Optional[int] = None,
                transpose: bool = False) -> torch.Tensor:
    """``(a.T if transpose else a) @ q`` emitted as a zero-padded
    ``[rows_pad, rank]`` staging tile (``rows_pad`` defaults to the
    round-up of the rows to a multiple of 8)."""
    return _kernel_build.route("matmul_pack", a, matmul_pack_plain,
                               matmul_pack_cuda)(a, q, rows_pad, transpose)
