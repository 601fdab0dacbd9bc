"""PowerSGD's factor products, written straight into zero-padded staging
tiles.

Counterpart of ``theanompi_tpu/ops/factor_pack.py``.  PowerSGD (arXiv:
1905.13727) sends per-leaf low-rank factors ``P = M' Q`` and
``Q' = M'ᵀ P̂``.  Each product is emitted as a ``[rows_pad, rank]`` tile,
``rows_pad = pad_rows(rows)`` a multiple of 8, its pad rows exactly 0, so
every leaf's tile is a slice of one staging buffer and all P factors (and
then all Q factors) are reduced with one collective: a zero pad row sums to
zero, so each slice equals the leaf's own reduction.

**Orientation.** The JAX package factors its leaf in its own layout,
``M = leaf.reshape(-1, shape[-1])``.  The port keeps the leaf in PyTorch's
layout, where ``A = leaf.reshape(shape[0], -1)`` is ``M`` transposed (with
M's rows permuted, for a conv).  So :func:`matmul_pack` takes a
``transpose`` flag and computes ``Aᵀ q`` (P) or ``A p`` (Q') from the one
contiguous ``A``: ``A.T.contiguous()`` would copy fc6's 411 MB every step.

**One pass, one launch.** :func:`matmul_pack_group` computes a whole
factor pass, every leaf's product, into the one staging buffer: the
leaves' tiles in order, each at the row offset that the ``pad_rows`` of
the leaves before it add up to.  Its plain version is the concatenation
of the leaves' plain tiles, which is what the JAX package's strategy
builds (``jnp.concatenate`` of ``matmul_pack`` tiles); its kernel writes
each tile in place, so there is nothing to concatenate.  :func:`plan`
cuts the leaves into the kernel's work items (see ``csrc/factor_pack.cu``)
once per set of shapes.

Two implementations of each, chosen by the tensors' device alone:

* ``matmul_pack_plain`` / ``matmul_pack_group_plain`` — ``torch.matmul``
  and a zero pad, the jnp oracle ``matmul_pack_jnp`` in torch ops; what a
  CPU tensor runs.
* ``matmul_pack_group_cuda`` — the hand-written Hopper kernel B9 of
  ``csrc/factor_pack.cu`` (a pass of up to 64 leaves per launch), which
  counts its launches in ``.launches``; ``matmul_pack_cuda`` is a pass of
  one leaf through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _kernel_build

_SUBLANE = 8

# the kernel's work split (csrc/factor_pack.cu): CLUSTER CTAs share one
# work item, each taking an even slice of its sums (A's rows for Aᵀ q, A's
# columns, in units of 4, for A q); a work item is COL_BAND output rows of
# Aᵀ q, or a band of A q's rows, a multiple of ROW_STEP up to MAX_ROW_BAND,
# sized to about TILE_BYTES of A per CTA
CLUSTER = 8
COL_BAND = 128
ROW_STEP = 32
MAX_ROW_BAND = 64
TILE_BYTES = 256 << 10
MAX_LEAVES = 64          # descriptors per launch (the kernel's parameters)


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


def _group_shapes(name: str, mats: Sequence[torch.Tensor],
                  qs: Sequence[torch.Tensor],
                  transposes: Sequence[bool]) -> List[int]:
    """Each leaf's rows_pad, after the checks of :func:`_shapes` and that
    the lists match and share one rank."""
    n = len(mats)
    if n == 0 or len(qs) != n or len(transposes) != n:
        raise ValueError(f"{name}: {n} matrices, {len(qs)} factors, "
                         f"{len(transposes)} orientations (one of each per "
                         f"leaf, at least one leaf)")
    if len({q.shape[-1] for q in qs}) != 1:
        raise ValueError(f"{name}: factors of ranks "
                         f"{sorted({q.shape[-1] for q in qs})}; a pass has "
                         f"one rank")
    return [_shapes(name, a, q, None, bool(t))[1]
            for a, q, t in zip(mats, qs, transposes)]


def matmul_pack_plain(a: torch.Tensor, q: torch.Tensor,
                      rows_pad: Optional[int] = None,
                      transpose: bool = False) -> torch.Tensor:
    """``(a.T if transpose else a) @ q`` zero-padded to ``[rows_pad,
    rank]`` (``matmul_pack_jnp``)."""
    rows, rows_pad = _shapes("matmul_pack_plain", a, q, rows_pad, transpose)
    p = (a.t() if transpose else a) @ q
    return F.pad(p, (0, 0, 0, rows_pad - rows))


def matmul_pack_group_plain(mats: Sequence[torch.Tensor],
                            qs: Sequence[torch.Tensor],
                            transposes: Sequence[bool]) -> torch.Tensor:
    """The leaves' :func:`matmul_pack_plain` tiles, concatenated."""
    pads = _group_shapes("matmul_pack_group_plain", mats, qs, transposes)
    return torch.cat([matmul_pack_plain(a, q, p, t)
                      for a, q, p, t in zip(mats, qs, pads, transposes)])


# -- the kernel's plan -----------------------------------------------------

def _split(n: int, k: int) -> int:
    """Start of the k-th of CLUSTER even slices of [0, n) (the kernel's
    ``split``)."""
    return n * k // CLUSTER


def _band(rows: int, cols: int, transpose: bool) -> int:
    """Output rows of one work item of the product over A [rows, cols]."""
    if transpose:
        return COL_BAND
    units = -(-cols // 4)                           # float4s in a row
    slice_bytes = 16 * max(1, -(-units // CLUSTER))  # a CTA's part of one
    fit = TILE_BYTES // slice_bytes // ROW_STEP * ROW_STEP
    return max(ROW_STEP, min(MAX_ROW_BAND, fit))


@functools.lru_cache(maxsize=64)
def plan(leaves: tuple) -> tuple:
    """The kernel's work for one pass over ``leaves``, a tuple of ``(rows,
    cols, rows_pad, transpose)`` of each leaf's A: a tuple of launches,
    each ``(first leaf, leaves, work items, ((out_off, item0, band), ...))``.
    A launch takes at most MAX_LEAVES leaves; ``out_off``, a leaf's first
    row in the staging buffer, is the sum of the ``rows_pad`` before it;
    ``item0`` counts the work items before it in its launch."""
    launches, out_off = [], 0
    for first in range(0, len(leaves), MAX_LEAVES):
        descs, items = [], 0
        for rows, cols, rows_pad, transpose in \
                leaves[first:first + MAX_LEAVES]:
            band = _band(rows, cols, transpose)
            descs.append((out_off, items, band))
            items += -(-rows_pad // band)
            out_off += rows_pad
        launches.append((first, len(descs), items, tuple(descs)))
    return tuple(launches)


def tile_table(leaves: tuple) -> list:
    """Every CTA of :func:`plan`'s launches, as the kernel reads it: ``(leaf,
    out rows, A rows, A cols)``, each a half-open ``(start, stop)`` range
    (out rows absolute in the staging buffer).  Together the CTAs cover
    each leaf's A exactly once, and each work item its output rows."""
    out = []
    for first, n, _, descs in plan(leaves):
        for li, (out_off, _, band) in enumerate(descs):
            rows, cols, rows_pad, transpose = leaves[first + li]
            for o0 in range(0, rows_pad, band):
                o1 = min(o0 + band, rows_pad)
                for k in range(CLUSTER):
                    if transpose:
                        a_rows = (_split(rows, k), _split(rows, k + 1))
                        a_cols = (min(o0, cols), min(o1, cols))
                    else:
                        units = -(-cols // 4)
                        a_rows = (min(o0, rows), min(o1, rows))
                        a_cols = (min(4 * _split(units, k), cols),
                                  min(4 * _split(units, k + 1), cols))
                    out.append((first + li, (out_off + o0, out_off + o1),
                                a_rows, a_cols))
    return out


class _Leaf(ctypes.Structure):
    """``struct Leaf`` of ``csrc/factor_pack.cu``."""
    _fields_ = [("a", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("R", ctypes.c_int), ("C", ctypes.c_int),
                ("rows_pad", ctypes.c_int), ("out_off", ctypes.c_int),
                ("item0", ctypes.c_int), ("band", ctypes.c_int),
                ("transpose", ctypes.c_int), ("vec", ctypes.c_int),
                ("qvec", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _kernel_build.load("factor_pack")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.matmul_pack_group.argtypes = [p, i, p, i, i, p]
    lib.matmul_pack_group.restype = ctypes.c_int
    return lib


def _launch(name: str, dev: torch.device, mats, qs, transposes, pads,
            out: torch.Tensor) -> int:
    """Launch B9 over the leaves, their tiles into ``out``; the number of
    launches made."""
    key = tuple((a.shape[0], a.shape[1], p, bool(t))
                for a, p, t in zip(mats, pads, transposes))
    launches = plan(key)
    rank = out.shape[1]
    for first, n, items, descs in launches:
        arr = (_Leaf * n)()
        for d, (out_off, item0, band), a, q, (rows, cols, rows_pad, t) in zip(
                arr, descs, mats[first:first + n], qs[first:first + n],
                key[first:first + n]):
            d.a, d.q = a.data_ptr(), q.data_ptr()
            d.R, d.C, d.rows_pad = rows, cols, rows_pad
            d.out_off, d.item0, d.band, d.transpose = out_off, item0, band, t
            d.vec = int(cols % 4 == 0 and a.data_ptr() % 16 == 0)
            d.qvec = int(rank in (1, 2, 4) and q.data_ptr() % 16 == 0)
        _kernel_build.launch(name, dev, _lib().matmul_pack_group, arr, n,
                             out.data_ptr(), rank, items)
    return len(launches)


def matmul_pack_group_cuda(mats: Sequence[torch.Tensor],
                           qs: Sequence[torch.Tensor],
                           transposes: Sequence[bool]) -> torch.Tensor:
    """Kernel B9 over a whole factor pass: every leaf's product of its
    contiguous CUDA ``A`` (or its transpose, read in place) and its ``q``,
    written as a zero-padded tile at its row offset of one staging buffer
    ``[Σ rows_pad, rank]``; one launch for up to 64 leaves."""
    pads = _group_shapes("matmul_pack_group_cuda", mats, qs, transposes)
    dev = _kernel_build.on_card("matmul_pack_group_cuda", *mats, *qs)
    out = torch.empty((sum(pads), qs[0].shape[1]), dtype=torch.float32,
                      device=dev)
    if out.numel():
        matmul_pack_group_cuda.launches += _launch(
            "matmul_pack_group_cuda", dev, mats, qs, transposes, pads, out)
    return out


def matmul_pack_cuda(a: torch.Tensor, q: torch.Tensor,
                     rows_pad: Optional[int] = None,
                     transpose: bool = False) -> torch.Tensor:
    """Kernel B9 for one leaf: the product of a contiguous CUDA ``a`` (or
    its transpose, read in place) and ``q`` as a ``[rows_pad, rank]`` tile
    whose pad rows are +0.  It is a pass of one leaf through
    :func:`matmul_pack_group_cuda` (whose count its launch adds to), so the
    tile is bit for bit the one that leaf gets in a group."""
    _, rows_pad = _shapes("matmul_pack_cuda", a, q, rows_pad, transpose)
    _kernel_build.on_card("matmul_pack_cuda", a, q)
    tile = matmul_pack_group_cuda([a], [q], [transpose])
    if rows_pad > tile.shape[0]:
        tile = torch.cat([tile, tile.new_zeros((rows_pad - tile.shape[0],
                                                tile.shape[1]))])
    return tile


# launch counts: the wrapper adds one where it launches the kernel
matmul_pack_group_cuda.launches = 0

KERNELS = (matmul_pack_group_cuda,)

#: the kernel wrapper's plain version (the CPU path, and what the card's
#: output is held to)
CUDA_PLAINS = {"matmul_pack_group_cuda": "matmul_pack_group_plain"}


def matmul_pack(a: torch.Tensor, q: torch.Tensor,
                rows_pad: Optional[int] = None,
                transpose: bool = False) -> torch.Tensor:
    """``(a.T if transpose else a) @ q`` emitted as a zero-padded
    ``[rows_pad, rank]`` staging tile (``rows_pad`` defaults to the
    round-up of the rows to a multiple of 8)."""
    return _kernel_build.route("matmul_pack", a, matmul_pack_plain,
                               matmul_pack_cuda)(a, q, rows_pad, transpose)


def matmul_pack_group(mats: Sequence[torch.Tensor],
                      qs: Sequence[torch.Tensor],
                      transposes: Sequence[bool]) -> torch.Tensor:
    """One factor pass: ``(a.T if t else a) @ q`` of every leaf, their
    zero-padded tiles (each ``pad_rows`` of its rows) stacked in order
    into one ``[Σ rows_pad, rank]`` staging buffer."""
    if not mats:
        raise ValueError("matmul_pack_group: no leaves")
    return _kernel_build.route("matmul_pack_group", mats[0],
                               matmul_pack_group_plain,
                               matmul_pack_group_cuda)(mats, qs, transposes)
