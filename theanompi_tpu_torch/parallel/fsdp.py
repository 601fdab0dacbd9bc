"""FSDP / ZeRO-3: the parameters themselves sharded over the data-parallel
ranks.

Counterpart of ``theanompi_tpu/parallel/fsdp.py``.  Each rank keeps only
its ``[chunk]`` of the flattened parameters, and the optimizer state of that
chunk; the full parameters exist in one flat buffer that every step
refills (``parallel/steps.py``, ``TrainStep._fsdp_step``):

    full    = all_gather(chunk)                  # the leaves are views of it
    grads   = backward over n_subb micro-batches # into one flat buffer
    g_chunk = reduce_scatter(grads, SUM) · 1/N   # the BSP mean of the chunk
    g_chunk = clip_chunk(g_chunk)                # global norm: one scalar sum
    chunk   = opt.update(g_chunk, chunk)         # in place

The JAX package gets the reduce-scatter as the AD transpose of its
all-gather; the port writes it out.  Only BSP grads mode with the exact
``allreduce`` strategy composes (the reduction IS the reduce-scatter).

**Layout.** The flat vector holds the leaves in the port's order and
layouts (``tree_leaves``, OIHW, ``[out, in]``), each leaf starting at an
offset that is a multiple of :data:`ALIGN` elements (256 bytes), the gaps
zero in the params and in the gradient.  A leaf is then a view at the
alignment of a tensor of its own, so cuBLAS and cuDNN pick the kernels
they pick for the unsharded leaf, and the step is bit-equal to plain BSP
on the card as on the CPU.  The flat vector is ``total`` long (the last
leaf's end), padded with zeros to ``chunk · N``; ``n_total`` counts the
parameters alone.  The JAX package's layout is dense and in its own order:
``convert.py`` maps its rows.

The JAX package's ``rechunk`` (a refit onto another worker count) belongs
to elastic resume, which the port refuses (A10).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..utils.helper_funcs import tree_leaves, tree_map
from .update_sharding import (all_gather_into, chunk_size,
                              reduce_scatter_into)

ALIGN = 64          # elements: 256 bytes of float32


class FsdpLayout:
    """The flat-chunk layout of a parameter tree on ``n_workers`` ranks and
    this rank's storage: ``shard`` (the persistent ``[chunk]`` of the
    params), ``full`` (the ``[padded]`` gathered buffer, of which ``params``
    holds the leaves as views that take gradients) and ``flat_grad`` (the
    ``[padded]`` gradient buffer, of which ``grad_views`` are the leaves).
    ``params`` is a tree of numpy arrays or tensors, in the port's layout;
    :meth:`attach` makes the storage on ``device``."""

    def __init__(self, params, n_workers: int, rank: int = 0,
                 align: int = ALIGN):
        self.n_workers, self.rank = int(n_workers), int(rank)
        leaves = tree_leaves(params)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets: List[int] = []
        ofs = 0
        for n in self.sizes:
            self.offsets.append(ofs)
            ofs = -(-(ofs + n) // align) * align
        self.n_total = sum(self.sizes)
        self.total = self.offsets[-1] + self.sizes[-1]
        self.chunk = chunk_size(self.total, self.n_workers)
        self.padded = self.chunk * self.n_workers
        self.template = tree_map(lambda _: None, params)
        self.shard = self.full = self.flat_grad = None
        self.params = None
        self.grad_views: List[torch.Tensor] = []

    # -- host side ----------------------------------------------------------

    def _tree(self, leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), self.template)

    def flat_host(self, params) -> np.ndarray:
        """``[padded]`` float32: the tree's leaves at their offsets."""
        flat = np.zeros(self.padded, np.float32)
        for o, n, l in zip(self.offsets, self.sizes, tree_leaves(params)):
            a = l.detach().cpu().numpy() if isinstance(l, torch.Tensor) \
                else np.asarray(l)
            flat[o:o + n] = a.reshape(-1)
        return flat

    def chunk_host(self, params) -> np.ndarray:
        """``[n_workers, chunk]`` float32 rows of the tree: row i is rank
        i's shard (the boxed checkpoint layout)."""
        return self.flat_host(params).reshape(self.n_workers, self.chunk)

    def from_dense(self, dense) -> np.ndarray:
        """``[n_workers, chunk]`` rows of a dense flat vector (the leaves
        back to back in the port's order, ``helper_funcs.flatten_tree``)."""
        dense = np.asarray(dense, np.float32).reshape(-1)
        flat = np.zeros(self.padded, np.float32)
        d = 0
        for o, n in zip(self.offsets, self.sizes):
            flat[o:o + n] = dense[d:d + n]
            d += n
        return flat.reshape(self.n_workers, self.chunk)

    def host_params_from_chunks(self, boxed_chunks):
        """Inverse of :meth:`chunk_host`: the tree of float32 arrays."""
        flat = np.asarray(boxed_chunks, np.float32).reshape(-1)
        return self._tree([flat[o:o + n].reshape(s).copy() for o, n, s in
                           zip(self.offsets, self.sizes, self.shapes)])

    # -- the storage ----------------------------------------------------------

    def views(self, flat: torch.Tensor) -> list:
        """The leaves as views of a ``[padded]`` flat tensor."""
        return [flat[o:o + n].view(s) for o, n, s in
                zip(self.offsets, self.sizes, self.shapes)]

    def attach(self, params, device) -> None:
        """Make the storage from ``params`` (this rank's chunk of them, the
        full buffer holding all of them, its leaves taking gradients) and
        the zeroed gradient buffer."""
        flat = torch.from_numpy(self.flat_host(params)).to(device)
        self.full = flat
        lo = self.rank * self.chunk
        self.shard = flat[lo:lo + self.chunk].clone()
        self.params = self._tree([v.requires_grad_(True)
                                  for v in self.views(flat)])
        self.flat_grad = torch.zeros_like(flat)
        self.grad_views = self.views(self.flat_grad)

    def load_full(self) -> None:
        """This rank's chunk refreshed from ``full`` (after the leaves were
        written directly)."""
        lo = self.rank * self.chunk
        with torch.no_grad():
            self.shard.copy_(self.full[lo:lo + self.chunk])

    # -- in the step ------------------------------------------------------------

    @torch.no_grad()
    def gather_params(self) -> None:
        """Every rank's shard gathered into ``full``, which ``params``
        view: one ``all_gather_into_tensor``."""
        all_gather_into(self.full, self.shard)

    @torch.no_grad()
    def reduce_grads(self) -> torch.Tensor:
        """This rank's chunk of the mean gradient: one
        ``reduce_scatter_tensor`` (SUM) of ``flat_grad``, times 1/N."""
        g = self.shard.new_empty(self.chunk)
        reduce_scatter_into(g, self.flat_grad)
        return g.mul_(1.0 / self.n_workers)

    @torch.no_grad()
    def clip_chunk(self, g_chunk: torch.Tensor, clip: float) -> torch.Tensor:
        """Global-L2-norm clipping of the chunked gradient: the chunks
        partition the flat vector (gaps and pad carry zeros), so the norm
        is one scalar all-reduce of the chunks' sums of squares; every rank
        scales by the same factor, on the device, in place."""
        if clip <= 0.0:
            return g_chunk
        sq = g_chunk.float().square().sum()
        dist.all_reduce(sq)
        scale = torch.clamp(clip / torch.clamp(sq.sqrt(), min=1e-12),
                            max=1.0)
        return g_chunk.mul_(scale)
