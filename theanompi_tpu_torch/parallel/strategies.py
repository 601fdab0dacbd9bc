"""Collective exchange strategies.

Counterpart of ``theanompi_tpu/parallel/strategies.py`` for ``NoComm``,
``AllReduce`` (with its bfloat16 wire) and ``OneBit`` (the sign-compressed
wire with error feedback), on ``torch.distributed``: NCCL for tensors on the
card, gloo for CPU tensors, whichever group the process initialized
(``base.MeshProcess``).

Every strategy is called as ``strategy(tree, state, size=N)`` and returns
``(mean_tree, new_state)``: the **mean** of its input tree over the ranks,
and its per-rank state for the next step (``()`` for a stateless
strategy; ``init_state(params)`` makes the first).  ``NoComm`` and
``AllReduce`` reduce in place: the gradient tensors they are handed hold
the mean on return.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..ops import compress as compress_ops
from ..utils.helper_funcs import (flatten_tree, tree_leaves, tree_size,
                                  unflatten_like)


class Strategy:
    """Base: ``(tree, state, *, size) -> (mean_tree, new_state)``."""

    name = "base"
    stateful = False
    # True when the strategy works on one flattened vector, not leaf-wise
    flattens = False

    def init_state(self, params) -> Any:
        """Per-rank persistent state."""
        return ()

    def __call__(self, tree, state, *, size: int):
        raise NotImplementedError


class NoComm(Strategy):
    """The per-rank mean WITHOUT the collective — for measuring what the
    exchange costs by difference.  Training with it breaks BSP: replicas
    diverge."""

    name = "none"

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        inv = 1.0 / size
        for g in tree_leaves(tree):
            g.mul_(inv)
        return tree, state


class AllReduce(Strategy):
    """``all_reduce`` sum, then ÷ size.  ``wire_dtype=torch.bfloat16``
    reduces a bfloat16 copy (cast → sum → cast back), the float32 master
    gradient untouched until the result lands in it."""

    def __init__(self, wire_dtype: Optional[torch.dtype] = None):
        self.wire_dtype = wire_dtype
        self.name = "allreduce" if wire_dtype is None else "allreduce16"

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        inv = 1.0 / size
        wd = self.wire_dtype
        for g in tree_leaves(tree):
            if wd is None:
                dist.all_reduce(g)
                g.mul_(inv)
            else:
                w = g.to(wd)
                dist.all_reduce(w)
                g.copy_(w.to(g.dtype)).mul_(inv)
        return tree, state


def _all_gather(t: torch.Tensor, size: int) -> torch.Tensor:
    """``[size, *t.shape]``: every rank's ``t``, in rank order."""
    out = t.new_empty((size,) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t)
    return out


class OneBit(Strategy):
    """1-bit sign compression with error feedback (BASELINE.json config 5).

    Each rank adds its carried error to its gradient, ``c = g + state``,
    sends the sign bits of ``c`` (packed 32 to a word) and one scale,
    ``mean|c|``, and keeps the residual ``c − scale·sign(c)`` as the next
    step's state.  Every rank decodes the same gathered bits and scales, so
    all ranks apply the same mean.  On the card the three passes are the
    kernels B5 (encode), B6 (residual) and B4 (decode) of
    ``ops/compress.py``; no value is read back to the host."""

    name = "onebit"
    stateful = True
    flattens = True

    def init_state(self, params) -> torch.Tensor:
        n = tree_size(params)
        padded = n + (-n) % compress_ops.PACK_ALIGN
        dev = tree_leaves(params)[0].device
        return torch.zeros(padded, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        flat = flatten_tree(tree, pad_to_multiple_of=compress_ops.PACK_ALIGN)
        n_true = tree_size(tree)
        packed, absc = compress_ops.pack_signs_encode(flat, state)
        # the scale over the true length: the zero pad would deflate it
        scale = absc[:n_true].mean() + 1e-12
        new_state = compress_ops.signed_residual(absc, packed, scale)
        all_scales = _all_gather(scale, size)          # [size]
        all_packed = _all_gather(packed, size)         # n/8 bytes per rank
        mean = compress_ops.unpack_signs_weighted_mean(all_packed, all_scales,
                                                       size)
        return unflatten_like(tree, mean), new_state


def get_strategy(name: str) -> Strategy:
    """Resolve a strategy by its reference-compatible config string."""
    name = name.lower()
    table = {
        "none": NoComm,
        "nocomm": NoComm,
        "allreduce": AllReduce,
        "ar": AllReduce,
        "nccl32": AllReduce,
        "nccl16": lambda: AllReduce(wire_dtype=torch.bfloat16),
        "bf16": lambda: AllReduce(wire_dtype=torch.bfloat16),
        "onebit": OneBit,
        "compressed": OneBit,
    }
    try:
        return table[name]()
    except KeyError:
        raise ValueError(f"unknown or not yet ported exchange strategy "
                         f"{name!r}; have {sorted(table)}")
