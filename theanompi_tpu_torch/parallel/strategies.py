"""Collective exchange strategies.

Counterpart of ``theanompi_tpu/parallel/strategies.py`` for ``NoComm`` and
``AllReduce`` (with its bfloat16 wire), on ``torch.distributed``: NCCL for
tensors on the card, gloo for CPU tensors, whichever group the process
initialized (``base.MeshProcess``).

Every strategy returns the **mean** of its input tree over the ranks.  The
port reduces in place: the gradient tensors it is handed hold the mean on
return.  The stateful strategies of the JAX package (error feedback) are
not ported yet, so a strategy here takes and returns only the tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utils.helper_funcs import tree_leaves


class Strategy:
    """Base: ``(tree, size) -> mean_tree``."""

    name = "base"

    def __call__(self, tree, *, size: int):
        raise NotImplementedError


class NoComm(Strategy):
    """The per-rank mean WITHOUT the collective — for measuring what the
    exchange costs by difference.  Training with it breaks BSP: replicas
    diverge."""

    name = "none"

    @torch.no_grad()
    def __call__(self, tree, *, size: int):
        inv = 1.0 / size
        for g in tree_leaves(tree):
            g.mul_(inv)
        return tree


class AllReduce(Strategy):
    """``all_reduce`` sum, then ÷ size.  ``wire_dtype=torch.bfloat16``
    reduces a bfloat16 copy (cast → sum → cast back), the float32 master
    gradient untouched until the result lands in it."""

    def __init__(self, wire_dtype: Optional[torch.dtype] = None):
        self.wire_dtype = wire_dtype
        self.name = "allreduce" if wire_dtype is None else "allreduce16"

    @torch.no_grad()
    def __call__(self, tree, *, size: int):
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
        return tree


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
    }
    try:
        return table[name]()
    except KeyError:
        raise ValueError(f"unknown or not yet ported exchange strategy "
                         f"{name!r}; have {sorted(table)}")
