"""ZeRO-1: the optimizer state sharded over the data-parallel ranks.

Counterpart of ``theanompi_tpu/parallel/zero.py``.  Under BSP every rank
applies the same reduced gradient, so its momentum (or Adam moments, or
EMA shadow) is a replica of every other rank's.  ``zero_opt=true`` keeps
one ``ceil(P/N)`` chunk of the flattened state per rank, updates only
that chunk of the params, and one all-gather rebuilds the full params for
the next forward: :func:`zero1` is ``update_sharding.flat_shard_opt``, the
flat-chunk-everything configuration.  The update math is element-wise on
disjoint chunks, so it is bit-equal to the unsharded update, a ragged
count (P = 10, N = 4) included.  On a model-parallel grid each rank chunks
its own local shards over its workers group (``ema_decay`` inside, as in
the JAX package), and a checkpoint holds the JAX package's boxed
``[dp, shards·chunk]``.

The JAX package's ``rechunk_boxed`` (a ZeRO checkpoint refit onto another
worker count) belongs to elastic resume, which the port refuses (A10).
"""

from __future__ import annotations

from ..utils.opt import OptPair
from .update_sharding import chunk_size, flat_shard_opt, padded_size

__all__ = ["chunk_size", "padded_size", "zero1"]


def zero1(opt: OptPair, n_workers: int, params_template,
          rank: int) -> OptPair:
    """``opt`` with its state flat-chunked over ``n_workers`` ranks, this
    one keeping chunk ``rank``: see :func:`update_sharding.flat_shard_opt`."""
    return flat_shard_opt(opt, n_workers, params_template, rank)
