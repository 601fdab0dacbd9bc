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
``[dp, shards·chunk]``, which :func:`rechunk_boxed` re-partitions onto
another worker count (a resume on another world, ``ModelBase.load``).
"""

from __future__ import annotations

import numpy as np

from ..utils.opt import OptPair
from .update_sharding import chunk_size, flat_shard_opt, padded_size

__all__ = ["chunk_size", "padded_size", "rechunk_boxed", "zero1"]


def rechunk_boxed(arr, n_new: int, shards: int,
                  local_total: int) -> np.ndarray:
    """A saved boxed ZeRO state leaf ``[n_saved, shards·chunk_s]``
    re-partitioned onto ``[n_new, shards·chunk_new]``.  Column block r of
    the rows is grid rank r's chunk, so grid rank r's local flat vector is
    block r of every row end to end: each is joined, its pad cut, padded
    again and sliced for ``n_new`` workers.  ``shards`` and
    ``local_total`` belong to the model's layout and must match the
    saving run's."""
    n_s = int(arr.shape[0])
    assert arr.ndim == 2 and arr.shape[1] % shards == 0, arr.shape
    chunk_s = arr.shape[1] // shards
    # [n_s, shards, chunk_s] -> [shards, n_s·chunk_s] -> pad cut
    per_rank = np.transpose(np.asarray(arr).reshape(n_s, shards, chunk_s),
                            (1, 0, 2)).reshape(shards, -1)[:, :local_total]
    chunk_n = chunk_size(local_total, n_new)
    per_rank = np.pad(per_rank, ((0, 0), (0, padded_size(local_total, n_new)
                                          - local_total)))
    return np.transpose(per_rank.reshape(shards, n_new, chunk_n),
                        (1, 0, 2)).reshape(n_new, shards * chunk_n)


def zero1(opt: OptPair, n_workers: int, params_template,
          rank: int) -> OptPair:
    """``opt`` with its state flat-chunked over ``n_workers`` ranks, this
    one keeping chunk ``rank``: see :func:`update_sharding.flat_shard_opt`."""
    return flat_shard_opt(opt, n_workers, params_template, rank)
