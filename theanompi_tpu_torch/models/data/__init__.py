"""Data pipeline.

Counterpart of ``theanompi_tpu/models/data/__init__.py``.  The JAX package
ran one process per host and split each global batch over that host's chips;
the port runs one process per GPU, so a data object yields the rows of ONE
rank: rank ``r`` of ``size`` takes the ``r``-th contiguous block of the
global batch, the block the JAX mesh would have handed worker ``r``.  The
common-seed shuffle keeps those blocks disjoint.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _host_topology(config: dict):
    """(process_count, process_index) of the HOSTS: always one host so far
    (multi-host loading is not ported).  Ranks within the host are
    ``config['rank']`` / ``config['size']``."""
    if int(config.get("process_count") or 1) != 1:
        raise NotImplementedError("multi-host data loading is not ported yet")
    return 1, 0


class DataBase:
    """In-memory dataset with the JAX package's shuffle semantics; each
    batch holds this rank's ``batch_size`` rows of the global batch."""

    def __init__(self, config: Optional[dict] = None, batch_size: int = 128):
        self.config = dict(config or {})
        self.size = int(self.config.get("size", 1))
        self.rank = int(self.config.get("rank", 0))
        self.batch_size = batch_size
        self.global_batch = self.size * batch_size
        self.procs, self.proc_id = _host_topology(self.config)
        self.x_train = self.y_train = self.x_val = self.y_val = None
        self._perm = None
        self._train_ptr = 0
        self._val_ptr = 0
        self._shuffle_seed = None

    def _finalize(self) -> None:
        n_train, n_val = len(self.y_train), len(self.y_val)
        self.n_batch_train = n_train // self.global_batch
        self.n_batch_val = max(1, n_val // self.global_batch)
        self._perm = np.arange(n_train)
        if self.n_batch_train <= 0:
            raise ValueError(f"{n_train} train samples < one global batch "
                             f"{self.global_batch}")

    def shuffle_data(self, seed: int) -> None:
        self._perm = np.random.RandomState(seed).permutation(len(self.y_train))
        self._shuffle_seed = int(seed)
        self._train_ptr = 0
        self._val_ptr = 0

    # -- checkpoint cursor: a resume replays the data stream exactly -------
    def get_cursor(self) -> Dict:
        """The shuffle seed (it regenerates the permutation) and the batch
        pointers (they reposition it)."""
        return {"shuffle_seed": self._shuffle_seed,
                "train_ptr": int(self._train_ptr),
                "val_ptr": int(self._val_ptr)}

    def set_cursor(self, cursor: Dict) -> None:
        if cursor.get("shuffle_seed") is not None:
            self.shuffle_data(int(cursor["shuffle_seed"]))
        self._train_ptr = int(cursor.get("train_ptr", 0))
        self._val_ptr = int(cursor.get("val_ptr", 0))

    def _local(self, lo: int) -> slice:
        start = lo + self.rank * self.batch_size
        return slice(start, start + self.batch_size)

    def next_train_batch(self, count: int) -> Dict[str, np.ndarray]:
        i = self._train_ptr % self.n_batch_train
        self._train_ptr += 1
        idx = self._perm[self._local(i * self.global_batch)]
        return self._make_batch(self.x_train[idx], self.y_train[idx],
                                train=True)

    def next_val_batch(self, count: int) -> Dict[str, np.ndarray]:
        i = self._val_ptr % self.n_batch_val
        self._val_ptr += 1
        sl = self._local(i * self.global_batch)
        return self._make_batch(self.x_val[sl], self.y_val[sl], train=False)

    def _make_batch(self, x, y, train: bool) -> Dict[str, np.ndarray]:
        return {"x": np.ascontiguousarray(x, dtype=np.float32),
                "y": np.ascontiguousarray(y, dtype=np.int32)}
