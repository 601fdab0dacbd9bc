"""CIFAR-10 data object.

Counterpart of ``theanompi_tpu/models/data/cifar10.py``, a copy (the port
imports nothing of the JAX package): the standard ``cifar-10-batches-py``
pickle files when present (``config['data_dir']``, ``$CIFAR10_DIR``, or
``./data/cifar-10-batches-py``), else a deterministic synthetic set
(per-class prototype images plus Gaussian noise, drawn from the same
``RandomState`` seeds, so bit-equal to the JAX package's).  Images are
NHWC float32 in [0, 1] (real) with the per-channel mean of the training set
subtracted.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from . import DataBase

N_CLASS = 10
IMG = 32


class Cifar10_data(DataBase):
    def __init__(self, config: Optional[dict] = None, batch_size: int = 128):
        super().__init__(config, batch_size)
        d = self._find_dir()
        if d:
            self._load_real(d)
            self.synthetic = False
        else:
            n_train = int(self.config.get("synthetic_train", 4096))
            n_val = int(self.config.get("synthetic_val", 1024))
            self._make_synthetic(n_train, n_val)
            self.synthetic = True
        # channel-mean subtraction (the reference subtracted the mean image)
        self.mean = self.x_train.mean(axis=(0, 1, 2), keepdims=True)
        self._finalize()

    def _find_dir(self) -> Optional[str]:
        cands = [self.config.get("data_dir"),
                 os.environ.get("CIFAR10_DIR"),
                 "./data/cifar-10-batches-py"]
        for c in cands:
            if c and os.path.isdir(c) and \
                    os.path.exists(os.path.join(c, "data_batch_1")):
                return c
        return None

    def _load_real(self, d: str) -> None:
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xs.append(b[b"data"])
            ys.append(b[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, IMG, IMG).transpose(0, 2, 3, 1)
        self.x_train = x.astype(np.float32) / 255.0
        self.y_train = np.concatenate(ys).astype(np.int32)
        with open(os.path.join(d, "test_batch"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xv = np.asarray(b[b"data"]).reshape(-1, 3, IMG, IMG).transpose(
            0, 2, 3, 1)
        self.x_val = xv.astype(np.float32) / 255.0
        self.y_val = np.asarray(b[b"labels"], dtype=np.int32)

    def _make_synthetic(self, n_train: int, n_val: int) -> None:
        rng = np.random.RandomState(1234)
        protos = rng.randn(N_CLASS, IMG, IMG, 3).astype(np.float32) * 0.8

        def make(n, seed):
            r = np.random.RandomState(seed)
            y = r.randint(0, N_CLASS, n).astype(np.int32)
            x = protos[y] + 0.25 * r.randn(n, IMG, IMG, 3).astype(np.float32)
            return x, y

        self.x_train, self.y_train = make(n_train, 5678)
        self.x_val, self.y_val = make(n_val, 91011)

    def _make_batch(self, x, y, train):
        return {"x": np.ascontiguousarray(x - self.mean, dtype=np.float32),
                "y": np.ascontiguousarray(y, dtype=np.int32)}
