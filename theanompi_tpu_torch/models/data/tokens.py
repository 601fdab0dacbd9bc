"""Token-file dataset for the transformer family.

Counterpart of ``theanompi_tpu/models/data/tokens.py``, a copy (the port
imports nothing of the JAX package): the real-data form of
``transformer_lm.LMData``'s synthetic stream, in nanoGPT's flat token
files (``train.bin`` / ``val.bin``: one raw little-endian token array a
split, ``token_dtype``, uint16 by default; ``.npy`` and ``_tokens.npy``
too), memory-mapped, so nothing is read until a batch gathers its windows.

A sample is a NON-OVERLAPPING ``seq_len + 1`` token window, held as a
window id in :class:`..DataBase`'s index arrays, so the common-seed
shuffle, the rank's block of the global batch and the resume cursor apply
unchanged; ``_make_batch`` gathers the windows (one fancy-indexed read of
the map), the targets shifted by one, and refuses a token id past the
model's vocabulary.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import DataBase


def _load_tokens(path_base: str, dtype) -> np.ndarray:
    """Memory-map ``<base>.bin`` (raw) or ``<base>.npy`` /
    ``<base>_tokens.npy``."""
    for p, loader in ((path_base + ".bin",
                       lambda p: np.memmap(p, dtype=dtype, mode="r")),
                      (path_base + ".npy",
                       lambda p: np.load(p, mmap_mode="r")),
                      (path_base + "_tokens.npy",
                       lambda p: np.load(p, mmap_mode="r"))):
        if os.path.exists(p):
            return loader(p)
    raise FileNotFoundError(
        f"no token file at {path_base}.bin/.npy/_tokens.npy")


class TokenFileData(DataBase):
    """``data_dir/train.bin`` + ``data_dir/val.bin`` next-token dataset."""

    def __init__(self, config: Optional[dict] = None, batch_size: int = 16,
                 seq_len: int = 64, vocab: Optional[int] = None):
        super().__init__(config, batch_size)
        self.seq_len = int(self.config.get("seq_len", seq_len))
        # the model passes its resolved vocab, so the out-of-range check
        # holds for a class-default vocabulary too: an embedding gather
        # past the table would index out of bounds
        v = self.config.get("vocab", vocab)
        self._vocab = int(v) if v is not None else None
        data_dir = self.config["data_dir"]
        dtype = np.dtype(self.config.get("token_dtype", "uint16"))
        self._toks = {
            True: _load_tokens(os.path.join(data_dir, "train"), dtype),
            False: _load_tokens(os.path.join(data_dir, "val"), dtype),
        }

        def n_windows(split):
            return max(0, (len(self._toks[split]) - 1) // self.seq_len)

        # the index arrays hold WINDOW ids; _make_batch gathers them
        self.x_train = self.y_train = np.arange(n_windows(True))
        self.x_val = self.y_val = np.arange(n_windows(False))
        self._finalize()

    def _make_batch(self, ids, _ids, train: bool):
        toks = self._toks[train]
        starts = np.asarray(ids, dtype=np.int64) * self.seq_len
        seq = np.asarray(
            toks[starts[:, None] + np.arange(self.seq_len + 1)],
            dtype=np.int32)
        if self._vocab is not None:
            mx = int(seq.max())
            assert mx < self._vocab, (
                f"token id {mx} >= vocab={self._vocab}: the corpus was "
                f"tokenized with a larger vocabulary than the model's")
        return {"x": np.ascontiguousarray(seq[:, :-1]),
                "y": np.ascontiguousarray(seq[:, 1:])}
