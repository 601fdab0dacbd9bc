"""ImageNet data object — the synthetic source.

Counterpart of ``theanompi_tpu/models/data/imagenet.py``.  This slice ports
its synthetic source: deterministic uint8 256×256 images (the stored size of
the reference's batch files) cropped to ``crop`` with a random window and
mirror per batch at train time, the centre window at validation, and the
mean subtracted — the stream the JAX package draws for the same config and
seed.  Reading ``.hkl`` batch files is not ported yet: a config whose
``data_dir`` holds ``train_hkl/`` raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

RAW = 256       # stored image side
CROP = 227      # AlexNet crop
N_CLASS = 1000


def augment_batch(x: np.ndarray, oy, ox, flip, crop: int,
                  mean: Optional[np.ndarray] = None,
                  mean_scalar: float = 0.0) -> np.ndarray:
    """Crop + mirror + mean-subtract + cast: uint8 NHWC → float32 NHWC.
    The NumPy path of ``theanompi_tpu/native/__init__.py`` ``augment_batch``;
    per-image offsets and flags, scalars broadcast."""
    if x.dtype != np.uint8 or x.ndim != 4:
        raise ValueError(f"augment_batch takes uint8 NHWC, got {x.dtype} "
                         f"{x.shape}")
    n, c = x.shape[0], x.shape[-1]
    oy = np.broadcast_to(np.asarray(oy, np.int32), (n,))
    ox = np.broadcast_to(np.asarray(ox, np.int32), (n,))
    flip = np.broadcast_to(np.asarray(flip, np.uint8), (n,))
    out = np.empty((n, crop, crop, c), np.float32)
    for i in range(n):
        win = x[i, oy[i]:oy[i] + crop, ox[i]:ox[i] + crop, :]
        if flip[i]:
            win = win[:, ::-1, :]
        out[i] = win
    out -= mean if mean is not None else np.float32(mean_scalar)
    return out


class ImageNet_data:
    """Batches of this rank's ``batch_size`` rows of the global batch."""

    def __init__(self, config: Optional[dict] = None, batch_size: int = 128,
                 crop: int = CROP):
        from . import _host_topology
        self.config = dict(config or {})
        self.size = int(self.config.get("size", 1))
        self.rank = int(self.config.get("rank", 0))
        self.batch_size = batch_size
        self.global_batch = self.size * batch_size
        self.procs, self.proc_id = _host_topology(self.config)
        self.crop = int(self.config.get("crop_size", crop))
        self.rng = np.random.RandomState(self.config.get("seed", 42))
        if self.config.get("aug_wire_u8", False):
            raise NotImplementedError("aug_wire_u8 is not ported yet")

        d = self.config.get("data_dir") or os.environ.get("IMAGENET_DIR")
        if d and os.path.isdir(os.path.join(d, "train_hkl")):
            raise NotImplementedError(
                f"{d}: reading .hkl ImageNet batches is not ported yet; "
                f"the port trains on the synthetic source")
        self.synthetic = True
        self.n_batch_train = int(self.config.get("synthetic_batches", 64))
        self.n_batch_val = int(self.config.get("synthetic_val_batches", 4))
        self.img_mean = np.float32(122.0)
        # the JAX package's single-host draw of the whole global batch, of
        # which this rank keeps its block: ranks see what the JAX workers
        # would, and N ranks together see what one rank sees on N× the batch
        r = np.random.RandomState([0, self.proc_id])
        x = r.randint(0, 256, (self.global_batch, RAW, RAW, 3), dtype=np.uint8)
        n_class = int(self.config.get("n_class", N_CLASS))
        y = r.randint(0, n_class, self.global_batch).astype(np.int32)
        rows = slice(self.rank * batch_size, (self.rank + 1) * batch_size)
        self._synth_x = np.ascontiguousarray(x[rows])
        self._synth_y = y[rows]

    def shuffle_data(self, seed: int) -> None:
        """The synthetic batch is re-used every step; nothing to permute."""

    def _draw(self, n: int, h: int, w: int, train: bool):
        """Crop/mirror draws for the GLOBAL batch (shared by all ranks)."""
        c = self.crop
        if train:
            m = n if self.config.get("aug_per_image", False) else 1
            oy = self.rng.randint(0, h - c + 1, size=m).astype(np.int32)
            ox = self.rng.randint(0, w - c + 1, size=m).astype(np.int32)
            flip = self.rng.randint(0, 2, size=m).astype(np.uint8)
        else:
            oy = np.full(1, (h - c) // 2, np.int32)
            ox = np.full(1, (w - c) // 2, np.int32)
            flip = np.zeros(1, np.uint8)
        return oy, ox, flip

    def _transform(self, draws) -> Dict[str, np.ndarray]:
        oy, ox, flip = draws
        if oy.shape[0] > 1:               # per-image draws: this rank's rows
            rows = slice(self.rank * self.batch_size,
                         (self.rank + 1) * self.batch_size)
            oy, ox, flip = oy[rows], ox[rows], flip[rows]
        out = augment_batch(self._synth_x, oy, ox, flip, self.crop,
                            mean_scalar=float(self.img_mean))
        return {"x": out, "y": np.ascontiguousarray(self._synth_y)}

    def next_train_batch(self, count: int) -> Dict[str, np.ndarray]:
        return self._transform(self._draw(self.global_batch, RAW, RAW,
                                          train=True))

    def next_val_batch(self, count: int) -> Dict[str, np.ndarray]:
        return self._transform(self._draw(self.global_batch, RAW, RAW,
                                          train=False))
