"""ImageNet data object: batch files or the synthetic source.

Counterpart of ``theanompi_tpu/models/data/imagenet.py``, on the reference's
on-disk contract: ``config['data_dir']`` (or ``$IMAGENET_DIR``) holds
``train_hkl/`` and ``val_hkl/`` of batch files (one file = one
``batch_size``-image uint8 batch, bc01, c01b or NHWC; ``.hkl``, ``.npy`` or
``.npz``), ``train_labels.npy`` and ``val_labels.npy`` (file ``j``'s labels
are rows ``j·batch_size ..``), and optionally ``img_mean.npy`` (a CHW or HWC
mean image, a per-channel mean, or none: the scalar 122).  An epoch is the
file list shuffled with a common seed; step ``i`` takes files
``i·size .. i·size + size - 1`` of it, and rank ``r`` loads file
``i·size + r``, its contiguous block of the global batch.  Augmentation:
one random crop window and mirror per global batch (``aug_per_image``: one
per image, drawn for the whole global batch so every rank's RNG stays in
step), the centre window at validation, the mean subtracted; the fused pass
is ``theanompi_tpu_torch.native``.  ``aug_wire_u8`` ships the uint8 crop
instead and leaves cast and mean to the card (``ModelBase.stage_input``).

Without batch files the source is synthetic: deterministic uint8 256×256
images drawn as the JAX package draws them, of which each rank keeps its
block.  ``.hkl`` files are read with h5py, imported only for such a file;
the ``.npy`` and ``.npz`` readers need nothing beyond NumPy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ... import native

RAW = 256       # stored image side
CROP = 227      # AlexNet crop
N_CLASS = 1000


def _load_hkl_h5py(path: str) -> np.ndarray:
    """A hickle ``.hkl`` file is an HDF5 file: its array is a dataset named
    ``data`` or ``data_0`` at the root (hickle v1–v3) or nested in a group
    among small metadata datasets (v4+), where it is the largest."""
    import h5py

    with h5py.File(path, "r") as f:
        for name in ("data", "data_0"):
            if name in f and isinstance(f[name], h5py.Dataset):
                return np.asarray(f[name])
        found = []

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                found.append((obj.size, name))

        f.visititems(visit)
        if not found:
            raise ValueError(f"{path}: no dataset inside the HDF5/.hkl file")
        return np.asarray(f[max(found)[1]])


def _load_batch_file(path: str) -> np.ndarray:
    """One batch file: ``.hkl`` through hickle when it is installed, else
    (or when hickle cannot read it) through h5py; ``.npz`` its first array;
    anything else ``np.load``."""
    if path.endswith(".hkl"):
        try:
            import hickle
        except ImportError:
            return _load_hkl_h5py(path)
        try:
            return np.asarray(hickle.load(path))
        except Exception as hickle_err:
            # an HDF5 file that is not hickle-shaped: the h5py reader's
            # failure would hide the real one, so raise hickle's
            try:
                return _load_hkl_h5py(path)
            except Exception:
                raise hickle_err
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]]
    return np.load(path)


def _is_c01b(x: np.ndarray) -> bool:
    """The legacy c01b layout ``(C, H, W, B)``: the channel count leads and
    the trailing dim is not one (else it is a small NHWC batch)."""
    return x.ndim == 4 and x.shape[0] in (1, 3) and x.shape[-1] not in (1, 3)


class ImageNet_data:
    """Batches of this rank's ``batch_size`` rows of the global batch.

    Training splits into :meth:`plan_train_batch` (advances the cursor and
    the augmentation RNG: sequential) and :meth:`materialize` (loads and
    augments: stateless, thread-safe), so the pooled producer of
    ``prefetch.PrefetchLoader`` can materialize several plans at once and
    still yield the serial stream bit for bit."""

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
        self.wire_u8 = bool(self.config.get("aug_wire_u8", False))
        # the pooled producer runs para_load_workers augments at once: each
        # takes its share of the host's threads
        workers = int(self.config.get("para_load_workers", 4)) \
            if self.config.get("para_load") else 1
        self.aug_threads = max(1, native.DEFAULT_THREADS // max(1, workers))

        d = self.config.get("data_dir") or os.environ.get("IMAGENET_DIR")
        if d and os.path.isdir(os.path.join(d, "train_hkl")):
            self._init_real(d)
            self.synthetic = False
        else:
            self._init_synthetic()
            self.synthetic = True
        self._train_ptr = 0
        self._val_ptr = 0
        self._shuffle_seed = None
        self._hw = None
        self._perm = None if self.synthetic \
            else np.arange(len(self.train_files))

    # -- real batch files ---------------------------------------------------

    def _init_real(self, d: str) -> None:
        def listdir(sub):
            p = os.path.join(d, sub)
            return sorted(os.path.join(p, f) for f in os.listdir(p)
                          if f.split(".")[-1] in ("hkl", "npy", "npz"))

        self.train_files: List[str] = listdir("train_hkl")
        self.val_files: List[str] = listdir("val_hkl")
        self.train_labels = np.load(os.path.join(d, "train_labels.npy"))
        self.val_labels = np.load(os.path.join(d, "val_labels.npy"))
        mean_path = os.path.join(d, "img_mean.npy")
        self.img_mean = (np.load(mean_path).astype(np.float32)
                         if os.path.exists(mean_path) else np.float32(122.0))
        if isinstance(self.img_mean, np.ndarray) and self.img_mean.ndim == 3:
            # a reference c01 (CHW) mean becomes HWC once, not per batch
            self.img_mean = self._mean_to_hwc(self.img_mean)
        self.n_batch_train = len(self.train_files) // self.size
        self.n_batch_val = max(1, len(self.val_files) // self.size)
        if self.n_batch_train <= 0:
            raise ValueError(f"{d}: {len(self.train_files)} train files < "
                             f"one per rank ({self.size})")

    # -- synthetic ----------------------------------------------------------

    def _init_synthetic(self) -> None:
        self.n_batch_train = int(self.config.get("synthetic_batches", 64))
        self.n_batch_val = int(self.config.get("synthetic_val_batches", 4))
        self.train_files = self.val_files = []
        self.img_mean = np.float32(122.0)
        # the JAX package's single-host draw of the whole global batch, of
        # which this rank keeps its block: ranks see what the JAX workers
        # would, and N ranks together see what one rank sees on N× the batch
        r = np.random.RandomState([0, self.proc_id])
        x = r.randint(0, 256, (self.global_batch, RAW, RAW, 3), dtype=np.uint8)
        n_class = int(self.config.get("n_class", N_CLASS))
        y = r.randint(0, n_class, self.global_batch).astype(np.int32)
        rows = self._rows()
        self._synth_x = np.ascontiguousarray(x[rows])
        self._synth_y = y[rows]

    # -- contract -----------------------------------------------------------

    def shuffle_data(self, seed: int) -> None:
        """Common-seed shuffle of the batch-FILE list: every rank permutes
        identically, so their files are disjoint.  The synthetic batch is
        re-used every step."""
        if not self.synthetic:
            self._perm = np.random.RandomState(seed).permutation(
                len(self.train_files))
        self._shuffle_seed = int(seed)
        self._train_ptr = 0
        self._val_ptr = 0

    def get_cursor(self) -> Dict:
        """Shuffle seed, batch pointers and augmentation RNG state: enough
        to resume the exact file, crop and mirror stream mid-epoch."""
        keys, pos, has_gauss, cached = self.rng.get_state()[1:]
        return {"shuffle_seed": self._shuffle_seed,
                "train_ptr": int(self._train_ptr),
                "val_ptr": int(self._val_ptr),
                "aug_rng_keys": np.asarray(keys),
                "aug_rng_pos": int(pos),
                "aug_rng_has_gauss": int(has_gauss),
                "aug_rng_cached": float(cached)}

    def set_cursor(self, cursor: Dict) -> None:
        if cursor.get("shuffle_seed") is not None:
            self.shuffle_data(int(cursor["shuffle_seed"]))
        self._train_ptr = int(cursor.get("train_ptr", 0))
        self._val_ptr = int(cursor.get("val_ptr", 0))
        if "aug_rng_keys" in cursor:
            self.rng.set_state(("MT19937",
                                np.asarray(cursor["aug_rng_keys"], np.uint32),
                                int(cursor["aug_rng_pos"]),
                                int(cursor["aug_rng_has_gauss"]),
                                float(cursor["aug_rng_cached"])))

    def _rows(self) -> slice:
        """This rank's block of a global batch's rows."""
        return slice(self.rank * self.batch_size,
                     (self.rank + 1) * self.batch_size)

    def _local_files(self, lo: int) -> range:
        """The files of the step that starts at file ``lo`` of the shuffled
        list: ``size`` of them, one per rank."""
        return range(lo, lo + self.size)

    def plan_train_batch(self, count: int) -> Dict:
        """Advance the cursor and the augmentation RNG; return a PLAN that
        :meth:`materialize` turns into the batch without touching either."""
        if self.synthetic:
            return {"files": None,
                    "draws": self._draw(self.global_batch, RAW, RAW,
                                        train=True)}
        i = self._train_ptr % self.n_batch_train
        self._train_ptr += 1
        idx = [int(self._perm[j]) for j in self._local_files(i * self.size)]
        h, w = self._stored_hw()
        return {"files": [idx[self.rank]],
                "draws": self._draw(self.global_batch, h, w, train=True)}

    def _stored_hw(self):
        """Stored image size, read once from the first batch file (the
        plan's draws must fit what materialize loads)."""
        if self._hw is None:
            self._hw = self._hw_of(self._to_input(
                _load_batch_file(self.train_files[0])))
        return self._hw

    def materialize(self, plan: Dict) -> Dict[str, np.ndarray]:
        """Stateless plan → batch (thread-safe: reads only fields that do
        not change after construction; all RNG happened at plan time)."""
        if plan["files"] is None:
            return self._transform(self._synth_x, self._synth_y,
                                   plan["draws"])
        x, y = self._load(self.train_files, self.train_labels, plan["files"])
        return self._transform(x, y, plan["draws"])

    def next_train_batch(self, count: int) -> Dict[str, np.ndarray]:
        return self.materialize(self.plan_train_batch(count))

    def next_val_batch(self, count: int) -> Dict[str, np.ndarray]:
        """The centre window of this rank's block.  A step with fewer files
        than ranks (fewer val files than ranks) is a short global batch,
        trimmed to a multiple of ``size`` rows and split evenly."""
        if self.synthetic:
            return self._augment(self._synth_x, self._synth_y, train=False)
        i = self._val_ptr % self.n_batch_val
        self._val_ptr += 1
        idx = [j for j in self._local_files(i * self.size)
               if j < len(self.val_files)]
        per = len(idx) * self.batch_size // self.size
        if per <= 0:
            raise ValueError(f"{len(idx) * self.batch_size} val images can't "
                             f"split across {self.size} ranks")
        lo, hi = self.rank * per, (self.rank + 1) * per
        first = lo // self.batch_size
        last = (hi - 1) // self.batch_size
        x, y = self._load(self.val_files, self.val_labels,
                          idx[first:last + 1])
        off = lo - first * self.batch_size
        return self._augment(x[off:off + per], y[off:off + per], train=False)

    def _load(self, files, labels, idx):
        """Files ``idx`` (indices into ``files``) as one batch in its stored
        layout (c01b made NHWC), and their labels."""
        xs = [self._to_input(_load_batch_file(files[j])) for j in idx]
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        y = np.concatenate([labels[j * self.batch_size:
                                   (j + 1) * self.batch_size] for j in idx])
        return x, y.astype(np.int32)

    @staticmethod
    def _to_input(x: np.ndarray) -> np.ndarray:
        """A loaded batch as the augment pass takes it: NHWC or bc01 as
        stored (the fused pass transposes bc01 itself), c01b made NHWC."""
        if native.is_nchw(x):
            return x
        if _is_c01b(x):
            return np.ascontiguousarray(x.transpose(3, 1, 2, 0))
        return x

    @staticmethod
    def _hw_of(x: np.ndarray):
        return (int(x.shape[2]), int(x.shape[3])) if native.is_nchw(x) \
            else (int(x.shape[1]), int(x.shape[2]))

    @staticmethod
    def _mean_to_hwc(m: np.ndarray) -> np.ndarray:
        """A 3-D mean image as (H, W, C)."""
        if m.shape[-1] in (1, 3):
            return m
        if m.shape[0] in (1, 3):      # CHW (the reference's c01 mean)
            return np.ascontiguousarray(m.transpose(1, 2, 0))
        return m

    def _draw(self, n: int, h: int, w: int, train: bool):
        """Crop/mirror draws for the GLOBAL batch of ``n`` images: one
        shared, or one per image under ``aug_per_image``; the centre
        window at validation."""
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

    def _augment(self, x: np.ndarray, y: np.ndarray,
                 train: bool) -> Dict[str, np.ndarray]:
        h, w = self._hw_of(x)
        return self._transform(x, y, self._draw(x.shape[0], h, w, train))

    def _transform(self, x: np.ndarray, y: np.ndarray,
                   draws) -> Dict[str, np.ndarray]:
        """Stateless tail of the augmentation: ``x`` holds this rank's rows
        (NHWC or bc01); per-image draws cover the global batch, of which
        this rank takes its block."""
        oy, ox, flip = draws
        if oy.shape[0] > 1 and oy.shape[0] != x.shape[0]:
            rows = self._rows()
            oy, ox, flip = oy[rows], ox[rows], flip[rows]
        h, w = self._hw_of(x)
        c = self.crop
        if int(oy.max()) + c > h or int(ox.max()) + c > w:
            raise ValueError(f"crop window ({int(oy.max())},{int(ox.max())})"
                             f"+{c} exceeds the loaded batch's {h}x{w}: "
                             f"batch files of different sizes?")
        y = np.ascontiguousarray(y, dtype=np.int32)
        if self.wire_u8:
            return {"x": self._crop_u8(x, oy, ox, flip), "y": y}
        mean, mean_scalar = None, 0.0
        m_img = self.img_mean
        if isinstance(m_img, np.ndarray) and m_img.size > 1:
            if m_img.ndim == 3:
                full = self._mean_to_hwc(m_img)
                if oy.shape[0] == 1:
                    mean = full[oy[0]:oy[0] + c, ox[0]:ox[0] + c, :]
                else:
                    # per-image windows: the mean image's centre window for
                    # all (a window-exact mean per image would defeat the
                    # fused pass)
                    cy, cx = (h - c) // 2, (w - c) // 2
                    mean = full[cy:cy + c, cx:cx + c, :]
            else:
                # a per-channel mean, broadcast to the window
                n_chan = x.shape[1] if native.is_nchw(x) else x.shape[-1]
                mean = np.broadcast_to(
                    np.asarray(m_img, np.float32).reshape(-1)[:n_chan],
                    (c, c, n_chan))
        else:
            mean_scalar = float(m_img)
        out = native.augment_batch(x, oy, ox, flip, c, mean=mean,
                                   mean_scalar=mean_scalar,
                                   n_threads=self.aug_threads)
        return {"x": out, "y": y}

    def _crop_u8(self, x, oy, ox, flip) -> np.ndarray:
        """``aug_wire_u8``: only crop and mirror on the host (a gather), the
        uint8 NHWC window; cast and mean happen on the card, where the mean
        is always the mean image's CENTRE window (``ModelBase.stage_input``):
        bit-equal to the float32 pass for a scalar mean and for
        ``aug_per_image``, the JAX package's documented deviation for a
        shared window with a full mean image."""
        c = self.crop
        if native.is_nchw(x):
            x = x.transpose(0, 2, 3, 1)       # a view: the gather copies
        if oy.shape[0] == 1:
            win = x[:, oy[0]:oy[0] + c, ox[0]:ox[0] + c, :]
            return np.ascontiguousarray(win[:, :, ::-1, :] if flip[0]
                                        else win)
        out = np.empty((x.shape[0], c, c, x.shape[3]), np.uint8)
        for i in range(x.shape[0]):
            win = x[i, oy[i]:oy[i] + c, ox[i]:ox[i] + c, :]
            out[i] = win[:, ::-1, :] if flip[i] else win
        return out
