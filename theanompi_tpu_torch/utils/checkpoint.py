"""Checkpoint / resume.

Counterpart of ``theanompi_tpu/utils/checkpoint.py``, without JAX: the same
files in the same formats.  A checkpoint of epoch ``e`` in ``ckpt_dir`` is

* ``ckpt_epoch{e}.npz``: every leaf of every state part, as
  ``{part}__{i}`` (``i`` in the part's leaf order), the generator states
  as ``_rngstate__{name}`` and the array entries of the data cursor as
  ``_cursor__{key}``;
* ``ckpt_epoch{e}.json``: the sidecar (epoch, count, the parts, the
  scalar cursor entries, whatever the caller adds);
* ``params_epoch{e}/``: optionally, the reference-style snapshot, one
  ``.npy`` per parameter leaf;
* ``LATEST``: the newest epoch, written last.

The one difference from the JAX package's files: where it stores PRNG keys
(``_rngkey__{name}``), the port stores torch generator states.

**Crash atomicity.** Every file is written to a temporary, fsynced and
installed with ``os.replace``, so a kill at any point leaves the old file
or the new one.  :func:`latest_epoch` checks its candidate (the zip
directory opens, the sidecar parses) and falls back to the newest valid
epoch, so a damaged latest checkpoint costs an epoch, never a resume.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from .helper_funcs import leaf_paths, tree_leaves, tree_map


def _fsync_write(path: str, write_fn) -> None:
    """``write_fn(fh)`` into ``path + '.tmp'``, fsync, ``os.replace``: a
    kill at any point leaves the old complete file or the new one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_valid(ckpt_dir: str, epoch: int) -> bool:
    """True when the epoch's ``.npz`` opens as a complete zip and its
    ``.json`` sidecar parses."""
    base = os.path.join(ckpt_dir, f"ckpt_epoch{epoch}")
    try:
        with np.load(base + ".npz") as z:
            z.files          # forces the central-directory read
        with open(base + ".json") as f:
            json.load(f)
    except Exception:
        return False
    return True


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_params(params, snapshot_dir: str) -> None:
    """A parameter tree as one ``.npy`` per leaf, named by its path
    (``conv1_w.npy``): the reference's per-layer snapshot."""
    os.makedirs(snapshot_dir, exist_ok=True)
    for path, leaf in zip(leaf_paths(params), tree_leaves(params)):
        name = "_".join(str(k) for k in path)
        np.save(os.path.join(snapshot_dir, f"{name}.npy"), _host(leaf))


def save_checkpoint(ckpt_dir: str, step_state: Dict[str, Any], epoch: int,
                    count: int,
                    rng_states: Optional[Dict[str, torch.Tensor]] = None,
                    cursor: Optional[Dict[str, Any]] = None,
                    params_npy: Optional[Any] = None,
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write epoch ``epoch``'s checkpoint; returns the ``.npz`` path.

    ``step_state``: part name → tree (tensors, arrays or Python numbers);
    ``rng_states``: name → a torch generator's ``get_state()``;
    ``cursor``: JSON-able scalars and numpy arrays (the arrays go into the
    ``.npz``); ``params_npy``: a params tree for the per-leaf snapshot."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_epoch{epoch}")
    flat: Dict[str, np.ndarray] = {}
    for key, tree in step_state.items():
        for i, leaf in enumerate(tree_leaves(tree)):
            flat[f"{key}__{i}"] = _host(leaf)
    meta: Dict[str, Any] = {"epoch": epoch, "count": count,
                            "keys": sorted(step_state)}
    if extra_meta:
        meta.update(extra_meta)
    if rng_states:
        meta["rng"] = sorted(rng_states)
        for name, st in rng_states.items():
            flat[f"_rngstate__{name}"] = _host(st)
    if cursor:
        meta_cursor: Dict[str, Any] = {}
        for k, v in cursor.items():
            if isinstance(v, np.ndarray):
                flat[f"_cursor__{k}"] = v
            else:
                meta_cursor[k] = v
        meta["cursor"] = meta_cursor
    # arrays, then the sidecar, then LATEST: each step atomic, LATEST the
    # commit point; an epoch left incomplete fails checkpoint_valid
    _fsync_write(path + ".npz", lambda f: np.savez(f, **flat))
    _fsync_write(path + ".json", lambda f: f.write(json.dumps(meta).encode()))
    if params_npy is not None:
        save_params(params_npy, os.path.join(ckpt_dir, f"params_epoch{epoch}"))
    _write_latest(ckpt_dir, epoch)
    return path + ".npz"


def load_checkpoint(ckpt_dir: str, template: Dict[str, Any],
                    epoch: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The state parts shaped like ``template`` (part → tree whose leaves
    have a ``shape``, or are Python numbers), as trees of numpy arrays;
    None when there is no checkpoint.  Also ``_meta`` (the sidecar),
    ``_rng_states`` (name → generator state tensor) and ``_cursor`` (the
    scalar and array entries merged) when they were saved.  A leaf whose
    shape differs from the template's raises."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            return None
    path = os.path.join(ckpt_dir, f"ckpt_epoch{epoch}.npz")
    if not os.path.exists(path):
        return None
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key, tree in template.items():
            it = iter(range(len(tree_leaves(tree))))

            def take(leaf):
                i = next(it)
                arr = data[f"{key}__{i}"]
                want = getattr(leaf, "shape", None)
                if want is not None and tuple(arr.shape) != tuple(want):
                    raise ValueError(
                        f"incompatible checkpoint: '{key}' leaf {i} has "
                        f"shape {tuple(arr.shape)}, expected {tuple(want)}: "
                        f"written by another model, strategy or worker "
                        f"count")
                return arr

            out[key] = tree_map(take, tree)
        with open(os.path.join(ckpt_dir, f"ckpt_epoch{epoch}.json")) as f:
            meta = json.load(f)
        out["_meta"] = meta
        if "rng" in meta:
            out["_rng_states"] = {
                name: torch.from_numpy(data[f"_rngstate__{name}"].copy())
                for name in meta["rng"]}
        if "cursor" in meta:
            cursor = dict(meta["cursor"])
            prefix = "_cursor__"
            for k in data.files:
                if k.startswith(prefix):
                    cursor[k[len(prefix):]] = data[k]
            out["_cursor"] = cursor
    return out


def peek_meta(ckpt_dir: str,
              epoch: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The sidecar alone (layout flags, epoch, count): lets a loader shape
    its template before it reads the arrays."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            return None
    path = os.path.join(ckpt_dir, f"ckpt_epoch{epoch}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The newest VALID epoch: the ``LATEST`` pointer when its checkpoint
    passes :func:`checkpoint_valid`, else the epochs on disk newest first."""
    candidates: list = []
    latest = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(latest):
        try:
            with open(latest) as f:
                candidates.append(int(f.read().strip()))
        except (ValueError, OSError):
            pass                  # a torn pointer: the scan decides
    if os.path.isdir(ckpt_dir):
        epochs = [int(f[len("ckpt_epoch"):-4]) for f in os.listdir(ckpt_dir)
                  if f.startswith("ckpt_epoch") and f.endswith(".npz")]
        candidates.extend(sorted(epochs, reverse=True))
    seen = set()
    for ep in candidates:
        if ep in seen:
            continue
        seen.add(ep)
        if checkpoint_valid(ckpt_dir, ep):
            if ep != candidates[0]:
                print(f"checkpoint: epoch {candidates[0]} is damaged or "
                      f"incomplete; resuming from the newest valid epoch "
                      f"{ep}", file=sys.stderr, flush=True)
            return ep
    return None


def _write_latest(ckpt_dir: str, epoch: int) -> None:
    _fsync_write(os.path.join(ckpt_dir, "LATEST"),
                 lambda f: f.write(str(epoch).encode()))
