"""Process/runtime core.

Counterpart of ``theanompi_tpu/base.py``.  The reference's
``MPI_GPU_Process`` did MPI init, bound a GPU and imported the model by
dotted path; the JAX package drove every local chip from one process over a
mesh.  The port is back to one process per GPU: :class:`MeshProcess` joins a
``torch.distributed`` group (NCCL on the card, gloo on the CPU) and binds
``cuda:{local_rank}``.

World size 1 goes through a real group too, over an in-memory ``HashStore``,
so no port is opened.  Larger worlds name their rendezvous in the config:
``init_method`` (``tcp://localhost:<port>`` or ``file:///<path>``), ``rank``
and ``n_workers``.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch
import torch.distributed as dist


def resolve_device(config: dict) -> torch.device:
    """The device a config names: ``cuda`` by default, ``cuda`` without an
    index meaning ``cuda:{local_rank}`` (``local_rank`` defaults to the
    rank), or ``cpu``.  Raises when CUDA is wanted and absent."""
    dev = torch.device(config.get("device", "cuda"))
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device(
            "cuda", int(config.get("local_rank", config.get("rank", 0))))
    return dev


class MeshProcess:
    """≙ reference ``MPI_GPU_Process``."""

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.verbose: bool = self.config.get("verbose", True)
        self.rank = 0
        self.size = 1
        self.device = None
        self._owns_group = False

    def get_internode_comm(self):
        """Join (or create) the process group and bind this rank's device.
        Sets ``rank``, ``size`` and ``device`` in the shared config."""
        self.size = int(self.config.get("n_workers") or 1)
        self.rank = int(self.config.get("rank", 0))
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside world {self.size}")
        self.device = self.init_device()
        if dist.is_initialized():
            if dist.get_world_size() != self.size or \
                    dist.get_rank() != self.rank:
                raise RuntimeError(
                    f"a process group of world {dist.get_world_size()} "
                    f"rank {dist.get_rank()} exists; this worker wants "
                    f"world {self.size} rank {self.rank}")
        else:
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            kw = dict(backend=backend, rank=self.rank, world_size=self.size)
            if self.config.get("init_method"):
                kw["init_method"] = self.config["init_method"]
            elif self.size == 1:
                kw["store"] = dist.HashStore()
            else:
                raise ValueError("n_workers > 1 needs config 'init_method' "
                                 "(tcp://localhost:<port> or file:///<path>)")
            dist.init_process_group(**kw)
            self._owns_group = True
        self.config.update(rank=self.rank, size=self.size,
                           device=str(self.device),
                           verbose=self.verbose and self.rank == 0)

    def init_device(self) -> torch.device:
        """This rank's device (:func:`resolve_device`), bound as the current
        CUDA device."""
        dev = resolve_device(dict(self.config, rank=self.rank))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return dev

    def close(self) -> None:
        """Leave the process group this worker created."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def build_model(self, modelfile: str, modelclass: str):
        """Import the model by dotted module path + class name."""
        mod = importlib.import_module(modelfile)
        return getattr(mod, modelclass)(self.config)
