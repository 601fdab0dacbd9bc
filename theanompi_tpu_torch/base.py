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
and ``n_workers``, and ``local_rank``, the rank's GPU on its host; the
launcher (``launcher.py``) sets all four.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch
import torch.distributed as dist


def resolve_device(config: dict) -> torch.device:
    """The device a config names: ``cuda`` by default, ``cuda`` without an
    index meaning ``cuda:{local_rank}`` (the launcher sets ``local_rank``,
    the rank's index on its host; it defaults to the rank), or ``cpu``.
    Raises when CUDA is wanted and absent, and when the index is past the
    visible GPUs."""
    dev = torch.device(config.get("device", "cuda"))
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    what = f"device {dev}"
    if dev.index is None:
        dev = torch.device(
            "cuda", int(config.get("local_rank", config.get("rank", 0))))
        what = f"local_rank {dev.index}"
    n = torch.cuda.device_count()
    if dev.index >= n:
        raise RuntimeError(
            f"{what} asks for cuda:{dev.index}, and this host has {n} "
            f"visible GPU{'' if n == 1 else 's'}: one GPU a rank")
    return dev


class MeshProcess:
    """≙ reference ``MPI_GPU_Process``."""

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.verbose: bool = self.config.get("verbose", True)
        self.rank = 0
        self.size = 1
        self.device = None
        # a world split into groups (``get_internode_comm(group_size)``):
        # this rank's index in the world, its group's, and the world's store
        self.world_rank = 0
        self.group = 0
        self.store = None
        self._owns_group = False

    def get_internode_comm(self, group_size: Optional[int] = None):
        """Join (or create) the process group and bind this rank's device.
        Sets ``rank``, ``size`` and ``device`` in the shared config.

        With ``group_size`` ``K`` the world of ``n_workers`` ranks splits
        into groups of ``K`` consecutive ranks (an async island each): world
        rank ``r`` joins group ``r // K`` as its rank ``r % K``, over the
        ``init_method``'s store under the group's prefix.  ``rank`` and
        ``size`` are then the group's; ``world_rank``, ``group`` and
        ``store`` (the whole world's) are kept."""
        n = int(self.config.get("n_workers") or 1)
        self.world_rank = int(self.config.get("rank", 0))
        if not 0 <= self.world_rank < n:
            raise ValueError(f"rank {self.world_rank} outside world {n}")
        k = int(group_size or n)
        if n % k:
            raise ValueError(f"{n} ranks do not split into groups of {k}")
        self.group, self.rank = divmod(self.world_rank, k)
        self.size = k
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
            init = self.config.get("init_method")
            if group_size is not None and init:
                self.store, _, _ = next(dist.rendezvous(
                    str(init), rank=self.world_rank, world_size=n))
                kw["store"] = dist.PrefixStore(f"group{self.group}/",
                                               self.store)
            elif init:
                kw["init_method"] = init
            elif n == 1:
                kw["store"] = dist.HashStore()
            else:
                raise ValueError("n_workers > 1 needs config 'init_method' "
                                 "(tcp://localhost:<port> or file:///<path>)")
            dist.init_process_group(**kw)
            self._owns_group = True
        self.verbose = self.verbose and self.world_rank == 0
        self.config.update(rank=self.rank, size=self.size,
                           device=str(self.device), verbose=self.verbose)

    def init_device(self) -> torch.device:
        """This rank's device (:func:`resolve_device`), bound as the current
        CUDA device."""
        dev = resolve_device(dict(self.config, rank=self.world_rank))
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
