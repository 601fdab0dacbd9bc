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

Model parallelism (``pp``, ``tp`` and ``sp`` in the config) makes the world
a grid of ``n_workers`` × ``pp`` × ``tp`` × ``sp`` ranks, in the JAX mesh's
axis order (``theanompi_tpu/parallel/mesh.py:98-102``): ``workers``
outermost, then ``pipe``, ``model``, ``seq`` innermost.  :class:`Grid` is a
rank's place in it and its three model-parallel groups; the default process
group is the rank's ``workers`` group (the ranks of its pipe, model and seq
coordinate), so every exchange, metric and checkpoint collective runs over
the data-parallel workers alone, and ``rank`` and ``size`` stay the JAX
package's data-parallel ones.
"""

from __future__ import annotations

import importlib
import time
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


def _subgroup(store, rank: int, size: int, device: torch.device):
    """A process group of ``size`` ranks over ``store``, outside the default
    group: gloo on the CPU, NCCL on the card.  The model-parallel layers
    call its methods (``allreduce``, ``allgather``, ``send``, ``recv``)
    directly."""
    if device.type == "cuda":
        return dist.ProcessGroupNCCL(store, rank, size)
    return dist.ProcessGroupGloo(store, rank, size)


class Grid:
    """A rank's place in the ``dp × pp × tp × sp`` world: its ``(worker,
    pipe, model, seq)`` coordinate, world rank ``((worker·pp + pipe)·tp +
    model)·sp + seq``, and its ``pipe``, ``model`` and ``seq`` groups
    (process groups of ``pp``, ``tp`` and ``sp`` ranks: the ranks that
    differ from it in that coordinate alone; None where the degree is 1).
    The ``workers`` group is the default one."""

    AXES = ("pipe", "model", "seq")

    def __init__(self, dp: int, tp: int, sp: int, world_rank: int,
                 pp: int = 1):
        self.dp, self.tp, self.sp = int(dp), int(tp), int(sp)
        self.pp = int(pp)
        self.world = self.dp * self.pp * self.tp * self.sp
        if not 0 <= world_rank < self.world:
            raise ValueError(f"rank {world_rank} outside the world of "
                             f"{self.dp} workers × pp {self.pp} × tp "
                             f"{self.tp} × sp {self.sp}")
        self.world_rank = int(world_rank)
        self.worker, rem = divmod(self.world_rank,
                                  self.pp * self.tp * self.sp)
        self.pipe, rem = divmod(rem, self.tp * self.sp)
        self.model, self.seq = divmod(rem, self.sp)
        self.pipe_group = self.model_group = self.seq_group = None

    def size(self, axis: str) -> int:
        """The degree of a grid axis (``pipe``, ``model`` or ``seq``)."""
        return {"pipe": self.pp, "model": self.tp, "seq": self.sp}[axis]

    def group(self, axis: str):
        """The process group of a grid axis (None at degree 1)."""
        return getattr(self, f"{axis}_group")

    def shard_of(self, pipe: int, model: int, seq: int) -> int:
        """The index of the ``(pipe, model, seq)`` coordinate among a
        worker's ``pp·tp·sp`` ranks (the JAX mesh's order, seq
        innermost): where its block sits in a state joined over them."""
        return (pipe * self.tp + model) * self.sp + seq

    @property
    def shard(self) -> int:
        """This rank's :meth:`shard_of`."""
        return self.shard_of(self.pipe, self.model, self.seq)

    @property
    def lead(self) -> bool:
        """Pipe 0, model 0, seq 0: the coordinate whose workers write what
        the world holds once (a checkpoint of global arrays)."""
        return self.pipe == 0 and self.model == 0 and self.seq == 0

    def barrier(self) -> None:
        """Wait until world rank 0 has come here: over the workers group,
        then the pipe, model and seq groups, so that a rank passes only
        after its worker's pipe 0, model 0, seq 0 rank has, and that one
        only after world rank 0 has."""
        dist.barrier()
        for axis in self.AXES:
            g = self.group(axis)
            if g is not None:
                g.barrier().wait()

    def join(self, store, device: torch.device) -> None:
        """Make this rank's pipe, model and seq groups over the world's
        store."""
        w, p, m, s = self.worker, self.pipe, self.model, self.seq
        for axis, rest in (("pipe", f"w{w}.m{m}.s{s}"),
                           ("model", f"w{w}.p{p}.s{s}"),
                           ("seq", f"w{w}.p{p}.m{m}")):
            if self.size(axis) > 1:
                setattr(self, f"{axis}_group", _subgroup(
                    dist.PrefixStore(f"{axis}.{rest}/", store),
                    getattr(self, axis), self.size(axis), device))


def model_parallel_degrees(config: dict) -> tuple:
    """``(tp, sp, pp)`` of a config."""
    return (int(config.get("tp", 1)), int(config.get("sp", 1)),
            int(config.get("pp", 1)))


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
        self.grid: Optional[Grid] = None
        self._owns_group = False

    def get_internode_comm(self, group_size: Optional[int] = None):
        """Join (or create) the process group and bind this rank's device.
        Sets ``rank``, ``size`` and ``device`` in the shared config.

        With ``group_size`` ``K`` the world of ``n_workers`` ranks splits
        into groups of ``K`` consecutive ranks (an async island each): world
        rank ``r`` joins group ``r // K`` as its rank ``r % K``, over the
        ``init_method``'s store under the group's prefix.  ``rank`` and
        ``size`` are then the group's; ``world_rank``, ``group`` and
        ``store`` (the whole world's) are kept.

        With ``pp``, ``tp`` or ``sp`` above 1 the world is the grid of
        ``n_workers`` × pp × tp × sp ranks (``rank`` names a world rank):
        this rank joins its ``workers`` group as the default group, and its
        pipe, model and seq groups (:class:`Grid`, ``config['grid']``)."""
        tp, sp, pp = model_parallel_degrees(self.config)
        if tp * sp * pp > 1:
            if group_size is not None:
                raise NotImplementedError(
                    "islands of a model-parallel world are not ported")
            return self._join_grid(tp, sp, pp)
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

    def _join_grid(self, tp: int, sp: int, pp: int) -> None:
        n = int(self.config.get("n_workers") or 1)
        grid = Grid(n, tp, sp, int(self.config.get("rank", 0)), pp=pp)
        self.world_rank = grid.world_rank
        self.device = self.init_device()
        if dist.is_initialized():
            raise RuntimeError("a process group exists; a model-parallel "
                               "world makes its own")
        init = self.config.get("init_method")
        if not init:
            raise ValueError(f"a world of {grid.world} ranks (pp={pp}, "
                             f"tp={tp}, sp={sp}) needs config 'init_method' "
                             f"(tcp://localhost:<port> or file:///<path>)")
        self.store, _, _ = next(dist.rendezvous(
            str(init), rank=grid.world_rank, world_size=grid.world))
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        dist.init_process_group(
            backend=backend, rank=grid.worker, world_size=n,
            store=dist.PrefixStore(
                f"workers.p{grid.pipe}.m{grid.model}.s{grid.seq}/",
                self.store))
        self._owns_group = True
        grid.join(self.store, self.device)
        self.grid = grid
        self.rank, self.size = grid.worker, n
        self.verbose = self.verbose and self.world_rank == 0
        self.config.update(rank=self.rank, size=self.size,
                           device=str(self.device), verbose=self.verbose,
                           grid=grid)

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
        self.grid = None

    def build_model(self, modelfile: str, modelclass: str):
        """Import the model by dotted module path + class name."""
        mod = importlib.import_module(modelfile)
        model = getattr(mod, modelclass)(self.config)
        self.t_model_built = time.time()      # the worker's start-up record
        return model
