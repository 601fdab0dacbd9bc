"""Train and validation steps.

Counterpart of ``theanompi_tpu/parallel/steps.py``.  The JAX package traced
the whole step — micro-batch scan, backward, exchange, update — into one XLA
program over the worker mesh.  The port runs one process per rank and the
same sequence eagerly: forward and backward for each of ``n_subb``
micro-batches, the exchanger's gradient collective, the optimizer update in
place.  Nothing in a step reads a device value back to the host, so the
card's queue stays full; the per-step metrics stay on the device until the
recorder prints them.

Batches reach the card through :func:`put_batch`: on the step's thread
from pageable memory, or, under ``para_load``, from the loader's producer
through a :class:`PinnedStager` (pinned buffers, a side stream, an event
the step's stream waits on in :func:`claim`).
"""

from __future__ import annotations

import queue
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.helper_funcs import tree_leaves, tree_map


def step_generator(seed: int, rank: int, count: int,
                   device: torch.device) -> torch.Generator:
    """The dropout stream of one step on one rank, seeded from
    ``(seed, rank, count)`` — the role of the JAX step's
    ``fold_in(fold_in(key, rank), count)``.  The bits differ from JAX's."""
    s = np.random.SeedSequence([int(seed), int(rank), int(count)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen


def _like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _accumulate_grads(loss_and_metrics: Callable, params, batch,
                      gen, n_subb: int):
    """Gradient accumulation over ``n_subb`` micro-batches, in order.

    ``loss_and_metrics(params, batch, gen, train=True)`` returns
    ``(cost, err)``.  Returns the mean cost, mean error and mean gradient
    tree (detached)."""
    leaves = tree_leaves(params)
    if n_subb == 1:
        cost, err = loss_and_metrics(params, batch, gen, True)
        grads = torch.autograd.grad(cost, leaves)
        return cost.detach(), err.detach(), _like(params, grads)

    def micro(x, i):
        if x.shape[0] % n_subb:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"n_subb={n_subb}")
        m = x.shape[0] // n_subb
        return x[i * m:(i + 1) * m]

    acc = [torch.zeros_like(p, requires_grad=False) for p in leaves]
    acc_c = acc_e = 0.0
    for i in range(n_subb):
        mb = {k: micro(v, i) for k, v in batch.items()}
        cost, err = loss_and_metrics(params, mb, gen, True)
        for a, g in zip(acc, torch.autograd.grad(cost, leaves)):
            a.add_(g)
        acc_c = acc_c + cost.detach()
        acc_e = acc_e + err.detach()
    inv = 1.0 / n_subb
    for a in acc:
        a.mul_(inv)
    return acc_c * inv, acc_e * inv, _like(params, acc)


def _mean_over_ranks(t: torch.Tensor, size: int) -> torch.Tensor:
    dist.all_reduce(t)
    return t / size


def build_train_step(model, exchanger) -> Callable:
    """``train_fn(batch, lr, count) -> (cost, err)``: one step of this rank,
    updating ``model.params``, ``model.opt_state`` and ``model.extra`` (the
    exchanger's per-rank state).  The returned metrics are means over the
    ranks, device scalars."""
    n_subb = int(getattr(model, "n_subb", 1))
    size = exchanger.size

    def train_fn(batch: Dict[str, torch.Tensor], lr: float, count: int):
        gen = step_generator(model.step_seed, model.rank, count,
                             model.device)
        cost, err, grads = _accumulate_grads(
            model.loss_and_metrics, model.params, batch, gen, n_subb)
        model.params, model.opt_state, model.extra = exchanger.step_update(
            model.params, model.opt_state, grads, model.extra, lr)
        m = _mean_over_ranks(torch.stack([cost, err]), size)
        return m[0], m[1]

    return train_fn


def build_val_step(model) -> Callable:
    """``val_fn(batch) -> (cost, err, err_top5)``: this rank's rows scored
    with its replica, averaged over the ranks."""
    size = dist.get_world_size()

    @torch.no_grad()
    def val_fn(batch: Dict[str, torch.Tensor]):
        cost, (err, err5) = model.val_metrics(model.params, batch)
        m = _mean_over_ranks(torch.stack([cost, err, err5]), size)
        return m[0], m[1], m[2]

    return val_fn


class DeviceBatch(dict):
    """A batch already on its device: tensors, and ``ready``, the CUDA event
    recorded after their host → device copies (None on the CPU)."""

    def __init__(self, tensors, ready=None):
        super().__init__(tensors)
        self.ready = ready


class PinnedStager:
    """Host → card staging off the step's thread (``para_load``'s producer).

    A ring of ``slots`` pinned host buffers (one per batch leaf) and a side
    CUDA stream of its own: :meth:`stage` copies a host batch into a free
    slot's pinned buffers, issues ``non_blocking`` copies to the card on the
    side stream, records an event after them and returns a
    :class:`DeviceBatch` carrying it.  A slot is written again only after
    its last copy's event has completed: the host waits on that event
    first, so a later batch can never overwrite bytes still in flight.
    Safe to call from several threads at once (each takes a slot of its
    own; the stream, the device and the event are set per call, since the
    current CUDA device and stream are per thread)."""

    def __init__(self, device: torch.device, slots: int = 3):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._free: "queue.Queue[dict]" = queue.Queue()
        for _ in range(max(1, int(slots))):
            self._free.put({"bufs": {}, "event": None})

    def stage(self, batch: Dict[str, np.ndarray]) -> DeviceBatch:
        slot = self._free.get()
        try:
            if slot["event"] is not None:
                slot["event"].synchronize()   # its last copy has completed
            out = {}
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                for k, a in batch.items():
                    src = torch.from_numpy(np.ascontiguousarray(a))
                    buf = slot["bufs"].get(k)
                    if buf is None or buf.shape != src.shape or \
                            buf.dtype != src.dtype:
                        buf = torch.empty(src.shape, dtype=src.dtype,
                                          pin_memory=True)
                        slot["bufs"][k] = buf
                    # a NumPy copy: one thread, the GIL released
                    np.copyto(buf.numpy(), src.numpy())
                    out[k] = buf.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            slot["event"] = ev
            return DeviceBatch(out, ev)
        finally:
            self._free.put(slot)


def put_batch(batch: Dict[str, np.ndarray], device: torch.device,
              stager: Optional[PinnedStager] = None):
    """Host batch → tensors on ``device``: on the CPU ``torch.from_numpy``
    (no copy); through ``stager`` (a :class:`DeviceBatch`, to be taken
    with :func:`claim`); else a synchronous copy from pageable memory."""
    if device.type == "cpu":
        return DeviceBatch({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in batch.items()})
    if stager is not None:
        return stager.stage(batch)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def is_device_batch(batch) -> bool:
    """True if the batch is already staged (by the parallel loader's
    producer): ``train_iter`` then takes it through :func:`claim`."""
    return isinstance(batch, DeviceBatch)


def claim(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A staged batch as the step's tensors: on the card the current
    (compute) stream waits on the staging copies' event, and each tensor is
    marked used by that stream, so the caching allocator does not hand its
    memory to another allocation of the side stream while the step still
    reads it."""
    ready = getattr(batch, "ready", None)
    if ready is not None:
        s = torch.cuda.current_stream(device)
        s.wait_event(ready)
        for t in batch.values():
            t.record_stream(s)
    return dict(batch)
