"""Train and validation steps.

Counterpart of ``theanompi_tpu/parallel/steps.py``.  The JAX package traced
the whole step — micro-batch scan, backward, exchange, update — into one XLA
program over the worker mesh, and ``steps_per_call`` scanned k such steps
in one dispatch.  The port runs one process per rank and the same sequence
in one step body: forward and backward for each of ``n_subb``
micro-batches (the BatchNorm running state updated in order through
them), the exchanger's gradient collective, the optimizer update, the
model's update hook (``ModelBase.postprocess_update``), the exchanger's
``sync_bn`` of the running state, all in place on the model's
state, then one all-reduce of the step's metrics (none in an async
island's step, whose ``exchanger.LocalExchanger`` has no process group).
:class:`TrainStep` runs
``n_steps`` bodies over a ``[k, ...]`` window per call; under an async
rule each step of a window whose count is due ends with the rule's
exchange (the JAX package's in-scan ``lax.cond``), and at one step a call
:class:`ExchangeStep` runs it after the step, from the worker's hook.

On the card the step is CAPTURED (``parallel/graph.py``): the first call
runs its step eagerly on a side stream (which also warms up cuBLAS, cuDNN
and NCCL), then records the body into a CUDA graph over static input
buffers, and every later call copies its batch into those buffers, sets
the learning rate and the dropout seeds, and replays the graph: one
launch for the whole step, its all-reduces included.  The counterpart of
the JAX step's traced inputs are device tensors the graph reads: the
learning rate (0-d float32, refilled when the schedule moves), Adam's
and the EMA's step counts, the step counts a model's update hook reads
(``ModelBase.postprocess_update``: the GANs' ``n_critic`` gate, refilled
before each call), and the dropout generators (and GoSGD's
send-gate generators), re-seeded from ``(seed, rank, count)`` before each
replay.  A window whose fused exchanges fall on other steps (its first
count's phase against ``exchange_freq``) replays a graph of its own; the
predicate is the host's, never a branch inside a capture.  A step that
cannot be captured raises
(:class:`graph.CaptureError`); ``capture=False`` builds the eager step
instead, explicitly (the reference the captured step is held to, and the
CPU's path).  Nothing in a step reads a device value back to the host;
the metrics stay on the device until the recorder prints them.

Batches reach the card through :func:`put_batch`: on the step's thread
from pageable memory, or, under ``para_load``, from the loader's producer
through a :class:`PinnedStager` (pinned buffers, a side stream, an event
the step's stream waits on in :func:`claim`); a captured step then copies
the staged batch into its static buffers on the device.
"""

from __future__ import annotations

import queue
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import numerics
from ..utils.helper_funcs import tree_leaves, tree_map
from . import graph as graph_lib


def step_seed(*keys: int) -> int:
    """A 63-bit seed from integer keys: the dropout seed of one step on
    one rank from ``(seed, rank, count)`` — the role of the JAX step's
    ``fold_in(fold_in(key, rank), count)``, whose bits differ — and GoSGD's
    draws from keys of their own."""
    s = np.random.SeedSequence([int(k) for k in keys])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _accumulate_grads(loss_and_metrics: Callable, params, bn_state, batch,
                      gen, n_subb: int, out=None):
    """Gradient accumulation over ``n_subb`` micro-batches, in order.

    ``loss_and_metrics(params, bn_state, batch, gen, train=True)`` returns
    ``(cost, err)`` and updates ``bn_state`` in place, so the running state
    threads through the micro-batches in order, as the JAX package's scan
    carries it.  Returns the mean cost, mean error and mean gradient tree
    (detached); ``out`` (tensors shaped like the leaves, FSDP's views of
    its flat gradient) receives the gradient, and is the returned tree's
    leaves."""
    leaves = tree_leaves(params)
    if n_subb == 1:
        cost, err = loss_and_metrics(params, bn_state, batch, gen, True)
        grads = torch.autograd.grad(cost, leaves)
        if out is not None:
            torch._foreach_copy_(out, grads)
            grads = out
        return cost.detach(), err.detach(), _like(params, grads)

    def micro(x, i):
        if x.shape[0] % n_subb:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"n_subb={n_subb}")
        m = x.shape[0] // n_subb
        return x[i * m:(i + 1) * m]

    if out is None:
        acc = [torch.zeros_like(p, requires_grad=False) for p in leaves]
    else:
        acc = list(out)
        torch._foreach_zero_(acc)
    acc_c = acc_e = 0.0
    for i in range(n_subb):
        mb = {k: micro(v, i) for k, v in batch.items()}
        cost, err = loss_and_metrics(params, bn_state, mb, gen, True)
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


def stack_host(batches) -> Dict[str, np.ndarray]:
    """The host ``[k, ...]`` stack of k per-step batches: the window layout
    a ``steps_per_call`` step takes.  One definition, shared by the
    ``para_load`` window producer and the step's own staging."""
    return {k: np.stack([np.asarray(b[k]) for b in batches])
            for k in batches[0]}


def _host_or_claimed(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch as tensors where they lie: a staged one claimed for the
    current stream, a host one viewed (``torch.from_numpy``, no copy)."""
    if is_device_batch(batch):
        return claim(batch, device)
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


class _Captured:
    """What a step captured on the card keeps: one CUDA graph per key (a
    window's phase, and the exchanger's active set: a graph freezes the
    membership it was captured under), each with the tensors its capture
    returned and the state tensors it was captured with, and the side
    stream its warm-up and capture run on."""

    def __init__(self):
        self._stream = None
        self._graphs: Dict[object, tuple] = {}   # key -> (graph, out, state)
        self._graph: Optional[graph_lib.StepGraph] = None   # the last used
        self._captured_state = None
        self._capture_secs: list = []            # each capture's seconds

    @property
    def graphed(self) -> bool:
        """True when the step runs as a CUDA graph replay."""
        return self.capture and self.device.type == "cuda"

    def capture_info(self) -> dict:
        """The step's ``compile_info`` entry: a CUDA graph cannot be
        saved, so a captured step says ``not storable`` with the seconds
        its first capture took (None before it), and its captures so far;
        an eager step, ``off``."""
        secs = self._capture_secs
        return {"cache": "not storable" if self.graphed else "off",
                "compile_secs": round(secs[0], 3) if secs else None,
                "captures": len(secs), "storable": False}

    def _state_leaves(self) -> list:
        return [l for part in self.model._state_parts().values()
                for l in tree_leaves(part)]

    def _state_current(self, captured=None) -> bool:
        """A graph reads the state tensors it was captured with (``None``:
        the last used graph's): false once any was replaced (a load that
        had to make new tensors)."""
        captured = self._captured_state if captured is None else captured
        now = self._state_leaves()
        return captured is not None and len(now) == len(captured) and \
            all(a is b for a, b in zip(now, captured))

    def _run_captured(self, key, eager: Callable, static: Callable,
                      gens) -> Optional[torch.Tensor]:
        """A replay of ``key``'s graph while its state is current (its
        outputs cloned: the next replay rewrites them); else this call run
        eagerly on the side stream (its warm-up), then ``static`` captured
        there, drawing from ``gens``."""
        entry = self._graphs.get(key)
        if entry is not None and self._state_current(entry[2]):
            self._graph, out, self._captured_state = entry
            self._graph.replay()
            return None if out is None else out.clone()
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        s = self._stream
        # the eager call and the capture one thread at a time (islands that
        # are threads each capture their own step: graph.CAPTURE_LOCK)
        with graph_lib.CAPTURE_LOCK:
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                out = eager()
            cur.wait_stream(s)
            if out is not None:
                out.record_stream(cur)
            self._graphs.pop(key, None)    # an old graph's pool goes first
            self._graph = None
            g = graph_lib.StepGraph(s, gens)
            captured = g.capture(static)
            self._capture_secs.append(g.capture_secs)
        state = self._state_leaves()
        self._graphs[key] = (g, captured, state)
        self._graph, self._captured_state = g, state
        return out


class TrainStep(_Captured):
    """``step(batch, lr, count) -> (cost[k], err[k])``: ``k = n_steps``
    training steps of this rank over one batch (k = 1) or one ``[k, ...]``
    window, updating ``model.params``, ``model.opt_state``,
    ``model.bn_state`` and ``model.extra`` in place.  ``count`` names the
    window's LAST step, as in the JAX package; step j draws its dropout
    from ``count - k + 1 + j``.
    The metrics are means over the ranks, on the device.

    ``capture`` (default: whether the model's device is a card) makes the
    step static: its inputs are copied into buffers it owns, and on the
    card it runs as a CUDA graph replay.  On the CPU a static step runs
    the same body eagerly over those buffers, which is what the tests
    hold against the eager step."""

    def __init__(self, model, exchanger, n_steps: int = 1,
                 capture: Optional[bool] = None):
        self.model, self.exchanger = model, exchanger
        self.n_steps = int(n_steps)
        if self.n_steps < 1:
            raise ValueError(f"n_steps={n_steps}: a call takes at least one "
                             f"step")
        self.device = torch.device(model.device)
        self.capture = self.device.type == "cuda" if capture is None \
            else bool(capture)
        self.n_subb = int(getattr(model, "n_subb", 1))
        self.size = exchanger.size
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(self.n_steps)]
        # the fused exchange cadence (an async rule at n_steps > 1): step
        # c of a window ends with the rule's exchange when c is due, each
        # step's exchange drawing from a generator of its own
        self._exch = exchanger if exchanger.fused else None
        self._xgens = [torch.Generator(device=self.device)
                       for _ in range(self.n_steps)] \
            if self._exch is not None and exchanger.uses_draws else []
        self._first = 0
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        # the model's update hook reads each step's count on the device:
        # first + arange(n_steps), filled before each call
        self._steps = self._counts = None
        if model.has_update_hook():
            self._steps = torch.arange(self.n_steps, device=self.device)
            self._counts = torch.zeros_like(self._steps)
        self._lr_host = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._stager: Optional[PinnedStager] = None
        # the numerics plane (None when off): the sampled step of the
        # current call (-1: none), its count on the device, this rank's
        # sample and every worker's ([n, len(SAMPLE_KEYS)], the aux)
        self._nx = numerics.graph_plan(model, exchanger)
        self._nx_j = -1
        self.nx_sampled = False
        if self._nx is not None:
            k = len(numerics.SAMPLE_KEYS)
            n = self.size if exchanger.collective else 1
            self._nx_it = torch.zeros((), dtype=torch.float32,
                                      device=self.device)
            self._nx_sample = torch.zeros(k, dtype=torch.float32,
                                          device=self.device)
            self.nx_buf = self._nx_sample.view(1, k) if n == 1 else \
                torch.zeros(n, k, dtype=torch.float32, device=self.device)
        _Captured.__init__(self)

    # -- inputs --------------------------------------------------------------

    def take(self, batch) -> Dict[str, torch.Tensor]:
        """What the data source yielded as this step's inputs: a host batch
        (dict of arrays), a staged one (:class:`DeviceBatch`), either of
        ``[k, ...]`` arrays (a window), or a list of k of them.  A static
        step copies it into its buffers (made at the first call, of the
        first batch's shapes; another shape raises) and returns them, a
        captured one from a host batch through a :class:`PinnedStager` of
        its own; an eager one returns tensors on the device."""
        parts = batch if isinstance(batch, (list, tuple)) else [batch]
        if isinstance(batch, (list, tuple)) and len(parts) != self.n_steps:
            raise ValueError(f"{len(parts)} batches for a step of "
                             f"{self.n_steps}")
        if self.graphed:
            # a host batch goes through pinned buffers, so the copy does
            # not make the host wait for the replay still queued before it
            if self._stager is None:
                self._stager = PinnedStager(self.device, slots=2)
            parts = [b if is_device_batch(b) else
                     put_batch(b, self.device, self._stager) for b in parts]
        tensors = [_host_or_claimed(b, self.device) for b in parts]
        if not self.capture:
            out = tensors[0] if len(tensors) == 1 else \
                {k: torch.stack([t[k] for t in tensors]) for k in tensors[0]}
            return {k: v.to(self.device) for k, v in out.items()}
        lead = (len(tensors),) if len(tensors) > 1 else ()
        if self._static is None:
            self._static = {k: torch.empty(lead + tuple(v.shape),
                                           dtype=v.dtype, device=self.device)
                            for k, v in tensors[0].items()}
        for j, t in enumerate(tensors):
            for k, buf in self._static.items():
                dst = buf[j] if lead else buf
                src = t[k]
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(
                        f"a static step takes {k} of {tuple(dst.shape)} "
                        f"{dst.dtype}, got {tuple(src.shape)} {src.dtype}")
                dst.copy_(src)
        return self._static

    # -- the step ------------------------------------------------------------

    def _body(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``n_steps`` full steps in place; ``[2, n_steps]`` costs and
        errors, means over the ranks.  With the numerics plane, step
        ``self._nx_j`` is sampled (its gradient's statistics before the
        update, a float32 copy of its params before the update, the sample
        after it, before the step's exchange) and the sample is gathered
        over the ranks."""
        m = self.model
        nx, js = self._nx, self._nx_j
        costs, errs = [], []
        for j in range(self.n_steps):
            b = batch if self.n_steps == 1 else \
                {k: v[j] for k, v in batch.items()}
            if m._fsdp is not None:
                cost, err = self._fsdp_step(b, self._gens[j])
            else:
                cost, err, grads = _accumulate_grads(
                    m.loss_and_metrics, m.params, m.bn_state, b,
                    self._gens[j], self.n_subb)
                m.reduce_model_grads(tree_leaves(grads))
                if j == js:
                    gstats = nx.grad_stats(tree_leaves(grads))
                    before = nx.keep_old(tree_leaves(m.params))
                old = m.snapshot_update(m.params, m.opt_state) \
                    if self._counts is not None else None
                self.exchanger.step_update(m.params, m.opt_state, grads,
                                           m.extra, self._lr)
                if self._counts is not None:
                    m.postprocess_update(old, m.params, m.opt_state,
                                         self._counts[j])
            self.exchanger.sync_bn(m.bn_state)
            if j == js:
                nx.compute(before, tree_leaves(m.params), gstats, m.extra,
                           self._nx_it, self._nx_sample)
            c = self._first + j
            if self._exch is not None and c % self._exch.exchange_freq == 0:
                self._exch.exchange_body(
                    c, self._xgens[j] if self._xgens else None)
            costs.append(cost)
            errs.append(err)
        if js >= 0 and self.nx_buf.shape[0] > 1:
            from .update_sharding import all_gather_into
            all_gather_into(self.nx_buf.view(-1), self._nx_sample)
        out = torch.stack(costs + errs)
        if self.exchanger.collective:
            dist.all_reduce(out)
        return out.div_(self.size).view(2, self.n_steps)

    def _fsdp_step(self, batch, gen):
        """One FSDP step (the counterpart of the JAX package's
        ``fsdp_step``), in place: every rank's chunk gathered into the
        buffer the params view, forward and backward over the micro-batches
        into the flat gradient buffer, its reduce-scatter (SUM) times 1/N,
        the global-norm clip of the chunk, and the optimizer's update of the
        chunk.  The caller then runs ``sync_bn``."""
        m = self.model
        fs = m._fsdp
        fs.gather_params()
        cost, err, _ = _accumulate_grads(m.loss_and_metrics, m.params,
                                         m.bn_state, batch, gen, self.n_subb,
                                         out=fs.grad_views)
        g = fs.clip_chunk(fs.reduce_grads(), self.exchanger.clip)
        m.opt.update(g, m.opt_state, fs.shard, self._lr)
        return cost, err

    def _phase(self) -> int:
        """Which graph a window replays: the window's phase against the
        fused exchange cadence (its first count modulo ``exchange_freq``),
        which fixes the steps of the window that end in an exchange; 0
        without a fused exchange.  One graph per phase the run meets (one
        when ``n_steps`` is a multiple of ``exchange_freq``)."""
        return self._first % self._exch.exchange_freq \
            if self._exch is not None else 0

    def _numerics_step(self) -> None:
        """The numerics plane's host predicate for this call: which step
        it samples (the last whose count is due; -1 for none, and then the
        call replays the plane-off graph), its count on the device, and
        whether the aux holds a sample after the call."""
        j = self._nx.sampled_step(self._first, self.n_steps)
        self._nx_j = j
        self.nx_sampled = j >= 0
        if j >= 0:
            self._nx_it.fill_(float(self._first + j))

    def numerics_aux(self):
        """The last call's per-worker sample (the JAX package's aux: a dict
        of ``[n_workers]`` columns; device tensors after a sampled call,
        the template after one that sampled nothing); None when the plane
        is off."""
        if self._nx is None:
            return None
        if self.nx_sampled:
            return numerics.aux_dict(self.nx_buf)
        t = self._nx.template()
        return {k: [t[i]] * self.nx_buf.shape[0]
                for i, k in enumerate(numerics.SAMPLE_KEYS)}

    def __call__(self, batch, lr, count: int):
        inputs = batch if batch is self._static else self.take(batch)
        lr = float(lr)
        if lr != self._lr_host:
            self._lr.fill_(lr)
            self._lr_host = lr
        self._first = first = int(count) - self.n_steps + 1
        if self._counts is not None:
            torch.add(self._steps, first, out=self._counts)
        for j, g in enumerate(self._gens):
            g.manual_seed(step_seed(self.model.step_seed, self.model.rank,
                                    first + j))
        for j, g in enumerate(self._xgens):
            self._exch.seed_draws(g, first + j)
        key = (self._phase(), self.exchanger.active_key())
        if self._nx is not None:
            self._numerics_step()
            key = (key, self._nx_j)
        if not self.graphed:
            out = self._body(inputs)
        else:
            if self._exch is not None:
                self._exch.check_capture()
            out = self._run_captured(key,
                                     lambda: self._body(inputs),
                                     lambda: self._body(self._static),
                                     self._gens + self._xgens)
        return out[0], out[1]


class ExchangeStep(_Captured):
    """``exchange(count)``: the rule's exchange after step ``count``, in
    place on the model's state — the unfused cadence, which the worker
    calls after a train step when the exchange is due (``steps_per_call =
    1``).  On the card it is captured in a CUDA graph of its own at its
    first call (that call runs eagerly, as the train step's does) and
    replayed after; GoSGD's send gate draws from a generator registered
    with the graph and seeded from ``(gosgd_seed, rank, count)`` before
    each call.  Its state identity check and launch counts are the train
    step's (:class:`_Captured`); a graph is kept for each active set the
    exchanger meets (``Exchanger.set_active_ranks``)."""

    def __init__(self, model, exchanger, capture: Optional[bool] = None):
        self.model, self.exchanger = model, exchanger
        self.device = torch.device(model.device)
        self.capture = self.device.type == "cuda" if capture is None \
            else bool(capture)
        self.gen = torch.Generator(device=self.device)
        _Captured.__init__(self)

    def __call__(self, count: int) -> None:
        self.exchanger.seed_draws(self.gen, int(count))

        def body():
            self.exchanger.exchange_body(int(count), self.gen)

        if not self.graphed:
            body()
            return
        self.exchanger.check_capture()
        self._run_captured(self.exchanger.active_key(), body, body,
                           [self.gen] if self.exchanger.uses_draws else [])


def build_train_step(model, exchanger, n_steps: int = 1,
                     capture: Optional[bool] = None) -> TrainStep:
    """The train step of ``model`` under ``exchanger``: ``n_steps`` steps a
    call, captured on the card unless ``capture=False`` (see
    :class:`TrainStep`)."""
    return TrainStep(model, exchanger, n_steps, capture)


def build_val_step(model) -> Callable:
    """``val_fn(batch) -> (cost, err, err_top5)``: this rank's rows scored
    with the parameters and BatchNorm running stats ``model.begin_val``
    chose (``model.val_params()``: the replica itself, the EMA shadow, or
    an async rule's canonical params with the replica-mean stats),
    averaged over the ranks (an async island's alone: no collective)."""
    collective = model.exchanger.collective
    size = dist.get_world_size() if collective else 1

    @torch.no_grad()
    def val_fn(batch: Dict[str, torch.Tensor]):
        params, bn_state = model.val_params()
        cost, (err, err5) = model.val_metrics(params, bn_state, batch)
        m = torch.stack([cost, err, err5])
        if collective:
            m = _mean_over_ranks(m, size)
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
