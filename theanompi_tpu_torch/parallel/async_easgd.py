"""Asynchronous EASGD and ASGD: worker islands around a host-side center.

Counterpart of ``theanompi_tpu/parallel/async_easgd.py``.  The reference's
EASGD ran a server process holding the center parameters; each worker
exchanged with it at its own pace, so a straggler never blocked the
others.  The in-step exchangers (``parallel/exchanger.py``) keep the
algebra at a synchronous cadence; here it runs as the reference ran it:

* An **island** of one device is one worker with its own captured train
  step and no collective (``exchanger.LocalExchanger``): the JAX
  package's islands were sub-meshes, whose mean over one device is the
  worker itself.  In-process islands are threads (:class:`IslandRunner`);
  island ``i`` binds ``cuda:{i}``, or every island the one card that
  ``device`` names (two islands share one H100 so).
* In a launched world (``init_method``, ``n_workers > 1``) every rank
  is a process of its own: the world of ``n_workers = K · async_islands``
  ranks splits into islands of ``K`` consecutive ranks, and each
  island's ranks join a process group of their own
  (``base.MeshProcess.get_internode_comm(K)``).  As on the JAX package's
  sub-mesh, each rank of an island is a local worker
  (``LocalExchanger``) with a replica of its own.  At an exchange the
  island's rank 0 alone calls the center and broadcasts what it got and
  how the call went, so every rank takes the same branch: EASGD moves
  each replica by ``p − α(p − c)`` and pushes the replicas' mean delta,
  ASGD pushes the replicas' mean less the anchor and resets every
  replica to the center it gets back.  Global rank 0 holds the center in
  memory and serves it to the other islands (its address rides the
  store), unless ``center_addr`` names one.
* The **center** (:class:`ElasticCenter`, NumPy only) holds float32
  leaves in the JAX package's flatten order and layouts (conv HWIO, FC
  ``[in, out]``), behind a lock.  ``center_serve`` also serves it over
  TCP and ``center_addr='host:port'`` joins a remote one
  (``parallel/center_server.py``, on the JAX package's wire): islands in
  other processes, of either package, share one center.

Every ``sync_freq`` local steps an island exchanges (:class:`CenterLink`):

    EASGD:  c ← pull;  delta = p − c;  p ← p − α·delta;  push delta
            (the center: c ← c + α·delta, atomically, possibly stale)
    ASGD:   delta = p − anchor;  anchor ← push_pull(delta);  p ← anchor
            (the center: c ← c + delta, and the new center returned in
            the same op; the anchor is the center at the island's start)

The elastic update and the delta run on the device as ``torch._foreach``
passes, in place on the captured step's own tensors; the permutes to and
from the JAX layout happen on the device, and the center's leaves cross
to the host through one pinned buffer each way.  A center outage mid-run
skips the exchange (``WireGiveUp``; under ASGD the anchor is re-taken
from the center at the next exchange); a center that came back without
its state is re-seeded from the island (``CenterUninitialized``).

Config (:class:`AsyncEASGDTrainer`, or ``EASGD(...).init(...,
easgd_mode='async')`` / ``ASGD(..., asgd_mode='async')``):
``async_islands`` (2), ``alpha`` (0.5), ``sync_freq`` (4),
``async_rule``, ``island_base`` (offsets island ids and data seeds across
processes: island ``i`` reads the data stream ``seed + island_base + i``),
``center_serve`` / ``center_host`` / ``center_port`` /
``center_keep_serving``, ``center_addr`` with ``wire_timeout`` /
``wire_retries`` / ``wire_deadline``, ``center_restore`` (a joining
island starts from the center), ``island_throttle`` (seconds of sleep
after each step, one number or ``{island: seconds}``: a deliberate
straggler), ``run_seconds`` (the session's budget, 60).  Leases, the
chaos trigger and the round spans of the JAX package wait for ROADMAP
A10 and are refused; so are ``steps_per_call > 1`` and bucketed wires.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..base import MeshProcess, resolve_device
from ..utils.helper_funcs import (_jax_shape, from_jax_layout, jax_leaf_paths,
                                  leaf_paths, to_jax_layout, tree_leaves)

# config keys of the JAX package's islands that need ROADMAP A10
_A10_KEYS = ("lease_dir", "chaos_dir", "chaos", "tracing", "telemetry",
             "trace_dir", "metrics_addr")


class ElasticCenter:
    """Host-side center store (≙ the reference's EASGD server): a flat list
    of float32 leaves, in the JAX package's flatten order and layouts.

    Thread-safe: islands and the server's handler threads call it at their
    own pace; the reentrant lock serializes updates (the server takes it
    first to measure its queue wait, then calls in)."""

    def __init__(self, leaves: Optional[List[np.ndarray]] = None,
                 alpha: float = 0.5):
        self.alpha = float(alpha)
        self._leaves: Optional[List[np.ndarray]] = None
        self._lock = threading.RLock()
        self.n_updates = 0            # exchanges absorbed (all islands)
        self.updates_by_island: Dict[int, int] = {}
        # elastic membership: a demoted island's pushes are dropped
        # (counted) while its pulls still serve
        self.demoted: set = set()
        self.dropped_by_island: Dict[int, int] = {}
        if leaves is not None:
            self.ensure_init_leaves(leaves)

    # -- membership ---------------------------------------------------------

    def demote_island(self, island: int) -> None:
        with self._lock:
            self.demoted.add(int(island))

    def readmit_island(self, island: int) -> None:
        with self._lock:
            self.demoted.discard(int(island))

    def stats_snapshot(self) -> Dict[str, object]:
        """A consistent copy of the bookkeeping, under the lock."""
        with self._lock:
            return {"n_updates": self.n_updates,
                    "by_island": dict(self.updates_by_island),
                    "demoted": sorted(self.demoted),
                    "dropped_by_island": dict(self.dropped_by_island)}

    def _drop_if_demoted(self, island: int) -> bool:
        """Caller holds the lock.  True: the push is from a demoted island
        and is dropped."""
        if int(island) in self.demoted:
            self.dropped_by_island[int(island)] = \
                self.dropped_by_island.get(int(island), 0) + 1
            return True
        return False

    # -- the leaf-list interface --------------------------------------------

    def ensure_init_leaves(self, leaves: List[np.ndarray]) -> None:
        """Seed the store from the first caller (islands share the model
        seed, so their initial params, and the center, agree); a no-op
        once seeded."""
        with self._lock:
            if self._leaves is None:
                self._leaves = [np.array(x, np.float32) for x in leaves]

    def pull_leaves(self) -> List[np.ndarray]:
        with self._lock:
            assert self._leaves is not None, "center not initialized yet"
            return [np.array(x) for x in self._leaves]

    def _check_leaves(self, deltas) -> None:
        # a client with another model config fails loudly here: zip would
        # truncate the shared store and crash every other island later
        assert self._leaves is not None, "center not initialized yet"
        assert len(deltas) == len(self._leaves), (
            f"push of {len(deltas)} leaves against a {len(self._leaves)}"
            "-leaf center — mismatched model configs across islands?")

    def _count(self, island: int) -> None:
        self.n_updates += 1
        self.updates_by_island[island] = \
            self.updates_by_island.get(island, 0) + 1

    def push_delta_leaves(self, deltas: List[np.ndarray],
                          island: int) -> None:
        """EASGD: center += α·delta."""
        a = self.alpha
        with self._lock:
            if self._drop_if_demoted(island):
                return
            self._check_leaves(deltas)
            self._leaves = [c + a * np.asarray(d, np.float32)
                            for c, d in zip(self._leaves, deltas)]
            self._count(island)

    def push_pull_leaves(self, deltas: List[np.ndarray],
                         island: int) -> List[np.ndarray]:
        """ASGD downpour: center += delta, and the new center returned, in
        one atomic op (a demoted island gets the center unchanged)."""
        with self._lock:
            dropped = self._drop_if_demoted(island)
            self._check_leaves(deltas)
            if not dropped:
                self._leaves = [c + np.asarray(d, np.float32)
                                for c, d in zip(self._leaves, deltas)]
                self._count(island)
            return [np.array(x) for x in self._leaves]


class CenterLink:
    """One island's side of the center: its params (the port's layout and
    leaf order, on its device) against the center's leaves (the JAX
    package's order and layouts, float32, on the host).

    Two float32 device buffers of the params' size hold the center's
    layout: ``dev_in`` what came from the center (EASGD's pull, ASGD's
    anchor), seen through views in the port's layout, and ``dev_out`` what
    goes to it; the permutes are device copies.  One host buffer (pinned
    on a card) carries each crossing: one device → host copy out, one host
    → device copy in.  Every exchange is timed by its parts, wall seconds
    ending in a synchronize (:attr:`records`): ``drain`` (the island's
    queued steps), ``d2h`` (the update or delta, the permutes and the copy
    out), ``wire`` (the center's calls: packing, CRC, the socket and the
    apply), ``apply`` (the center's own time, from the replies' server
    split; the whole call for a center in memory), ``h2d`` (into the
    pinned buffer and the copy in).

    In an island of ``group_size > 1`` devices the center is rank 0's
    alone (``center`` is None on the others): it broadcasts ``dev_in``
    and the outcome of each call, and the replicas' mean is reduced into
    its ``dev_out``."""

    def __init__(self, model, center, island: int,
                 alpha: Optional[float] = None, group_size: int = 1):
        self.model, self.center, self.island = model, center, int(island)
        self.alpha = float(center.alpha if alpha is None else alpha)
        # an island of more than one device: this process's rank in the
        # island's group (the default group); its rank 0 alone calls the
        # center
        self.k = int(group_size)
        self.lead = self.k == 1 or dist.get_rank() == 0
        params = model.params
        kept = frozenset(model.kept_layout_paths())
        self.device = torch.device(model.device)
        self._cuda = self.device.type == "cuda"
        index = {p: i for i, p in enumerate(leaf_paths(params))}
        jpaths = jax_leaf_paths(params)
        self._order = [index[p] for p in jpaths]  # JAX position → port index
        leaves = tree_leaves(params)
        self._params = leaves
        self._shapes = [_jax_shape(tuple(leaves[i].shape), p, kept)
                        for i, p in zip(self._order, jpaths)]
        sizes = [int(np.prod(s)) for s in self._shapes]
        self.n = sum(sizes)
        self.host = torch.empty(self.n, dtype=torch.float32,
                                pin_memory=self._cuda)
        self._host_leaves = [v.numpy().reshape(s) for v, s in
                             zip(self.host.split(sizes), self._shapes)]
        self.dev_in = torch.empty(self.n, dtype=torch.float32,
                                  device=self.device)
        self.dev_out = torch.empty_like(self.dev_in)
        self._out = [v.view(s) for v, s in
                     zip(self.dev_out.split(sizes), self._shapes)]
        into = [None] * len(leaves)
        for j, (v, s, p) in enumerate(zip(self.dev_in.split(sizes),
                                          self._shapes, jpaths)):
            into[self._order[j]] = from_jax_layout(v.view(s), p, kept)
        self._in = into               # port order and layout, views
        self._jpaths, self._kept = jpaths, kept
        self.records: List[Dict[str, float]] = []

    @property
    def bytes_per_crossing(self) -> int:
        """Float32 bytes of the params: one pull, push or reply body's
        leaves."""
        return 4 * self.n

    def sync(self) -> None:
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()

    # -- the crossings -------------------------------------------------------

    @torch.no_grad()
    def down(self, leaves: list) -> List[np.ndarray]:
        """Port-order device leaves → the center's leaves: views of the
        host buffer, valid until the next crossing."""
        self._pack(leaves)
        return self._to_host()

    def _pack(self, leaves: list) -> None:
        for j, (v, p) in enumerate(zip(self._out, self._jpaths)):
            v.copy_(to_jax_layout(leaves[self._order[j]], p, self._kept))

    def _to_host(self) -> List[np.ndarray]:
        self.host.copy_(self.dev_out, non_blocking=self._cuda)
        self.sync()
        return self._host_leaves

    @torch.no_grad()
    def _mean_down(self, leaves: list) -> Optional[List[np.ndarray]]:
        """The island's mean of ``leaves`` (one a replica) as the center's
        leaves, on the island's rank 0 (None elsewhere): :meth:`down` in an
        island of one device."""
        if self.k == 1:
            return self.down(leaves)
        self._reduce_mean(leaves)
        return self._to_host() if self.lead else None

    def _reduce_mean(self, leaves: list) -> None:
        """``dev_out`` ← the replicas' mean of ``leaves``, on rank 0."""
        self._pack(leaves)
        dist.reduce(self.dev_out, 0)
        if self.lead:
            self.dev_out.div_(self.k)

    def _bcast_in(self) -> None:
        """``dev_in`` from the island's rank 0 to its other ranks."""
        if self.k > 1:
            dist.broadcast(self.dev_in, 0)

    def _lead(self, call, default=(None, 0.0, 0.0)):
        """``call()`` on the island's rank 0; ``default`` elsewhere.  In an
        island of more than one device rank 0 broadcasts how the call went,
        so every rank raises the ``WireGiveUp`` or ``CenterUninitialized``
        it raised (and takes the same branch after)."""
        if self.k == 1:
            return call()
        from .wire import CenterUninitialized, WireGiveUp
        out, err = default, None
        if self.lead:
            try:
                out = call()
            except (WireGiveUp, CenterUninitialized) as e:
                err = e
        code = torch.tensor([0 if err is None else 1 if isinstance(
            err, WireGiveUp) else 2], device=self.device)
        dist.broadcast(code, 0)
        code = int(code.item())
        if code and err is None:
            err = (WireGiveUp, CenterUninitialized)[code - 1](
                f"island {self.island}: its rank 0's center call failed")
        if err is not None:
            raise err
        return out

    @torch.no_grad()
    def up(self, leaves: List[np.ndarray]) -> list:
        """The center's leaves → ``dev_in``; returns its port-layout views
        (float32, in the params' leaf order)."""
        if len(leaves) != len(self._shapes):
            raise ValueError(f"the center holds {len(leaves)} leaves, this "
                             f"island's model {len(self._shapes)}")
        for dst, src, p in zip(self._host_leaves, leaves, self._jpaths):
            if tuple(np.shape(src)) != dst.shape:
                raise ValueError(f"center leaf {p} has shape "
                                 f"{np.shape(src)}, this island's model "
                                 f"wants {dst.shape}")
            np.copyto(dst, src)
        self.dev_in.copy_(self.host, non_blocking=self._cuda)
        return self._in

    def _cast_in(self) -> list:
        return [c if c.dtype == p.dtype else c.to(p.dtype)
                for p, c in zip(self._params, self._in)]

    def _call(self, fn, *args):
        """One center call: its wall seconds and the center's apply
        seconds."""
        t = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t
        srv = getattr(self.center, "last_srv", None)
        return out, dt, (float(srv.get("a", 0.0)) if srv else dt)

    # -- start-up and resync ---------------------------------------------------

    def seed(self, mean: bool = False) -> None:
        """Seed the center from this island's params (a no-op on a seeded
        center): rank 0's, which every replica shares at the start, or with
        ``mean`` the replicas' mean (a re-seed)."""
        if mean:
            host = self._mean_down(self._params)
        else:
            host = self.down(self._params) if self.lead else None
        self._lead(lambda: self.center.ensure_init_leaves(host), None)

    @torch.no_grad()
    def anchor(self, set_params: bool = False) -> None:
        """``dev_in`` ← the center (ASGD's anchor); with ``set_params`` the
        params too (a rejoin, or ASGD's resync after an outage)."""
        self._lead(lambda: self.up(self.center.pull_leaves()), None)
        self._bcast_in()
        if set_params:
            torch._foreach_copy_(self._params, self._cast_in())
        self.sync()

    # -- the exchanges ---------------------------------------------------------

    @torch.no_grad()
    def easgd(self) -> Dict[str, float]:
        """Pull, ``p ← p − α·(p − c)``, push ``delta = p − c`` (the
        replicas' mean delta in an island of more than one device)."""
        t0 = time.perf_counter()
        self.sync()
        t1 = time.perf_counter()
        leaves, w1, a1 = self._lead(
            lambda: self._call(self.center.pull_leaves))
        t2 = time.perf_counter()
        if self.lead:
            self.up(leaves)
        self._bcast_in()
        self.sync()
        t3 = time.perf_counter()
        ps = self._params
        delta = torch._foreach_sub(ps, self._cast_in())
        torch._foreach_add_(ps, delta, alpha=-self.alpha)
        host = self._mean_down(delta)
        del delta
        t4 = time.perf_counter()
        _, w2, a2 = self._lead(lambda: self._call(
            self.center.push_delta_leaves, host, self.island))
        t5 = time.perf_counter()
        return self._record(drain=t1 - t0, wire=w1 + w2, apply=a1 + a2,
                            h2d=t3 - t2, d2h=t4 - t3, total=t5 - t0)

    @torch.no_grad()
    def asgd(self) -> Dict[str, float]:
        """Push ``delta = p − anchor`` (the replicas' mean less the anchor
        in an island of more than one device); the new center returned is
        the anchor and every replica's params."""
        t0 = time.perf_counter()
        self.sync()
        t1 = time.perf_counter()
        if self.k == 1:
            delta = torch._foreach_sub(self._params, self._cast_in())
            host = self.down(delta)
            del delta
        else:
            self._reduce_mean(self._params)
            host = None
            if self.lead:
                self.dev_out.sub_(self.dev_in)
                host = self._to_host()
        t2 = time.perf_counter()
        leaves, w, a = self._lead(lambda: self._call(
            self.center.push_pull_leaves, host, self.island))
        t3 = time.perf_counter()
        if self.lead:
            self.up(leaves)
        self._bcast_in()
        torch._foreach_copy_(self._params, self._cast_in())
        self.sync()
        t4 = time.perf_counter()
        return self._record(drain=t1 - t0, d2h=t2 - t1, wire=w, apply=a,
                            h2d=t4 - t3, total=t4 - t0)

    def _record(self, **parts) -> Dict[str, float]:
        self.records.append(parts)
        return parts


class IslandRunner(threading.Thread):
    """One island: one worker on one device, its own captured train step,
    its own pace.

    ``model_factory(config) -> model`` builds the island's model from its
    config (the device, rank 0 of a world of 1, and ``data_seed``, its own
    data stream; the params' seed is shared, so every island starts from
    the same weights)."""

    def __init__(self, island_id: int, model_factory: Callable, config: dict,
                 center, sync_freq: int, stop_event: threading.Event,
                 throttle_s: float = 0.0, rule: str = "easgd",
                 group_size: int = 1, alpha: Optional[float] = None):
        super().__init__(daemon=True)
        self.island_id = island_id
        self.config = config
        self.center = center
        self.sync_freq = int(sync_freq)
        self.stop_event = stop_event
        self.throttle_s = float(throttle_s)   # a deliberate straggler
        self.rule = rule                      # 'easgd' elastic | 'asgd' downpour
        # an island of more than one device: this process is the island's
        # rank ``config['rank']`` of ``group_size`` in the default group;
        # only its rank 0 has a ``center`` (``alpha`` names α for the rest)
        self.group_size = int(group_size)
        self.alpha = alpha
        self.steps_done = 0
        self.exchanges_done = 0
        # center outages survived: the island trained on locally and
        # resynced at a later exchange
        self.exchanges_skipped = 0
        self.error: Optional[BaseException] = None
        self.model = None
        self.link: Optional[CenterLink] = None
        # wall seconds of each round's local steps, to the end of the
        # exchange's drain, its throttle sleeps left out; and the cost of
        # the step before each exchange
        self.round_s: List[float] = []
        self.costs: List[float] = []
        self.run_s = 0.0
        self._model_factory = model_factory

    def run(self) -> None:
        t0 = time.time()
        try:
            dev = torch.device(self.config.get("device", "cuda"))
            if dev.type == "cuda":
                # the island's work on a stream of its own: islands sharing
                # a card do not queue behind each other's steps
                torch.cuda.set_device(dev)
                ctx = torch.cuda.stream(torch.cuda.Stream(dev))
            else:
                ctx = contextlib.nullcontext()
            with ctx:
                self._run()
        except BaseException as e:      # re-raised by stop_and_join
            self.error = e
        finally:
            self.run_s = time.time() - t0

    def _run(self) -> None:
        from .exchanger import LocalExchanger
        from .wire import CenterUninitialized, WireGiveUp

        model = self.model = self._model_factory(self.config)
        grouped = self.group_size > 1
        link = self.link = CenterLink(model, self.center, self.island_id,
                                      self.alpha, self.group_size)
        try:
            link.seed()
        except WireGiveUp as e:
            raise RuntimeError(
                f"island {self.island_id}: center unreachable at startup — "
                f"cannot seed or join the center.  Is the center server up?"
                f"  Underlying wire error: {e}") from e
        model.compile_iter_fns(LocalExchanger(self.config))
        model.data.shuffle_data(int(self.config.get("data_seed", 0)))
        if self.config.get("center_restore", False):
            # a (re)joining island starts from the consensus; a dead center
            # fails the rejoin loudly (bounded by the wire's deadline)
            try:
                link.anchor(set_params=True)
            except WireGiveUp as e:
                raise RuntimeError(
                    f"island {self.island_id}: center_restore failed — the "
                    f"center stayed unreachable through the wire client's "
                    f"retry budget.  Underlying wire error: {e}") from e
        # ASGD's anchor is taken at the START (the center as this island
        # joins), not at the first exchange: another island's push landing
        # before then would otherwise be subtracted away
        anchored = True
        if self.rule == "asgd":
            link.anchor()
        count = 0
        t_round, slept = time.perf_counter(), 0.0
        # an island of more than one device stops where its rank 0 says,
        # after an exchange
        while grouped or not self.stop_event.is_set():
            count += 1
            model.train_iter(count)
            self.steps_done += 1
            if self.throttle_s:
                time.sleep(self.throttle_s)
                slept += self.throttle_s
            if count % self.sync_freq:
                continue
            link.sync()
            self.round_s.append(time.perf_counter() - t_round - slept)
            self.costs.append(float(model.current_info["cost"]))
            try:
                if self.rule == "easgd":
                    link.easgd()
                elif anchored:
                    link.asgd()
                else:
                    # resync after an outage: the interrupted push_pull may
                    # have landed with its reply lost, and a delta against
                    # the old anchor would apply it twice: take the center
                    # as it is and start the accumulation again
                    link.anchor(set_params=True)
                    anchored = True
                self.exchanges_done += 1
            except WireGiveUp:
                self.exchanges_skipped += 1
                anchored = False
            except CenterUninitialized:
                # the center came back without its state: re-seed it from
                # this island's params and carry on
                self.exchanges_skipped += 1
                try:
                    link.seed(mean=True)
                    if self.rule == "asgd":
                        link.anchor()
                except (WireGiveUp, CenterUninitialized):
                    pass               # the next exchange tries again
            if grouped and self._lead_says_stop(model.device):
                break
            t_round, slept = time.perf_counter(), 0.0

    def _lead_says_stop(self, device) -> bool:
        """The island's rank 0's stop, broadcast to its other ranks."""
        flag = torch.tensor([float(self.stop_event.is_set())], device=device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def perf(self) -> dict:
        """Step and exchange times: the median local step (the first round,
        which captures the step, left out), the island's overall pace, and
        each exchange part's median in ms."""
        out = {"run_s": self.run_s}
        rounds = self.round_s[1:] or self.round_s
        if rounds:
            out["step_ms"] = 1e3 * float(np.median(rounds)) / self.sync_freq
        if self.run_s > 0:
            out["steps_per_s"] = self.steps_done / self.run_s
        recs = self.link.records if self.link is not None else []
        if recs:
            out["exchange_ms"] = {k: 1e3 * float(np.median([r[k] for r in recs]))
                                  for k in recs[0]}
            out["bytes_per_exchange"] = 2 * self.link.bytes_per_crossing
        if self.costs:
            out["costs"] = self.costs[-16:]     # the latest
        return out


class AsyncEASGDTrainer:
    """Islands around one center, trained asynchronously (≙ the reference's
    server + independent workers topology)."""

    def __init__(self, model_factory: Callable, config: Optional[dict] = None,
                 rule: str = "easgd"):
        self.config = dict(config or {})
        self.rule = str(self.config.get("async_rule", rule))
        if self.rule not in ("easgd", "asgd"):
            raise ValueError(f"async_rule={self.rule!r}; have 'easgd', "
                             f"'asgd'")
        self.n_islands = int(self.config.get("async_islands", 2))
        self.alpha = float(self.config.get("alpha", 0.5))
        self.sync_freq = int(self.config.get("sync_freq", 4))
        for k in _A10_KEYS:
            if self.config.get(k):
                raise NotImplementedError(
                    f"async islands with {k!r}: leases, chaos and tracing "
                    f"are not ported yet (ROADMAP A10)")
        if int(self.config.get("steps_per_call", 1)) != 1:
            raise NotImplementedError(
                "async islands take one step a call (steps_per_call=1)")
        # the islands this process runs (their indices, before
        # island_base); in a launched world, this rank's place in it
        self.island_size = 1
        self._local = list(range(self.n_islands))
        self._proc = None
        n_workers = int(self.config.get("n_workers") or 1)
        if n_workers > self.n_islands or (
                n_workers > 1 and self.config.get("init_method")):
            self._join_island(n_workers)
        proc = self._proc
        self._island_devices = self._devices()
        self.model_factory = model_factory
        self.stop_event = threading.Event()
        self.islands: List[IslandRunner] = []
        self._center_updates_final = None

        # the center: in memory (islands are threads of this process),
        # also served over TCP (center_serve), or a remote one (center_addr);
        # in a world of multi-device islands global rank 0 holds it and
        # serves the other islands, and only an island's rank 0 talks to it
        self._server = None
        addr = self.config.get("center_addr")
        if proc is not None and proc.rank > 0:
            self.center = None
        elif addr or (proc is not None and proc.world_rank > 0):
            from .center_server import RemoteCenter
            if not addr:
                addr = proc.store.get("center_addr").decode()
            # the client id keys the server's dedup window: island ids stay
            # unique across processes through island_base
            self.center = RemoteCenter(
                str(addr), alpha=self.alpha,
                client_id=f"w{self._island_base + self._local[0]}",
                op_timeout_s=float(self.config.get("wire_timeout", 20.0)),
                max_retries=int(self.config.get("wire_retries", 8)),
                deadline_s=float(self.config.get("wire_deadline", 60.0)))
        else:
            self.center = ElasticCenter(alpha=self.alpha)
            if self.config.get("center_serve") or (
                    proc is not None and self.n_islands > 1):
                from .center_server import CenterServer
                self._server = CenterServer(center=self.center)
                host, port = self._server.start(
                    str(self.config.get("center_host", "127.0.0.1")),
                    int(self.config.get("center_port", 0)))
                self.center_address = f"{host}:{port}"
                if proc is not None:
                    proc.store.set("center_addr", self.center_address)

    def _join_island(self, n_workers: int) -> None:
        """This process as one rank of a launched world of islands of
        ``K = n_workers / async_islands`` devices: rank ``r`` is rank
        ``r % K`` of island ``r // K``, whose ``K`` ranks form this
        process's default group (``MeshProcess.get_internode_comm(K)``)."""
        n = self.n_islands
        if n_workers % n:
            raise ValueError(f"{n_workers} devices do not split into {n} "
                             f"async islands of equal size")
        k = n_workers // n
        if not self.config.get("init_method"):
            raise NotImplementedError(
                f"{n_workers} devices over {n} async islands gives an island "
                f"more than one device: such an island is {k} processes, one "
                f"a device, each a rank of the launcher's world (python -m "
                f"theanompi_tpu_torch.launcher --n-workers {n_workers}: "
                f"rank, init_method); one process runs islands of one device "
                f"only")
        if dist.is_initialized():
            raise RuntimeError("this process has a process group already; "
                               "an island's rank joins its island's own")
        proc = self._proc = MeshProcess(dict(self.config,
                                             n_workers=n_workers))
        proc.get_internode_comm(group_size=k)
        self.island_size = k
        self._local = [proc.group]

    def _leave_island(self, failed: bool) -> None:
        """Tell the world this island is done; global rank 0, serving the
        center, waits for every island before it stops serving; then
        leave the island's group."""
        proc = self._proc
        if not failed:
            if proc.rank == 0:
                proc.store.add("islands_done", 1)
            if proc.world_rank == 0 and self._server is not None:
                while proc.store.add("islands_done", 0) < self.n_islands:
                    time.sleep(0.05)
        proc.close()

    def _devices(self) -> List[torch.device]:
        """Island ``i``'s device: ``cuda:{i}``, or the one card (or the CPU)
        that ``device`` names, shared by every island; in a world of
        multi-device islands, this rank's ``cuda:{local_rank}``."""
        n = self.n_islands
        if self._proc is not None:
            return [self._proc.device]
        named = str(self.config.get("device", "cuda"))
        dev = resolve_device({"device": named})
        if dev.type == "cpu" or ":" in named:
            return [dev] * n
        if n > torch.cuda.device_count():
            raise ValueError(
                f"{n} async islands and {torch.cuda.device_count()} visible "
                f"GPUs: island i binds cuda:i; name one card (device="
                f"'cuda:0') for the islands to share it")
        return [torch.device("cuda", i) for i in range(n)]

    def _island_config(self, i: int) -> dict:
        cfg = dict(self.config)
        cfg.update(device=str(self._island_devices[self._local.index(i)]),
                   rank=self._proc.rank if self._proc else 0,
                   size=self.island_size,
                   n_workers=self.island_size)
        # a data stream of its own per island, across processes too; the
        # params' seed is shared
        cfg["data_seed"] = int(cfg.get("seed", 0)) + self._island_base + i
        return cfg

    @property
    def _island_base(self) -> int:
        return int(self.config.get("island_base", 0))

    def _throttle(self) -> Dict[int, float]:
        t = self.config.get("island_throttle") or {}
        if isinstance(t, dict):
            return {int(k): float(v) for k, v in t.items()}
        return {i: float(t) for i in range(self.n_islands)}

    def start(self, throttle: Optional[Dict[int, float]] = None) -> None:
        """Start every island; ``throttle`` (default: the config's
        ``island_throttle``) maps a local island index to the seconds it
        sleeps after each step."""
        throttle = self._throttle() if throttle is None else throttle
        for i in self._local:
            r = IslandRunner(self._island_base + i, self.model_factory,
                             self._island_config(i), self.center,
                             self.sync_freq, self.stop_event,
                             throttle_s=throttle.get(i, 0.0), rule=self.rule,
                             group_size=self.island_size, alpha=self.alpha)
            self.islands.append(r)
            r.start()

    def stop_and_join(self, timeout: float = 60.0) -> None:
        """Stop the islands, close the center's client (after reading its
        update count) or the server, and re-raise an island's error.  An
        island of more than one device stops at its next exchange, when its
        rank 0 says so; a rank that failed leaves its island's other ranks
        waiting in a collective, for the launcher to stop."""
        self.stop_event.set()
        for r in self.islands:
            r.join(timeout=None if self.island_size > 1 else timeout)
        if hasattr(self.center, "close"):
            try:
                self._center_updates_final = self.center.n_updates
            except Exception:
                pass
            self.center.close()
        if self._proc is not None:
            self._leave_island(any(r.error is not None
                                   for r in self.islands))
        if self._server is not None and not self.config.get(
                "center_keep_serving"):
            self._server.stop()
        for r in self.islands:
            if r.error is not None:
                raise r.error

    def run_for(self, seconds: float,
                throttle: Optional[Dict[int, float]] = None) -> None:
        """Train for ``seconds`` (less if an island fails: its error is
        raised at once), then stop."""
        self.start(throttle)
        deadline = time.time() + float(seconds)
        while not self.stop_event.is_set() and time.time() < deadline \
                and not any(r.error is not None for r in self.islands):
            self.stop_event.wait(min(0.1, max(0.0, deadline - time.time())))
        self.stop_and_join()

    @property
    def center_params(self) -> List[np.ndarray]:
        """The center's leaves (the JAX package's order and layouts;
        ``convert.params_from_center_leaves`` lays them out as a port
        model's params)."""
        return self.center.pull_leaves()

    # -- recorder-compatible surface ------------------------------------------
    # ``EASGD(...).wait()`` returns this trainer in async mode: a session
    # script's ``rec.save(...)`` and ``epoch_records`` keep working

    def stats(self) -> dict:
        cu = self._center_updates_final
        if cu is None and self.center is not None:
            cu = self.center.n_updates
        return {"islands": [{"island": r.island_id, "steps": r.steps_done,
                             "exchanges": r.exchanges_done,
                             "exchanges_skipped": r.exchanges_skipped,
                             **r.perf()}
                            for r in self.islands],
                "center_updates": cu}

    @property
    def epoch_records(self):
        return [self.stats()]

    def save(self, record_dir: Optional[str] = None) -> None:
        import json
        import os
        d = record_dir or self.config.get("record_dir", "./inc")
        os.makedirs(d, exist_ok=True)
        # a launched world's ranks share the directory: a file a rank
        name = "async_easgd_stats.jsonl" if self._proc is None \
            else f"async_easgd_stats_rank{self._proc.world_rank}.jsonl"
        with open(os.path.join(d, name), "w") as f:
            f.write(json.dumps(self.stats()) + "\n")
