"""Elastic membership: heartbeat leases, the membership controller, the
center's reactions and the elastic supervisor.

Counterpart of ``theanompi_tpu/parallel/membership.py``, a copy of its
logic (the JAX module is stdlib-only at its top).  ``launcher
--supervise`` restarts a dead world; the async rules need no such
restart, because EASGD's and ASGD's algebra is per island, push and pull
against a center.  So an island that dies is respawned alone:

* **Leases** — each island beats a small JSON lease file
  (``<lease_dir>/lease_w{id}.json``, atomic tmp+rename) and mirrors the
  beat into its telemetry as the ``heartbeat.iter`` gauge.  A lease
  older than ``lease_timeout`` is a dead or wedged island (a SIGSTOPped
  process stops beating without exiting).
* **:class:`MembershipController`** — the island state machine:
  ``poll()`` folds lease files and process observations into
  ``worker_join`` / ``worker_leave`` / ``worker_demote`` transitions (one
  telemetry event each, and the reactors' callbacks), and
  ``check_stragglers()`` demotes an island that
  ``tools/telemetry_report.py``'s windowed ranking charges with
  ``straggle_windows`` straggles.
* **Reactors** — :class:`CenterReactor` demotes and readmits islands at
  the EASGD/ASGD center: a demoted island's pushes are dropped, its pulls
  still served.  :class:`MeshReactor` drives an in-world exchanger's
  ``set_active_ranks``: GoSGD's tables drawn again without the demoted
  rank, EASGD's and ASGD's exchange masked.  BSP has no shrink reaction:
  its reaction is a supervised world restart (``launcher --supervise``).
* **:class:`ElasticSupervisor`** — spawns the island processes, sees a
  death (an exit, or a lease expired), respawns with :class:`Backoff`,
  trips a :class:`CrashLoopBreaker` when failures cluster, supervises the
  center as a process of its own (``center_proc``), and acts on the fleet
  monitor's alerts.  A respawned island restores its params from the
  center (``center_restore``).

:func:`run_elastic` composes them (``launcher --elastic``), and
:func:`elastic_worker_main` is one island's process:
``python -m theanompi_tpu_torch.parallel.membership <rule> <modelfile>
<modelclass> [key=value ...]``.  The module's top imports the stdlib and
the port's telemetry and tracing only; torch is imported in the island's
process.

Every time comparison that decides something (lease freshness, backoff,
crash-loop windows) goes through the injectable clock
(``utils/clock.py``).
"""

from __future__ import annotations

import glob
import json
import os
import random
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import telemetry, tracing
from ..utils.clock import WALL

# The membership transition vocabulary (the JAX package's, which
# tools/telemetry_report.py renders).  A readmitted straggler re-enters
# via ``worker_join`` with ``reason='readmit'``.
MEMBERSHIP_EVENTS = ("worker_join", "worker_leave", "worker_demote")

# The center-outage pair: ``center_down`` when the supervised center
# process dies (or its lease expires while it is wedged),
# ``center_restored`` when the respawned center answers on its fixed port
# again; the islands ride the gap out on the wire's retries.
CENTER_EVENTS = ("center_down", "center_restored")

# Heartbeat gauge keys a WorkerLease.beat mirrors into the telemetry
# stream.
HEARTBEAT_GAUGES = ("heartbeat.iter",)


# -- leases ------------------------------------------------------------------

def lease_path(lease_dir: str, worker_id: int) -> str:
    return os.path.join(lease_dir, f"lease_w{int(worker_id)}.json")


def read_leases(lease_dir: str) -> Dict[int, dict]:
    """All parseable lease docs, keyed by worker id.  A torn write can't
    occur (writes are atomic) but a foreign/garbage file is skipped."""
    out: Dict[int, dict] = {}
    if not lease_dir or not os.path.isdir(lease_dir):
        return out
    for name in os.listdir(lease_dir):
        if not (name.startswith("lease_w") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(lease_dir, name)) as f:
                doc = json.load(f)
            out[int(doc["worker"])] = doc
        except (ValueError, KeyError, OSError):
            continue
    return out


class WorkerLease:
    """Worker-side half of the lease contract: ``beat()`` refreshes the
    lease file atomically and mirrors the step into the telemetry stream
    (one ``gauges`` event carrying :data:`HEARTBEAT_GAUGES`); ``release()``
    marks a CLEAN departure so the controller reports ``finished`` instead
    of a lease expiry.

    Safe to call every iteration: a beat within ``min_interval_s`` of the
    last write is one ``time.time()`` check and nothing else (no file
    write, no event), so the hot loop can beat wherever it already beats
    the watchdog without a per-step I/O cost.  Status changes always
    write."""

    def __init__(self, lease_dir: str, worker_id: int, telemetry_=None,
                 min_interval_s: float = 2.0, clock=None):
        self.lease_dir = str(lease_dir)
        self.worker_id = int(worker_id)
        self.telemetry = telemetry_ if telemetry_ is not None \
            else telemetry.active()
        self.min_interval_s = float(min_interval_s)
        self.clock = clock or WALL
        os.makedirs(self.lease_dir, exist_ok=True)
        self._step = 0
        # -inf, not 0.0: under a virtual clock the epoch IS ~0, and a
        # 0.0 sentinel would throttle away the very first beat
        self._last_write = -float("inf")

    def beat(self, step: Optional[int] = None, status: str = "live",
             **extra) -> None:
        if step is not None:
            self._step = int(step)
        now = self.clock.now()
        if status == "live" and not extra and \
                now - self._last_write < self.min_interval_s:
            return
        self._last_write = now
        # full-precision ts: the controller's dead_ts guard compares this
        # against a later time.time() — rounding could order an immediate
        # respawn's first beat "before" the death it follows
        doc = {"worker": self.worker_id, "pid": os.getpid(),
               "ts": now, "step": self._step,
               "status": status}
        doc.update(extra)
        path = lease_path(self.lease_dir, self.worker_id)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            pass                       # a heartbeat must never kill training
        tm = self.telemetry
        if tm.enabled:
            tm.gauge("heartbeat.iter", self._step)
            tm.event("gauges", **{"heartbeat.iter": self._step})

    def release(self) -> None:
        self.beat(status="left")


# -- backoff / crash-loop breaker -------------------------------------------

class Backoff:
    """Bounded exponential backoff + jitter: ``base·factor^attempt`` capped
    at ``cap``, scaled by a uniform ``1 ± jitter`` draw so clients retrying
    against the same dead center don't retry in lockstep.

    ``seed`` makes this instance's draws deterministic on its own; ``rng``
    injects a shared ``random.Random``.  Default (neither): a fresh
    unseeded stream."""

    def __init__(self, base: float = 1.0, factor: float = 2.0,
                 cap: float = 30.0, jitter: float = 0.25, seed=None,
                 rng=None):
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        assert rng is None or seed is None, \
            "Backoff takes seed= OR rng=, not both"
        self._rng = rng if rng is not None else random.Random(seed)

    def delay(self, attempt: int) -> float:
        d = min(self.base * (self.factor ** max(0, int(attempt))), self.cap)
        return d * (1.0 - self.jitter + 2.0 * self.jitter * self._rng.random())


class CrashLoopBreaker:
    """``limit`` failures inside a trailing ``window_s`` window mean the
    failure is systemic (bad config, poisoned checkpoint, dead backend):
    retrying forever just hides it.  ``record_failure()`` returns True when
    the breaker trips; the launcher then exits nonzero."""

    def __init__(self, limit: int = 5, window_s: float = 300.0,
                 clock=None):
        self.limit = int(limit)
        self.window_s = float(window_s)
        self.clock = clock or WALL
        self._times: deque = deque()

    def record_failure(self, now: Optional[float] = None) -> bool:
        now = self.clock.now() if now is None else now
        self._times.append(now)
        while self._times and now - self._times[0] > self.window_s:
            self._times.popleft()
        return len(self._times) >= self.limit


def flight_tail_lines(record_dir: str, n: int = 12) -> List[str]:
    """The last ``n`` events of the NEWEST flight recording under
    ``record_dir`` (crash sweeps included), one per line: what a crash-loop
    exit prints so the death isn't silent."""
    paths = (glob.glob(os.path.join(record_dir, "flight_rank*.jsonl")) +
             glob.glob(os.path.join(record_dir, "crash_*",
                                    "flight_rank*.jsonl")))
    if not paths:
        return []
    newest = max(paths, key=os.path.getmtime)
    lines: List[str] = [f"flight tail ({newest}):"]
    try:
        with open(newest) as f:
            raw = [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return []
    for ln in raw[-n:]:
        try:
            ev = json.loads(ln)
        except ValueError:
            continue
        detail = {k: v for k, v in ev.items()
                  if k not in ("ts", "run", "rank", "ev")}
        lines.append(f"  ts={ev.get('ts')} rank={ev.get('rank')} "
                     f"{ev.get('ev')} {detail}")
    return lines


# -- reactors (the rule reaction matrix) ------------------------------------

class Reactor:
    """Rule-side hooks the controller drives on each transition.  The base
    is all no-ops so a controller can run observation-only."""

    def on_join(self, worker: int, info: dict) -> None:
        pass

    def on_leave(self, worker: int, info: dict) -> None:
        pass

    def on_demote(self, worker: int, info: dict) -> None:
        pass

    def on_readmit(self, worker: int, info: dict) -> None:
        pass


class CenterReactor(Reactor):
    """EASGD/ASGD shrink without stopping: a left/demoted island's pushes
    are DROPPED at the center (zombie pushes from a half-dead process can't
    pollute it) while pulls still serve — the island keeps training locally
    and, on readmit/rejoin, restores from the center and re-enters.

    Works against an in-process :class:`~.async_easgd.ElasticCenter` or a
    :class:`~.center_server.RemoteCenter`.  A remote op failing because
    the center is DOWN (the supervisor may be mid-respawn of that very
    center) is remembered, not raised — the supervisor's tick calls
    :meth:`flush_pending` so the latest intended state lands once the
    center answers again."""

    def __init__(self, center):
        self.center = center
        self._pending: Dict[int, str] = {}    # island -> demote | readmit

    def _call(self, island: int, what: str) -> None:
        try:
            if what == "demote":
                self.center.demote_island(island)
            else:
                self.center.readmit_island(island)
            self._pending.pop(island, None)
        except ConnectionError as e:           # incl. wire.WireGiveUp
            if self._pending.get(island) != what:  # log intent once, not
                print(f"membership: center {what}({island}) deferred — "
                      f"center unreachable ({e!r})", file=sys.stderr,
                      flush=True)                  # every flush retry
            self._pending[island] = what       # latest intent wins

    def flush_pending(self) -> None:
        for island, what in list(self._pending.items()):
            self._call(island, what)

    def on_leave(self, worker, info):
        self._call(worker, "demote")

    def on_demote(self, worker, info):
        self._call(worker, "demote")

    def on_join(self, worker, info):
        self._call(worker, "readmit")

    def on_readmit(self, worker, info):
        self._call(worker, "readmit")


class MeshReactor(Reactor):
    """In-world shrink: the exchanger's ``set_active_ranks`` over every
    rank not demoted (GoSGD's tables drawn over the active ranks, EASGD's
    and ASGD's exchange masked).  Every rank runs one, driven by the same
    controller sequence, since each rank's exchange must know the set.
    When the exchange cadence is fused into the train step's window
    (``steps_per_call > 1``) the model rebuilds its step functions
    (``ModelBase.rebuild_steps``), which keeps the optimizer state, the
    center and α as they are."""

    def __init__(self, exchanger, model=None):
        self.exchanger = exchanger
        self.model = model
        self.demoted: set = set()

    def _apply(self) -> None:
        size = getattr(self.exchanger, "size", None)
        assert size, "MeshReactor needs a prepared exchanger"
        active = [r for r in range(size) if r not in self.demoted]
        self.exchanger.set_active_ranks(active)
        if getattr(self.exchanger, "fused", False):
            # the window's step runs the exchange: rebuilt for the new set
            assert self.model is not None, (
                "MeshReactor on a fused-cadence exchanger needs the model "
                "(MeshReactor(exchanger, model=...)) so its step is rebuilt "
                "for the new active set")
            self.model.rebuild_steps()

    def on_demote(self, worker, info):
        self.demoted.add(int(worker))
        self._apply()

    def on_leave(self, worker, info):
        self.demoted.add(int(worker))
        self._apply()

    def on_join(self, worker, info):
        self.demoted.discard(int(worker))
        self._apply()

    def on_readmit(self, worker, info):
        self.demoted.discard(int(worker))
        self._apply()


# -- the controller ----------------------------------------------------------

def _load_report_module():
    """The port's run report (``tools/telemetry_report.py``, stdlib): the
    ONE windowed straggler ranking, not a re-implementation.  Imported as
    a module of the package, so an installed port has it; a missing
    report is an ImportError, never a silently disabled demotion."""
    from ..tools import telemetry_report
    return telemetry_report


class MembershipController:
    """The worker-state machine behind the elastic runtime.

    States per worker: ``live`` → (``demoted`` ⇄ ``live``) → ``dead`` /
    ``left``; every transition emits its :data:`MEMBERSHIP_EVENTS` event
    (tagged with the worker id and a reason) and fans out to the
    ``reactors``.  The controller is transport-agnostic: the
    :class:`ElasticSupervisor` feeds it process observations, ``poll()``
    folds in lease files, and a caller in the training process may drive
    ``demote``/``readmit`` directly from the straggler ranking."""

    def __init__(self, lease_dir: Optional[str] = None,
                 lease_timeout: float = 15.0, telemetry_=None,
                 reactors: Sequence[Reactor] = (),
                 record_dir: Optional[str] = None,
                 straggle_windows: int = 3,
                 straggle_window_s: float = 5.0,
                 min_active: int = 1, clock=None,
                 lease_source: Optional[Callable[[], Dict[int, dict]]]
                 = None):
        self.lease_dir = lease_dir
        # ``lease_source`` overrides WHERE lease docs come from, not what
        # they mean: poll() folds whatever mapping it returns with the
        # exact file-dir semantics (an in-memory table in a test); real
        # runs leave it None and read lease_dir.
        self.lease_source = lease_source
        self.clock = clock or WALL
        self.lease_timeout = float(lease_timeout)
        self.telemetry = telemetry_ if telemetry_ is not None \
            else telemetry.active()
        self.reactors = list(reactors)
        self.record_dir = record_dir
        self.straggle_windows = int(straggle_windows)
        self.straggle_window_s = float(straggle_window_s)
        self.min_active = max(1, int(min_active))
        # worker id -> {"status", "last_ts", "step", "pid", "joins"}
        self.workers: Dict[int, dict] = {}
        self.transitions: List[Tuple[str, int, dict]] = []

    # -- transition plumbing ------------------------------------------------

    def _emit(self, event: str, worker: int, hook: str, **info) -> None:
        self.transitions.append((event, worker, info))
        tm = self.telemetry
        if tm.enabled:
            tm.event(event, worker=int(worker), **info)
        for r in self.reactors:
            getattr(r, hook)(worker, info)

    def _entry(self, worker: int) -> dict:
        return self.workers.setdefault(int(worker), {
            "status": "new", "last_ts": 0.0, "step": 0, "pid": None,
            "joins": 0})

    # -- explicit transitions (the supervisor, a training process) ---------

    def join(self, worker: int, pid: Optional[int] = None,
             reason: str = "spawn", now: Optional[float] = None) -> None:
        st = self._entry(worker)
        rejoin = st["joins"] > 0
        st.update(status="live",
                  last_ts=self.clock.now() if now is None else now,
                  pid=pid, joins=st["joins"] + 1)
        self._emit("worker_join", worker, "on_join",
                   reason=reason, rejoin=rejoin, pid=pid)

    def leave(self, worker: int, reason: str = "exit",
              now: Optional[float] = None, **info) -> None:
        st = self._entry(worker)
        if st["status"] in ("dead", "left"):
            return
        st["status"] = "left" if reason == "finished" else "dead"
        # lease docs written BEFORE this death must not resurrect the
        # worker (a killed process's last beat can still be 'fresh')
        st["dead_ts"] = self.clock.now() if now is None else now
        self._emit("worker_leave", worker, "on_leave", reason=reason, **info)

    def demote(self, worker: int, reason: str = "straggler", **info) -> bool:
        st = self._entry(worker)
        if st["status"] != "live":
            return False
        if len(self.active_ranks()) - 1 < self.min_active:
            return False           # never demote below the active floor
        st["status"] = "demoted"
        self._emit("worker_demote", worker, "on_demote",
                   reason=reason, **info)
        return True

    def readmit(self, worker: int, reason: str = "readmit") -> None:
        st = self._entry(worker)
        if st["status"] != "demoted":
            return
        st["status"] = "live"
        # readmission forgives history: the cumulative ranking kept
        # charging this worker while it was demoted, so the NEXT
        # check_stragglers must re-baseline before judging it — without
        # this a readmitted worker is instantly re-demoted on stale
        # evidence (flapping)
        st["straggle_forgive"] = True
        self._emit("worker_join", worker, "on_readmit",
                   reason=reason, rejoin=True, pid=st.get("pid"))

    # -- center outage pair (the center is not a worker: no state-machine
    # entry, no reactor fan-out — just the audited event pair) -------------

    def center_down(self, reason: str = "crashed", **info) -> None:
        self.transitions.append(("center_down", -1, dict(info,
                                                         reason=reason)))
        tm = self.telemetry
        if tm.enabled:
            tm.event("center_down", reason=reason, **info)

    def center_restored(self, **info) -> None:
        self.transitions.append(("center_restored", -1, dict(info)))
        tm = self.telemetry
        if tm.enabled:
            tm.event("center_restored", **info)

    # -- lease polling ------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[Tuple[str, int, dict]]:
        """Fold the lease files into transitions: a fresh lease from an
        unknown (or previously dead) worker is a join; a ``left`` status is
        a clean finish; a lease older than ``lease_timeout`` is a death —
        covers both crashed AND wedged (SIGSTOPped) workers, which stop
        beating without exiting.  Returns the transitions this poll made."""
        if not (self.lease_dir or self.lease_source):
            return []
        now = self.clock.now() if now is None else now
        leases = self.lease_source() if self.lease_source is not None \
            else read_leases(self.lease_dir)
        before = len(self.transitions)
        for wid, doc in sorted(leases.items()):
            st = self.workers.get(wid)
            fresh = now - float(doc.get("ts", 0)) <= self.lease_timeout
            if doc.get("status") == "left":
                if st is not None and st["status"] in ("live", "demoted"):
                    self.leave(wid, reason="finished", now=now)
                continue
            if st is None or st["status"] in ("dead", "left", "new"):
                if fresh and (st is None or
                              float(doc.get("ts", 0)) > st.get("dead_ts", 0)):
                    self.join(wid, pid=doc.get("pid"), reason="lease",
                              now=now)
                continue
            if fresh:
                st["last_ts"] = float(doc["ts"])
                st["step"] = int(doc.get("step", st["step"]))
        for wid, st in self.workers.items():
            if st["status"] in ("live", "demoted") and \
                    now - st["last_ts"] > self.lease_timeout:
                self.leave(wid, reason="lease_expired", now=now,
                           age=round(now - st["last_ts"], 1))
        return self.transitions[before:]

    # -- straggler loop -----------------------------------------------------

    def straggler_ranking(self) -> List[dict]:
        """The windowed ranking from ``tools/telemetry_report.py`` over
        this run's merged per-rank streams (``record_dir``).  When the
        streams carry causal-tracing ``span`` events, the report's
        root-cause table is computed from the SAME parse and stashed for
        :meth:`check_stragglers` to cite in its demote events."""
        if not self.record_dir:
            return []
        mod = _load_report_module()
        events = mod.load_events(self.record_dir)
        rc_fn = getattr(mod, "straggler_root_cause", None)
        if rc_fn is not None:
            try:
                # RECENT windows only: the citation must name what
                # dominated the rounds that are TRIGGERING the demotion,
                # not the whole run's average (a worker can be compute-
                # bound for an hour, then queue-bound into its demotion)
                # — and assembling only the recent slice bounds the
                # per-poll trace cost on long runs.  The cumulative
                # ranking below still reads the FULL stream by contract
                # (windows_straggled/straggle_base count since run
                # start).
                horizon = self.clock.now() - \
                    4 * max(1, self.straggle_windows) * \
                    self.straggle_window_s
                recent = [e for e in events
                          if e.get("ts", 0) >= horizon]
                self._root_cause = rc_fn(recent, self.straggle_window_s)
            except Exception:
                self._root_cause = {}
        return mod.straggler_ranking(events, self.straggle_window_s)

    def check_stragglers(self, ranking: Optional[List[dict]] = None
                         ) -> List[int]:
        """Demote every live rank charged ≥ ``straggle_windows`` straggles
        by the windowed ranking (injectable for tests; sourced from the
        telemetry streams otherwise).  Single-rank rankings are ignored —
        with no peer to compare against, 'slowest' is meaningless.

        When the run carries distributed traces, each demote event cites
        the straggler root-cause table's verdict for that worker — WHICH
        component (compute | stage | wire | queue | apply) dominated its
        rounds — so 'demoted: straggler' comes with a cause, not just a
        symptom."""
        ranking = self.straggler_ranking() if ranking is None else ranking
        if len(ranking) < 2:
            return []
        root_cause = getattr(self, "_root_cause", {}) or {}
        demoted: List[int] = []
        for row in ranking:
            wid = int(row["rank"])
            ws = int(row.get("windows_straggled", 0))
            # the ranking is CUMULATIVE over the run: judge a worker on the
            # windows straggled SINCE its last demotion, or a readmitted
            # (recovered) worker would be instantly re-demoted forever on
            # the evidence that got it demoted the first time
            st = self.workers.get(wid, {})
            if st.get("straggle_forgive"):
                st["straggle_base"] = ws
                st["straggle_forgive"] = False
            base = st.get("straggle_base", 0)
            if ws - base < self.straggle_windows:
                continue
            cause = root_cause.get(wid) or root_cause.get(str(wid)) or {}
            if self.demote(wid, reason="straggler", windows_straggled=ws,
                           mean_train_secs=row.get("mean_train_secs"),
                           component=cause.get("dominant")):
                self.workers[wid]["straggle_base"] = ws
                demoted.append(wid)
        return demoted

    # -- views --------------------------------------------------------------

    def active_ranks(self) -> List[int]:
        return sorted(w for w, st in self.workers.items()
                      if st["status"] == "live")

    def status(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {"live": [], "demoted": [], "dead": [],
                                     "left": []}
        for w, st in sorted(self.workers.items()):
            out.setdefault(st["status"], []).append(w)
        return out


# -- the elastic supervisor --------------------------------------------------

class ElasticSupervisor:
    """Spawn/monitor/respawn elastic worker subprocesses around a
    :class:`MembershipController`.

    ``cmd_for(worker_id, attempt)`` builds the worker's argv (attempt 0 is
    the first spawn; respawns pass the attempt count so the command can add
    e.g. ``resume=true``).  A worker exiting 0 is finished; any other death
    (nonzero exit, signal, lease expiry while the process is wedged) is a
    ``worker_leave`` followed — after :class:`Backoff` — by a respawn and
    ``worker_join``, up to ``max_restarts`` per worker.  Failures clustering
    inside the :class:`CrashLoopBreaker` window stop the world with the
    flight-recorder tail printed."""

    #: the supervised center's id in chaos schedules and lease files —
    #: worker ids are 1-based in ``run_elastic``, so 0 is free
    CENTER_ID = 0

    def __init__(self, cmd_for: Callable[[int, int], List[str]],
                 worker_ids: Sequence[int], lease_dir: str, *,
                 record_dir: Optional[str] = None,
                 lease_timeout: float = 15.0, poll_s: float = 0.25,
                 backoff: Optional[Backoff] = None, max_restarts: int = 3,
                 crash_limit: int = 5, crash_window_s: float = 120.0,
                 telemetry_=None, reactors: Sequence[Reactor] = (),
                 straggle_windows: int = 0, straggle_poll_s: float = 10.0,
                 center_cmd_for: Optional[Callable[[int], List[str]]] = None,
                 center_addr: Optional[str] = None,
                 center_max_restarts: int = 5,
                 center_lease_dir: Optional[str] = None,
                 verbose: bool = True, clock=None, fleetmon=None):
        self.cmd_for = cmd_for
        self.worker_ids = [int(w) for w in worker_ids]
        self.lease_dir = lease_dir
        self.record_dir = record_dir
        self.poll_s = float(poll_s)
        self.clock = clock or WALL
        self.backoff = backoff or Backoff()
        self.max_restarts = int(max_restarts)
        self.breaker = CrashLoopBreaker(crash_limit, crash_window_s,
                                        clock=self.clock)
        self.verbose = verbose
        self.controller = MembershipController(
            lease_dir=lease_dir, lease_timeout=lease_timeout,
            telemetry_=telemetry_, reactors=reactors,
            record_dir=record_dir, straggle_windows=straggle_windows or 3,
            clock=self.clock)
        self._straggle_enabled = straggle_windows > 0
        self._straggle_poll_s = float(straggle_poll_s)
        self._last_straggle_check = 0.0
        self.procs: Dict[int, subprocess.Popen] = {}
        self.attempts: Dict[int, int] = {w: 0 for w in self.worker_ids}
        self.done: set = set()
        self.failed: set = set()
        self._pending: List[Tuple[float, int]] = []   # (due_ts, worker)
        # -- supervised center process: the center is respawned
        # from its snapshot like a worker — lease + backoff + breaker —
        # while the clients ride the outage out on wire retries
        self.center_cmd_for = center_cmd_for
        self.center_addr = center_addr
        self.center_max_restarts = int(center_max_restarts)
        # the center's lease lives in its OWN dir: controller.poll() folds
        # every lease under lease_dir into WORKER transitions, and the
        # center is not a worker
        self.center_lease_dir = center_lease_dir
        self.center_proc: Optional[subprocess.Popen] = None
        self.center_attempts = 0
        self._center_due: Optional[float] = None      # pending respawn ts
        self._center_probe = False                    # awaiting restored?
        self._center_downs = 0
        # -- the fleet monitor: a
        # FleetMonServer whose collector's actionable alerts this loop
        # drains — the alert-driven half of supervision
        self.fleetmon = fleetmon
        self.alert_demotions: List[Tuple[str, int]] = []
        self.flight_dumps_requested = 0

    # chaos harness hook: the CURRENT pid of a worker (None between lives);
    # target CENTER_ID resolves the supervised center process
    def pid_of(self, worker_id: int) -> Optional[int]:
        if int(worker_id) == self.CENTER_ID and \
                self.center_cmd_for is not None:
            p = self.center_proc
            return p.pid if p is not None and p.poll() is None else None
        p = self.procs.get(int(worker_id))
        return p.pid if p is not None and p.poll() is None else None

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"elastic: {msg}", file=sys.stderr, flush=True)

    def _spawn(self, wid: int) -> None:
        attempt = self.attempts[wid]
        cmd = self.cmd_for(wid, attempt)
        self.procs[wid] = subprocess.Popen(cmd)
        self.attempts[wid] = attempt + 1
        self.controller.join(wid, pid=self.procs[wid].pid,
                             reason="respawn" if attempt else "spawn")
        self._log(f"worker {wid} spawned (pid {self.procs[wid].pid}, "
                  f"attempt {attempt})")

    # -- center supervision -------------------------------------------------

    def _spawn_center(self) -> None:
        cmd = self.center_cmd_for(self.center_attempts)
        self.center_proc = subprocess.Popen(cmd)
        self.center_attempts += 1
        self._center_due = None
        self._center_probe = True      # emit center_restored on first answer
        self._log(f"center spawned (pid {self.center_proc.pid}, "
                  f"attempt {self.center_attempts - 1})")

    def _center_answers(self) -> bool:
        """Non-blocking-ish probe: does the center accept on its fixed
        port?  Called once per tick only while awaiting a restore."""
        import socket
        host, port = str(self.center_addr).rsplit(":", 1)
        try:
            socket.create_connection((host, int(port)), timeout=0.2).close()
            return True
        except OSError:
            return False

    def _tick_center(self) -> bool:
        """One supervision tick for the center process.  True when the
        center crash-looped past its budget (caller stops the world)."""
        if self.center_cmd_for is None:
            return False
        now = self.clock.now()
        p = self.center_proc
        # a WEDGED center (alive, not beating — SIGSTOP, hung handler) is
        # as gone as a dead one: kill it, the death branch below respawns
        if p is not None and p.poll() is None and self.center_lease_dir \
                and not self._center_probe:
            doc = read_leases(self.center_lease_dir).get(self.CENTER_ID)
            if doc is not None and \
                    now - float(doc.get("ts", 0)) > \
                    self.controller.lease_timeout:
                self._log("center lease expired while wedged — killing it")
                self._center_wedged = True
                try:
                    p.kill()
                    p.wait(timeout=30)
                except Exception:
                    pass
        if p is not None and p.poll() is not None:
            rc = p.returncode
            self.center_proc = None
            self._center_downs += 1
            reason = "wedged" if getattr(self, "_center_wedged", False) \
                else "crashed"
            self._center_wedged = False
            self.controller.center_down(
                reason=reason, rc=rc, downs=self._center_downs)
            if self.breaker.record_failure():
                self._log("center crash tripped the crash-loop breaker "
                          "— stopping the world")
                return True
            if self.center_attempts > self.center_max_restarts:
                self._log(f"center exhausted {self.center_max_restarts} "
                          f"restarts — stopping the world")
                return True
            delay = self.backoff.delay(self.center_attempts - 1)
            self._log(f"center died (rc={rc}); respawn from snapshot "
                      f"in {delay:.1f}s — clients ride it out on wire "
                      f"retries")
            self._center_due = now + delay
        if self._center_due is not None and now >= self._center_due:
            self._spawn_center()
        if self._center_probe and self.center_proc is not None and \
                self.center_addr and self._center_answers():
            self._center_probe = False
            # first spawn is not a restoration — the pair the chaos gate
            # audits is down → restored
            if self._center_downs:
                self.controller.center_restored(
                    attempt=self.center_attempts - 1)
                self._log("center restored — serving again")
        # let deferred demote/readmit intents land on the revived center —
        # only once it answers (each flush attempt against a dead center
        # blocks this loop for the reactor client's retry budget)
        if not self._center_probe:
            for r in self.controller.reactors:
                flush = getattr(r, "flush_pending", None)
                if flush is not None:
                    flush()
        return False

    # -- alert-driven supervision --------------------------------------------

    def _tick_fleetmon(self) -> None:
        """Drain the collector's actionable alerts: a per-rank ``demote``
        alert feeds the EXISTING demotion path with the firing rule
        cited in the ``worker_demote`` event (``fleetmon.apply_alert``),
        and a fleet-scoped ``flight_dump`` alert asks every statusz
        endpoint for its flight ring.  The supervisor also ingests its
        own liveness sample, so the fleet view includes it."""
        fm = self.fleetmon
        if fm is None:
            return
        from ..utils import fleetmon as _fleetmon
        fm.collector.ingest({"steps": float(len(self.done))}, rank=-2,
                            role="supervisor")
        for alert in fm.collector.pop_actions():
            if alert.get("action") == "demote":
                if _fleetmon.apply_alert(self.controller, alert):
                    self.alert_demotions.append(
                        (str(alert.get("rule")), int(alert["rank"])))
                    self._log(f"alert {alert['rule']} "
                              f"(value {alert.get('value')}) demoted "
                              f"worker {alert['rank']}")
            elif alert.get("action") == "flight_dump" and self.record_dir:
                paths = _fleetmon.fleet_flight_dump(
                    self.record_dir, reason=f"alert {alert.get('rule')}")
                self.flight_dumps_requested += 1
                self._log(f"alert {alert['rule']}: fleet-wide flight "
                          f"dump ({len(paths)} ring(s) written)")

    def _stop_center(self) -> None:
        p = self.center_proc
        if p is None:
            return
        try:
            if p.poll() is None:
                p.terminate()          # SIGTERM: final snapshot + lease
                try:
                    p.wait(timeout=15)
                except Exception:
                    p.kill()
                    p.wait(timeout=15)
        except OSError:
            pass
        self.center_proc = None

    def _kill_all(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except Exception:
                pass
        self._stop_center()

    def _on_death(self, wid: int, rc: Optional[int], reason: str) -> bool:
        """Record a death; schedule the respawn.  True when the crash-loop
        breaker tripped (caller stops the world)."""
        self.controller.leave(wid, reason=reason, rc=rc)
        if self.breaker.record_failure():
            self._log(f"crash-loop breaker tripped "
                      f"({self.breaker.limit} failures within "
                      f"{self.breaker.window_s:.0f}s) — stopping the world")
            if self.record_dir:
                for line in flight_tail_lines(self.record_dir):
                    print(line, file=sys.stderr, flush=True)
            return True
        if self.attempts[wid] > self.max_restarts:
            self._log(f"worker {wid} exhausted {self.max_restarts} restarts "
                      f"— giving up on it")
            self.failed.add(wid)
            return False
        delay = self.backoff.delay(self.attempts[wid] - 1)
        self._log(f"worker {wid} {reason} (rc={rc}); respawn in {delay:.1f}s")
        self._pending.append((self.clock.now() + delay, wid))
        return False

    def run(self, timeout_s: float = 600.0) -> int:
        """Run the elastic world until every worker finished (rc 0): 0 — or
        nonzero on breaker trip / restart exhaustion / timeout."""
        t0 = self.clock.now()
        # live ops endpoint: the supervisor is a long-lived process
        # too — fleetz shows its view of the fleet next to the workers'
        statusz = None
        if self.record_dir:
            statusz = tracing.StatuszServer(
                "supervisor", ident=0, run_dir=self.record_dir,
                telemetry_=self.controller.telemetry,
                extra=lambda: {"workers": self.controller.status(),
                               "done": sorted(self.done),
                               "failed": sorted(self.failed),
                               "center_downs": self._center_downs,
                               "alert_demotions": len(self.alert_demotions)})
            statusz.start()
        if self.center_cmd_for is not None:
            self._spawn_center()
        for wid in self.worker_ids:
            self._spawn(wid)
        try:
            while True:
                # 0. the supervised center: death → center_down → backoff
                # respawn-from-snapshot → center_restored when it answers
                if self._tick_center():
                    self._kill_all()
                    return 1
                # 1. process deaths
                for wid, p in list(self.procs.items()):
                    if wid in self.done or wid in self.failed:
                        continue
                    rc = p.poll()
                    if rc is None:
                        continue
                    del self.procs[wid]
                    if rc == 0:
                        self.done.add(wid)
                        self.controller.leave(wid, reason="finished")
                        self._log(f"worker {wid} finished")
                    elif self._on_death(wid, rc, "crashed"):
                        self._kill_all()
                        return 1
                # 2. lease expiry of WEDGED workers (process alive, no
                # heartbeats — SIGSTOP, hung collective): kill + respawn
                for ev, wid, info in self.controller.poll():
                    if ev == "worker_leave" and \
                            info.get("reason") == "lease_expired" and \
                            wid in self.procs:
                        p = self.procs.pop(wid)
                        try:
                            p.kill()
                            p.wait(timeout=30)
                        except Exception:
                            pass
                        self._log(f"worker {wid} lease expired while "
                                  f"wedged — killed")
                        if self._on_death(wid, p.returncode, "wedged"):
                            self._kill_all()
                            return 1
                # 3. persistent-straggler demotion (off unless enabled;
                # throttled — the ranking re-reads the whole record_dir,
                # which grows with the run: not per-0.25s-tick work)
                if self._straggle_enabled and \
                        self.clock.now() - self._last_straggle_check > \
                        self._straggle_poll_s:
                    self._last_straggle_check = self.clock.now()
                    self.controller.check_stragglers()
                # 3b. alert-driven supervision: drain the fleet-health
                # collector's actionable alerts (rule-cited demotions,
                # fleet-wide flight dumps)
                self._tick_fleetmon()
                # 4. due respawns
                now = self.clock.now()
                due = [w for ts, w in self._pending if ts <= now]
                self._pending = [(ts, w) for ts, w in self._pending
                                 if ts > now]
                for wid in due:
                    self._spawn(wid)
                # 5. exit conditions
                if len(self.done | self.failed) == len(self.worker_ids):
                    return 0 if not self.failed else 1
                if self.clock.now() - t0 > timeout_s:
                    self._log(f"timeout after {timeout_s:.0f}s — "
                              f"stopping the world")
                    self._kill_all()
                    return 1
                self.clock.sleep(self.poll_s)
        finally:
            self._kill_all()
            if statusz is not None:
                # exception-unwinding supervisor keeps its roster entry
                statusz.stop(deregister=sys.exc_info()[0] is None)


# -- elastic worker CLI ------------------------------------------------------

def parse_kv(items: Sequence[str]) -> Dict[str, Any]:
    """``key=value`` config parsing with the worker CLI's coercions."""
    config: Dict[str, Any] = {}
    for kv in items:
        k, _, v = kv.partition("=")
        try:
            config[k] = int(v)
        except ValueError:
            try:
                config[k] = float(v)
            except ValueError:
                config[k] = {"true": True, "false": False}.get(v.lower(), v)
    return config


def _host_devices(k: int) -> int:
    """``host_devices`` (the JAX package's CPU venue of ``k`` simulated
    chips): 0 runs the island on the card, 1 on the CPU; more is refused.
    An island of ``k > 1`` devices is ``k`` processes in the port, one a
    rank of a launched world (``launcher --n-workers``), not one elastic
    process."""
    k = int(k or 0)
    if k > 1:
        raise NotImplementedError(
            f"host_devices={k}: an island of {k} devices is {k} processes "
            f"in the port, one a rank of a launched world (python -m "
            f"theanompi_tpu_torch.launcher --n-workers {k}); an elastic "
            f"island is one process of one device (host_devices 1 runs it "
            f"on the CPU, 0 on the card)")
    return k


def elastic_worker_main(argv: Optional[Sequence[str]] = None) -> int:
    """One elastic island: ``python -m
    theanompi_tpu_torch.parallel.membership <rule> <modelfile> <modelclass>
    [key=value ...]``.

    Keys: ``center_addr`` (the EASGD/ASGD center server), ``island`` (the
    worker id, also the telemetry rank), ``lease_dir`` (heartbeats),
    ``steps`` (the local-step goal, then exit 0), ``host_devices`` (1: the
    island runs on the CPU), ``metrics_addr`` (the fleet monitor),
    ``max_seconds``, plus the model's config.  On a (re)join the island
    restores its params from the center (``center_restore``, default
    true) and trains at its own pace: the asynchronous algebra needs no
    barrier with the others."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        print("usage: python -m theanompi_tpu_torch.parallel.membership "
              "<rule> <modelfile> <modelclass> [key=value ...]")
        return 2
    rule, modelfile, modelclass = argv[:3]
    cfg = parse_kv(argv[3:])

    if _host_devices(cfg.pop("host_devices", 0)):
        # the CPU venue asked for explicitly; nothing else defaults an
        # island to the CPU on a machine with a card
        cfg["device"] = "cpu"
    island = int(cfg.get("island", 0))
    steps_goal = int(cfg.get("steps", 32))
    deadline = time.time() + float(cfg.get("max_seconds", 600))
    tm = telemetry.init({"record_dir": cfg.get("record_dir"),
                         "rank": island, "run_id": cfg.get("run_id"),
                         "telemetry": cfg.get("telemetry"),
                         "telemetry_flush_every":
                             cfg.get("telemetry_flush_every", 64)})
    # tracing=true mints a trace per exchange round in the island loop,
    # propagated over the wire to the center
    tracing.init(cfg)
    lease = WorkerLease(cfg["lease_dir"], island, telemetry_=tm) \
        if cfg.get("lease_dir") else None
    if lease:
        # alive before torch's import and the model's build: everything
        # above this line is stdlib, so the spawn-to-first-beat window
        # cannot outlive a lease
        lease.beat(0)

    import importlib

    mod = importlib.import_module(modelfile)
    cls = getattr(mod, modelclass)

    def factory(c):
        c = dict(c)
        c.setdefault("verbose", False)
        return cls(c)

    from .async_easgd import AsyncEASGDTrainer
    cfg.setdefault("async_islands", 1)
    cfg.setdefault("island_base", island)
    cfg.setdefault("center_restore", True)
    trainer_cfg = dict(cfg)
    # this process owns the lease (it beats from before the trainer
    # exists) and the telemetry (rank = the island id): the trainer must
    # neither register a second lease nor re-initialize telemetry
    for k in ("lease_dir", "record_dir", "telemetry", "tracing"):
        trainer_cfg.pop(k, None)
    trainer = AsyncEASGDTrainer(factory, trainer_cfg, rule=rule)
    trainer.start()
    statusz = None
    if tm.enabled and cfg.get("record_dir") and cfg.get("statusz", True):
        statusz = tracing.StatuszServer(
            "worker", ident=island, run_dir=cfg["record_dir"],
            telemetry_=tm,
            extra=lambda: {
                "steps": trainer.islands[0].steps_done,
                "exchanges": trainer.islands[0].exchanges_done,
                "skipped": trainer.islands[0].exchanges_skipped})
        statusz.start()
    # the fleet monitor: this island's metric snapshots stream to the
    # run's collector; the stream doubles as the health heartbeat (a kill
    # or a wedge silences it).  Its divergence is the largest ‖delta‖
    # since the last snapshot: a one-exchange spike is never overwritten
    # unseen between two samples
    streamer = None
    interval = float(cfg.get("metrics_interval_s", 1.0))
    if cfg.get("metrics_addr"):
        from ..utils.fleetmon import MetricStreamer
        streamer = MetricStreamer(
            str(cfg["metrics_addr"]), rank=island, role="worker",
            interval_s=interval, telemetry_=tm,
            extra=lambda: {"steps": trainer.islands[0].steps_done,
                           "divergence": trainer.islands[0].take_dist_peak()})
        streamer.start()
    rc = 0
    t_snap = 0.0
    try:
        while True:
            isl = trainer.islands[0]
            if lease:
                lease.beat(isl.steps_done)
            if streamer is not None and tm.enabled and \
                    time.time() - t_snap >= interval:
                # the card's memory gauges (hbm_min_headroom_bytes) for
                # the streamer, read off the training thread
                t_snap = time.time()
                tm.system_snapshot(iter=isl.steps_done)
            if isl.error is not None:
                rc = 1
                break
            if isl.steps_done >= steps_goal:
                break
            if time.time() > deadline:
                rc = 3
                break
            time.sleep(0.1)
        trainer.stop_and_join(timeout=120)
    except BaseException:
        rc = 1
        raise
    finally:
        if streamer is not None:
            # a clean exit sends one final `left` sample so the collector
            # retires this rank instead of alerting on its silence
            streamer.stop(final=(rc == 0))
        if statusz is not None:
            # a failed island keeps its discovery doc: listed as down
            statusz.stop(deregister=(rc == 0))
        if lease:
            if rc == 0:
                lease.release()
            else:
                lease.beat(status="dying", rc=rc)
        if tm.enabled:
            tm.event("train_end", steps=trainer.islands[0].steps_done,
                     exchanges=trainer.islands[0].exchanges_done)
            tm.close()
    return rc


# -- launcher-facing composition --------------------------------------------

def _free_port(host: str = "127.0.0.1") -> int:
    """A port the center process can bind — chosen ONCE so clients
    reconnect to the same address across center restarts."""
    import socket
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_elastic(rule: str, modelfile: str, modelclass: str,
                config: Dict[str, Any], n_workers: int, *,
                record_dir: Optional[str] = None, steps: int = 32,
                host_devices: int = 0, supervisor_kw: Optional[dict] = None,
                chaos_schedule=None, net_chaos_schedule=None,
                center_proc: bool = False, timeout_s: float = 600.0,
                verbose: bool = True) -> int:
    """One elastic run: a center server and ``n_workers`` island
    processes (ids 1..n) under an :class:`ElasticSupervisor`; ``launcher
    --elastic`` lands here.  ``host_devices`` 1 runs the islands on the
    CPU; 0 (the default) on the card.  BSP has no shrink algebra: its
    answer to a lost rank is ``launcher --supervise``.

    ``center_proc=True`` runs the center as a supervised process of its
    own (a fixed port, crash-atomic snapshots, a respawn from the snapshot
    after a backoff; its death and rebirth are the ``center_down`` /
    ``center_restored`` pair), which a ``chaos_schedule`` aimed at worker 0,
    the center, needs.  ``net_chaos_schedule`` puts a
    :class:`~..utils.chaos.ChaosProxy` between the islands and the center.
    With ``fleetmon`` in ``config`` a :class:`~..utils.fleetmon.FleetMonServer`
    collects every process's metric snapshots (``fleetmon_divergence``,
    ``fleetmon_heartbeat_s``, ``fleetmon_step_p99_s``,
    ``fleetmon_eval_s`` shape its rules), and the supervisor acts on its
    alerts."""
    _host_devices(host_devices)
    rule = rule.lower()
    if rule not in ("easgd", "asgd"):
        raise ValueError(
            f"elastic process membership needs a center-based rule "
            f"(easgd/asgd), got {rule!r} — BSP preemption tolerance is "
            f"`launcher --supervise` (world restart from the newest "
            f"checkpoint); GoSGD demotion is in-mesh "
            f"(Exchanger.set_active_ranks)")
    from .center_server import (CenterServer, RemoteCenter, load_snapshot,
                                snapshot_path)
    record_dir = record_dir or config.get("record_dir")
    lease_dir = config.get("lease_dir") or (
        os.path.join(record_dir, "membership") if record_dir else None)
    assert lease_dir, "run_elastic needs record_dir or lease_dir"
    run_id = config.get("run_id") or f"elastic{int(time.time())}"
    tm = telemetry.init({"record_dir": record_dir, "rank": 0,
                         "run_id": run_id}) if record_dir else \
        telemetry.active()

    alpha = float(config.get("alpha", 0.5))
    chost = str(config.get("center_host", "127.0.0.1"))
    srv = None
    center_kw: Dict[str, Any] = {}
    snap_dir = None
    if center_proc:
        assert record_dir, "center_proc needs a record_dir (snapshots)"
        port = int(config.get("center_port", 0)) or _free_port(chost)
        addr = f"{chost}:{port}"
        snap_dir = os.path.join(record_dir, "center_snap")
        center_lease_dir = os.path.join(lease_dir, "center")

        def center_cmd_for(attempt: int) -> List[str]:
            cmd = [sys.executable, "-m",
                   "theanompi_tpu_torch.parallel.center_server",
                   "--host", chost, "--port", str(port),
                   "--alpha", str(alpha),
                   "--snapshot-dir", snap_dir,
                   "--snapshot-every",
                   str(config.get("center_snapshot_every_s", 1.0)),
                   "--lease-dir", center_lease_dir,
                   "--lease-id", str(ElasticSupervisor.CENTER_ID),
                   "--run-id", str(run_id)]
            if record_dir:
                cmd += ["--record-dir", record_dir]
            if metrics_addr:
                # bound at spawn time: the fleetmon server starts before
                # the supervisor spawns anything
                cmd += ["--metrics-addr", metrics_addr]
            return cmd

        # the supervisor's own client: SHORT deadline — reactor calls and
        # probes must never stall the supervision loop that is busy
        # respawning the very center they are waiting for
        center_handle = RemoteCenter(addr, alpha=alpha,
                                     client_id="supervisor",
                                     op_timeout_s=5.0, max_retries=2,
                                     deadline_s=8.0, telemetry_=tm)
        center_kw = dict(center_cmd_for=center_cmd_for, center_addr=addr,
                         center_lease_dir=center_lease_dir)
    else:
        srv = CenterServer(alpha=alpha)
        host, port = srv.start(chost, int(config.get("center_port", 0)))
        addr = f"{host}:{port}"
        center_handle = srv.center

    # wire-level chaos: the proxy sits between the WORKERS and the center
    # (the supervisor's membership ops take the direct road — the faults
    # under test are the training wire's)
    # every landed fault (process AND wire level) appends to the run's
    # realized-schedule log, from which the run can be replayed.  Truncate any previous run's file:
    # the writers append, and a merged two-run history would replay
    # every fault twice
    realized = os.path.join(record_dir, "chaos_realized.jsonl") \
        if record_dir else None
    if realized and os.path.exists(realized):
        try:
            os.remove(realized)
        except OSError:
            realized = None
    # `corrupt` faults land as trigger files here; each island polls the
    # dir at its exchange rounds (async_easgd) and perturbs its own live
    # params; the numerics beacon must then catch the desync
    corrupt_dir = os.path.join(record_dir, "chaos") \
        if (record_dir and chaos_schedule) else None
    proxy = None
    worker_addr = addr
    if net_chaos_schedule:
        from ..utils.chaos import ChaosProxy
        proxy = ChaosProxy(addr, net_chaos_schedule, telemetry_=tm,
                           realized_path=realized)
        worker_addr = proxy.start()

    # the fleet monitor: a FleetCollector
    # service every process streams metric snapshots to; its rule engine
    # emits `alert` events into the run's telemetry stream and queues
    # actionable alerts the supervisor loop drains.  The metrics wire is
    # DIRECT (never through the chaos proxy): observability must survive
    # the faults it reports on.
    fleetmon_srv = None
    metrics_addr = None
    if record_dir and config.get("fleetmon"):
        from ..utils.fleetmon import FleetMonServer, default_rules
        divergence = config.get("fleetmon_divergence")
        rules = config.get("fleetmon_rules") or default_rules(
            heartbeat_s=float(config.get("fleetmon_heartbeat_s", 10.0)),
            step_p99_s=config.get("fleetmon_step_p99_s"),
            step_window_s=float(config.get("fleetmon_step_window_s", 10.0)),
            divergence=None if divergence is None else float(divergence))
        fleetmon_srv = FleetMonServer(
            rules=rules, run_dir=record_dir,
            snapshot_dir=os.path.join(record_dir, "fleetmon_snap"),
            eval_window_s=float(config.get("fleetmon_eval_s", 2.0)),
            telemetry_=tm)
        fh, fp = fleetmon_srv.start()
        metrics_addr = f"{fh}:{fp}"

    base_kv = dict(config)
    for drop in ("lease_dir", "record_dir", "run_id", "center_addr",
                 "rule", "n_workers", "fleetmon", "fleetmon_rules",
                 "fleetmon_heartbeat_s", "fleetmon_step_p99_s",
                 "fleetmon_step_window_s", "fleetmon_eval_s",
                 "fleetmon_divergence"):
        base_kv.pop(drop, None)

    def cmd_for(wid: int, attempt: int) -> List[str]:
        kv = dict(base_kv)
        kv.update(island=wid, center_addr=worker_addr, lease_dir=lease_dir,
                  steps=steps, host_devices=host_devices, run_id=run_id)
        if record_dir:
            kv["record_dir"] = record_dir
        if corrupt_dir:
            kv["chaos_dir"] = corrupt_dir
        if metrics_addr:
            kv["metrics_addr"] = metrics_addr
        return [sys.executable, "-m",
                "theanompi_tpu_torch.parallel.membership",
                rule, modelfile, modelclass] + \
            [f"{k}={v}" for k, v in sorted(kv.items())]

    kw = dict(record_dir=record_dir, telemetry_=tm,
              reactors=(CenterReactor(center_handle),), verbose=verbose,
              fleetmon=fleetmon_srv)
    kw.update(center_kw)
    kw.update(supervisor_kw or {})
    sup = ElasticSupervisor(cmd_for, list(range(1, n_workers + 1)),
                            lease_dir, **kw)
    # progress-gated chaos: fault times are relative to the run MAKING
    # PROGRESS (first lease beat with step >= 1), not to process spawn —
    # a loaded box's slow first compile must not eat the schedule's whole
    # window before training even exists (the kill-lands-mid-run
    # guarantee the chaos tests assert).  Bounded fallback: if no step
    # ever beats, the monkey starts anyway so no-pid drops still resolve.
    monkey_box: List[Any] = []
    gate_halt = threading.Event()
    if chaos_schedule:
        from ..utils.chaos import ChaosMonkey

        def _gated_start():
            deadline = time.time() + min(120.0, float(timeout_s))
            while time.time() < deadline and not gate_halt.is_set():
                if any(int(doc.get("step", 0)) >= 1
                       for doc in read_leases(lease_dir).values()):
                    break
                time.sleep(0.1)
            if gate_halt.is_set():
                return
            m = ChaosMonkey(chaos_schedule, pid_of=sup.pid_of,
                            telemetry_=tm, realized_path=realized,
                            corrupt_dir=corrupt_dir)
            monkey_box.append(m)
            m.start()

        threading.Thread(target=_gated_start, daemon=True,
                         name="chaos-gate").start()
    try:
        rc = sup.run(timeout_s=timeout_s)
    finally:
        gate_halt.set()
        for m in monkey_box:
            m.stop()
        if proxy is not None:
            proxy.stop()
        # persist the final center + its bookkeeping for offline eval
        # (a chaos run's loss gate and applied-once audit)
        try:
            import numpy as np
            leaves = None
            stats = None
            if center_proc:
                # sup.run's exit SIGTERMed the center, which wrote a
                # final crash-atomic snapshot — the authoritative final
                # state whether the run ended cleanly or under chaos
                if snap_dir and os.path.exists(snapshot_path(snap_dir)):
                    leaves, meta = load_snapshot(snapshot_path(snap_dir))
                    dd = meta.get("dedup") or {}
                    stats = {"n_updates": meta.get("n_updates", 0),
                             "by_island": meta.get("updates_by_island",
                                                   {}),
                             "demoted": meta.get("demoted", []),
                             "dropped_by_island":
                                 meta.get("dropped_by_island", {}),
                             "dedup_hits": dd.get("hits", 0),
                             "seq_hwm": dd.get("hwm", {})}
            else:
                leaves = srv.center.pull_leaves()
                stats = {"ok": True, **srv.center.stats_snapshot(),
                         "dedup_hits": srv.dedup.hits,
                         "seq_hwm": srv.dedup.hwm_snapshot()}
            if record_dir and leaves is not None:
                with open(os.path.join(record_dir, "center_final.npz"),
                          "wb") as f:
                    np.savez(f, **{f"leaf{i}": x
                                   for i, x in enumerate(leaves)})
            if record_dir and stats is not None:
                stats = {k: v for k, v in stats.items()
                         if k not in ("ok", "v", "crc", "tok")}
                stats["center_downs"] = sup._center_downs
                if proxy is not None:
                    # frames the proxy actually faulted per kind — the
                    # audit tells 'dup window opened but no traffic
                    # passed' apart from 'duplicates were re-applied'
                    stats["net_frames_faulted"] = \
                        dict(proxy.frames_faulted)
                with open(os.path.join(record_dir, "center_stats.json"),
                          "w") as f:
                    json.dump(stats, f, indent=1, sort_keys=True)
        except Exception:
            pass
        if center_proc:
            sup._stop_center()
            try:
                center_handle.close()
            except Exception:
                pass
        if srv is not None:
            srv.stop()
        if fleetmon_srv is not None:
            fleetmon_srv.stop()
        if tm.enabled:
            tm.event("elastic_end", rc=rc,
                     status=sup.controller.status())
            tm.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(elastic_worker_main())
