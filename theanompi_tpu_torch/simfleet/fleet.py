"""FleetSim: the virtual fleet — real survivability logic, simulated
everything else.

Counterpart of ``theanompi_tpu/simfleet/fleet.py``.  "Real" below means
the port's own production copies: ``parallel/membership.py``,
``parallel/topology.py``, ``parallel/wire.py`` and ``utils/chaos.py`` of
``theanompi_tpu_torch``.  For the same arguments the event log is byte for
byte the JAX FleetSim's (``tests/test_torch_simfleet.py`` holds the two).

One seeded run drives N simulated workers (default 1,000) through
exchange rounds against a sharded center and a gossip mesh, while a
chaos schedule (the REAL ``utils/chaos.py`` grammar) kills, wedges, and
slows them and fault windows drop/delay/duplicate/corrupt/partition
their frames.  What is real and what is simulated:

==========================  =============================================
real (production code)      simulated (virtual stand-ins)
==========================  =============================================
MembershipController        worker processes (state structs + events)
  poll/lease folding,         heartbeats (an in-memory lease table the
  dead-ts guard, straggler    controller folds via its ``lease_source``
  demotion + cumulative       seam — same doc schema as WorkerLease)
  base, min-active floor
CenterReactor/MeshReactor   the supervisor loop (death detection,
GoSGD tables                  respawn scheduling — but through the real
  (topology.derangements      Backoff + CrashLoopBreaker)
  + embed_active)
DedupWindow (+ snapshot/    the TCP wire (SimTransport resolves each
  restore on center crash)    frame's fate from the real
Backoff, CrashLoopBreaker     fault_window_active rule)
chaos schedule grammar      the EASGD center math (push counting — the
fault_window_active           membership/dedup planes, not gradients)
==========================  =============================================

The run is a pure function of its seed: one ``random.Random`` drives
every sample, events are totally ordered, and nothing reads wall time —
so the event log is byte-identical across runs (the determinism
gate) and any realized schedule can be exported and replayed through
the live harness (``simfleet.fidelity``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..parallel import topology
from ..parallel.membership import (Backoff, CenterReactor, CrashLoopBreaker,
                                   MembershipController, MeshReactor)
from ..utils import telemetry
from ..utils.chaos import NET_FAULT_KINDS, Fault, seeded_schedule

from .clock import VirtualClock
from .events import EventLog, EventQueue
from .transport import SimCenter, SimTransport

#: SimCenter's slot in chaos schedules — matches
#: ``ElasticSupervisor.CENTER_ID`` so ``kill@t:0`` means the same thing
#: in a simulated and a live schedule.
CENTER_ID = 0


class SimExchanger:
    """The in-mesh exchanger stand-in the REAL :class:`MeshReactor`
    drives: ``set_active_ranks`` regenerates the GoSGD routing tables
    through the production algebra (``topology.derangements`` +
    ``topology.embed_active``).  ``exclude`` holds non-mesh slots (the
    center's id 0 lives in the worker id space but not in the mesh)."""

    fused = False          # no in-scan cadence to recompile in a sim

    def __init__(self, size: int, n_perms: int = 16, family_seed: int = 0,
                 exclude: Sequence[int] = ()):
        self.size = int(size)
        self.n_perms = int(n_perms)
        self.family_seed = int(family_seed)
        self.exclude = frozenset(int(e) for e in exclude)
        self.active: List[int] = []
        self.tables = np.arange(self.size)[None, :]
        self.regens = 0
        self.table_violations: List[str] = []
        self.set_active_ranks(range(self.size))

    def set_active_ranks(self, active) -> None:
        if active is None:
            active = range(self.size)
        act = sorted(set(int(a) for a in active) - self.exclude)
        self.active = act
        if not act:
            # end-of-run drain: every worker finished and left — a real
            # mesh never shrinks to zero (the run ends first), the sim's
            # controller keeps folding leaves past that point
            self.tables = np.arange(self.size)[None, :]
            self.regens += 1
            return
        m = len(act)
        sub = topology.derangements(m, self.n_perms,
                                    seed=0x605 + self.family_seed)
        self.tables = topology.embed_active(sub, act, self.size) \
            if len(sub) else np.arange(self.size)[None, :]
        self.regens += 1
        self._audit()

    def _audit(self) -> None:
        """Topology invariant at every regeneration: inactive ranks are
        fixed points, active ranks route among themselves and never to
        self (m>1) — pins MeshReactor + embed_active at width."""
        act = np.zeros(self.size, dtype=bool)
        act[self.active] = True
        idx = np.arange(self.size)
        if (self.tables[:, ~act] != idx[~act]).any():
            self.table_violations.append(
                f"regen{self.regens}: an inactive rank is routed")
        sub = self.tables[:, act]
        if sub.size and (not act[sub].all() or
                         (len(self.active) > 1 and
                          (sub == idx[act]).any())):
            self.table_violations.append(
                f"regen{self.regens}: active routing broken "
                f"(left the active set or self-loop)")


class SimWorker:
    """One virtual worker's mutable state (no behavior — the fleet's
    event handlers drive it)."""

    __slots__ = ("wid", "status", "steps_done", "attempts", "gen",
                 "seqs", "round_seqs", "pending", "round_reply_t",
                 "retry_attempts", "wedged_until",
                 "slow_until", "persistent_factor", "round_t0",
                 "last_beat", "delay_episodes", "divergence")

    def __init__(self, wid: int):
        self.wid = wid
        self.status = "new"          # new|live|dead|finished|failed
        self.steps_done = 0
        self.attempts = 0            # spawns (first spawn = 1)
        self.gen = 0                 # bumps on death/spawn: stale events
        self.seqs: List[int] = []    # per-shard next seq
        self.round_seqs: List[int] = []
        self.pending = 0
        self.round_reply_t = 0.0
        self.retry_attempts: List[int] = []
        self.wedged_until = -1.0
        self.slow_until = -1.0
        self.persistent_factor = 1.0
        self.round_t0 = 0.0
        self.last_beat = -1.0
        self.delay_episodes = 0
        self.divergence = 0.0        # §25 beacon spread (corrupt faults)


class FleetSim:
    """Build with a config, ``run()``, then read ``log``, ``summary``,
    and hand the instance to :func:`simfleet.invariants.check_invariants`.
    """

    def __init__(self, n_workers: int = 128, steps: int = 2000,
                 sync_freq: int = 16, seed: int = 0, *,
                 n_shards: int = 2, dedup_depth: int = 64,
                 step_time_s: float = 0.02, step_jitter: float = 0.2,
                 n_stragglers: int = 0, straggler_factor: float = 4.0,
                 lease_timeout: float = 15.0, poll_s: float = 2.0,
                 detect_s: float = 0.25, max_restarts: int = 3,
                 crash_limit: Optional[int] = None,
                 crash_window_s: float = 60.0,
                 schedule: Optional[Sequence[Fault]] = None,
                 net_schedule: Optional[Sequence[Fault]] = None,
                 n_faults: int = 0, net_n_faults: int = 0,
                 fault_t_min: float = 5.0, fault_t_max: float = 60.0,
                 net_fault_duration: float = 3.0,
                 latency_s: float = 0.004, op_timeout_s: float = 3.0,
                 wire_max_retries: int = 8,
                 straggle_windows: int = 3, straggle_window_s: float = 5.0,
                 straggle_poll_s: float = 10.0,
                 straggle_ratio: float = 2.0,
                 exch_prob: float = 0.25, n_perms: int = 16,
                 gossip: bool = True, center_outage_s: float = 2.0,
                 horizon_s: Optional[float] = None,
                 fleetmon: bool = False, fleetmon_rules=None,
                 fleetmon_eval_s: float = 2.0):
        self.n_workers = int(n_workers)
        self.steps_goal = int(steps)
        self.sync_freq = max(1, int(sync_freq))
        self.seed = int(seed)
        self.n_shards = int(n_shards)
        self.step_time_s = float(step_time_s)
        self.step_jitter = float(step_jitter)
        self.straggler_factor = float(straggler_factor)
        self.lease_timeout = float(lease_timeout)
        self.poll_s = float(poll_s)
        self.detect_s = float(detect_s)
        self.max_restarts = int(max_restarts)
        self.op_timeout_s = float(op_timeout_s)
        self.wire_max_retries = int(wire_max_retries)
        self.straggle_windows = int(straggle_windows)
        self.straggle_window_s = float(straggle_window_s)
        self.straggle_poll_s = float(straggle_poll_s)
        self.straggle_ratio = float(straggle_ratio)
        self.exch_prob = float(exch_prob)
        self.gossip_on = bool(gossip)
        self.center_outage_s = float(center_outage_s)

        # -- seeded randomness: ONE stream per concern, all derived from
        # the run seed, so reordering draws in one concern cannot shift
        # another (the determinism gate depends on it)
        self.rng = random.Random(self.seed)               # durations/latency
        self.rng_gossip = random.Random(self.seed ^ 0x9E3779B9)
        self.backoff = Backoff(base=0.5, factor=2.0, cap=8.0,
                               rng=random.Random(
                                   self.seed ^ 0x5DEECE66))  # respawns
        self.wire_backoff = Backoff(base=0.2, factor=2.0, cap=5.0,
                                    rng=random.Random(
                                        self.seed ^ 0x0BACF))  # retries

        # -- schedules: explicit lists, or seeded draws from the real
        # chaos generator
        wids = list(range(1, self.n_workers + 1))
        if schedule is None and n_faults:
            schedule = seeded_schedule(self.seed ^ 0xC4A05, wids,
                                       n_faults=n_faults,
                                       t_min=fault_t_min, t_max=fault_t_max,
                                       kinds=("kill", "stop", "delay"),
                                       duration=4.0)
        if net_schedule is None and net_n_faults:
            net_schedule = seeded_schedule(self.seed ^ 0x7E7, [-1],
                                           n_faults=net_n_faults,
                                           t_min=fault_t_min,
                                           t_max=fault_t_max,
                                           kinds=NET_FAULT_KINDS,
                                           duration=net_fault_duration)
        self.schedule = sorted([f for f in (schedule or ())
                                if f.kind not in NET_FAULT_KINDS],
                               key=lambda f: (f.at, f.target))
        self.net_schedule = sorted([f for f in (schedule or ())
                                    if f.kind in NET_FAULT_KINDS]
                                   + list(net_schedule or ()),
                                   key=lambda f: (f.at, f.target))

        # -- the machinery under test ---------------------------------------
        self.vclock = VirtualClock()
        self.queue = EventQueue(self.vclock)
        self.log = EventLog()
        self.lease_table: Dict[int, dict] = {}
        self.center = SimCenter(self.n_shards, dedup_depth)
        self.mesh = SimExchanger(self.n_workers + 1, n_perms=n_perms,
                                 exclude=(CENTER_ID,))
        self.controller = MembershipController(
            lease_timeout=self.lease_timeout,
            telemetry_=telemetry.DISABLED,
            reactors=(CenterReactor(self.center), MeshReactor(self.mesh)),
            straggle_windows=self.straggle_windows,
            straggle_window_s=self.straggle_window_s,
            min_active=1, clock=self.vclock,
            lease_source=lambda: self.lease_table)
        kills = sum(1 for f in self.schedule if f.kind == "kill")
        self.breaker = CrashLoopBreaker(
            limit=crash_limit if crash_limit is not None
            else max(6, kills + 2),
            window_s=crash_window_s, clock=self.vclock)

        # -- fleet state ------------------------------------------------------
        self.workers = {w: SimWorker(w) for w in wids}
        stragglers = list(wids)
        random.Random(self.seed ^ 0x57A6).shuffle(stragglers)
        self.stragglers = sorted(stragglers[:int(n_stragglers)])
        for w in self.stragglers:
            self.workers[w].persistent_factor = self.straggler_factor
        self.transport = SimTransport(self.vclock, self.rng,
                                      self.net_schedule,
                                      center=self.center,
                                      latency_s=latency_s,
                                      op_timeout_s=self.op_timeout_s)
        # fleet health plane rehearsal (docs/design.md §20):
        # the REAL FleetCollector + rule engine on the virtual clock —
        # off by default so the §18 determinism hashes are unchanged;
        # enabled, its alerts join the canonical event log
        self.health = None
        if fleetmon:
            from .health import HealthPlane
            self.health = HealthPlane(self, rules=fleetmon_rules,
                                      eval_window_s=fleetmon_eval_s)
        self.finished: set = set()
        self.failed: set = set()
        self.deaths = 0
        self.skips = 0
        self.dedup_first_attempt: List[tuple] = []   # wrongly deduped
        self.lease_violations: List[str] = []
        self.alpha_violations: List[str] = []
        self._alpha_at_demote: Dict[int, float] = {}
        self._clean_streak: Dict[int, int] = {}
        self._window_means: Dict[int, Dict[int, float]] = {}
        self._windows_straggled: Dict[int, int] = {}
        self._last_mean: Dict[int, float] = {}
        self._scored_widx = -1
        self._drained = 0
        self.realized: List[dict] = []
        self.stopped_reason: Optional[str] = None
        # gossip plane: α mass (the conservation invariant) and a mixing
        # scalar (weighted-average merge — variance decay is the mixing
        # observable); index = worker id, slot 0 unused
        self.alpha = [1.0] * (self.n_workers + 1)
        self.mix = [float(w) for w in range(self.n_workers + 1)]
        self.alpha0_sum = float(self.n_workers)
        self.mix_var0 = float(np.var(self.mix[1:]))
        self.horizon_s = horizon_s if horizon_s is not None else \
            max(600.0, 60.0 * self.steps_goal * self.step_time_s *
                self.straggler_factor)
        self.summary: dict = {}

    # -- helpers --------------------------------------------------------------

    def _now(self) -> float:
        return self.vclock.now()

    def _realize(self, fault: Fault, error: Optional[str] = None) -> None:
        now = self._now()
        self.realized.append({
            "ts": round(now, 6), "rel": round(now, 6), "kind": fault.kind,
            "target": fault.target, "duration": fault.duration,
            "pid": None, "error": error, "source": "simfleet"})
        self.log.append(now, "fault", kind=fault.kind, target=fault.target,
                        duration=fault.duration, error=error)

    def _drain_transitions(self) -> None:
        """Mirror every controller transition into the event log (the
        membership-sequence artifact fidelity compares)."""
        trans = self.controller.transitions
        while self._drained < len(trans):
            ev, w, info = trans[self._drained]
            self._drained += 1
            self.log.append(self._now(), ev, worker=w,
                            reason=info.get("reason"),
                            rejoin=bool(info.get("rejoin")))

    #: the live worker's monitor thread beats every ~2 s (WorkerLease
    #: min_interval_s) REGARDLESS of step speed — the sim must match, or
    #: any round longer than lease_timeout falsely reads as a wedge
    BEAT_EVERY_S = 2.0

    def _beat(self, w: SimWorker, status: str = "live") -> None:
        now = self._now()
        w.last_beat = now
        self.lease_table[w.wid] = {"worker": w.wid, "pid": None,
                                   "ts": now, "step": w.steps_done,
                                   "status": status}
        if self.health is not None:
            # a lease beat doubles as a metric-snapshot arrival (the
            # live MetricStreamer cadence) — kills/wedges silence it
            self.health.on_beat(w.wid, status, w.steps_done)

    def _schedule_beats(self, wid: int, gen: int, t_from: float,
                        t_until: float) -> None:
        """Mid-round heartbeats for a compute segment longer than the
        beat cadence (a slow/slowed worker is ALIVE — only wedges and
        deaths may silence the lease)."""
        t = t_from + self.BEAT_EVERY_S
        while t < t_until:
            self.queue.push(t, lambda: self._beat_tick(wid, gen))
            t += self.BEAT_EVERY_S

    def _beat_tick(self, wid: int, gen: int) -> None:
        w = self.workers[wid]
        if self.stopped_reason or w.gen != gen or w.status != "live":
            return
        if self._now() < w.wedged_until:
            return                 # SIGSTOPped: the process can't beat
        self._beat(w)

    def _exchange_duration(self, w: SimWorker) -> float:
        now = self._now()
        j = self.step_jitter
        dt = self.sync_freq * self.step_time_s * \
            (1.0 - j + 2.0 * j * self.rng.random()) * w.persistent_factor
        if now < w.slow_until:
            dt *= self.straggler_factor
        return dt

    def _alldone(self) -> bool:
        return len(self.finished | self.failed) >= self.n_workers

    # -- straggler windows ----------------------------------------------------

    def _window_sample(self, w: SimWorker, dur: float) -> None:
        """Attribute a completed round to the window containing its
        COMPLETION time, immediately — a finalize-on-next-round scheme
        would deliver a slow worker's sample after its window was
        already scored, silently freezing exactly the straggle counts
        the policy runs on."""
        widx = int(self._now() / self.straggle_window_s)
        bucket = self._window_means.setdefault(widx, {})
        ent = bucket.get(w.wid)
        if ent is None:
            bucket[w.wid] = [dur, 1]
        else:
            ent[0] += dur
            ent[1] += 1

    def _score_windows(self) -> None:
        """Fold completed straggler windows into cumulative straggle
        counts (the ranking rows the REAL check_stragglers consumes) and
        clean streaks (the readmission signal)."""
        upto = int(self._now() / self.straggle_window_s) - 1
        for widx in range(self._scored_widx + 1, upto + 1):
            bucket = self._window_means.pop(widx, None)
            if not bucket or len(bucket) < 2:
                continue
            means = {wid: s / c for wid, (s, c) in bucket.items()}
            med = sorted(means.values())[len(means) // 2]
            for wid, mean in sorted(means.items()):
                self._last_mean[wid] = mean
                if med > 0 and mean > self.straggle_ratio * med:
                    self._windows_straggled[wid] = \
                        self._windows_straggled.get(wid, 0) + 1
                    self._clean_streak[wid] = 0
                else:
                    self._clean_streak[wid] = \
                        self._clean_streak.get(wid, 0) + 1
        self._scored_widx = max(self._scored_widx, upto)

    # -- lifecycle events -----------------------------------------------------

    def _spawn(self, wid: int, respawn: bool) -> None:
        w = self.workers[wid]
        w.status = "live"
        w.gen += 1
        w.steps_done = 0
        w.attempts += 1
        w.wedged_until = -1.0
        w.pending = 0
        w.divergence = 0.0     # a respawn restores from the live center
        # a respawn of a straggler-demoted worker rejoins (the real
        # join→on_join path readmits it) — its α legitimately unfreezes
        self._alpha_at_demote.pop(wid, None)
        now = self._now()
        # the real WireClient seeds each incarnation's seq from the clock
        # so a respawn can never replay into its predecessor's HWM shadow
        base = int(now * 1000)
        w.seqs = [base] * self.n_shards
        w.round_seqs = [0] * self.n_shards
        w.retry_attempts = [0] * self.n_shards
        self._beat(w)
        self.controller.join(wid, reason="respawn" if respawn else "spawn",
                             now=now)
        self._drain_transitions()
        w.round_t0 = now
        gen = w.gen
        t_next = now + self._exchange_duration(w)
        self._schedule_beats(wid, gen, now, t_next)
        self.queue.push(t_next, lambda: self._exchange(wid, gen))

    def _on_death(self, wid: int, reason: str) -> None:
        w = self.workers[wid]
        now = self._now()
        self.deaths += 1
        self.controller.leave(wid, reason=reason, now=now, rc=-9)
        self._drain_transitions()
        if self.breaker.record_failure(now):
            self.stopped_reason = "crash_loop_breaker"
            self.log.append(now, "breaker_tripped", deaths=self.deaths)
            return
        if w.attempts > self.max_restarts:
            w.status = "failed"
            self.failed.add(wid)
            self.log.append(now, "restart_exhausted", worker=wid,
                            attempts=w.attempts)
            return
        delay = self.backoff.delay(w.attempts - 1)
        self.log.append(now, "respawn_scheduled", worker=wid,
                        delay=round(delay, 6), attempt=w.attempts)
        self.queue.push(now + delay, lambda: self._respawn(wid))

    def _respawn(self, wid: int) -> None:
        if self.stopped_reason or self.workers[wid].status != "dead":
            return
        self._spawn(wid, respawn=True)

    # -- the exchange round ---------------------------------------------------

    def _exchange(self, wid: int, gen: int) -> None:
        w = self.workers[wid]
        if self.stopped_reason or w.gen != gen or w.status != "live":
            return
        now = self._now()
        if now < w.wedged_until:           # SIGSTOPped: silent, deferred
            self.queue.push(w.wedged_until + 1e-3,
                            lambda: self._exchange(wid, gen))
            return
        # the straggler sample spans the whole round — compute AND wire
        # (retry stalls, delay windows), so network trouble surfaces in
        # the ranking exactly as it does in the live phase brackets
        self._window_sample(w, now - w.round_t0)
        if self.health is not None:
            self.health.on_round(w.wid, now - w.round_t0,
                                 divergence=w.divergence)
        if w.divergence:
            # the elastic pull drags a corrupted replica back toward the
            # center each round: decay until the rule's breach episode
            # clears, so a LATER corrupt fault can re-alert (no-flapping
            # episode semantics need the condition to go false between)
            w.divergence = 0.0 if w.divergence < 1e-9 \
                else w.divergence * 0.5
        w.round_t0 = now
        self._beat(w)
        w.steps_done += self.sync_freq
        if w.steps_done >= self.steps_goal:
            w.status = "finished"
            self.finished.add(wid)
            self._beat(w, status="left")   # the clean-departure lease doc
            self.log.append(now, "worker_finished", worker=wid,
                            steps=w.steps_done, attempts=w.attempts)
            return
        w.pending = self.n_shards
        w.round_reply_t = now
        for shard in range(self.n_shards):
            w.round_seqs[shard] = w.seqs[shard]
            w.seqs[shard] += 1
            w.retry_attempts[shard] = 0
            self._send(wid, shard, gen)

    def _send(self, wid: int, shard: int, gen: int) -> None:
        w = self.workers[wid]
        if self.stopped_reason or w.gen != gen or w.status != "live":
            return
        now = self._now()
        if now < w.wedged_until:
            # SIGSTOP freezes the whole process: retries stall too
            self.queue.push(w.wedged_until + 1e-3,
                            lambda: self._send(wid, shard, gen))
            return
        # the worker's main thread beats through exchange retries (the
        # elastic worker CLI's monitor loop) — only wedges and deaths
        # silence the lease
        self._beat(w)
        seq = w.round_seqs[shard]
        attempt = w.retry_attempts[shard]
        status, verdict, t_done = \
            self.transport.request_push(wid, shard, seq)
        if status == "ok":
            if verdict == "dedup" and attempt == 0:
                # a NEVER-retried token answered from the window: the
                # dedup/HWM machinery swallowed a fresh push
                self.dedup_first_attempt.append((wid, shard, seq))
            self._shard_done(w, t_done)
            return
        # lost / retryable: the client retries the SAME token after the
        # real wire backoff, up to the wire retry budget; past it the
        # island skips the exchange (wire.exchange_skipped semantics)
        w.retry_attempts[shard] = attempt + 1
        if self.health is not None:
            # the live wire.retry counter tick — the wire_degraded rate
            # rule's raw signal
            self.health.on_wire_retry(wid)
        if attempt + 1 > self.wire_max_retries:
            self.skips += 1
            self.log.append(self._now(), "exchange_skipped", worker=wid,
                            shard=shard, attempts=attempt + 1)
            self._shard_done(w, t_done)
            return
        delay = self.wire_backoff.delay(attempt)
        self.queue.push(t_done + delay, lambda: self._send(wid, shard, gen))

    def _shard_done(self, w: SimWorker, t_done: float) -> None:
        w.round_reply_t = max(w.round_reply_t, t_done)
        w.pending -= 1
        if w.pending > 0:
            return
        gen = w.gen
        t_next = w.round_reply_t + self._exchange_duration(w)
        self._schedule_beats(w.wid, gen, w.round_reply_t, t_next)
        self.queue.push(t_next, lambda: self._exchange(w.wid, gen))

    # -- faults ---------------------------------------------------------------

    def _apply_fault(self, fault: Fault, tries: int = 0) -> None:
        if self.stopped_reason:
            return
        now = self._now()
        if fault.target == CENTER_ID:
            if fault.kind == "kill":
                outage = fault.duration or self.center_outage_s
                self.center.crash_and_restore(now, outage)
                self.controller.center_down(reason="crashed", rc=-9,
                                            downs=self.center.restarts)
                self._realize(fault)
                self.queue.push(now + outage, self._center_restored)
            else:
                self._realize(fault, error="center-faults-are-kills")
            return
        w = self.workers.get(fault.target)
        if w is None or w.status != "live":
            # the monkey's grace semantics: retry while the target is
            # between lives, then drop with no-pid
            if tries * 0.5 > 10.0 or w is None or \
                    w.status in ("finished", "failed"):
                self._realize(fault, error="no-pid")
            else:
                self.queue.push(now + 0.5,
                                lambda: self._apply_fault(fault, tries + 1))
            return
        if fault.kind == "kill":
            w.status = "dead"
            w.gen += 1
            self._realize(fault)
            self.queue.push(now + self.detect_s,
                            lambda: self._on_death(fault.target, "crashed"))
        elif fault.kind == "stop":
            w.wedged_until = now + fault.duration
            self._realize(fault)
        elif fault.kind == "delay":
            w.slow_until = now + fault.duration
            w.delay_episodes += 1
            self._realize(fault)
        elif fault.kind == "corrupt":
            # the live semantics (utils/chaos.py): the replica perturbs
            # itself by `duration`-as-scale and the §25 beacon spread
            # jumps; the next round's divergence sample must trip the
            # replica_divergence rule within one beacon period.  The bad
            # push then moves the CENTER, so every live replica's
            # distance to the consensus spikes — the live elastic run
            # alerts fleet-wide, and the rehearsal must match that set
            scale = fault.duration or 1e-3
            for peer in self.workers.values():
                if peer.status != "dead":
                    peer.divergence = max(peer.divergence, scale)
            self._realize(fault)

    def _center_restored(self) -> None:
        self.controller.center_restored(attempt=self.center.restarts)
        self._drain_transitions()

    # -- control loops --------------------------------------------------------

    def _poll(self) -> None:
        if self.stopped_reason:
            return
        trans = self.controller.poll()
        for ev, wid, info in trans:
            if ev == "worker_leave" and \
                    info.get("reason") == "lease_expired":
                w = self.workers[wid]
                # lease-timeout safe region: an expiry verdict against a
                # worker that was alive and beating is a FALSE death
                now = self._now()
                silent = now - w.last_beat
                if w.status == "live" and now >= w.wedged_until and \
                        silent <= self.lease_timeout:
                    self.lease_violations.append(
                        f"false death: worker {wid} expired while "
                        f"beating (silent {silent:.1f}s)")
                # the detection bound: the first poll past expiry must
                # catch it — a wedge goes unnoticed for at most
                # lease_timeout + one poll period
                if silent > self.lease_timeout + self.poll_s + 0.5:
                    self.lease_violations.append(
                        f"late detection: worker {wid} silent "
                        f"{silent:.1f}s before expiry verdict")
                # the supervisor kills a wedged-but-alive process and
                # respawns it (membership step 2)
                if w.status == "live":
                    w.status = "dead"
                    w.gen += 1
                    self._on_death(wid, "wedged")
        self._drain_transitions()
        if not self._alldone():
            self.queue.push(self._now() + self.poll_s, self._poll)

    def _straggle_check(self) -> None:
        if self.stopped_reason:
            return
        self._score_windows()
        status = self.controller.status()
        ranking = [{"rank": wid,
                    "windows_straggled": self._windows_straggled.get(wid, 0),
                    "mean_train_secs": self._last_mean.get(wid)}
                   for wid in sorted(self.workers)
                   if self.workers[wid].status == "live"]
        demoted = self.controller.check_stragglers(ranking)
        for wid in demoted:
            self._alpha_at_demote[wid] = self.alpha[wid]
        # readmission: a demoted worker with a clean streak re-enters
        # (worker_join reason='readmit' — design.md §14)
        for wid in status.get("demoted", ()):
            if self._clean_streak.get(wid, 0) >= self.straggle_windows \
                    and self.workers[wid].status == "live":
                ref = self._alpha_at_demote.pop(wid, None)
                if ref is not None and \
                        abs(self.alpha[wid] - ref) > 1e-9:
                    self.alpha_violations.append(
                        f"demoted worker {wid} alpha moved "
                        f"{ref} -> {self.alpha[wid]}")
                # readmit() itself forgives the stale cumulative
                # evidence (straggle_forgive — the production fix the
                # first 1,000-worker rehearsal forced)
                self.controller.readmit(wid)
        self._drain_transitions()
        if not self._alldone():
            self.queue.push(self._now() + self.straggle_poll_s,
                            self._straggle_check)

    def _gossip_round(self) -> None:
        if self.stopped_reason:
            return
        tables = self.mesh.tables
        active = self.mesh.active
        rng = self.rng_gossip
        if len(active) > 1:
            row = tables[rng.randrange(len(tables))]
            sends = [(i, int(row[i])) for i in active
                     if rng.random() < self.exch_prob]
            # two-phase like the traced algebra: every w_send derives
            # from the PRE-round alpha, receivers then merge
            staged = []
            for i, peer in sends:
                s = self.alpha[i] * 0.5
                staged.append((i, peer, s, self.mix[i]))
                self.alpha[i] -= s
            for i, peer, s, mx in staged:
                a = self.alpha[peer]
                self.mix[peer] = (a * self.mix[peer] + s * mx) / (a + s) \
                    if a + s > 0 else self.mix[peer]
                self.alpha[peer] = a + s
        if not self._alldone():
            self.queue.push(
                self._now() + self.sync_freq * self.step_time_s,
                self._gossip_round)

    # -- run ------------------------------------------------------------------

    def run(self) -> dict:
        # initial joins BEFORE reactors see churn would regenerate the
        # mesh N times for nothing — the reactors are attached already,
        # so spawn order is the regeneration order; with 1,000 workers
        # that is the one deliberately-batched step: spawn with reactors
        # detached, then sync them once.
        self.log.append(0.0, "fleet_start", n_workers=self.n_workers,
                        steps=self.steps_goal, sync_freq=self.sync_freq,
                        seed=self.seed, shards=self.n_shards,
                        schedule=[repr(f) for f in self.schedule],
                        net_schedule=[repr(f) for f in self.net_schedule],
                        stragglers=self.stragglers)
        reactors = self.controller.reactors
        self.controller.reactors = []
        for wid in sorted(self.workers):
            self._spawn(wid, respawn=False)
        self.controller.reactors = reactors
        self.mesh.set_active_ranks(None)
        for f in self.schedule:
            self.queue.push(f.at,
                            lambda fault=f: self._apply_fault(fault))
        for f in self.net_schedule:
            # a window OPENING is the realized event (the live proxy's
            # monitor emits exactly then); per-frame fates are counters
            self.queue.push(f.at, lambda fault=f: self._realize(fault))
        self.queue.push(self.poll_s, self._poll)
        self.queue.push(self.straggle_poll_s, self._straggle_check)
        if self.health is not None:
            self.health.install()
        if self.gossip_on:
            self.queue.push(self.sync_freq * self.step_time_s,
                            self._gossip_round)
        self.queue.run(until=self.horizon_s)
        if not self._alldone() and not self.stopped_reason:
            self.stopped_reason = "horizon"
        self._score_windows()
        self._drain_transitions()
        now = self._now()
        cs = self.center.stats()
        self.summary = {
            "n_workers": self.n_workers, "seed": self.seed,
            "virtual_secs": round(now, 3),
            "events": self.queue.processed,
            "finished": len(self.finished), "failed": len(self.failed),
            "deaths": self.deaths, "skips": self.skips,
            "transitions": len(self.controller.transitions),
            "center": cs,
            "frames_faulted": dict(sorted(
                self.transport.frames_faulted.items())),
            "mesh_regens": self.mesh.regens,
            "alpha_sum": round(sum(self.alpha[1:]), 9),
            "mix_var_ratio": round(
                float(np.var([self.mix[i] for i in self.mesh.active]))
                / self.mix_var0, 9) if self.mesh.active and self.mix_var0
            else None,
            "windows_scored": self._scored_widx + 1,
            "stragglers": self.stragglers,
            "stopped": self.stopped_reason,
        }
        if self.health is not None:
            self.summary["fleetmon"] = self.health.summary()
        self.log.append(now, "summary", **self.summary)
        return self.summary
