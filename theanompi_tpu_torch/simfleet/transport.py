"""The simulated wire: chaos-scheduled fault windows over virtual frames,
and the sharded center those frames land on.

Counterpart of ``theanompi_tpu/simfleet/transport.py``, on the port's
``parallel/wire.py`` (:class:`DedupWindow`) and ``utils/chaos.py``.

**Transport.**  No sockets — a request is resolved as pure arithmetic
over virtual time: sample a one-way latency, ask the REAL
window-membership rule (:func:`theanompi_tpu_torch.utils.chaos
.fault_window_active`, the same function the live :class:`ChaosProxy`
routes by) which fault windows cover the frame at its delivery and
reply instants, and produce the exact client-observable outcomes the
proxy produces on real TCP:

* ``net_drop`` / ``net_partition`` at delivery — the frame evaporates;
  the client sees silence and times out (``lost``).
* ``net_delay`` — the frame stalls ``NET_DELAY_PER_FRAME_S`` (the
  proxy's knob, imported not copied) before the server sees it.
* ``net_corrupt`` — the server's CRC rejects it *before* the dedup
  window is consulted (mirroring ``center_server``'s handler order);
  the client gets a retryable error reply.
* ``net_dup`` — the server is hit TWICE; the duplicate's reply is
  swallowed (the client sent one frame, it sees one reply) — the twin
  lands on the dedup window, which is the point.
* ``net_partition`` at reply time — the op APPLIED but the ack is lost:
  the client times out and retries an op that landed, the
  exactly-once case that justifies the whole token machinery.

**Center.**  K shards (the sharded-center shape), each
with its own REAL :class:`~theanompi_tpu_torch.parallel.wire.DedupWindow`.
Every apply is checked against a per-worker applied-seq high-water mark
— client streams are strictly sequential, so ANY re-application
surfaces as a ledger violation, O(1) memory at 1,000-client width.
``kill@t:0`` restarts the center: windows snapshot/restore through the
real crash-recovery path (in-flight claims dropped, HWMs kept) while
requests during the outage are lost and ridden out on retries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..parallel.wire import INFLIGHT, DedupWindow
from ..utils import telemetry
from ..utils.chaos import (NET_DELAY_PER_FRAME_S, NET_FAULT_KINDS,
                           fault_window_active)


class SimTransport:
    """Resolve framed request/reply round-trips in virtual time.

    ``request()`` returns ``(status, verdict, t_done)``:

    * ``("ok", <server verdict>, t_reply)`` — reply in hand at t_reply;
    * ``("retry", "corrupt", t_reply)`` — retryable error reply (CRC);
    * ``("lost", None, t_timeout)`` — silence; the client's op timeout
      expires at ``t_timeout``.
    """

    def __init__(self, clock, rng, schedule=(), *, center=None,
                 latency_s: float = 0.004,
                 latency_jitter: float = 0.5, op_timeout_s: float = 3.0):
        self.clock = clock
        self.rng = rng
        self.center = center
        self.schedule = [f for f in (schedule or ())
                         if f.kind in NET_FAULT_KINDS]
        self.latency_s = float(latency_s)
        self.latency_jitter = float(latency_jitter)
        self.op_timeout_s = float(op_timeout_s)
        self.frames_faulted: Dict[str, int] = {}
        self.dup_applied = 0       # duplicated frames a LIVE center saw
        # per-kind sub-schedules with coarse [lo, hi] bounds: a frame
        # outside a kind's span pays two comparisons, and the membership
        # verdict itself still comes from the REAL fault_window_active
        # rule over that kind's faults (filtering by kind first is
        # exactly what the rule does anyway)
        self._by_kind: Dict[str, tuple] = {}
        for kind in NET_FAULT_KINDS:
            fs = [f for f in self.schedule if f.kind == kind]
            if fs:
                self._by_kind[kind] = (
                    fs, min(f.at for f in fs),
                    max(f.at + f.duration for f in fs))

    def _count(self, kind: str) -> None:
        self.frames_faulted[kind] = self.frames_faulted.get(kind, 0) + 1

    def _window(self, kind: str, worker: int, t: float) -> bool:
        sub = self._by_kind.get(kind)
        if sub is None or t < sub[1] or t > sub[2]:
            return False
        return fault_window_active(sub[0], kind, worker, t)

    def _lat(self) -> float:
        j = self.latency_jitter
        return self.latency_s * (1.0 - j + 2.0 * j * self.rng.random())

    def request_push(self, worker: int, shard: int,
                     seq: int) -> Tuple[str, Optional[str], float]:
        """One round-trip for ``worker``'s push to ``shard``."""
        t_send = self.clock.now()
        t_deliver = t_send + self._lat()
        t_lost = t_send + self.op_timeout_s
        if self._window("net_partition", worker, t_deliver):
            self._count("net_partition")
            return "lost", None, t_lost
        if self._window("net_drop", worker, t_deliver):
            self._count("net_drop")
            return "lost", None, t_lost
        if self._window("net_delay", worker, t_deliver):
            self._count("net_delay")
            t_deliver += NET_DELAY_PER_FRAME_S
        if self._window("net_corrupt", worker, t_deliver):
            # CRC verdict precedes the dedup window server-side: a
            # corrupted frame never claims a token
            self._count("net_corrupt")
            return "retry", "corrupt", t_deliver + self._lat()
        center = self.center
        down = center.is_down(t_deliver)
        verdict = None if down else center.apply_push(shard, worker, seq)
        if self._window("net_dup", worker, t_deliver):
            # the duplicate hits the server too; its reply is swallowed.
            # frames_faulted counts the frame (proxy parity) whether or
            # not the center was up; dup_applied counts only twins that
            # actually REACHED a live center — the denominator the
            # dedup invariant is entitled to
            self._count("net_dup")
            if not down:
                center.apply_push(shard, worker, seq)
                self.dup_applied += 1
        if down:
            return "lost", None, t_lost        # outage: the frame dies
        t_reply = t_deliver + self._lat()
        if self._window("net_partition", worker, t_reply):
            # applied, ack lost — the retry-of-a-landed-op case
            self._count("net_partition")
            return "lost", None, t_lost
        return "ok", verdict, t_reply


class SimShard:
    """One center shard: a real DedupWindow plus the exactly-once ledger."""

    def __init__(self, idx: int, dedup_depth: int = 64):
        self.idx = int(idx)
        self.window = DedupWindow(depth=dedup_depth,
                                  telemetry_=telemetry.DISABLED)
        self.applied_hwm: Dict[int, int] = {}      # worker -> max applied seq
        self.applied_by_worker: Dict[int, int] = {}
        self.dropped_by_worker: Dict[int, int] = {}
        self.applied_total = 0
        self.violations: List[Tuple[int, int]] = []  # (worker, seq) reapplied


class SimCenter:
    """K shards behind one membership surface — the object the REAL
    :class:`~theanompi_tpu_torch.parallel.membership.CenterReactor` drives.
    ``demote_island``/``readmit_island`` follow ElasticCenter semantics:
    a demoted island's pushes are dropped-but-acked on every shard, its
    pulls (not modeled) would still serve."""

    def __init__(self, n_shards: int = 2, dedup_depth: int = 64):
        assert n_shards >= 1
        self.shards = [SimShard(i, dedup_depth) for i in range(n_shards)]
        self.demoted: set = set()
        self.down_until: float = -1.0          # center outage (kill@t:0)
        self.restarts = 0

    # -- the CenterReactor surface ------------------------------------------

    def demote_island(self, island: int) -> None:
        self.demoted.add(int(island))

    def readmit_island(self, island: int) -> None:
        self.demoted.discard(int(island))

    # -- outage / crash recovery --------------------------------------------

    def crash_and_restore(self, now: float, outage_s: float) -> None:
        """Kill the center and bring it back from snapshot after
        ``outage_s``: every shard's dedup window round-trips through the
        REAL snapshot/restore (in-flight claims dropped, applied tokens
        and HWMs kept) — the §15 crash-recovery semantics at width."""
        self.restarts += 1
        self.down_until = now + float(outage_s)
        for sh in self.shards:
            snap = sh.window.snapshot()
            sh.window = DedupWindow(depth=sh.window.depth,
                                    telemetry_=telemetry.DISABLED)
            sh.window.restore(snap)

    def is_down(self, t: float) -> bool:
        return t < self.down_until

    # -- the push op ---------------------------------------------------------

    def apply_push(self, shard_idx: int, worker: int, seq: int) -> str:
        """One mutating op on one shard: dedup check → demote drop →
        apply, with the exactly-once ledger audited on the way."""
        sh = self.shards[shard_idx]
        tok = {"w": f"w{worker}", "seq": int(seq)}
        dup, cached = sh.window.check(tok, "push")
        if dup:
            # the sim applies atomically, so a claim can never still be
            # in flight — an INFLIGHT here is itself a violation
            if cached is INFLIGHT:
                sh.violations.append((int(worker), int(seq)))
            return "dedup"
        if int(worker) in self.demoted:
            sh.dropped_by_worker[int(worker)] = \
                sh.dropped_by_worker.get(int(worker), 0) + 1
            sh.window.record(tok, "push", {"ok": True, "dropped": True})
            return "dropped"
        last = sh.applied_hwm.get(int(worker), -1)
        if int(seq) <= last:
            sh.violations.append((int(worker), int(seq)))
        else:
            sh.applied_hwm[int(worker)] = int(seq)
        sh.applied_total += 1
        sh.applied_by_worker[int(worker)] = \
            sh.applied_by_worker.get(int(worker), 0) + 1
        sh.window.record(tok, "push", {"ok": True})
        return "applied"

    # -- views ---------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "shards": len(self.shards),
            "applied_per_shard": [sh.applied_total for sh in self.shards],
            "dedup_hits_per_shard": [sh.window.hits for sh in self.shards],
            "violations": sum(len(sh.violations) for sh in self.shards),
            "restarts": self.restarts,
            "demoted": sorted(self.demoted),
        }
