"""Fleet health plane: streamed metric snapshots, SLO rules, alerts.

Counterpart of ``theanompi_tpu/utils/fleetmon.py``, a copy of its logic:
the JAX module is stdlib-only, and the port imports nothing of the JAX
package.

* **Metric snapshots** — each long-lived process (an elastic island, a
  worker, the center) samples its own telemetry registry
  (:func:`snapshot_from_telemetry`: step p50/p99, img/s, the card's
  memory headroom, the prefetch queue depth, the wire's rtt, outage and
  retries, the step count, the numerics gauges) and a
  :class:`MetricStreamer` daemon thread sends it as one
  :data:`METRICS_OP` request on the wire (``parallel/wire.py``: the JAX
  package's framing, tokened and deduplicated like every mutating op).
* **:class:`FleetCollector`** — a bounded ring per (rank, series), fleet
  percentile rollups, a Prometheus-style text exposition, and the
  ``heartbeat_age_s`` series derived from the snapshots' arrival times
  (a killed or stopped process stops streaming, and its age climbs).
* **The rule engine** — plain-dict rules (:func:`validate_rules`):
  ``threshold``, ``rate_of_change``, ``sustained`` and ``fleet_quantile``
  predicates, per rank or fleet-wide.  A breach episode fires exactly one
  :data:`ALERT_EVENT` (a firing rule stays silent until its condition
  clears).
* **Alert-driven supervision** — a rule's ``action``: :func:`apply_alert`
  turns a ``demote`` alert into ``MembershipController.demote`` with the
  rule cited, and :func:`fleet_flight_dump` answers a ``flight_dump``
  alert by asking every statusz endpoint of the run for its flight ring.
* **The audit** — :func:`audit_alerts`, the chaos run's closing check:
  every landed fault whose symptom a rule covers
  (:data:`FAULT_ALERT_COVERAGE`) raised its alert in time.

Nothing here runs on the training thread: the streamer only exists with
``metrics_addr`` and reads the registry the loop already feeds.  The
collector's state snapshots are crash-atomic (``utils/checkpoint``), and
a streamer rides a collector outage on the wire's retries (a failed send
is dropped; the next interval's lands).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import telemetry
from .clock import WALL

#: The wire op a metric snapshot rides in on (idempotency-tokened by
#: ``WireClient`` like every mutating op — a retried snapshot is
#: deduplicated, never double-counted into the rings).
METRICS_OP = "metrics"

#: The alert event kind in the telemetry stream — consumed by
#: scripts/telemetry_report.py (Perfetto instant markers with the rule
#: name + firing value) and by the chaos alert-audit.
ALERT_EVENT = "alert"
ALERT_EVENTS = (ALERT_EVENT,)

#: Snapshot fields a process samples from its own registry — the metric
#: snapshot schema.  All optional per sample (a
#: center has no prefetch queue); the collector keeps one ring per
#: (rank, field) that ever arrives.
METRIC_FIELDS = (
    "step_p50",              # phase.train histogram p50 (seconds)
    "step_p99",              # phase.train histogram p99 (seconds)
    "img_s",                 # images_per_sec gauge
    "hbm_headroom_bytes",    # hbm_min_headroom_bytes gauge
    "queue_depth",           # prefetch.queue_depth gauge
    "wire_rtt_p50",          # wire.rtt histogram p50 (seconds)
    "wire_rtt_p99",          # wire.rtt histogram p99 (seconds)
    "wire_outage_s",         # wire.outage_s gauge (last healed outage)
    "wire_retries",          # wire.retry counter (CUMULATIVE — the
                             # wire_degraded rule reads its rate, so a
                             # healed outage clears and a later fault
                             # re-alerts instead of latching forever)
    "steps",                 # heartbeat.iter gauge / caller extra
    "grad_norm",             # numerics.grad_norm gauge
    "divergence",            # numerics.divergence gauge — the cross-rank
                             # beacon spread; nonzero means replicas that
                             # must agree bit-diverged
)

#: Series the collector maintains beyond the streamed fields — derived
#: at evaluation time, never sent.
DERIVED_SERIES = ("heartbeat_age_s",)

#: Every series name the collector can register — the exposition must
#: cover all of these (schema-drift-probed).
FLEET_SERIES = METRIC_FIELDS + DERIVED_SERIES

#: Counters the fleet-health machinery ticks (streamer side).
FLEETMON_COUNTERS = ("fleetmon.sent", "fleetmon.send_fail")

RULE_PREDICATES = ("threshold", "rate_of_change", "sustained",
                   "fleet_quantile")
RULE_OPS = (">", "<", ">=", "<=")
RULE_SCOPES = ("rank", "fleet")
RULE_ACTIONS = ("demote", "flight_dump")
#: The full key vocabulary one rule dict may carry.
RULE_KEYS = ("name", "series", "predicate", "op", "value", "window_s",
             "quantile", "scope", "action", "roles")

#: Which rule (by name) covers each chaos fault kind's SYMPTOM — the
#: contract :func:`audit_alerts` checks a live run against.  A fault
#: kind absent here has no collector-visible symptom contract: net_dup /
#: net_corrupt are absorbed by the dedup/CRC machinery by design, and a
#: ``kill`` under supervision is HEALED (detect + backoff respawn)
#: faster than any sane heartbeat threshold — its audit is the
#: leave→rejoin pair the chaos gate already matches; the health plane
#: only sees a kill when respawns exhaust and the silence grows, which
#: the heartbeat rule then catches as a bonus, not a contract.
FAULT_ALERT_COVERAGE = {
    "stop": ("heartbeat_lost",),
    "delay": ("step_time_degraded",),
    "net_partition": ("wire_degraded",),
    "net_drop": ("wire_degraded",),
    # a parameter corruption that slips PAST the wire CRC (net_corrupt
    # stays absorbed by design — this kind models the bad apply itself):
    # the numerics beacon must catch the resulting replica desync
    "corrupt": ("replica_divergence",),
}


def default_rules(heartbeat_s: float = 10.0,
                  step_p99_s: Optional[float] = None,
                  step_window_s: float = 10.0,
                  hbm_headroom_bytes: Optional[float] = None,
                  wire_retry_rate: float = 0.05,
                  wire_window_s: float = 5.0,
                  queue_starved_window_s: float = 10.0,
                  divergence: Optional[float] = None) -> List[dict]:
    """The stock rule set.  ``step_p99_s``/``hbm_headroom_bytes``/
    ``divergence`` default to None = rule omitted (absolute step-time and
    HBM budgets are workload-specific, and the divergence rule only means
    something when the numerics beacon streams; the heartbeat/retry/
    queue rules are not).  The wire rule is rate-of-change over the
    CUMULATIVE retry counter deliberately: a latched last-outage gauge
    would fire once and never clear, so a second fault could never
    re-alert."""
    rules = [
        {"name": "heartbeat_lost", "series": "heartbeat_age_s",
         "predicate": "threshold", "op": ">", "value": float(heartbeat_s),
         "scope": "rank", "action": "demote", "roles": ("worker",)},
        {"name": "wire_degraded", "series": "wire_retries",
         "predicate": "rate_of_change", "op": ">",
         "value": float(wire_retry_rate),
         "window_s": float(wire_window_s), "scope": "rank",
         "roles": ("worker",)},
        {"name": "queue_starved", "series": "queue_depth",
         "predicate": "fleet_quantile", "quantile": 0.5, "op": "<",
         "value": 1.0, "window_s": float(queue_starved_window_s),
         "scope": "fleet", "action": "flight_dump", "roles": ("worker",)},
    ]
    if step_p99_s is not None:
        rules.append(
            {"name": "step_time_degraded", "series": "step_p99",
             "predicate": "sustained", "op": ">",
             "value": float(step_p99_s), "window_s": float(step_window_s),
             "scope": "rank", "action": "demote", "roles": ("worker",)})
    if hbm_headroom_bytes is not None:
        rules.append(
            {"name": "hbm_low_headroom", "series": "hbm_headroom_bytes",
             "predicate": "threshold", "op": "<",
             "value": float(hbm_headroom_bytes), "scope": "rank",
             "roles": ("worker",)})
    if divergence is not None:
        # threshold, not sustained: a single breaching beacon sample IS
        # the symptom — bit-desync never heals on its own, and the
        # acceptance bound is one beacon period, not a sustain window
        rules.append(
            {"name": "replica_divergence", "series": "divergence",
             "predicate": "threshold", "op": ">",
             "value": float(divergence), "scope": "rank",
             "action": "flight_dump", "roles": ("worker",)})
    return rules


DEFAULT_RULES = default_rules()


def validate_rules(rules: Sequence[dict]) -> List[dict]:
    """Check a rule list against the predicate grammar; raises
    ``ValueError`` naming the offending rule/key.  Returns
    the rules unchanged so call sites can validate inline."""
    names = set()
    for r in rules:
        name = r.get("name")
        if not name or not isinstance(name, str):
            raise ValueError(f"rule without a name: {r!r}")
        if name in names:
            raise ValueError(f"duplicate rule name {name!r}")
        names.add(name)
        unknown = sorted(set(r) - set(RULE_KEYS))
        if unknown:
            raise ValueError(f"rule {name!r}: unknown key(s) {unknown} "
                             f"(have {RULE_KEYS})")
        if r.get("series") not in FLEET_SERIES:
            raise ValueError(f"rule {name!r}: unknown series "
                             f"{r.get('series')!r} (have {FLEET_SERIES})")
        pred = r.get("predicate")
        if pred not in RULE_PREDICATES:
            raise ValueError(f"rule {name!r}: unknown predicate {pred!r} "
                             f"(have {RULE_PREDICATES})")
        if r.get("op", ">") not in RULE_OPS:
            raise ValueError(f"rule {name!r}: unknown op {r.get('op')!r}")
        if "value" not in r:
            raise ValueError(f"rule {name!r}: no threshold value")
        if pred in ("sustained", "rate_of_change") and \
                float(r.get("window_s", 0)) <= 0:
            raise ValueError(f"rule {name!r}: predicate {pred!r} needs a "
                             f"positive window_s")
        if pred == "fleet_quantile" and \
                not (0.0 <= float(r.get("quantile", -1)) <= 1.0):
            raise ValueError(f"rule {name!r}: fleet_quantile needs "
                             f"quantile in [0, 1]")
        if r.get("scope", "fleet" if pred == "fleet_quantile"
                 else "rank") not in RULE_SCOPES:
            raise ValueError(f"rule {name!r}: unknown scope "
                             f"{r.get('scope')!r}")
        act = r.get("action")
        if act is not None and act not in RULE_ACTIONS:
            raise ValueError(f"rule {name!r}: unknown action {act!r} "
                             f"(have {RULE_ACTIONS})")
    return list(rules)


def _cmp(op: str, value: float, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == "<":
        return value < threshold
    if op == ">=":
        return value >= threshold
    return value <= threshold


# -- emission side ------------------------------------------------------------

def snapshot_from_telemetry(tm, **extra) -> Dict[str, float]:
    """One metric snapshot sampled from a live registry — the
    :data:`METRIC_FIELDS` subset this process can answer.  Cheap (reads
    state other paths already maintain; the two histogram percentiles
    sort bounded reservoirs) and NEVER called on the training hot path —
    only from the streamer's own low-rate thread."""
    out: Dict[str, float] = {}
    if not tm.enabled:
        return out
    h = tm.hists.get("phase.train")
    if h is not None and h.count:
        p50, p99 = h.percentile(50), h.percentile(99)
        if p50 is not None:
            out["step_p50"] = round(p50, 6)
        if p99 is not None:
            out["step_p99"] = round(p99, 6)
    rtt = tm.hists.get("wire.rtt")
    if rtt is not None and rtt.count:
        p50, p99 = rtt.percentile(50), rtt.percentile(99)
        if p50 is not None:
            out["wire_rtt_p50"] = round(p50, 6)
        if p99 is not None:
            out["wire_rtt_p99"] = round(p99, 6)
    for field, gauge in (("img_s", "images_per_sec"),
                         ("hbm_headroom_bytes", "hbm_min_headroom_bytes"),
                         ("queue_depth", "prefetch.queue_depth"),
                         ("wire_outage_s", "wire.outage_s"),
                         ("steps", "heartbeat.iter"),
                         ("grad_norm", "numerics.grad_norm"),
                         ("divergence", "numerics.divergence")):
        v = tm.gauges.get(gauge)
        if v is not None:
            out[field] = float(v)
    # cumulative, ALWAYS present once a wire client exists: the
    # wire_degraded rate rule needs steady baseline samples to measure
    # a burst against
    retries = tm.counters.get("wire.retry")
    if retries is not None or "wire_rtt_p50" in out:
        out["wire_retries"] = float(retries or 0.0)
    for k, v in extra.items():
        if v is not None and k in METRIC_FIELDS:
            out[k] = float(v)
    return out


def emit_alert(tm, alert: dict) -> None:
    """One :data:`ALERT_EVENT` into the telemetry stream — the ONE
    emission point, so the event schema (rule / series / rank / value /
    threshold) cannot drift between collector venues.  Callers guard on
    ``tm.enabled``."""
    tm.event(ALERT_EVENT, rule=alert.get("rule"),
             series=alert.get("series"), scope=alert.get("scope"),
             worker=alert.get("rank"), value=alert.get("value"),
             threshold=alert.get("threshold"),
             action=alert.get("action"))


class MetricStreamer(threading.Thread):
    """Stream this process's metric snapshots to the collector.

    A daemon thread owning one :class:`~..parallel.wire.WireClient`:
    every ``interval_s`` it builds :func:`snapshot_from_telemetry` (plus
    caller ``extra()`` fields) and sends one :data:`METRICS_OP` request.
    A collector outage is survivable by construction — the wire client
    retries briefly, a failed send is dropped (``fleetmon.send_fail``)
    and the NEXT interval tries again; the snapshot stream needs no
    history, the newest sample is the state."""

    def __init__(self, addr: str, rank: int, role: str = "worker",
                 interval_s: float = 1.0, telemetry_=None,
                 extra: Optional[Callable[[], dict]] = None,
                 clock=None, client=None):
        super().__init__(daemon=True, name=f"fleetmon-stream-{role}{rank}")
        self.addr = str(addr)
        self.rank = int(rank)
        self.role = str(role)
        self.interval_s = float(interval_s)
        self.telemetry = telemetry_
        self.extra = extra
        self.clock = clock or WALL
        if client is None:
            from ..parallel.wire import WireClient
            # short budget: a snapshot is disposable — never stall the
            # streamer past its own cadence waiting on a dead collector
            client = WireClient(addr, client_id=f"{self.role}{self.rank}",
                                op_timeout_s=3.0, connect_timeout_s=2.0,
                                max_retries=1, deadline_s=4.0,
                                telemetry_=telemetry.DISABLED)
        self.client = client
        # push() runs on this thread AND from the caller (tests, the
        # final `left` sample in stop()) — the counters need the lock
        self._stats_lock = threading.Lock()
        self.sent = 0
        self.failed = 0
        self._halt = threading.Event()

    def _tm(self):
        return self.telemetry if self.telemetry is not None \
            else telemetry.active()

    def push(self, status: str = "live") -> bool:
        """Build + send one snapshot now; True when it landed."""
        tm = self._tm()
        sample = snapshot_from_telemetry(tm)
        if self.extra is not None:
            try:
                sample.update({k: float(v)
                               for k, v in (self.extra() or {}).items()
                               if v is not None and k in METRIC_FIELDS})
            except Exception:
                pass           # a metrics probe must never kill training
        header = {"op": METRICS_OP, "rank": self.rank, "role": self.role,
                  "status": status}
        try:
            self.client.request(header, json.dumps(sample).encode())
        except (ConnectionError, RuntimeError):
            with self._stats_lock:
                self.failed += 1
            if tm.enabled:
                tm.counter("fleetmon.send_fail")
            return False
        with self._stats_lock:
            self.sent += 1
        if tm.enabled:
            tm.counter("fleetmon.sent")
        return True

    def run(self) -> None:
        while not self._halt.wait(self.interval_s):
            self.push()

    def stop(self, final: bool = True, join_timeout: float = 5.0) -> None:
        """Stop streaming; ``final=True`` sends one last ``left`` sample
        so the collector retires this rank instead of raising a
        heartbeat alert over a clean exit."""
        self._halt.set()
        if self.is_alive():
            self.join(timeout=join_timeout)
        if final:
            self.push(status="left")
        try:
            self.client.close()
        except OSError:
            pass


# -- the collector ------------------------------------------------------------

class SeriesRing:
    """One bounded time series: ``(ts, value)`` samples, newest last."""

    __slots__ = ("samples",)

    def __init__(self, depth: int = 512):
        self.samples: deque = deque(maxlen=int(depth))

    def append(self, ts: float, value: float) -> None:
        self.samples.append((float(ts), float(value)))

    def latest(self) -> Optional[Tuple[float, float]]:
        return self.samples[-1] if self.samples else None

    def window(self, since: float) -> List[Tuple[float, float]]:
        return [(t, v) for t, v in self.samples if t >= since]

    def at_or_before(self, ts: float) -> Optional[Tuple[float, float]]:
        out = None
        for t, v in self.samples:
            if t <= ts:
                out = (t, v)
            else:
                break
        return out


def _quantile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class FleetCollector:
    """Windowed fleet time series + the SLO rule engine.

    Transport-agnostic: :meth:`ingest` is called by the wire server
    (:class:`FleetMonServer`) and by the supervisor for its own
    liveness — same method, same semantics.
    ``evaluate()`` runs every rule against the current state; each
    breach EPISODE fires exactly one alert (telemetry event + alert log
    + ``on_alert`` callback + the action queue the supervisor drains).
    Thread-safe; every decision-time comparison goes through the
    injectable clock, so a test drives the engine in virtual time."""

    def __init__(self, rules: Optional[Sequence[dict]] = None,
                 ring_depth: int = 512, eval_window_s: float = 2.0,
                 telemetry_=None, clock=None,
                 on_alert: Optional[Callable[[dict], None]] = None):
        self.rules = validate_rules(DEFAULT_RULES if rules is None
                                    else rules)
        self.ring_depth = int(ring_depth)
        self.eval_window_s = float(eval_window_s)
        self.telemetry = telemetry_
        self.clock = clock or WALL
        self.on_alert = on_alert
        self._lock = threading.Lock()
        # rank -> series name -> SeriesRing
        self.series: Dict[int, Dict[str, SeriesRing]] = {}
        self.roles: Dict[int, str] = {}
        self.last_seen: Dict[int, float] = {}
        self.retired: set = set()          # clean departures: no alerts
        self.samples_ingested = 0
        self.alerts: List[dict] = []       # every alert ever fired
        self.actions: deque = deque()      # alerts with an action, FIFO
        # (rule, scope key) -> {"breach_since": ts|None, "firing": bool}
        self._state: Dict[Tuple[str, Any], dict] = {}
        self.evaluations = 0

    def _tm(self):
        return self.telemetry if self.telemetry is not None \
            else telemetry.active()

    # -- ingest -------------------------------------------------------------

    def ingest(self, sample: Dict[str, Any], rank: int,
               role: str = "worker", status: str = "live",
               now: Optional[float] = None) -> None:
        now = self.clock.now() if now is None else float(now)
        rank = int(rank)
        with self._lock:
            self.samples_ingested += 1
            self.roles[rank] = str(role)
            self.last_seen[rank] = now
            if status == "left":
                self.retired.add(rank)
                return
            self.retired.discard(rank)     # a respawn streams again
            rings = self.series.setdefault(rank, {})
            for name in METRIC_FIELDS:
                v = sample.get(name)
                if v is None:
                    continue
                ring = rings.get(name)
                if ring is None:
                    ring = rings[name] = SeriesRing(self.ring_depth)
                ring.append(now, float(v))

    # -- series views -------------------------------------------------------

    def _ranks_for(self, rule: dict) -> List[int]:
        roles = rule.get("roles")
        return sorted(r for r in self.roles
                      if r not in self.retired
                      and (roles is None or self.roles[r] in roles))

    def _value(self, rule: dict, rank: int, now: float) -> Optional[float]:
        """The rule's series value for one rank at ``now`` — streamed
        latest sample, or the derived heartbeat age."""
        if rule["series"] == "heartbeat_age_s":
            seen = self.last_seen.get(rank)
            return None if seen is None else max(0.0, now - seen)
        ring = self.series.get(rank, {}).get(rule["series"])
        if ring is None:
            return None
        latest = ring.latest()
        return None if latest is None else latest[1]

    def fleet_rollup(self, series: str,
                     quantiles: Sequence[float] = (0.5, 0.9, 1.0),
                     now: Optional[float] = None) -> Dict[str, float]:
        """Percentiles of the latest per-rank values of one series."""
        now = self.clock.now() if now is None else float(now)
        rule = {"series": series}
        with self._lock:
            ranks = [r for r in self.roles if r not in self.retired]
            vals = [v for v in (self._value(rule, r, now) for r in ranks)
                    if v is not None]
        out = {}
        for q in quantiles:
            v = _quantile(vals, q)
            if v is not None:
                out[f"p{int(q * 100)}"] = round(v, 6)
        out["n"] = len(vals)
        return out

    # -- the rule engine ----------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass: returns the alerts that fired NOW.

        Episode semantics (the no-flapping contract): per (rule, scope
        key) the engine tracks when the breach began; ``sustained``
        fires once the breach has held ``window_s``, ``threshold`` /
        ``rate_of_change`` / ``fleet_quantile`` fire on the first
        breaching evaluation — and NONE re-fire until an evaluation has
        seen the condition false (which also resets the sustain
        window)."""
        now = self.clock.now() if now is None else float(now)
        fired: List[dict] = []
        with self._lock:
            for rule in self.rules:
                scope = rule.get("scope", "fleet" if rule["predicate"] ==
                                 "fleet_quantile" else "rank")
                if scope == "fleet" or rule["predicate"] == "fleet_quantile":
                    keys = [(None, self._fleet_value(rule, now))]
                else:
                    keys = [(r, self._rank_value(rule, r, now))
                            for r in self._ranks_for(rule)]
                for rank, value in keys:
                    if value is None:
                        continue
                    st = self._state.setdefault(
                        (rule["name"], rank),
                        {"breach_since": None, "firing": False})
                    breach = _cmp(rule.get("op", ">"), value,
                                  float(rule["value"]))
                    if not breach:
                        st["breach_since"] = None
                        st["firing"] = False
                        continue
                    if st["breach_since"] is None:
                        st["breach_since"] = now
                    need = float(rule.get("window_s", 0.0)) \
                        if rule["predicate"] == "sustained" else 0.0
                    if st["firing"] or now - st["breach_since"] < need:
                        continue
                    st["firing"] = True
                    alert = {"ts": round(now, 3), "rule": rule["name"],
                             "series": rule["series"],
                             "predicate": rule["predicate"],
                             "scope": "fleet" if rank is None else "rank",
                             "rank": rank, "value": round(value, 6),
                             "threshold": float(rule["value"]),
                             "action": rule.get("action")}
                    fired.append(alert)
            self.evaluations += 1
            self.alerts.extend(fired)
            for a in fired:
                if a["action"]:
                    self.actions.append(a)
        tm = self._tm()
        for a in fired:
            if tm.enabled:
                emit_alert(tm, a)
            if self.on_alert is not None:
                self.on_alert(a)
        return fired

    def _rank_value(self, rule: dict, rank: int,
                    now: float) -> Optional[float]:
        if rule["predicate"] == "rate_of_change":
            ring = self.series.get(rank, {}).get(rule["series"])
            if ring is None:
                return None
            latest = ring.latest()
            base = ring.at_or_before(now - float(rule["window_s"]))
            if latest is None or base is None or latest[0] <= base[0]:
                return None
            return (latest[1] - base[1]) / (latest[0] - base[0])
        return self._value(rule, rank, now)

    def _fleet_value(self, rule: dict, now: float) -> Optional[float]:
        vals = [v for v in (self._value(rule, r, now)
                            for r in self._ranks_for(rule))
                if v is not None]
        if len(vals) < 2:
            return None        # one rank is not a fleet — no quantile
        return _quantile(vals, float(rule.get("quantile", 0.5)))

    def pop_actions(self) -> List[dict]:
        """Drain the action queue (the supervisor's per-tick read)."""
        with self._lock:
            out = list(self.actions)
            self.actions.clear()
        return out

    # -- exposition ---------------------------------------------------------

    def expose_text(self, now: Optional[float] = None) -> str:
        """Prometheus-style text exposition: one
        ``theanompi_<series>{rank=...,role=...}`` line per live rank per
        registered series, fleet rollup gauges, and the alert counter —
        every name in :data:`FLEET_SERIES` appears even when no rank
        streams it yet (schema guarantee: scraping never misses a series
        because the fleet is young)."""
        now = self.clock.now() if now is None else float(now)
        lines: List[str] = []
        with self._lock:
            ranks = sorted(r for r in self.roles if r not in self.retired)
            for name in FLEET_SERIES:
                metric = "theanompi_" + name
                lines.append(f"# TYPE {metric} gauge")
                for rank in ranks:
                    v = self._value({"series": name}, rank, now)
                    if v is None:
                        continue
                    lines.append(
                        f'{metric}{{rank="{rank}",'
                        f'role="{self.roles[rank]}"}} {v:g}')
            lines.append("# TYPE theanompi_fleet_alerts_total counter")
            lines.append(f"theanompi_fleet_alerts_total {len(self.alerts)}")
            lines.append("# TYPE theanompi_fleet_ranks gauge")
            lines.append(f"theanompi_fleet_ranks {len(ranks)}")
        return "\n".join(lines) + "\n"

    def status(self) -> dict:
        with self._lock:
            return {"ranks": sorted(self.roles),
                    "retired": sorted(self.retired),
                    "samples": self.samples_ingested,
                    "evaluations": self.evaluations,
                    "alerts": len(self.alerts),
                    "rules": [r["name"] for r in self.rules]}

    # -- crash-recovery snapshots -------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "series": {str(r): {n: list(ring.samples)
                                    for n, ring in rings.items()}
                           for r, rings in self.series.items()},
                "roles": {str(r): v for r, v in self.roles.items()},
                "last_seen": {str(r): v for r, v in self.last_seen.items()},
                "retired": sorted(self.retired),
                "alerts": list(self.alerts),
                "state": [[name, rank, dict(st)] for (name, rank), st
                          in self._state.items()],
                "samples": self.samples_ingested,
            }

    def restore(self, snap: dict) -> None:
        with self._lock:
            self.series = {}
            for r, rings in (snap.get("series") or {}).items():
                dst = self.series[int(r)] = {}
                for n, samples in rings.items():
                    ring = dst[n] = SeriesRing(self.ring_depth)
                    for ts, v in samples:
                        ring.append(ts, v)
            self.roles = {int(r): str(v)
                          for r, v in (snap.get("roles") or {}).items()}
            self.last_seen = {int(r): float(v) for r, v in
                              (snap.get("last_seen") or {}).items()}
            self.retired = set(int(r) for r in snap.get("retired", ()))
            self.alerts = list(snap.get("alerts") or ())
            self._state = {(str(name), rank): dict(st)
                           for name, rank, st in snap.get("state", ())}
            self.samples_ingested = int(snap.get("samples", 0))


# -- alert → supervision ------------------------------------------------------

def apply_alert(controller, alert: dict) -> bool:
    """Feed one actionable alert into the membership plane: a per-rank
    ``demote`` alert drives the EXISTING demotion path with the firing
    rule cited in the ``worker_demote`` event (``rule=``).  Returns True
    when a demotion actually happened (the controller still owns the
    min-active floor)."""
    if alert.get("action") != "demote" or alert.get("rank") is None:
        return False
    return controller.demote(
        int(alert["rank"]), reason="alert", rule=alert.get("rule"),
        series=alert.get("series"), value=alert.get("value"))


def fleet_flight_dump(record_dir: str, reason: str,
                      timeout_s: float = 2.0) -> List[str]:
    """Ask every registered statusz endpoint to dump its flight ring
    (the ``flight`` op) — the fleet-wide what-was-everyone-doing
    trail a fleet-scoped alert (``queue_starved``) triggers.  Returns
    the dump paths the endpoints reported."""
    from . import tracing
    paths: List[str] = []
    for doc in tracing.read_statusz_docs(record_dir):
        addr = f"{doc.get('host', '127.0.0.1')}:{doc.get('port')}"
        try:
            rep = tracing.statusz_query(addr, "flight", timeout_s=timeout_s)
        except Exception:
            continue               # a DOWN process dumped on its own way out
        if rep.get("path"):
            paths.append(rep["path"])
    return paths


# -- the live chaos alert-audit -----------------------------------------------

def alert_deadline_s(rule: dict, duration_s: float, eval_window_s: float,
                     interval_s: float) -> float:
    """How long after a fault LANDS its alert may legitimately take:
    the fault's own duration (a window's symptom may persist until it
    closes), the rule's detection budget (a heartbeat threshold IS
    seconds-of-silence before the symptom exists; a sustained window
    must fill), one streamer interval (the sample that carries the
    symptom), and ONE evaluation window — the acceptance bound."""
    budget = float(duration_s) + float(interval_s) + float(eval_window_s)
    budget += float(rule.get("window_s", 0.0) or 0.0)
    if rule.get("series") == "heartbeat_age_s":
        budget += float(rule.get("value", 0.0))
    return budget


def audit_alerts(alert_events: Sequence[dict], realized: Sequence[dict],
                 rules: Sequence[dict], eval_window_s: float,
                 interval_s: float = 1.0) -> Tuple[bool, List[str]]:
    """The chaos harness's closing check: every LANDED fault whose
    symptom a rule covers must have produced its alert within one
    evaluation window of the symptom becoming visible
    (:func:`alert_deadline_s`).

    ``alert_events`` are :data:`ALERT_EVENT` telemetry events (or the
    collector's own alert log — same schema), ``realized`` the realized-
    schedule docs (``chaos_realized.jsonl`` lines) in
    the SAME time base as the alerts (wall epoch live, virtual seconds
    in a rehearsal).  A fault is COVERED when a rule named by
    :data:`FAULT_ALERT_COVERAGE` for its kind is in the active rule set.
    Returns ``(ok, lines)`` — lines name every fault checked and every
    miss."""
    by_name = {r["name"]: r for r in rules}
    lines: List[str] = []
    ok = True
    alerts = [dict(a) for a in alert_events]
    for a in alerts:
        # telemetry events carry the alerted rank as `worker`
        # (emit_alert) — their envelope `rank` is the EMITTING process
        # (the collector's registry), which must not shadow the target;
        # collector-log alerts carry `rank` and no `worker`
        if "worker" in a:
            a["rank"] = a.get("worker")
    for doc in realized:
        if doc.get("error"):
            continue                       # never landed — no symptom owed
        kind = str(doc.get("kind"))
        covered = [n for n in FAULT_ALERT_COVERAGE.get(kind, ())
                   if n in by_name]
        if not covered:
            continue
        target = doc.get("target")
        t_fault = float(doc.get("ts", doc.get("rel", 0.0)))
        deadline = t_fault + max(
            alert_deadline_s(by_name[n], doc.get("duration", 0.0),
                             eval_window_s, interval_s) for n in covered)
        hit = None
        for a in alerts:
            if a.get("rule") not in covered:
                continue
            if a.get("rank") is not None and target not in (-1, None) \
                    and int(a["rank"]) != int(target):
                continue
            ats = float(a.get("ts", 0.0))
            if t_fault <= ats <= deadline:
                hit = a
                break
        if hit is None:
            ok = False
            lines.append(
                f"ALERT-AUDIT FAIL: {kind}@{round(t_fault, 1)} on "
                f"w{target} raised none of {covered} by "
                f"+{round(deadline - t_fault, 1)}s")
        else:
            lines.append(
                f"alert-audit: {kind} on w{target} -> {hit['rule']} "
                f"(+{round(float(hit['ts']) - t_fault, 1)}s, value "
                f"{hit.get('value')})")
    return ok, lines


# -- the collector service ----------------------------------------------------

class FleetMonServer:
    """Serve a :class:`FleetCollector` over the wire framing.

    Ops: :data:`METRICS_OP` (ingest one snapshot — dedup-windowed, so a
    wire-retried sample lands once), ``series`` (one rank+series window),
    ``rollup`` (fleet percentiles), ``alerts`` (the alert log tail),
    ``exposition`` (the Prometheus-style text, as the reply body), and
    ``health`` (statusz-compatible: fleetz probes this server like any
    other roster entry).  A discovery doc registers under
    ``<run_dir>/statusz/`` with role ``fleetmon``; an evaluation thread
    runs the rule engine every ``eval_window_s``; ``snapshot_dir``
    enables crash-atomic state snapshots restored on start."""

    def __init__(self, collector: Optional[FleetCollector] = None,
                 rules: Optional[Sequence[dict]] = None,
                 run_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_s: float = 2.0,
                 eval_window_s: float = 2.0,
                 idle_timeout_s: float = 60.0, telemetry_=None):
        self.collector = collector if collector is not None else \
            FleetCollector(rules=rules, eval_window_s=eval_window_s,
                           telemetry_=telemetry_)
        self.run_dir = run_dir
        self.snapshot_dir = snapshot_dir
        self.snapshot_every_s = float(snapshot_every_s)
        self.idle_timeout_s = float(idle_timeout_s)
        self.telemetry = telemetry_
        self.t0 = time.time()
        self._srv = None
        self._thread: Optional[threading.Thread] = None
        self._eval_thread: Optional[threading.Thread] = None
        self._halt = threading.Event()
        self._doc_path: Optional[str] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        from ..parallel import wire as _wire
        self._wire = _wire
        self.dedup = _wire.DedupWindow(depth=256,
                                       telemetry_=telemetry.DISABLED)

    def _tm(self):
        return self.telemetry if self.telemetry is not None \
            else telemetry.active()

    # -- snapshots ----------------------------------------------------------

    def _snap_path(self) -> Optional[str]:
        return os.path.join(self.snapshot_dir, "fleetmon_state.json") \
            if self.snapshot_dir else None

    def snapshot(self) -> Optional[str]:
        path = self._snap_path()
        if not path:
            return None
        from .checkpoint import _fsync_write
        os.makedirs(self.snapshot_dir, exist_ok=True)
        state = {"collector": self.collector.snapshot(),
                 "dedup": self.dedup.snapshot()}
        _fsync_write(path, lambda f: f.write(
            json.dumps(state, sort_keys=True).encode()))
        return path

    def restore(self) -> bool:
        path = self._snap_path()
        if not path or not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                state = json.load(f)
            self.collector.restore(state.get("collector") or {})
            self.dedup.restore(state.get("dedup") or {})
        except (ValueError, OSError):
            return False           # torn/garbage snapshot: start fresh
        return True

    def _eval_loop(self) -> None:
        last_mark = None
        while not self._halt.wait(self.collector.eval_window_s):
            try:
                self.collector.evaluate()
                if self.snapshot_dir:
                    c = self.collector
                    mark = (c.samples_ingested, len(c.alerts))
                    if mark != last_mark:
                        self.snapshot()
                        last_mark = mark
            except Exception:
                pass               # evaluation must never kill serving

    # -- serving ------------------------------------------------------------

    def status(self) -> dict:
        tm = self._tm()
        out = {"ok": True, "role": "fleetmon", "id": 0,
               "pid": os.getpid(),
               "uptime_s": round(time.time() - self.t0, 1),
               "run": getattr(tm, "run_id", None)}
        out.update(self.collector.status())
        return out

    def start(self, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[str, int]:
        import socketserver
        wire = self._wire
        collector = self.collector
        dedup = self.dedup
        idle = self.idle_timeout_s
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.settimeout(idle)
                with outer._conns_lock:
                    outer._conns.add(self.request)
                try:
                    while True:
                        try:
                            header, body = wire.recv_msg(self.request)
                        except wire.VersionMismatch as e:
                            wire.send_msg(self.request,
                                          {"ok": False, "error": str(e)})
                            return
                        except wire.CorruptPayload as e:
                            wire.send_msg(self.request,
                                          {"ok": False, "error": str(e),
                                           "retry": True})
                            continue
                        try:
                            self._dispatch(header, body)
                        except (ConnectionError, OSError):
                            raise
                        except Exception as e:
                            wire.send_msg(self.request,
                                          {"ok": False, "error": repr(e)})
                except Exception:
                    return         # peer gone / idle / bad frame: drop it
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(self.request)

            def _dispatch(self, header, body):
                op = header.get("op")
                tok = header.get("tok")
                if op == METRICS_OP:
                    dup, cached = dedup.check(tok, op)
                    if dup:
                        # a retried snapshot (reply lost in flight): the
                        # original landed — ack without re-ingesting
                        wire.send_msg(self.request,
                                      {"ok": True, "dedup": True})
                        return
                    try:
                        sample = json.loads(body.decode()) if body else {}
                        collector.ingest(
                            sample, rank=int(header.get("rank", 0)),
                            role=str(header.get("role", "worker")),
                            status=str(header.get("status", "live")))
                        dedup.record(tok, op, {"ok": True})
                    except Exception:
                        dedup.release(tok, op)
                        raise
                    wire.send_msg(self.request, {"ok": True})
                elif op == "series":
                    rank = int(header.get("rank", 0))
                    name = str(header.get("series"))
                    # under the collector lock: ingest appends to the
                    # ring concurrently, and copying a mutating deque
                    # raises mid-iteration
                    with collector._lock:
                        ring = collector.series.get(rank, {}).get(name)
                        samples = list(ring.samples) if ring else []
                    wire.send_msg(self.request,
                                  {"ok": True, "samples": samples})
                elif op == "rollup":
                    wire.send_msg(self.request, {
                        "ok": True,
                        "rollup": collector.fleet_rollup(
                            str(header.get("series")))})
                elif op == "alerts":
                    n = int(header.get("n", 32))
                    with collector._lock:
                        tail = collector.alerts[-n:]
                    wire.send_msg(self.request,
                                  {"ok": True, "alerts": tail})
                elif op == "exposition":
                    wire.send_msg(self.request, {"ok": True},
                                  collector.expose_text().encode())
                elif op in ("health", "events"):
                    # statusz-compatible: fleetz probes this roster entry
                    # with the same ops it sends every other process
                    if op == "health":
                        wire.send_msg(self.request, outer.status())
                    else:
                        tm = outer._tm()
                        evs = tm.tail(int(header.get("n", 16))) \
                            if tm.enabled else []
                        wire.send_msg(self.request,
                                      {"ok": True, "events": evs})
                else:
                    wire.send_msg(self.request,
                                  {"ok": False,
                                   "error": f"unknown fleetmon op {op!r}"})

        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.restore()
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="fleetmon-serve")
        self._thread.start()
        self._eval_thread = threading.Thread(target=self._eval_loop,
                                             daemon=True,
                                             name="fleetmon-eval")
        self._eval_thread.start()
        host, port = self._srv.server_address[:2]
        if self.run_dir:
            from . import tracing
            d = tracing.statusz_dir(self.run_dir)
            try:
                os.makedirs(d, exist_ok=True)
                self._doc_path = os.path.join(d, "fleetmon_0.json")
                tmp = f"{self._doc_path}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump({"role": "fleetmon", "id": 0,
                               "pid": os.getpid(), "host": host,
                               "port": port, "ts": time.time()}, f)
                os.replace(tmp, self._doc_path)
            except OSError:
                self._doc_path = None     # discovery is best-effort
        return host, port

    def stop(self, deregister: bool = True,
             final_snapshot: bool = True) -> None:
        self._halt.set()
        if self._eval_thread is not None:
            self._eval_thread.join(timeout=10)
            self._eval_thread = None
        if final_snapshot and self.snapshot_dir:
            try:
                self.snapshot()
            except Exception:
                pass
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
            # a collector death severs every in-flight connection; an
            # in-process stop must too, or persistent streamer
            # connections keep feeding a 'dead' collector (and restart
            # tests test nothing)
            with self._conns_lock:
                conns = list(self._conns)
                self._conns.clear()
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._doc_path is not None:
            if deregister:
                try:
                    os.remove(self._doc_path)
                except OSError:
                    pass
            self._doc_path = None
