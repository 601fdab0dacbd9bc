"""Training sentry: catch a sick run before it burns a hardware window.

Counterpart of ``theanompi_tpu/utils/sentry.py``, a copy (stdlib only).
The pattern this exists for: a run keeps dispatching —
so the stall watchdog stays quiet — while the loss has gone NaN, spiked
off a cliff, or throughput has silently halved (a degraded tunnel
window, a straggling data producer, a bad LR resume).  Nothing notices
until a human reads the console hours later.  The sentry watches the
recorder's print-cadence records and raises a structured ``anomaly``
event + a flight-recorder dump the moment the run stops looking like a
training run:

* **nan_loss** — the printed cost is NaN/±inf;
* **loss_spike** — cost exceeds the rolling-window median by
  ``sentry_loss_spike`` × the window's median-absolute-deviation scale
  (robust: one spike can't poison its own baseline, and WGAN-style
  negative losses don't break a ratio test);
* **throughput_regression** — images/sec drops below
  ``sentry_tput_drop`` × the rolling median;
* **grad_overflow** — the numerics plane (``utils/numerics.py``) reports
  nonfinite gradient entries or a non-finite gradient norm;
* **update_ratio_collapse** — the update-to-param ratio falls below the
  absolute ``sentry_ratio_floor`` while gradients are nonzero: the
  optimizer is applying nothing (a zeroed LR resume, a saturated scale);
* **replica_divergence** — the cross-rank consistency beacon reports a
  digest mismatch beyond ``sentry_divergence_eps`` between replicas the
  exchange rule declares bit-identical (BSP post-reduce params, the
  EASGD/ASGD center copy).

The numerics detectors run off :meth:`observe_numerics` (fed the
``numerics.host_report`` dict at the same print cadence) and honor
:meth:`notice_discontinuity` exactly like the throughput detector: the
first report after a val/ckpt/restore boundary may describe a
legitimately transient state (a ``center_restore`` rejoin pulls
‖w−c‖ and the beacon through a real discontinuity) and is neither
judged nor learned from.

Detection runs at print cadence only (never per step — zero hot-path
cost), emits :data:`ANOMALY_EVENT` events through the telemetry
registry, and triggers the existing flight-recorder dump once per
anomaly kind (the trail of the N events leading INTO the anomaly is the
diagnosable part; repeat dumps would only overwrite it with the sick
steady-state).  The event schema is the JAX package's.

Config knobs (worker config): ``sentry`` (default on whenever telemetry
is enabled; ``false`` disables), ``sentry_loss_spike`` (default 6.0 MAD
multiples), ``sentry_tput_drop`` (default 0.4), ``sentry_window``
(records, default 16), ``sentry_min_records`` (arming threshold,
default 4).

Stdlib-only by contract.
"""

from __future__ import annotations

import math
from collections import deque
from statistics import median
from typing import Any, Dict, List, Optional, Tuple

ANOMALY_EVENT = "anomaly"
ANOMALY_KINDS = ("nan_loss", "loss_spike", "throughput_regression",
                 "grad_overflow", "update_ratio_collapse",
                 "replica_divergence")


class TrainingSentry:
    """Rolling-window anomaly detector over recorder print records."""

    def __init__(self, config: Optional[dict] = None, telemetry=None):
        config = config or {}
        if telemetry is None:
            from . import telemetry as telemetry_mod
            telemetry = telemetry_mod.active()
        self.telemetry = telemetry
        self.loss_spike_mads = float(config.get("sentry_loss_spike", 6.0))
        self.tput_drop_share = float(config.get("sentry_tput_drop", 0.4))
        self.window = max(2, int(config.get("sentry_window", 16)))
        self.min_records = max(2, int(config.get("sentry_min_records", 4)))
        self.verbose = bool(config.get("verbose", True))
        self._costs: deque = deque(maxlen=self.window)
        self._tputs: deque = deque(maxlen=self.window)
        self.ratio_floor = float(config.get("sentry_ratio_floor", 1e-12))
        self.divergence_eps = float(config.get("sentry_divergence_eps", 0.0))
        self.records_seen = 0
        self.anomalies: List[Tuple[str, Any]] = []      # (kind, iter)
        self._dumped: set = set()
        self._tput_discontinuity = False
        self._numerics_discontinuity = False
        self._numerics_last_iter: Optional[int] = None

    def notice_discontinuity(self) -> None:
        """The caller declares the next record's throughput unrepresentative
        — the recorder's images/sec is wall time since the LAST TRAIN
        print, so the first record after a validation pass / checkpoint /
        shuffle spans that dead time and would read as a regression.  The
        next record's throughput is neither judged nor learned from; loss
        detection is unaffected (cost has no wall-time denominator).  The
        numerics detectors honor the same boundary (the first report after
        it may describe a transient rejoin/restore state)."""
        self._tput_discontinuity = True
        self._numerics_discontinuity = True

    # -- detection ----------------------------------------------------------

    def _loss_spike(self, cost: float) -> Optional[Dict[str, float]]:
        if len(self._costs) < self.min_records:
            return None
        med = median(self._costs)
        # MAD scale with a floor: a flat window (MAD 0) must not turn
        # float noise into an anomaly, so the deviation also has to clear
        # 5% of the median's magnitude (or an absolute epsilon near zero)
        mad = median(abs(c - med) for c in self._costs)
        scale = max(mad, 0.05 * abs(med), 1e-6)
        threshold = med + self.loss_spike_mads * scale
        if cost > threshold:
            return {"cost": cost, "median": med, "threshold": threshold}
        return None

    def _tput_regression(self, ips: float) -> Optional[Dict[str, float]]:
        if len(self._tputs) < self.min_records:
            return None
        med = median(self._tputs)
        threshold = self.tput_drop_share * med
        if med > 0 and ips < threshold:
            return {"images_per_sec": ips, "median": med,
                    "threshold": threshold}
        return None

    def observe_record(self, rec: dict) -> Optional[str]:
        """Feed one ``print_train_info`` record; returns the anomaly kind
        raised (first match wins: a NaN loss is not ALSO a spike), or
        None for a healthy record."""
        self.records_seen += 1
        it = rec.get("iter")
        cost = rec.get("cost")
        ips = rec.get("images_per_sec")
        kind = None
        detail: Dict[str, Any] = {}
        if cost is not None:
            try:
                cost = float(cost)
            except (TypeError, ValueError):
                cost = None
        if cost is not None and not math.isfinite(cost):
            kind, detail = "nan_loss", {"cost": str(cost)}
        elif cost is not None:
            d = self._loss_spike(cost)
            if d is not None:
                kind, detail = "loss_spike", d
        tput_ok = isinstance(ips, (int, float)) and ips > 0 and \
            not self._tput_discontinuity
        self._tput_discontinuity = False
        if kind is None and tput_ok:
            d = self._tput_regression(float(ips))
            if d is not None:
                kind, detail = "throughput_regression", d
        # windows only learn from healthy, finite samples — an anomaly
        # must not drag its own detection baseline toward itself
        if kind is None:
            if cost is not None and math.isfinite(cost):
                self._costs.append(cost)
            if tput_ok:
                self._tputs.append(float(ips))
        if kind is not None:
            self._raise(kind, it, detail)
        return kind

    def observe_numerics(self, report: Optional[dict]) -> Optional[str]:
        """Feed one ``numerics.host_report`` dict (print cadence); returns
        the anomaly kind raised, first match wins — an overflow is not
        ALSO judged for divergence.  Detectors are absolute-threshold
        (no rolling baseline): a corrupted replica or a zeroed update is
        anomalous from the very first report, which is what lets the
        chaos/SIGTERM coverage tests assert deterministically."""
        if report is None:
            return None
        it = report.get("iter")
        # the aux is a latest-sample carry — the same sample can surface
        # under several print records at a sparse cadence; judge each
        # sampled step once
        if it is not None and it == self._numerics_last_iter:
            return None
        self._numerics_last_iter = it
        if self._numerics_discontinuity:
            # val/ckpt/restore boundary: a center_restore rejoin or a
            # checkpoint reload legitimately moves ‖w−c‖/the beacon —
            # the first report after it is neither judged nor learned from
            self._numerics_discontinuity = False
            return None
        grad_norm = float(report.get("grad_norm", 0.0))
        nonfinite = float(report.get("nonfinite", 0.0))
        kind: Optional[str] = None
        detail: Dict[str, Any] = {}
        if nonfinite > 0 or not math.isfinite(grad_norm):
            kind = "grad_overflow"
            detail = {"nonfinite": nonfinite, "grad_norm": str(grad_norm)}
        if kind is None:
            div = report.get("divergence")
            if div is not None and div > self.divergence_eps:
                kind = "replica_divergence"
                detail = {"divergence": str(div),
                          "threshold": self.divergence_eps}
        if kind is None:
            ratio = float(report.get("update_ratio", 1.0))
            if grad_norm > 0 and ratio < self.ratio_floor:
                kind = "update_ratio_collapse"
                detail = {"update_ratio": ratio,
                          "grad_norm": grad_norm,
                          "floor": self.ratio_floor}
        if kind is not None:
            self._raise(kind, it, detail)
        return kind

    # -- reaction -----------------------------------------------------------

    def _raise(self, kind: str, it, detail: Dict[str, Any]) -> None:
        self.anomalies.append((kind, it))
        tm = self.telemetry
        if tm.enabled:
            tm.event(ANOMALY_EVENT, kind=kind, iter=it, **detail)
            tm.counter("sentry.anomalies")
            tm.counter("sentry." + kind)
            if kind not in self._dumped:
                # one dump per kind: the ring holds the events leading INTO
                # the first occurrence — the diagnosable part; later
                # occurrences would overwrite it with the sick steady-state
                self._dumped.add(kind)
                tm.dump_flight(reason=f"sentry {kind} at iter {it}")
        if self.verbose:
            pretty = " ".join(f"{k}={v}" for k, v in detail.items())
            print(f"SENTRY: {kind} at iter {it} ({pretty})", flush=True)
