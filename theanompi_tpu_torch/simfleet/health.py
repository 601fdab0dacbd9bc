"""Simulated metric streams through the REAL fleet-health plane.

Counterpart of ``theanompi_tpu/simfleet/health.py``, on the port's
``utils/fleetmon.py``.

The §20 rule engine must be rehearsable at width without hardware: this
module wires a :class:`~theanompi_tpu_torch.utils.fleetmon.FleetCollector` —
the PRODUCTION collector and rule engine, not a stand-in — into a
:class:`~theanompi_tpu_torch.simfleet.fleet.FleetSim` run on the fleet's
virtual clock.  The simulated metric stream mirrors what the live
emitters send:

* every lease beat doubles as a snapshot arrival (the live
  ``MetricStreamer`` runs at its own cadence whatever the hot loop
  does; the sim's ``BEAT_EVERY_S`` events are exactly that cadence), so
  the derived ``heartbeat_age_s`` series sees kills and wedges with no
  cooperation from the dying worker;
* a completed exchange round lands one ``step_p99`` sample (round
  duration — compute AND wire, like the live phase brackets);
* every wire retry bumps the rank's CUMULATIVE ``wire_retries`` series
  (the live ``wire.retry`` counter the snapshot carries), which the
  ``wire_degraded`` rate-of-change rule turns into fault-window-shaped
  episodes — it clears when the retries stop, so successive net faults
  each get their own alert.

Alerts fire through the real episode/hysteresis logic and are appended
to the fleet's canonical event log, so the §18 determinism contract
extends to the health plane: same seed ⇒ byte-identical alert log, and
a seeded fault schedule raises exactly the expected alert set with no
flapping (tests/test_torch_simfleet.py pins both).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..utils import telemetry
from ..utils.fleetmon import FleetCollector


def sim_rules(fleet) -> list:
    """The stock rehearsal rule set, scaled to the fleet's own timing
    parameters (a fixed absolute step-time threshold would mean nothing
    across configs): a heartbeat lost past the lease timeout, a round
    time sustained above 2× the jitter-ceiling expectation (a 4× delay
    straggler clears it, healthy jitter does not), and a wire retry
    burst (rate-of-change over the cumulative counter)."""
    expected_round = fleet.sync_freq * fleet.step_time_s * \
        (1.0 + fleet.step_jitter)
    return [
        {"name": "heartbeat_lost", "series": "heartbeat_age_s",
         "predicate": "threshold", "op": ">",
         "value": float(fleet.lease_timeout), "scope": "rank",
         "roles": ("worker",)},
        {"name": "step_time_degraded", "series": "step_p99",
         "predicate": "sustained", "op": ">",
         "value": 2.0 * expected_round,
         "window_s": float(fleet.straggle_window_s), "scope": "rank",
         "action": "demote", "roles": ("worker",)},
        {"name": "wire_degraded", "series": "wire_retries",
         "predicate": "rate_of_change", "op": ">", "value": 0.05,
         "window_s": 5.0, "scope": "rank", "roles": ("worker",)},
        # the §25 beacon: any nonzero divergence sample above float
        # noise is a replica that bit-desynced from the consensus — a
        # `corrupt` fault sets it orders of magnitude above this floor
        {"name": "replica_divergence", "series": "divergence",
         "predicate": "threshold", "op": ">", "value": 1e-6,
         "scope": "rank", "roles": ("worker",)},
    ]


class HealthPlane:
    """One collector + rule engine over a running :class:`FleetSim`.

    The fleet calls the three ``on_*`` hooks from its event handlers;
    :meth:`_tick` re-schedules itself on the fleet's event queue every
    ``eval_window_s`` virtual seconds — the same evaluation cadence the
    live :class:`~theanompi_tpu_torch.utils.fleetmon.FleetMonServer` runs."""

    def __init__(self, fleet, rules: Optional[Sequence[dict]] = None,
                 eval_window_s: float = 2.0):
        self.fleet = fleet
        self.eval_window_s = float(eval_window_s)
        self._retries: dict = {}            # wid -> cumulative count
        self.collector = FleetCollector(
            rules=sim_rules(fleet) if rules is None else rules,
            eval_window_s=self.eval_window_s,
            telemetry_=telemetry.DISABLED, clock=fleet.vclock,
            on_alert=self._on_alert)

    # -- alert sink ---------------------------------------------------------

    def _on_alert(self, alert: dict) -> None:
        self.fleet.log.append(self.fleet.vclock.now(), "alert",
                              rule=alert["rule"], series=alert["series"],
                              scope=alert["scope"], worker=alert["rank"],
                              value=round(float(alert["value"]), 6))

    # -- the simulated metric stream ----------------------------------------

    def on_beat(self, wid: int, status: str, steps: int) -> None:
        # every snapshot carries the cumulative retry count — the rate
        # rule needs steady baseline samples to measure a burst against
        self.collector.ingest(
            {"steps": float(steps),
             "wire_retries": float(self._retries.get(wid, 0))},
            rank=wid, role="worker", status=status)

    def on_round(self, wid: int, duration_s: float,
                 divergence: Optional[float] = None) -> None:
        sample = {"step_p99": float(duration_s),
                  "wire_retries": float(self._retries.get(wid, 0))}
        if divergence is not None:
            # every round carries the current beacon spread (0.0 when
            # healthy) so the replica_divergence episode can CLEAR once
            # the corruption is pulled back toward the center
            sample["divergence"] = float(divergence)
        self.collector.ingest(sample, rank=wid, role="worker")

    def on_wire_retry(self, wid: int) -> None:
        n = self._retries.get(wid, 0) + 1
        self._retries[wid] = n
        self.collector.ingest({"wire_retries": float(n)}, rank=wid,
                              role="worker")

    # -- evaluation loop ----------------------------------------------------

    def _tick(self) -> None:
        if self.fleet.stopped_reason:
            return
        self.collector.evaluate()
        if not self.fleet._alldone():
            self.fleet.queue.push(
                self.fleet.vclock.now() + self.eval_window_s, self._tick)

    def install(self) -> None:
        """Schedule the first evaluation (called from ``FleetSim.run``)."""
        self.fleet.queue.push(self.eval_window_s, self._tick)

    # -- summary ------------------------------------------------------------

    def summary(self) -> dict:
        by_rule: dict = {}
        for a in self.collector.alerts:
            by_rule[a["rule"]] = by_rule.get(a["rule"], 0) + 1
        return {"alerts": len(self.collector.alerts),
                "by_rule": dict(sorted(by_rule.items())),
                "evaluations": self.collector.evaluations}
