"""At-width invariant checkers over a finished :class:`FleetSim`.

Counterpart of ``theanompi_tpu/simfleet/invariants.py``.

Each checker returns ``(name, ok, detail)``; :func:`check_invariants`
runs them all and is the pass/fail verdict the CLI and its gate
print.  These are the properties the survivability plane CLAIMS at
production width but could never test there until now:

* **no-resurrect-after-death** — a dead worker re-enters only through a
  supervisor respawn; a stale-but-fresh-looking lease must never fold
  back into a join (the controller's dead-ts guard, at 1,000 workers).
* **Σα conservation under churn** — gossip mass is conserved through
  demotions, readmissions, kills, and derangement regenerations; a
  demoted rank's α is bit-frozen while it is out.
* **applied-exactly-once** — under dup storms, retry-after-applied-ack-
  lost, eviction, and center crash/restore, no (client, seq) lands on a
  shard twice, and no fresh token is wrongly swallowed by the window.
* **straggler stability** — the demotion loop converges: nobody flaps
  (bounded demote count per worker), persistent stragglers end demoted.
* **center-shard/push load balance** — K shards absorb the same pushes
  up to the churn the run actually had (deaths and skips each strand at
  most one partial round).
* **lease-timeout safe region** — no false deaths (a beating worker is
  never expired) and no late detections (an expiry verdict lands within
  lease_timeout + one poll period of silence).
* **topology sanity** — every MeshReactor regeneration produced
  embedded derangements: inactive ranks fixed, active ranks routed
  among themselves.
"""

from __future__ import annotations

from typing import List, Tuple

Result = Tuple[str, bool, str]


def _no_resurrect(fleet) -> Result:
    dead_kind = ("crashed", "wedged", "lease_expired")
    state: dict = {}
    bad: List[str] = []
    for rec in fleet.log.records:
        ev, w = rec["ev"], rec.get("worker")
        if ev == "worker_leave" and rec.get("reason") in dead_kind:
            state[w] = "dead"
        elif ev == "worker_leave":
            state[w] = "left"
        elif ev == "worker_join":
            prev = state.get(w)
            if prev in ("dead", "left") and \
                    rec.get("reason") not in ("respawn",):
                bad.append(f"worker {w} resurrected from {prev} via "
                           f"join reason={rec.get('reason')!r} "
                           f"at t={rec['t']}")
            state[w] = "live"
    for w in sorted(fleet.failed):
        if state.get(w) == "live":
            bad.append(f"restart-exhausted worker {w} came back")
    return ("no_resurrect_after_death", not bad,
            "; ".join(bad[:4]) or "dead workers re-entered only via "
            "supervisor respawns")


def _alpha_conservation(fleet) -> Result:
    total = sum(fleet.alpha[1:])
    drift = abs(total - fleet.alpha0_sum)
    bad: List[str] = list(fleet.alpha_violations)
    # still-demoted ranks at run end: α frozen since their demotion
    for wid, ref in sorted(fleet._alpha_at_demote.items()):
        if abs(fleet.alpha[wid] - ref) > 1e-9:
            bad.append(f"still-demoted worker {wid} alpha moved "
                       f"{ref} -> {fleet.alpha[wid]}")
    ok = drift < 1e-6 * max(1.0, fleet.alpha0_sum) and not bad
    return ("alpha_conservation_under_churn", ok,
            "; ".join(bad[:4]) or f"Σα drift {drift:.2e} over "
            f"{fleet.mesh.regens} topology regenerations")


def _exactly_once(fleet) -> Result:
    cs = fleet.center.stats()
    bad: List[str] = []
    if cs["violations"]:
        bad.append(f"{cs['violations']} re-applications "
                   f"(per-worker applied-seq ledger)")
    if fleet.dedup_first_attempt:
        bad.append(f"{len(fleet.dedup_first_attempt)} fresh tokens "
                   f"wrongly answered from the dedup window, e.g. "
                   f"{fleet.dedup_first_attempt[0]}")
    # only twins that reached a LIVE center had anything to dedup — a
    # dup window entirely inside a center outage is not a dedup miss
    dups = fleet.transport.dup_applied
    hits = sum(cs["dedup_hits_per_shard"])
    if dups and not hits:
        bad.append(f"{dups} duplicated frames but 0 dedup hits — "
                   f"duplicates were re-applied")
    return ("dedup_applied_exactly_once", not bad,
            "; ".join(bad) or f"{sum(cs['applied_per_shard'])} applies, "
            f"{hits} dedup hits, {dups} dup frames, "
            f"{cs['restarts']} center restarts")


def _straggler_stability(fleet) -> Result:
    demotes: dict = {}
    readmits: dict = {}
    for rec in fleet.log.records:
        if rec["ev"] == "worker_demote":
            demotes[rec["worker"]] = demotes.get(rec["worker"], 0) + 1
        elif rec["ev"] == "worker_join" and \
                rec.get("reason") == "readmit":
            readmits[rec["worker"]] = readmits.get(rec["worker"], 0) + 1
    bad: List[str] = []
    # convergence = bounded transitions: a worker may be demoted once
    # for being persistently slow plus once per injected delay episode;
    # more is flapping.  (A late readmit is NOT flapping: once the fast
    # workers finish, a "straggler" is no longer slow relative to the
    # remaining fleet — relative ranking is the policy.)
    for wid, n in sorted(demotes.items()):
        allowance = 1 + fleet.workers[wid].delay_episodes
        if n > allowance:
            bad.append(f"worker {wid} demoted {n}x "
                       f"(allowance {allowance}): flapping")
    enough = fleet.summary.get("windows_scored", 0) >= \
        3 * fleet.straggle_windows
    if enough:
        for wid in fleet.stragglers:
            if fleet.workers[wid].status == "failed":
                continue               # died out of the ranking
            if demotes.get(wid, 0) < 1:
                bad.append(f"persistent straggler {wid} never demoted "
                           f"({fleet.summary['windows_scored']} windows)")
    return ("straggler_demotion_converges", not bad,
            "; ".join(bad[:4]) or f"{sum(demotes.values())} demotions / "
            f"{sum(readmits.values())} readmissions, no flapping")


def _shard_balance(fleet) -> Result:
    per = fleet.center.stats()["applied_per_shard"]
    spread = max(per) - min(per)
    # every death or skip strands at most one partial round's shard
    # asymmetry; center restarts can strand one in-flight round fleetwide
    allowance = fleet.deaths + fleet.skips + \
        fleet.center.restarts * fleet.n_workers // max(1, fleet.n_shards) \
        + 2
    ok = spread <= allowance
    return ("center_shard_load_balance", ok,
            f"per-shard applies {per}, spread {spread} "
            f"(allowance {allowance})")


def _lease_safety(fleet) -> Result:
    bad = fleet.lease_violations
    return ("lease_timeout_safe_region", not bad,
            "; ".join(bad[:4]) or "no false deaths, no late detections")


def _topology(fleet) -> Result:
    bad = fleet.mesh.table_violations
    return ("gossip_topology_regeneration", not bad,
            "; ".join(bad[:4]) or f"{fleet.mesh.regens} regenerations, "
            f"all embedded derangements valid")


def _completion(fleet) -> Result:
    ok = fleet.stopped_reason in (None,) and \
        len(fleet.finished) + len(fleet.failed) == fleet.n_workers
    return ("fleet_completed", ok,
            f"finished={len(fleet.finished)} failed={len(fleet.failed)} "
            f"of {fleet.n_workers}, stopped={fleet.stopped_reason}")


CHECKERS = (_completion, _no_resurrect, _alpha_conservation, _exactly_once,
            _straggler_stability, _shard_balance, _lease_safety, _topology)


def check_invariants(fleet) -> List[Result]:
    """Run every checker; the fleet must have finished ``run()``."""
    assert fleet.summary, "run() the fleet before checking invariants"
    return [c(fleet) for c in CHECKERS]
