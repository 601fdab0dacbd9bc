"""Fidelity cross-check: the simulator's word, verified against reality.

Counterpart of ``theanompi_tpu/simfleet/fidelity.py``; the live half runs
the port's elastic runtime (``parallel/membership.run_elastic``), on the
card unless ``host_devices=1`` asks for the CPU.

A simulator that only agrees with itself proves nothing.  This module
closes the loop at small scale: run a schedule through :class:`FleetSim`,
export the *realized* schedule (the same jsonl dialect the live
harness's ``chaos_realized.jsonl`` speaks), replay it through the REAL
elastic runtime — actual island processes, the actual
ChaosMonkey/ChaosProxy — and assert both worlds produced the same
*membership-event sequence* per worker, modulo timing:

    join ( death rejoin )* finish        for a worker the schedule kills
    join finish                          for one it leaves alone

Event kinds and reasons are normalized (``crashed``/``wedged``/
``lease_expired`` are all a *death*; ``respawn``/``lease`` rejoins are
one *rejoin*) because WHICH detector fires first is timing, while THAT
a kill produces exactly one death and one supervised rejoin is the
contract under test.

This is deliberately cheap (4 workers, one schedule) and sits next to
the width rehearsal: simfleet argues at 1,000 workers, fidelity argues
the simulator tells the truth at 4.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import chaos
from ..utils.chaos import NET_FAULT_KINDS, schedule_from_realized
from .fleet import FleetSim

#: normalization: event kind + reason -> sequence token
_DEATH_REASONS = ("crashed", "wedged", "lease_expired")

#: the live half's default model (``simfleet/drill.py``), slowed to a
#: quarter second a step so the replayed faults land mid-run
LIVE_MODEL = ("theanompi_tpu_torch.simfleet.drill", "DrillNet")
LIVE_CONFIG = {"sync_freq": 2, "batch_size": 8, "iter_sleep": 0.25}


def export_realized(realized: Sequence[dict], path: str, *,
                    min_at: float = 0.0, scale: float = 1.0) -> str:
    """Write a FleetSim's realized fault list in the live harness's
    ``chaos_realized.jsonl`` dialect.  ``scale``/``min_at`` let a replay
    re-time the schedule (live islands spend seconds importing torch and
    building the model before a fault can land; virtual workers are live
    at t=0⁺)."""
    with open(path, "w") as f:
        for doc in realized:
            out = dict(doc)
            out["rel"] = round(max(float(doc["rel"]) * scale, min_at), 3)
            f.write(json.dumps(out, sort_keys=True) + "\n")
    return path


def normalize_sequence(events: Sequence[dict]) -> Dict[int, List[str]]:
    """Per-worker token sequences from membership events (each event a
    dict with ``ev``/``worker``/``reason``/``rejoin`` fields — both the
    sim log and the live telemetry stream satisfy this)."""
    seqs: Dict[int, List[str]] = {}
    for e in events:
        ev, w = e.get("ev"), e.get("worker")
        if w is None or int(w) < 0:
            continue
        w = int(w)
        if ev == "worker_join":
            tok = "rejoin" if e.get("rejoin") else "join"
        elif ev == "worker_leave":
            tok = "finish" if e.get("reason") == "finished" else (
                "death" if e.get("reason") in _DEATH_REASONS else None)
        elif ev == "worker_demote":
            tok = "demote"
        else:
            continue
        if tok is None:
            continue
        seq = seqs.setdefault(w, [])
        # collapse repeats: a wedge can be seen by BOTH the lease expiry
        # and the process exit — one death, two observations
        if not (seq and seq[-1] == tok and tok in ("death", "rejoin")):
            seq.append(tok)
    return seqs


def load_events(record_dir: str) -> List[dict]:
    """Every telemetry event of a live run, each process's
    ``telemetry_rank*.jsonl`` stream merged and sorted by timestamp (a
    line a crash truncated is skipped)."""
    events = []
    for p in sorted(glob.glob(os.path.join(record_dir,
                                           "telemetry_rank*.jsonl"))):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if isinstance(e, dict) and "ev" in e:
                    events.append(e)
    events.sort(key=lambda e: e.get("ts", 0))
    return events


def sim_membership_sequence(fleet: FleetSim) -> Dict[int, List[str]]:
    return normalize_sequence(fleet.log.select(
        "worker_join", "worker_leave", "worker_demote"))


def live_membership_sequence(record_dir: str) -> Dict[int, List[str]]:
    return normalize_sequence([
        e for e in load_events(record_dir)
        if e["ev"] in ("worker_join", "worker_leave", "worker_demote")])


def simulate(record_dir: str, *, n_workers: int = 4,
             schedule="kill@6:1", steps: int = 40, seed: int = 0,
             sync_freq: int = 2, fleetmon: bool = False,
             min_at: float = 6.0) -> Tuple[FleetSim, str]:
    """The cross-check's simulated half: ``schedule`` (the chaos grammar,
    or a list of faults) at the live width, one center shard, no gossip
    mesh, virtual step time sized so the schedule lands mid-run; the
    realized schedule exported to ``<record_dir>/sim_realized.jsonl``,
    no fault earlier than ``min_at``.  Returns the finished fleet and the
    exported file."""
    os.makedirs(record_dir, exist_ok=True)
    sched = chaos.parse_schedule(schedule) if isinstance(schedule, str) \
        else list(schedule)
    max_at = max((f.at + f.duration for f in sched), default=0.0)
    # virtual step time sized so the schedule lands MID-run, as it will
    # live (live islands run ~0.2–1 s/step after a multi-second boot)
    step_time = max(0.02, 2.5 * max_at / max(1, steps))
    fleet = FleetSim(n_workers=n_workers, steps=steps, sync_freq=sync_freq,
                     seed=seed, schedule=sched, n_shards=1,
                     step_time_s=step_time, lease_timeout=60.0,
                     gossip=False, fleetmon=fleetmon)
    fleet.run()
    realized_path = os.path.join(record_dir, "sim_realized.jsonl")
    # the live monkey's clock is progress-gated (membership.run_elastic
    # starts it once every island leases step >= 1), so rel times here
    # are measured from real training progress, not from spawn — min_at
    # only needs to keep the fault clear of the very first steps
    export_realized(fleet.realized, realized_path, min_at=min_at)
    return fleet, realized_path


def crosscheck(record_dir: str, *, n_workers: int = 4,
               schedule: str = "kill@6:1", steps: int = 40,
               seed: int = 0, modelfile: str = LIVE_MODEL[0],
               modelclass: str = LIVE_MODEL[1],
               config: Optional[dict] = None, host_devices: int = 0,
               live_timeout_s: float = 420.0, run_live: bool = True) -> dict:
    """The acceptance cross-check: simulate ``schedule`` at
    ``n_workers``, export the realized schedule, replay it through the
    live elastic runtime (ChaosMonkey + ChaosProxy when net windows are
    present) with ``modelfile.modelclass`` under ``config`` as each
    island's model, on the card (``host_devices`` 0) or the CPU (1), and
    compare membership sequences.

    Returns ``{"ok", "sim", "live", "realized_path", "live_rc"}``;
    ``run_live=False`` stops after the sim+export (for callers that
    split the phases)."""
    from ..parallel.membership import Backoff, run_elastic

    fleet, realized_path = simulate(
        record_dir, n_workers=n_workers, schedule=schedule, steps=steps,
        seed=seed, sync_freq=int((config or LIVE_CONFIG).get(
            "sync_freq", 2)))
    sim_seq = sim_membership_sequence(fleet)
    out = {"sim": sim_seq, "realized_path": realized_path,
           "live": None, "live_rc": None, "ok": None}
    if not run_live:
        return out

    live_sched = schedule_from_realized(realized_path)
    live_dir = os.path.join(record_dir, "live")
    proc_sched = [f for f in live_sched
                  if f.kind not in NET_FAULT_KINDS]
    # the sleepy model stretches the live run past the schedule's last
    # fault: with the progress-gated monkey a bare tiny model burns all
    # `steps` in well under the re-timed fault offsets, and the kill
    # would land on a finished fleet (no death, sequence mismatch)
    rc = run_elastic(
        "easgd", modelfile, modelclass,
        dict(LIVE_CONFIG if config is None else config), n_workers,
        record_dir=live_dir, steps=steps, host_devices=host_devices,
        chaos_schedule=proc_sched,
        net_chaos_schedule=[f for f in live_sched
                            if f.kind in NET_FAULT_KINDS] or None,
        # target 0 = the center: it must exist as its own supervised
        # process for the monkey to kill it (chaos_run derives this the
        # same way)
        center_proc=any(f.target == 0 for f in proc_sched),
        timeout_s=live_timeout_s,
        supervisor_kw={"poll_s": 0.2, "backoff": Backoff(base=0.3),
                       "lease_timeout": 60.0})
    live_seq = live_membership_sequence(live_dir)
    out["live"] = live_seq
    out["live_rc"] = rc
    out["ok"] = rc == 0 and live_seq == sim_seq
    return out
