"""Rehearse a production-width fault schedule in virtual time.

Counterpart of ``scripts/simfleet_run.py``, over the port's ``simfleet``
and so over the port's membership, wire, chaos and fleetmon code.  The
two-command recipe:

    # 1,000 workers, 10,000 local steps each, seeded kills + wedges +
    # stragglers + net windows (drop/dup/partition/...), invariants
    # checked, byte-identical event log per seed — seconds of CPU
    python -m theanompi_tpu_torch.tools.simfleet_run --workers 1000 \\
        --steps 10000 --seed 7 --n-faults 20 --net-n-faults 8 \\
        --stragglers 20 --realized-out /tmp/sim/sim_realized.jsonl

    # replay the realized schedule through the LIVE harness (real
    # island processes on the card, real ChaosMonkey/ChaosProxy) at
    # small scale; export it from a run at the live width (--workers 4)
    python -m theanompi_tpu_torch.tools.chaos_run --workers 4 --steps 40 \\
        --faults-from /tmp/sim/sim_realized.jsonl --record-dir /tmp/live

Modes:

* default — one simulated run: summary, invariant verdicts, log hash.
  rc 0 only if every invariant holds (3 if one fails).
* ``--gate`` — the determinism gate: same seed twice must hash
  byte-identical (and differ for seed+1), then a 512-worker invariant
  suite must pass inside ``--budget`` CPU-seconds.
* ``--fidelity DIR`` — the cross-check: simulate a 4-worker schedule,
  export its realized faults, replay through the live elastic runtime,
  and require the same membership-event sequence.  The islands run on
  the card; ``--host-devices 1`` runs them on the CPU.
"""

import argparse
import os
import time

from ..simfleet import FleetSim, check_invariants
from ..utils import chaos


def build_fleet(args, seed=None, workers=None) -> FleetSim:
    sched = chaos.parse_schedule(args.faults) if args.faults else None
    net = chaos.parse_schedule(args.net_faults) if args.net_faults else None
    return FleetSim(
        n_workers=workers if workers is not None else args.workers,
        steps=args.steps, sync_freq=args.sync_freq,
        seed=seed if seed is not None else args.seed,
        n_shards=args.shards, schedule=sched, net_schedule=net,
        n_faults=args.n_faults, net_n_faults=args.net_n_faults,
        n_stragglers=args.stragglers,
        fault_t_min=args.t_min, fault_t_max=args.t_max,
        fleetmon=args.fleetmon)


def report(fleet, cpu_s) -> bool:
    s = fleet.summary
    print(f"simfleet: {s['n_workers']} workers, seed {s['seed']} — "
          f"{s['virtual_secs']}s virtual in {cpu_s:.1f}s CPU "
          f"({s['events']} events)")
    print(f"  finished={s['finished']} failed={s['failed']} "
          f"deaths={s['deaths']} transitions={s['transitions']} "
          f"mesh_regens={s['mesh_regens']}")
    print(f"  center: applies/shard={s['center']['applied_per_shard']} "
          f"dedup_hits={sum(s['center']['dedup_hits_per_shard'])} "
          f"restarts={s['center']['restarts']}")
    print(f"  frames faulted: {s['frames_faulted'] or 'none'}")
    if s.get("fleetmon"):
        fm = s["fleetmon"]
        by = ", ".join(f"{k}×{v}" for k, v in fm["by_rule"].items()) \
            or "none"
        print(f"  fleetmon: {fm['alerts']} alert(s) over "
              f"{fm['evaluations']} evaluation(s) — {by}")
    ok_all = True
    for name, ok, detail in check_invariants(fleet):
        ok_all &= ok
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    print(f"  event-log sha256: {fleet.log.sha256()}")
    return ok_all


def run_gate(args) -> int:
    """Determinism + a 512-worker invariant suite on a budget."""
    t0 = time.process_time()
    pair = []
    for _ in range(2):
        f = FleetSim(n_workers=128, steps=1200, sync_freq=8,
                     seed=args.seed, n_faults=5, net_n_faults=4,
                     n_stragglers=4)
        f.run()
        pair.append(f.log.sha256())
    if pair[0] != pair[1]:
        print(f"GATE FAIL: same seed, different event logs "
              f"({pair[0][:16]} != {pair[1][:16]})")
        return 1
    f3 = FleetSim(n_workers=128, steps=1200, sync_freq=8,
                  seed=args.seed + 1, n_faults=5, net_n_faults=4,
                  n_stragglers=4)
    f3.run()
    if f3.log.sha256() == pair[0]:
        print("GATE FAIL: different seeds produced identical logs "
              "(the schedule is not actually seeded)")
        return 1
    print(f"determinism: same seed ⇒ identical log ({pair[0][:16]}…), "
          f"seed+1 differs")
    fleet = FleetSim(n_workers=512, steps=2000, sync_freq=16,
                     seed=args.seed, n_faults=10, net_n_faults=6,
                     n_stragglers=10, fault_t_min=8.0, fault_t_max=60.0)
    fleet.run()
    ok = report(fleet, time.process_time() - t0)
    cpu = time.process_time() - t0
    if cpu > args.budget:
        print(f"GATE FAIL: {cpu:.1f}s CPU exceeds the "
              f"{args.budget:.0f}s budget")
        return 1
    print(f"simfleet gate: {'PASS' if ok else 'FAIL'} "
          f"({cpu:.1f}s CPU of {args.budget:.0f}s budget)")
    return 0 if ok else 1


def run_fidelity(args) -> int:
    from ..simfleet.fidelity import crosscheck
    out = crosscheck(args.fidelity, n_workers=4,
                     schedule=args.faults or "kill@6:1",
                     steps=args.steps if args.steps <= 200 else 40,
                     seed=args.seed, host_devices=args.host_devices)
    print(f"sim membership sequences:  {out['sim']}")
    print(f"live membership sequences: {out['live']}")
    print(f"live rc={out['live_rc']}  realized={out['realized_path']}")
    print(f"fidelity cross-check: {'PASS' if out['ok'] else 'FAIL'}")
    return 0 if out["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=10000,
                    help="local steps per worker (rounds)")
    ap.add_argument("--sync-freq", type=int, default=25,
                    help="local steps per exchange round")
    # seed 2's seeded draws cover every fault kind at the default counts
    # (kills, wedges, delays, and all five net window kinds incl.
    # partitions) — the acceptance run exercises the whole taxonomy
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2,
                    help="center shards (the load-balance probe)")
    ap.add_argument("--faults", default=None,
                    help="explicit process schedule "
                         "(chaos grammar: kill@20:3,stop@30:5:20,...)")
    ap.add_argument("--net-faults", default=None,
                    help="explicit wire schedule "
                         "(net_dup@8:-1:6,net_partition@45:-1:3,...)")
    ap.add_argument("--n-faults", type=int, default=20,
                    help="seeded process faults when --faults absent")
    ap.add_argument("--net-n-faults", type=int, default=8,
                    help="seeded net windows when --net-faults absent")
    ap.add_argument("--stragglers", type=int, default=20,
                    help="persistent stragglers (4x step time)")
    ap.add_argument("--fleetmon", action="store_true",
                    help="rehearse the health plane: the REAL "
                         "FleetCollector + SLO rule engine on the "
                         "virtual clock; alerts join the event log")
    ap.add_argument("--t-min", type=float, default=10.0)
    ap.add_argument("--t-max", type=float, default=150.0)
    ap.add_argument("--log-out", default=None,
                    help="write the canonical event log (jsonl)")
    ap.add_argument("--realized-out", default=None,
                    help="write the realized fault schedule (replayable "
                         "via python -m theanompi_tpu_torch.tools."
                         "chaos_run --faults-from)")
    ap.add_argument("--gate", action="store_true",
                    help="determinism + 512-worker invariant gate")
    ap.add_argument("--budget", type=float, default=120.0,
                    help="--gate CPU-seconds budget")
    ap.add_argument("--fidelity", default=None, metavar="DIR",
                    help="run the live fidelity cross-check into DIR")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="--fidelity: 0 runs the islands on the card, 1 "
                         "on the CPU")
    args = ap.parse_args(argv)

    if args.gate:
        return run_gate(args)
    if args.fidelity:
        return run_fidelity(args)

    t0 = time.process_time()
    fleet = build_fleet(args)
    fleet.run()
    ok = report(fleet, time.process_time() - t0)
    if args.log_out:
        fleet.log.write(args.log_out)
        print(f"event log -> {args.log_out}")
    if args.realized_out:
        from ..simfleet.fidelity import export_realized
        os.makedirs(os.path.dirname(args.realized_out) or ".",
                    exist_ok=True)
        export_realized(fleet.realized, args.realized_out)
        print(f"realized schedule -> {args.realized_out}")
        if args.workers <= 8:
            print(f"replay live:  python -m theanompi_tpu_torch.tools."
                  f"chaos_run --workers {args.workers} --steps 40 "
                  f"--faults-from {args.realized_out} "
                  f"--record-dir <dir>")
        else:
            # a live replay only makes sense at live width — faults
            # targeting workers a 4-process run doesn't have would drop
            print("to replay live, export from a sim at the live width "
                  f"(--workers 4), or run the automated cross-check: "
                  f"python -m theanompi_tpu_torch.tools.simfleet_run "
                  f"--fidelity <dir>")
    return 0 if ok else 3


if __name__ == "__main__":
    raise SystemExit(main())
