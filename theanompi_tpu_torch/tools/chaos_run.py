"""Chaos-mode training run: inject faults, verify the elastic reactions.

Counterpart of ``scripts/chaos_run.py``, over the port's elastic runtime
(``parallel/membership.run_elastic``), its launcher and its chaos harness.
The islands run on the card; ``--host-devices 1`` runs them on the CPU.
The two-command recipe:

    # elastic EASGD: 3 islands, SIGKILL island 2 at t=20s — the run
    # absorbs the death (leave → backoff respawn → rejoin-from-center)
    python -m theanompi_tpu_torch.tools.chaos_run --rule easgd \\
        --workers 3 --steps 120 --faults kill@20:2 --record-dir /tmp/chaos

    # or replay a schedule rehearsed in virtual time
    python -m theanompi_tpu_torch.tools.simfleet_run --workers 4 \\
        --realized-out /tmp/sim/sim_realized.jsonl
    python -m theanompi_tpu_torch.tools.chaos_run --workers 4 --steps 40 \\
        --faults-from /tmp/sim/sim_realized.jsonl --record-dir /tmp/live

Modes:

* ``--rule easgd|asgd`` — elastic membership: island processes around a
  center server under ``parallel/membership.py``'s supervisor.  Faults
  hit island processes; the run completes WITHOUT a world restart.
* ``--rule bsp`` — supervised world restart: ``python -m
  theanompi_tpu_torch.launcher --supervise`` under chaos; a SIGKILLed
  worker resumes from its newest checkpoint (pass ``ckpt_dir=``).

Faults come from ``--faults`` (explicit ``kind@sec:worker[:dur]`` list),
``--faults-from`` (a realized schedule: ``chaos_realized.jsonl`` of a live
run or ``sim_realized.jsonl`` of a rehearsal, of this package or of the
JAX package: the dialect is one), or ``--seed``/``--n-faults``
(reproducible random draws over the non-zero workers).  After the run the
merged telemetry stream is audited: every applied kill fault must have a
matching ``worker_leave`` AND a ``worker_join`` rejoin, every center kill
its ``center_down``/``center_restored`` pair, duplicated frames their
dedup hits, and with ``--fleetmon`` every covered fault its alert.
``--verify-loss`` additionally evaluates the final center on the model's
validation set and gates on ``--loss-threshold``.

Exit codes: the run's own when it failed, 2 when a realized file leaves
nothing to replay, 4 when an audit fails, 5 when the loss gate fails.
"""

import argparse
import json
import os
import subprocess
import sys
import time

from ..simfleet.fidelity import load_events

#: the default model: the fault drill's tiny LRN net (``simfleet/drill.py``;
#: ``iter_sleep=`` slows its steps)
DEFAULT_MODEL = ("theanompi_tpu_torch.simfleet.drill", "DrillNet")


def eval_center_loss(modelfile, modelclass, config, center_npz,
                     host_devices=0):
    """Validation cost of the persisted final center params: builds the
    model in-process (on the card, or the CPU with ``host_devices`` 1),
    loads the center's leaves into its params the way a rejoining island
    does (``CenterLink.anchor``), runs the validation loop.  The
    convergence half of the chaos gate."""
    import importlib

    import numpy as np

    from ..parallel.async_easgd import CenterLink
    from ..parallel.exchanger import LocalExchanger
    from ..utils.recorder import Recorder

    cfg = dict(config)
    cfg.setdefault("verbose", False)
    if host_devices:
        cfg["device"] = "cpu"
    model = getattr(importlib.import_module(modelfile), modelclass)(cfg)
    model.compile_iter_fns(LocalExchanger(cfg))
    with np.load(center_npz) as z:
        leaves = [z[f"leaf{i}"] for i in range(len(z.files))]

    class _Saved:
        """The saved center, as the one call ``anchor`` makes of it."""
        alpha = 0.5

        @staticmethod
        def pull_leaves():
            return leaves

    CenterLink(model, _Saved(), 0).anchor(set_params=True)
    rec = Recorder({"verbose": False})
    model.begin_val()
    for _ in range(model.data.n_batch_val):
        model.val_iter(0, rec)
    model.end_val()
    return rec.print_val_info(0)["val_cost"]


def audit_membership(record_dir, kill_targets):
    """Match telemetry membership transitions against the injected kills:
    every killed worker needs a crash/wedge ``worker_leave`` and a respawn
    ``worker_join``.  Returns (ok, transitions)."""
    events = load_events(record_dir)
    trans = [e for e in events
             if e["ev"] in ("worker_join", "worker_leave", "worker_demote",
                            "center_down", "center_restored",
                            "fault_injected")]
    ok = True
    for w in sorted(set(kill_targets)):
        leaves = [e for e in trans if e["ev"] == "worker_leave"
                  and e.get("worker") == w
                  and e.get("reason") in ("crashed", "wedged",
                                          "lease_expired")]
        joins = [e for e in trans if e["ev"] == "worker_join"
                 and e.get("worker") == w and e.get("rejoin")]
        if not leaves:
            print(f"AUDIT FAIL: no crash worker_leave for killed worker {w}")
            ok = False
        if not joins:
            print(f"AUDIT FAIL: no rejoin worker_join for killed worker {w}")
            ok = False
    return ok, trans


def audit_center(record_dir, n_center_kills, require_dedup):
    """Every center SIGKILL must have its ``center_down`` →
    ``center_restored`` pair (and the run must END restored, not down);
    when duplicate frames were injected, the center's dedup window must
    have actually deduplicated (counter > 0) and its applied-once
    bookkeeping must balance.  Returns (ok, stats)."""
    events = load_events(record_dir)
    downs = [e for e in events if e["ev"] == "center_down"]
    restores = [e for e in events if e["ev"] == "center_restored"]
    ok = True
    if n_center_kills:
        if len(downs) < n_center_kills:
            print(f"AUDIT FAIL: {n_center_kills} center kills but only "
                  f"{len(downs)} center_down events")
            ok = False
        if len(restores) < n_center_kills:
            print(f"AUDIT FAIL: {n_center_kills} center kills but only "
                  f"{len(restores)} center_restored events")
            ok = False
        if downs and (not restores
                      or restores[-1]["ts"] < downs[-1]["ts"]):
            print("AUDIT FAIL: the run ended center_down (no "
                  "center_restored after the last outage)")
            ok = False
    stats = None
    stats_path = os.path.join(record_dir, "center_stats.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f)
    if stats is not None:
        applied = sum(int(v) for v in stats.get("by_island", {}).values())
        if applied != int(stats.get("n_updates", -1)):
            print(f"AUDIT FAIL: applied-once bookkeeping off — n_updates="
                  f"{stats.get('n_updates')} != Σ by_island = {applied}")
            ok = False
    if require_dedup:
        hits = (stats or {}).get("dedup_hits", 0)
        faulted = (stats or {}).get("net_frames_faulted")
        if not stats:
            print("AUDIT FAIL: duplicate frames injected but no "
                  "center_stats.json to prove deduplication")
            ok = False
        elif faulted is not None and faulted.get("net_dup", 0) == 0:
            # the window opened but no frame crossed it (islands still
            # booting, schedule mistimed) — nothing to dedup, not a bug
            print("warning: net_dup window(s) opened but no frame passed "
                  "through them — dedup gate vacuous this run")
        elif hits <= 0:
            print("AUDIT FAIL: duplicate frames injected but the center's "
                  "dedup window recorded 0 hits — duplicates were "
                  "re-applied or never arrived")
            ok = False
        else:
            print(f"dedup audit: {hits} duplicate(s) deduplicated, "
                  f"applied-once bookkeeping balanced")
    return ok, stats


def audit_fleetmon(record_dir, heartbeat_s, eval_window_s):
    """Every landed fault whose symptom a rule covers must have raised its
    alert within one evaluation window (``fleetmon.audit_alerts``), read
    from the run's realized schedule and the alert events the collector
    streamed into its telemetry.  Returns (ok, lines, n_alerts)."""
    from ..utils import chaos, fleetmon
    alert_events = [e for e in load_events(record_dir)
                    if e["ev"] == fleetmon.ALERT_EVENT]
    realized = []
    realized_path = os.path.join(record_dir, chaos.REALIZED_SCHEDULE)
    if os.path.exists(realized_path):
        with open(realized_path) as f:
            for line in f:
                try:
                    realized.append(json.loads(line))
                except ValueError:
                    continue
    rules = fleetmon.default_rules(heartbeat_s=float(heartbeat_s))
    ok, lines = fleetmon.audit_alerts(alert_events, realized, rules,
                                      eval_window_s=float(eval_window_s))
    return ok, lines, len(alert_events)


def run_bsp_chaos(args, kv):
    """``launcher --supervise`` under chaos: SIGKILL the worker process
    mid-epoch, assert the supervisor resumes it to completion."""
    from ..launcher import WORKER_MODULE
    from ..utils import chaos

    kv = list(kv)
    if args.host_devices and not any(c.startswith("device=") for c in kv):
        kv.append("device=cpu")
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.launcher",
           "--supervise", str(args.max_restarts), "--rule", "bsp",
           "--modelfile", args.modelfile, "--modelclass", args.modelclass,
           "--backoff", "0.2"] + kv
    sup = subprocess.Popen(cmd)
    schedule = chaos.parse_schedule(args.faults) if args.faults else \
        chaos.seeded_schedule(args.seed, [0], n_faults=args.n_faults,
                              t_min=args.t_min, t_max=args.t_max)

    def pid_of(_target):
        return chaos.find_child_pid(sup.pid, WORKER_MODULE, timeout_s=0.2)

    monkey = chaos.ChaosMonkey(schedule, pid_of=pid_of)
    monkey.start()
    rc = sup.wait()
    monkey.stop()
    applied = [f for f in monkey.applied if f.error is None]
    print(f"bsp chaos: rc={rc}, faults applied: {applied}")
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rule", default="easgd",
                    choices=["easgd", "asgd", "bsp"])
    ap.add_argument("--modelfile", default=DEFAULT_MODEL[0])
    ap.add_argument("--modelclass", default=DEFAULT_MODEL[1])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=120,
                    help="local steps per elastic island before clean exit")
    ap.add_argument("--faults", default=None,
                    help="explicit schedule: kind@sec:worker[:dur],... "
                         "(worker 0 = the center — implies --center-proc)")
    ap.add_argument("--faults-from", default=None,
                    help="replay a REALIZED schedule file "
                         "(chaos_realized.jsonl from a previous live run, "
                         "or sim_realized.jsonl from python -m "
                         "theanompi_tpu_torch.tools.simfleet_run) — "
                         "process faults go to the monkey, net_* windows "
                         "to the proxy")
    ap.add_argument("--seed", type=int, default=7,
                    help="seeded random faults when --faults is not given")
    ap.add_argument("--n-faults", type=int, default=1)
    ap.add_argument("--t-min", type=float, default=10.0)
    ap.add_argument("--t-max", type=float, default=30.0)
    ap.add_argument("--center-proc", action="store_true",
                    help="run the center as its own supervised process "
                         "(snapshots + respawn; auto-on when a fault "
                         "targets worker 0)")
    ap.add_argument("--net-faults", default=None,
                    help="wire-level schedule through the ChaosProxy: "
                         "net_dup@5:-1:6,net_partition@12:-1:3,... "
                         "(target -1 = every client)")
    ap.add_argument("--net-seed", type=int, default=None,
                    help="seeded net-fault windows when --net-faults is "
                         "not given")
    ap.add_argument("--net-n-faults", type=int, default=3)
    ap.add_argument("--net-duration", type=float, default=3.0)
    ap.add_argument("--fleetmon", action="store_true",
                    help="run the fleet-health collector (utils/fleetmon)"
                         " for this run and close with the alert-audit: "
                         "every landed fault whose symptom a rule covers "
                         "must raise its alert within one evaluation "
                         "window")
    ap.add_argument("--record-dir", required=True)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="0 runs the islands (or the BSP world) on the "
                         "card, 1 on the CPU")
    ap.add_argument("--sync-freq", type=int, default=2)
    ap.add_argument("--max-restarts", type=int, default=4)
    ap.add_argument("--lease-timeout", type=float, default=20.0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--verify-loss", action="store_true",
                    help="evaluate the final center on the val set")
    ap.add_argument("--loss-threshold", type=float, default=None,
                    help="chaos gate: final center val cost must be below")
    ap.add_argument("config", nargs="*", help="key=value model config")
    args = ap.parse_args(argv)

    os.makedirs(args.record_dir, exist_ok=True)
    if args.rule == "bsp":
        return run_bsp_chaos(args, args.config)

    from ..parallel.membership import parse_kv, run_elastic
    from ..utils import chaos

    replayed = chaos.schedule_from_realized(args.faults_from) \
        if args.faults_from else None
    if replayed is not None:
        # a realized file from a WIDER fleet (a 1,000-worker rehearsal)
        # targets islands this replay doesn't have — dropping them
        # silently would report a fault-free run as a faithful replay
        wide = [f for f in replayed
                if f.target > args.workers]
        if wide:
            print(f"warning: dropping {len(wide)}/{len(replayed)} "
                  f"realized fault(s) targeting workers beyond "
                  f"--workers {args.workers} (e.g. {wide[0]!r}) — "
                  f"export the replay schedule from a sim run at the "
                  f"live width (python -m theanompi_tpu_torch.tools."
                  f"simfleet_run --workers {args.workers}), or use "
                  f"--fidelity")
            replayed = [f for f in replayed if f.target <= args.workers]
        if not replayed:
            print("error: nothing left to replay from "
                  f"{args.faults_from}")
            return 2
        # one realized file carries both planes; split by kind
        schedule = [f for f in replayed
                    if f.kind not in chaos.NET_FAULT_KINDS]
    elif args.faults:
        schedule = chaos.parse_schedule(args.faults)
    else:
        schedule = chaos.seeded_schedule(
            args.seed, list(range(1, args.workers + 1)),
            n_faults=args.n_faults, t_min=args.t_min, t_max=args.t_max)
    net_schedule = None
    if replayed is not None:
        net_schedule = [f for f in replayed
                        if f.kind in chaos.NET_FAULT_KINDS] or None
    elif args.net_faults:
        net_schedule = chaos.parse_schedule(args.net_faults)
    elif args.net_seed is not None:
        net_schedule = chaos.seeded_schedule(
            args.net_seed, [-1], n_faults=args.net_n_faults,
            t_min=args.t_min, t_max=args.t_max,
            kinds=chaos.NET_FAULT_KINDS, duration=args.net_duration)
    center_proc = args.center_proc or \
        any(f.target == 0 for f in schedule)
    print(f"chaos schedule: {schedule}"
          + (f"\nnet schedule:   {net_schedule}" if net_schedule else "")
          + (f"\ncenter: supervised subprocess (snapshots + respawn)"
             if center_proc else ""))
    config = parse_kv(args.config)
    config.setdefault("sync_freq", args.sync_freq)
    if args.fleetmon:
        config["fleetmon"] = True
        # the wedge rule must out-wait healthy silence but fire inside a
        # stop fault — half the lease timeout mirrors the live default
        config.setdefault("fleetmon_heartbeat_s", args.lease_timeout / 2.0)
    t0 = time.time()
    rc = run_elastic(
        args.rule, args.modelfile, args.modelclass, config, args.workers,
        record_dir=args.record_dir, steps=args.steps,
        host_devices=args.host_devices, chaos_schedule=schedule,
        net_chaos_schedule=net_schedule, center_proc=center_proc,
        timeout_s=args.timeout,
        supervisor_kw={"max_restarts": args.max_restarts,
                       "lease_timeout": args.lease_timeout})
    print(f"elastic run rc={rc} in {time.time() - t0:.1f}s")
    if rc != 0:
        return rc

    landed = [f for f in schedule
              if f.kind == "kill" and f.applied and f.error is None]
    kills = [f.target for f in landed if f.target != 0]
    center_kills = [f for f in landed if f.target == 0]
    if not landed:
        print("warning: no kill fault landed on a live island — nothing "
              "to audit (islands finished before the schedule fired?)")
    ok, trans = audit_membership(args.record_dir, kills)
    for e in trans:
        print(f"  {e['ev']} worker={e.get('worker')} "
              f"reason={e.get('reason') or e.get('kind')}")
    dup_injected = bool(net_schedule) and \
        any(f.kind == "net_dup" and f.applied for f in net_schedule)
    center_ok, _stats = audit_center(args.record_dir, len(center_kills),
                                     require_dedup=dup_injected)
    ok = ok and center_ok
    if args.fleetmon:
        alert_ok, lines, n_alerts = audit_fleetmon(
            args.record_dir, config["fleetmon_heartbeat_s"],
            config.get("fleetmon_eval_s", 2.0))
        for line in lines:
            print(line)
        if not alert_ok:
            print("ALERT AUDIT FAIL: a covered fault raised no alert "
                  "within its window")
            ok = False
        else:
            print(f"alert audit: PASS ({n_alerts} alert(s) fired)")
    if not ok:
        return 4
    if args.verify_loss or args.loss_threshold is not None:
        center = os.path.join(args.record_dir, "center_final.npz")
        loss = eval_center_loss(args.modelfile, args.modelclass,
                                config, center, args.host_devices)
        print(f"final center val cost: {loss:.4f}")
        with open(os.path.join(args.record_dir, "chaos_gate.json"),
                  "w") as f:
            json.dump({"val_cost": loss, "kills": kills,
                       "threshold": args.loss_threshold}, f)
        if args.loss_threshold is not None and \
                not loss < args.loss_threshold:
            print(f"CHAOS GATE FAIL: {loss:.4f} >= {args.loss_threshold}")
            return 5
    print("chaos gate: PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
