"""fleetz — one table for every live process in a run directory.

Each long-lived process of an elastic run (worker CLIs, the center
server, the supervisor) serves a tiny ``statusz`` socket
(``theanompi_tpu_torch/utils/tracing.py``) and registers it under
``<record_dir>/statusz/``.  This tool dials every registered endpoint
and prints the fleet's live state — role, pid, uptime, current
iteration, current span, spans emitted, last event — marking
unreachable endpoints DOWN (a crashed process leaves its discovery file
behind; a cleanly-exited one removes it).

Usage:
    python -m theanompi_tpu_torch.tools.fleetz <record_dir> [--json]
        [--events N] [--watch] [--interval S] [--iterations N]

``--events N`` additionally tails the last N flight-ring events of every
reachable process (the cross-process "what is everyone doing right now"
that used to need N terminals).

``--watch`` re-probes and re-prints every ``--interval`` seconds — the
live control-room view.  When the run serves a fleet-health collector
(``utils/fleetmon``, registered in the same roster under role
``fleetmon``), each frame also shows its recent alerts and fleet rank
count.  ``--iterations N`` bounds the loop (N=1 is the single-shot test
mode; 0 = forever); the exit code reflects the LAST frame's roster (any
DOWN row → 2, same as the one-shot contract).

The port's counterpart of the JAX package's ``fleetz``, the same flags,
rows and exit codes; it loads the port's stdlib planes only (no torch).
"""

import argparse
import json
import os
import sys

from ..utils import tracing


def probe(doc, timeout_s=2.0):
    """One roster entry → its live health reply (or a DOWN row)."""
    addr = f"{doc.get('host', '127.0.0.1')}:{doc.get('port')}"
    try:
        rep = tracing.statusz_query(addr, "health", timeout_s=timeout_s)
    except Exception as e:
        return {"ok": False, "role": doc.get("role"), "id": doc.get("id"),
                "pid": doc.get("pid"), "addr": addr, "down": True,
                "error": repr(e)[:80]}
    rep.setdefault("role", doc.get("role"))
    rep.setdefault("id", doc.get("id"))
    rep["addr"] = addr
    return rep


def fleet_table(record_dir, timeout_s=2.0):
    return [probe(doc, timeout_s)
            for doc in tracing.read_statusz_docs(record_dir)]


def print_table(rows):
    cols = ("role", "id", "pid", "state", "uptime", "iter", "spans",
            "current span", "last event")
    table = []
    for r in rows:
        cur = r.get("current_span") or {}
        last = r.get("last_event") or {}
        table.append((
            str(r.get("role", "?")), str(r.get("id", "?")),
            str(r.get("pid", "?")),
            "DOWN" if r.get("down") else "up",
            f"{r.get('uptime_s', 0):.0f}s" if not r.get("down") else "-",
            str(r.get("iter", r.get("steps", "-"))),
            str(r.get("spans", "-")),
            cur.get("name", "-") if cur else "-",
            last.get("ev", "-") if last else "-"))
    widths = [max(len(c), *(len(row[i]) for row in table)) if table
              else len(c) for i, c in enumerate(cols)]
    print("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
    for row in table:
        print("  ".join(v.ljust(w) for v, w in zip(row, widths)))


def print_alerts(rows, timeout_s=2.0, n=5):
    """When a fleet-health collector is in the roster, show its recent
    alerts + fleet size — the control-room summary line."""
    for r in rows:
        if r.get("role") != "fleetmon" or r.get("down"):
            continue
        try:
            rep = tracing.statusz_query(r["addr"], "alerts", n=n,
                                        timeout_s=timeout_s)
        except Exception:
            continue
        alerts = rep.get("alerts", [])
        print(f"\nfleetmon: {len(r.get('ranks', []))} rank(s) streaming, "
              f"{r.get('alerts', 0)} alert(s) total, "
              f"{r.get('evaluations', 0)} evaluation(s)")
        for a in alerts[-n:]:
            who = "fleet" if a.get("rank") is None else f"w{a['rank']}"
            print(f"  ALERT {a.get('rule')} [{who}] "
                  f"{a.get('series')}={a.get('value')} "
                  f"(threshold {a.get('threshold')}) ts={a.get('ts')}")


def frame(record_dir, timeout_s=2.0):
    """One probe of the roster: ``(exit code, rows)`` as one frame reports
    them — 1 and no rows when nothing is registered, 2 when any row is
    DOWN (a dead process left its discovery file behind; clean exits
    deregister), else 0."""
    docs = tracing.read_statusz_docs(record_dir)
    if not docs:
        return 1, []
    rows = [probe(doc, timeout_s) for doc in docs]
    return (0 if all(not r.get("down") for r in rows) else 2), rows


def one_frame(args):
    """One probe → print pass; returns the exit code for this frame."""
    rc, rows = frame(args.record_dir, args.timeout)
    if rc == 1:
        print(f"no statusz endpoints registered under "
              f"{tracing.statusz_dir(args.record_dir)} — is a run with "
              f"record_dir set (and statusz not disabled) live?",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"fleet": rows}, default=str))
    else:
        print_table(rows)
        print_alerts(rows, args.timeout)
    if args.events:
        for r in rows:
            if r.get("down"):
                continue
            try:
                rep = tracing.statusz_query(r["addr"], "events",
                                            n=args.events,
                                            timeout_s=args.timeout)
            except Exception:
                continue
            print(f"\n{r.get('role')} {r.get('id')} — last "
                  f"{args.events} events:")
            for ev in rep.get("events", []):
                detail = {k: v for k, v in ev.items()
                          if k not in ("ts", "run", "rank", "ev")}
                print(f"  ts={ev.get('ts')} {ev.get('ev')} {detail}")
    return rc


def main(argv=None):
    import time
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("record_dir")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON doc)")
    ap.add_argument("--events", type=int, default=0, metavar="N",
                    help="also tail each live process's last N "
                         "flight-ring events")
    ap.add_argument("--watch", action="store_true",
                    help="re-probe every --interval seconds (live view)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch refresh period (default 2s)")
    ap.add_argument("--iterations", type=int, default=0, metavar="N",
                    help="--watch frame budget (0 = forever; 1 = the "
                         "single-shot test mode)")
    ap.add_argument("--timeout", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not args.watch:
        return one_frame(args)
    frame = 0
    rc = 1
    while True:
        frame += 1
        print(f"--- fleetz watch frame {frame} "
              f"({time.strftime('%H:%M:%S')}) ---")
        rc = one_frame(args)
        if args.iterations and frame >= args.iterations:
            return rc
        time.sleep(args.interval)


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        os._exit(0)
