"""Merge per-rank telemetry streams into one run report.

Reads a record/telemetry directory produced by a run with ``record_dir``
set (see ``theanompi_tpu_torch/utils/telemetry.py``):

* ``telemetry_rank{r}.jsonl``        — the per-rank event streams
* ``telemetry_summary_rank{r}.json`` — counters/gauges/histograms at close
* ``flight_rank{r}.jsonl`` / ``crash_*/flight_rank{r}.jsonl`` — crash dumps

and emits the cross-worker run report the bucket sums can't answer:

* **phase breakdown** — per recorder section (train/comm/load/...), event
  count, total seconds, mean and p50/p95/p99 tail percentiles;
* **per-rank throughput timeline** — images/sec over wall time from the
  periodic ``train_record`` events;
* **straggler ranking** — wall time is cut into windows (``--window``,
  default 10 s); each window's slowest rank (highest mean ``phase.train``
  dt) is charged one straggle; ranks sorted by windows-straggled and mean
  step time;
* **health flags** — prefetch queue starvation (starved dequeues / min
  queue depth) and HBM headroom (peak bytes vs limit from ``gauges``
  events), plus any flight recordings found (a crash/stall happened) and
  per-rank sentry ``anomaly`` counts (NaN loss / loss spike / throughput
  regression — ``utils/sentry``);
* **``--trace out.json``** — the merged per-rank streams converted to
  Chrome trace-event JSON: one process (track group) per rank holding
  the phase spans (a ``phase`` event's span is ``[ts − dt, ts]``),
  counter tracks for HBM bytes-in-use, prefetch queue depth, heartbeat
  progress, and images/sec, and instant markers for anomaly/crash/stall/
  fatal-signal events plus the elastic-membership transitions
  (``worker_join``/``worker_leave``/``worker_demote``) and chaos-harness
  ``fault_injected`` audits — open directly in Perfetto (ui.perfetto.dev)
  or ``chrome://tracing`` for the cross-rank straggler/churn timeline.

* **distributed traces** — ``span``
  events from the causal-tracing layer (``utils/tracing.py``) are joined
  ACROSS rank files by span id: each exchange round's client span, its
  ``wire.<op>`` children, and the center's ``center.<op>`` handler spans
  become one per-round trace with a critical path (compute | stage |
  wire | queue | apply), a join rate, and dedup-twin accounting; the
  per-worker straggler ROOT-CAUSE table (which component dominated) is
  what ``membership.check_stragglers`` cites in its demote events, and
  the Perfetto export draws flow arrows from each client wire span to
  the server span it caused;
* **``--since TS`` / ``--last SEC``** — time-window the load (cheap
  ``ts``-prefix line skip, no full parse) so long elastic/chaos runs can
  be reported incrementally.

Usage:
    python -m theanompi_tpu_torch.tools.telemetry_report <record_dir>
        [--window SEC] [--since TS | --last SEC]
        [--json out.json] [--trace out.json]

Stdlib only: the port's own copy of the JAX package's run report, the
same sections, flags and output byte for byte.  The elastic supervisor's
straggler ranking (``parallel/membership.py``) and the lint's schema-drift
probe import it as a module.
"""

import argparse
import glob
import json
import os
import sys
from collections import defaultdict


# Event kinds this report (and the --trace converter) consumes — the
# tpulint schema-drift checker asserts the emitters' vocabulary (telemetry
# phase events, sentry anomalies, devprof device profiles, membership
# transitions, chaos fault injections) stays inside it, so an emitter
# can't add a kind the report silently drops.
TRACKED_EVENTS = ("phase", "train_record", "val_record", "gauges",
                  "device_profile", "anomaly", "crash", "stall",
                  "fatal_signal", "worker_join", "worker_leave",
                  "worker_demote", "fault_injected",
                  "center_down", "center_restored", "wire",
                  "span", "statusz", "alert", "numerics")

# gauges-event keys drawn as Perfetto counter tracks (plus
# images_per_sec from train_record events); heartbeat.iter is the
# membership lease's liveness signal (parallel/membership.py);
# wire.outage_s is the wire client's healed-outage duration
# (parallel/wire.py); the numerics.* keys ride `numerics` events
# (utils/numerics) — grad-norm, update-ratio,
# beacon-divergence and ‖w−c‖ counter tracks per rank
TRACE_COUNTER_KEYS = ("hbm_bytes_in_use", "prefetch.queue_depth",
                      "heartbeat.iter", "wire.outage_s",
                      "numerics.grad_norm", "numerics.update_ratio",
                      "numerics.divergence", "numerics.dist_center")

INSTANT_EVENTS = ("anomaly", "crash", "stall", "fatal_signal",
                  "worker_join", "worker_leave", "worker_demote",
                  "fault_injected", "center_down", "center_restored",
                  "wire", "statusz", "alert")

# The critical-path component vocabulary (mirrors utils/tracing.py
# COMPONENTS — schema-drift-probed): every second of a traced exchange
# round is charged to exactly one of these.
TRACE_COMPONENTS = ("compute", "stage", "wire", "queue", "apply")


def percentile(values, q):
    # same nearest-rank formula as telemetry.Histogram.percentile — kept
    # local so this module stays stdlib-only
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def _line_ts(line):
    """The ``ts`` of one JSONL line WITHOUT a full json parse — telemetry
    serializes ``ts`` first (dict insertion order), so a prefix scan is
    enough.  None when the line doesn't open with the ts key (then the
    caller falls back to a real parse)."""
    if not line.startswith('{"ts":'):
        return None
    end = line.find(",", 6)
    if end < 0:
        end = line.find("}", 6)
    if end < 0:
        return None
    try:
        return float(line[6:end].strip())
    except ValueError:
        return None


def load_events(record_dir, since=None, until=None):
    """All events from every per-rank stream, sorted by timestamp.

    ``since``/``until`` (epoch seconds) window the load for long
    elastic/chaos runs: out-of-window lines are skipped on a cheap
    ``ts``-prefix scan, never fully json-parsed — incremental reporting
    without paying for the whole stream."""
    events = []
    for path in sorted(glob.glob(
            os.path.join(record_dir, "telemetry_rank*.jsonl"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if since is not None or until is not None:
                    ts = _line_ts(line)
                    if ts is not None and (
                            (since is not None and ts < since) or
                            (until is not None and ts > until)):
                        continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue          # a crash can truncate the last line
                if not (isinstance(ev, dict) and "ev" in ev):
                    continue
                if since is not None and ev.get("ts", 0) < since:
                    continue          # fallback for ts-not-first lines
                if until is not None and ev.get("ts", 0) > until:
                    continue
                events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0))
    return events


def stream_extent(record_dir):
    """``(first_ts, last_ts)`` across the per-rank streams, read from each
    file's head and tail only (no full parse) — what ``--last N`` anchors
    its window against.  ``(None, None)`` when nothing is parseable."""
    lo = hi = None
    for path in sorted(glob.glob(
            os.path.join(record_dir, "telemetry_rank*.jsonl"))):
        try:
            with open(path, "rb") as f:
                head = f.readline().decode("utf-8", "replace").strip()
                ts = _line_ts(head)
                if ts is not None:
                    lo = ts if lo is None else min(lo, ts)
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 65536))
                tail = f.read().decode("utf-8", "replace").splitlines()
            for line in reversed(tail):
                ts = _line_ts(line.strip())
                if ts is not None:
                    hi = ts if hi is None else max(hi, ts)
                    break
        except OSError:
            continue
    return lo, hi


def load_summaries(record_dir):
    out = {}
    for path in sorted(glob.glob(
            os.path.join(record_dir, "telemetry_summary_rank*.json"))):
        try:
            with open(path) as f:
                s = json.load(f)
            out[int(s.get("rank", 0))] = s
        except (ValueError, OSError):
            continue
    return out


def find_flight_dumps(record_dir):
    return sorted(
        glob.glob(os.path.join(record_dir, "flight_rank*.jsonl")) +
        glob.glob(os.path.join(record_dir, "crash_*", "flight_rank*.jsonl")))


def phase_breakdown(events):
    """Per-section dt distribution from the ``phase`` events."""
    dts = defaultdict(list)
    for ev in events:
        if ev["ev"] == "phase":
            dts[ev.get("sec", "?")].append(float(ev.get("dt", 0.0)))
    out = {}
    for sec, vals in sorted(dts.items()):
        out[sec] = {"count": len(vals), "total": round(sum(vals), 4),
                    "mean": round(sum(vals) / len(vals), 6),
                    "p50": percentile(vals, 50), "p95": percentile(vals, 95),
                    "p99": percentile(vals, 99),
                    # exact extreme over the (windowed) stream — the one
                    # sample a reservoir can drop and an SLO cares about
                    "max": round(max(vals), 6)}
    return out


def throughput_timeline(events):
    """Per-rank [(t_rel, images_per_sec), ...] from train_record events."""
    t0 = events[0]["ts"] if events else 0.0
    tl = defaultdict(list)
    for ev in events:
        if ev["ev"] == "train_record" and "images_per_sec" in ev:
            tl[int(ev.get("rank", 0))].append(
                (round(ev["ts"] - t0, 1), round(ev["images_per_sec"], 1)))
    return dict(tl)


def straggler_ranking(events, window_s):
    """Charge each wall-clock window to its slowest rank (highest mean
    ``phase.train`` dt).  Single-rank runs trivially 'win' every window —
    the mean/p95 columns are the useful part there."""
    train = [(ev["ts"], int(ev.get("rank", 0)), float(ev.get("dt", 0.0)))
             for ev in events
             if ev["ev"] == "phase" and ev.get("sec") == "train"]
    if not train:
        return []
    t0 = train[0][0]
    per_window = defaultdict(lambda: defaultdict(list))
    per_rank = defaultdict(list)
    for ts, rank, dt in train:
        per_window[int((ts - t0) / window_s)][rank].append(dt)
        per_rank[rank].append(dt)
    straggles = defaultdict(int)
    for w, by_rank in per_window.items():
        if len(by_rank) < 1:
            continue
        slowest = max(by_rank,
                      key=lambda r: sum(by_rank[r]) / len(by_rank[r]))
        straggles[slowest] += 1
    ranking = []
    for rank in sorted(per_rank):
        vals = per_rank[rank]
        ranking.append({
            "rank": rank, "windows_straggled": straggles.get(rank, 0),
            "dispatches": len(vals),
            "mean_train_secs": round(sum(vals) / len(vals), 6),
            "p95_train_secs": percentile(vals, 95)})
    ranking.sort(key=lambda r: (-r["windows_straggled"],
                                -(r["mean_train_secs"] or 0)))
    return ranking


def assemble_traces(events):
    """Join client and server ``span`` events across rank streams into
    per-round distributed traces.

    A round is a client span named ``round`` (async islands) or
    ``exchange`` (sync SPMD dispatch); its ``wire.<op>`` child spans were
    emitted by the wire client, and the server's ``center.<op>`` spans
    join by parent span id — a chaos-duplicated or retried request may
    produce several server spans for one client span, of which exactly
    one is APPLIED (the ``dedup``-tagged twins are counted but never
    charged to the critical path).

    Per-round critical path: every second of the round is charged to one
    component — ``queue``/``apply`` from the server's reply-header time
    split, ``wire`` is each op's remaining transit time (dt − q − a,
    retries included: that IS wire time), ``stage`` from the round's own
    ``stage_s`` field when the worker measured one, and ``compute`` is
    the residual (local steps, data wait, elastic update math).  The
    components therefore sum to the observed round time by construction
    — the 5% acceptance tolerance covers clock skew between the two
    processes' q/a stamps, not bookkeeping slack."""
    rounds = []
    wires = defaultdict(list)
    servers = defaultdict(list)
    for ev in events:
        if ev.get("ev") != "span":
            continue
        if ev.get("side") == "server":
            servers[ev.get("parent")].append(ev)
        elif str(ev.get("name", "")).startswith("wire."):
            wires[ev.get("trace")].append(ev)
        elif ev.get("name") in ("round", "exchange"):
            rounds.append(ev)
    out = []
    for r in rounds:
        tid = r.get("trace")
        total = float(r.get("dt", 0.0))
        wire_s = queue_s = apply_s = 0.0
        wire_ops = joined = unjoined = dedup_twins = 0
        for w in wires.get(tid, ()):
            q = float(w.get("q") or 0.0)
            a = float(w.get("a") or 0.0)
            dt = float(w.get("dt", 0.0))
            queue_s += q
            apply_s += a
            wire_s += max(0.0, dt - q - a)
            wire_ops += 1
            srvs = servers.get(w.get("span"), ())
            if any(not s.get("dedup") for s in srvs):
                joined += 1
            else:
                unjoined += 1
            dedup_twins += sum(1 for s in srvs if s.get("dedup"))
        stage = float(r.get("stage_s") or 0.0)
        compute = max(0.0, total - wire_s - queue_s - apply_s - stage)
        components = {"compute": round(compute, 6),
                      "stage": round(stage, 6),
                      "wire": round(wire_s, 6),
                      "queue": round(queue_s, 6),
                      "apply": round(apply_s, 6)}
        dominant = max(components, key=components.get)
        out.append({"trace": tid, "rank": int(r.get("rank", 0)),
                    "island": r.get("island"), "name": r.get("name"),
                    "t0": r.get("t0", r.get("ts")), "dt": round(total, 6),
                    "components": components, "dominant": dominant,
                    "wire_ops": wire_ops, "joined": joined,
                    "unjoined": unjoined, "dedup_twins": dedup_twins,
                    "outcome": r.get("outcome")})
    out.sort(key=lambda t: t.get("t0") or 0.0)
    return out


def straggler_root_cause(events, window_s, traces=None):
    """Per-worker root-cause table from the assembled traces: WHICH
    critical-path component dominated each worker's rounds, per
    ``window_s`` wall-clock window — the demote-event citation
    ``membership.MembershipController.check_stragglers`` attaches, so a
    straggler demotion names its cause (slow compute vs a slow wire vs a
    queued-up center), not just its symptom."""
    traces = assemble_traces(events) if traces is None else traces
    if not traces:
        return {}
    t_origin = min(t.get("t0") or 0.0 for t in traces)
    win = defaultdict(lambda: defaultdict(lambda: defaultdict(float)))
    totals = defaultdict(lambda: defaultdict(float))
    counts = defaultdict(int)
    dt_sum = defaultdict(float)
    for t in traces:
        rank = t["rank"]
        w = int(((t.get("t0") or 0.0) - t_origin) / window_s)
        for comp, secs in t["components"].items():
            win[rank][w][comp] += secs
            totals[rank][comp] += secs
        counts[rank] += 1
        dt_sum[rank] += t["dt"]
    out = {}
    for rank in sorted(counts):
        dom_windows = defaultdict(int)
        for comps in win[rank].values():
            dom_windows[max(comps, key=comps.get)] += 1
        tot = totals[rank]
        overall = max(tot, key=tot.get)
        denom = sum(tot.values()) or 1.0
        out[rank] = {
            "rounds": counts[rank], "windows": len(win[rank]),
            "dominant": overall,
            "dominant_share": round(tot[overall] / denom, 4),
            "windows_dominated_by": dict(sorted(dom_windows.items())),
            "mean_round_s": round(dt_sum[rank] / counts[rank], 6),
            "components_total_s": {k: round(v, 4)
                                   for k, v in sorted(tot.items())}}
    return out


def trace_summary(events, window_s=10.0):
    """The run-level trace digest: round/join/dedup counts, critical-path
    totals, and the per-worker root-cause table.  Empty dict when the
    streams carry no spans (tracing off)."""
    traces = assemble_traces(events)
    if not traces:
        return {}
    joined = sum(t["joined"] for t in traces)
    unjoined = sum(t["unjoined"] for t in traces)
    comp = {k: round(sum(t["components"][k] for t in traces), 4)
            for k in TRACE_COMPONENTS}
    denom = joined + unjoined
    return {
        "rounds": len(traces),
        "wire_ops": sum(t["wire_ops"] for t in traces),
        "joined": joined, "unjoined": unjoined,
        "join_rate": round(joined / denom, 4) if denom else None,
        "dedup_twins": sum(t["dedup_twins"] for t in traces),
        "components_total_s": comp,
        "dominant": max(comp, key=comp.get),
        "root_cause": straggler_root_cause(events, window_s,
                                           traces=traces)}


def health_flags(events, summaries):
    """Queue-starvation and HBM-headroom verdicts, per rank where known."""
    flags = {}
    # prefetch starvation: counters + queue-depth histogram from summaries
    starve = {}
    for rank, s in summaries.items():
        c = s.get("counters", {})
        deq = c.get("prefetch.dequeues", 0)
        if deq:
            h = s.get("hist", {}).get("prefetch.queue_depth", {})
            share = c.get("prefetch.starved_dequeues", 0) / deq
            starve[rank] = {
                "dequeues": int(deq), "starved_share": round(share, 4),
                "min_queue_depth": h.get("min"),
                "p50_queue_depth": h.get("p50"),
                "starving": share > 0.05}
    if starve:
        flags["prefetch"] = starve
    # HBM headroom: the LAST gauges event per rank
    hbm = {}
    for ev in events:
        if ev["ev"] == "gauges" and "hbm_peak_bytes" in ev:
            rank = int(ev.get("rank", 0))
            peak, limit = ev["hbm_peak_bytes"], ev.get("hbm_bytes_limit")
            hbm[rank] = {"peak_bytes": int(peak),
                         "limit_bytes": int(limit) if limit else None,
                         "peak_share": round(peak / limit, 4) if limit
                         else None,
                         "near_oom": bool(limit) and peak / limit > 0.9}
    if hbm:
        flags["hbm"] = hbm
    # sentry anomalies: per-rank counts by kind — a run that tripped the
    # sentry must never read as healthy in the merged report
    anomalies = {}
    for ev in events:
        if ev["ev"] == "anomaly":
            rank = int(ev.get("rank", 0))
            kind = str(ev.get("kind", "?"))
            anomalies.setdefault(rank, {})
            anomalies[rank][kind] = anomalies[rank].get(kind, 0) + 1
    if anomalies:
        flags["anomalies"] = anomalies
    return flags


def numerics_health(events):
    """Per-rank numerics-plane digest (utils/numerics, §25): the LAST
    report's stats plus worst-case values over the window — the beacon
    divergence and nonfinite count must surface even if the run recovered
    afterwards.  Empty dict when the plane was off."""
    out = {}
    for ev in events:
        if ev.get("ev") != "numerics":
            continue
        rank = int(ev.get("rank", 0))
        row = out.setdefault(rank, {"reports": 0, "max_divergence": 0.0,
                                    "nonfinite_total": 0.0,
                                    "max_grad_norm": 0.0,
                                    "min_update_ratio": None,
                                    "max_dist_center": 0.0, "last": {}})
        row["reports"] += 1
        div = ev.get("divergence")
        if isinstance(div, (int, float)) and div == div:
            row["max_divergence"] = max(row["max_divergence"], div)
        nf = ev.get("nonfinite")
        if isinstance(nf, (int, float)):
            row["nonfinite_total"] += nf
        gn = ev.get("grad_norm")
        if isinstance(gn, (int, float)) and gn == gn:
            row["max_grad_norm"] = max(row["max_grad_norm"], gn)
        ur = ev.get("update_ratio")
        if isinstance(ur, (int, float)):
            row["min_update_ratio"] = ur if row["min_update_ratio"] \
                is None else min(row["min_update_ratio"], ur)
        dc = ev.get("dist_center")
        if isinstance(dc, (int, float)) and dc == dc:
            row["max_dist_center"] = max(row["max_dist_center"], dc)
        row["last"] = {k: ev.get(k)
                       for k in ("iter", "grad_norm", "grad_max_abs",
                                 "nonfinite", "param_norm", "update_norm",
                                 "update_ratio", "divergence",
                                 "dist_center", "ef_norm", "beacon")}
    return out


def wire_health(events, summaries):
    """Per-rank wire-layer health (parallel/wire.py): rtt percentiles,
    retry/timeout/corrupt/dedup counters from the summaries, healed
    outages from the ``wire`` events — the network half of the churn
    story the membership transitions tell."""
    out = {}
    ranks = set(summaries) | {int(e.get("rank", 0)) for e in events
                              if e.get("ev") == "wire"}
    for rank in sorted(ranks):
        s = summaries.get(rank, {})
        row = {k: v for k, v in s.get("counters", {}).items()
               if k.startswith("wire.")}
        h = s.get("hist", {}).get("wire.rtt")
        if h:
            row["rtt_count"] = h.get("count")
            row["rtt_p50"] = h.get("p50")
            row["rtt_p99"] = h.get("p99")
            # the EXACT streaming extreme (telemetry.Histogram tracks it
            # outside the reservoir) — the worst RTT an SLO cares about,
            # which percentile-of-reservoir can drop
            row["rtt_max"] = h.get("max")
        # the v2 reply-header time split: RTT decomposable into center
        # queueing vs apply even with tracing disabled (§17 satellite)
        for key, label in (("wire.server_queue", "server_queue"),
                           ("wire.server_apply", "server_apply")):
            hh = s.get("hist", {}).get(key)
            if hh:
                row[label + "_p50"] = hh.get("p50")
                row[label + "_p99"] = hh.get("p99")
        outages = [e for e in events
                   if e.get("ev") == "wire" and e.get("kind") == "outage"
                   and int(e.get("rank", 0)) == rank]
        if outages:
            row["outages"] = len(outages)
            row["outage_total_s"] = round(
                sum(float(e.get("secs", 0.0)) for e in outages), 3)
        if row:
            out[rank] = row
    return out


def build_trace(events):
    """Merged per-rank events → Chrome trace-event JSON (Perfetto/
    chrome://tracing).  Layout: one process per rank (pid = rank) with a
    ``phases`` thread of span events, counter tracks for HBM/queue-depth
    (``gauges`` events) and images/sec (``train_record`` events), and
    instant markers for anomaly/crash/stall/fatal-signal.  Spans are
    emitted in ts order with non-negative durations — a ``phase`` event
    is stamped at bracket END, so its span is ``[ts − dt, ts]``, clamped
    at the capture origin."""
    ranks = sorted({int(e.get("rank", 0)) for e in events})
    t0 = min((e["ts"] for e in events if "ts" in e), default=0.0)

    def us(ts):
        return max(0.0, round((ts - t0) * 1e6, 1))

    # §17 causal spans: rounds on tid 1, wire/server handler spans on
    # tid 2 — pre-scanned so the thread metadata and the cross-track flow
    # arrows (client wire span → the server span it caused) can be built
    span_evs = [e for e in events if e.get("ev") == "span" and "ts" in e]
    span_tids = {(int(e.get("rank", 0)),
                  1 if e.get("name") in ("round", "exchange") else 2)
                 for e in span_evs}

    meta, body = [], []
    for r in ranks:
        meta.append({"ph": "M", "pid": r, "name": "process_name",
                     "args": {"name": "center" if r < 0 else f"rank {r}"}})
        meta.append({"ph": "M", "pid": r, "name": "process_sort_index",
                     "args": {"sort_index": r}})
        meta.append({"ph": "M", "pid": r, "tid": 0, "name": "thread_name",
                     "args": {"name": "phases"}})
    for r, tid in sorted(span_tids):
        meta.append({"ph": "M", "pid": r, "tid": tid, "name": "thread_name",
                     "args": {"name": "rounds" if tid == 1 else "spans"}})
    for ev in events:
        kind = ev.get("ev")
        if kind not in TRACKED_EVENTS or "ts" not in ev:
            continue
        rank = int(ev.get("rank", 0))
        if kind == "phase":
            dur = max(0.0, float(ev.get("dt", 0.0))) * 1e6
            end = us(ev["ts"])
            start = max(0.0, end - dur)
            body.append({"ph": "X", "pid": rank, "tid": 0,
                         "ts": round(start, 1),
                         "dur": round(end - start, 1),
                         "name": str(ev.get("sec", "?")), "cat": "phase"})
        elif kind == "gauges":
            for key in TRACE_COUNTER_KEYS:
                if key in ev:
                    body.append({"ph": "C", "pid": rank, "tid": 0,
                                 "ts": us(ev["ts"]), "name": key,
                                 "args": {"value": ev[key]}})
        elif kind == "numerics":
            # numerics events carry short field names; the counter-track
            # vocabulary uses the gauge-qualified "numerics.<field>"
            for key in TRACE_COUNTER_KEYS:
                if not key.startswith("numerics."):
                    continue
                field = key.split(".", 1)[1]
                val = ev.get(field)
                if isinstance(val, (int, float)) and val == val:
                    body.append({"ph": "C", "pid": rank, "tid": 0,
                                 "ts": us(ev["ts"]), "name": key,
                                 "args": {"value": val}})
        elif kind == "train_record":
            if "images_per_sec" in ev:
                body.append({"ph": "C", "pid": rank, "tid": 0,
                             "ts": us(ev["ts"]), "name": "images_per_sec",
                             "args": {"value": round(
                                 ev["images_per_sec"], 1)}})
        elif kind == "val_record":
            if "val_cost" in ev and ev["val_cost"] == ev["val_cost"]:
                body.append({"ph": "C", "pid": rank, "tid": 0,
                             "ts": us(ev["ts"]), "name": "val_cost",
                             "args": {"value": round(ev["val_cost"], 5)}})
        elif kind == "device_profile":
            if ev.get("overlap_ratio") is not None:
                body.append({"ph": "C", "pid": rank, "tid": 0,
                             "ts": us(ev["ts"]),
                             "name": "device.overlap_ratio",
                             "args": {"value": ev["overlap_ratio"]}})
        elif kind == "span":
            name = str(ev.get("name", "?"))
            tid = 1 if name in ("round", "exchange") else 2
            dur = max(0.0, float(ev.get("dt", 0.0)) * 1e6)
            start = us(float(ev["t0"])) if ev.get("t0") is not None \
                else max(0.0, us(ev["ts"]) - dur)
            label = name
            if ev.get("dedup"):
                label += ":dedup"
            elif ev.get("ok") is False:
                label += ":failed"
            elif ev.get("outcome") and ev["outcome"] != "exchanged":
                label += f":{ev['outcome']}"
            body.append({"ph": "X", "pid": rank, "tid": tid,
                         "ts": round(start, 1), "dur": round(dur, 1),
                         "name": label, "cat": "span",
                         "args": {k: ev.get(k)
                                  for k in ("trace", "span", "parent",
                                            "q", "a", "retries", "island")
                                  if ev.get(k) is not None}})
        elif kind == "alert":
            # fleet-health SLO alerts (utils/fleetmon): the marker names
            # the firing RULE and value, so the Perfetto timeline reads
            # "alert:step_time_degraded=0.41 (w3)" at the instant the
            # rule engine fired — next to the fault/membership markers
            # that explain it
            who = "fleet" if ev.get("worker") is None \
                else f"w{ev['worker']}"
            val = ev.get("value")
            label = f"alert:{ev.get('rule', '?')}"
            if val is not None:
                label += f"={val:g}" if isinstance(val, (int, float)) \
                    else f"={val}"
            body.append({"ph": "i", "pid": rank, "tid": 0,
                         "ts": us(ev["ts"]), "s": "p",
                         "name": f"{label} ({who})", "cat": "alert"})
        elif kind in INSTANT_EVENTS:
            parts = []
            if "worker" in ev:          # membership/chaos events name the
                parts.append(f"w{ev['worker']}")   # affected worker
            d = ev.get("kind") or ev.get("reason") or ev.get("role") or \
                ev.get("label") or ev.get("error", "")[:40] or \
                ev.get("signum", "")
            if d:
                parts.append(str(d))
            detail = ":".join(parts)
            body.append({"ph": "i", "pid": rank, "tid": 0,
                         "ts": us(ev["ts"]), "s": "p",
                         "name": f"{kind}:{detail}" if detail else kind,
                         "cat": "alert"})
    # flow arrows: each server span binds back to the client wire span
    # that caused it (join by parent span id) — the visual cross-rank
    # link between a worker's exchange and the center handler it hit.
    # The flow id is the SERVER span id, so a dedup twin gets its own
    # arrow out of the same client span.
    def _mid(ev):
        dur = max(0.0, float(ev.get("dt", 0.0)) * 1e6)
        start = us(float(ev["t0"])) if ev.get("t0") is not None \
            else max(0.0, us(ev["ts"]) - dur)
        return round(start + dur / 2.0, 1)

    wire_client = {e.get("span"): e for e in span_evs
                   if e.get("side") != "server"
                   and str(e.get("name", "")).startswith("wire.")}
    for s_ev in span_evs:
        if s_ev.get("side") != "server":
            continue
        c_ev = wire_client.get(s_ev.get("parent"))
        if c_ev is None:
            continue              # client span lost (crash mid-round)
        fid = str(s_ev.get("span"))
        body.append({"ph": "s", "id": fid, "cat": "wire", "name": "rpc",
                     "pid": int(c_ev.get("rank", 0)), "tid": 2,
                     "ts": _mid(c_ev)})
        body.append({"ph": "f", "bp": "e", "id": fid, "cat": "wire",
                     "name": "rpc", "pid": int(s_ev.get("rank", 0)),
                     "tid": 2, "ts": _mid(s_ev)})
    body.sort(key=lambda e: e["ts"])
    return {"displayTimeUnit": "ms", "traceEvents": meta + body}


def build_report(record_dir, window_s=10.0, events=None):
    if events is None:
        events = load_events(record_dir)
    summaries = load_summaries(record_dir)
    dumps = find_flight_dumps(record_dir)
    runs = sorted({ev.get("run") for ev in events if ev.get("run")})
    ranks = sorted({int(ev.get("rank", 0)) for ev in events})
    crashes = [ev for ev in events if ev["ev"] in ("crash", "stall",
                                                   "fatal_signal",
                                                   "anomaly")]
    # last device-attribution result per rank (worker trace_dir captures,
    # utils/devprof) — the comm/compute overlap evidence
    device = {}
    for ev in events:
        if ev["ev"] == "device_profile":
            device[int(ev.get("rank", 0))] = {
                k: ev.get(k) for k in ("compute_secs", "comm_secs",
                                       "exposed_comm_secs", "overlap_ratio",
                                       "lanes", "train_dispatches")}
    # membership transitions + injected faults (elastic runtime,
    # parallel/membership.py + utils/chaos.py) — the run's churn story
    membership = [
        {"ts": ev["ts"], "ev": ev["ev"], "worker": ev.get("worker"),
         "reason": ev.get("reason"), "kind": ev.get("kind"),
         "rejoin": ev.get("rejoin")}
        for ev in events
        if ev["ev"] in ("worker_join", "worker_leave", "worker_demote",
                        "fault_injected", "center_down",
                        "center_restored")]
    # fleet-health SLO alerts (utils/fleetmon): what the rule engine
    # fired during the window, cited next to the wire health it explains
    alerts = [{"ts": ev["ts"], "rule": ev.get("rule"),
               "series": ev.get("series"), "scope": ev.get("scope"),
               "worker": ev.get("worker"), "value": ev.get("value"),
               "threshold": ev.get("threshold"),
               "action": ev.get("action")}
              for ev in events if ev["ev"] == "alert"]
    return {
        "record_dir": os.path.abspath(record_dir),
        "runs": runs, "ranks": ranks, "events": len(events),
        "device_profiles": device,
        "phases": phase_breakdown(events),
        "throughput_timeline": throughput_timeline(events),
        "straggler_ranking": straggler_ranking(events, window_s),
        "flags": health_flags(events, summaries),
        "counters": {r: s.get("counters", {}) for r, s in summaries.items()},
        "wire": wire_health(events, summaries),
        "numerics": numerics_health(events),
        "alerts": alerts,
        "traces": trace_summary(events, window_s),
        "membership_events": membership,
        "crash_events": crashes,
        "flight_dumps": dumps,
    }


def print_report(rep):
    print(f"telemetry report — {rep['record_dir']}")
    print(f"  runs: {', '.join(rep['runs']) or '(none)'}   "
          f"ranks: {rep['ranks']}   events: {rep['events']}")
    if rep["phases"]:
        print("\nphase breakdown (seconds per dispatch):")
        print(f"  {'phase':<9}{'count':>7}{'total':>10}{'mean':>10}"
              f"{'p50':>10}{'p95':>10}{'p99':>10}")
        for sec, p in rep["phases"].items():
            print(f"  {sec:<9}{p['count']:>7}{p['total']:>10.3f}"
                  f"{p['mean']:>10.5f}{p['p50']:>10.5f}{p['p95']:>10.5f}"
                  f"{p['p99']:>10.5f}")
    if rep["straggler_ranking"]:
        print("\nstraggler ranking (slowest rank per "
              "window, slowest first):")
        for r in rep["straggler_ranking"]:
            print(f"  rank {r['rank']}: straggled {r['windows_straggled']} "
                  f"window(s), mean train {r['mean_train_secs'] * 1e3:.2f} ms"
                  f", p95 {r['p95_train_secs'] * 1e3:.2f} ms "
                  f"over {r['dispatches']} dispatches")
    for rank, tl in sorted(rep["throughput_timeline"].items()):
        pts = " ".join(f"{t}s:{ips}" for t, ips in tl[-8:])
        print(f"\nrank {rank} throughput timeline (img/s, last 8): {pts}")
    pf = rep["flags"].get("prefetch")
    if pf:
        print("\nprefetch queue:")
        for rank, f in sorted(pf.items()):
            verdict = "STARVING" if f["starving"] else "healthy"
            print(f"  rank {rank}: {verdict} — starved share "
                  f"{f['starved_share']:.1%} of {f['dequeues']} dequeues, "
                  f"min depth {f['min_queue_depth']}, "
                  f"p50 depth {f['p50_queue_depth']}")
    hb = rep["flags"].get("hbm")
    if hb:
        print("\nHBM headroom:")
        for rank, f in sorted(hb.items()):
            share = (f"{f['peak_share']:.1%} of limit"
                     if f["peak_share"] is not None else "limit unknown")
            verdict = " — NEAR OOM" if f["near_oom"] else ""
            print(f"  rank {rank}: peak {f['peak_bytes'] / 2**30:.2f} GiB "
                  f"({share}){verdict}")
    if rep.get("device_profiles"):
        print("\ndevice-time attribution (last trace capture per rank):")
        for rank, d in sorted(rep["device_profiles"].items()):
            overlap = (f"{d['overlap_ratio']:.1%} overlap"
                       if d.get("overlap_ratio") is not None
                       else "no collectives in window")
            print(f"  rank {rank}: compute {d.get('compute_secs', 0):.3f}s "
                  f"comm {d.get('comm_secs', 0):.3f}s exposed "
                  f"{d.get('exposed_comm_secs', 0):.3f}s ({overlap})")
    nm = rep.get("numerics")
    if nm:
        print("\nnumerics health (per-rank, last report + window worst):")
        for rank, n in sorted(nm.items()):
            last = n.get("last", {})
            verdict = ""
            if n["max_divergence"] > 0:
                verdict = " — DIVERGED"
            elif n["nonfinite_total"] > 0:
                verdict = " — OVERFLOWED"
            gn = last.get("grad_norm")
            ur = last.get("update_ratio")
            dc = last.get("dist_center")
            ef = last.get("ef_norm")
            parts = [f"iter {last.get('iter')}"]
            if isinstance(gn, (int, float)):
                parts.append(f"grad_norm {gn:.4g}")
            if isinstance(ur, (int, float)):
                parts.append(f"update_ratio {ur:.3g}")
            if isinstance(dc, (int, float)) and dc:
                parts.append(f"dist_center {dc:.4g}")
            if isinstance(ef, (int, float)) and ef:
                parts.append(f"ef_norm {ef:.4g}")
            beacon = last.get("beacon")
            parts.append(
                f"divergence {n['max_divergence']:.4g} (max)"
                if beacon else "no beacon")
            parts.append(f"nonfinite {int(n['nonfinite_total'])}")
            print(f"  rank {rank}: " + ", ".join(parts)
                  + f" over {n['reports']} report(s){verdict}")
    an = rep["flags"].get("anomalies")
    if an:
        print("\nsentry anomalies:")
        for rank, kinds in sorted(an.items()):
            pretty = ", ".join(f"{k}×{n}" for k, n in sorted(kinds.items()))
            print(f"  rank {rank}: {pretty}")
    if rep.get("wire"):
        print("\nwire health (center RPC layer):")
        for rank, w in sorted(rep["wire"].items()):
            rtt = (f"rtt p50 {w['rtt_p50'] * 1e3:.1f}ms "
                   f"p99 {w['rtt_p99'] * 1e3:.1f}ms "
                   f"max {w['rtt_max'] * 1e3:.1f}ms "
                   f"over {w['rtt_count']} ops"
                   if w.get("rtt_p50") is not None else "no rtt samples")
            if w.get("server_queue_p50") is not None:
                # the v2 reply-header split: how much of that RTT was the
                # center queueing/applying rather than the wire itself
                rtt += (f" [center queue p50 "
                        f"{w['server_queue_p50'] * 1e3:.2f}ms, apply p50 "
                        f"{w.get('server_apply_p50', 0) * 1e3:.2f}ms]")
            churn = ", ".join(
                f"{k.split('.', 1)[1]}×{int(v)}" for k, v in sorted(
                    w.items()) if k.startswith("wire.") and v)
            outage = (f", outages {w['outages']} "
                      f"({w['outage_total_s']}s total)"
                      if w.get("outages") else "")
            print(f"  rank {rank}: {rtt}"
                  + (f" — {churn}" if churn else "") + outage)
        wire_alerts = [a for a in rep.get("alerts", ())
                       if str(a.get("series", "")).startswith("wire")]
        if wire_alerts:
            # the SLO verdicts behind those numbers: which wire rules
            # fired in this window, on whom
            cite = ", ".join(
                f"{a['rule']}"
                + ("[fleet]" if a.get("worker") is None
                   else f"[w{a['worker']}]")
                for a in wire_alerts[-6:])
            print(f"  alerts fired: {cite}")
    alerts = rep.get("alerts")
    if alerts:
        print(f"\nfleet-health alerts ({len(alerts)} fired):")
        for a in alerts[-10:]:
            who = "fleet" if a.get("worker") is None \
                else f"worker {a['worker']}"
            act = f" -> {a['action']}" if a.get("action") else ""
            print(f"  {a['rule']} on {who}: {a['series']}={a['value']} "
                  f"(threshold {a['threshold']}){act}")
    tr = rep.get("traces")
    if tr:
        jr = (f"{tr['join_rate']:.1%} joined" if tr.get("join_rate")
              is not None else "no wire ops")
        print(f"\ndistributed traces ({tr['rounds']} exchange rounds, "
              f"{tr['wire_ops']} wire ops, {jr}, "
              f"{tr['dedup_twins']} dedup twin(s)):")
        comp = tr["components_total_s"]
        print("  critical path totals: " + "  ".join(
            f"{k} {comp[k]:.3f}s" for k in comp))
        if tr.get("root_cause"):
            print("  straggler root cause (dominant component per worker):")
            for rank, rc in sorted(tr["root_cause"].items(),
                                   key=lambda kv: str(kv[0])):
                wins = ", ".join(f"{k}×{v}" for k, v in
                                 rc["windows_dominated_by"].items())
                print(f"    rank {rank}: {rc['dominant'].upper()} "
                      f"({rc['dominant_share']:.0%} of round time; "
                      f"windows: {wins}; mean round "
                      f"{rc['mean_round_s'] * 1e3:.1f} ms over "
                      f"{rc['rounds']} rounds)")
    if rep.get("membership_events"):
        print("\nmembership transitions / injected faults:")
        for ev in rep["membership_events"][-12:]:
            detail = ev.get("reason") or ev.get("kind") or ""
            who = "center" if ev["ev"].startswith("center_") \
                else f"worker {ev.get('worker')}"
            print(f"  {ev['ev']} {who}"
                  + (f" ({detail})" if detail else "")
                  + (" [rejoin]" if ev.get("rejoin") else ""))
    if rep["crash_events"]:
        print("\ncrash/stall/anomaly events:")
        for ev in rep["crash_events"][-5:]:
            detail = ev.get("error") or ev.get("label") or \
                ev.get("kind") or ev.get("signum", "")
            print(f"  rank {ev.get('rank', 0)} {ev['ev']}: {detail}")
    if rep["flight_dumps"]:
        print("\nflight recordings (crash/stall trails):")
        for p in rep["flight_dumps"]:
            print(f"  {p}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("record_dir")
    ap.add_argument("--window", type=float, default=10.0,
                    help="straggler window seconds (default 10)")
    ap.add_argument("--since", type=float, default=None, metavar="TS",
                    help="only events at/after this unix timestamp — "
                         "incremental reports over long runs without "
                         "parsing the whole stream")
    ap.add_argument("--last", type=float, default=None, metavar="SEC",
                    help="only the trailing SEC seconds of the stream "
                         "(anchored at the newest event)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the machine-readable report here "
                         "('-' for stdout)")
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="also write Chrome trace-event JSON (one track "
                         "per rank: phase spans, HBM/queue-depth/img-s "
                         "counter tracks, anomaly markers) — open in "
                         "Perfetto (ui.perfetto.dev) or chrome://tracing")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.record_dir):
        print(f"no such directory: {args.record_dir}", file=sys.stderr)
        return 2
    since = args.since
    if args.last is not None:
        _, hi = stream_extent(args.record_dir)
        if hi is not None:
            last_since = hi - args.last
            since = last_since if since is None else max(since, last_since)
    events = load_events(args.record_dir,        # parsed ONCE, shared by
                         since=since)            # report and --trace
    rep = build_report(args.record_dir, args.window,
                       events=events)
    if since is not None:
        rep["since"] = round(since, 3)
    if not rep["events"]:
        win = " in the requested window" if since is not None else ""
        print(f"no telemetry_rank*.jsonl events under "
              f"{args.record_dir}{win} — run with record_dir set "
              "(telemetry streams there)", file=sys.stderr)
        return 1
    print_report(rep)
    if args.json == "-":
        print(json.dumps(rep))
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
        print(f"\nwrote {args.json}")
    if args.trace:
        trace = build_trace(events)
        with open(args.trace, "w") as f:
            json.dump(trace, f)
        spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        print(f"\nwrote {args.trace} ({spans} spans across "
              f"{len(rep['ranks'])} rank track(s)) — open in Perfetto")
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        os._exit(0)          # downstream `head`/pager closed the pipe
