"""schema-drift: the port's telemetry vocabularies stay in sync, held
against live objects.

Each probe drives a live object of the port and compares what it emits
with what its module declares, so a record built by hand that drifts
from the declared list is caught too:

* phases: ``recorder.SECTIONS`` is ``telemetry.PHASES``, a live
  ``print_train_info`` emits ``t_<phase>`` keys, a live registry one
  phase event and histogram per phase;
* device attribution: ``devprof.feed_telemetry`` of a complete profile
  (a kernel and an NCCL collective overlapping on one card) sets exactly
  ``DEVICE_GAUGES``, ``profile_row_fields`` returns exactly
  ``TRACE_ROW_COLUMNS``; a live sentry fed a NaN cost emits its
  ``anomaly`` event with a declared kind;
* membership: a live controller's join/demote/leave emits exactly
  ``MEMBERSHIP_EVENTS``, a live lease beat ``HEARTBEAT_GAUGES``;
* the wire: a live ``WireClient`` against a dead address retries, gives
  up and streams its ``wire`` event; a ``DedupWindow`` replay counts one
  hit; a frame of another version fails naming both; the controller's
  center-outage pair emits ``CENTER_EVENTS``;
* tracing: a live round span carries ``SPAN_FIELDS``; client and server
  spans assemble into one joined round in the report; a live statusz
  endpoint answers ``health`` with ``STATUSZ_FIELDS`` over a socket;
* the fleet monitor: the stock rules validate, a breach fires exactly one
  alert and does not re-fire, an alert's demotion cites its rule, the
  exposition covers every series;
* numerics: ``record(example_report())`` covers the declared gauges,
  histograms and event; an overflow raises ``grad_overflow``;
* the compile cache: its key is content-addressed and byte-stable, and
  each ladder counter is mirrored into the registry;
* the center: the op table read out of ``center_server.py`` equals the
  ops a live ``RemoteCenter`` sends over a stubbed wire;
* thread roles: every Thread and Timer in ``membership.py`` and
  ``chaos.py`` resolves to its entry function in the engine.

The report (``scripts/telemetry_report.py``, stdlib, loaded by file path
as ``parallel/membership.py`` loads it) must consume every event kind.
The probes import the port's stdlib planes and numpy; the center probe
imports ``center_server``, which imports torch (about three seconds of a
cold run on a CPU host).  None imports ``jax`` or the JAX package.
"""

from __future__ import annotations

import importlib.util
import os
import tempfile
from typing import List, Optional

from ..core import Checker, Finding, register
from ..protocol import (CENTER_PATH, FLEETMON_PATH, MEMBERSHIP_PATH,
                        TRACING_PATH, WIRE_PATH)

_UTILS = "theanompi_tpu_torch/utils"
TELEMETRY_PATH = f"{_UTILS}/telemetry.py"
RECORDER_PATH = f"{_UTILS}/recorder.py"
DEVPROF_PATH = f"{_UTILS}/devprof.py"
SENTRY_PATH = f"{_UTILS}/sentry.py"
CHAOS_PATH = f"{_UTILS}/chaos.py"
NUMERICS_PATH = f"{_UTILS}/numerics.py"
COMPILE_CACHE_PATH = f"{_UTILS}/compile_cache.py"
REPORT_PATH = "scripts/telemetry_report.py"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# one card: a kernel over [0, 50] us and an NCCL all-reduce over [40, 60]
# us → compute 50 us, comm 20 us, 10 us exposed, overlap 0.5: a complete
# profile, so feed_telemetry must set every declared gauge
_PROBE_EVENTS = [
    {"ph": "X", "cat": "kernel", "pid": 1, "tid": 7, "ts": 0.0, "dur": 50.0,
     "name": "sm90_xmma_gemm_bf16bf16", "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "pid": 1, "tid": 8, "ts": 40.0, "dur": 20.0,
     "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
     "args": {"correlation": 2}},
]


def _tm(telemetry, rank: int = 0):
    return telemetry.Telemetry(rank=rank, run_id="drift-check")


def live_drift_errors(recorder, telemetry) -> List[tuple]:
    """The phase probes, on the two modules (tests pass stand-ins).
    ``(path, message)`` pairs; empty when in sync."""
    errors: List[tuple] = []
    if tuple(recorder.SECTIONS) != tuple(telemetry.PHASES):
        errors.append((RECORDER_PATH,
                       f"recorder.SECTIONS {tuple(recorder.SECTIONS)!r} != "
                       f"telemetry.PHASES {tuple(telemetry.PHASES)!r}"))
    r = recorder.Recorder({"verbose": False, "printFreq": 1})
    r.start()
    r.end("train")
    r.train_error(1, 1.0, 0.5, 8)
    rec = r.print_train_info(1)
    want = {"t_" + s for s in telemetry.PHASES if s != "val"}
    if not rec:
        errors.append((RECORDER_PATH,
                       "print_train_info(1) did not fire at printFreq=1"))
    elif {k for k in rec if k.startswith("t_")} != want:
        errors.append((RECORDER_PATH,
                       f"print_train_info record keys "
                       f"{sorted(k for k in rec if k.startswith('t_'))} != "
                       f"t_<PHASES except val> {sorted(want)}"))
    if tuple(recorder.RECORD_KEYS) != tuple(
            "t_" + s for s in telemetry.PHASES if s != "val"):
        errors.append((RECORDER_PATH,
                       f"recorder.RECORD_KEYS {tuple(recorder.RECORD_KEYS)!r}"
                       " drifted from telemetry.PHASES"))
    tm = _tm(telemetry)
    for s in telemetry.PHASES:
        tm.phase(s, 0.0)
    got = {e.get("sec") for e in tm.tail(len(telemetry.PHASES) + 1)
           if e["ev"] == "phase"}
    if got != set(telemetry.PHASES):
        errors.append((TELEMETRY_PATH,
                       f"telemetry phase-event names {sorted(got)} != "
                       f"PHASES {sorted(telemetry.PHASES)}"))
    if {k for k in tm.hists if k.startswith("phase.")} != \
            {"phase." + s for s in telemetry.PHASES}:
        errors.append((TELEMETRY_PATH,
                       f"telemetry phase histograms "
                       f"{sorted(k for k in tm.hists if k.startswith('phase.'))}"
                       " drifted from PHASES"))
    return errors


def _tracked(report) -> set:
    return set(getattr(report, "TRACKED_EVENTS", ()))


def _missing_tracked(report, want, path_msg) -> List[tuple]:
    missing = sorted(set(want) - _tracked(report)) if report is not None else []
    return [(REPORT_PATH, path_msg.format(missing))] if missing else []


def device_schema_errors(devprof, sentry, telemetry,
                         telemetry_report=None) -> List[tuple]:
    """The device-attribution and sentry probes.  ``telemetry_report`` may
    be None (then its checks are skipped)."""
    errors: List[tuple] = []
    prof = devprof.attribute(_PROBE_EVENTS)
    tm = _tm(telemetry)
    devprof.feed_telemetry(prof, tm)
    if set(tm.gauges) != set(devprof.DEVICE_GAUGES):
        errors.append((DEVPROF_PATH,
                       f"feed_telemetry gauges {sorted(tm.gauges)} != "
                       f"DEVICE_GAUGES {sorted(devprof.DEVICE_GAUGES)}"))
    if not [e for e in tm.tail(4) if e["ev"] == devprof.PROFILE_EVENT]:
        errors.append((DEVPROF_PATH,
                       f"feed_telemetry emitted no {devprof.PROFILE_EVENT!r} "
                       f"event"))
    if any(not g.startswith("device.") for g in devprof.DEVICE_GAUGES):
        errors.append((DEVPROF_PATH,
                       "DEVICE_GAUGES contains a non-'device.' name"))
    fields = devprof.profile_row_fields(prof, total_flops=1e9,
                                        peak_flops=1e12)
    if set(fields) != set(devprof.TRACE_ROW_COLUMNS):
        errors.append((DEVPROF_PATH,
                       f"profile_row_fields keys {sorted(fields)} != "
                       f"TRACE_ROW_COLUMNS {sorted(devprof.TRACE_ROW_COLUMNS)}"))
    bucket_cols = getattr(devprof, "BUCKET_ROW_COLUMNS", None)
    if not bucket_cols:
        errors.append((DEVPROF_PATH,
                       "BUCKET_ROW_COLUMNS missing from devprof — the "
                       "bucketed rows have no pinned vocabulary"))
    else:
        clash = sorted(set(bucket_cols) & set(devprof.TRACE_ROW_COLUMNS))
        if clash:
            errors.append((DEVPROF_PATH,
                           f"BUCKET_ROW_COLUMNS collide with "
                           f"TRACE_ROW_COLUMNS: {clash}"))
    tm2 = _tm(telemetry)
    s = sentry.TrainingSentry({"verbose": False, "sentry_min_records": 2},
                              telemetry=tm2)
    for i in range(3):
        s.observe_record({"iter": i, "cost": 1.0, "images_per_sec": 100.0})
    kind = s.observe_record({"iter": 3, "cost": float("nan"),
                             "images_per_sec": 100.0})
    anoms = [e for e in tm2.tail(8) if e["ev"] == sentry.ANOMALY_EVENT]
    if kind != "nan_loss" or not anoms:
        errors.append((SENTRY_PATH,
                       f"a NaN cost did not raise a live "
                       f"{sentry.ANOMALY_EVENT!r} event (got kind {kind!r})"))
    else:
        if anoms[-1].get("kind") not in sentry.ANOMALY_KINDS:
            errors.append((SENTRY_PATH,
                           f"anomaly kind {anoms[-1].get('kind')!r} not in "
                           f"ANOMALY_KINDS {sentry.ANOMALY_KINDS}"))
        if "iter" not in anoms[-1]:
            errors.append((SENTRY_PATH,
                           "anomaly event carries no 'iter' field"))
    errors += _missing_tracked(
        telemetry_report, {"phase", "train_record", "gauges",
                           sentry.ANOMALY_EVENT, devprof.PROFILE_EVENT},
        "TRACKED_EVENTS is missing emitter event kind(s) {} — the "
        "report/trace export would silently drop them")
    return errors


def membership_schema_errors(membership, chaos, telemetry,
                             telemetry_report=None) -> List[tuple]:
    """A live controller through join → demote → leave emits exactly
    ``MEMBERSHIP_EVENTS`` (each naming its worker); a live lease beat
    streams ``HEARTBEAT_GAUGES``; the report consumes both and chaos's
    fault event."""
    errors: List[tuple] = []
    if membership is not None:
        tm = _tm(telemetry)
        ctl = membership.MembershipController(telemetry_=tm)
        ctl.join(7, pid=123)
        ctl.demote(7)            # refused: the active set would be empty
        ctl.join(8, pid=124)
        ctl.demote(7)
        ctl.leave(8, reason="probe")
        evs = [e for e in tm.tail(8) if e["ev"] != "run_start"]
        got = {e["ev"] for e in evs}
        if got != set(membership.MEMBERSHIP_EVENTS):
            errors.append((MEMBERSHIP_PATH,
                           f"a live controller's join/demote/leave emitted "
                           f"{sorted(got)} != MEMBERSHIP_EVENTS "
                           f"{sorted(membership.MEMBERSHIP_EVENTS)}"))
        if any("worker" not in e for e in evs):
            errors.append((MEMBERSHIP_PATH,
                           "a membership event carries no 'worker' field"))
        tm2 = _tm(telemetry)
        with tempfile.TemporaryDirectory() as d:
            membership.WorkerLease(d, 0, telemetry_=tm2).beat(5)
        beats = [e for e in tm2.tail(4) if e["ev"] == "gauges"]
        want = set(membership.HEARTBEAT_GAUGES)
        if not beats or not want <= set(beats[-1]):
            errors.append((MEMBERSHIP_PATH,
                           f"WorkerLease.beat streamed no gauges event "
                           f"carrying HEARTBEAT_GAUGES {sorted(want)}"))
        if set(tm2.gauges) != want:
            errors.append((MEMBERSHIP_PATH,
                           f"WorkerLease.beat gauges {sorted(tm2.gauges)} "
                           f"!= HEARTBEAT_GAUGES {sorted(want)}"))
    if telemetry_report is not None:
        want = set(getattr(membership, "MEMBERSHIP_EVENTS", ()))
        if chaos is not None:
            want.add(chaos.FAULT_EVENT)
        errors += _missing_tracked(
            telemetry_report, want,
            "TRACKED_EVENTS is missing membership/chaos event kind(s) {} — "
            "the chaos gate's leave/join matching would silently drop them")
        hb = set(getattr(membership, "HEARTBEAT_GAUGES", ()))
        counters = set(getattr(telemetry_report, "TRACE_COUNTER_KEYS", ()))
        if hb and not hb <= counters:
            errors.append((REPORT_PATH,
                           f"TRACE_COUNTER_KEYS is missing heartbeat "
                           f"gauge(s) {sorted(hb - counters)} — the Perfetto "
                           f"export would not render liveness"))
    return errors


def wire_schema_errors(wire, membership, telemetry,
                       telemetry_report=None) -> List[tuple]:
    """The wire's telemetry: a live client against a dead address retries,
    gives up and streams the ``wire`` event; a dedup replay counts one
    hit; a frame of another version fails loudly; the controller's
    center-outage pair emits ``CENTER_EVENTS``."""
    errors: List[tuple] = []
    if wire is None:
        return errors
    # the telemetry names: the client's counters (kept without the
    # prefix, as its ``counters`` dict is), histograms and gauges
    for name in (tuple("wire." + c for c in wire.WIRE_COUNTERS)
                 + tuple(getattr(wire, "WIRE_HISTS", ()))
                 + tuple(getattr(wire, "WIRE_GAUGES", ()))):
        if not name.startswith("wire."):
            errors.append((WIRE_PATH,
                           f"declared wire metric {name!r} is outside the "
                           f"'wire.' namespace"))
    for decl in ("WIRE_HISTS", "WIRE_GAUGES"):
        if not getattr(wire, decl, ()):
            errors.append((WIRE_PATH,
                           f"{decl} is not declared — the wire streams "
                           f"metrics of that kind with no pinned vocabulary"))
    if membership is not None:
        tm = _tm(telemetry)
        client = wire.WireClient(
            "127.0.0.1:9", client_id="drift", op_timeout_s=0.2,
            connect_timeout_s=0.2, max_retries=1, deadline_s=1.0,
            backoff=membership.Backoff(base=0.01, cap=0.02), telemetry_=tm)
        try:
            client.request({"op": "stats"})
            errors.append((WIRE_PATH,
                           "a WireClient against a dead address did not "
                           "raise WireGiveUp"))
        except ConnectionError:
            pass
        finally:
            client.close()
        if tm.counters.get("wire.giveup", 0) < 1 or \
                tm.counters.get("wire.retry", 0) < 1:
            errors.append((WIRE_PATH,
                           f"give-up path ticked {sorted(tm.counters)} — "
                           f"expected wire.retry and wire.giveup counts"))
        evs = [e for e in tm.tail(8) if e["ev"] == wire.WIRE_EVENT]
        if not evs or evs[-1].get("kind") != "giveup":
            errors.append((WIRE_PATH,
                           f"give-up emitted no {wire.WIRE_EVENT!r} event "
                           f"with kind='giveup'"))
    tm2 = _tm(telemetry)
    win = wire.DedupWindow(telemetry_=tm2)
    tok = {"w": "drift", "seq": 0}
    dup, _ = win.check(tok, "push")
    win.record(tok, "push", {"ok": True})
    dup2, _ = win.check(tok, "push")
    if dup or not dup2 or win.hits != 1 or \
            tm2.counters.get("wire.dedup_hit", 0) != 1:
        errors.append((WIRE_PATH,
                       f"DedupWindow replay did not register exactly one "
                       f"wire.dedup_hit (fresh={dup}, dup={dup2}, "
                       f"hits={win.hits})"))
    import socket
    a, b = socket.socketpair()
    try:
        a.sendall(wire.encode_frame({"ok": True, "v": 999999}))
        try:
            wire.recv_msg(b)
            errors.append((WIRE_PATH, "a version-mismatched frame did not "
                                      "raise"))
        except wire.VersionMismatch as e:
            if "999999" not in str(e) or str(wire.WIRE_VERSION) not in str(e):
                errors.append((WIRE_PATH,
                               f"VersionMismatch message lacks both "
                               f"versions: {str(e)!r}"))
    finally:
        a.close()
        b.close()
    if membership is not None:
        tm3 = _tm(telemetry)
        ctl = membership.MembershipController(telemetry_=tm3)
        ctl.center_down(reason="probe")
        ctl.center_restored(attempt=1)
        got = {e["ev"] for e in tm3.tail(4) if e["ev"] != "run_start"}
        if got != set(membership.CENTER_EVENTS):
            errors.append((MEMBERSHIP_PATH,
                           f"a live controller's center outage pair emitted "
                           f"{sorted(got)} != CENTER_EVENTS "
                           f"{sorted(membership.CENTER_EVENTS)}"))
    if telemetry_report is not None:
        want = {wire.WIRE_EVENT} | set(getattr(membership, "CENTER_EVENTS", ()))
        errors += _missing_tracked(
            telemetry_report, want,
            "TRACKED_EVENTS is missing wire/center event kind(s) {} — the "
            "chaos gate's center_down→center_restored matching and the wire "
            "outage markers would be dropped")
        counters = set(getattr(telemetry_report, "TRACE_COUNTER_KEYS", ()))
        missing = sorted(set(getattr(wire, "WIRE_GAUGES", ())) - counters)
        if missing:
            errors.append((REPORT_PATH,
                           f"TRACE_COUNTER_KEYS is missing wire gauge(s) "
                           f"{missing} — the Perfetto export would not render "
                           f"outage durations"))
    return errors


def tracing_schema_errors(tracing, telemetry,
                          telemetry_report=None) -> List[tuple]:
    """A live round span carries ``SPAN_FIELDS``; the three emitters join
    into one round in the report's assembly (the dedup twin counted, not
    joined); a live statusz endpoint answers with ``STATUSZ_FIELDS`` and
    registers, then removes, its discovery doc."""
    errors: List[tuple] = []
    if tracing is None:
        return errors
    tm = _tm(telemetry)
    tr = tracing.Tracer(telemetry_=tm)
    tr.begin("round", island=0).end(outcome="exchanged")
    spans = [e for e in tm.tail(4) if e["ev"] == tracing.SPAN_EVENT]
    if not spans:
        errors.append((TRACING_PATH, f"a live Tracer round emitted no "
                                     f"{tracing.SPAN_EVENT!r} event"))
    else:
        missing = [k for k in tracing.SPAN_FIELDS
                   if k not in spans[-1] and k != "parent"]
        if missing:                 # a None parent is left out
            errors.append((TRACING_PATH,
                           f"round span event lacks declared SPAN_FIELDS "
                           f"{missing}: {sorted(spans[-1])}"))
        if tr.spans != 1:
            errors.append((TRACING_PATH, f"Tracer.spans counted {tr.spans} "
                                         f"after one emitted span"))
    import time
    tm2 = _tm(telemetry, rank=1)
    rnd = tracing.Tracer(telemetry_=tm2).begin("round", island=1)
    sid = tracing.new_span_id()
    tracing.emit_wire_span(tm2, rnd.ctx(), "push", span=sid, t0=rnd.t0,
                           dt=0.01, q=0.002, a=0.003)
    srv_ctx = {"t": rnd.trace, "s": sid}
    tracing.emit_server_span(tm2, srv_ctx, "push", t0=rnd.t0, dt=0.006,
                             q=0.002, a=0.003, island=1)
    tracing.emit_server_span(tm2, srv_ctx, "push", t0=rnd.t0, dt=0.0001,
                             island=1, dedup=True)
    time.sleep(0.015)           # the round outlasts its wire op's 10 ms
    rnd.end(outcome="exchanged")
    if telemetry_report is not None:
        assemble = getattr(telemetry_report, "assemble_traces", None)
        if assemble is None:
            errors.append((REPORT_PATH,
                           "telemetry_report has no assemble_traces — span "
                           "events would be emitted but never "
                           "joined/rendered"))
        else:
            traces = assemble(tm2.tail(8))
            if len(traces) != 1:
                errors.append((REPORT_PATH,
                               f"trace assembly built {len(traces)} round(s) "
                               f"from one emitted round"))
            else:
                t = traces[0]
                if t["joined"] != 1 or t["dedup_twins"] != 1:
                    errors.append((REPORT_PATH,
                                   f"client span did not join exactly one "
                                   f"applied server span with one dedup twin "
                                   f"(joined={t['joined']}, "
                                   f"twins={t['dedup_twins']})"))
                total = sum(t["components"].values())
                if abs(total - t["dt"]) > max(0.05 * t["dt"], 1e-6):
                    errors.append((REPORT_PATH,
                                   f"critical-path components sum "
                                   f"{total:.6f} != round dt {t['dt']:.6f}"))
                if set(t["components"]) != set(tracing.COMPONENTS):
                    errors.append((REPORT_PATH,
                                   f"component vocabulary "
                                   f"{sorted(t['components'])} != "
                                   f"tracing.COMPONENTS "
                                   f"{sorted(tracing.COMPONENTS)}"))
        comps = getattr(telemetry_report, "TRACE_COMPONENTS", ())
        if tuple(comps) != tuple(tracing.COMPONENTS):
            errors.append((REPORT_PATH,
                           f"TRACE_COMPONENTS {tuple(comps)!r} != "
                           f"tracing.COMPONENTS {tuple(tracing.COMPONENTS)!r}"))
        errors += _missing_tracked(
            telemetry_report, {tracing.SPAN_EVENT, tracing.STATUSZ_EVENT},
            "TRACKED_EVENTS is missing tracing event kind(s) {} — "
            "spans/statusz would be silently dropped from report and trace")
    with tempfile.TemporaryDirectory() as d:
        tm3 = _tm(telemetry)
        sz = tracing.StatuszServer("probe", ident=0, run_dir=d,
                                   telemetry_=tm3, tracer_=tr)
        try:
            host, port = sz.start()
            docs = tracing.read_statusz_docs(d)
            if len(docs) != 1 or docs[0].get("port") != port:
                errors.append((TRACING_PATH,
                               f"statusz discovery doc missing/wrong under "
                               f"{d}: {docs}"))
            rep = tracing.statusz_query(f"{host}:{port}", "health")
            missing = [k for k in tracing.STATUSZ_FIELDS if k not in rep]
            if missing:
                errors.append((TRACING_PATH,
                               f"statusz health reply lacks declared "
                               f"STATUSZ_FIELDS {missing}: {sorted(rep)}"))
            evs = tracing.statusz_query(f"{host}:{port}", "events", n=4)
            if not evs.get("ok") or "events" not in evs:
                errors.append((TRACING_PATH,
                               "statusz events op returned no event list"))
            sz_evs = [e for e in tm3.tail(4)
                      if e["ev"] == tracing.STATUSZ_EVENT]
            if not sz_evs or "addr" not in sz_evs[-1]:
                errors.append((TRACING_PATH,
                               f"statusz start emitted no "
                               f"{tracing.STATUSZ_EVENT!r} event with an "
                               f"addr"))
        except Exception as e:
            errors.append((TRACING_PATH, f"live statusz probe failed: {e!r}"))
        finally:
            sz.stop()
        if tracing.read_statusz_docs(d):
            errors.append((TRACING_PATH,
                           "statusz stop() left its discovery doc behind — "
                           "the fleet dialer would list a ghost"))
    return errors


def fleetmon_schema_errors(fleetmon, membership, telemetry,
                           telemetry_report=None) -> List[tuple]:
    """The stock rules pass their validator and the alert audit's
    coverage names real rules; a breach fires exactly one complete
    ``alert`` event and does not re-fire while it lasts; an alert's
    demotion cites its rule; the exposition covers every series."""
    errors: List[tuple] = []
    if fleetmon is None:
        return errors
    try:
        fleetmon.validate_rules(fleetmon.DEFAULT_RULES)
        full = fleetmon.validate_rules(fleetmon.default_rules(
            step_p99_s=1.0, hbm_headroom_bytes=1.0, divergence=1.0))
    except ValueError as e:
        errors.append((FLEETMON_PATH,
                       f"the stock rule set fails its own validator: {e}"))
        full = []
    names = {r["name"] for r in full}
    for kind, cover in fleetmon.FAULT_ALERT_COVERAGE.items():
        missing = sorted(set(cover) - names)
        if missing:
            errors.append((FLEETMON_PATH,
                           f"FAULT_ALERT_COVERAGE[{kind!r}] names rule(s) "
                           f"{missing} absent from default_rules(...) — the "
                           f"alert-audit for that fault kind is vacuously "
                           f"uncovered"))
    tm = _tm(telemetry)
    rules = [{"name": "probe_rule", "series": "step_p99",
              "predicate": "threshold", "op": ">", "value": 1.0,
              "scope": "rank"}]
    col = fleetmon.FleetCollector(rules=rules, telemetry_=tm)
    col.ingest({"step_p99": 5.0}, rank=3)
    first = col.evaluate()
    col.ingest({"step_p99": 6.0}, rank=3)
    second = col.evaluate()
    evs = [e for e in tm.tail(8) if e["ev"] == fleetmon.ALERT_EVENT]
    if len(first) != 1 or len(evs) != 1:
        errors.append((FLEETMON_PATH,
                       f"one breaching sample fired {len(first)} alert(s) / "
                       f"{len(evs)} event(s) — expected exactly 1"))
    elif second:
        errors.append((FLEETMON_PATH,
                       "a persisting breach RE-fired on the next evaluation "
                       "— the no-flapping episode contract is broken"))
    else:
        missing = [k for k in ("rule", "series", "worker", "value",
                               "threshold") if k not in evs[-1]]
        if missing:
            errors.append((FLEETMON_PATH,
                           f"alert event lacks field(s) {missing}: "
                           f"{sorted(evs[-1])}"))
    if membership is not None:
        tm2 = _tm(telemetry)
        ctl = membership.MembershipController(telemetry_=tm2)
        ctl.join(1, pid=1)
        ctl.join(2, pid=2)
        alert = {"rule": "probe_rule", "series": "step_p99", "rank": 1,
                 "value": 5.0, "threshold": 1.0, "action": "demote"}
        if not fleetmon.apply_alert(ctl, alert):
            errors.append((FLEETMON_PATH,
                           "apply_alert did not demote a live worker"))
        else:
            demotes = [e for e in tm2.tail(8) if e["ev"] == "worker_demote"]
            if not demotes or demotes[-1].get("rule") != "probe_rule":
                errors.append((FLEETMON_PATH,
                               f"alert-driven worker_demote does not cite the "
                               f"firing rule: "
                               f"{demotes[-1] if demotes else None}"))
            elif demotes[-1]["rule"] not in {r["name"] for r in col.rules}:
                errors.append((FLEETMON_PATH,
                               f"demote cites rule {demotes[-1]['rule']!r} "
                               f"that exists in no active rule set"))
    col2 = fleetmon.FleetCollector(rules=[], telemetry_=telemetry.DISABLED)
    col2.ingest({k: 1.0 for k in fleetmon.METRIC_FIELDS}, rank=0)
    text = col2.expose_text()
    missing = [s for s in fleetmon.FLEET_SERIES
               if ("theanompi_" + s) not in text]
    if missing:
        errors.append((FLEETMON_PATH,
                       f"expose_text() omits registered fleet series "
                       f"{missing} — a scrape would silently miss them"))
    errors += _missing_tracked(
        telemetry_report, fleetmon.ALERT_EVENTS,
        "TRACKED_EVENTS is missing fleet-health event kind(s) {} — alerts "
        "would be dropped from report and Perfetto export")
    return errors


def numerics_schema_errors(numerics, sentry, fleetmon, telemetry,
                           telemetry_report=None) -> List[tuple]:
    """The numerics plane's host half: its sentry kinds are declared
    anomaly kinds; ``record(example_report())`` sets every declared gauge
    and histogram and emits one event; a live sentry fed an overflow raises
    ``grad_overflow``; fleetmon's snapshot carries the beacon series."""
    errors: List[tuple] = []
    if numerics is None:
        return errors
    if sentry is not None:
        missing = sorted(set(numerics.SENTRY_KINDS) - set(sentry.ANOMALY_KINDS))
        if missing:
            errors.append((NUMERICS_PATH,
                           f"numerics SENTRY_KINDS {missing} absent from "
                           f"sentry.ANOMALY_KINDS — the detectors would raise "
                           f"undeclared anomalies"))
    tm = _tm(telemetry)
    numerics.record(tm, numerics.example_report(), rank=0)
    missing = sorted(set(numerics.NUMERICS_GAUGES) - set(tm.gauges))
    if missing:
        errors.append((NUMERICS_PATH,
                       f"record(example_report()) never set declared "
                       f"gauge(s) {missing}"))
    missing = sorted(set(numerics.NUMERICS_HISTOGRAMS) - set(tm.hists))
    if missing:
        errors.append((NUMERICS_PATH,
                       f"record(example_report()) never observed declared "
                       f"histogram(s) {missing}"))
    evs = [e for e in tm.tail(4) if e["ev"] == numerics.NUMERICS_EVENT]
    if len(evs) != 1:
        errors.append((NUMERICS_PATH,
                       f"record(example_report()) emitted {len(evs)} "
                       f"{numerics.NUMERICS_EVENT!r} event(s) — expected "
                       f"exactly 1"))
    if sentry is not None:
        tm2 = _tm(telemetry)
        bad = dict(numerics.example_report(), nonfinite=4.0)
        kind = sentry.TrainingSentry({"verbose": False},
                                     telemetry=tm2).observe_numerics(bad)
        if kind != "grad_overflow" or not [
                e for e in tm2.tail(4) if e["ev"] == sentry.ANOMALY_EVENT]:
            errors.append((SENTRY_PATH,
                           f"an overflowing numerics report did not raise a "
                           f"live grad_overflow anomaly (got {kind!r})"))
    if fleetmon is not None:
        missing = sorted({"grad_norm", "divergence"} -
                         set(fleetmon.METRIC_FIELDS))
        if missing:
            errors.append((FLEETMON_PATH,
                           f"METRIC_FIELDS is missing numerics series "
                           f"{missing} — the replica_divergence rule would "
                           f"read an unregistered series"))
    if telemetry_report is not None:
        errors += _missing_tracked(
            telemetry_report, {numerics.NUMERICS_EVENT},
            "TRACKED_EVENTS is missing {} — numerics reports would be "
            "dropped from the report")
        counters = set(getattr(telemetry_report, "TRACE_COUNTER_KEYS", ()))
        missing = sorted({"numerics.grad_norm", "numerics.divergence"} -
                         counters)
        if missing:
            errors.append((REPORT_PATH,
                           f"TRACE_COUNTER_KEYS is missing numerics key(s) "
                           f"{missing} — the Perfetto export would drop the "
                           f"counter tracks"))
    return errors


def compile_cache_schema_errors(compile_cache, telemetry) -> List[tuple]:
    """The kernel-library cache: its key is a function of the source, the
    flags and the toolkit alone (the same inputs give the same key, each
    changed input another), and every rung of its fallback ladder that it
    counts is mirrored into the registry as ``compile_cache.<rung>``."""
    errors: List[tuple] = []
    if compile_cache is None:
        return errors
    key = compile_cache.library_key
    base = key(b"src", ("-O3",), "V12.8")
    if base != key(b"src", ("-O3",), "V12.8"):
        errors.append((COMPILE_CACHE_PATH,
                       "library_key is not deterministic — every load would "
                       "miss"))
    if len({base, key(b"src2", ("-O3",), "V12.8"),
            key(b"src", ("-O2",), "V12.8"),
            key(b"src", ("-O3",), "V12.9")}) != 4:
        errors.append((COMPILE_CACHE_PATH,
                       "library_key ignores the source, the flags or the "
                       "toolkit — a stale library would hit"))
    # the ladder ticks the process registry: this one, for the probe
    prev, tm = telemetry._ACTIVE, _tm(telemetry)
    telemetry._ACTIVE = tm
    try:
        cache = compile_cache.CompileCache(None, enabled=False)
        for kind in cache.counters:
            cache._tick(kind)
    finally:
        telemetry._ACTIVE = prev
    want = {"compile_cache." + k for k in cache.counters}
    if set(tm.counters) != want:
        errors.append((COMPILE_CACHE_PATH,
                       f"the ladder counters {sorted(cache.counters)} reach "
                       f"the registry as {sorted(tm.counters)} != "
                       f"{sorted(want)}"))
    return errors


def thread_role_coverage_errors(root: Optional[str] = None) -> List[tuple]:
    """Every ``threading.Thread``/``Timer`` in ``membership.py`` and
    ``chaos.py`` is a spawn site of the engine and resolves to its entry
    function, on an index of those two files alone: a spawn the engine
    cannot resolve escapes the host-concurrency pass."""
    import ast

    from ..core import SourceFile
    from ..engine import ProgramIndex
    root = root or _ROOT
    files = []
    for rel in (MEMBERSHIP_PATH, CHAOS_PATH):
        if os.path.exists(os.path.join(root, rel)):
            try:
                files.append(SourceFile(root, rel))
            except SyntaxError:
                continue           # the parse step reports it
    if not files:
        return []
    index = ProgramIndex(files)
    sites = {(s.path, s.line): s for s in index.spawn_sites()
             if s.kind in ("thread", "timer")}
    errors: List[tuple] = []
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or sf.resolver.resolve(
                    node.func) not in ("threading.Thread", "threading.Timer"):
                continue
            site = sites.get((sf.path, node.lineno))
            if site is None:
                errors.append((sf.path,
                               f"thread spawn at line {node.lineno} is "
                               f"invisible to the thread-role map "
                               f"(engine.spawn_sites) — the host-concurrency "
                               f"pass cannot analyze it"))
            elif not site.entries:
                errors.append((sf.path,
                               f"thread spawn at line {node.lineno} (target "
                               f"`{site.target_desc}`) does not resolve to an "
                               f"entry function — its thread role is empty "
                               f"and its body escapes the race analysis"))
    return errors


def center_protocol_errors(center_server, root: Optional[str] = None
                           ) -> List[tuple]:
    """The center's op table read out of ``center_server.py`` equals the
    ops the static client table sees and the ops a live ``RemoteCenter``
    sends when each of its public calls is driven against a stub wire that
    keeps the header and stops there."""
    from .. import protocol
    from ..core import SourceFile
    from ..engine import ProgramIndex
    root = root or _ROOT
    if not os.path.exists(os.path.join(root, CENTER_PATH)):
        return []
    try:
        sf = SourceFile(root, CENTER_PATH)
    except SyntaxError:
        return []               # the parse step reports it
    index = ProgramIndex([sf])
    spec = next(s for s in protocol.ENDPOINTS if s.name == "center")
    table = protocol.server_op_table(index, spec)
    if table is None:
        return [(CENTER_PATH,
                 "the center op table could not be extracted (dispatch "
                 "function missing?) — the protocol checkers are blind to "
                 "this endpoint")]
    errors: List[tuple] = []

    class _Captured(Exception):
        pass

    sent: set = set()

    class _WireStub:
        def request(self, header, body=b"", trace=None):
            sent.add(header.get("op"))
            raise _Captured()

        def close(self):
            pass

    rc = center_server.RemoteCenter("127.0.0.1:9")
    rc._wire.close()
    rc._wire = _WireStub()
    surface = (("ensure_init_leaves", ([],)), ("pull_leaves", ()),
               ("push_delta_leaves", ([], 0)), ("push_pull_leaves", ([], 0)),
               ("demote_island", (0,)), ("readmit_island", (0,)),
               ("stats", ()))
    for method, args in surface:
        try:
            getattr(rc, method)(*args)
        except _Captured:
            continue
        except Exception as e:
            errors.append((CENTER_PATH,
                           f"RemoteCenter.{method} failed before reaching the "
                           f"wire ({e!r}) — the runtime surface probe cannot "
                           f"see its op"))
    if sent != set(table):
        errors.append((CENTER_PATH,
                       f"a live RemoteCenter sends ops {sorted(sent)} != the "
                       f"extracted center dispatch table {sorted(table)} — "
                       f"static protocol view drifted from the runtime "
                       f"surface (or this probe's own `surface` list in "
                       f"center_protocol_errors is stale: extend it when "
                       f"adding an op)"))
    static_client = set(protocol.client_op_table(index, spec))
    if static_client != set(table):
        errors.append((CENTER_PATH,
                       f"the static client op table {sorted(static_client)} "
                       f"!= the extracted dispatch table {sorted(table)} — "
                       f"the wire-contract checker should have caught this; "
                       f"its extraction rules drifted"))
    return errors


def load_report(root: Optional[str] = None):
    """``scripts/telemetry_report.py`` loaded by file path (stdlib), or
    None when it is absent or broken (its checks are then skipped)."""
    path = os.path.join(root or _ROOT, REPORT_PATH)
    if not os.path.exists(path):
        return None
    try:
        spec = importlib.util.spec_from_file_location(
            "_tpulint_torch_telemetry_report", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception:
        return None
    return mod


def _optional(name: str):
    """A port module by import, or None when it cannot be imported (a
    partial tree)."""
    try:
        return importlib.import_module(f"theanompi_tpu_torch.{name}")
    except ImportError:
        return None


@register
class SchemaDriftChecker(Checker):
    name = "schema-drift"
    description = ("recorder.SECTIONS / print_train_info record keys / "
                   "telemetry phase events must derive from telemetry."
                   "PHASES; device.* gauges, sentry anomaly schema, wire, "
                   "tracing, fleetmon, numerics and compile-cache "
                   "vocabularies must match their declarations "
                   "(live-object probe)")
    reads_files = False    # a run of this probe alone parses nothing
    # what the probes load beyond the files of the run: it keys the
    # result cache of partial runs
    disk_scoped = (RECORDER_PATH, TELEMETRY_PATH, DEVPROF_PATH, SENTRY_PATH,
                   REPORT_PATH, MEMBERSHIP_PATH, CHAOS_PATH, WIRE_PATH,
                   TRACING_PATH, FLEETMON_PATH, CENTER_PATH, NUMERICS_PATH,
                   COMPILE_CACHE_PATH)

    def check_project(self, files):
        from theanompi_tpu_torch.utils import recorder, telemetry
        report = load_report()
        devprof, sentry = _optional("utils.devprof"), _optional("utils.sentry")
        membership = _optional("parallel.membership")
        chaos = _optional("utils.chaos")
        wire = _optional("parallel.wire")
        fleetmon = _optional("utils.fleetmon")
        errors = live_drift_errors(recorder, telemetry)
        if devprof is not None and sentry is not None:
            errors += device_schema_errors(devprof, sentry, telemetry, report)
        errors += membership_schema_errors(membership, chaos, telemetry, report)
        errors += wire_schema_errors(wire, membership, telemetry, report)
        errors += tracing_schema_errors(_optional("utils.tracing"), telemetry,
                                        report)
        errors += fleetmon_schema_errors(fleetmon, membership, telemetry,
                                         report)
        errors += numerics_schema_errors(_optional("utils.numerics"), sentry,
                                         fleetmon, telemetry, report)
        errors += compile_cache_schema_errors(
            _optional("utils.compile_cache"), telemetry)
        center_server = _optional("parallel.center_server")
        if center_server is not None:
            errors += center_protocol_errors(center_server)
        errors += thread_role_coverage_errors()
        return [Finding(self.name, path, 1, 0, msg) for path, msg in errors]
