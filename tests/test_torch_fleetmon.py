"""The port's fleet monitor (``theanompi_tpu_torch/utils/fleetmon.py``)
against the JAX package's ``utils/fleetmon.py``.

* The rule grammar: ``validate_rules`` refuses the same rule documents
  with the same message; the vocabularies and ``default_rules`` agree.
* The collector: one scripted sample stream, on one virtual clock, goes
  into the JAX ``FleetCollector`` and the port's, for every predicate of
  ``RULE_PREDICATES`` and for the derived ``heartbeat_age_s``: the alerts
  of every evaluation, the exposition and the ``snapshot()`` documents
  are equal, and each package's snapshot restores into the other's
  collector, which then evaluates as the first did.
* The emission side: ``snapshot_from_telemetry`` of the same registry
  contents, ``emit_alert``, ``apply_alert``, ``alert_deadline_s`` and
  ``audit_alerts`` give equal results.
* The wire: a port ``MetricStreamer`` feeds a JAX ``FleetMonServer`` and a
  JAX streamer the port's server; a retried snapshot (its token again)
  lands once; a server restarts from its snapshot, of either package; the
  server's ops (series, rollup, alerts, exposition, statusz health).
* The live audit: three port streamers over real sockets, a stop-shaped
  and a delay-shaped fault, each matched to its alert by ``audit_alerts``.

The supervisor's alert tick is in ``test_torch_membership.py``.
"""

import json
import os
import socket
import time

import pytest

from theanompi_tpu.parallel import wire as JW
from theanompi_tpu.utils import fleetmon as JF
from theanompi_tpu.utils import telemetry as JT
from theanompi_tpu_torch.parallel import wire as TW
from theanompi_tpu_torch.utils import chaos
from theanompi_tpu_torch.utils import fleetmon as TF
from theanompi_tpu_torch.utils import telemetry as TT
from theanompi_tpu_torch.utils import tracing
from theanompi_tpu_torch.utils.clock import Clock

PKGS = {"jax": (JF, JT, JW), "torch": (TF, TT, TW)}


class VClock(Clock):
    """A virtual clock: time moves only when the test advances it."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


def _rule(**kw):
    base = {"name": "r", "series": "step_p99", "predicate": "threshold",
            "op": ">", "value": 1.0, "scope": "rank"}
    base.update(kw)
    return base


# -- the rule grammar -----------------------------------------------------------

def test_vocabularies_and_default_rules_agree():
    for name in ("METRICS_OP", "ALERT_EVENT", "METRIC_FIELDS",
                 "DERIVED_SERIES", "FLEET_SERIES", "FLEETMON_COUNTERS",
                 "RULE_PREDICATES", "RULE_OPS", "RULE_SCOPES",
                 "RULE_ACTIONS", "RULE_KEYS", "FAULT_ALERT_COVERAGE",
                 "DEFAULT_RULES"):
        assert getattr(TF, name) == getattr(JF, name), name
    for kw in ({}, {"step_p99_s": 0.5, "hbm_headroom_bytes": 1e9},
               {"heartbeat_s": 3.0, "divergence": 10.0,
                "wire_retry_rate": 0.2, "wire_window_s": 2.0}):
        assert TF.default_rules(**kw) == JF.default_rules(**kw)
        TF.validate_rules(TF.default_rules(**kw))


BAD_RULES = [
    (_rule(predicate="nope"), "predicate"),
    (_rule(series="nope"), "series"),
    (_rule(op="!="), "op"),
    (_rule(bogus_key=1), "unknown key"),
    (_rule(predicate="sustained"), "window_s"),
    (_rule(predicate="rate_of_change", window_s=0), "window_s"),
    (_rule(predicate="fleet_quantile", quantile=7.0), "quantile"),
    (_rule(action="explode"), "action"),
    (_rule(scope="galaxy"), "scope"),
    ({"name": "v", "series": "step_p99", "predicate": "threshold"}, "value"),
    ({"series": "step_p99"}, "name"),
]


@pytest.mark.parametrize("bad,msg", BAD_RULES,
                         ids=[m.replace(" ", "_") for _, m in BAD_RULES])
def test_validate_rules_refuses_what_the_jax_package_refuses(bad, msg):
    errs = []
    for mod in (JF, TF):
        with pytest.raises(ValueError, match=msg) as e:
            mod.validate_rules([bad])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_duplicate_rule_names_are_refused_alike():
    errs = []
    for mod in (JF, TF):
        with pytest.raises(ValueError, match="duplicate") as e:
            mod.validate_rules([_rule(), _rule()])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the collector: one stream, one clock, both packages --------------------------

# each stream: its rules and a script of ("in", rank, sample[, status
# [, role]]), ("adv", seconds) and ("eval",) steps
STREAMS = {
    "threshold": (
        [_rule()],
        [("in", 1, {"step_p99": 3.0}), ("eval",)]
        + [s for _ in range(4) for s in (("adv", 1.0),
                                         ("in", 1, {"step_p99": 3.0}),
                                         ("eval",))]
        + [("adv", 1.0), ("in", 1, {"step_p99": 0.1}), ("eval",),
           ("adv", 1.0), ("in", 1, {"step_p99": 9.0}), ("eval",),
           ("in", 2, {"step_p99": 0.5, "img_s": 12.5}), ("eval",)]),
    "sustained": (
        [_rule(predicate="sustained", window_s=5.0)],
        [s for _ in range(4) for s in (("in", 1, {"step_p99": 3.0}),
                                       ("eval",), ("adv", 1.0))]
        + [("in", 1, {"step_p99": 0.5}), ("eval",)]
        + [s for _ in range(7) for s in (("adv", 1.0),
                                         ("in", 1, {"step_p99": 3.0}),
                                         ("eval",))]),
    "rate_of_change": (
        [{"name": "wire_degraded", "series": "wire_retries",
          "predicate": "rate_of_change", "op": ">", "value": 0.5,
          "window_s": 4.0, "scope": "rank", "roles": ("worker",)}],
        [s for v in (0, 0, 0, 0, 0) for s in (
            ("in", 2, {"wire_retries": float(v), "wire_rtt_p50": 0.01}),
            ("eval",), ("adv", 1.0))]
        + [s for v in (3, 6, 9) for s in (
            ("in", 2, {"wire_retries": float(v)}), ("adv", 1.0))]
        + [("eval",)]
        + [s for _ in range(6) for s in (("adv", 1.0),
                                         ("in", 2, {"wire_retries": 9.0}),
                                         ("eval",))]
        + [s for v in (12, 15, 18) for s in (
            ("adv", 1.0), ("in", 2, {"wire_retries": float(v)}),
            ("eval",))]),
    "fleet_quantile": (
        [{"name": "queue_starved", "series": "queue_depth",
          "predicate": "fleet_quantile", "quantile": 0.5, "op": "<",
          "value": 1.0, "scope": "fleet", "action": "flight_dump",
          "roles": ("worker",)}],
        [("in", 1, {"queue_depth": 0.0}), ("eval",),
         ("in", 2, {"queue_depth": 0.0}),
         ("in", 3, {"queue_depth": 4.0}),
         ("in", -1, {"queue_depth": 9.0}, "live", "center"), ("eval",),
         ("adv", 1.0), ("eval",),
         ("in", 1, {"queue_depth": 5.0}), ("in", 2, {"queue_depth": 6.0}),
         ("eval",), ("adv", 1.0),
         ("in", 2, {"queue_depth": 0.0}), ("in", 3, {"queue_depth": 0.0}),
         ("eval",)]),
    "heartbeat_age_s": (
        [{"name": "heartbeat_lost", "series": "heartbeat_age_s",
          "predicate": "threshold", "op": ">", "value": 5.0,
          "scope": "rank", "action": "demote", "roles": ("worker",)}],
        [("in", 1, {"steps": 1.0}), ("in", 2, {"steps": 1.0}, "left"),
         ("in", -1, {"steps": 3.0}, "live", "center"),
         ("adv", 10.0), ("eval",), ("adv", 1.0), ("eval",),
         ("in", 1, {"steps": 2.0}), ("eval",),
         ("in", 2, {"steps": 0.0}), ("adv", 6.0), ("eval",)]),
}


def _collectors(rules, clk):
    return [mod.FleetCollector(rules=rules, clock=clk,
                               telemetry_=tmod.DISABLED)
            for mod, tmod, _ in (PKGS["jax"], PKGS["torch"])]


def _drive(cols, clk, script):
    """Run ``script`` on every collector in lockstep; the alerts each
    evaluation fired, by collector."""
    fired = [[] for _ in cols]
    for step in script:
        if step[0] == "adv":
            clk.t += step[1]
        elif step[0] == "in":
            rank, sample = step[1], step[2]
            status = step[3] if len(step) > 3 else "live"
            role = step[4] if len(step) > 4 else "worker"
            for c in cols:
                c.ingest(dict(sample), rank=rank, role=role, status=status)
        else:
            for f, c in zip(fired, cols):
                f.append(c.evaluate())
    return fired


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_collector_matches_the_jax_package_on_one_stream(stream):
    """Every evaluation's alerts, the exposition, the rollups, the status,
    the action queue and the snapshot document are the JAX package's."""
    rules, script = STREAMS[stream]
    clk = VClock()
    jc, tc = _collectors(rules, clk)
    fired = _drive([jc, tc], clk, script)
    assert fired[0] == fired[1]
    assert sum(map(len, fired[1])) >= 1, fired      # the rule did fire
    assert tc.alerts == jc.alerts
    assert tc.expose_text() == jc.expose_text()
    for series in ("step_p99", "queue_depth", "heartbeat_age_s"):
        assert tc.fleet_rollup(series) == jc.fleet_rollup(series)
    assert tc.status() == jc.status()
    assert tc.pop_actions() == jc.pop_actions()
    assert json.loads(json.dumps(tc.snapshot())) == \
        json.loads(json.dumps(jc.snapshot()))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_collector_snapshots_restore_across_packages(stream, writer, reader):
    """Half the stream into ``writer``'s collector, its snapshot (through
    JSON, as on disk) into a fresh collector of ``reader``'s and of
    ``writer``'s package; the second half into both: the same alerts (a
    firing episode does not fire again after the restore) and the same
    snapshot at the end."""
    rules, script = STREAMS[stream]
    half = len(script) // 2
    clk = VClock()
    first = PKGS[writer][0].FleetCollector(rules=rules, clock=clk,
                                           telemetry_=PKGS[writer][1].DISABLED)
    _drive([first], clk, script[:half])
    snap = json.loads(json.dumps(first.snapshot()))
    cols = []
    for pkg in (writer, reader):
        c = PKGS[pkg][0].FleetCollector(rules=rules, clock=clk,
                                        telemetry_=PKGS[pkg][1].DISABLED)
        c.restore(snap)
        assert json.loads(json.dumps(c.snapshot())) == snap
        cols.append(c)
    fired = _drive(cols, clk, script[half:])
    assert fired[0] == fired[1]
    assert cols[0].alerts == cols[1].alerts
    assert cols[0].expose_text() == cols[1].expose_text()
    assert json.loads(json.dumps(cols[0].snapshot())) == \
        json.loads(json.dumps(cols[1].snapshot()))


def test_threshold_episode_fires_once_until_clear():
    """The no-flapping contract on the port alone, as the JAX package's
    test states it."""
    clk = VClock()
    col = TF.FleetCollector(rules=[_rule()], clock=clk,
                            telemetry_=TT.DISABLED)
    col.ingest({"step_p99": 3.0}, rank=1)
    assert len(col.evaluate()) == 1
    for _ in range(5):
        clk.t += 1.0
        col.ingest({"step_p99": 3.0}, rank=1)
        assert col.evaluate() == []
    clk.t += 1.0
    col.ingest({"step_p99": 0.1}, rank=1)
    assert col.evaluate() == []
    clk.t += 1.0
    col.ingest({"step_p99": 9.0}, rank=1)
    fired = col.evaluate()
    assert len(fired) == 1 and fired[0]["value"] == 9.0
    assert len(col.alerts) == 2


def test_exposition_covers_every_series():
    clk = VClock()
    col = TF.FleetCollector(rules=[_rule()], clock=clk,
                            telemetry_=TT.DISABLED)
    col.ingest({k: 1.0 for k in TF.METRIC_FIELDS}, rank=0)
    col.ingest({"step_p99": 7.0}, rank=1)
    assert len(col.evaluate()) == 1
    text = col.expose_text()
    for name in TF.FLEET_SERIES:
        assert f"# TYPE theanompi_{name} gauge" in text, name
    assert "theanompi_fleet_alerts_total 1" in text
    assert "theanompi_fleet_ranks 2" in text


# -- the emission side ------------------------------------------------------------

def _fill(tm):
    for v in (0.1, 0.2, 0.3, 0.25):
        tm.observe("phase.train", v)
        tm.observe("wire.rtt", v / 10)
    tm.gauge("images_per_sec", 123.0)
    tm.gauge("hbm_min_headroom_bytes", 1e9)
    tm.gauge("prefetch.queue_depth", 2.0)
    tm.gauge("wire.outage_s", 0.5)
    tm.gauge("heartbeat.iter", 17.0)
    tm.gauge("numerics.grad_norm", 3.5)
    tm.gauge("numerics.divergence", 0.25)
    tm.counter("wire.retry", 3)


def test_snapshot_from_telemetry_matches_the_jax_package():
    assert TF.snapshot_from_telemetry(TT.DISABLED) == {} == \
        JF.snapshot_from_telemetry(JT.DISABLED)
    jt = JT.Telemetry(rank=0, run_id="snap")
    tt = TT.Telemetry(rank=0, run_id="snap")
    try:
        _fill(jt)
        _fill(tt)
        snap = TF.snapshot_from_telemetry(tt, steps=20, bogus=1.0)
        assert snap == JF.snapshot_from_telemetry(jt, steps=20, bogus=1.0)
        assert snap["img_s"] == 123.0 and snap["steps"] == 20.0
        assert snap["hbm_headroom_bytes"] == 1e9
        assert snap["wire_retries"] == 3.0 and snap["divergence"] == 0.25
        assert 0.1 <= snap["step_p50"] <= snap["step_p99"] <= 0.3
        assert set(snap) <= set(TF.METRIC_FIELDS)
        # a registry with a wire client but no retry counter still sends
        # the cumulative series (the rate rule's baseline)
        t2 = TT.Telemetry(rank=0, run_id="snap2")
        t2.observe("wire.rtt", 0.01)
        assert TF.snapshot_from_telemetry(t2)["wire_retries"] == 0.0
        t2.close()
    finally:
        jt.close()
        tt.close()


def test_alert_events_carry_the_jax_schema():
    """An alert's telemetry event: the same fields as the JAX package's,
    through the one emitter."""
    evs = []
    for mod, tmod, _ in (PKGS["jax"], PKGS["torch"]):
        tm = tmod.Telemetry(rank=0, run_id="alerts")
        col = mod.FleetCollector(rules=[_rule(action="demote")],
                                 telemetry_=tm, clock=VClock())
        col.ingest({"step_p99": 5.0}, rank=4)
        col.evaluate()
        ev = [e for e in tm.tail(8) if e["ev"] == mod.ALERT_EVENT]
        assert len(ev) == 1
        evs.append({k: v for k, v in ev[0].items() if k != "ts"})
        tm.close()
    assert evs[0] == evs[1]
    assert evs[1]["worker"] == 4 and evs[1]["rule"] == "r" and \
        evs[1]["threshold"] == 1.0 and evs[1]["action"] == "demote"


def test_apply_alert_and_audit_match_the_jax_package():
    class Ctl:
        def __init__(self):
            self.calls = []

        def demote(self, rank, **kw):
            self.calls.append((rank, kw))
            return True

    alerts = [{"rule": "heartbeat_lost", "series": "heartbeat_age_s",
               "rank": 3, "value": 12.0, "action": "demote", "ts": 105.0},
              {"rule": "queue_starved", "rank": None, "action": "flight_dump",
               "ts": 106.0},
              {"rule": "replica_divergence", "worker": 2, "rank": 0,
               "value": 99.0, "action": "flight_dump", "ts": 103.0}]
    got = []
    for mod in (JF, TF):
        ctl = Ctl()
        got.append(([mod.apply_alert(ctl, a) for a in alerts], ctl.calls))
    assert got[0] == got[1]
    assert got[1][0] == [True, False, False]
    rules = JF.default_rules(heartbeat_s=10.0, step_p99_s=1.0,
                             divergence=10.0)
    realized = [{"ts": 100.0, "kind": "stop", "target": 3, "duration": 2.0},
                {"ts": 100.0, "kind": "corrupt", "target": 2},
                {"ts": 100.0, "kind": "delay", "target": 1, "duration": 1.0},
                {"ts": 100.0, "kind": "net_dup", "target": -1},
                {"ts": 100.0, "kind": "kill", "target": 1, "error": "no-pid"}]
    for interval in (1.0, 4.0):
        a = JF.audit_alerts(alerts, realized, rules, 0.5, interval)
        b = TF.audit_alerts(alerts, realized, rules, 0.5, interval)
        assert a == b
    ok, lines = b
    assert not ok                          # the delay raised no alert
    assert any("ALERT-AUDIT FAIL: delay" in ln for ln in lines)
    assert any("corrupt on w2 -> replica_divergence" in ln for ln in lines)
    for r in rules:
        assert TF.alert_deadline_s(r, 2.0, 0.5, 1.0) == \
            JF.alert_deadline_s(r, 2.0, 0.5, 1.0)


# -- the wire ------------------------------------------------------------------------

def _retry_twice(host, port, wmod, rank=9):
    """One snapshot frame sent twice with one token: both acked, the
    second as a duplicate."""
    s = socket.create_connection((host, port))
    try:
        h = {"op": TF.METRICS_OP, "rank": rank, "role": "worker",
             "status": "live", "tok": {"w": f"w{rank}", "seq": 5}}
        body = json.dumps({"steps": 1.0}).encode()
        wmod.send_msg(s, h, body)
        first = wmod.recv_msg(s)[0]
        wmod.send_msg(s, h, body)
        second = wmod.recv_msg(s)[0]
    finally:
        s.close()
    assert first["ok"] and not first.get("dedup")
    assert second["ok"] and second.get("dedup") is True


@pytest.mark.parametrize("streamer,server", [("torch", "jax"),
                                             ("jax", "torch")])
def test_streamer_feeds_the_other_packages_server(streamer, server,
                                                  tmp_path):
    """A snapshot crosses between the packages on the wire; a retried one
    lands once; the server restarts on its port from its snapshot and the
    streamer's next send lands there."""
    SF, ST, SW = PKGS[streamer]
    VF, VT, VW = PKGS[server]
    d = str(tmp_path)
    kw = dict(rules=[_rule()], run_dir=d,
              snapshot_dir=os.path.join(d, "snap"), eval_window_s=0.1,
              telemetry_=VT.DISABLED)
    srv = VF.FleetMonServer(**kw)
    host, port = srv.start()
    tm = ST.Telemetry(rank=3, run_id="cross")
    try:
        tm.observe("phase.train", 2.0)
        tm.gauge("heartbeat.iter", 7.0)
        st = SF.MetricStreamer(f"{host}:{port}", rank=3, telemetry_=tm)
        assert st.push()
        _retry_twice(host, port, SW)
        assert srv.collector.samples_ingested == 2   # 3 sends, 2 lands
        ring = srv.collector.series[3]
        assert ring["step_p99"].latest()[1] == 2.0
        assert ring["steps"].latest()[1] == 7.0
        deadline = time.time() + 10
        while time.time() < deadline and not srv.collector.alerts:
            time.sleep(0.05)
        assert [a["rank"] for a in srv.collector.alerts] == [3]
        srv.stop(deregister=False)
        assert not st.push() and st.failed == 1
        srv2 = VF.FleetMonServer(**kw)
        srv2.start(port=port)
        try:
            assert srv2.collector.samples_ingested == 2
            assert len(srv2.collector.alerts) == 1
            _retry_twice(host, port, SW, rank=10)
            # the restored dedup marks: the old token is a duplicate
            s = socket.create_connection((host, port))
            SW.send_msg(s, {"op": TF.METRICS_OP, "rank": 9,
                            "tok": {"w": "w9", "seq": 5}},
                        json.dumps({"steps": 1.0}).encode())
            assert SW.recv_msg(s)[0].get("dedup") is True
            s.close()
            assert st.push()
            assert srv2.collector.samples_ingested == 4
        finally:
            srv2.stop()
        st.stop(final=False)
    finally:
        tm.close()
        srv.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_server_snapshot_restores_across_packages(writer, reader, tmp_path):
    """``fleetmon_state.json`` written by one package's server restores in
    the other's: the collector document and the dedup marks."""
    snap_dir = str(tmp_path)
    clk = VClock()
    col = PKGS[writer][0].FleetCollector(
        rules=[_rule()], clock=clk, telemetry_=PKGS[writer][1].DISABLED)
    _drive([col], clk, STREAMS["threshold"][1])
    srv = PKGS[writer][0].FleetMonServer(collector=col,
                                         snapshot_dir=snap_dir,
                                         telemetry_=PKGS[writer][1].DISABLED)
    srv.dedup.check({"w": "w4", "seq": 11}, TF.METRICS_OP)
    srv.dedup.record({"w": "w4", "seq": 11}, TF.METRICS_OP, {"ok": True})
    assert srv.snapshot() == os.path.join(snap_dir, "fleetmon_state.json")
    back = PKGS[reader][0].FleetMonServer(
        rules=[_rule()], snapshot_dir=snap_dir,
        telemetry_=PKGS[reader][1].DISABLED)
    assert back.restore() is True
    assert json.loads(json.dumps(back.collector.snapshot())) == \
        json.loads(json.dumps(col.snapshot()))
    assert back.dedup.check({"w": "w4", "seq": 11}, TF.METRICS_OP)[0]
    with open(os.path.join(snap_dir, "fleetmon_state.json"), "w") as f:
        f.write("{torn")
    assert PKGS[reader][0].FleetMonServer(
        snapshot_dir=snap_dir, telemetry_=PKGS[reader][1].DISABLED
    ).restore() is False


def test_server_ops_and_statusz_health(tmp_path):
    d = str(tmp_path)
    srv = TF.FleetMonServer(rules=[_rule()], run_dir=d, eval_window_s=0.1,
                            telemetry_=TT.DISABLED)
    host, port = srv.start()
    addr = f"{host}:{port}"
    tm = TT.Telemetry(rank=3, run_id="ops")
    try:
        tm.observe("phase.train", 2.0)
        st = TF.MetricStreamer(addr, rank=3, telemetry_=tm)
        assert st.push() and st.sent == 1
        # the discovery doc, as statusz registers one
        docs = tracing.read_statusz_docs(d)
        assert [(x["role"], x["port"]) for x in docs] == [("fleetmon", port)]
        c = TW.WireClient(addr, client_id="probe")
        resp, _ = c.request({"op": "series", "rank": 3,
                             "series": "step_p99"})
        assert resp["ok"] and len(resp["samples"]) == 1
        resp, _ = c.request({"op": "rollup", "series": "step_p99"})
        assert resp["rollup"]["n"] == 1 and resp["rollup"]["p50"] == 2.0
        resp, body = c.request({"op": "exposition"})

        def steady(text):                   # the heartbeat age moves on
            return [ln for ln in text.splitlines()
                    if not ln.startswith("theanompi_heartbeat_age_s")]
        assert resp["ok"] and \
            steady(body.decode()) == steady(srv.collector.expose_text())
        assert 'theanompi_step_p99{rank="3",role="worker"} 2' in \
            body.decode()
        deadline = time.time() + 10
        while time.time() < deadline and not srv.collector.alerts:
            time.sleep(0.05)
        resp, _ = c.request({"op": "alerts"})
        assert resp["alerts"] and resp["alerts"][0]["rule"] == "r"
        with pytest.raises(TW.RemoteOpError, match="unknown fleetmon op"):
            c.request({"op": "nope"})
        c.close()
        rep = tracing.statusz_query(addr, "health")
        assert rep["ok"] and rep["role"] == "fleetmon" and \
            rep["samples"] == 1 and rep["rules"] == ["r"]
        st.stop(final=True)                   # the `left` sample retires
        assert srv.collector.retired == {3}
    finally:
        tm.close()
        srv.stop()
    assert tracing.read_statusz_docs(d) == []


def test_live_alert_audit_stop_and_delay(tmp_path):
    """The port's machinery end to end, no subprocesses: three streamers
    over real sockets feed the collector; a stop-shaped fault (a streamer
    silenced) and a delay-shaped one (a rank's step histogram inflated)
    land per a chaos schedule, and ``audit_alerts`` matches each to its
    alert."""
    rules = [
        {"name": "heartbeat_lost", "series": "heartbeat_age_s",
         "predicate": "threshold", "op": ">", "value": 1.2,
         "scope": "rank", "action": "demote", "roles": ("worker",)},
        {"name": "step_time_degraded", "series": "step_p99",
         "predicate": "sustained", "op": ">", "value": 0.5,
         "window_s": 0.6, "scope": "rank", "roles": ("worker",)},
    ]
    tm0 = TT.Telemetry(rank=0, run_id="audit", stream_dir=str(tmp_path))
    srv = TF.FleetMonServer(rules=rules, eval_window_s=0.2, telemetry_=tm0)
    host, port = srv.start()
    addr = f"{host}:{port}"
    schedule = chaos.parse_schedule("stop@0.6:2:2.0,delay@0.6:3:1.5")
    tms, streamers = {}, {}
    try:
        for rank in (1, 2, 3):
            tms[rank] = TT.Telemetry(rank=rank, run_id="audit")
            tms[rank].observe("phase.train", 0.1)
            streamers[rank] = TF.MetricStreamer(
                addr, rank=rank, interval_s=0.2, telemetry_=tms[rank])
            streamers[rank].start()
        t0 = time.time()
        realized = []
        for f in schedule:
            time.sleep(max(0.0, t0 + f.at - time.time()))
            realized.append({"ts": time.time(), "kind": f.kind,
                             "target": f.target,
                             "duration": f.duration, "error": None})
            if f.kind == "stop":
                streamers[f.target]._halt.set()
                streamers[f.target].join(timeout=2)
            else:
                for _ in range(8):
                    tms[f.target].observe("phase.train", 2.0)
        time.sleep(2.6)
        streamers[2] = TF.MetricStreamer(
            addr, rank=2, interval_s=0.2, telemetry_=tms[2])
        streamers[2].start()
        time.sleep(0.6)
        alerts = list(srv.collector.alerts)
        ok, lines = TF.audit_alerts(alerts, realized, rules,
                                    eval_window_s=0.2, interval_s=0.2)
        assert ok, "\n".join(lines) + f"\nalerts: {alerts}"
        assert (ok, lines) == JF.audit_alerts(alerts, realized, rules,
                                              eval_window_s=0.2,
                                              interval_s=0.2)
        evs = [e for e in tm0.tail(16) if e["ev"] == TF.ALERT_EVENT]
        assert any(e["rule"] == "heartbeat_lost" and e["worker"] == 2
                   for e in evs)
        assert any(a["action"] == "demote"
                   for a in srv.collector.pop_actions())
    finally:
        for st in streamers.values():
            st.stop(final=False)
        for t in tms.values():
            t.close()
        srv.stop()
        tm0.close()
