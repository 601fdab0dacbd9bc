"""The port's causal tracing (``theanompi_tpu_torch/utils/tracing.py``, the
wire's trace propagation, the center's server spans) and statusz, against
the JAX package's ``utils/tracing.py`` and its report script.

* The tracer: inert while off (and off without telemetry), the span
  hierarchy (a child shares its root's trace and parents to it), the
  span event's fields (the JAX package's ``SPAN_FIELDS``).
* A round span over a port client and a port center: the client's
  ``wire.<op>`` spans and the server's ``center.<op>`` spans share the
  trace, parent to each other, carry the server's ``q`` / ``a`` split,
  and the JAX ``telemetry_report.assemble_traces`` joins every wire op;
  an untraced op still feeds the ``wire.server_queue`` / ``apply``
  histograms; the header the client sends is the JAX client's bytes for
  the same trace context.
* statusz: ``health`` (the JAX package's ``STATUSZ_FIELDS``), ``events``,
  ``flight``, an unknown op refused; the discovery doc registered under
  the run dir, removed on a clean stop and kept on a crash stop; and a
  worker's endpoint and ``center_main --record-dir``'s, each registered
  while the process runs.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from theanompi_tpu.utils import tracing as JTR
from theanompi_tpu_torch.parallel.center_server import (CenterServer,
                                                        RemoteCenter)
from theanompi_tpu_torch.utils import telemetry, tracing

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_telemetry import ENV, report_script  # noqa: E402


@pytest.fixture
def traced(tmp_path):
    d = str(tmp_path / "stream")
    tm = telemetry.init({"record_dir": d, "telemetry_flush_every": 1})
    tr = tracing.init({"tracing": True})
    yield d, tm, tr
    telemetry.init({})
    tracing.init({})


def _events(d):
    out = []
    for name in sorted(os.listdir(d)):
        if name.startswith("telemetry_rank") and name.endswith(".jsonl"):
            with open(os.path.join(d, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def test_tracer_off_and_span_schema():
    assert tracing.init({}).enabled is False
    assert tracing.active().begin("round") is None
    telemetry.init({"telemetry": False})
    assert tracing.init({"tracing": True}).enabled is False
    assert tracing.SPAN_FIELDS == JTR.SPAN_FIELDS
    assert tracing.STATUSZ_FIELDS == JTR.STATUSZ_FIELDS
    tm = telemetry.Telemetry(rank=3, run_id="t")
    tr = tracing.Tracer(telemetry_=tm)
    rnd = tr.begin("round", island=2)
    assert tr.current["span"] == rnd.span
    child = rnd.child("wire.push")
    assert child.trace == rnd.trace and child.parent == rnd.span
    ev = child.end()
    assert ev["parent"] == rnd.span
    rnd.note(train_s=0.5)
    ev = rnd.end(outcome="exchanged")
    assert tr.spans == 2 and tr.current is None
    assert all(k in ev for k in tracing.SPAN_FIELDS)
    streamed = [e for e in tm.tail(4) if e["ev"] == tracing.SPAN_EVENT]
    assert [e["name"] for e in streamed] == ["wire.push", "round"]
    assert streamed[-1]["train_s"] == 0.5 and \
        streamed[-1]["outcome"] == "exchanged"


def test_wire_and_server_spans_join(traced):
    d, tm, tr = traced
    srv = CenterServer(alpha=0.5)
    host, port = srv.start()
    try:
        c = RemoteCenter(f"{host}:{port}", client_id="w1")
        c.ensure_init_leaves([np.ones(3, np.float32)])
        rnd = tr.begin("round", island=1)
        c.pull_leaves(trace=rnd.ctx())
        c.push_delta_leaves([np.full(3, 2.0, np.float32)], 1,
                            trace=rnd.ctx())
        rnd.end(outcome="exchanged")
        c.push_delta_leaves([np.ones(3, np.float32)], 1)     # untraced
        c.close()
    finally:
        srv.stop()
    tm.close()
    evs = _events(d)
    spans = [e for e in evs if e["ev"] == "span"]
    rounds = [s for s in spans if s["name"] == "round"]
    wires = [s for s in spans if s["name"].startswith("wire.")]
    servers = [s for s in spans if s["side"] == "server"]
    assert len(rounds) == 1 and len(wires) == 2 and len(servers) == 2
    tid = rounds[0]["trace"]
    assert all(s["trace"] == tid for s in wires + servers)
    assert all(w["parent"] == rounds[0]["span"] for w in wires)
    assert {s["parent"] for s in servers} == {w["span"] for w in wires}
    push_srv = [s for s in servers if s["name"] == "center.push"][0]
    push_wire = [w for w in wires if w["name"] == "wire.push"][0]
    assert push_srv["q"] is not None and push_wire["a"] == push_srv["a"]
    assert push_srv["island"] == 1
    traces = report_script().assemble_traces(evs)
    assert len(traces) == 1 and traces[0]["joined"] == 2 and \
        traces[0]["unjoined"] == 0 and traces[0]["wire_ops"] == 2
    with open(os.path.join(d, "telemetry_summary_rank0.json")) as f:
        hist = json.load(f)["hist"]
    for k in ("wire.server_queue", "wire.server_apply", "wire.rtt"):
        assert hist[k]["count"] == 4, (k, hist.get(k))


def test_traced_header_bytes_are_the_jax_clients(monkeypatch):
    """The port client and the JAX client frame the same traced request
    into the same bytes (the span id, the token's seq and the frame's CRC
    fixed)."""
    from theanompi_tpu.parallel import wire as JW
    from theanompi_tpu_torch.parallel import wire as TW
    frames = {}
    for name, mod, trmod in (("port", TW, tracing), ("jax", JW, JTR)):
        monkeypatch.setattr(trmod, "new_span_id", lambda: "00ff00ff00ff00ff")
        sent = []

        class Sock:
            def sendall(self, b):
                sent.append(bytes(b))

        c = mod.WireClient("127.0.0.1:9", client_id="w1")
        c._seq = 1000
        c._sock = Sock()
        monkeypatch.setattr(mod, "recv_msg",
                            lambda sock, check_version=True: ({"ok": True},
                                                              b""))
        c.request({"op": "pull"}, trace={"t": "abc", "s": "def"})
        frames[name] = sent[0]
    assert frames["port"] == frames["jax"]
    header = json.loads(frames["port"][8:-4])
    assert header["trace"] == {"t": "abc", "s": "00ff00ff00ff00ff"}


def test_statusz_ops_and_discovery(tmp_path):
    d = str(tmp_path)
    tm = telemetry.Telemetry(rank=1, run_id="sz", stream_dir=d)
    tr = tracing.Tracer(telemetry_=tm)
    tr.begin("round", island=1)
    sz = tracing.StatuszServer("worker", ident=1, run_dir=d, telemetry_=tm,
                               tracer_=tr, extra=lambda: {"steps": 42})
    host, port = sz.start()
    try:
        docs = tracing.read_statusz_docs(d)
        assert [(x["role"], x["id"], x["port"]) for x in docs] == \
            [("worker", 1, port)]
        rep = tracing.statusz_query(f"{host}:{port}", "health")
        assert rep["ok"] and rep["role"] == "worker" and rep["steps"] == 42
        assert all(k in rep for k in tracing.STATUSZ_FIELDS)
        assert rep["current_span"]["name"] == "round"
        # the JAX package's query reads the port's endpoint
        assert JTR.statusz_query(f"{host}:{port}", "health")["id"] == 1
        evs = tracing.statusz_query(f"{host}:{port}", "events", n=4)
        assert evs["ok"] and evs["events"][-1]["ev"] == "statusz"
        fl = tracing.statusz_query(f"{host}:{port}", "flight")
        assert fl["ok"] and os.path.exists(fl["path"])
        bad = tracing.statusz_query(f"{host}:{port}", "nope")
        assert bad["ok"] is False and "unknown" in bad["error"]
    finally:
        sz.stop()
    assert tracing.read_statusz_docs(d) == []        # a clean stop
    sz2 = tracing.StatuszServer("worker", ident=2, run_dir=d, telemetry_=tm)
    sz2.start()
    sz2.stop(deregister=False)                         # a crash stop
    assert [x["id"] for x in tracing.read_statusz_docs(d)] == [2]
    tm.close()


def _wait_doc(d, role, proc, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        docs = [x for x in tracing.read_statusz_docs(d) if x["role"] == role]
        if docs:
            return docs[0]
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        time.sleep(0.05)
    raise AssertionError(f"no {role} statusz doc in {d}")


@pytest.mark.parametrize("role", ["worker", "center"])
def test_process_statusz_and_center_record_dir(tmp_path, role):
    d = str(tmp_path / "rec")
    if role == "worker":
        cmd = [sys.executable, "-m", "theanompi_tpu_torch.worker", "bsp",
               "torch_launch_helper", "SleepyNet", "device=cpu",
               "iter_sleep=0.2", "epochs=1", "verbose=false",
               f"record_dir={d}"]
    else:
        cmd = [sys.executable, "-m",
               "theanompi_tpu_torch.parallel.center_server", "--port", "0",
               "--record-dir", d, "--max-seconds", "60"]
    p = subprocess.Popen(cmd, cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        doc = _wait_doc(d, role, p)
        rep = tracing.statusz_query(f"{doc['host']}:{doc['port']}", "health")
        assert rep["ok"] and rep["role"] == role and rep["pid"] == p.pid
        if role == "center":
            c = RemoteCenter(rep["addr"], client_id="w9")
            c.ensure_init_leaves([np.ones(2, np.float32)])
            c.push_delta_leaves([np.ones(2, np.float32)], 9,
                                trace={"t": "t1", "s": "s1"})
            c.close()
            p.terminate()
        out = p.communicate(timeout=120)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, out[-3000:]
    assert tracing.read_statusz_docs(d) == []        # a clean exit
    rank = 0 if role == "worker" else -1
    with open(os.path.join(d, f"telemetry_rank{rank}.jsonl")) as f:
        evs = [json.loads(line) for line in f]
    assert any(e["ev"] == "statusz" for e in evs)
    assert os.path.exists(os.path.join(
        d, f"telemetry_summary_rank{rank}.json"))
    if role == "center":
        spans = [e for e in evs if e["ev"] == "span"]
        assert [(s["name"], s["side"], s["trace"], s["island"])
                for s in spans] == [("center.push", "server", "t1", 9)]
