"""The port's chaos harness (``theanompi_tpu_torch/utils/chaos.py``)
against the JAX package's ``utils/chaos.py``.

* Schedules: ``parse_schedule`` and ``seeded_schedule`` give the JAX
  package's schedules for the same specs and seeds, and refuse what it
  refuses; ``fault_window_active`` is the same rule.
* The monkey: kill, stop and delay against a live child process; a
  target without a pid dropped after its grace; the realized-schedule log
  written and replayed (``schedule_from_realized``), across the packages.
* The proxy: its drop, dup and corrupt windows over the port's center
  server, survived by the port's wire retries and deduplicated once; a
  partition that an island of the port rides out and recovers from; its
  threads joined on stop.
* ``find_child_pid`` finds a process of the port's modules.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from theanompi_tpu.utils import chaos as JC
from theanompi_tpu_torch.parallel.center_server import (CenterServer,
                                                        RemoteCenter)
from theanompi_tpu_torch.parallel.membership import Backoff
from theanompi_tpu_torch.utils import chaos
from theanompi_tpu_torch.utils import telemetry as TT

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402


def _rows(faults):
    return [(f.kind, f.at, f.target, f.duration) for f in faults]


# -- schedules ------------------------------------------------------------------

SPECS = ["kill@8:1,stop@12:2:3.5,delay@3:0:0.5",
         "corrupt@2:1:50,kill@6:1",
         "net_dup@5:-1:6,net_partition@12:2:3,net_drop@1.5:-1:0.25",
         " kill@0:0 , ,net_corrupt@9.75:3:1e-1 "]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_schedule_matches_the_jax_package(spec):
    t, j = chaos.parse_schedule(spec), JC.parse_schedule(spec)
    assert _rows(t) == _rows(j)
    assert [repr(f) for f in t] == [repr(f) for f in j]


@pytest.mark.parametrize("spec,exc,msg", [
    ("kill@oops", ValueError, "bad fault entry"),
    ("kill@3", ValueError, "bad fault entry"),
    ("maim@3:0", AssertionError, "unknown fault kind")])
def test_parse_schedule_refuses_alike(spec, exc, msg):
    errs = []
    for mod in (JC, chaos):
        with pytest.raises(exc, match=msg) as e:
            mod.parse_schedule(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("seed,kw", [
    (7, dict(n_faults=4, t_min=5, t_max=30, kinds=("kill", "stop"))),
    (8, dict(n_faults=4)),
    (11, dict(n_faults=6, t_min=8, t_max=30, duration=2.5,
              kinds=chaos.NET_FAULT_KINDS)),
    (3, dict(n_faults=3, kinds=("corrupt", "delay", "kill")))])
def test_seeded_schedule_matches_the_jax_package(seed, kw):
    targets = [-1, 1, 2] if "kinds" in kw and \
        kw["kinds"] == chaos.NET_FAULT_KINDS else [1, 2, 3]
    t = chaos.seeded_schedule(seed, targets, **kw)
    assert _rows(t) == _rows(JC.seeded_schedule(seed, targets, **kw))
    assert _rows(t) == _rows(chaos.seeded_schedule(seed, targets, **kw))
    assert all(kw.get("t_min", 5.0) <= f.at <= kw.get("t_max", 30.0) and
               f.target in targets for f in t)
    assert _rows(t) != _rows(chaos.seeded_schedule(seed + 1, targets, **kw))


def test_vocabularies_and_window_rule_agree():
    for name in ("FAULT_KINDS", "NET_FAULT_KINDS", "NET_DELAY_PER_FRAME_S",
                 "FAULT_EVENT", "REALIZED_SCHEDULE"):
        assert getattr(chaos, name) == getattr(JC, name), name
    sched = chaos.parse_schedule("net_drop@10:-1:5,net_dup@20:3:2")
    jsched = JC.parse_schedule("net_drop@10:-1:5,net_dup@20:3:2")
    for kind in ("net_drop", "net_dup", "net_delay"):
        for worker in (None, 3, 4, 7):
            for now in (9.9, 10.0, 12.0, 15.0, 15.1, 21.0, 22.5):
                assert chaos.fault_window_active(sched, kind, worker, now) \
                    == JC.fault_window_active(jsched, kind, worker, now)
    assert chaos.fault_window_active(sched, "net_drop", None, 12.0)
    assert not chaos.fault_window_active(sched, "net_dup", None, 21.0)
    # a pid-targeted monkey leaves the net faults to the proxy
    monkey = chaos.ChaosMonkey(sched + chaos.parse_schedule("kill@1:0"))
    assert [f.kind for f in monkey.schedule] == ["kill"]


# -- the monkey ------------------------------------------------------------------

def test_monkey_kill_fault_against_live_process():
    p = subprocess.Popen(["sleep", "30"])
    tm = TT.Telemetry(rank=0, run_id="chaos-kill")
    try:
        monkey = chaos.ChaosMonkey(chaos.parse_schedule("kill@0.1:0"),
                                   pid_of=lambda t: p.pid, telemetry_=tm)
        monkey.start()
        rc = p.wait(timeout=10)
        monkey.stop()
        assert rc == -signal.SIGKILL
        assert monkey.applied and monkey.applied[0].error is None
        ev = [e for e in tm.tail(8) if e["ev"] == chaos.FAULT_EVENT]
        assert ev and ev[0]["kind"] == "kill" and ev[0]["pid"] == p.pid
    finally:
        tm.close()
        if p.poll() is None:
            p.kill()


def test_monkey_stop_fault_wedges_then_releases():
    t0 = time.time()
    p = subprocess.Popen(["sleep", "0.2"])
    try:
        monkey = chaos.ChaosMonkey(chaos.parse_schedule("stop@0.05:0:0.6"),
                                   pid_of=lambda t: p.pid)
        monkey.start()
        rc = p.wait(timeout=10)
        monkey.stop()
        # stopped for 0.6 s: a 0.2 s sleep cannot end before ~0.6 s
        assert rc == 0 and time.time() - t0 > 0.5
    finally:
        if p.poll() is None:
            p.kill()


def test_monkey_delay_without_hook_is_a_stop_pair():
    t0 = time.time()
    p = subprocess.Popen(["sleep", "0.2"])
    try:
        monkey = chaos.ChaosMonkey(chaos.parse_schedule("delay@0.05:0:0.6"),
                                   pid_of=lambda t: p.pid)
        monkey.start()
        assert p.wait(timeout=10) == 0 and time.time() - t0 > 0.5
        monkey.stop()
    finally:
        if p.poll() is None:
            p.kill()


def test_monkey_delay_hook_and_no_pid_drop():
    hits = []
    monkey = chaos.ChaosMonkey(
        chaos.parse_schedule("delay@0.05:3:0.7,kill@0.05:1"),
        pid_of=lambda t: None, delay_hook=lambda t, d: hits.append((t, d)),
        grace_s=0.3)
    monkey.start()
    time.sleep(1.0)
    monkey.stop()
    assert hits == [(3, 0.7)]
    killf = [f for f in monkey.schedule if f.kind == "kill"][0]
    assert killf.applied and killf.error == "no-pid"


def test_monkey_corrupt_drops_the_trigger_file(tmp_path):
    d = str(tmp_path / "chaos")
    monkey = chaos.ChaosMonkey(
        chaos.parse_schedule("corrupt@0:2:50,corrupt@0:3"), corrupt_dir=d)
    monkey.start()
    deadline = time.time() + 5
    while len(monkey.applied) < 2 and time.time() < deadline:
        time.sleep(0.02)
    monkey.stop()
    docs = {}
    for w in (2, 3):
        with open(os.path.join(d, f"corrupt_w{w}.json")) as f:
            docs[w] = json.load(f)
    assert docs == {2: {"target": 2, "scale": 50.0},
                    3: {"target": 3, "scale": 1e-3}}
    nodir = chaos.ChaosMonkey(chaos.parse_schedule("corrupt@0:2"))
    assert nodir._apply(nodir.schedule[0]) and \
        nodir.schedule[0].error == "no-corrupt-dir"


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_realized_schedule_is_written_and_replays(reader, tmp_path):
    """Every fault that lands (and every asked-but-missed drop) is on the
    realized log, which parses back, in either package, into a schedule
    that replays the faults at their relative landing times."""
    path = str(tmp_path / chaos.REALIZED_SCHEDULE)
    p = subprocess.Popen(["sleep", "30"])
    try:
        monkey = chaos.ChaosMonkey(
            chaos.parse_schedule("kill@0.05:2,kill@0.1:9"),
            pid_of=lambda t: p.pid if t == 2 else None,
            grace_s=0.3, realized_path=path)
        monkey.start()
        p.wait(timeout=10)
        time.sleep(0.6)                       # let the no-pid drop resolve
        monkey.stop()
    finally:
        if p.poll() is None:
            p.kill()
    with open(path) as f:
        docs = [json.loads(ln) for ln in f if ln.strip()]
    by_target = {d["target"]: d for d in docs}
    assert by_target[2]["kind"] == "kill" and \
        by_target[2]["error"] is None and by_target[2]["source"] == "monkey"
    assert by_target[9]["error"] == "no-pid"
    proxy = chaos.ChaosProxy("127.0.0.1:1",
                             chaos.parse_schedule("net_dup@0:-1:5"),
                             realized_path=path)
    proxy._emit(proxy.schedule[0])
    mod = chaos if reader == "torch" else JC
    sched = mod.schedule_from_realized(path)
    assert sorted((f.kind, f.target) for f in sched) == \
        [("kill", 2), ("net_dup", -1)]
    assert all(0.0 <= f.at < 5.0 for f in sched)
    assert _rows(sched) == _rows(chaos.schedule_from_realized(path))
    # the replay: the kill lands again at its relative time
    q = subprocess.Popen(["sleep", "30"])
    try:
        again = chaos.ChaosMonkey([f for f in sched if f.kind == "kill"],
                                  pid_of=lambda t: q.pid)
        again.start()
        assert q.wait(timeout=10) == -signal.SIGKILL
        again.stop()
    finally:
        if q.poll() is None:
            q.kill()


# -- the proxy -------------------------------------------------------------------

def _leaves(v):
    return [np.full(3, v, np.float32)]


def test_proxy_duplicates_frames_and_the_server_dedups():
    srv = CenterServer(alpha=0.5)
    host, port = srv.start()
    proxy = chaos.ChaosProxy(f"{host}:{port}",
                             chaos.parse_schedule("net_dup@0:-1:30"))
    paddr = proxy.start()
    try:
        rc = RemoteCenter(paddr, alpha=0.5, client_id="w1")
        rc.ensure_init_leaves(_leaves(1.0))
        rc.push_delta_leaves(_leaves(2.0), 1)
        st = rc.stats()
        # every frame arrived twice; the mutating op applied once
        assert st["n_updates"] == 1
        assert st["dedup_hits"] == 1
        np.testing.assert_allclose(rc.pull_leaves()[0], 2.0)
        assert proxy.frames_faulted.get("net_dup", 0) >= 3
        assert proxy.applied and proxy.applied[0].kind == "net_dup"
        rc.close()
    finally:
        proxy.stop()
        srv.stop()


def test_proxy_drop_and_corrupt_are_survived_by_retry():
    tm = TT.Telemetry(rank=0, run_id="proxy-test")
    srv = CenterServer(alpha=0.5)
    host, port = srv.start()
    t0 = time.time()
    proxy = chaos.ChaosProxy(
        f"{host}:{port}",
        chaos.parse_schedule("net_corrupt@0:-1:1.2,net_drop@1.3:-1:1.2"),
        t0=t0, telemetry_=tm)
    paddr = proxy.start()
    try:
        rc = RemoteCenter(paddr, alpha=0.5, client_id="w1",
                          op_timeout_s=0.5, max_retries=20, deadline_s=30,
                          backoff=Backoff(base=0.05, cap=0.3),
                          telemetry_=tm)
        rc.ensure_init_leaves(_leaves(1.0))              # corrupt window
        time.sleep(max(0.0, t0 + 1.4 - time.time()))
        rc.push_delta_leaves(_leaves(2.0), 1)            # drop window
        st = rc.stats()
        assert st["n_updates"] == 1                      # exactly once
        np.testing.assert_allclose(rc.pull_leaves()[0], 2.0)
        assert proxy.frames_faulted.get("net_corrupt", 0) >= 1
        assert proxy.frames_faulted.get("net_drop", 0) >= 1
        # corrupt: the server's CRC refused it and the client retried the
        # token; drop: an op timeout, a reconnect and a retry
        assert tm.counters.get("wire.corrupt", 0) >= 1
        assert tm.counters.get("wire.timeout", 0) >= 1
        assert [e["kind"] for e in tm.tail(64)
                if e["ev"] == chaos.FAULT_EVENT] == ["net_corrupt",
                                                     "net_drop"]
        rc.close()
    finally:
        proxy.stop()
        srv.stop()
        tm.close()


def test_partitioned_island_reconnects_and_resyncs():
    """An EASGD island of the port behind a partition keeps training
    (its exchanges skipped, not fatal), reconnects when the partition
    heals, and its pushes land on the center again."""
    from theanompi_tpu_torch.parallel.async_easgd import AsyncEASGDTrainer
    srv = CenterServer(alpha=0.5)
    host, port = srv.start()
    # the window is armed once the island is live
    sched = chaos.parse_schedule("net_partition@0.2:-1:2.0")
    proxy = chaos.ChaosProxy(f"{host}:{port}", sched,
                             t0=time.time() + 3600)
    paddr = proxy.start()
    tr = AsyncEASGDTrainer(helper.TinyLRNNet, {
        "async_islands": 1, "sync_freq": 1, "device": "cpu",
        "verbose": False, "center_addr": paddr, "wire_timeout": 0.5,
        "wire_retries": 2, "wire_deadline": 1.0, "island_throttle": 0.02})
    try:
        tr.start()
        isl = tr.islands[0]
        deadline = time.time() + 120
        while isl.exchanges_done < 1 and time.time() < deadline:
            assert isl.error is None, isl.error
            time.sleep(0.05)
        assert isl.exchanges_done >= 1, "the island never reached the center"
        proxy.t0 = time.time()                 # partition in 0.2 s, for 2 s
        time.sleep(2.6)
        skipped = isl.exchanges_skipped
        e_heal = isl.exchanges_done
        while isl.exchanges_done < e_heal + 2 and time.time() < deadline:
            assert isl.error is None, isl.error
            time.sleep(0.05)
        tr.stop_and_join(timeout=60)
        assert skipped >= 1, "the partition never bit an exchange"
        assert isl.exchanges_done >= e_heal + 2
        assert srv.center.n_updates >= e_heal + 2
        assert tr.stats()["islands"][0]["exchanges_skipped"] == \
            isl.exchanges_skipped
        assert proxy.frames_faulted.get("net_partition", 0) >= 1
    finally:
        proxy.stop()
        srv.stop()


def test_proxy_stop_joins_its_threads():
    import socket
    up = socket.socket()
    up.bind(("127.0.0.1", 0))
    up.listen(1)
    host, port = up.getsockname()
    proxy = chaos.ChaosProxy(f"{host}:{port}",
                             chaos.parse_schedule("net_drop@600:1:1"))
    proxy.start()
    threads = list(proxy._threads)
    assert threads and all(t.is_alive() for t in threads)
    proxy.stop()
    assert all(not t.is_alive() for t in threads)
    assert proxy._threads == []
    up.close()


# -- find_child_pid, wait_for_file --------------------------------------------

def test_find_child_pid_finds_the_ports_center(tmp_path):
    p = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.parallel.center_server",
         "--port", "0", "--max-seconds", "30"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        found = chaos.find_child_pid(
            os.getpid(), "theanompi_tpu_torch.parallel.center_server",
            timeout_s=10)
        assert found == p.pid
        assert chaos.find_child_pid(os.getpid(), "no-such-needle",
                                    timeout_s=0.2) is None
    finally:
        p.kill()
        p.wait()


def test_wait_for_file(tmp_path):
    path = str(tmp_path / "LATEST")
    threading.Timer(0.2, lambda: open(path, "w").write("3")).start()
    assert chaos.wait_for_file(path, timeout_s=5,
                               predicate=lambda s: s.strip() == "3")
    assert not chaos.wait_for_file(str(tmp_path / "never"), timeout_s=0.2)
