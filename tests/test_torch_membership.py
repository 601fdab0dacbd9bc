"""The port's elastic membership (``theanompi_tpu_torch/parallel/
membership.py``) against the JAX package's ``parallel/membership.py``;
the in-world side (``MeshReactor``, ``set_active_ranks``) is
``tests/test_torch_mesh_membership.py``'s.

* Leases: a beat's document and heartbeat gauges; lease files written by
  either package's ``WorkerLease`` read by the other's ``read_leases``.
* The controller: one lease and clock sequence, the lease files written
  by either package, polled by both packages' controllers in lockstep:
  the same join, leave and demote transitions; a stale lease cannot
  resurrect a dead worker; a clean finish is not a death; straggler
  demotion with its floor, from a given ranking and from the telemetry
  streams of a run (the JAX controller through ``scripts/telemetry_report.py``
  loaded by path, the port's through its own ``tools/telemetry_report.py``).
* The center's reactions: ``CenterReactor`` demotes and readmits on a
  port center in memory and behind the wire, and defers through an
  outage, then flushes; the ``center_down`` / ``center_restored`` pair.
* The supervisor: a crashed worker respawned to a clean finish, as the
  JAX package's supervisor does it; the breaker; ``_tick_fleetmon``
  applying a ``demote`` alert and a ``flight_dump`` alert.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

from theanompi_tpu.parallel import membership as JM
from theanompi_tpu.utils import telemetry as JT
from theanompi_tpu_torch.parallel import membership as mb
from theanompi_tpu_torch.parallel.async_easgd import ElasticCenter
from theanompi_tpu_torch.parallel.center_server import (CenterServer,
                                                        RemoteCenter)
from theanompi_tpu_torch.utils import fleetmon, tracing
from theanompi_tpu_torch.utils import telemetry as TT
from theanompi_tpu_torch.utils.clock import Clock

PKGS = {"jax": (JM, JT), "torch": (mb, TT)}


class VClock(Clock):
    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


def _tm():
    return TT.Telemetry(rank=0, run_id="membership-test")


def _events(tm, *kinds):
    return [e for e in tm.tail(64) if e["ev"] in kinds]


def test_vocabularies_agree():
    for name in ("MEMBERSHIP_EVENTS", "CENTER_EVENTS", "HEARTBEAT_GAUGES"):
        assert getattr(mb, name) == getattr(JM, name), name
    assert mb.ElasticSupervisor.CENTER_ID == JM.ElasticSupervisor.CENTER_ID
    items = ["a=1", "b=2.5", "c=true", "d=False", "e=x", "f=", "g=1e-3",
             "h=tcp://h:1"]
    assert mb.parse_kv(items) == JM.parse_kv(items)


# -- leases ------------------------------------------------------------------------

def test_lease_beat_roundtrip_and_heartbeat_gauges(tmp_path):
    tm = _tm()
    lease = mb.WorkerLease(str(tmp_path), 3, telemetry_=tm)
    lease.beat(7)
    docs = mb.read_leases(str(tmp_path))
    assert docs[3]["step"] == 7 and docs[3]["status"] == "live"
    assert docs[3]["pid"] == os.getpid()
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert tm.gauges["heartbeat.iter"] == 7
    gs = _events(tm, "gauges")
    assert gs and gs[-1]["heartbeat.iter"] == 7
    # a beat inside min_interval_s writes nothing
    lease.beat(8)
    assert mb.read_leases(str(tmp_path))[3]["step"] == 7
    lease.release()
    assert mb.read_leases(str(tmp_path))[3]["status"] == "left"
    tm.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_lease_files_cross_between_packages(writer, reader, tmp_path):
    clk = VClock()
    d = str(tmp_path)
    W, WT = PKGS[writer]
    lease = W.WorkerLease(d, 4, telemetry_=WT.DISABLED, clock=clk,
                          min_interval_s=0.0)
    lease.beat(12, epoch=2)
    open(os.path.join(d, "lease_wgarbage.json"), "w").write("{nope")
    docs = PKGS[reader][0].read_leases(d)
    assert docs == W.read_leases(d)
    assert docs[4] == {"worker": 4, "pid": os.getpid(), "ts": 1000.0,
                       "step": 12, "status": "live", "epoch": 2}
    assert PKGS[reader][0].lease_path(d, 4) == W.lease_path(d, 4)


# -- the controller ---------------------------------------------------------------

def _controllers(d, clk, **kw):
    return [pkg.MembershipController(lease_dir=d, clock=clk,
                                     telemetry_=tmod.DISABLED, **kw)
            for pkg, tmod in (PKGS["jax"], PKGS["torch"])]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_controllers_make_the_same_transitions(writer, tmp_path):
    """One lease and clock sequence, the leases written by ``writer``'s
    ``WorkerLease``, polled by the JAX package's controller and the
    port's: every poll's transitions, the explicit ones, and the states,
    equal."""
    d = str(tmp_path)
    clk = VClock()
    W, WT = PKGS[writer]
    leases = {w: W.WorkerLease(d, w, telemetry_=WT.DISABLED, clock=clk,
                               min_interval_s=0.0) for w in (1, 2, 3)}
    ctls = _controllers(d, clk, lease_timeout=5.0, min_active=1)
    polls = [[], []]

    def poll():
        for out, c in zip(polls, ctls):
            out.append(c.poll())

    def both(method, *a, **kw):
        return [getattr(c, method)(*a, **kw) for c in ctls]

    for w in (1, 2, 3):
        leases[w].beat(1)
    poll()                                   # three joins
    clk.t += 3.0
    leases[1].beat(4)
    leases[3].beat(4)
    poll()
    clk.t += 3.0
    poll()                                   # 2's lease expired
    leases[2].beat(6)
    poll()                                   # 2 rejoins
    assert both("demote", 3, reason="straggler", windows_straggled=4) == \
        [True, True]
    assert both("demote", 3) == [False, False]     # not live any more
    both("readmit", 3)
    leases[1].release()
    poll()                                   # 1 finished
    both("leave", 3, reason="crashed", rc=-9)
    poll()                                   # 3's fresh lease is stale
    clk.t += 0.5
    leases[3].beat(9)
    poll()                                   # a newer beat: 3 rejoins
    clk.t += 10.0
    leases[3].beat(10)
    poll()                                   # 2 expires again
    both("center_down", reason="crashed", rc=-9)
    both("center_restored", attempt=1)
    assert polls[0] == polls[1]
    assert ctls[0].transitions == ctls[1].transitions
    assert ctls[0].status() == ctls[1].status()
    assert ctls[1].status() == {"live": [3], "demoted": [], "dead": [2],
                                "left": [1]}
    kinds = [(e, w, i.get("reason")) for e, w, i in ctls[1].transitions]
    assert ("worker_leave", 2, "lease_expired") in kinds
    assert ("worker_leave", 1, "finished") in kinds
    assert ("worker_demote", 3, "straggler") in kinds
    assert ("worker_join", 3, "readmit") in kinds
    assert [k for k in kinds if k[0].startswith("center")] == [
        ("center_down", -1, "crashed"), ("center_restored", -1, None)]


def test_controller_join_expire_rejoin_cycle(tmp_path):
    tm = _tm()
    ctl = mb.MembershipController(lease_dir=str(tmp_path),
                                  lease_timeout=0.2, telemetry_=tm)
    lease = mb.WorkerLease(str(tmp_path), 1, telemetry_=tm,
                           min_interval_s=0.0)
    lease.beat(1)
    assert [t[0] for t in ctl.poll()] == ["worker_join"]
    assert ctl.active_ranks() == [1]
    time.sleep(0.3)
    trans = ctl.poll()
    assert [t[0] for t in trans] == ["worker_leave"]
    assert trans[0][2]["reason"] == "lease_expired"
    lease.beat(9)
    trans = ctl.poll()
    assert [t[0] for t in trans] == ["worker_join"]
    assert trans[0][2]["rejoin"] is True
    evs = _events(tm, *mb.MEMBERSHIP_EVENTS)
    assert [e["ev"] for e in evs] == ["worker_join", "worker_leave",
                                     "worker_join"]
    assert all(e["worker"] == 1 for e in evs)
    tm.close()


def test_clean_finish_is_not_a_death(tmp_path):
    ctl = mb.MembershipController(lease_dir=str(tmp_path),
                                  lease_timeout=30.0,
                                  telemetry_=TT.DISABLED)
    lease = mb.WorkerLease(str(tmp_path), 4)
    lease.beat(10)
    ctl.poll()
    lease.release()
    trans = ctl.poll()
    assert [t[0] for t in trans] == ["worker_leave"]
    assert trans[0][2]["reason"] == "finished"
    assert ctl.status()["left"] == [4]


def test_straggler_demotion_and_min_active_floor():
    ranking = [{"rank": 2, "windows_straggled": 5, "mean_train_secs": 0.9},
               {"rank": 1, "windows_straggled": 1, "mean_train_secs": 0.1},
               {"rank": 0, "windows_straggled": 0, "mean_train_secs": 0.1}]
    worse = [dict(ranking[0], windows_straggled=8)] + ranking[1:]
    outs = []
    for pkg, tmod in (PKGS["jax"], PKGS["torch"]):
        ctl = pkg.MembershipController(telemetry_=tmod.DISABLED,
                                       straggle_windows=3, min_active=1)
        for w in (0, 1, 2):
            ctl.join(w)
        out = [ctl.check_stragglers(ranking), ctl.check_stragglers(ranking)]
        ctl.readmit(2)
        out += [ctl.check_stragglers(ranking), ctl.check_stragglers(worse)]
        outs.append((out, ctl.transitions))
    assert outs[0] == outs[1]
    assert outs[1][0] == [[2], [], [], [2]]
    ctl2 = mb.MembershipController(straggle_windows=1, min_active=2,
                                   telemetry_=TT.DISABLED)
    ctl2.join(0)
    ctl2.join(1)
    assert ctl2.check_stragglers(
        [{"rank": 1, "windows_straggled": 9},
         {"rank": 0, "windows_straggled": 0}]) == []


def test_straggler_ranking_sourced_from_telemetry_streams(tmp_path):
    """The controller reads the run report's windowed ranking (the port's
    ``tools/telemetry_report.py``) over real per-rank stream files: rank
    2's long train phases get it demoted, in the port's controller as in
    the JAX package's."""
    t0 = time.time()
    for rank in range(3):
        with open(tmp_path / f"telemetry_rank{rank}.jsonl", "w") as f:
            for i in range(30):
                dt = 0.5 if rank == 2 else 0.01
                f.write(json.dumps(
                    {"ts": t0 + i, "run": "r", "rank": rank, "ev": "phase",
                     "sec": "train", "dt": dt}) + "\n")
    got = []
    for pkg, tmod in (PKGS["jax"], PKGS["torch"]):
        ctl = pkg.MembershipController(telemetry_=tmod.DISABLED,
                                       record_dir=str(tmp_path),
                                       straggle_windows=2,
                                       straggle_window_s=5.0)
        for w in range(3):
            ctl.join(w)
        got.append((ctl.check_stragglers(), ctl.status()))
    assert got[0] == got[1]
    assert got[1][0] == [2] and got[1][1]["demoted"] == [2]
    assert mb._load_report_module() is not None


# -- the center's reactions ---------------------------------------------------------

def test_center_reactor_drives_demote_and_readmit():
    center = ElasticCenter([np.ones((2, 2), np.float32)], alpha=0.5)
    reactor = mb.CenterReactor(center)
    ctl = mb.MembershipController(telemetry_=TT.DISABLED,
                                  reactors=[reactor])
    ctl.join(1)
    ctl.join(2)
    ctl.demote(2)
    assert center.demoted == {2}
    snap = center.pull_leaves()
    center.push_delta_leaves([np.ones((2, 2), np.float32)], 2)   # dropped
    np.testing.assert_array_equal(center.pull_leaves()[0], snap[0])
    assert center.dropped_by_island == {2: 1}
    ctl.readmit(2)
    assert center.demoted == set()
    ctl.leave(1, reason="crashed")          # zombie pushes must not land
    assert center.demoted == {1}
    ctl.join(1, reason="respawn")           # a rejoin readmits
    assert center.demoted == set()


def test_center_reactor_over_the_wire_defers_through_an_outage(tmp_path):
    """The reactor's calls on a port center behind the wire: a demote
    lands; with the center down the readmit is remembered, not raised;
    once the center is back on its port (restored from its snapshot) the
    flush lands the latest intent."""
    snap = str(tmp_path)
    srv = CenterServer(alpha=0.5, snapshot_dir=snap)
    host, port = srv.start()
    remote = RemoteCenter(f"{host}:{port}", alpha=0.5, client_id="sup",
                          op_timeout_s=1.0, max_retries=1, deadline_s=2.0)
    try:
        remote.ensure_init_leaves([np.ones(3, np.float32)])
        reactor = mb.CenterReactor(remote)
        ctl = mb.MembershipController(telemetry_=TT.DISABLED,
                                      reactors=[reactor])
        ctl.join(5)
        ctl.join(6)
        ctl.leave(5, reason="crashed")
        assert remote.stats()["demoted"] == [5]
        remote.push_delta_leaves([np.ones(3, np.float32)], 5)
        assert remote.stats()["n_updates"] == 0
        srv.snapshot()
        srv.stop()                                  # the outage
        ctl.join(5, reason="respawn")               # deferred readmit
        ctl.demote(6)                               # deferred demote
        assert reactor._pending == {5: "readmit", 6: "demote"}
        srv = CenterServer(alpha=0.5, snapshot_dir=snap)
        assert srv.restore()
        srv.start(host, port)
        reactor.flush_pending()
        assert reactor._pending == {}
        st = remote.stats()
        assert st["demoted"] == [6]
        remote.push_delta_leaves([np.ones(3, np.float32)], 5)
        assert remote.n_updates == 1
    finally:
        remote.close()
        srv.stop()


def test_center_reactor_defers_and_latest_intent_wins():
    class FlakyCenter:
        def __init__(self):
            self.up = True
            self.demoted = set()

        def demote_island(self, island):
            if not self.up:
                raise ConnectionError("center down")
            self.demoted.add(island)

        def readmit_island(self, island):
            if not self.up:
                raise ConnectionError("center down")
            self.demoted.discard(island)

    center = FlakyCenter()
    reactor = mb.CenterReactor(center)
    ctl = mb.MembershipController(telemetry_=TT.DISABLED,
                                  reactors=[reactor])
    ctl.join(1)
    ctl.join(2)
    center.up = False
    ctl.leave(1, reason="crashed")
    assert center.demoted == set() and reactor._pending == {1: "demote"}
    center.up = True
    reactor.flush_pending()
    assert center.demoted == {1} and reactor._pending == {}
    center.up = False
    ctl.leave(2, reason="crashed")
    ctl.join(2, reason="respawn")
    assert reactor._pending == {2: "readmit"}
    center.up = True
    reactor.flush_pending()
    assert center.demoted == {1}


def test_center_down_restored_event_pair():
    tm = _tm()
    ctl = mb.MembershipController(telemetry_=tm)
    ctl.center_down(reason="crashed", rc=-9)
    ctl.center_restored(attempt=1)
    evs = _events(tm, *mb.CENTER_EVENTS)
    assert [e["ev"] for e in evs] == ["center_down", "center_restored"]
    assert evs[0]["reason"] == "crashed" and evs[0]["rc"] == -9
    assert [t[0] for t in ctl.transitions] == list(mb.CENTER_EVENTS)
    tm.close()


# -- the supervisor ---------------------------------------------------------------

CRASH_ONCE = ("import sys; sys.exit(0 if int(sys.argv[2]) else "
              "int(sys.argv[1]) % 2)")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_supervisor_respawns_a_crashed_worker_to_a_clean_finish(pkg,
                                                                tmp_path):
    """Worker 1 exits 1 on its first attempt, worker 2 exits 0: worker 1
    leaves (crashed), is respawned after the backoff and finishes; the
    transitions are the same in both packages' supervisors."""
    M, _ = PKGS[pkg]
    sup = M.ElasticSupervisor(
        lambda w, a: [sys.executable, "-c", CRASH_ONCE, str(w), str(a)],
        [1, 2], str(tmp_path), poll_s=0.05, backoff=M.Backoff(base=0.05),
        verbose=False, telemetry_=PKGS[pkg][1].DISABLED)
    assert sup.run(timeout_s=60) == 0
    kinds = sorted((e, w, i.get("reason")) for e, w, i in
                   sup.controller.transitions)
    assert kinds == sorted([
        ("worker_join", 1, "spawn"), ("worker_join", 2, "spawn"),
        ("worker_leave", 1, "crashed"), ("worker_join", 1, "respawn"),
        ("worker_leave", 1, "finished"), ("worker_leave", 2, "finished")])
    assert sup.done == {1, 2} and sup.attempts == {1: 2, 2: 1}
    assert sup.pid_of(1) is None


def test_supervisor_breaker_stops_a_crash_loop(tmp_path, capsys):
    sup = mb.ElasticSupervisor(
        lambda w, a: [sys.executable, "-c", "import sys; sys.exit(3)"],
        [1], str(tmp_path), poll_s=0.05, backoff=mb.Backoff(base=0.01),
        crash_limit=3, crash_window_s=60.0, max_restarts=10,
        telemetry_=TT.DISABLED)
    assert sup.run(timeout_s=60) == 1
    assert "crash-loop breaker tripped" in capsys.readouterr().err
    assert sum(1 for e, w, i in sup.controller.transitions
               if e == "worker_leave") == 3


def test_supervisor_tick_applies_demote_and_flight_dump(tmp_path):
    d = str(tmp_path)
    tm = TT.Telemetry(rank=0, run_id="sup", stream_dir=d)
    srv = fleetmon.FleetMonServer(rules=fleetmon.default_rules(),
                                  telemetry_=TT.DISABLED)
    sup = mb.ElasticSupervisor(lambda w, a: ["true"], [1, 2], d,
                               record_dir=d, telemetry_=tm, fleetmon=srv)
    sup.controller.join(1, pid=11)
    sup.controller.join(2, pid=22)
    sz = tracing.StatuszServer("worker", ident=1, run_dir=d, telemetry_=tm)
    sz.start()
    try:
        srv.collector.alerts.append({})          # not actionable: ignored
        srv.collector.actions.append(
            {"rule": "heartbeat_lost", "series": "heartbeat_age_s",
             "rank": 1, "value": 30.0, "threshold": 10.0,
             "action": "demote"})
        srv.collector.actions.append(
            {"rule": "queue_starved", "series": "queue_depth",
             "rank": None, "value": 0.0, "threshold": 1.0,
             "action": "flight_dump"})
        sup._tick_fleetmon()
        assert sup.alert_demotions == [("heartbeat_lost", 1)]
        assert sup.controller.workers[1]["status"] == "demoted"
        demotes = [e for e in tm.tail(16) if e["ev"] == "worker_demote"]
        assert demotes and demotes[-1]["rule"] == "heartbeat_lost" \
            and demotes[-1]["reason"] == "alert" \
            and demotes[-1]["series"] == "heartbeat_age_s"
        assert sup.flight_dumps_requested == 1
        assert os.path.exists(os.path.join(d, "flight_rank0.jsonl"))
        # the supervisor's own liveness sample joined the fleet view
        assert srv.collector.roles.get(-2) == "supervisor"
        # the floor: the last live worker is never demoted by an alert
        srv.collector.actions.append(
            {"rule": "heartbeat_lost", "rank": 2, "value": 30.0,
             "action": "demote"})
        sup._tick_fleetmon()
        assert sup.alert_demotions == [("heartbeat_lost", 1)]
    finally:
        sz.stop()
        tm.close()


def test_host_devices_above_one_are_refused():
    assert mb._host_devices(0) == 0 and mb._host_devices(1) == 1
    with pytest.raises(NotImplementedError, match="--n-workers 2"):
        mb._host_devices(2)
    with pytest.raises(NotImplementedError, match="host_devices=4"):
        mb.run_elastic("easgd", "m", "M", {}, 2, host_devices=4,
                       record_dir="/nonexistent")
    with pytest.raises(ValueError, match="center-based rule"):
        mb.run_elastic("bsp", "m", "M", {}, 2, record_dir="/nonexistent")


# -- the BSP worker's hooks ------------------------------------------------------

def test_bsp_worker_beats_a_lease_and_streams_metrics(tmp_path):
    """``Worker.run`` with ``lease_dir`` and ``metrics_addr``: the rank's
    lease follows its iterations and is released on the clean exit; its
    metric snapshots reach the fleet monitor, which retires the rank on
    the final ``left`` sample."""
    import theanompi_tpu_torch as T
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    srv = fleetmon.FleetMonServer(telemetry_=TT.DISABLED)
    host, port = srv.start()
    d = str(tmp_path / "leases")
    try:
        r = T.BSP()
        r.init(devices=1, modelfile="torch_port_helper",
               modelclass="TinyLRNNet", device="cpu", verbose=False,
               epochs=2, telemetry=True, lease_dir=d,
               metrics_addr=f"{host}:{port}", metrics_interval_s=0.05)
        r.wait()
        doc = mb.read_leases(d)[0]
        n_iter = 2 * r.model.data.n_batch_train
        assert doc["status"] == "left" and doc["step"] == n_iter
        col = srv.collector
        assert col.roles == {0: "worker"} and col.retired == {0}
        assert col.samples_ingested >= 2
        assert "step_p50" in col.series[0] and "steps" in col.series[0]
    finally:
        srv.stop()
        TT.init({})


def test_worker_accepts_the_chaos_key():
    """The JAX worker reads no ``chaos`` key, and the port's accepts a
    config carrying one as it does: the run trains as without it."""
    import theanompi_tpu_torch as T
    from theanompi_tpu_torch import worker
    # the last refused key, trace_dir, is ported: the worker refuses none
    assert not hasattr(worker, "_REFUSED")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    costs = []
    for extra in ({}, {"chaos": "kill@3:1,corrupt@5:2:50"}):
        r = T.BSP()
        r.init(devices=1, modelfile="torch_port_helper",
               modelclass="TinyLRNNet", device="cpu", verbose=False,
               printFreq=2, **extra)
        costs.append([x["cost"] for x in r.wait().train_records])
    assert costs[0] == costs[1] and len(costs[1]) == 3
