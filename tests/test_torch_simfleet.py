"""The port's simfleet (``theanompi_tpu_torch/simfleet/``): every case of
``tests/test_simfleet.py`` against the port's modules — the determinism
gate, the at-width invariant suite, the clock seam, the transport's fault
semantics, the realized-schedule export and the live fidelity cross-check
on CPU islands — and the parity of the two simulators: the JAX package's
FleetSim and the port's, built from the same arguments, must write the
same event log byte for byte (``EventLog.sha256``) and the same summary.
The port's FleetSim drives the port's own membership, topology, wire,
chaos and fleetmon code, so a byte of difference is a departure of one of
those copies from the JAX package's."""

import os
import random
import sys
import time

import pytest

from theanompi_tpu_torch.parallel import membership as mb
from theanompi_tpu_torch.simfleet import (EventLog, EventQueue, FleetSim,
                                          VirtualClock, check_invariants)
from theanompi_tpu_torch.simfleet.fidelity import (export_realized,
                                                   normalize_sequence,
                                                   sim_membership_sequence)
from theanompi_tpu_torch.simfleet.transport import SimCenter, SimTransport
from theanompi_tpu_torch.tools import simfleet_run
from theanompi_tpu_torch.utils import chaos
from theanompi_tpu_torch.utils.clock import WALL, WallClock

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402

# one explicit schedule covering the WHOLE fault taxonomy: center kill,
# worker kills, a lease-expiring wedge, a short wedge, a delay
# straggler, and all five wire window kinds
FULL_SCHEDULE = (
    "kill@10:0,kill@12:3,kill@14:7,stop@20:5:20,stop@30:9:2,"
    "delay@40:11:15,net_dup@8:-1:6,net_dup@35:-1:5,net_drop@25:-1:3,"
    "net_partition@45:-1:3,net_delay@55:-1:4,net_corrupt@60:-1:3")


def _run(n_workers=64, steps=2000, seed=11, schedule=FULL_SCHEDULE,
         **kw):
    kw.setdefault("sync_freq", 8)
    kw.setdefault("n_stragglers", 3)
    fleet = FleetSim(n_workers=n_workers, steps=steps, seed=seed,
                     schedule=chaos.parse_schedule(schedule)
                     if schedule else None, **kw)
    fleet.run()
    return fleet


# -- event core ---------------------------------------------------------------

def test_event_queue_total_order_and_clock_advance():
    clock = VirtualClock()
    q = EventQueue(clock)
    seen = []
    q.push(2.0, lambda: seen.append(("b", clock.now())))
    q.push(1.0, lambda: seen.append(("a", clock.now())))
    q.push(2.0, lambda: seen.append(("c", clock.now())))  # same t: FIFO
    q.run()
    assert seen == [("a", 1.0), ("b", 2.0), ("c", 2.0)]
    with pytest.raises(RuntimeError, match="schedule an event"):
        clock.sleep(1.0)


def test_event_log_canonical_and_hashable():
    a, b = EventLog(), EventLog()
    for log in (a, b):
        log.append(1.23456789, "x", worker=3, reason="spawn")
        log.append(2.0, "y")
    assert a.sha256() == b.sha256()
    assert a.to_jsonl().count("\n") == 2
    b.append(3.0, "z")
    assert a.sha256() != b.sha256()
    # the JAX package's log of the same records: the same bytes
    from theanompi_tpu.simfleet import EventLog as JaxLog
    j = JaxLog()
    j.append(1.23456789, "x", worker=3, reason="spawn")
    j.append(2.0, "y")
    assert j.to_jsonl() == a.to_jsonl()


# -- determinism gate ---------------------------------------------------------

def test_same_seed_byte_identical_log_different_seed_differs():
    f1 = _run(n_workers=48, steps=800, seed=5)
    f2 = _run(n_workers=48, steps=800, seed=5)
    assert f1.log.to_jsonl() == f2.log.to_jsonl()       # byte-identical
    assert f1.log.sha256() == f2.log.sha256()
    f3 = _run(n_workers=48, steps=800, seed=6)
    assert f3.log.sha256() != f1.log.sha256()


def test_gate_passes_under_its_budget(capsys):
    """``python -m theanompi_tpu_torch.tools.simfleet_run --gate``:
    128-worker determinism, then the 512-worker invariant suite inside the
    CPU budget."""
    assert simfleet_run.main(["--gate", "--seed", "7"]) == 0
    out = capsys.readouterr().out
    assert "seed+1 differs" in out and "simfleet gate: PASS" in out
    assert "[FAIL]" not in out


# -- the at-width invariant suite ---------------------------------------------

def test_invariant_suite_at_width_under_budget():
    """The at-width claim in-suite at 256 workers: full fault taxonomy,
    every invariant checker green, in CPU-seconds."""
    t0 = time.process_time()
    fleet = _run(n_workers=256, steps=2000, seed=11, sync_freq=16,
                 n_stragglers=10)
    cpu = time.process_time() - t0
    results = check_invariants(fleet)
    failures = [(n, d) for n, ok, d in results if not ok]
    assert not failures, failures
    assert cpu < 60.0, f"256-worker suite took {cpu:.1f}s CPU"
    s = fleet.summary
    assert s["finished"] == 256
    assert s["deaths"] >= 3                 # kills + the long wedge
    assert s["center"]["restarts"] == 1     # kill@10:0 restarted it
    assert sum(s["center"]["dedup_hits_per_shard"]) > 0
    assert s["frames_faulted"].get("net_dup", 0) > 0


def test_killed_wedged_delayed_worker_sequences():
    fleet = _run(n_workers=32, steps=2000, seed=11)
    seqs = sim_membership_sequence(fleet)
    assert seqs[3] == ["join", "death", "rejoin", "finish"]   # SIGKILL
    assert seqs[5] == ["join", "death", "rejoin", "finish"]   # long wedge
    assert seqs[9] == ["join", "finish"]                      # short wedge
    # the delay target straggles; it may be demoted (then readmitted or
    # respawned) but must finish
    assert seqs[11][0] == "join" and seqs[11][-1] == "finish"
    # the center outage pair landed in order
    evs = [r["ev"] for r in fleet.log.select("center_down",
                                             "center_restored")]
    assert evs == ["center_down", "center_restored"]


def test_straggler_demotion_and_alpha_freeze_at_width():
    fleet = _run(n_workers=64, steps=3000, seed=9, schedule=None,
                 n_stragglers=4)
    results = dict((n, (ok, d)) for n, ok, d in check_invariants(fleet))
    assert results["straggler_demotion_converges"][0], results
    assert results["alpha_conservation_under_churn"][0], results
    demoted = {r["worker"] for r in fleet.log.select("worker_demote")}
    assert set(fleet.stragglers) <= demoted


# -- clock seam: wall vs virtual equivalence ----------------------------------

def _scripted_controller(clock, base, table):
    ctl = mb.MembershipController(lease_timeout=10.0,
                                  telemetry_=None, clock=clock,
                                  lease_source=lambda: table)
    # identical scripted event sequence, timestamps relative to ``base``
    table[1] = {"worker": 1, "ts": base + 0.0, "step": 0, "status": "live"}
    table[2] = {"worker": 2, "ts": base + 0.0, "step": 0, "status": "live"}
    ctl.poll(now=base + 1.0)                 # both join
    ctl.demote(1, reason="straggler")
    table[2]["ts"] = base + 8.0              # 2 beats, 1 goes silent...
    ctl.poll(now=base + 9.0)                 # ...but not expired yet
    ctl.poll(now=base + 12.0)                # 1 expires (demoted+silent)
    ctl.leave(2, reason="crashed", now=base + 13.0)
    table[2]["ts"] = base + 12.5             # stale beat from before death
    ctl.poll(now=base + 14.0)                # must NOT resurrect 2
    table[2] = {"worker": 2, "ts": base + 15.0, "step": 0,
                "status": "live"}            # a real respawn beat
    ctl.poll(now=base + 16.0)                # rejoin via lease
    table[2]["ts"] = base + 17.0
    table[2]["status"] = "left"
    ctl.poll(now=base + 18.0)                # clean finish
    return [(ev, w, info.get("reason"), bool(info.get("rejoin")))
            for ev, w, info in ctl.transitions]


def test_controller_transitions_identical_wall_vs_virtual_clock():
    """The clock seam is behavior-preserving: the same scripted event
    sequence produces IDENTICAL transitions whether the port's controller
    runs on wall time or virtual time."""
    wall_base = time.time() - 3600.0         # arbitrary real epoch
    wall = _scripted_controller(WallClock(), wall_base, {})
    virt = _scripted_controller(VirtualClock(), 0.0, {})
    assert wall == virt
    assert [t[:3] for t in virt] == [
        ("worker_join", 1, "lease"), ("worker_join", 2, "lease"),
        ("worker_demote", 1, "straggler"),
        ("worker_leave", 1, "lease_expired"),
        ("worker_leave", 2, "crashed"),
        ("worker_join", 2, "lease"),
        ("worker_leave", 2, "finished")]
    # the rejoin flag carried through identically too
    assert virt[5][3] is True


def test_wall_clock_is_real_time():
    t = time.time()
    assert abs(WALL.now() - t) < 5.0
    assert isinstance(WALL, WallClock)


# -- transport fault semantics -----------------------------------------------

def _transport(schedule, center, seed=0, **kw):
    clock = VirtualClock()
    return clock, SimTransport(clock, random.Random(seed),
                               chaos.parse_schedule(schedule),
                               center=center, **kw)


def test_transport_drop_dup_corrupt_partition_semantics():
    center = SimCenter(n_shards=1)
    clock, tp = _transport(
        "net_drop@10:-1:5,net_dup@20:1:5,net_corrupt@30:-1:5", center)
    # clean push applies
    st, verdict, _ = tp.request_push(1, 0, 100)
    assert (st, verdict) == ("ok", "applied")
    # drop window: lost, client times out
    clock.advance_to(11.0)
    st, verdict, t_done = tp.request_push(1, 0, 101)
    assert st == "lost" and t_done == pytest.approx(11.0 + tp.op_timeout_s)
    # retry of the lost frame AFTER the window: same seq applies once
    clock.advance_to(16.0)
    st, verdict, _ = tp.request_push(1, 0, 101)
    assert (st, verdict) == ("ok", "applied")
    # dup window targeted at worker 1: twin applies get deduped
    clock.advance_to(21.0)
    st, verdict, _ = tp.request_push(1, 0, 102)
    assert (st, verdict) == ("ok", "applied")
    assert center.shards[0].window.hits == 1       # the swallowed twin
    assert tp.frames_faulted["net_dup"] == 1
    # ...and worker 2 is untouched by worker 1's window
    st, _, _ = tp.request_push(2, 0, 1)
    assert st == "ok" and tp.frames_faulted["net_dup"] == 1
    # corrupt window: retryable verdict, dedup window NOT consulted
    clock.advance_to(31.0)
    hits = center.shards[0].window.hits
    st, verdict, _ = tp.request_push(1, 0, 103)
    assert (st, verdict) == ("retry", "corrupt")
    assert center.shards[0].window.hits == hits
    # exactly-once ledger stayed clean through all of it
    assert not center.shards[0].violations


def test_transport_partition_ack_loss_then_dedup():
    """The case the tokens exist for: the op APPLIES, the ack is lost in
    a partition, the retry is answered from the dedup window."""
    center = SimCenter(n_shards=1)
    # window opens just after delivery (~58.004) and covers the reply
    clock, tp = _transport("net_partition@58.005:-1:2", center,
                           latency_jitter=0.0)
    clock.advance_to(58.0)
    st, verdict, _ = tp.request_push(4, 0, 7)
    assert st == "lost"
    assert center.shards[0].applied_by_worker.get(4) == 1   # it landed
    clock.advance_to(61.0)
    st, verdict, _ = tp.request_push(4, 0, 7)               # the retry
    assert (st, verdict) == ("ok", "dedup")
    assert center.shards[0].applied_by_worker.get(4) == 1   # ONCE
    assert not center.shards[0].violations


def test_center_crash_restore_dedups_replays_at_width():
    center = SimCenter(n_shards=2)
    for w in range(1, 201):
        for shard in (0, 1):
            center.apply_push(shard, w, 1000 + w)
    center.crash_and_restore(now=50.0, outage_s=2.0)
    assert center.is_down(51.0) and not center.is_down(52.5)
    # replays of every pre-crash token are recognized post-restore
    for w in range(1, 201):
        for shard in (0, 1):
            assert center.apply_push(shard, w, 1000 + w) == "dedup"
    assert not center.shards[0].violations
    assert not center.shards[1].violations
    # fresh seqs above the restored HWM still apply
    assert center.apply_push(0, 7, 5000) == "applied"


# -- realized schedule export / replay grammar --------------------------------

def test_realized_export_parses_back_into_the_chaos_grammar(tmp_path):
    fleet = _run(n_workers=16, steps=1200, seed=11)
    path = str(tmp_path / "sim_realized.jsonl")
    export_realized(fleet.realized, path, min_at=6.0)
    sched = chaos.schedule_from_realized(path)
    kinds = {(f.kind, f.target) for f in sched}
    assert ("kill", 3) in kinds and ("kill", 7) in kinds
    assert ("kill", 0) in kinds                   # the center kill
    assert any(f.kind == "net_dup" for f in sched)
    assert all(f.at >= 6.0 for f in sched)        # re-timed for live boot
    # faults that never landed are excluded from the replay
    err = [d for d in fleet.realized if d.get("error")]
    assert len(sched) == len(fleet.realized) - len(err)


def test_normalize_sequence_collapses_double_observations():
    evs = [
        {"ev": "worker_join", "worker": 1, "reason": "spawn"},
        {"ev": "worker_leave", "worker": 1, "reason": "lease_expired"},
        {"ev": "worker_leave", "worker": 1, "reason": "crashed"},
        {"ev": "worker_join", "worker": 1, "reason": "respawn",
         "rejoin": True},
        {"ev": "worker_leave", "worker": 1, "reason": "finished"},
    ]
    assert normalize_sequence(evs) == {
        1: ["join", "death", "rejoin", "finish"]}


# -- fidelity: the live cross-check (island processes on the CPU) -------------

def test_fidelity_crosscheck_sim_matches_live(tmp_path, monkeypatch):
    """The acceptance cross-check: one simulated kill schedule, exported
    and replayed through the port's live ChaosMonkey + elastic runtime at
    4 islands on the CPU (``host_devices=1``) — same membership-event
    sequence, modulo timing."""
    from theanompi_tpu_torch.simfleet.fidelity import crosscheck
    for k, v in helper.RANK_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [HERE, REPO, os.environ.get("PYTHONPATH", "")]))
    out = crosscheck(str(tmp_path), n_workers=4, schedule="kill@6:1",
                     steps=40, seed=0, modelfile="torch_port_helper",
                     modelclass="SleepyLRNNet", host_devices=1)
    assert out["live_rc"] == 0
    assert out["sim"] == out["live"], (out["sim"], out["live"])
    assert out["ok"] is True
    assert out["sim"][1] == ["join", "death", "rejoin", "finish"]


# -- parity with the JAX package's FleetSim -----------------------------------

PARITY = {
    # the determinism gate's 128-worker pair, and its seed+1 fleet
    "gate_seed7": dict(n_workers=128, steps=1200, sync_freq=8, seed=7,
                       n_faults=5, net_n_faults=4, n_stragglers=4),
    "gate_seed8": dict(n_workers=128, steps=1200, sync_freq=8, seed=8,
                       n_faults=5, net_n_faults=4, n_stragglers=4),
    # the gate's 512-worker invariant run
    "invariants_512": dict(n_workers=512, steps=2000, sync_freq=16, seed=7,
                           n_faults=10, net_n_faults=6, n_stragglers=10,
                           fault_t_min=8.0, fault_t_max=60.0),
    # the health plane on four center shards
    "fleetmon_4_shards": dict(n_workers=64, steps=2000, sync_freq=8,
                              seed=3, n_shards=4, fleetmon=True,
                              n_faults=5, net_n_faults=4, n_stragglers=3),
    # a center kill, a wedge and the net windows, explicitly
    "explicit_schedule": dict(n_workers=64, steps=2000, sync_freq=8,
                              seed=11, n_stragglers=3,
                              schedule=FULL_SCHEDULE),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fleet_log_is_the_jax_fleets_byte_for_byte(case):
    from theanompi_tpu.simfleet import FleetSim as JaxFleetSim
    from theanompi_tpu.simfleet import check_invariants as jax_check
    from theanompi_tpu.utils import chaos as jax_chaos
    kw = dict(PARITY[case])
    spec = kw.pop("schedule", None)
    jax = JaxFleetSim(schedule=jax_chaos.parse_schedule(spec)
                      if spec else None, **kw)
    port = FleetSim(schedule=chaos.parse_schedule(spec)
                    if spec else None, **kw)
    jax.run()
    port.run()
    assert port.summary == jax.summary
    assert port.log.sha256() == jax.log.sha256()
    assert port.realized == jax.realized
    assert check_invariants(port) == jax_check(jax)
    if kw.get("fleetmon"):
        assert port.summary["fleetmon"]["alerts"] > 0


def test_crosscheck_exports_the_jax_schedule(tmp_path):
    """A fidelity-sized 4-worker cross-check, sim half only: the port's
    exported ``sim_realized.jsonl`` is the JAX package's, byte for byte,
    and so are the simulated membership sequences."""
    from theanompi_tpu.simfleet.fidelity import crosscheck as jax_cc
    from theanompi_tpu_torch.simfleet.fidelity import crosscheck
    spec = "kill@6:1,stop@8:2:3,net_dup@5:-1:4"
    jax = jax_cc(str(tmp_path / "jax"), n_workers=4, schedule=spec,
                 steps=40, seed=0, run_live=False)
    port = crosscheck(str(tmp_path / "port"), n_workers=4, schedule=spec,
                      steps=40, seed=0, run_live=False)
    with open(jax["realized_path"], "rb") as f:
        jax_bytes = f.read()
    with open(port["realized_path"], "rb") as f:
        assert f.read() == jax_bytes
    assert port["sim"] == jax["sim"]
    assert port["sim"][1] == ["join", "death", "rejoin", "finish"]
