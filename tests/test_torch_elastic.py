"""Elastic island runs of the port on the CPU, process for process: the
counterparts of ``tests/test_chaos.py``'s fast elastic gates.

``run_elastic`` (``theanompi_tpu_torch/parallel/membership.py``) spawns a
center and two island processes of ``SleepyLRNNet``
(``tests/torch_port_helper.py``: ``TinyLRNNet`` that sleeps
``iter_sleep`` a step, the counterpart of ``tests/conftest.py``'s
``SleepyModel``) under the elastic supervisor, and the chaos harness
injects its faults once a lease reports a step (progress-gated):

* a SIGKILL of island 1: it leaves (crashed), is respawned, rejoins from
  the center and finishes, island 2 untouched, with no world restart;
* a ``corrupt`` fault on island 1: the perturbation is applied, every
  island's divergence beacon raises ``replica_divergence`` at the fleet
  monitor, and ``audit_alerts`` closes over the realized fault.

The center's SIGKILL under ``center_proc`` is in
``test_torch_elastic_center.py`` (the files spread over the workers).
Every spawned process runs one CPU thread (``torch_port_helper.RANK_ENV``).
"""

import glob
import json
import os
import sys

import pytest

from theanompi_tpu_torch.parallel import membership as mb
from theanompi_tpu_torch.utils import chaos, fleetmon

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402

MODEL = ("torch_port_helper", "SleepyLRNNet")
SUPERVISOR = {"poll_s": 0.2, "lease_timeout": 60.0}


@pytest.fixture
def island_env(monkeypatch):
    """The spawned processes: the tests' helper importable, one thread."""
    for k, v in helper.RANK_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [HERE, REPO, os.environ.get("PYTHONPATH", "")]))


def merged_events(record_dir):
    events = []
    for p in sorted(glob.glob(os.path.join(record_dir,
                                           "telemetry_rank*.jsonl"))):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        pass
    return events


def run(record_dir, cfg, schedule, steps=40, **kw):
    return mb.run_elastic(
        "easgd", *MODEL, dict(cfg), 2, record_dir=record_dir, steps=steps,
        host_devices=1, chaos_schedule=schedule, timeout_s=420,
        supervisor_kw=dict(SUPERVISOR, backoff=mb.Backoff(base=0.3)), **kw)


def test_elastic_easgd_survives_sigkill_and_rejoins(tmp_path, island_env):
    """SIGKILL island 1 mid-run: the EASGD run completes without a world
    restart, the stream holds the leave/join pair, and the respawned
    island restored from the center and pushed again."""
    record_dir = str(tmp_path)
    schedule = chaos.parse_schedule("kill@6:1")
    # the monkey's clock starts at the first lease with a step, and
    # iter_sleep stretches the run past the kill: ≥ 40 · 0.25 = 10 s
    rc = run(record_dir, {"sync_freq": 2, "iter_sleep": 0.25}, schedule)
    assert rc == 0
    assert schedule[0].error is None, "the kill never landed"
    events = merged_events(record_dir)
    kinds = [(e["ev"], e.get("worker"), e.get("reason")) for e in events
             if e["ev"] in mb.MEMBERSHIP_EVENTS + (chaos.FAULT_EVENT,)]
    assert ("fault_injected", 1, None) in kinds
    crash_leaves = [k for k in kinds if k[0] == "worker_leave" and k[1] == 1
                    and k[2] in ("crashed", "wedged", "lease_expired")]
    rejoins = [e for e in events if e["ev"] == "worker_join"
               and e.get("worker") == 1 and e.get("rejoin")]
    assert crash_leaves, kinds
    assert rejoins, kinds
    finished = [k for k in kinds if k[0] == "worker_leave"
                and k[2] == "finished"]
    assert {k[1] for k in finished} == {1, 2}
    assert len([e for e in events if e["ev"] == "worker_join"
                and e.get("worker") == 2]) == 1       # never restarted
    # the respawned island (its own stream, rank 1) ran to its goal
    ends = [e for e in events if e["ev"] == "train_end"
            and e.get("rank") == 1]
    assert len(ends) == 1 and ends[0]["steps"] >= 40 and \
        ends[0]["exchanges"] >= 1
    with open(os.path.join(record_dir, "center_stats.json")) as f:
        stats = json.load(f)
    assert stats["n_updates"] == sum(stats["by_island"].values())
    assert stats["by_island"]["1"] >= 1 and stats["by_island"]["2"] >= 1
    # a finished island leaves, and the center drops its pushes from then
    assert stats["demoted"] == [1, 2]
    assert os.path.exists(os.path.join(record_dir, "center_final.npz"))


def test_elastic_corrupt_chaos_raises_replica_divergence(tmp_path,
                                                         island_env):
    """A ``corrupt`` fault perturbs island 1's live params in place (the
    bad value never crosses the wire as a frame, so no CRC sees it); its
    ``‖p − c‖`` jumps at its next exchange, and the center's move jumps
    island 2's after; the fleet monitor's ``replica_divergence`` rule
    alerts on both, and the coverage audit closes over the fault."""
    record_dir = str(tmp_path)
    # the third field is the scale: the threshold (10) sits between the
    # healthy drift (under 1 for this model) and the jump, 50·√16 = 200
    schedule = chaos.parse_schedule("corrupt@2:1:50")
    rc = run(record_dir, {"sync_freq": 2, "iter_sleep": 0.25,
                          "fleetmon": True, "fleetmon_divergence": 10.0,
                          "fleetmon_eval_s": 0.5}, schedule)
    assert rc == 0
    assert schedule[0].error is None, "the corrupt fault never landed"
    assert not os.path.exists(os.path.join(record_dir, "chaos",
                                           "corrupt_w1.json"))
    events = merged_events(record_dir)
    applied = [e for e in events if e["ev"] == "corrupt_applied"]
    assert [(e["rank"], e["island"], e["scale"]) for e in applied] == \
        [(1, 1, 50.0)]
    assert any(e["ev"] == chaos.FAULT_EVENT and e.get("kind") == "corrupt"
               for e in events)
    alerts = [e for e in events if e["ev"] == fleetmon.ALERT_EVENT]
    div_alerts = [a for a in alerts if a["rule"] == "replica_divergence"]
    # EASGD: the poisoned push moves the center, so both islands' distance
    # to it jumps
    assert {a["worker"] for a in div_alerts} == {1, 2}, alerts
    with open(os.path.join(record_dir, "chaos_realized.jsonl")) as f:
        realized = [json.loads(ln) for ln in f if ln.strip()]
    rules = fleetmon.default_rules(heartbeat_s=10.0, divergence=10.0)
    # interval_s covers the symptom's pipeline: the island reads the
    # trigger at its next round (≤ 2 · iter_sleep), then one streamer
    # beat (1 s) carries the beacon
    ok, lines = fleetmon.audit_alerts(alerts, realized, rules,
                                      eval_window_s=0.5, interval_s=4.0)
    assert ok, "\n".join(lines)
    assert any("corrupt" in ln and "replica_divergence" in ln
               for ln in lines)
    # the fleet view: every island and the supervisor streamed, and the
    # islands retired cleanly (their final `left` samples)
    with open(os.path.join(record_dir, "fleetmon_snap",
                           "fleetmon_state.json")) as f:
        col = json.load(f)["collector"]
    assert col["roles"] == {"-2": "supervisor", "1": "worker",
                            "2": "worker"}
    assert sorted(col["retired"]) == [1, 2]
    assert {"steps", "step_p99", "divergence", "wire_rtt_p50"} <= \
        set(col["series"]["1"])
