"""The port's chaos-run tool (``python -m
theanompi_tpu_torch.tools.chaos_run``), the counterpart of
``scripts/chaos_run.py``, on the CPU (``--host-devices 1``):

* 3 elastic EASGD islands under a SIGKILL and a ``net_dup`` window, the
  fleet monitor on: the membership, center (dedup) and alert audits pass,
  the final center's validation cost is finite, exit 0;
* a schedule rehearsed by the port's ``tools.simfleet_run`` and replayed
  with ``--faults-from``;
* ``--rule bsp``: a SIGKILL under the port's ``launcher --supervise``,
  the world restarted and finished;
* each audit refusing a doctored record directory with the exit code the
  JAX script gives the same directory (4), and passing a sound one (0).

Every spawned process runs one CPU thread (``torch_port_helper.RANK_ENV``).
"""

import json
import os
import subprocess
import sys

import pytest

from theanompi_tpu_torch.tools import chaos_run, simfleet_run
from theanompi_tpu_torch.utils import chaos

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402

ENV = dict(os.environ, **helper.RANK_ENV,
           PYTHONPATH=os.pathsep.join([HERE, REPO,
                                       os.environ.get("PYTHONPATH", "")]))
# the islands: the tool's default model (the fault drill's tiny LRN net)
# slowed to 0.2 s a step, so a fault lands mid-run
ISLANDS = ["--host-devices", "1", "--lease-timeout", "60", "sync_freq=2",
           "iter_sleep=0.2"]


def tool(name, *args, timeout=300):
    """``python -m theanompi_tpu_torch.tools.<name> args``: (rc, output)."""
    r = subprocess.run([sys.executable, "-m",
                        f"theanompi_tpu_torch.tools.{name}", *args],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=timeout)
    return r.returncode, r.stdout + r.stderr


def test_easgd_kill_and_net_dup_pass_every_audit(tmp_path):
    """The proxy's windows count from its start, not from the first step:
    the ``net_dup`` window spans the whole run, so frames cross it however
    long the islands take to start."""
    rec = str(tmp_path / "rec")
    rc, out = tool("chaos_run", "--workers", "3", "--steps", "30",
                   "--faults", "kill@3:1", "--net-faults", "net_dup@0:-1:300",
                   "--fleetmon", "--verify-loss", "--record-dir", rec,
                   *ISLANDS)
    assert rc == 0, out[-4000:]
    assert "worker_leave worker=1 reason=crashed" in out
    assert "worker_join worker=1 reason=respawn" in out
    assert "duplicate(s) deduplicated" in out
    assert "alert audit: PASS" in out and "chaos gate: PASS" in out
    with open(os.path.join(rec, "chaos_gate.json")) as f:
        gate = json.load(f)
    assert gate["kills"] == [1] and 0.0 < gate["val_cost"] < 10.0


def test_faults_from_a_simfleet_rehearsal(tmp_path):
    """The two-command recipe: rehearse at the live width, replay the
    realized schedule through the live islands."""
    realized = str(tmp_path / "sim" / "sim_realized.jsonl")
    assert simfleet_run.main([
        "--workers", "3", "--steps", "400", "--sync-freq", "2",
        "--faults", "kill@3:2", "--net-faults", "net_dup@2:-1:3",
        "--stragglers", "0", "--realized-out", realized]) == 0
    sched = chaos.schedule_from_realized(realized)
    assert [(f.kind, f.target) for f in sched] == [("net_dup", -1),
                                                   ("kill", 2)]
    rec = str(tmp_path / "rec")
    rc, out = tool("chaos_run", "--workers", "3", "--steps", "30",
                   "--faults-from", realized, "--record-dir", rec,
                   *ISLANDS)
    assert rc == 0, out[-4000:]
    assert "chaos schedule: [kill@3:w2]" in out
    assert "worker_join worker=2 reason=respawn" in out
    assert "chaos gate: PASS" in out
    # a realized file from a wider fleet keeps the faults this width has
    wide = str(tmp_path / "wide.jsonl")
    with open(wide, "w") as f:
        f.write(json.dumps({"kind": "kill", "target": 9, "rel": 3.0,
                            "duration": 0.0, "error": None}) + "\n")
    rc, out = tool("chaos_run", "--workers", "3", "--faults-from", wide,
                   "--record-dir", str(tmp_path / "none"), *ISLANDS)
    assert rc == 2 and "nothing left to replay" in out


def test_bsp_kill_under_the_supervising_launcher(tmp_path):
    ck = str(tmp_path / "ck")
    rc, out = tool("chaos_run", "--rule", "bsp", "--faults", "kill@4:0",
                   "--record-dir", str(tmp_path / "rec"), "--host-devices",
                   "1", "--modelfile", "torch_launch_helper", "--modelclass",
                   "SleepyNet", "epochs=2", "batch_size=8", "iter_sleep=0.5",
                   f"ckpt_dir={ck}", "verbose=false")
    assert rc == 0, out[-4000:]
    assert "faults applied: [kill@4:w0]" in out
    assert "restarting in" in out                 # the world restarted
    assert os.path.exists(os.path.join(ck, "LATEST"))


# -- the audits on doctored record directories --------------------------------

def _ev(ts, ev, **kw):
    return dict(ts=1000.0 + ts, ev=ev, rank=0, **kw)


SOUND = [_ev(0, "worker_join", worker=1, reason="spawn"),
         _ev(3, "fault_injected", worker=1, kind="kill"),
         _ev(4, "worker_leave", worker=1, reason="crashed"),
         _ev(5, "worker_join", worker=1, reason="respawn", rejoin=True),
         _ev(20, "worker_leave", worker=1, reason="finished")]
STATS = {"n_updates": 10, "by_island": {"1": 6, "2": 4}, "dedup_hits": 3,
         "net_frames_faulted": {"net_dup": 3}}

# name: (tool flags, telemetry events, center stats, realized docs, rc)
DOCTORED = {
    "sound": (["--faults", "kill@3:1", "--net-faults", "net_dup@2:-1:3"],
              SOUND, STATS, [], 0),
    "no_crash_leave": (["--faults", "kill@3:1"],
                       [e for e in SOUND if e["ev"] != "worker_leave"
                        or e["reason"] != "crashed"], STATS, [], 4),
    "no_rejoin": (["--faults", "kill@3:1"],
                  [e for e in SOUND if not e.get("rejoin")], STATS, [], 4),
    "center_never_restored": (
        ["--faults", "kill@3:0"],
        SOUND + [_ev(6, "center_down", worker=0, reason="crashed")],
        STATS, [], 4),
    "dups_not_deduplicated": (["--net-faults", "net_dup@2:-1:3"], SOUND,
                              dict(STATS, dedup_hits=0), [], 4),
    "applied_twice": (["--faults", "kill@3:1"], SOUND,
                      dict(STATS, n_updates=11), [], 4),
    "wedge_never_alerted": (
        ["--faults", "stop@3:1:15", "--fleetmon"], SOUND, STATS,
        [{"ts": 1003.0, "rel": 3.0, "kind": "stop", "target": 1,
          "duration": 15.0, "pid": 7, "error": None, "source": "monkey"}],
        4),
}


def _fake_run(events, stats, realized):
    """A ``run_elastic`` that lands every fault and leaves ``events``,
    ``stats`` and ``realized`` as the run's records."""
    def run(rule, modelfile, modelclass, config, n, *, record_dir,
            chaos_schedule=None, net_chaos_schedule=None, **_):
        for f in list(chaos_schedule or ()) + list(net_chaos_schedule or ()):
            f.applied = True
        with open(os.path.join(record_dir, "telemetry_rank0.jsonl"),
                  "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in events)
        with open(os.path.join(record_dir, "center_stats.json"), "w") as f:
            json.dump(stats, f)
        with open(os.path.join(record_dir, chaos.REALIZED_SCHEDULE),
                  "w") as f:
            f.writelines(json.dumps(d) + "\n" for d in realized)
        return 0
    return run


@pytest.mark.parametrize("case", sorted(DOCTORED))
def test_audits_refuse_doctored_records_as_the_jax_script_does(
        case, tmp_path, monkeypatch, capsys):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chaos_run as jax_chaos_run
    from theanompi_tpu.parallel import membership as jax_mb
    from theanompi_tpu_torch.parallel import membership as mb
    flags, events, stats, realized, want = DOCTORED[case]
    fake = _fake_run(events, stats, realized)
    monkeypatch.setattr(jax_mb, "run_elastic", fake)
    monkeypatch.setattr(mb, "run_elastic", fake)
    fails = {}
    for name, main in (("jax", jax_chaos_run.main),
                       ("port", chaos_run.main)):
        rc = main(flags + ["--record-dir", str(tmp_path / name)])
        out = capsys.readouterr().out
        assert rc == want, (name, out)
        fails[name] = [ln for ln in out.splitlines() if "FAIL" in ln]
    assert fails["port"] == fails["jax"]
    assert bool(fails["port"]) == (want != 0)
