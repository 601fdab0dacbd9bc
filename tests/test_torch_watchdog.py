"""The port's stall watchdog (``theanompi_tpu_torch/utils/watchdog.py``),
its place in the worker loop, and the flight trail a dead worker leaves.

* The monitor: one firing per stall episode, re-armed by the next beat,
  silent while the loop beats, off at ``stall_timeout`` 0, and the first
  beat's larger threshold, as the JAX package's ``StallWatchdog`` (both
  packages' watchdogs driven the same way side by side).
* In the worker: a slow step trips the default handler (its stall event
  and flight dump land in ``record_dir``), training completes; the
  monitor thread calls no ``torch.cuda`` function.
* A supervised world (``launcher.py --supervise``) recovers from a hang:
  ``stall_action=exit`` ends the hung worker with code 42 after its flight
  dump, the launcher sweeps the dump into ``crash_attempt0_rc42/`` and the
  restart resumes from the checkpoint and finishes.
* A worker process dumps its flight ring on SIGTERM and dies by the
  signal.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from theanompi_tpu.utils.watchdog import StallWatchdog as JStallWatchdog
from theanompi_tpu_torch.utils import telemetry
from theanompi_tpu_torch.utils.watchdog import StallWatchdog

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_telemetry import ENV  # noqa: E402


@pytest.fixture(autouse=True)
def _reset():
    yield
    telemetry.init({})


def _episodes(cls):
    events = []
    wd = cls(timeout_s=0.15, poll_s=0.03,
             on_stall=lambda el, label: events.append(label))
    with wd:
        wd.beat("iter 1")
        time.sleep(0.4)              # a stall: one firing
        n1 = len(events)
        wd.beat("iter 2")            # the beat re-arms
        time.sleep(0.4)
        n2 = len(events)
        for i in range(6):           # beating: silent
            wd.beat(f"iter {3 + i}")
            time.sleep(0.03)
        n3 = len(events)
    quiet = cls(timeout_s=0)
    quiet.start()
    return {"counts": (n1, n2, n3), "labels": events[:2],
            "stalls": wd.stall_count, "off": quiet._thread is None}


def test_watchdog_fires_once_per_stall_and_rearms_as_jax():
    got, want = _episodes(StallWatchdog), _episodes(JStallWatchdog)
    assert got == want
    assert got["counts"] == (1, 2, 2) and got["labels"] == ["iter 1",
                                                            "iter 2"]
    first = []
    wd = StallWatchdog(timeout_s=0.05, poll_s=0.02, first_timeout_s=0.5,
                       on_stall=lambda el, label: first.append(label))
    with wd:
        time.sleep(0.2)              # before the first beat: the larger bound
        assert first == []
        time.sleep(0.5)
    assert first == ["(no heartbeat yet)"]


def test_worker_stall_dumps_flight_and_touches_no_cuda(tmp_path,
                                                      monkeypatch):
    import torch
    import theanompi_tpu_torch as T
    monitor_calls = []
    main = threading.main_thread()
    for name in ("synchronize", "is_available", "is_initialized",
                 "memory_stats", "current_stream", "device_count"):
        fn = getattr(torch.cuda, name)

        def spy(*a, _fn=fn, _name=name, **k):
            if threading.current_thread() is not main:
                monitor_calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(torch.cuda, name, spy)
    d = str(tmp_path)
    r = T.BSP()
    r.init(devices=1, modelfile="torch_launch_helper", modelclass="SleepyNet",
           device="cpu", verbose=False, epochs=1, iter_sleep=0.4,
           stall_timeout=0.15, record_dir=d, printFreq=2)
    rec = r.wait()
    assert len(rec.train_records) > 0 and r.worker.watchdog.stall_count > 0
    assert monitor_calls == []
    with open(os.path.join(d, "flight_rank0.jsonl")) as f:
        head = json.loads(f.readline())
    assert head["reason"].startswith("watchdog stall")
    with open(os.path.join(d, "telemetry_rank0.jsonl")) as f:
        stalls = [json.loads(line) for line in f
                  if '"ev": "stall"' in line]
    assert stalls and stalls[0]["action"] == "trace"


def test_supervised_world_recovers_from_a_hang(tmp_path):
    rec, ck = str(tmp_path / "rec"), str(tmp_path / "ck")
    marker = str(tmp_path / "hung")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher", "--supervise",
         "1", "--backoff", "0.1", "--modelfile", "torch_ops_helper",
         "--modelclass", "HangOnceNet", "--n-workers", "1", "device=cpu",
         "epochs=2", "verbose=false", "stall_timeout=1.0",
         "stall_action=exit", f"ckpt_dir={ck}", f"record_dir={rec}",
         f"hang_marker={marker}", "hang_at=5"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert time.time() - t0 < 200 and os.path.exists(marker)
    assert "restarting in" in r.stderr
    crash = os.path.join(rec, "crash_attempt0_rc42")
    assert os.listdir(crash) == ["flight_rank0.jsonl"]
    with open(os.path.join(crash, "flight_rank0.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["reason"].startswith("watchdog stall")
    assert any(e["ev"] == "beat" for e in lines)
    assert not any(n.startswith("flight") for n in os.listdir(rec))
    with open(os.path.join(ck, "LATEST")) as f:
        assert int(f.read()) == 1


def test_sigterm_dumps_the_flight_ring(tmp_path):
    d = str(tmp_path)
    p = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.worker", "bsp",
         "torch_launch_helper", "SleepyNet", "device=cpu", "iter_sleep=0.2",
         "epochs=50", "verbose=false", f"record_dir={d}"],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        t0 = time.time()
        path = os.path.join(d, "telemetry_rank0.jsonl")
        while time.time() - t0 < 120:
            if os.path.exists(path) and os.path.getsize(path) > 0:
                break
            assert p.poll() is None, p.communicate()[0][-3000:]
            time.sleep(0.05)
        time.sleep(1.0)                  # a few steps into the ring
        p.send_signal(signal.SIGTERM)
        p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == -signal.SIGTERM
    with open(os.path.join(d, "flight_rank0.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["reason"] == f"signal {int(signal.SIGTERM)}"
    assert any(e["ev"] == "fatal_signal" for e in lines)
    assert any(e["ev"] == "phase" for e in lines)
