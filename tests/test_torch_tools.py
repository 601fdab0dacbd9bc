"""The port's tools (``theanompi_tpu_torch/tools/``) against the JAX
package's scripts under ``scripts/``.

* C19: the port's package alone (no ``scripts/`` beside it) ranks
  stragglers through its own report, ``tools/telemetry_report.py``, and
  the ranking equals the JAX script's on the same record dir.
* ``telemetry_report``: on record dirs that port runs wrote (a 2-rank
  gloo BSP world with tracing and numerics; an elastic island run whose
  center process streams as rank -1), the text, ``--json`` and
  ``--trace`` outputs equal the JAX script's byte for byte.
* ``fleetz``: against a live port center server and worker, the
  ``--json --iterations 1`` rows equal the JAX script's apart from the
  uptimes and timestamps; a SIGKILLed worker is DOWN and the exit code 2.
* ``plot_records``: loads without matplotlib and reads a port run's
  records as the JAX script does.
* ``profile_model`` and ``loader_bench``: the JSON keys of the JAX
  scripts, a run to the end on the CPU when ``--host-devices`` asks for
  it, and a refusal of the CPU when it does not.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")]))


def jax_script(name):
    """One of the JAX package's stdlib scripts, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_streams(d, slow_rank=1, windows=6, window_s=1.0):
    """Two ranks' telemetry streams over ``windows`` windows of
    ``window_s`` seconds, ``slow_rank``'s train steps twice as long."""
    from theanompi_tpu_torch.utils.telemetry import Telemetry
    t0 = 1.7e9
    for rank in (0, 1):
        tm = Telemetry(rank=rank, run_id="c19", stream_dir=d)
        tm.close()
        with open(os.path.join(d, f"telemetry_rank{rank}.jsonl"), "a") as f:
            for i in range(windows * 4):
                dt = 0.2 if rank == slow_rank else 0.1
                f.write(json.dumps({"ts": t0 + i * window_s / 4,
                                    "run": "c19", "rank": rank,
                                    "ev": "phase", "sec": "train",
                                    "dt": dt}) + "\n")
    return d


# -- C19 ----------------------------------------------------------------------

_C19_CHILD = r"""
import json, sys
from theanompi_tpu_torch.parallel import membership as mb
mod = mb._load_report_module()
ctl = mb.MembershipController(record_dir=sys.argv[1], straggle_window_s=1.0)
print(json.dumps({"module": getattr(mod, "__name__", None),
                  "ranking": ctl.straggler_ranking()}))
"""


def test_c19_port_package_alone_ranks_stragglers(tmp_path):
    """The port's package copied alone into a directory, without
    ``scripts/``: its controller loads the port's report and its windowed
    straggler ranking equals the JAX script's on the same streams."""
    root = tmp_path / "alone"
    shutil.copytree(os.path.join(REPO, "theanompi_tpu_torch"),
                    root / "theanompi_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = write_streams(str(tmp_path / "rec"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root))
    r = subprocess.run([sys.executable, "-c", _C19_CHILD, d], cwd=str(root),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["module"] == "theanompi_tpu_torch.tools.telemetry_report"
    jax_rep = jax_script("telemetry_report")
    want = jax_rep.straggler_ranking(jax_rep.load_events(d), 1.0)
    assert got["ranking"] == json.loads(json.dumps(want))
    assert got["ranking"][0]["rank"] == 1 and \
        got["ranking"][0]["windows_straggled"] > 0


# -- telemetry_report -----------------------------------------------------------

@pytest.fixture(scope="module")
def record_dirs(tmp_path_factory):
    """Two record dirs of port runs: a 2-rank gloo BSP world with tracing
    and numerics (launched), and an elastic EASGD run of two islands
    around a center process, which streams as rank -1."""
    from theanompi_tpu_torch.parallel import membership as mb
    root = tmp_path_factory.mktemp("records")
    bsp = str(root / "bsp")
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "torch_port_helper", "--modelclass", "TinyLRNNet",
         "--n-workers", "2", "device=cpu", "batch_size=4", "printFreq=2",
         "epochs=1", "verbose=false", f"record_dir={bsp}", "tracing=true",
         "numerics=true"], cwd=REPO, env=ENV, capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    isl = str(root / "islands")
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "PYTHONPATH")}
    os.environ.update(OMP_NUM_THREADS="1", PYTHONPATH=ENV["PYTHONPATH"])
    try:
        rc = mb.run_elastic(
            "easgd", "torch_port_helper", "TinyLRNNet",
            {"sync_freq": 2, "tracing": True}, 2, record_dir=isl, steps=8,
            host_devices=1, center_proc=True, timeout_s=240, verbose=False,
            supervisor_kw={"poll_s": 0.2, "lease_timeout": 60.0,
                           "backoff": mb.Backoff(base=0.3)})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    assert os.path.exists(os.path.join(isl, "telemetry_rank-1.jsonl"))
    return {"bsp": bsp, "islands": isl}


def _report(cmd, record_dir, cwd, *flags):
    os.makedirs(cwd, exist_ok=True)
    r = subprocess.run(cmd + [record_dir, *flags], cwd=cwd, env=ENV,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    return r.stdout


@pytest.mark.parametrize("which", ["bsp", "islands"])
@pytest.mark.parametrize("flags", [
    ("--json", "rep.json", "--trace", "trace.json"),
    ("--window", "2", "--json", "-"),
    ("--last", "TAIL", "--trace", "trace.json")],
    ids=["json-trace", "window-json-stdout", "last-trace"])
def test_telemetry_report_equals_jax_byte_for_byte(record_dirs, tmp_path,
                                                    which, flags):
    """The port's report and the JAX script over one record dir: the
    text, the ``--json`` document and the ``--trace`` file, byte for
    byte (each run in a directory of its own, the files under the same
    relative names).  ``--last`` takes the stream's tail from just before
    its last train phase: a loaded host stretches a run's teardown past
    any fixed window, and the tail must still cut the run's start."""
    d = record_dirs[which]
    if "TAIL" in flags:
        from theanompi_tpu_torch.tools import telemetry_report as tr
        _, hi = tr.stream_extent(d)
        events = tr.load_events(d)
        t = max(ev["ts"] for ev in events
                if ev["ev"] == "phase" and ev.get("sec") == "train")
        tail = round(hi - t + 0.002, 3)
        assert len(tr.load_events(d, since=hi - tail)) < len(events)
        flags = tuple(str(tail) if f == "TAIL" else f for f in flags)
    mine = str(tmp_path / "port")
    theirs = str(tmp_path / "jax")
    got = _report([sys.executable, "-m",
                   "theanompi_tpu_torch.tools.telemetry_report"], d, mine,
                  *flags)
    want = _report([sys.executable,
                    os.path.join(REPO, "scripts", "telemetry_report.py")],
                   d, theirs, *flags)
    assert got == want
    assert b"straggler" in got
    for name in ("rep.json", "trace.json"):
        if name in flags:
            with open(os.path.join(mine, name), "rb") as f, \
                    open(os.path.join(theirs, name), "rb") as g:
                assert f.read() == g.read()
    if which == "islands" and "--json" in flags and "-" in flags:
        rep = json.loads(got.decode().splitlines()[-1])
        assert -1 in rep["ranks"] and rep["traces"]["rounds"] > 0


# -- fleetz ---------------------------------------------------------------------

def _wait_docs(d, roles, procs, timeout=120):
    from theanompi_tpu_torch.utils import tracing
    t0 = time.time()
    while time.time() - t0 < timeout:
        docs = tracing.read_statusz_docs(d)
        if {x["role"] for x in docs} >= set(roles):
            return docs
        for p in procs:
            assert p.poll() is None, p.communicate()[0][-3000:]
        time.sleep(0.05)
    raise AssertionError(f"no {roles} statusz docs in {d}")


def _fleetz(cmd, d):
    r = subprocess.run(cmd + [d, "--json", "--iterations", "1"], cwd=REPO,
                       env=ENV, capture_output=True, text=True, timeout=60)
    return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])


def _steady(v):
    """A fleetz row without what moves between two probes: uptimes,
    timestamps (at any depth)."""
    if isinstance(v, dict):
        return {k: _steady(x) for k, x in v.items()
                if k not in ("uptime_s", "ts") and not k.endswith("_ts")}
    if isinstance(v, list):
        return [_steady(x) for x in v]
    return v


def test_fleetz_rows_equal_jax_and_down_exits_2(tmp_path):
    """A live port center server and a port worker (its first step held
    by a long sleep) in one record dir: the port's and the JAX script's
    ``--json --iterations 1`` rows equal, uptimes and timestamps apart,
    exit 0; the worker SIGKILLed leaves its discovery file, and both
    report it DOWN with exit 2."""
    d = str(tmp_path / "rec")
    center = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.parallel.center_server",
         "--port", "0", "--record-dir", d, "--max-seconds", "120"],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    worker = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.worker", "bsp",
         "torch_launch_helper", "SleepyNet", "device=cpu", "iter_sleep=60",
         "epochs=1", "verbose=false", f"record_dir={d}"],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    port_cmd = [sys.executable, "-m", "theanompi_tpu_torch.tools.fleetz"]
    jax_cmd = [sys.executable, os.path.join(REPO, "scripts", "fleetz.py")]
    try:
        _wait_docs(d, ("center", "worker"), (center, worker))
        rc, mine = _fleetz(port_cmd, d)
        rc_j, theirs = _fleetz(jax_cmd, d)
        assert rc == rc_j == 0
        assert [_steady(r) for r in mine["fleet"]] == \
            [_steady(r) for r in theirs["fleet"]]
        assert sorted(r["role"] for r in mine["fleet"]) == \
            ["center", "worker"]
        worker.kill()
        worker.wait()
        rc, mine = _fleetz(port_cmd, d)
        rc_j, theirs = _fleetz(jax_cmd, d)
        assert rc == rc_j == 2
        assert [_steady(r) for r in mine["fleet"]] == \
            [_steady(r) for r in theirs["fleet"]]
        down = [r for r in mine["fleet"] if r.get("down")]
        assert [r["role"] for r in down] == ["worker"]
    finally:
        for p in (center, worker):
            if p.poll() is None:
                p.kill()
            p.communicate()


# -- plot_records ---------------------------------------------------------------

def test_plot_records_reads_a_port_run_as_jax(record_dirs, tmp_path):
    """The module loads without matplotlib (imported in ``main`` only);
    it reads a port run's records as the JAX script does, and plots
    them."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import theanompi_tpu_torch.tools.plot_records; "
         "print('matplotlib' in sys.modules, 'torch' in sys.modules)"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=60)
    assert r.stdout.split() == ["False", "False"], r.stderr
    from theanompi_tpu_torch.tools import plot_records
    d = record_dirs["bsp"]
    assert plot_records.load_records(d) == \
        jax_script("plot_records").load_records(d)
    assert plot_records.PHASES == jax_script("plot_records").PHASES
    out = str(tmp_path / "curves.png")
    assert plot_records.main([d, out]) == 0
    assert os.path.getsize(out) > 0


# -- profile_model and loader_bench --------------------------------------------

def _tool(name, *args, cwd=REPO, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", f"theanompi_tpu_torch.tools.{name}", *args],
        cwd=cwd, env=env or ENV, capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("name,args", [
    ("profile_model", ("cifar10", "8", "2")),
    ("loader_bench", ("--batches", "2", "--batch-size", "4")),
    ("scaling_sweep", ("--iters", "1")),
    ("rules_time_to_acc", ()),
    ("async_vs_sync_easgd", ()),
    ("gosgd_mixing", ())])
def test_tools_refuse_the_cpu_unless_asked(name, args):
    """With no GPU in sight (the card hidden, where there is one), without
    ``--host-devices`` each tool that runs a model or stages a batch exits
    with argparse's code 2 and says how to ask for the CPU; nothing falls
    back."""
    r = _tool(name, *args, env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
              timeout=60)
    assert r.returncode == 2, r.stdout[-2000:] + r.stderr[-2000:]
    assert "--host-devices" in r.stderr


def test_profile_model_json_has_the_jax_keys(tmp_path):
    """``profile_model cifar10 8 2 --host-devices 1 --json OUT`` runs to
    its end on the CPU; its document holds the JAX script's keys (run
    metadata plus ``devprof.attribute``'s), two traced dispatches, and
    the trace under ``PROFILE_DIR``."""
    from theanompi_tpu.utils import devprof as jdevprof
    out = str(tmp_path / "prof.json")
    env = dict(ENV, PROFILE_DIR=str(tmp_path / "trace"))
    r = _tool("profile_model", "cifar10", "8", "2", "--host-devices", "1",
              "--json", out, "--schedule", env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "== cifar10 batch 8 BSP: 2 traced dispatch(es) on cpu" in r.stdout
    with open(out) as f:
        doc = json.load(f)
    want = {"model", "batch_size", "rule", "spc", "iters", "platform",
            "device_kind", "trace_dir"} | set(jdevprof.attribute([]))
    assert want <= set(doc), sorted(want - set(doc))
    assert doc["train_dispatches"] == 2 and doc["platform"] == "cpu"
    assert doc["trace_dir"] == str(tmp_path / "trace")


def test_loader_bench_json_has_the_jax_keys(tmp_path):
    """The host pipeline (through the prefetch producer, the u8 wire) and
    the window A/B on the CPU: the JAX script's keys, images counted."""
    from theanompi_tpu_torch.tools import loader_bench
    d = loader_bench.write_batch_files(str(tmp_path / "data"), 4, 1, 4)
    r = _tool("loader_bench", "--batches", "4", "--batch-size", "4",
              "--epochs", "1", "--prefetch", "--u8-wire", "--data-dir", d,
              "--host-devices", "1")
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "gb_per_sec_out", "images", "seconds",
            "note"} <= set(out)
    assert out["images"] == 3 * 4 and out["value"] > 0
    assert "(u8-wire) via PrefetchLoader x1" in out["metric"]
    r = _tool("loader_bench", "--batches", "4", "--batch-size", "4",
              "--epochs", "1", "--windows", "2", "--data-dir", d,
              "--host-devices", "1")
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "serial_assembly_ms",
            "window_dequeue_ms", "consumer_stall_saved_ms",
            "compute_ms_between_dequeues", "windows", "note"} <= set(out)


def test_loader_bench_only_reads_a_named_data_dir(tmp_path):
    """``--data-dir`` is read, never rewritten: a set with no mean file
    (the reader's scalar mean) keeps every file; a directory without
    ``train_hkl/`` is refused with argparse's code 2 and left as it was.
    Without ``--data-dir`` the tool's own set is made once, and a half
    made one (no marker) is made again."""
    from theanompi_tpu_torch.tools import loader_bench
    d = loader_bench.write_batch_files(str(tmp_path / "data"), 2, 1, 4,
                                       mean=False)
    with open(os.path.join(d, "mine.txt"), "w") as f:
        f.write("keep")

    def tree(root):
        return sorted((os.path.relpath(os.path.join(a, n), root),
                       os.path.getsize(os.path.join(a, n)))
                      for a, _, ns in os.walk(root) for n in ns)

    before = tree(d)
    r = _tool("loader_bench", "--batch-size", "4", "--epochs", "1",
              "--data-dir", d, "--host-devices", "1")
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["images"] == 4
    assert tree(d) == before
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("keep")
    r = _tool("loader_bench", "--data-dir", str(empty), "--host-devices",
              "1")
    assert r.returncode == 2 and "no train_hkl/" in r.stderr, r.stderr
    assert tree(str(empty)) == [("notes.txt", 4)]
    own = str(tmp_path / "own")
    assert loader_bench.ensure_dataset(2, 4, own) == own
    os.remove(os.path.join(own, "train_hkl", "0001.npy"))
    assert loader_bench.ensure_dataset(2, 4, own) == own      # marker there
    assert not os.path.exists(os.path.join(own, "train_hkl", "0001.npy"))
    os.remove(os.path.join(own, loader_bench.DONE))
    loader_bench.ensure_dataset(2, 4, own)                    # made again
    assert os.path.exists(os.path.join(own, "train_hkl", "0001.npy"))
