"""The port's telemetry plane (``theanompi_tpu_torch/utils/telemetry.py``,
the recorder's hook, the prefetch loader's probes, the exchanger's
histograms) against the JAX package's ``utils/telemetry.py``, and the JAX
package's ``scripts/telemetry_report.py`` reading a port run.

* The registry: histograms (the same summaries as the JAX package's for
  the same samples), counters, gauges, the bounded flight ring, the JSONL
  stream, the summary sidecar and the flight dump; ``init``'s rules
  (``record_dir`` streams, ``telemetry=true`` keeps it in memory,
  ``telemetry=false`` forces it off); the inert ``DISABLED`` registry;
  the device gauges' aggregation, and ``system_snapshot`` on the CPU.
* The hooks: every recorder bracket a ``phase`` event and histogram
  sample, every printed record a ``train_record`` / ``val_record`` event;
  the ``para_load`` loader's queue depth, dequeues, starved dequeues,
  produce and blocked times; one ``exchange.dispatch_secs`` sample and
  one ``exchange.count`` / ``exchange.count.<rule>`` tick an exchange.
* ``build_report`` of the JAX package's script (loaded by file path) on
  the ``record_dir`` of a 2-rank port world launched under EASGD with
  telemetry, tracing and numerics on: its phase, throughput, numerics and
  trace sections filled for both ranks.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from theanompi_tpu.utils import telemetry as JT
from theanompi_tpu_torch.utils import telemetry
from theanompi_tpu_torch.utils.recorder import Recorder
from theanompi_tpu_torch.utils.telemetry import DISABLED, Histogram, Telemetry

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_vgg import cpu_group  # noqa: E402,F401

ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(autouse=True)
def _reset():
    yield
    telemetry.init({})


def report_script():
    """The JAX package's stdlib-only report script, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(REPO, "scripts",
                                         "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(1000, 4096), (20000, 128)])
def test_histogram_summaries_equal_the_jax_ones(n, cap):
    r = np.random.RandomState(n)
    mine, theirs = Histogram(cap=cap), JT.Histogram(cap=cap)
    for v in r.exponential(size=n):
        mine.observe(v)
        theirs.observe(v)
    assert mine.summary() == theirs.summary()
    assert len(mine._samples) <= cap


def test_registry_stream_sidecar_and_flight(tmp_path):
    d = str(tmp_path)
    tm = Telemetry(rank=1, run_id="rx", stream_dir=d, flight_events=16)
    tm.counter("c")
    tm.counter("c", 2)
    tm.gauge("g", 7.5)
    tm.phase("train", 0.01)
    tm.event("beat", ring_only=True, label="iter 1")   # ring, not stream
    for i in range(40):
        tm.event("e", i=i)
    assert tm.counters["c"] == 3 and tm.gauges["g"] == 7.5
    assert len(tm.tail(100)) == 16 and tm.tail(1)[0]["i"] == 39
    path = tm.dump_flight(reason="test dump")
    tm.close()
    with open(os.path.join(d, "telemetry_rank1.jsonl")) as f:
        evs = [json.loads(line) for line in f]
    assert [e["ev"] for e in evs[:2]] == ["run_start", "phase"]
    assert all(e["ev"] != "beat" for e in evs)
    assert all(e["rank"] == 1 and e["run"] == "rx" for e in evs)
    with open(path) as f:
        flight = [json.loads(line) for line in f]
    assert flight[0]["ev"] == "flight_dump" and \
        flight[0]["reason"] == "test dump" and len(flight) == 17
    with open(os.path.join(d, "telemetry_summary_rank1.json")) as f:
        summ = json.load(f)
    assert summ["counters"]["c"] == 3
    assert summ["hist"]["phase.train"]["count"] == 1
    assert not tm.enabled
    tm.event("late")                     # a closed registry is inert


@pytest.mark.parametrize("config,kind", [
    ({}, "disabled"),
    ({"telemetry": False, "record_dir": "D"}, "disabled"),
    ({"telemetry": "false"}, "disabled"),
    ({"telemetry": True}, "memory"),
    ({"record_dir": "D", "rank": 2, "run_id": "rid"}, "stream")])
def test_init_rules_as_jax(tmp_path, config, kind):
    config = {k: (str(tmp_path) if v == "D" else v)
              for k, v in config.items()}
    tm = telemetry.init(config)
    theirs = JT.init(config)
    try:
        assert tm.enabled == theirs.enabled == (kind != "disabled")
        if kind == "disabled":
            assert tm is DISABLED
        else:
            assert tm.stream_dir == theirs.stream_dir
            assert tm.rank == theirs.rank and telemetry.active() is tm
    finally:
        JT.init({})


def test_disabled_registry_is_inert():
    assert telemetry.active() is DISABLED and not DISABLED.enabled
    for call in (lambda: DISABLED.counter("a"), lambda: DISABLED.gauge("g", 1),
                 lambda: DISABLED.observe("h", 1),
                 lambda: DISABLED.phase("train", 1.0),
                 lambda: DISABLED.event("e", x=1), DISABLED.close):
        assert call() is None
    assert DISABLED.tail() == [] and DISABLED.summary() == {}
    assert DISABLED.system_snapshot(iter=1) == {}
    assert DISABLED.dump_flight("x") is None
    # a recorder outside a worker feeds nothing
    rec = Recorder({"verbose": False})
    rec.start()
    rec.end("train")
    assert rec.telemetry is DISABLED


def test_memory_gauges_and_snapshot_on_the_cpu():
    stats = [{"bytes_in_use": 100, "peak_bytes_in_use": 900,
              "bytes_limit": 1000},
             {"bytes_in_use": 300, "peak_bytes_in_use": 400,
              "bytes_limit": 1000}, None, {"bytes_in_use": 50}]
    assert telemetry.aggregate_memory_stats(stats) == \
        JT.aggregate_memory_stats(stats)
    assert telemetry.cuda_memory_stats() == []     # no card here
    tm = telemetry.init({"telemetry": True})
    tm.gauge("prefetch.queue_depth", 3)
    vals = tm.system_snapshot(iter=7)
    assert vals["iter"] == 7 and vals["prefetch.queue_depth"] == 3
    assert vals["host_rss_bytes"] > 0 and "device_count" not in vals
    assert tm.tail(1)[0]["ev"] == "gauges"


# -- the hooks ----------------------------------------------------------------

def test_recorder_feeds_phases_and_records(tmp_path):
    tm = telemetry.init({"record_dir": str(tmp_path)})
    rec = Recorder({"verbose": False, "printFreq": 1})
    rec.telemetry = tm
    for section in ("load", "train"):
        rec.start()
        rec.end(section)
    rec.train_error(1, 2.0, 0.5, 8)
    rec.print_train_info(1)
    rec.val_error(1, 2.5, 0.5)
    rec.print_val_info(1)
    kinds = [e["ev"] for e in tm.tail(8)]
    assert kinds.count("phase") == 2 and "train_record" in kinds \
        and "val_record" in kinds
    assert tm.hists["phase.train"].count == 1
    assert {e["sec"] for e in tm.tail(8) if e["ev"] == "phase"} == \
        {"load", "train"}


def test_prefetch_probes():
    from theanompi_tpu_torch.models.data.prefetch import PrefetchLoader
    tm = telemetry.init({"telemetry": True})
    data = helper.TinyLRNNet({"verbose": False, "device": "cpu"}).data
    loader = PrefetchLoader(data, depth=2)
    loader.shuffle_data(0)
    n = data.n_batch_train
    for i in range(n):
        loader.next_train_batch(i + 1)
    loader.close()
    assert tm.counters["prefetch.dequeues"] == n
    assert tm.hists["prefetch.queue_depth"].count == n
    assert "prefetch.queue_depth" in tm.gauges
    assert tm.hists["prefetch.produce_secs"].count == n
    assert tm.hists["prefetch.producer_blocked_secs"].count == n
    assert tm.counters.get("prefetch.starved_dequeues", 0) <= n


def test_exchanger_histograms(cpu_group):
    from theanompi_tpu_torch.parallel.exchanger import EASGD_Exchanger
    tm = telemetry.init({"telemetry": True})
    m = helper.TinyLRNNet({"verbose": False, "device": "cpu",
                           "rule": "easgd", "sync_freq": 2})
    ex = EASGD_Exchanger(m.config)
    m.compile_iter_fns(ex)
    m.data.shuffle_data(0)
    for count in range(1, 6):
        m.train_iter(count)
        ex.exchange(None, count)
    assert tm.hists["exchange.dispatch_secs"].count == 2
    assert tm.counters["exchange.count"] == 2
    assert tm.counters["exchange.count.easgd"] == 2


# -- the JAX report on a port run --------------------------------------------

def test_jax_report_reads_a_two_rank_port_run(tmp_path):
    d = str(tmp_path / "rec")
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher", "--rule",
         "easgd", "--modelfile", "torch_port_helper", "--modelclass",
         "TinyLRNNet", "--n-workers", "2", "device=cpu", "batch_size=4",
         "sync_freq=2", "printFreq=2", "epochs=1", "verbose=false",
         f"record_dir={d}", "tracing=true", "numerics=true"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    rep = report_script().build_report(d)
    assert rep["ranks"] == [0, 1] and len(rep["runs"]) == 1
    assert {"train", "load", "comm"} <= set(rep["phases"])
    assert sorted(rep["throughput_timeline"]) == [0, 1]
    for rank in (0, 1):
        nm = rep["numerics"][rank]
        assert nm["reports"] > 0 and nm["nonfinite_total"] == 0.0
        # the center is the beacon: bit-equal on both ranks
        assert nm["max_divergence"] == 0.0 and nm["last"]["beacon"] == 1
        assert nm["max_dist_center"] > 0
    tr = rep["traces"]
    assert tr["rounds"] > 0 and set(tr["root_cause"]) == {0, 1}
    assert rep["crash_events"] == [] and rep["flight_dumps"] == []
    for rank in (0, 1):
        assert rep["counters"][rank]["exchange.count.easgd"] == \
            tr["rounds"] / 2
