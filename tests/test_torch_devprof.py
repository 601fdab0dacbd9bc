"""``theanompi_tpu_torch/utils/devprof.py`` against the JAX package's
``utils/devprof.py``, on the CPU.

* The JAX ``test_attribute_*`` cases (``tests/test_devprof.py``) rebuilt
  from the same intervals as torch device events (a JAX lane becomes a
  card, an async pair the one NCCL kernel spanning its in-flight window):
  the same ``compute_secs``, ``comm_secs``, ``exposed_comm_secs`` and
  ``overlap_ratio`` to 1e-9 relative.
* The port's lane is the card, all its streams unioned: an NCCL kernel on
  its own stream under compute on another stream of the same card is
  hidden; with its compute on another card it is exposed.
* The ``modules`` map keyed by the host anchor that launched each op,
  through ``args.correlation`` to a ``cudaLaunchKernel`` and a
  ``cudaGraphLaunch``.
* The schema strings, the gauges, the bubble, the schedule reports, the
  traffic model and the two model reports pinned against the JAX module
  (``update_state_report`` at 2 gloo ranks against the JAX figure on 2
  CPU devices).
* The round trip: the BSP worker at 2 gloo ranks through the launcher
  with ``trace_dir`` and telemetry, standing in for the JAX
  ``test_capture_round_trip_psum`` and
  ``test_worker_trace_capture_feeds_device_gauges``, which cannot pass
  here; an island config with ``trace_dir`` accepted.
"""

import gzip
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from theanompi_tpu.parallel import exchanger as JX
from theanompi_tpu.parallel import strategies as JS
from theanompi_tpu.parallel.pipeline import build_schedule as j_build_schedule
from theanompi_tpu.utils import devprof as jdev
from theanompi_tpu_torch.parallel import strategies as TS
from theanompi_tpu_torch.parallel.pipeline import build_schedule
from theanompi_tpu_torch.utils import devprof
from theanompi_tpu_torch.utils import telemetry as TT

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_launch_helper as lh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_vgg import _JTinyVGGNet  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")])}

NCCL = {"all-reduce": "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
                      "(ncclDevKernelArgsStorage<4096ul>)",
        "all-gather": "ncclDevKernel_AllGather_RING_LL"
                      "(ncclDevKernelArgsStorage<4096ul>)",
        "hop": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"}


def _op(ts, dur, name, pid=1, tid=1, module="jit_step"):
    """A JAX trace op event (``tests/test_devprof.py``'s helper)."""
    return {"ph": "X", "pid": pid, "tid": tid, "ts": float(ts),
            "dur": float(dur), "name": name,
            "args": {"hlo_op": name, "hlo_module": module}}


def _k(ts, dur, kind="compute", dev=0, stream=7, src=None, corr=None,
       cat="kernel"):
    """A torch device event: ``kind`` an NCCL family or compute (a GEMM)."""
    name = NCCL.get(kind, "void gemm_kernel<128, 64>(float const*, float*)")
    ev = {"ph": "X", "cat": cat, "name": name, "pid": dev, "tid": stream,
          "ts": float(ts), "dur": float(dur),
          "args": {"device": dev, "stream": stream, "correlation": corr}}
    if src is not None:
        ev["_src"] = src
    return ev


def _host(ts, dur, name, cat, corr=None, pid=100, tid=100):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
          "ts": float(ts), "dur": float(dur), "args": {}}
    if corr is not None:
        ev["args"]["correlation"] = corr
    return ev


# -- the JAX attribution cases as torch events ------------------------------

# (the JAX events of a tests/test_devprof.py case, the same intervals as
# torch device events)
CASES = {
    "exposed_comm_and_overlap": (
        [_op(0, 50, "fusion.1"), _op(40, 20, "all-reduce.1")],
        [_k(0, 50), _k(40, 20, "all-reduce", stream=20)]),
    "nested_and_multi_lane": (
        [_op(0, 100, "while.2"), _op(10, 20, "fusion.3"),
         _op(0, 40, "all-reduce.1", tid=2)],
        [_k(0, 100), _k(10, 20), _k(0, 40, "all-reduce", dev=1)]),
    "cross_host_lane_ids_do_not_collide": (
        [dict(_op(0, 100, "fusion.1"), _src=0),
         dict(_op(0, 40, "all-reduce.1"), _src=1)],
        [_k(0, 100, src=0), _k(0, 40, "all-reduce", src=1)]),
    "fully_hidden_comm_and_async_names": (
        [_op(0, 100, "fusion.1"), _op(10, 5, "all-gather-start.2"),
         _op(60, 10, "all-gather-done.2")],
        [_k(0, 100), _k(10, 60, "all-gather", stream=20)]),
    "async_pair_on_dedicated_stream_counts_once": (
        [_op(0, 100, "fusion.1"), _op(10, 5, "all-reduce-start.3"),
         _op(60, 10, "all-reduce-done.3", tid=2)],
        [_k(0, 100), _k(10, 60, "all-reduce", stream=20)]),
    "async_two_lane_trace_pairs_in_order": (
        [_op(0, 100, "fusion.1"),
         _op(5, 5, "all-reduce-start.1", tid=2),
         _op(40, 5, "all-reduce-done.1", tid=2),
         _op(50, 5, "all-reduce-start.2", tid=2),
         _op(85, 5, "all-reduce-done.2", tid=2)],
        [_k(0, 100), _k(5, 40, "all-reduce", dev=1),
         _k(50, 40, "all-reduce", dev=1)]),
    "async_unpaired_start": (
        [_op(5, 5, "all-reduce-start.9")],
        [_k(5, 5, "all-reduce")]),
    "no_comm_yields_none_ratio": (
        [_op(0, 10, "fusion.1", module="jit_a"),
         _op(20, 10, "convolution.4", module="jit_b")],
        [_k(0, 10), _k(20, 10)]),
}

KEYS4 = ("compute_secs", "comm_secs", "exposed_comm_secs", "overlap_ratio")


@pytest.mark.parametrize("case", list(CASES))
def test_jax_attribution_cases_as_torch_events(case):
    jax_events, torch_events = CASES[case]
    want = jdev.attribute(jax_events)
    got = devprof.attribute(torch_events)
    for key in KEYS4:
        if want[key] is None:
            assert got[key] is None, (key, got)
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-9, abs=0), \
                (key, got, want)
    assert got["n_op_events"] == len(torch_events)


# -- the lane is the card ---------------------------------------------------

def test_nccl_kernel_on_its_stream_under_same_card_compute_is_hidden():
    """Compute on stream 7 [0, 100], NCCL on its own stream 20 [40, 80] of
    the same card: hidden, one lane (a lane per stream would call it
    exposed)."""
    prof = devprof.attribute([_k(0, 100), _k(40, 40, "all-reduce",
                                             stream=20)])
    assert prof["lanes"] == 1 and prof["compute_lanes"] == 1
    assert prof["comm_secs"] == pytest.approx(40e-6)
    assert prof["exposed_comm_secs"] == 0.0
    assert prof["overlap_ratio"] == 1.0


def test_nccl_kernel_with_its_compute_on_another_card_is_exposed():
    prof = devprof.attribute([_k(0, 100, dev=0), _k(40, 40, "all-reduce",
                                                    dev=1, stream=20)])
    assert prof["lanes"] == 2 and prof["compute_lanes"] == 1
    assert prof["exposed_comm_secs"] == pytest.approx(40e-6)
    assert prof["overlap_ratio"] == 0.0
    # and partly: compute [0, 50] on the card, NCCL [40, 80] → 30 exposed
    part = devprof.attribute([_k(0, 50), _k(40, 40, "all-reduce",
                                            stream=20)])
    assert part["exposed_comm_secs"] == pytest.approx(30e-6)
    assert part["overlap_ratio"] == pytest.approx(0.25)


# -- the modules map and the anchors ----------------------------------------

def test_modules_keyed_by_the_launching_anchor():
    """Each device op is keyed by the anchor span that holds its launch on
    the same host thread, through ``correlation``: a ``cudaLaunchKernel``
    and a ``cudaGraphLaunch`` (two kernels of one replay) in the train
    span, a launch in the exchange span, one outside every span, one on
    another thread inside a span's time (``other``); host junk and the
    anchors' mirrors on the card are ignored."""
    events = [
        _host(0, 50, devprof.TRAIN_DISPATCH_SPAN, "user_annotation"),
        _host(60, 30, devprof.EXCHANGE_SPAN, "user_annotation"),
        _host(10, 2, "cudaLaunchKernel", "cuda_runtime", corr=1),
        _host(20, 2, "cudaGraphLaunch", "cuda_runtime", corr=2),
        _host(65, 2, "cudaLaunchKernel", "cuda_runtime", corr=3),
        _host(95, 2, "cudaLaunchKernel", "cuda_runtime", corr=4),
        _host(30, 2, "cudaLaunchKernel", "cuda_runtime", corr=5, tid=101),
        # host junk: an ATen op, a Python frame, the collective's host op,
        # the anchors' mirrors on the card, metadata
        _host(0, 99, "aten::mm", "cpu_op"),
        _host(0, 99, "worker.py(200): run", "python_function"),
        _host(61, 20, "nccl:all_reduce", "user_annotation"),
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 10.0, "dur": 30.0, "name": devprof.TRAIN_DISPATCH_SPAN},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 66.0, "dur": 10.0, "name": devprof.EXCHANGE_SPAN},
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "GPU 0"}},
        _k(12, 10, corr=1),
        _k(22, 4, corr=2), _k(26, 6, corr=2),
        _k(66, 10, "all-reduce", stream=20, corr=3),
        _k(96, 3, corr=4),
        _k(32, 2, corr=5),
    ]
    prof = devprof.attribute(events)
    assert prof["train_dispatches"] == 1
    assert prof["exchange_dispatches"] == 1
    assert prof["n_op_events"] == 6
    mods = prof["modules"]
    assert set(mods) == {devprof.TRAIN_DISPATCH_SPAN, devprof.EXCHANGE_SPAN,
                         "other"}
    assert mods[devprof.TRAIN_DISPATCH_SPAN]["compute_secs"] == \
        pytest.approx(20e-6)
    assert mods[devprof.TRAIN_DISPATCH_SPAN]["comm_secs"] == 0.0
    assert mods[devprof.EXCHANGE_SPAN]["comm_secs"] == pytest.approx(10e-6)
    assert mods[devprof.EXCHANGE_SPAN]["exposed_comm_secs"] == \
        pytest.approx(10e-6)
    assert mods["other"]["compute_secs"] == pytest.approx(5e-6)


def test_nested_anchor_takes_the_launch():
    """An exchange span inside a train span (a window's fused exchange)
    keys the launches it holds."""
    prof = devprof.attribute([
        _host(0, 100, devprof.TRAIN_DISPATCH_SPAN, "user_annotation"),
        _host(40, 20, devprof.EXCHANGE_SPAN, "user_annotation"),
        _host(10, 1, "cudaLaunchKernel", "cuda_runtime", corr=1),
        _host(45, 1, "cudaLaunchKernel", "cuda_runtime", corr=2),
        _k(11, 5, corr=1), _k(46, 5, "all-reduce", corr=2, stream=20)])
    assert set(prof["modules"]) == {devprof.TRAIN_DISPATCH_SPAN,
                                    devprof.EXCHANGE_SPAN}
    assert prof["modules"][devprof.EXCHANGE_SPAN]["comm_secs"] == \
        pytest.approx(5e-6)


def test_op_classification():
    for kind in ("all-reduce", "all-gather", "hop"):
        assert devprof.is_comm_op(NCCL[kind])
    for name in ("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)",
                 "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL"
                 "(ncclDevKernelArgsStorage<4096ul>)",
                 "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage"
                 "<4096ul>)"):
        assert devprof.is_comm_op(name)
    assert devprof.is_hop_op(NCCL["hop"])
    assert not devprof.is_hop_op(NCCL["all-reduce"])
    assert devprof.op_class(NCCL["all-reduce"]) == \
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
    assert devprof.op_class("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD"
    assert devprof.op_class(
        "void at::native::(anonymous namespace)::max_pool_forward_nchw"
        "<float, float>(int, float const*)") == \
        "void at::native::(anonymous namespace)::max_pool_forward_nchw"
    for name in ("memcpy128", "Memset (Device)",
                 "Memcpy HtoD (Pinned -> Device)",
                 "void at::native::vectorized_elementwise_kernel<4>(int)"):
        assert not devprof.is_comm_op(name)
    # memcpy and memset are device time, classed as compute
    prof = devprof.attribute([
        _k(0, 10, cat="gpu_memcpy"),
        dict(_k(20, 5, cat="gpu_memset"), name="Memset (Device)"),
        # host ops of a collective never count as device time
        _host(0, 50, "nccl:all_reduce", "user_annotation"),
        _host(0, 50, "c10d::allreduce_", "cpu_op"),
        _host(0, 50, "ncclDevKernel_AllReduce", "cuda_runtime")])
    assert prof["compute_secs"] == pytest.approx(15e-6)
    assert prof["comm_secs"] == 0.0 and prof["n_op_events"] == 2


def _write_trace(path, events, gz=True):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_profile_dir_empty_truncated_newest_and_named(tmp_path):
    assert devprof.profile_dir(str(tmp_path)) is None
    old = tmp_path / "iter00000002"
    _write_trace(str(old / "rank0.pt.trace.json.gz"), [_k(0, 99)])
    new = tmp_path / "iter00000009"
    _write_trace(str(new / "rank0.pt.trace.json.gz"), [_k(0, 10)])
    _write_trace(str(new / "rank1.pt.trace.json"), [_k(0, 20)], gz=False)
    with gzip.open(new / "rank2.pt.trace.json.gz", "wt") as f:
        f.write('{"traceEvents": [')          # truncated capture
    os.utime(old, (1, 1))
    prof = devprof.profile_dir(str(tmp_path))
    # the newest session, its whole files each a _src (two lanes)
    assert prof["trace_files"] == ["rank0.pt.trace.json.gz",
                                   "rank1.pt.trace.json",
                                   "rank2.pt.trace.json.gz"]
    assert prof["compute_secs"] == pytest.approx(30e-6)
    assert prof["lanes"] == 2
    one = devprof.profile_dir(str(tmp_path), name="rank1")
    assert one["compute_secs"] == pytest.approx(20e-6)
    assert devprof.profile_dir(str(new), name="rank2") is None
    # a directory with only a truncated capture
    bad = tmp_path / "bad" / "s"
    bad.mkdir(parents=True)
    with gzip.open(bad / "host.pt.trace.json.gz", "wt") as f:
        f.write('{"traceEvents": [')
    assert devprof.profile_dir(str(tmp_path / "bad")) is None


# -- pinned against the JAX module -----------------------------------------

@pytest.mark.parametrize("name", [
    "TRAIN_DISPATCH_SPAN", "EXCHANGE_SPAN", "DEVICE_GAUGES", "PROFILE_EVENT",
    "TRACE_ROW_COLUMNS", "BUCKET_ROW_COLUMNS", "PIPELINE_ROW_COLUMNS",
    "USHARD_ROW_COLUMNS", "COMPRESS_ROW_COLUMNS"])
def test_schema_strings_equal_the_jax_module(name):
    assert getattr(devprof, name) == getattr(jdev, name)


def test_feed_telemetry_and_row_fields_emit_the_jax_vocabularies():
    prof = devprof.attribute([_k(0, 50), _k(40, 20, "all-reduce",
                                             stream=20)])
    tm = TT.Telemetry(rank=0, run_id="t")
    devprof.feed_telemetry(prof, tm)
    assert set(tm.gauges) == set(jdev.DEVICE_GAUGES)
    assert tm.gauges["device.overlap_ratio"] == pytest.approx(0.5)
    evs = [e for e in tm.tail(4) if e["ev"] == jdev.PROFILE_EVENT]
    assert evs and evs[-1]["top_ops"][0] == "void gemm_kernel"
    devprof.feed_telemetry(prof, TT.DISABLED)      # a no-op, not an error
    fields = devprof.profile_row_fields(prof)
    assert tuple(fields) == jdev.TRACE_ROW_COLUMNS
    assert fields["device_mfu"] is None
    want = jdev.profile_row_fields(jdev.attribute(
        CASES["exposed_comm_and_overlap"][0]), total_flops=1e9,
        peak_flops=1e15)
    assert devprof.profile_row_fields(prof, total_flops=1e9,
                                      peak_flops=1e15) == want
    # the card's peak by default: 1e9 flops over 50 µs at 989.4 TFLOP/s
    assert devprof.profile_row_fields(prof, total_flops=1e9)[
        "device_mfu"] == pytest.approx(1e9 / 50e-6 / 989.4e12, abs=1e-4)


def test_bubble_fraction_per_lane_idle_gaps():
    """The JAX bubble case: card 0 compute [0,10] + [20,30], card 1
    [0,40], a collective in card 0's gap: the JAX module's figure."""
    j = [_op(0, 10, "fusion.1"), _op(20, 10, "fusion.2"),
         _op(0, 40, "while.1", tid=2)]
    t = [_k(0, 10), _k(20, 10), _k(0, 40, dev=1)]
    assert devprof.attribute(t)["bubble_fraction"] == \
        jdev.attribute(j)["bubble_fraction"] == pytest.approx(10 / 70,
                                                              abs=1e-4)
    assert devprof.attribute(t + [_k(12, 6, "all-reduce", stream=20)])[
        "bubble_fraction"] == jdev.attribute(
            j + [_op(12, 6, "all-reduce.1")])["bubble_fraction"]
    assert devprof.attribute([_k(0, 5, "all-reduce")])[
        "bubble_fraction"] is None
    assert devprof.attribute([_k(0, 50)])["bubble_fraction"] == 0.0


def test_schedule_occupancy_equals_the_jax_report():
    def jev(name, ts, dur, tid=0):
        return {"ph": "X", "name": name, "pid": 7, "tid": tid, "_src": "t0",
                "args": {"hlo_op": name}, "ts": ts, "dur": dur}

    jax_events = [jev("fusion.1", 0.0, 10.0),
                  jev("collective-permute.2", 10.0, 5.0),
                  jev("all-reduce.6", 16.0, 2.0),
                  jev("fusion.3", 15.0, 15.0),
                  jev("fusion.4", 0.0, 10.0, tid=1),
                  jev("fusion.5", 20.0, 10.0, tid=1)]
    torch_events = [_k(0, 10, src="t0"), _k(10, 5, "hop", src="t0"),
                    _k(16, 2, "all-reduce", src="t0"),
                    _k(15, 15, src="t0"),
                    _k(0, 10, dev=1, src="t0"), _k(20, 10, dev=1, src="t0")]
    want = jdev.schedule_occupancy(jax_events, strip_width=12)
    got = devprof.schedule_occupancy(torch_events, strip_width=12)
    assert [dict(l, lane=None) for l in got["lanes"]] == \
        [dict(l, lane=None) for l in want["lanes"]]
    assert [l["lane"] for l in got["lanes"]] == ["t0:0", "t0:1"]
    assert got["bubble_fraction"] == want["bubble_fraction"]
    txt = devprof.format_schedule(got)
    assert "t0:0" in txt and "bubble_fraction" in txt


GRID = [(2, 1, 3), (4, 1, 8), (2, 2, 4), (4, 2, 8), (3, 2, 6), (2, 4, 2)]


@pytest.mark.parametrize("pp,v,m", GRID)
def test_pipeline_schedule_report_and_busy_counts(pp, v, m):
    """The report on the same hop intervals (one hop a stage a tick, two
    passes, a jittered tick) equals the JAX module's; the busy counts are
    the column sums of the port's schedule table (and of the JAX one)."""
    jax_events, torch_events = [], []
    T = v * m + pp - 1
    for g in range(2 * T):
        for r in range(pp):
            ts = g * 100.0 + r + (7.0 if g == 3 else 0.0)
            jax_events.append({"ph": "X", "name": f"collective-permute.{r}",
                               "pid": 1, "tid": r, "ts": ts, "dur": 3.0,
                               "args": {"hlo_op": "collective-permute"}})
            torch_events.append(_k(ts, 3.0, "hop", dev=r, stream=30))
    torch_events.append(_k(0, 50))                       # compute: no hop
    assert devprof.pipeline_schedule_report(torch_events, pp, v, m) == \
        jdev.pipeline_schedule_report(jax_events, pp, v, m)
    assert devprof.pipeline_schedule_report([], pp, v, m) == \
        jdev.pipeline_schedule_report([], pp, v, m)
    busy = devprof._schedule_busy_counts(pp, v, m)
    np.testing.assert_array_equal(
        np.asarray(build_schedule(pp, v, m).real).sum(axis=1), busy)
    np.testing.assert_array_equal(
        np.asarray(j_build_schedule(pp, v, m).real).sum(axis=1), busy)


@pytest.mark.parametrize("strategy,kw", [
    ("onebit", {}), ("topk", {"chunk": 4096, "k_c": 41}), ("topk", {}),
    ("powersgd2", {"rank": 2, "leaf_shapes": [(3, 3, 64, 128), (4096, 1000),
                                              (1000,), (8, 8)]}),
    ("powersgd1", {"rank": 1, "leaf_shapes": [(4, 4)]}),
    ("allreduce", {})])
def test_compress_traffic_model_equals_the_jax_one(strategy, kw):
    for n, w in ((1 << 22, 2), (138_357_544, 4), (1000, 1)):
        assert devprof.compress_traffic_model(strategy, n, w, **kw) == \
            jdev.compress_traffic_model(strategy, n, w, **kw)


@pytest.mark.parametrize("strategy", ["onebit", "topk", "powersgd1",
                                      "allreduce"])
def test_compress_traffic_report_equals_the_jax_one(strategy):
    """The port's TinyVGGNet (its leaves in the port's layout) against the
    JAX twin on the same config, at 2 workers."""
    model = helper.TinyVGGNet({"device": "cpu", "verbose": False,
                               "size": 2})
    model.exchanger = types.SimpleNamespace(
        strategy=TS.get_strategy(strategy))
    jm = _JTinyVGGNet({"n_workers": 2, "verbose": False})
    stub = types.SimpleNamespace(
        exchanger=types.SimpleNamespace(strategy=JS.get_strategy(strategy)),
        params=jm.params, mesh=jm.mesh)
    want = jdev.compress_traffic_report(stub)
    assert devprof.compress_traffic_report(model) == want
    assert (want is None) == (strategy == "allreduce")


# -- update_state_report at 2 gloo ranks -----------------------------------

_USTATE = {}


def _ustate(tmp_path_factory):
    """Every rank's ``update_state_report`` of each ``lh.USTATE_CASES``
    key on TinyLRNNet, from one launch of ``torch_launch_helper``'s
    ``ustate`` mode at 2 gloo ranks."""
    if not _USTATE:
        mp = pytest.MonkeyPatch()
        for k, v in ENV.items():
            mp.setenv(k, v)
        out = str(tmp_path_factory.mktemp("ustate") / "u")
        try:
            rc = lh.launch("bsp", "-", 2, "device=cpu", "helper_mode=ustate",
                           f"helper_out={out}", "batch_size=8", "epochs=1",
                           timeout_s=240)
        finally:
            mp.undo()
        assert rc == 0
        for r in range(2):
            with open(f"{out}_r{r}.json") as f:
                _USTATE[r] = json.load(f)
    return _USTATE


@pytest.mark.parametrize("case", list(lh.USTATE_CASES))
def test_update_state_report_equals_the_jax_figure(case, tmp_path_factory):
    """Per-rank bytes, replicated bytes and their ratio against the JAX
    report of the same config at 2 CPU devices: equal under plain BSP,
    ``zero_opt`` and ``update_sharding``; under FSDP the port's chunk
    starts each leaf at a multiple of ``fsdp.ALIGN`` elements (256 bytes),
    so its per-rank bytes exceed the JAX figure by less than ALIGN
    float32 elements a leaf over the 2 workers (one momentum tree)."""
    from theanompi_tpu_torch.parallel import fsdp as TF
    got = _ustate(tmp_path_factory)
    cfg = dict({"n_workers": 2, "verbose": False, "batch_size": 8},
               **lh.USTATE_CASES[case])
    jm = _JTinyLRNNet(cfg)
    jm.compile_iter_fns(JX.get_exchanger("bsp", cfg))
    want = jdev.update_state_report(jm)
    for r in (0, 1):
        g = got[r][case]
        assert g["update_state_bytes_replicated"] == \
            want["update_state_bytes_replicated"]
        if case != "fsdp":
            assert g == want, (r, g, want)
            continue
        n_leaves = 4
        diff = g["update_state_bytes_per_chip"] - \
            want["update_state_bytes_per_chip"]
        assert 0 <= diff < 4 * TF.ALIGN * n_leaves / 2, (g, want)
    if case != "plain":
        assert got[0][case]["update_state_shrink"] > 1.5


# -- the round trip ---------------------------------------------------------

def _launch(tmp_path, tag, *kv):
    ck = str(tmp_path / f"ck_{tag}")
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "torch_port_helper", "--modelclass", "TinyLRNNet",
         "--n-workers", "2", "device=cpu", "batch_size=4",
         "exch_mode=params", f"ckpt_dir={ck}", *kv],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, **ENV))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return ck, r.stdout


def test_worker_trace_round_trip_at_two_gloo_ranks(tmp_path):
    """The BSP worker (params mode: a standalone exchange a step) at 2
    gloo ranks with ``trace_dir``, ``trace_start`` 2, ``trace_iters`` 2
    and telemetry: each rank's trace is found and parsed, 2 train and 2
    exchange dispatches, no device lane (a CPU trace has no device op),
    the gloo all-reduce's host op (``gloo:all_reduce``, on gloo's threads)
    inside each exchange anchor, the
    ``device.*`` gauges and a ``device_profile`` event in each rank's
    stream; the final checkpoint bit for bit the untraced run's."""
    trace, rec = str(tmp_path / "trace"), str(tmp_path / "rec")
    ck, out = _launch(tmp_path, "traced", f"trace_dir={trace}",
                      "trace_start=2", "trace_iters=2", f"record_dir={rec}")
    ck0, _ = _launch(tmp_path, "plain")
    assert "profiler trace saved to" in out and "device time:" in out
    assert "start-up (s from process start):" in out
    sessions = os.listdir(trace)
    assert sessions == ["iter00000002"]
    for r in (0, 1):
        prof = devprof.profile_dir(trace, name=f"rank{r}")
        assert prof["trace_files"] == [f"rank{r}.pt.trace.json.gz"]
        assert prof["train_dispatches"] == 2
        assert prof["exchange_dispatches"] == 2
        assert prof["lanes"] == 0 and prof["n_op_events"] == 0
        events = devprof.load_dir_events(trace, name=f"rank{r}")
        spans = [e for e in events if e.get("name") == devprof.EXCHANGE_SPAN]
        gloo = [e for e in events if e.get("name") == "gloo:all_reduce"]
        # gloo runs the collective on its own threads: each exchange span
        # holds (in time) the all-reduces it issued
        held = [[g for g in gloo if s["ts"] <= g["ts"]
                 and g["ts"] + g["dur"] <= s["ts"] + s["dur"]]
                for s in spans]
        assert len(spans) == 2 and all(held), (len(spans), len(gloo))
        with open(os.path.join(rec, f"telemetry_rank{r}.jsonl")) as f:
            evs = [json.loads(line) for line in f if line.strip()]
        prof_evs = [e for e in evs if e["ev"] == devprof.PROFILE_EVENT]
        assert len(prof_evs) == 1 and prof_evs[0]["train_dispatches"] == 2
        assert [e for e in evs if e["ev"] == "startup"]
        with open(os.path.join(rec, f"telemetry_summary_rank{r}.json")) as f:
            gauges = json.load(f)["gauges"]
        # overlap_ratio is None without comm, and is not fed
        assert set(devprof.DEVICE_GAUGES) - {"device.overlap_ratio"} <= \
            set(gauges), sorted(gauges)
    with np.load(os.path.join(ck, "ckpt_epoch0.npz")) as a, \
            np.load(os.path.join(ck0, "ckpt_epoch0.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for k in a.files:
            assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), k


def test_capture_context_and_anonymous_dir(tmp_path):
    """``capture`` on the CPU: the profile on exit, two anchors counted;
    an anonymous capture's directory removed afterwards."""
    import torch
    from torch.profiler import record_function
    x = torch.ones(32, 32)
    with devprof.capture(str(tmp_path / "t"), cuda=False) as cap:
        for _ in range(2):
            with record_function(devprof.TRAIN_DISPATCH_SPAN):
                x = x @ x / 32
    assert cap.profile["train_dispatches"] == 2
    assert cap.profile["lanes"] == 0
    assert len(os.listdir(tmp_path / "t")) == 1
    with devprof.capture(cuda=False) as anon:
        with record_function(devprof.EXCHANGE_SPAN):
            x = x + 1
    assert anon.profile["exchange_dispatches"] == 1
    assert not os.path.exists(anon.trace_dir)


def test_island_accepts_trace_dir(tmp_path, capsys):
    """The JAX islands read no ``trace_dir``; the port's accept the key
    the same way and say that an island takes no device profile."""
    import theanompi_tpu_torch as T
    r = T.EASGD()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", easgd_mode="async", async_islands=1, sync_freq=2,
           run_seconds=1.0, trace_dir=str(tmp_path / "t"))
    assert r.wait().stats()["center_updates"] >= 1
    assert "an island takes no device profile" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "t")
