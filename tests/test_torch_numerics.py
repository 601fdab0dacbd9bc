"""The numerics health plane of the port (``utils/numerics.py``,
``parallel/steps.TrainStep``) against the JAX package's
(``theanompi_tpu/utils/numerics.py``), and the training sentry.

* **Inertness and the host report**, one parametrised test over BSP
  (allreduce), BSP at ``steps_per_call`` 4, EASGD at ``sync_freq`` 2 and
  BSP onebit: the port with ``numerics=true`` (telemetry and tracing on)
  leaves params, optimizer state, extra state and every cost bit-equal to
  the same run with the planes off; its ``host_report`` after the last
  call matches the JAX package's, from the JAX run's aux, both models
  starting from the JAX twin's weights.  Tolerances: ``iter``,
  ``nonfinite``, ``n_workers``, ``beacon`` and a None divergence exactly;
  grad and param norms and max|g| rtol 1e-5 (the packages' gradients
  differ in summation order, ~1e-7 relative, and a few steps carry it);
  the update norm and ratio rtol 1e-4 (a difference of nearly equal
  params: the params' ~1e-7 relative gap over an update ~0.05 of them);
  ``dist_center`` rtol 1e-3 (the same amplified by ``p − c``, ~1e-2 of
  the params); ``ef_norm`` rtol 1e-4 (onebit's scale sums its elements in
  another order in each package); the digest within 1e-5 · Σ_leaf w·Σ|x|
  (float32 sums of signed values).
* **The beacon** at 2 gloo ranks (``torch_ops_helper.py beacon``): BSP's
  divergence exactly 0.0 while the replicas agree and > 0 after one
  rank's params are perturbed; EASGD's ``dist_center`` against
  ``‖p − c‖`` recomputed in float64 from the same tensors, rtol 1e-6.
* **tp**: the LM at dp 1 × tp 2 (``torch_ops_helper.py tp``): the sampled
  ``grad_norm`` and ``param_norm`` equal the dense run's, rtol 1e-5.
* **The cadence** at ``steps_per_call`` 1 and 4, as the JAX package's
  ``test_numerics.py`` pins it: an off-cadence call at one step a call
  reports nothing (the template), a window carries its last due step.
* **The sentry**: the detector order, the iteration dedupe and the
  discontinuity cases of the JAX ``tests/test_numerics.py``, on the
  port's copy.
"""

import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import exchanger as JEX
from theanompi_tpu.utils import numerics as JN
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import exchanger as TEX
from theanompi_tpu_torch.utils import helper_funcs as TH
from theanompi_tpu_torch.utils import numerics, telemetry, tracing
from theanompi_tpu_torch.utils.sentry import TrainingSentry

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_ops_helper as oh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_vgg import _JTinyVGGNet, cpu_group  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _planes_off():
    yield
    telemetry.init({})
    tracing.init({})


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


CASES = {
    # name: (JAX exchanger, port exchanger, config, spc, calls)
    "bsp": (JEX.BSP_Exchanger, TEX.BSP_Exchanger, {}, 1, 4),
    "bsp_spc4": (JEX.BSP_Exchanger, TEX.BSP_Exchanger, {}, 4, 2),
    "easgd": (JEX.EASGD_Exchanger, TEX.EASGD_Exchanger,
              {"rule": "easgd", "sync_freq": 2}, 1, 5),
    "onebit": (JEX.BSP_Exchanger, TEX.BSP_Exchanger,
               {"exch_strategy": "onebit"}, 1, 3),
}


def _port(case, jp0, on):
    _, tex, cfg, spc, _ = CASES[case]
    cfg = dict(cfg, verbose=False, device="cpu", steps_per_call=spc)
    if on:
        cfg.update(numerics=True, numerics_every=1)
    cls = helper.TinyVGGNet if case == "onebit" else helper.TinyLRNNet
    tm = cls(cfg)
    tm.load_params(convert.params_from_jax(jp0, tm.kept_layout_paths()))
    tx = tex(tm.config)
    tm.compile_iter_fns(tx)
    return tm, tx


def _drive(model, exch, spc, calls):
    model.data.shuffle_data(0)
    costs = []
    for i in range(calls):
        count = (i + 1) * spc
        model.train_iter(count)
        exch.exchange(None, count)
        costs.append(np.asarray(model.current_info["cost"]).copy())
    return costs


def _state(model):
    return [t.detach().clone() for part in ("params", "opt_state", "bn_state",
                                            "extra")
            for t in TH.tree_leaves(getattr(model, part))]


def _digest_scale(model):
    pos = {p: i for i, p in enumerate(TH.jax_leaf_paths(model.params))}
    return sum(numerics._leaf_weight(pos[p])
               * float(TH.get_leaf(model.params, p).detach().abs().sum())
               for p in TH.leaf_paths(model.params))


RTOL = {"grad_norm": 1e-5, "grad_max_abs": 1e-5, "param_norm": 1e-5,
        "update_norm": 1e-4, "update_ratio": 1e-4, "dist_center": 1e-3,
        "ef_norm": 1e-4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_numerics_is_inert_and_reports_as_jax(cpu_group, case):
    jex, _, cfg, spc, calls = CASES[case]
    jcfg = dict(cfg, verbose=False, n_workers=1, steps_per_call=spc,
                numerics=True, numerics_every=1)
    jm = (_JTinyVGGNet if case == "onebit" else _JTinyLRNNet)(jcfg)
    jp0 = _host(jm.params)
    jx = jex(jm.config)
    jm.compile_iter_fns(jx)
    jm.data.shuffle_data(0)
    for i in range(calls):
        jm.train_iter((i + 1) * spc)
        jx.exchange(None, (i + 1) * spc)
    want = JN.host_report(jax.device_get(jm.numerics_aux))

    off, xo = _port(case, jp0, on=False)
    costs_off = _drive(off, xo, spc, calls)
    assert off.numerics_aux is None
    # the planes on: telemetry and tracing around the sampled step
    telemetry.init({"telemetry": True})
    tracing.init({"tracing": True})
    on, xn = _port(case, jp0, on=True)
    costs_on = _drive(on, xn, spc, calls)
    for a, b in zip(costs_off, costs_on):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(_state(off), _state(on)):
        assert torch.equal(a, b)
    got = numerics.host_report(numerics.to_host(on.numerics_aux))

    assert got["iter"] == want["iter"] == calls * spc
    assert got["n_workers"] == want["n_workers"] == 1
    assert got["nonfinite"] == want["nonfinite"] == 0.0
    assert got["divergence"] is None and want["divergence"] is None
    assert got["per_rank"]["beacon"] == want["per_rank"]["beacon"]
    for k, rtol in RTOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert abs(got["per_rank"]["digest"][0] - want["per_rank"]["digest"][0]) \
        <= 1e-5 * _digest_scale(on)
    if case == "easgd":
        assert got["dist_center"] > 0
    if case == "onebit":
        assert got["ef_norm"] > 0


# -- the beacon and the distance at 2 ranks -----------------------------------

def test_beacon_and_dist_center_at_two_ranks(tmp_path):
    res = oh.collect(oh.spawn("beacon", 2, tmp_path, "beacon", {}))
    for r in res:
        # healthy BSP replicas: bit-equal digests, divergence exactly 0
        assert r["div_healthy"] == 0.0
        assert r["div_perturbed"] > 0.0
        np.testing.assert_allclose(r["dist_sample"], r["dist_f64"],
                                   rtol=1e-6)
        assert r["dist_sample"] > 0
    # the gathered digests: rank 0's row on both ranks
    np.testing.assert_array_equal(res[0]["digests"], res[1]["digests"])


def test_tp_norms_equal_the_dense_run(tmp_path):
    res = oh.collect(oh.spawn("tp", 2, tmp_path, "tp",
                              {"init_npz": oh.lm_init(tmp_path)}))
    dense = res[0]
    for r in res:
        for k in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(r[f"tp_{k}"], dense[f"dense_{k}"],
                                       rtol=1e-5, err_msg=k)


# -- the cadence --------------------------------------------------------------

@pytest.mark.parametrize("spc,every,calls,want", [
    # one step a call: an off-cadence call reports nothing
    (1, 4, 6, None), (1, 4, 8, 8),
    # a window carries its last due step: 5..8 at every 3 is 6
    (4, 3, 2, 6), (4, 4, 2, 8), (4, 5, 1, None)])
def test_cadence_follows_jax(cpu_group, spc, every, calls, want):
    tm = helper.TinyLRNNet({"verbose": False, "device": "cpu",
                            "steps_per_call": spc, "numerics": True,
                            "numerics_every": every})
    tx = TEX.BSP_Exchanger(tm.config)
    tm.compile_iter_fns(tx)
    _drive(tm, tx, spc, calls)
    rep = numerics.host_report(numerics.to_host(tm.numerics_aux))
    assert (None if rep is None else rep["iter"]) == want


# -- the host plane and the sentry (the JAX test_numerics.py cases) ---------

def test_host_report_and_record_as_jax():
    aux = {k: [0.0, 0.0] for k in numerics.SAMPLE_KEYS}
    aux.update(iter=[8.0, 8.0], grad_norm=[1.0, 3.0], nonfinite=[1.0, 2.0],
               update_ratio=[0.01, 0.002], digest=[5.0, 5.5],
               beacon=[1.0, 1.0])
    assert numerics.host_report(aux) == JN.host_report(aux)
    aux["digest"] = [1.0, float("nan")]
    assert numerics.host_report(aux)["divergence"] == math.inf
    assert numerics.host_report(None) is None
    tm = telemetry.Telemetry(rank=0, run_id="nx")
    numerics.record(tm, numerics.example_report(), rank=3)
    assert set(numerics.NUMERICS_GAUGES) <= set(tm.gauges)
    assert set(numerics.NUMERICS_HISTOGRAMS) <= set(tm.hists)
    assert numerics.SAMPLE_KEYS == JN.SAMPLE_KEYS
    assert numerics.NUMERICS_GAUGES == JN.NUMERICS_GAUGES


def _rep(**kw):
    rep = dict(numerics.example_report())
    rep.update(kw)
    return rep


@pytest.mark.parametrize("reports,kinds", [
    # the detector order: overflow before divergence before collapse
    ([dict(iter=1, nonfinite=2.0, divergence=9.0), dict(iter=2,
      divergence=1e-6), dict(iter=3, update_ratio=1e-15), dict(iter=4),
      dict(iter=5, grad_norm=float("inf"))],
     ["grad_overflow", "replica_divergence", "update_ratio_collapse", None,
      "grad_overflow"]),
    # the latest-sample carry: one sampled step judged once
    ([dict(iter=7, nonfinite=1.0), dict(iter=7, nonfinite=1.0),
      dict(iter=9, nonfinite=1.0)], ["grad_overflow", None,
                                     "grad_overflow"]),
    # a discontinuity consumes exactly one report
    (["discontinuity", dict(iter=1, divergence=5.0),
      dict(iter=2, divergence=5.0)], [None, "replica_divergence"]),
])
def test_sentry_numerics_detectors(reports, kinds):
    s = TrainingSentry({"verbose": False}, telemetry=telemetry.DISABLED)
    got = []
    for r in reports:
        if r == "discontinuity":
            s.notice_discontinuity()
        else:
            got.append(s.observe_numerics(_rep(**r)))
    assert got == kinds
    assert set(k for k, _ in s.anomalies) <= set(numerics.SENTRY_KINDS)


def test_sentry_record_detectors_and_one_dump_per_kind(tmp_path):
    tm = telemetry.Telemetry(rank=0, run_id="s", stream_dir=str(tmp_path))
    s = TrainingSentry({"verbose": False, "sentry_min_records": 2}, tm)
    for i in range(4):
        assert s.observe_record({"iter": i, "cost": 2.0,
                                 "images_per_sec": 100.0}) is None
    flight = os.path.join(str(tmp_path), "flight_rank0.jsonl")

    def reason():
        with open(flight) as f:
            return json.loads(f.readline())["reason"]

    assert s.observe_record({"iter": 5, "cost": float("nan")}) == "nan_loss"
    assert reason() == "sentry nan_loss at iter 5"
    assert s.observe_record({"iter": 6, "cost": 50.0}) == "loss_spike"
    assert reason() == "sentry loss_spike at iter 6"
    # a second nan_loss: an event, no second dump of its kind
    assert s.observe_record({"iter": 7, "cost": float("inf")}) == "nan_loss"
    assert reason() == "sentry loss_spike at iter 6"
    s.notice_discontinuity()
    assert s.observe_record({"iter": 8, "cost": 2.0,
                             "images_per_sec": 1.0}) is None
    assert s.observe_record({"iter": 9, "cost": 2.0,
                             "images_per_sec": 1.0}) == \
        "throughput_regression"
    assert tm.counters["sentry.anomalies"] == 4
    assert tm.counters["sentry.nan_loss"] == 2
    assert reason() == "sentry throughput_regression at iter 9"
    tm.close()
