"""The port's asynchronous islands around a center
(``theanompi_tpu_torch/parallel/async_easgd.py``) against the JAX package.

* ``ElasticCenter``'s algebra (push, push_pull, demote and readmit, the
  leaf-count check) against the JAX center's, bit for bit.
* One island under EASGD and under ASGD against the JAX ``IslandRunner``:
  ``torch_port_helper.TinyLRNNetFrom`` (Conv → LRN → Pool → FC, the plain
  B1/B2 on the CPU) from its JAX twin's weights, float32, no dropout,
  each stopped after 3 exchanges by a center that sets the stop event on
  its 3rd push: the center's leaves and the island's params, momentum
  too, at rtol 1e-5 / atol 1e-6 (``test_torch_rules.py``'s bound; the
  packages differ in summation order only).
* The same island over the wire, joining a center that a JAX trainer
  serves (``center_serve``): the center ends where the JAX island's
  in-memory center ends.
* A straggler does not block: of 2 in-process islands, one sleeps after
  every step while the other exchanges.
* The session API (``EASGD``/``ASGD`` with ``<rule>_mode='async'``), a
  center restart mid-run (re-seed, re-anchor), a failing island raising
  at once, the device rules, and two island processes around one center.
* ``convert``'s center leaves: a JAX center snapshot loads as a port
  model's params, and back, bit for bit.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import async_easgd as JA
from theanompi_tpu.parallel import center_server as JCS
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import async_easgd as TA
from theanompi_tpu_torch.parallel import center_server as TCS
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
K_EXCHANGES = 3
SYNC_FREQ = 2


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _stopping(base):
    """A center class that sets ``stop`` on its ``k``-th push, so an
    island stops after exactly k exchanges."""

    class Stopping(base):
        def __init__(self, stop, k, alpha=0.5):
            super().__init__(alpha=alpha)
            self.stop, self.k, self.pushes = stop, k, 0

        def _pushed(self):
            self.pushes += 1
            if self.pushes >= self.k:
                self.stop.set()

        def push_delta_leaves(self, deltas, island):
            super().push_delta_leaves(deltas, island)
            self._pushed()

        def push_pull_leaves(self, deltas, island):
            out = super().push_pull_leaves(deltas, island)
            self._pushed()
            return out

    return Stopping


J_STOPPING = _stopping(JA.ElasticCenter)
T_STOPPING = _stopping(TA.ElasticCenter)


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
    init = convert.params_from_jax(_host(jm.params))
    path = str(tmp_path_factory.mktemp("islands") / "init.npz")
    np.savez(path, **{"/".join(p): TH.get_leaf(init, p)
                      for p in TH.leaf_paths(init)})
    return path


_JAX_RUNS = {}


def _jax_island(rule):
    """The JAX package's one island (``async_islands`` 1, one CPU device),
    stopped after K_EXCHANGES: (center leaves, params, velocity) on the
    host; cached per rule."""
    if rule not in _JAX_RUNS:
        models = []

        def factory(cfg):
            models.append(_JTinyLRNNet(dict(cfg, verbose=False)))
            return models[-1]

        tr = JA.AsyncEASGDTrainer(factory, {
            "async_islands": 1, "n_workers": 1, "alpha": 0.5,
            "sync_freq": SYNC_FREQ, "verbose": False}, rule=rule)
        tr.center = J_STOPPING(tr.stop_event, K_EXCHANGES)
        tr.start()
        tr.islands[0].join(timeout=300)
        tr.stop_and_join()
        st = _host(models[0].step_state)
        _JAX_RUNS[rule] = (
            [np.asarray(x) for x in tr.center.pull_leaves()],
            jax.tree.map(lambda a: a[0], st["params"]),
            jax.tree.map(lambda a: a[0], st["opt_state"]),
            tr.islands[0].steps_done)
    return _JAX_RUNS[rule]


def _port_trainer(rule, npz, **cfg):
    return TA.AsyncEASGDTrainer(helper.TinyLRNNetFrom, dict({
        "async_islands": 1, "alpha": 0.5, "sync_freq": SYNC_FREQ,
        "device": "cpu", "verbose": False, "init_npz": npz}, **cfg),
        rule=rule)


def _check_island(rule, center_leaves, island):
    jc, jp, jv, jsteps = _jax_island(rule)
    assert island.steps_done == jsteps == K_EXCHANGES * SYNC_FREQ
    assert island.exchanges_done == K_EXCHANGES
    assert len(center_leaves) == len(jc)
    for a, b in zip(center_leaves, jc):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    m = island.model
    want_p, want_v = convert.params_from_jax(jp), convert.params_from_jax(jv)
    for path in TH.leaf_paths(want_p):
        np.testing.assert_allclose(
            TH.get_leaf(m.params, path).detach().numpy(),
            TH.get_leaf(want_p, path), rtol=RTOL, atol=ATOL,
            err_msg=f"params {path}")
        np.testing.assert_allclose(
            TH.get_leaf(m.opt_state, path).numpy(),
            TH.get_leaf(want_v, path), rtol=RTOL, atol=ATOL,
            err_msg=f"velocity {path}")
    if rule == "asgd":
        # after a downpour exchange the island IS the center it got back
        got = convert.center_leaves_from_params(m.params)
        for a, b in zip(got, center_leaves):
            np.testing.assert_array_equal(a, b)


# -- the center ----------------------------------------------------------------

def test_elastic_center_algebra_matches_jax():
    r = np.random.RandomState(0)
    p0 = [r.randn(3, 3, 2, 4).astype(np.float32), r.randn(5).astype(np.float32)]
    ds = [[r.randn(*x.shape).astype(np.float32) for x in p0]
          for _ in range(5)]
    centers = (JA.ElasticCenter(alpha=0.3), TA.ElasticCenter(alpha=0.3))
    outs = []
    for c in centers:
        c.ensure_init_leaves(p0)
        c.ensure_init_leaves(ds[0])          # a no-op once seeded
        c.push_delta_leaves(ds[0], 0)
        got = [c.push_pull_leaves(ds[1], 1)]
        c.demote_island(1)
        c.push_delta_leaves(ds[2], 1)        # dropped
        got.append(c.push_pull_leaves(ds[3], 1))   # dropped, still pulls
        c.readmit_island(1)
        c.push_delta_leaves(ds[4], 1)
        got.append(c.pull_leaves())
        with pytest.raises(AssertionError, match="mismatched model"):
            c.push_delta_leaves(ds[0][:1], 0)
        outs.append((got, c.stats_snapshot()))
    (jg, js), (tg, ts) = outs
    assert ts == js == {"n_updates": 3, "by_island": {0: 1, 1: 2},
                        "demoted": [], "dropped_by_island": {1: 2}}
    for a, b in zip(jg, tg):
        for x, y in zip(a, b):
            assert y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    want = [x + 0.3 * d0 + d1 + 0.3 * d4
            for x, d0, d1, d4 in zip(p0, ds[0], ds[1], ds[4])]
    for x, y in zip(tg[-1], want):
        np.testing.assert_allclose(x, y, rtol=1e-6)


def test_uninitialized_center_asserts():
    with pytest.raises(AssertionError, match="not initialized"):
        TA.ElasticCenter().pull_leaves()


# -- one island against the JAX package ----------------------------------------

@pytest.mark.parametrize("rule", ["easgd", "asgd"])
def test_one_island_matches_jax_island_runner(rule, init_npz):
    tr = _port_trainer(rule, init_npz)
    tr.center = T_STOPPING(tr.stop_event, K_EXCHANGES)
    tr.start()
    tr.islands[0].join(timeout=300)
    tr.stop_and_join()
    _check_island(rule, tr.center.pull_leaves(), tr.islands[0])
    st = tr.stats()
    assert st["center_updates"] == K_EXCHANGES
    isl = st["islands"][0]
    assert isl["exchanges"] == K_EXCHANGES and len(isl["costs"]) == 3
    assert isl["bytes_per_exchange"] == 2 * 4 * sum(
        int(np.prod(x.shape)) for x in tr.center.pull_leaves())
    assert set(isl["exchange_ms"]) >= {"drain", "d2h", "wire", "apply",
                                       "h2d", "total"}


@pytest.mark.parametrize("rule", ["easgd", "asgd"])
def test_port_island_joins_a_jax_served_center(rule, init_npz, monkeypatch):
    """A JAX trainer serves its center (``center_serve``; it runs no
    island of its own here); the port island joins it over the wire and
    the center ends where the JAX island's in-memory center ends."""
    stop = threading.Event()
    monkeypatch.setattr(JA, "ElasticCenter", lambda alpha=0.5: J_STOPPING(
        stop, K_EXCHANGES, alpha))
    jtr = JA.AsyncEASGDTrainer(lambda cfg: None, {
        "async_islands": 1, "n_workers": 1, "center_serve": True,
        "center_keep_serving": True}, rule=rule)
    port_tr = _port_trainer(rule, init_npz, center_addr=jtr.center_address)
    port_tr.stop_event = stop
    try:
        port_tr.start()
        port_tr.islands[0].join(timeout=300)
        port_tr.stop_and_join()
        _check_island(rule, jtr.center.pull_leaves(), port_tr.islands[0])
        assert jtr.center.updates_by_island == {0: K_EXCHANGES}
        # the replies carried the JAX server's time split
        rec = port_tr.islands[0].link.records[-1]
        assert rec["apply"] <= rec["wire"]
    finally:
        jtr._server.stop()


# -- asynchrony ----------------------------------------------------------------

def test_slow_island_does_not_block_fast_one(init_npz):
    tr = _port_trainer("easgd", init_npz, async_islands=2)
    tr.start(throttle={1: 3.0})
    fast, slow = tr.islands
    deadline = time.time() + 120
    while fast.exchanges_done < 3 and time.time() < deadline:
        assert fast.error is None and slow.error is None
        time.sleep(0.02)
    f_steps, f_exch, s_steps = fast.steps_done, fast.exchanges_done, \
        slow.steps_done
    tr.stop_and_join(timeout=60)
    assert f_exch >= 3 and f_steps >= 6
    assert s_steps <= 2, (f_steps, s_steps)
    assert tr.center.updates_by_island.get(0, 0) >= 3
    assert tr.center.n_updates == sum(tr.center.updates_by_island.values())
    # the islands read their own data streams from the same weights
    assert fast.config["data_seed"] == 0 and slow.config["data_seed"] == 1


@pytest.mark.parametrize("rule", ["EASGD", "ASGD"])
def test_session_api_async_mode(rule, tmp_path):
    import theanompi_tpu_torch as T
    r = getattr(T, rule)()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", verbose=False, sync_freq=2, async_islands=2,
           run_seconds=1.5, **{f"{rule.lower()}_mode": "async"})
    tr = r.wait()
    assert tr is r.trainer and len(tr.islands) == 2
    assert all(i.error is None and i.exchanges_done > 0 for i in tr.islands)
    assert tr.center.n_updates == sum(i.exchanges_done for i in tr.islands)
    assert all(np.isfinite(x).all() for x in tr.center_params)
    assert tr.epoch_records[0]["center_updates"] == tr.center.n_updates
    tr.save(str(tmp_path))
    with open(tmp_path / "async_easgd_stats.jsonl") as f:
        assert json.loads(f.readline())["center_updates"] > 0


def test_failing_island_raises_at_once():
    def factory(cfg):
        raise RuntimeError("no model here")

    tr = TA.AsyncEASGDTrainer(factory, {"async_islands": 2, "device": "cpu"})
    t0 = time.time()
    with pytest.raises(RuntimeError, match="no model here"):
        tr.run_for(60)
    assert time.time() - t0 < 30


def test_island_devices():
    cpu = TA.AsyncEASGDTrainer(lambda c: None, {"async_islands": 3,
                                                "device": "cpu"})
    assert [str(d) for d in cpu._island_devices] == ["cpu"] * 3
    with pytest.raises(NotImplementedError, match="more than one device"):
        TA.AsyncEASGDTrainer(lambda c: None, {"async_islands": 1,
                                              "n_workers": 2,
                                              "device": "cpu"})
    with pytest.raises(NotImplementedError, match="steps_per_call"):
        TA.AsyncEASGDTrainer(lambda c: None, {"device": "cpu",
                                              "steps_per_call": 2})
    if not torch.cuda.is_available():
        # an island that finds no card raises; nothing falls back
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TA.AsyncEASGDTrainer(lambda c: None, {"async_islands": 1})


@pytest.mark.parametrize("rule", ["easgd", "asgd"])
def test_island_survives_a_snapshotless_center_restart(rule, init_npz):
    """The center dies with nothing persisted and comes back empty on the
    same port: the island re-seeds it from its own params (a skipped
    exchange) and trains on."""
    srv = TCS.CenterServer(alpha=0.5)
    host, port = srv.start()
    tr = _port_trainer(rule, init_npz, sync_freq=1,
                       center_addr=f"{host}:{port}", wire_timeout=0.5,
                       wire_retries=2, wire_deadline=1.0)
    srv2 = None
    try:
        tr.start()
        isl = tr.islands[0]
        deadline = time.time() + 180
        while isl.exchanges_done < 1 and time.time() < deadline:
            assert isl.error is None, isl.error
            time.sleep(0.02)
        srv.stop()
        srv2 = TCS.CenterServer(alpha=0.5)
        srv2.start(host, port)
        e0 = isl.exchanges_done
        while isl.exchanges_done < e0 + 2 and time.time() < deadline:
            assert isl.error is None, isl.error
            time.sleep(0.02)
        tr.stop_and_join(timeout=120)
        assert isl.exchanges_done >= e0 + 2
        assert isl.exchanges_skipped >= 1
        assert srv2.center.n_updates >= 2
    finally:
        if srv2 is not None:
            srv2.stop()
        srv.stop()


@pytest.mark.parametrize("rule", ["easgd", "asgd"])
def test_two_island_processes_share_one_center(rule):
    """Two processes, each one island, join one center over TCP; the
    throttled one lags while the other exchanges."""
    srv = TCS.CenterServer(alpha=0.5)
    host, port = srv.start()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_port_helper.py"),
             "island", str(i), f"{host}:{port}", rule,
             "4.0" if i == 1 else "0.0", "6.0" if i == 1 else "-1"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=400)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("ST ")][0]
            outs.append(json.loads(line[3:]))
    finally:
        srv.stop()
    fast = next(o for o in outs if o["proc"] == 0)["islands"][0]
    slow = next(o for o in outs if o["proc"] == 1)["islands"][0]
    assert fast["exchanges"] >= 2 and fast["steps"] >= 4, (fast, slow)
    assert slow["steps"] <= 2, (fast, slow)
    by_island = srv.center.updates_by_island
    assert by_island.get(0, 0) >= 2, by_island
    assert srv.center.n_updates == sum(by_island.values())
    assert all(np.isfinite(x).all() for x in srv.center.pull_leaves())


# -- weights carried across ------------------------------------------------------

def test_center_leaves_round_trip_bit_for_bit(tmp_path):
    """A JAX center's snapshot (JAX params seeded through its own server)
    loads as the port model's params — the same arrays as
    ``params_from_jax`` — and the port's params go back out as the JAX
    leaves, bit for bit."""
    jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
    jparams = _host(jm.params)
    srv = JCS.CenterServer(alpha=0.5, snapshot_dir=str(tmp_path))
    srv.center.ensure_init(jparams)
    srv.snapshot()
    leaves, meta = TCS.load_snapshot(TCS.snapshot_path(str(tmp_path)))
    like = helper.TinyLRNNet({"device": "cpu", "verbose": False}).params
    got = convert.params_from_center_leaves(leaves, like)
    want = convert.params_from_jax(jparams)
    assert TH.leaf_paths(got) == TH.leaf_paths(like)
    for p in TH.leaf_paths(want):
        np.testing.assert_array_equal(TH.get_leaf(got, p),
                                      TH.get_leaf(want, p))
    tensors = TH.tree_map(torch.from_numpy, got)
    back = convert.center_leaves_from_params(tensors)
    for a, b in zip(back, jax.tree.leaves(jparams)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="center leaves"):
        convert.params_from_center_leaves(leaves[:-1], like)
