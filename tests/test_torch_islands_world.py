"""Async islands of more than one device (``parallel/async_easgd.py``), on
CPU gloo through the port's launcher.

* 2 islands × 2 ranks (and 2 islands of one rank each, a process each)
  around the center global rank 0 holds and serves
  (``torch_launch_helper``'s ``islands`` mode in each rank, started as
  the launcher starts the worker; each island stops after 3 exchanges),
  EASGD and ASGD.  Every rank of an island is a local worker with a
  replica of its own (the replicas part after the first step, on their
  own data), and every exchange is held against a plain recomputation
  from the tensors around it: each rank got what its rank 0 pulled;
  EASGD moves each replica to ``p − α(p − c)`` within a few float32
  roundings of a float64 recomputation and pushes the replicas' mean
  delta bit for bit; ASGD pushes the replicas' mean less the anchor bit
  for bit and resets every replica to the center it got back, so the
  island's params are bit-identical after each ASGD exchange.  Both
  ranks of an island take the same steps; the center counts 3 exchanges
  of each island.
* One island of 2 ranks, the center in rank 0's memory, against the JAX
  package's one island of 2 host devices (its own ``IslandRunner``,
  unchanged) over the same 3 exchanges (``sync_freq`` 2), from the same
  weights, float32, no dropout: the center's leaves, and each worker's
  params and momentum, at rtol 1e-5 / atol 1e-6
  (``test_torch_async_easgd.py``'s bound for one island).
* The worker command line (``easgd_mode=async``) trains 2 islands × 2
  ranks through the launcher for a few seconds.
* The refusals: a multi-device island outside a launched world, and a
  world that does not split into equal islands.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from theanompi_tpu.parallel import async_easgd as JA
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import async_easgd as TA
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_launch_helper as lh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_async_easgd import J_STOPPING  # noqa: E402

ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")]))
LAUNCH = [sys.executable, "-m", "theanompi_tpu_torch.launcher"]
K_EXCHANGES, SYNC_FREQ, ALPHA = 3, 2, 0.5
TOL = (1e-5, 1e-6)                                       # (rtol, atol)
# EASGD's pull against a float64 recomputation: the delta, the product and
# the sum each round once in float32 (chip_smoke.py's EASGD_TOL)
EASGD_TOL = (2.0 ** -21, 2.0 ** -22)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _islands(tmp, rule, world, n_islands, modelclass="TinyLRNNet", *kv):
    out = str(tmp / f"{rule}{world}")
    with pytest.MonkeyPatch.context() as mp:
        for k in ("OMP_NUM_THREADS", "PYTHONPATH"):
            mp.setenv(k, ENV[k])
        rc = lh.launch(rule, modelclass, world, "device=cpu",
                       "helper_mode=islands", f"helper_out={out}",
                       f"async_islands={n_islands}", f"sync_freq={SYNC_FREQ}",
                       f"alpha={ALPHA}", f"helper_exchanges={K_EXCHANGES}",
                       *kv)
    assert rc == 0
    ranks = []
    for i in range(world):
        with np.load(f"{out}_r{i}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


@pytest.mark.parametrize("size", [2, 1])
@pytest.mark.parametrize("rule", ["easgd", "asgd"])
def test_two_islands_around_a_served_center(rule, size, tmp_path):
    """2 islands of ``size`` ranks (a rank a process), each stopping after
    K_EXCHANGES exchanges."""
    ranks = _islands(tmp_path, rule, 2 * size, 2)
    assert [int(r["island"]) for r in ranks] == [0] * size + [1] * size
    for lead in (0, size):
        island = ranks[lead:lead + size]
        a = island[0]
        assert int(a["steps"]) == K_EXCHANGES * SYNC_FREQ
        for b in island[1:]:
            assert int(b["steps"]) == int(a["steps"])
            np.testing.assert_array_equal(b["init"], a["init"])
            # a local worker on its own data, not a copy of rank 0
            assert not np.array_equal(b["ex/0/before"], a["ex/0/before"])
            assert not any(k.endswith(("/pulled", "/pushed")) for k in b)
        for j in range(K_EXCHANGES):
            befores = [r[f"ex/{j}/before"] for r in island]
            afters = [r[f"ex/{j}/after"] for r in island]
            pulled, pushed = a[f"ex/{j}/pulled"], a[f"ex/{j}/pushed"]
            for r in island:
                # every replica trained since the exchange before
                assert not np.array_equal(
                    r[f"ex/{j}/before"],
                    r[f"ex/{j - 1}/after"] if j else r["init"])
                np.testing.assert_array_equal(r[f"ex/{j}/got"], pulled)
            if rule == "easgd":
                deltas = [p - pulled for p in befores]
                np.testing.assert_array_equal(
                    pushed, sum(deltas[1:], deltas[0]) / np.float32(size))
                for p, after in zip(befores, afters):
                    want = p.astype(np.float64) - ALPHA * (
                        p.astype(np.float64) - pulled)
                    np.testing.assert_allclose(
                        after, want, rtol=EASGD_TOL[0],
                        atol=EASGD_TOL[1] * float(np.abs(want).max()))
            else:
                mean = sum(befores[1:], befores[0]) / np.float32(size)
                np.testing.assert_array_equal(pushed,
                                              mean - a[f"ex/{j}/anchor"])
                for after in afters:
                    np.testing.assert_array_equal(after, pulled)
    # global rank 0 held the center: 3 exchanges from each island
    assert json.loads(str(ranks[0]["by_island"])) == {"0": K_EXCHANGES,
                                                      "1": K_EXCHANGES}
    assert not any(k.startswith("center/") for r in ranks[1:] for k in r)
    assert all(np.isfinite(ranks[0][f"center/{i}"]).all() for i in range(4))


_JAX_RUNS = {}


def _jax_island_of_two(rule):
    if rule not in _JAX_RUNS:
        models = []

        def factory(cfg):
            models.append(_JTinyLRNNet(dict(cfg, verbose=False)))
            return models[-1]

        tr = JA.AsyncEASGDTrainer(factory, {
            "async_islands": 1, "n_workers": 2, "alpha": ALPHA,
            "sync_freq": SYNC_FREQ, "verbose": False}, rule=rule)
        tr.center = J_STOPPING(tr.stop_event, K_EXCHANGES, alpha=ALPHA)
        tr.start()
        tr.islands[0].join(timeout=300)
        tr.stop_and_join()
        st = _host(models[0].step_state)
        _JAX_RUNS[rule] = ([np.asarray(x) for x in tr.center.pull_leaves()],
                           st["params"], st["opt_state"],
                           tr.islands[0].steps_done)
    return _JAX_RUNS[rule]


@pytest.mark.parametrize("rule", ["easgd", "asgd"])
def test_one_island_of_two_ranks_matches_jax(rule, tmp_path):
    jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
    init = convert.params_from_jax(_host(jm.params))
    npz = str(tmp_path / "init.npz")
    np.savez(npz, **{"/".join(p): TH.get_leaf(init, p)
                     for p in TH.leaf_paths(init)})
    ranks = _islands(tmp_path, rule, 2, 1, "TinyLRNNetFrom",
                     f"init_npz={npz}")
    jc, jp, jv, jsteps = _jax_island_of_two(rule)
    rtol, atol = TOL
    assert int(ranks[0]["steps"]) == jsteps == K_EXCHANGES * SYNC_FREQ
    for i, want in enumerate(jc):
        np.testing.assert_allclose(ranks[0][f"center/{i}"], want, rtol=rtol,
                                   atol=atol, err_msg=f"center leaf {i}")
    paths = TH.leaf_paths(helper.TinyLRNNet({"device": "cpu",
                                             "verbose": False}).params)
    for w, r in enumerate(ranks):   # the JAX island's worker w, as rank w
        want_p = convert.params_from_jax(jax.tree.map(lambda a: a[w], jp))
        want_v = convert.params_from_jax(jax.tree.map(lambda a: a[w], jv))
        for i, path in enumerate(paths):
            name = "/".join(path)
            np.testing.assert_allclose(
                r[f"params/{name}"], TH.get_leaf(want_p, path), rtol=rtol,
                atol=atol, err_msg=f"worker {w} params {name}")
            np.testing.assert_allclose(
                r[f"opt/{i}"], TH.get_leaf(want_v, path), rtol=rtol,
                atol=atol, err_msg=f"worker {w} velocity {name}")


def test_worker_command_line_trains_islands_of_two(tmp_path):
    rec = str(tmp_path / "rec")
    r = subprocess.run(
        LAUNCH + ["--rule", "easgd", "--modelfile", "torch_port_helper",
                  "--modelclass", "TinyLRNNet", "--n-workers", "4",
                  "device=cpu", "easgd_mode=async", "async_islands=2",
                  "sync_freq=2", "run_seconds=3", f"record_dir={rec}"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    st = []
    for i in range(4):
        with open(os.path.join(rec, f"async_easgd_stats_rank{i}.jsonl")) as f:
            st.append(json.loads(f.readline()))
    isl = [s["islands"][0] for s in st]
    assert [i["island"] for i in isl] == [0, 0, 1, 1]
    for lead, other in ((0, 1), (2, 3)):
        assert isl[lead]["exchanges"] >= 1
        for k in ("steps", "exchanges", "exchanges_skipped"):
            assert isl[lead][k] == isl[other][k], (isl[lead], isl[other])
    assert st[0]["center_updates"] == isl[0]["exchanges"] + isl[2]["exchanges"]


def test_multi_device_islands_need_a_launched_world():
    with pytest.raises(NotImplementedError, match="launcher"):
        TA.AsyncEASGDTrainer(lambda c: None, {"async_islands": 2,
                                              "n_workers": 4,
                                              "device": "cpu"})
    with pytest.raises(ValueError, match="equal size"):
        TA.AsyncEASGDTrainer(lambda c: None, {"async_islands": 2,
                                              "n_workers": 3,
                                              "device": "cpu",
                                              "init_method": "tcp://x:1"})
