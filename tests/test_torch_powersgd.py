"""The port's PowerSGD wire against the JAX package's.

* names, the compressible-leaf rule and the state's structure against the
  JAX package's ``PowerSGD``;
* ``convert.powersgd_state_from_jax``: the JAX state (its sorted leaf order,
  ``e`` as its ``[rows, cols]`` matrix) in the port's leaf order and
  layouts, so that ``g + e`` is the same matrix in both;
* one exchange at world 1 against the algorithm written out in float64 on
  the JAX package's layout, and the exact decode when the rank covers the
  matrix;
* a 3-step BSP trajectory of a small VGG block under
  ``exch_strategy='powersgd1'`` through both packages' step paths, the
  port started from the JAX package's initial state (at rank 2 no leaf of
  the block is compressible: min(27, 8) = 8 is not > 8);
* PowerSGD over two gloo processes against the float64 composition of
  both ranks' inputs, and two ranks training with bit-identical
  parameters and different error states.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import strategies as JS
from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JBSP
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import strategies as S
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger as TBSP
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_vgg import _host, _JTinyVGGNet, cpu_group  # noqa: E402,F401


def _jax_tree(seed=3):
    """A tree in the JAX layout: a conv [3, 3, 4, 12], an FC [40, 10], a
    small FC [6, 3] and biases."""
    r = np.random.RandomState(seed)
    return {"conv": {"w": r.randn(3, 3, 4, 12).astype(np.float32),
                     "b": r.randn(12).astype(np.float32)},
            "fc": {"w": r.randn(40, 10).astype(np.float32),
                   "b": r.randn(10).astype(np.float32)},
            "head": {"w": r.randn(6, 3).astype(np.float32)}}


def _port(jtree):
    return TH.tree_map(torch.from_numpy, convert.params_from_jax(jtree))


@pytest.mark.parametrize("name,kw,rank", [
    ("powersgd", {}, 2), ("powersgd", {"rank": 3}, 3), ("powersgd4", {}, 4),
    ("PowerSGD1", {"rank": 1}, 1)])
def test_names_resolve_as_in_jax(name, kw, rank):
    strat, ref = S.get_strategy(name, **kw), JS.get_strategy(name, **kw)
    assert isinstance(strat, S.PowerSGD)
    assert strat.rank == ref.rank == rank and strat.name == ref.name
    assert strat.stateful and not strat.flattens


def test_rank_conflict_asserts_as_in_jax():
    for get in (S.get_strategy, JS.get_strategy):
        with pytest.raises(AssertionError, match="conflicts"):
            get("powersgd4", rank=2)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_compressible_rule_matches_jax(rank):
    """The port tests its leaf shape; the JAX package the JAX layout's."""
    jtree = _jax_tree()
    jtree["c1"] = {"w": np.zeros((3, 3, 3, 64), np.float32)}   # 27 × 64
    jtree["c2"] = {"w": np.zeros((3, 3, 1, 8), np.float32)}    # 9 × 8
    ttree = _port(jtree)
    strat, ref = S.PowerSGD(rank), JS.PowerSGD(rank)
    for path in TH.jax_leaf_paths(jtree):
        jshape = TH.get_leaf(jtree, path).shape
        assert strat._compressible(TH.get_leaf(ttree, path).shape) == \
            ref._compressible(jshape), (path, jshape)


def test_init_state_structure():
    """A list over the port's leaves: ``q`` [cols, r] from the seed
    ``1905 + i`` (the same on every call, so on every rank), ``e`` zeros
    in the leaf's shape; empty for an incompressible leaf."""
    ttree = _port(_jax_tree())
    strat = S.PowerSGD(2)
    st = strat.init_state(ttree)
    again = strat.init_state(ttree)
    leaves = TH.tree_leaves(ttree)
    assert len(st) == len(leaves)
    for s, s2, leaf in zip(st, again, leaves):
        if strat._compressible(leaf.shape):
            assert s["q"].shape == (leaf.shape[0], 2)
            assert s["e"].shape == leaf.shape and not s["e"].any()
            assert torch.equal(s["q"], s2["q"])
        else:
            assert s["q"].shape == (0, 2) and s["e"].shape == (0, 0)
    assert [s["e"].numel() > 0 for s in st] == \
        [True, False, True, False, False]         # conv w, fc w only


def test_state_converter():
    """The JAX package's state (sorted leaves, ``e`` as ``[rows, cols]``)
    lands in the port's order; ``q`` is unchanged and ``g + e`` is the
    same matrix in both packages' layouts."""
    jtree = _jax_tree()
    ttree = _port(jtree)
    jst = JS.PowerSGD(2).init_state(jtree)
    r = np.random.RandomState(9)
    jst = [{"q": np.asarray(s["q"]),
            "e": r.randn(*np.shape(s["e"])).astype(np.float32)}
           for s in jst]
    got = convert.powersgd_state_from_jax(jst, jtree, ttree)
    jpaths = TH.jax_leaf_paths(jtree)
    for path, s in zip(TH.leaf_paths(ttree), got):
        js = jst[jpaths.index(path)]
        np.testing.assert_array_equal(s["q"], js["q"])
        leaf = TH.get_leaf(jtree, path)
        if js["e"].size == 0:
            assert s["e"].shape == (0, 0)
            continue
        m = leaf.reshape(-1, leaf.shape[-1]) + js["e"]     # JAX: M + e
        want = convert.params_from_jax(m.reshape(leaf.shape))
        np.testing.assert_array_equal(
            TH.get_leaf(ttree, path).numpy() + s["e"], want)
    with pytest.raises(ValueError, match="states"):
        convert.powersgd_state_from_jax(jst[:-1], jtree, ttree)


def _reference(grads_j, states_j, rank):
    """The PowerSGD exchange in float64 on the JAX layout, over the ranks'
    gradient trees and states (``M`` = leaf.reshape(-1, cols)): the mean
    tree and each rank's new ``e``, per compressible leaf path."""
    size = len(grads_j)
    out, es = {}, [{} for _ in range(size)]
    for path in TH.jax_leaf_paths(grads_j[0]):
        shape = TH.get_leaf(grads_j[0], path).shape
        if not JS.PowerSGD(rank)._compressible(shape):
            out[path] = np.mean([TH.get_leaf(g, path) for g in grads_j], 0)
            continue
        ms = [TH.get_leaf(g, path).reshape(-1, shape[-1]).astype(np.float64)
              + st[path]["e"] for g, st in zip(grads_j, states_j)]
        q = states_j[0][path]["q"].astype(np.float64)
        ph, _ = np.linalg.qr(np.mean([m @ q for m in ms], 0))
        qn = np.mean([m.T @ ph for m in ms], 0)
        mhat = ph @ qn.T
        out[path] = mhat.reshape(shape)
        for e, m in zip(es, ms):
            e[path] = m - mhat
    return out, es


def test_world_one_exchange_is_the_algorithm(cpu_group):
    """One rank, from a nonzero state: the port's mean and new ``e``
    against the float64 algorithm on the JAX layout (rtol 1e-4 / atol
    1e-5: float32 products of length ≤ 40, a QR, and a rank-2 product).
    The incompressible leaves come back as they went in (the world-1
    mean), reduced in place."""
    jtree = _jax_tree()
    ttree = _port(jtree)
    strat = S.PowerSGD(2)
    st = strat.init_state(ttree)
    r = np.random.RandomState(4)
    for s in st:
        s["e"] += torch.from_numpy(
            r.randn(*s["e"].shape).astype(np.float32) * 0.1)
    jpaths = TH.jax_leaf_paths(jtree)
    port_st = dict(zip(TH.leaf_paths(ttree), st))
    st_j = {}
    for p in jpaths:
        leaf = TH.get_leaf(jtree, p)
        e = port_st[p]["e"].numpy()
        st_j[p] = {"q": port_st[p]["q"].numpy(), "e": (
            TH.to_jax_layout(torch.from_numpy(e)).reshape(
                -1, leaf.shape[-1]).numpy() if e.size else e)}
    want, (want_e,) = _reference([jtree], [st_j], 2)
    dense_before = ttree["fc"]["b"]
    mean, new = strat(ttree, st, size=1)
    assert mean["fc"]["b"] is dense_before                   # in place
    for p in jpaths:
        np.testing.assert_allclose(
            TH.to_jax_layout(TH.get_leaf(mean, p)).numpy(), want[p],
            rtol=1e-4, atol=1e-5, err_msg=str(p))
    for p, s in zip(TH.leaf_paths(ttree), new):
        if p in want_e:
            e = TH.to_jax_layout(s["e"]).reshape(want_e[p].shape).numpy()
            np.testing.assert_allclose(e, want_e[p], rtol=1e-4, atol=1e-5)


def test_exact_when_the_rank_covers_the_matrix(cpu_group):
    """A gradient of rank ≤ r decodes to itself and leaves e ≈ 0 (the JAX
    package's ``test_exact_when_rank_covers_the_mean`` at world 1)."""
    r = np.random.RandomState(5)
    g = (r.randn(12, 2) @ r.randn(2, 36)).astype(np.float32)   # rank 2
    tree = {"w": torch.from_numpy(g.reshape(12, 4, 3, 3))}
    strat = S.PowerSGD(2)
    mean, new = strat(tree, strat.init_state(tree), size=1)
    np.testing.assert_allclose(mean["w"].numpy(), g.reshape(12, 4, 3, 3),
                               rtol=1e-4, atol=1e-5)
    assert float(new[0]["e"].abs().max()) < 1e-4


def test_powersgd1_three_step_trajectory_matches_jax(cpu_group):
    """3 BSP steps at world 1 under ``exch_strategy='powersgd1'``, both
    packages from the same weights, data and initial state (the JAX
    package's ``q``, through ``convert.powersgd_state_from_jax``).

    Tolerances: cost rtol 1e-5; params rtol 1e-5 / atol 1e-6 and momentum
    rtol 1e-5 / atol 1e-7, as for the allreduce trajectory (float32, the
    gradients differ in summation order, ~1e-7 relative; the factor
    products and the QR add a few ulps).  ``e`` is held to rtol 1e-5 /
    atol 1e-6; ``q`` too, up to the sign of each column (QR fixes P̂ only
    up to it; M̂ and e do not depend on it)."""
    cfg = {"verbose": False, "exch_strategy": "powersgd1"}
    jm = _JTinyVGGNet(dict(cfg, n_workers=1))
    tm = helper.TinyVGGNet(dict(cfg, device="cpu"))
    jp0 = _host(jm.params)
    tm.load_params(convert.params_from_jax(jp0))
    jm.compile_iter_fns(JBSP(jm.config))
    tm.compile_iter_fns(TBSP(tm.config))

    def jax_state():
        return jax.tree.map(lambda v: np.asarray(v)[0],
                            jax.device_get(jm.step_state["extra"]["strat"]))

    st0 = convert.powersgd_state_from_jax(jax_state(), jp0, tm.params)
    assert [s["e"].size > 0 for s in st0] == [True, False] * 3
    tm.extra["strat"] = [{k: torch.from_numpy(v) for k, v in s.items()}
                         for s in st0]
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)
    want = convert.params_from_jax(_host(jm.canonical_host_params()))
    got = tm.host_params()
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n], want[k][n], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}/{n}")
    vel = jax.tree.map(lambda v: np.asarray(v)[0],
                       jax.device_get(jm.step_state["opt_state"]))
    want_v = convert.params_from_jax(vel)
    for k in want_v:
        for n in want_v[k]:
            np.testing.assert_allclose(tm.opt_state[k][n].numpy(),
                                       want_v[k][n], rtol=1e-5, atol=1e-7,
                                       err_msg=f"velocity {k}/{n}")
    want_s = convert.powersgd_state_from_jax(jax_state(), jp0, tm.params)
    for w, g in zip(want_s, tm.extra["strat"]):
        q = g["q"].numpy()
        sign = np.where((w["q"] * q).sum(0) < 0, -1.0, 1.0)
        np.testing.assert_allclose(q, w["q"] * sign, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["e"].numpy(), w["e"], rtol=1e-5,
                                   atol=1e-6)
        assert g["e"].numel() == 0 or g["e"].any()


def _rank_states(r, n_leaves):
    return [{k: r[f"state/{i}/{k}"] for k in ("q", "e")}
            for i in range(n_leaves)]


def test_powersgd_two_gloo_ranks_match_the_float64_composition(tmp_path):
    """Each rank's mean against the float64 algorithm over both ranks'
    inputs (rtol 1e-4 / atol 1e-5, as at world 1), the same on both ranks
    bit for bit (both decode the same reduced factors); each rank's ``e``
    is its own ``M' − M̂``."""
    ranks = helper.run_ranks("powersgd", 2, tmp_path, "ps")
    like = helper.TinyVGGNet({"device": "cpu", "verbose": False}).params
    paths = TH.leaf_paths(like)
    init = dict(zip(paths, S.PowerSGD(1).init_state(like)))
    grads_j, states_j = [], []
    for r in ranks:
        g = TH.unflatten_like(like, torch.from_numpy(r["flat"]))
        grads_j.append(TH.tree_map(lambda t: TH.to_jax_layout(t).numpy(), g))
        states_j.append({p: {"q": init[p]["q"].numpy(), "e": 0.0}
                         for p in paths})
    want, want_e = _reference(grads_j, states_j, 1)
    np.testing.assert_array_equal(ranks[0]["mean"], ranks[1]["mean"])
    for r, we in zip(ranks, want_e):
        mean = TH.unflatten_like(like, torch.from_numpy(r["mean"]))
        for p in paths:
            np.testing.assert_allclose(
                TH.to_jax_layout(TH.get_leaf(mean, p)).numpy(), want[p],
                rtol=1e-4, atol=1e-5, err_msg=str(p))
        for p, s in zip(paths, _rank_states(r, len(paths))):
            if p in we:
                e = TH.to_jax_layout(torch.from_numpy(s["e"])).reshape(
                    we[p].shape).numpy()
                np.testing.assert_allclose(e, we[p], rtol=1e-4, atol=1e-5)


def test_powersgd_bsp_two_gloo_ranks_stay_identical(tmp_path):
    """Two ranks train one epoch (3 steps) of the VGG block under
    ``powersgd1``: both decode the same reduced factors, so their
    parameters and ``q`` are bit-identical, while their ``e``, made from
    their own gradients, differ."""
    r0, r1 = helper.run_ranks("train", 2, tmp_path, "pst", 8, "TinyVGGNet",
                              "powersgd1")
    assert sorted(r0) == sorted(r1)
    for k in r0:
        if not k.endswith("/e"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    es = [k for k in r0 if k.endswith("/e") and r0[k].size]
    assert es == ["extra/strat/0/e", "extra/strat/2/e", "extra/strat/4/e"]
    for k in es:
        assert not np.array_equal(r0[k], r1[k]), k
    init = helper.TinyVGGNet({"device": "cpu"}).host_params()
    assert not np.allclose(r0["fc/w"], init["fc"]["w"])     # it trained
