"""In-world elastic membership of the port (``Exchanger.set_active_ranks``
driven by ``membership.MeshReactor`` through the ``MembershipController``)
against the JAX package's (``tests/test_membership.py:351-480``,
``tests/test_buckets.py:99-210``).

One launch of 4 gloo ranks and one of 2 (``torch_elastic_helper.py``'s
``mesh`` mode) train ``TinyLRNNetFrom`` from the JAX twin's weights under
each case of ``MESH_CASES`` for 6 steps, a rank demoted after step 2 and
readmitted after step 4 by the same controller sequence on every rank:

* EASGD and ASGD at 4 ranks against the JAX rules on ``worker_mesh(4)``
  with the same init, data and active sets: every rank's params,
  velocity and center within the rule tests' tolerance
  (``tests/test_torch_rules.py``'s ``TOL``);
* a demoted rank's replica (and GoSGD's α) bit-frozen by the exchange
  while every rank's copy of a center stays bit-equal, the active ranks
  mixing; ASGD's demoted rank keeps its replica and resets once
  readmitted; a readmitted rank mixes again;
* GoSGD's tables over the active set bit-equal to the JAX package's
  (``embed_active`` of ``derangements(m)`` and ``iid_maps(m)``), ``shift``
  on the active sub-ring, Σα conserved, and one active rank keeping its α
  through a fixed point delivered locally, with no send or receive;
* the bucketed wire against the monolithic one: bit for bit at 2 ranks;
  at 4 the summing rules within the bucket tests' trajectory bound, and
  GoSGD bit for bit;
* ``update_sharding``'s gathered center and the fused cadence
  (``steps_per_call`` 2, where ``MeshReactor`` rebuilds the step) bit for
  bit the plain unfused run: the optimizer state, the center and α
  carried over, not initialised again;
* the numerics beacon bit-equal on every rank while a rank is demoted;
* the refusals: BSP (naming ``launcher --supervise``), an empty set, an
  out-of-range rank, a call before ``prepare``.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import exchanger as JEX
from theanompi_tpu.parallel import topology as JT
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import exchanger as TEX
from theanompi_tpu_torch.parallel import membership as mb
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_elastic_helper as eh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_rules import TOL  # noqa: E402

# the bucket tests' bound on a 4-rank summing trajectory (another order of
# float32 sums, compounded over the steps; tests/test_torch_buckets.py)
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
SUMMING = ("easgd", "asgd")


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
    init = convert.params_from_jax(_host(jm.params))
    npz = str(tmp / "init.npz")
    np.savez(npz, **{"/".join(p): TH.get_leaf(init, p)
                     for p in TH.leaf_paths(init)})
    return {w: helper.run_ranks("mesh", w, tmp, f"mesh{w}", npz,
                                script="torch_elastic_helper.py",
                                timeout=240) for w in (4, 2)}


def _keys(st, case, when, kinds=("params/", "opt/", "extra/", "center/")):
    pre = f"{case}/{when}/"
    return sorted(k[len(pre):] for k in st if k.startswith(pre)
                  and k[len(pre):].startswith(kinds))


def _paths():
    return TH.leaf_paths(helper.TinyLRNNet({"device": "cpu",
                                            "verbose": False}).params)


def _jax_run(case):
    """The JAX rule on ``worker_mesh(4)`` driven as the helper drives the
    port: the exchange hook after each step, rank 2 demoted after step 2
    and readmitted after step 4."""
    rule, cfg = eh.MESH_CASES[case]
    cfg = {k: v for k, v in cfg.items() if not k.startswith("numerics")}
    jm = _JTinyLRNNet(dict(cfg, n_workers=4, batch_size=eh.BATCH,
                           verbose=False))
    ex = JEX.get_exchanger(rule, jm.config)
    jm.compile_iter_fns(ex)
    jm.data.shuffle_data(0)
    for count in range(1, eh.STEPS + 1):
        jm.train_iter(count)
        ex.exchange(None, count)
        if count == 2:
            ex.set_active_ranks([r for r in range(4)
                                 if r not in eh.demoted(case, 4)])
        elif count == 4:
            ex.set_active_ranks(None)
    return _host(jm.step_state)


@pytest.mark.parametrize("case", SUMMING)
def test_center_rules_match_jax_with_a_rank_demoted(worlds, case):
    ranks = worlds[4]
    state = _jax_run(case)
    rtol, atol = TOL[case]
    paths = _paths()
    center = convert.params_from_jax(
        jax.tree.map(lambda a: a[0], state["extra"]["center"]))
    for r, st in enumerate(ranks):
        row = jax.tree.map(lambda a: a[r], state)
        want = {"params": convert.params_from_jax(row["params"]),
                "opt": convert.params_from_jax(row["opt_state"]),
                "center": center}
        for kind, tree in want.items():
            for i, p in enumerate(paths):
                got = st[f"{case}/end/params/" + "/".join(p)] \
                    if kind == "params" else st[f"{case}/end/{kind}/{i}"]
                np.testing.assert_allclose(
                    got, TH.get_leaf(tree, p), rtol=rtol, atol=atol,
                    err_msg=f"rank {r} {kind} {p}")


X_CASES = ("easgd", "easgd-buck", "easgd-us", "asgd", "asgd-buck", "gosgd",
           "gosgd-buck", "gosgd-iid", "gosgd-shift", "gosgd-one")


@pytest.mark.parametrize("case", X_CASES)
def test_demoted_replica_is_bit_frozen_and_centers_agree(worlds, case):
    """Around step 3's exchange: each demoted rank's params (and α) bit for
    bit as before it; each active rank moved (one active rank alone mixes
    with nothing); every rank's full center the same bits at each
    snapshot."""
    ranks = worlds[4]
    out = eh.demoted(case, 4)
    frozen = ("params/", "extra/") if case.startswith("gosgd") \
        else ("params/",)
    for r, st in enumerate(ranks):
        keys = _keys(st, case, "x3pre", frozen)
        assert keys
        moved = [k for k in keys if k.startswith("params/") and not
                 np.array_equal(st[f"{case}/x3pre/{k}"],
                                st[f"{case}/x3post/{k}"])]
        if r in out:
            assert not moved, (r, moved)
            for k in keys:
                np.testing.assert_array_equal(st[f"{case}/x3post/{k}"],
                                              st[f"{case}/x3pre/{k}"],
                                              err_msg=f"rank {r} {k}")
        elif case != "gosgd-one":
            assert moved, r
    for when in ("x3pre", "x3post", "x5post", "end"):
        for k in _keys(ranks[0], case, when, ("center/",)):
            for r, st in enumerate(ranks[1:], 1):
                np.testing.assert_array_equal(
                    st[f"{case}/{when}/{k}"], ranks[0][f"{case}/{when}/{k}"],
                    err_msg=f"{when} rank {r} {k}")


@pytest.mark.parametrize("case", X_CASES)
def test_readmitted_rank_mixes_again(worlds, case):
    """After the readmission the exchange moves the rank again: its params
    at step 5's exchange, or under GoSGD (whose iid draw may leave it
    without a message there) its α by the end."""
    for d in eh.demoted(case, 4):
        st = worlds[4][d]
        keys = _keys(st, case, "x5pre", ("params/",))
        moved = any(not np.array_equal(st[f"{case}/x5pre/{k}"],
                                       st[f"{case}/x5post/{k}"])
                    for k in keys)
        if case.startswith("gosgd") and not moved:
            moved = float(st[f"{case}/x5pre/extra/0"]) != \
                float(st[f"{case}/end/extra/0"])
        assert moved, (case, d)
        assert int(st[f"{case}/active_end"]) == -1


@pytest.mark.parametrize("case", ["asgd", "asgd-buck"])
def test_asgd_demoted_rank_keeps_its_replica_then_resets(worlds, case):
    ranks = worlds[4]
    d = eh.demoted(case, 4)[0]
    for k in _keys(ranks[0], case, "x3post", ("params/",)):
        for r in range(4):
            if r != d:      # the active ranks restarted from one center
                np.testing.assert_array_equal(ranks[r][f"{case}/x3post/{k}"],
                                              ranks[0][f"{case}/x3post/{k}"])
        assert not np.array_equal(ranks[d][f"{case}/x3post/{k}"],
                                  ranks[0][f"{case}/x3post/{k}"])
        for r in range(4):  # readmitted: every rank from the same center
            np.testing.assert_array_equal(ranks[r][f"{case}/x5post/{k}"],
                                          ranks[0][f"{case}/x5post/{k}"])


@pytest.mark.parametrize("case", ["gosgd", "gosgd-buck", "gosgd-iid",
                                  "gosgd-shift", "gosgd-fused", "gosgd-one"])
def test_gosgd_alpha_conserved_and_one_active_rank_keeps_its_own(worlds,
                                                                 case):
    ranks = worlds[4]
    whens = ("end",) if case.endswith("fused") else \
        ("x3pre", "x3post", "x5pre", "x5post", "end")
    for when in whens:
        total = sum(float(st[f"{case}/{when}/extra/0"]) for st in ranks)
        np.testing.assert_allclose(total, 4.0, rtol=1e-6, err_msg=when)
    if case == "gosgd-one":
        # rank 1 alone sends at p = 1: its α/2 comes back to it
        st = ranks[1]
        assert float(st["gosgd-one/x3post/extra/0"]) == \
            float(st["gosgd-one/x3pre/extra/0"])


@pytest.mark.parametrize("case", ["easgd-buck", "asgd-buck", "gosgd-buck"])
@pytest.mark.parametrize("world", [2, 4])
def test_bucketed_equals_monolithic_under_demotion(worlds, world, case):
    mono = case[:-len("-buck")]
    for r, st in enumerate(worlds[world]):
        keys = _keys(st, mono, "end")
        assert keys == _keys(st, case, "end")
        for k in keys:
            got, want = st[f"{case}/end/{k}"], st[f"{mono}/end/{k}"]
            if world == 2 or mono not in SUMMING:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_allclose(got, want, err_msg=f"rank {r} {k}",
                                           **SUM_TOL)


@pytest.mark.parametrize("case,twin", [("easgd-fused", "easgd"),
                                       ("gosgd-fused", "gosgd"),
                                       ("easgd-us", "easgd")])
def test_fused_and_sharded_demotion_equal_the_plain_run(worlds, case, twin):
    """The fused cadence, whose demotion ``MeshReactor`` applies by
    rebuilding the step, and ``update_sharding``'s gathered center: the
    params, the velocity and the rule's state bit for bit the unfused,
    unsharded run's (a state initialised again would start over)."""
    kinds = ("params/", "opt/", "center/") if case.endswith("-us") else \
        ("params/", "opt/", "extra/", "center/")
    for r, st in enumerate(worlds[4]):
        keys = _keys(st, twin, "end", kinds)
        assert keys and keys == _keys(st, case, "end", kinds)
        for k in keys:
            np.testing.assert_array_equal(st[f"{case}/end/{k}"],
                                          st[f"{twin}/end/{k}"],
                                          err_msg=f"rank {r} {k}")


def test_numerics_beacon_bit_equal_while_a_rank_is_demoted(worlds):
    ranks = worlds[4]
    rows = ranks[0]["easgd/beacon"]
    assert rows.shape == (4, 2) and (rows[:, 1] == 1.0).all()
    assert (rows[:, 0] == rows[0, 0]).all()
    for st in ranks[1:]:
        np.testing.assert_array_equal(st["easgd/beacon"], rows)


# -- GoSGD's tables and routes over an active set ---------------------------

def _prepared(cls, rank=0, size=4, **cfg):
    ex = cls(cfg)
    model = helper.TinyLRNNet({"device": "cpu", "verbose": False})
    model.rank = rank
    ex.prepare(model, size)
    return ex


@pytest.mark.parametrize("active", [(0, 1, 3), (0, 2), (1,)])
@pytest.mark.parametrize("peers", ["perm", "iid"])
def test_gosgd_tables_over_the_active_set_bit_equal_to_jax(peers, active):
    ex = _prepared(TEX.GOSGD_Exchanger, gosgd_peers=peers, gosgd_seed=3)
    ex.set_active_ranks(active)
    m = len(active)
    sub = JT.derangements(m, 16, seed=0x605 + 3) if peers == "perm" else \
        JT.iid_maps(m, 16, seed=0x1d1 + 3)
    want = JT.embed_active(sub, list(active), 4)
    np.testing.assert_array_equal(ex._tables, want)
    for d in set(range(4)) - set(active):
        assert (ex._tables[:, d] == d).all()       # a fixed point
    ex.set_active_ranks(None)
    np.testing.assert_array_equal(
        ex._tables, JT.derangements(4, 16, seed=0x605 + 3)
        if peers == "perm" else JT.iid_maps(4, 16, seed=0x1d1 + 3))


@pytest.mark.parametrize("active", [(0, 1, 3), (1, 2), (2,)])
def test_gosgd_shift_routes_on_the_active_sub_ring(active):
    ex = _prepared(TEX.GOSGD_Exchanger, gosgd_peers="shift")
    ex.set_active_ranks(active)
    m, shifts = len(active), set()
    for count in range(40):
        (pairs,) = ex.rounds(count)
        assert sorted(s for s, _ in pairs) == list(active)
        assert sorted(d for _, d in pairs) == list(active)
        s = {(active.index(d) - active.index(a)) % m for a, d in pairs}
        assert len(s) == 1
        shifts |= s
    assert shifts == (set(range(1, m)) if m > 1 else {0})


@pytest.mark.parametrize("peers", ["perm", "iid", "shift"])
def test_a_fixed_point_is_delivered_locally(peers):
    """No process group exists here, so any send or receive would raise:
    the one active rank gets its own buffer back, a demoted rank of the
    table-routed modes its own (zero) message, and under ``shift`` a
    demoted rank, on no pair, zeros."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    buf = torch.arange(5, dtype=torch.float32)
    one = _prepared(TEX.GOSGD_Exchanger, rank=1, gosgd_peers=peers)
    one.set_active_ranks([1])
    for count in range(3):
        got = one._route([buf], count)[0]
        np.testing.assert_array_equal(got.numpy(), buf.numpy())
        assert got.data_ptr() != buf.data_ptr()
    out = _prepared(TEX.GOSGD_Exchanger, rank=2, gosgd_peers=peers)
    out.set_active_ranks([1])
    want = np.zeros(5, np.float32) if peers == "shift" else buf.numpy()
    np.testing.assert_array_equal(out._route([buf], 0)[0].numpy(), want)


# -- refusals and the reactor -------------------------------------------------

def test_membership_refusals():
    bsp = _prepared(TEX.BSP_Exchanger)
    assert not bsp.supports_elastic()
    with pytest.raises(NotImplementedError, match="launcher --supervise"):
        bsp.set_active_ranks([0, 1])
    with pytest.raises(RuntimeError, match="before prepare"):
        TEX.EASGD_Exchanger({}).set_active_ranks([0])
    ex = _prepared(TEX.EASGD_Exchanger)
    assert ex.supports_elastic()
    with pytest.raises(ValueError, match="at least one rank"):
        ex.set_active_ranks([])
    with pytest.raises(ValueError, match="outside the 4-rank world"):
        ex.set_active_ranks([0, 4])
    ex.set_active_ranks([3, 1, 1])
    assert ex.active_key() == (1, 3)
    np.testing.assert_array_equal(ex.active_mask(), [0, 1, 0, 1])
    ex.set_active_ranks(range(4))              # the full set: no mask
    assert ex.active_key() is None


def test_mesh_reactor_drives_the_exchanger_and_rebuilds_a_fused_step():
    calls, rebuilt = [], []

    class Stub:
        size, fused = 4, False

        def set_active_ranks(self, active):
            calls.append(tuple(active))

    class Model:
        def rebuild_steps(self):
            rebuilt.append(1)

        def compile_iter_fns(self, *a, **k):
            raise AssertionError("compile_iter_fns initialises the state")

    ex = Stub()
    ctl = mb.MembershipController(reactors=[mb.MeshReactor(ex, Model())])
    for w in range(4):
        ctl.join(w)
    calls.clear()
    ctl.demote(3)
    assert calls[-1] == (0, 1, 2) and not rebuilt
    ex.fused = True
    ctl.readmit(3)
    assert calls[-1] == (0, 1, 2, 3) and rebuilt == [1]
    ctl.leave(1)
    assert calls[-1] == (0, 2, 3) and rebuilt == [1, 1]
    bare = mb.MembershipController(reactors=[mb.MeshReactor(ex)])
    with pytest.raises(AssertionError, match="needs the model"):
        bare.join(0)
