"""Sequence parallelism of the port (``parallel/sp.py``, the ring of
``ops/ring_attention.py`` over ``base.Grid``'s seq group) against the JAX
package's (``tests/test_sp_lm.py``) and the dense model.

One spawn of 4 gloo ranks: sp = 2 × dp = 2 (training, validation, a
checkpoint, n_subb and steps_per_call, EASGD, the onebit wire, sampling),
then the same processes as tp = 2 × sp = 2 at dp = 1; the JAX package
runs the same grids and the dense model on the 8-device CPU mesh
meanwhile.  Tolerances are the JAX tests' own: costs rtol 2e-4, atol 2e-5
(3e-4, 3e-5 for the 3-D grid), params rtol 5e-3, atol 1e-5 (1e-4).
"""

import jax
import numpy as np
import pytest

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from torch_mp_jax import (KEPT, dense_tokens, host, jax_async, jax_lm,
                          jax_train, jax_val, part, port_ef, port_tree)

COST_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
COST_TOL_3D = dict(rtol=3e-4, atol=3e-5)
PARAM_TOL_3D = dict(rtol=5e-3, atol=1e-4)
SP, DP = 2, 2
PROMPT = [[7, 8, 9, 10]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    dense = jax_lm(DP)
    init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, dense.params), KEPT), str(tmp / "init.npz"))
    spawned = mh.spawn("mp", DP * SP, tmp, "sp", dict(
        grid=dict(n_workers=DP, sp=SP), init_npz=init, prompt=PROMPT,
        rules={"easgd": dict(sync_freq=2)}, strategies=("onebit",),
        ckpt_dir=str(tmp / "ckpt"),
        worlds={"tp2sp2": dict(n_workers=1, tp=2, sp=2)}))
    out = {"init": port_tree(dense.params)}
    out["dense_costs"] = jax_train(dense, 6)
    out["dense"] = port_tree(host(dense.step_state["params"]))
    dense.data.shuffle_data(0)
    out["dense_val"] = jax_val(dense)
    out["jsp_costs"] = jax_train(jax_lm(DP, sp=SP), 6)
    d1 = jax_lm(1)
    out["dense1_costs"] = jax_train(d1, 6)
    out["dense1"] = port_tree(host(d1.step_state["params"]))
    out["j3d_costs"] = jax_train(jax_lm(1, tp=2, sp=2), 6)
    out["subb_costs"] = jax_train(jax_lm(DP, n_subb=2), 4)
    # the seq ranks compress one summed gradient: sp's onebit wire and
    # EASGD are the dense dp = 2 runs'
    jm = jax_lm(DP, exch_strategy="onebit")
    out["j_onebit_costs"] = jax_train(jm, 8)
    out["j_onebit"] = port_tree(host(jm.step_state["params"]))
    out["j_onebit_ef"] = jax.device_get(jm.step_state["extra"]["strat"])
    out["jparams"] = jax.tree.map(np.asarray, jm.params)
    jm = jax_lm(DP, sync_freq=2)
    out["j_easgd_costs"] = jax_async(jm, "easgd", 4)
    jm.data.shuffle_data(0)
    out["j_easgd_val"] = jax_val(jm)
    out["ranks"] = mh.collect(spawned)
    return out


def test_sp_init_identical_to_dense(run):
    for res in run["ranks"]:
        got = part(res, "init")
        for k, v in run["init"].items():
            np.testing.assert_array_equal(got[k], v)
            np.testing.assert_array_equal(part(res, "shard")[k], v)


def test_sp_bsp_training_matches_jax_and_dense(run):
    for res in run["ranks"]:
        np.testing.assert_allclose(res["bsp_costs"], run["jsp_costs"],
                                   **COST_TOL)
        np.testing.assert_allclose(res["bsp_costs"], run["dense_costs"],
                                   **COST_TOL)
        got = part(res, "bsp")
        for k, v in run["dense"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)


def test_sp_ranks_hold_one_model(run):
    """The seq ranks' summed gradients are one gradient: every rank ends
    with the same bits."""
    first = run["ranks"][0]
    for res in run["ranks"][1:]:
        np.testing.assert_array_equal(res["bsp_costs"], first["bsp_costs"])
        for k, v in part(first, "bsp").items():
            np.testing.assert_array_equal(res["bsp/" + k], v)


def test_sp_val_matches_dense(run):
    for res in run["ranks"]:
        cost, err, err5 = res["val"]
        dc, de, de5 = run["dense_val"]
        assert abs(cost - dc) < 1e-4
        assert err == pytest.approx(de, abs=1e-6)
        assert err5 == pytest.approx(de5, abs=1e-6)


def test_sp_with_grad_accumulation_and_multi_step_dispatch(run):
    for res in run["ranks"]:
        np.testing.assert_allclose(res["subb_costs"], run["subb_costs"],
                                   **COST_TOL)
        spc, two = part(res, "spc"), part(res, "bsp_step2")
        for k, v in two.items():
            np.testing.assert_allclose(spc[k], v, rtol=1e-5, atol=1e-5)


def test_sp_with_compressed_wire(run):
    """The onebit wire under sp: the seq ranks compress the same summed
    gradient, so 8 steps trace the JAX dense dp = 2 onebit run's costs,
    land on its params and carry its error feedback; the cost falls and
    the ranks hold one model."""
    ranks = run["ranks"]
    for wr, res in enumerate(ranks):
        c = res["onebit_costs"]
        np.testing.assert_allclose(c, run["j_onebit_costs"], **COST_TOL)
        assert np.mean(c[-3:]) < np.mean(c[:3])
        got = part(res, "onebit")
        for k, v in run["j_onebit"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
        want = port_ef("onebit", run["j_onebit_ef"][wr // SP],
                       run["jparams"], mh.nest(part(res, "shard")))
        np.testing.assert_allclose(res["onebit_ef"], want, **PARAM_TOL)
    for res in ranks[1:]:
        for k, v in part(ranks[0], "onebit").items():
            np.testing.assert_array_equal(res["onebit/" + k], v)


def test_sp_with_async_rule_smoke(run):
    """EASGD (sync_freq 2) under sp: 4 steps and an exchange trace the JAX
    dense dp = 2 run's costs, and validation scores what it scores."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["easgd_costs"], run["j_easgd_costs"],
                                   **COST_TOL)
        cost, err, err5 = res["easgd_val"]
        jc, je, je5 = run["j_easgd_val"]
        assert abs(cost - jc) < 1e-4
        assert err == pytest.approx(je, abs=1e-6)
        assert err5 == pytest.approx(je5, abs=1e-6)


def test_sp_checkpoint_roundtrip(run):
    for res in run["ranks"]:
        assert int(res["loaded_epoch"]) == 0
        for sfx in ("", "_m"):
            saved = part(res, "saved" + sfx)
            for k, v in part(res, "loaded" + sfx).items():
                np.testing.assert_array_equal(v, saved[k])
        assert np.isfinite(res["resumed_cost"])


def test_sp_composes_with_tp_at_one_worker(run):
    """tp = 2 × sp = 2 at dp = 1 (heads and tokens both cut): the JAX 3-D
    run's and the dense dp = 1 run's costs, the dense params, and a
    checkpoint round trip."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["tp2sp2_costs"], run["j3d_costs"],
                                   **COST_TOL_3D)
        np.testing.assert_allclose(res["tp2sp2_costs"], run["dense1_costs"],
                                   **COST_TOL_3D)
        got = part(res, "tp2sp2")
        for k, v in run["dense1"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL_3D)
        assert np.isfinite(res["tp2sp2_val"]).all()
        # its checkpoint, loaded into a new session, holds the same bits
        loaded = part(res, "tp2sp2_loaded")
        assert set(loaded) == set(got)
        for k, v in loaded.items():
            np.testing.assert_array_equal(v, got[k])


@pytest.mark.parametrize("layout", ["sp", "tp2sp2"])
def test_generate_from_sequence_layouts_matches_dense(run, layout):
    """Greedy tokens from the sp and tp × sp layouts are the dense
    model's from the same gathered params."""
    for res in run["ranks"]:
        key = "bsp" if layout == "sp" else layout
        gen = res["gen"] if layout == "sp" else res[f"{layout}_gen"]
        np.testing.assert_array_equal(gen, dense_tokens(part(res, key),
                                                        PROMPT))
