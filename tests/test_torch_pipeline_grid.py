"""Pipeline parallelism composed with the other grid axes, and the MoE LM
on a pipeline, against the JAX package.

One world of 4 gloo ranks (``torch_mp_helper``'s ``pp`` mode, every phase
a session of its own), from the JAX dense models' initial weights at 4
layers, d 32: pp 2 × tp 2 and pp 2 × sp 2 at dp 1
(``tests/test_3d_mesh.py:40``, ``tests/test_sp_lm.py:187``), and the MoE
LM at dp 2 × pp 2 with every block a MoE (``moe_every`` 1;
``tests/test_pipeline.py:226-241``, ``tests/test_moe.py:108``); the JAX
package runs the same layouts on the 8-device CPU mesh meanwhile.
Tolerances: costs rtol 2e-4, atol 2e-5 (``tests/test_pipeline.py``'s),
pp × sp rtol 3e-4, atol 3e-5 (``tests/test_sp_lm.py``'s for that
layout); params after the Adam steps rtol 5e-3, atol 1e-5
(``tests/test_tp.py``'s).
"""

import jax
import numpy as np
import pytest

from theanompi_tpu.models.transformer_lm import MoETransformerLM as JMoELM

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import MoETransformerLM
from torch_mp_jax import (KEPT, dense_tokens, host, jax_lm, jax_train,
                          jax_val, part, port_tree)

COST_TOL = dict(rtol=2e-4, atol=2e-5)
SP_COST_TOL = dict(rtol=3e-4, atol=3e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
N_LAYER = 4
PROMPT = [[3, 4, 5], [10, 11, 12]]
MOE = dict(moe_every=1, moe_experts=4)
# drop-free capacity and no aux term: the pipelined MoE is the dense one
FREE = dict(capacity_factor=4.0, moe_aux=0.0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppgrid")
    dense = jax_lm(1, n_layer=N_LAYER)
    init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, dense.params), KEPT), str(tmp / "init.npz"))
    moe_kept = MoETransformerLM(dict(
        mh.LM_CFG, device="cpu", n_layer=N_LAYER, **MOE)).kept_layout_paths()
    jmoe = jax_lm(2, n_layer=N_LAYER, cls=JMoELM, **MOE)
    moe_init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, jmoe.params), moe_kept),
        str(tmp / "moe_init.npz"))
    moe = dict(moe=True, steps=4, cfg=dict(n_workers=2, init_npz=moe_init,
                                           **MOE))
    phases = {
        "pptp": dict(init=True, val=True, gen=True, cfg=dict(tp=2)),
        "ppsp": dict(val=True, gen=True,
                     cfg=dict(sp=2, pp_microbatches=2)),
        "moe": moe,
        "moe_v2": dict(moe, cfg=dict(moe["cfg"], pp_interleave=2)),
        "moe_free": dict(moe, cfg=dict(moe["cfg"], **FREE)),
        "moe_free_dense": dict(moe, world=2,
                               cfg=dict(moe["cfg"], pp=1, **FREE)),
    }
    spawned = mh.spawn("pp", 4, tmp, "ppgrid", dict(
        init_npz=init, prompt=PROMPT, phases=phases,
        cfg=dict(n_layer=N_LAYER, n_workers=1, pp=2)))
    out = {"init": port_tree(dense.params)}
    jm = jax_lm(1, tp=2, pp=2, n_layer=N_LAYER)
    out["pptp_costs"] = jax_train(jm, 6)
    out["pptp"] = port_tree(host(jm.step_state["params"]))
    jm.data.shuffle_data(0)
    out["pptp_val"] = jax_val(jm)
    # pp × sp is held against the JAX dense run, the JAX test's own oracle
    # for that layout: the JAX pp × sp program at dp 1 aborts in XLA's CPU
    # all-reduce on this mesh
    out["dense_costs"] = jax_train(dense, 6)
    dense.data.shuffle_data(0)
    out["ppsp_val"] = jax_val(dense)
    out["moe_costs"] = jax_train(jax_lm(2, pp=2, n_layer=N_LAYER,
                                        cls=JMoELM, **MOE), 4)
    out["ranks"] = mh.collect(spawned)
    return out


def test_pp_tp_matches_jax(run):
    """dp 1 × pp 2 × tp 2: the gathered initial params are the dense
    model's bit for bit, and 6 BSP steps trace the JAX pp × tp run's costs
    and land on its params (the stacked tree, tp shards joined)."""
    for res in run["ranks"]:
        for k, v in run["init"].items():
            np.testing.assert_array_equal(res[f"pptp_init/{k}"], v,
                                          err_msg=k)
        np.testing.assert_allclose(res["pptp_costs"], run["pptp_costs"],
                                   **COST_TOL)
        got = part(res, "pptp")
        assert set(got) == set(run["pptp"])
        for k, v in run["pptp"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)


def test_pp_tp_shards_each_stage_over_the_model_group(run):
    """Each rank of pp 2 × tp 2 holds half of its stage's rows' split dims
    (world rank (p·tp + m)), and the four ranks end with one model."""
    coords = [tuple(res["pptp_coord"]) for res in run["ranks"]]
    assert coords == [(0, p, m, 0) for p in range(2) for m in range(2)]
    res = run["ranks"][0]
    shard, full = part(res, "pptp_shard"), part(res, "pptp")
    assert shard["blocks/fc1/w"].shape == (2, 32, 64)      # [L/pp, in, out/tp]
    assert full["blocks/fc1/w"].shape == (4, 32, 128)
    assert shard["blocks/attn/wo"].shape == (2, 16, 32)    # [L/pp, in/tp, out]
    assert shard["embed/w"].shape == (16, 32)              # vocab over model
    for other in run["ranks"][1:]:
        for k, v in part(res, "pptp").items():
            np.testing.assert_array_equal(other[f"pptp/{k}"], v, err_msg=k)


def test_pp_sp_matches_jax(run):
    """dp 1 × pp 2 × sp 2 with 2 microbatches (ring attention inside each
    stage): 6 steps trace the JAX dense run's costs, as the JAX package's
    pp × sp test holds its own (``tests/test_sp_lm.py:187``); pp × tp
    traces it too."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["ppsp_costs"], run["dense_costs"],
                                   **SP_COST_TOL)
        np.testing.assert_allclose(res["pptp_costs"], run["dense_costs"],
                                   **COST_TOL)


@pytest.mark.parametrize("layout", ["pptp", "ppsp"])
def test_pp_grid_val_and_generate(run, layout):
    """Validation scores what the JAX run of the layout scores (pp × sp:
    the JAX dense run's), and greedy tokens from the layout are the dense
    model's from its params."""
    for res in run["ranks"]:
        cost, err, err5 = res[f"{layout}_val"]
        jc, je, je5 = run[f"{layout}_val"]
        assert abs(cost - jc) < 1e-4
        assert err == pytest.approx(je, abs=1e-6)
        assert err5 == pytest.approx(je5, abs=1e-6)
        want = dense_tokens(part(res, f"{layout}_dense"), PROMPT,
                            n_layer=N_LAYER)
        np.testing.assert_array_equal(res[f"{layout}_gen"], want)
        np.testing.assert_array_equal(res[f"{layout}_gen_kv0"], want)


def test_moe_pp_matches_jax(run):
    """The MoE LM at dp 2 × pp 2 (every block a MoE, capacity per
    microbatch, the aux the mean of the microbatches'): 4 steps trace the
    JAX pp run's costs, main loss and aux together."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["moe_costs"], run["moe_costs"],
                                   **COST_TOL)


def test_moe_pp_interleaved_matches_fill_drain_exactly(run):
    """pp_interleave = 2 trains the MoE LM bit for bit as v = 1: costs and
    unstacked params (``tests/test_pipeline.py:226-241``)."""
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["moe_v2_costs"], res["moe_costs"])
        for k, v in part(res, "moe_dense").items():
            np.testing.assert_array_equal(res[f"moe_v2_dense/{k}"], v,
                                          err_msg=k)


def test_moe_pp_matches_dense_layout_when_drop_free(run):
    """With drop-free capacity and no aux term the pipelined MoE LM is the
    dense layout's: the same costs (``tests/test_moe.py:108``'s bound) and
    params."""
    dense = run["ranks"][0]
    for res in run["ranks"]:
        np.testing.assert_allclose(res["moe_free_costs"],
                                   dense["moe_free_dense_costs"], **COST_TOL)
        for k, v in part(dense, "moe_free_dense_dense").items():
            np.testing.assert_allclose(res[f"moe_free_dense/{k}"], v,
                                       err_msg=k, **PARAM_TOL)


def test_moe_pp_needs_a_homogeneous_stack():
    """A mixed MoE/dense stack does not stack over pipe (the JAX package's
    check, ``transformer_lm.py:680-684`` there)."""
    with pytest.raises(ValueError, match="moe_every"):
        MoETransformerLM(dict(mh.LM_CFG, device="cpu", n_layer=N_LAYER,
                              pp=2, moe_every=2))
