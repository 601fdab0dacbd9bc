"""Pipeline parallelism of the port (``parallel/pipeline.py`` over the
``pipe`` group of ``base.Grid``) against the JAX package's
(``theanompi_tpu/parallel/pipeline.py``) and the dense model.

The schedule tables are held array for array against the JAX
``build_schedule`` (the cases of ``tests/test_pipeline_schedule.py``).
One world of 4 gloo ranks, dp = 2 × pp = 2 (``torch_mp_helper``'s ``pp``
mode, every phase a session of its own), from the JAX dense model's
initial weights at 4 layers; the JAX package runs dp 2 × pp 2 on the
8-device CPU mesh meanwhile.  Tolerances are ``tests/test_pipeline.py``'s:
costs rtol 2e-4, atol 2e-5 (microbatched sums add in another order); params
after the Adam steps ``tests/test_tp.py``'s rtol 5e-3, atol 1e-5.  The
interleaved schedule (``pp_interleave`` 2) walks each chunk's microbatches
in the fill/drain order, so it is held bit for bit, as the JAX test holds
it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import pipeline as jpl

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import pipeline as pl
from torch_mp_jax import (KEPT, dense_tokens, host, jax_lm, jax_train,
                          jax_val, part, port_tree)

COST_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
DP, PP, N_LAYER = 2, 2, 4
PROMPT = [[3, 4, 5], [10, 11, 12]]
CLIP = 0.05
# (pp, v, m): tests/test_pipeline_schedule.py's grid
GRID = [(2, 1, 3), (4, 1, 8), (2, 2, 4), (4, 2, 8), (4, 4, 8), (3, 2, 6),
        (3, 3, 6), (2, 4, 2)]


# -- the schedule, against the JAX package's --------------------------------

@pytest.mark.parametrize("pp,v,m", GRID + [(1, 1, 4), (2, 1, 4)])
def test_schedule_matches_jax(pp, v, m):
    mine, want = pl.build_schedule(pp, v, m), jpl.build_schedule(pp, v, m)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(mine, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("n_layer,pp,v", [(8, 4, 1), (8, 4, 2), (12, 2, 3),
                                          (16, 4, 2), (24, 3, 4)])
def test_stage_permutation_matches_jax(n_layer, pp, v):
    np.testing.assert_array_equal(pl.stage_permutation(n_layer, pp, v),
                                  jpl.stage_permutation(n_layer, pp, v))


@pytest.mark.parametrize("call,knob", [
    (lambda m: m.build_schedule(4, 2, 6), "pp_microbatches"),
    (lambda m: m.stage_permutation(8, 4, 3), "pp_interleave"),
    (lambda m: m._validate(4, 1, 2, 4), "pp_microbatches"),
    (lambda m: m._validate(4, 2, 6, 2), "pp_microbatches"),
    (lambda m: m._validate(4, 2, 8, 3), "pp_interleave")])
def test_schedule_errors_name_the_knob_as_jax(call, knob):
    """Each degenerate schedule raises the JAX package's message."""
    with pytest.raises(ValueError, match=knob) as mine:
        call(pl)
    with pytest.raises(ValueError) as want:
        call(jpl)
    assert str(mine.value) == str(want.value)


@pytest.mark.parametrize("with_aux", [False, True])
def test_one_stage_pipeline_matches_sequential(with_aux):
    """``pipeline_apply`` with no group (one stage) computes the stack's
    forward, its aux and their gradients as a plain loop does
    (``tests/test_pipeline.py::test_pipeline_apply_matches_sequential``'s
    check; its bounds: cost rel 1e-5, grads rtol 1e-4, atol 1e-6)."""
    r = np.random.RandomState(0)
    n, m, mb, d = 4, 4, 2, 16
    stack = torch.tensor(0.3 * r.randn(n, d, d), dtype=torch.float32)
    x = torch.tensor(r.randn(m * mb, d), dtype=torch.float32)

    def stage(rows, h):
        aux = None
        for w in rows[0]:
            h = torch.tanh(h @ w)
            a = (h ** 2).mean()
            aux = a if aux is None else aux + a
        return (h, aux) if with_aux else h

    def loss(fn):
        s, xx = stack.clone().requires_grad_(True), \
            x.clone().requires_grad_(True)
        out = fn(s, xx)
        y, aux = out if with_aux else (out, torch.zeros(()))
        cost = (y ** 2).sum() + aux
        cost.backward()
        return float(cost.detach()), s.grad, xx.grad

    def piped(s, xx):
        out = pl.pipeline_apply(stage, [s], pl.microbatch(xx, m),
                                with_aux=with_aux)
        if with_aux:
            return pl.unmicrobatch(out[0]), out[1]
        return pl.unmicrobatch(out)

    def plain(s, xx):
        if not with_aux:
            return stage([s], xx)
        ys, aux = [], 0.0
        for xm in pl.microbatch(xx, m):
            y, a = stage([s], xm)
            ys.append(y)
            aux = aux + a
        return torch.cat(ys), aux

    (c1, gs1, gx1), (c2, gs2, gx2) = loss(piped), loss(plain)
    assert c1 == pytest.approx(c2, rel=1e-5)
    np.testing.assert_allclose(gs1, gs2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gx1, gx2, rtol=1e-4, atol=1e-6)


# -- the dp 2 × pp 2 world against the JAX package ---------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    dense = jax_lm(DP, n_layer=N_LAYER)
    init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, dense.params), KEPT), str(tmp / "init.npz"))
    # a JAX pp checkpoint after 3 steps, before the port world reads it
    jpp = jax_lm(DP, pp=PP, n_layer=N_LAYER)
    jpp_costs = jax_train(jpp, 3)
    jckpt = str(tmp / "jax_ckpt")
    jpp.save(jckpt, epoch=0, count=3)
    out = {"jax_saved": port_tree(host(jpp.step_state["params"])),
           "jax_saved_m": port_tree(host(jpp.step_state["opt_state"]["m"]))}
    # and one of the onebit wire, its error feedback per pipe rank
    jm = jax_lm(DP, pp=PP, n_layer=N_LAYER, exch_strategy="onebit")
    onebit_costs = jax_train(jm, 3)
    jckpt_onebit = str(tmp / "jax_ckpt_onebit")
    jm.save(jckpt_onebit, epoch=0, count=3)
    ck = str(tmp / "ckpt")
    phases = {
        "bsp": dict(init=True, step2=True, val=True, gen=True),
        "v2": dict(init=True, cfg=dict(pp_interleave=2)),
        "dense": dict(world=DP, cfg=dict(pp=1), val=True),
        "subb": dict(steps=4, cfg=dict(n_subb=2)),
        "spc": dict(steps=2, spc=2, cfg=dict(steps_per_call=2)),
        "clip": dict(steps=4, cfg=dict(grad_clip=CLIP)),
        "onebit": dict(steps=8, ef=True, save=os.path.join(ck, "onebit"),
                       cfg=dict(exch_strategy="onebit")),
        "onebit_load": dict(load=os.path.join(ck, "onebit"), at=8, ef=True,
                            cfg=dict(exch_strategy="onebit")),
        "save": dict(steps=3, save=os.path.join(ck, "bsp")),
        "load": dict(load=os.path.join(ck, "bsp"), at=3, steps=3),
        "v2save": dict(steps=3, save=os.path.join(ck, "v2"),
                       cfg=dict(pp_interleave=2)),
        "v2load": dict(load=os.path.join(ck, "v2"), at=3, steps=3,
                       cfg=dict(pp_interleave=2)),
        "jaxload": dict(jax_load=jckpt, at=3, steps=3),
        "jaxload_onebit": dict(jax_load=jckpt_onebit, at=3, steps=3,
                               ef=True, cfg=dict(exch_strategy="onebit")),
    }
    spawned = mh.spawn("pp", DP * PP, tmp, "pp", dict(
        init_npz=init, prompt=PROMPT, phases=phases,
        cfg=dict(n_layer=N_LAYER, n_workers=DP, pp=PP)))
    # the JAX side while the ranks run
    for i in range(3, 6):
        jpp.train_iter(i, None)
        jpp_costs.append(float(jpp.current_info["cost"]))
    out["jpp_costs"] = jpp_costs
    out["jpp"] = port_tree(host(jpp.step_state["params"]))
    jpp.data.shuffle_data(0)
    out["jpp_val"] = jax_val(jpp)
    out["subb_costs"] = jax_train(jax_lm(DP, pp=PP, n_layer=N_LAYER,
                                         n_subb=2), 4)
    out["clip_costs"] = jax_train(jax_lm(DP, pp=PP, n_layer=N_LAYER,
                                         grad_clip=CLIP), 4)
    for i in range(3, 8):
        jm.train_iter(i, None)
        onebit_costs.append(float(jm.current_info["cost"]))
    out["onebit_costs"] = onebit_costs
    out["onebit"] = port_tree(host(jm.step_state["params"]))
    out["init"] = port_tree(dense.params)
    out["ranks"] = mh.collect(spawned)
    out["ckpt"], out["jckpt"] = ck, jckpt
    return out


def test_pp_init_identical_to_dense(run):
    """Every rank's gathered initial params, unstacked, are the dense
    model's bit for bit at v = 1 and v = 2; each rank holds its pipe
    coordinate's rows of the stack (rows in stage order)."""
    for res in run["ranks"]:
        for tag in ("bsp_init", "v2_init"):
            got = part(res, tag)
            assert set(got) == set(run["init"])
            for k, v in run["init"].items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        _, p, _, _ = res["bsp_coord"]
        c = N_LAYER // PP
        shard = part(res, "bsp_shard")
        full = part(res, "bsp")        # the global stack, after training
        for k, v in shard.items():
            if k.startswith("blocks/"):
                assert v.shape[0] == c and full[k].shape[0] == N_LAYER
            else:
                assert v.shape == full[k].shape


def test_pp_bsp_training_matches_jax_and_dense(run):
    """6 BSP steps at dp 2 × pp 2: the JAX pp run's costs and params (the
    stacked tree, port layout), and the port's dense dp 2 run's costs and
    params."""
    dense = run["ranks"][0]
    for res in run["ranks"]:
        np.testing.assert_allclose(res["bsp_costs"], run["jpp_costs"],
                                   **COST_TOL)
        np.testing.assert_allclose(res["bsp_costs"], dense["dense_costs"],
                                   **COST_TOL)
        got = part(res, "bsp")
        assert set(got) == set(run["jpp"])
        for k, v in run["jpp"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
        got = part(res, "bsp_dense")
        for k, v in part(dense, "dense_dense").items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)


def test_pp_ranks_hold_one_model(run):
    """Every rank computes the same costs and ends with the same global
    params (pipe ranks: the replicated leaves' gradients are the dense
    ones on each; workers: BSP)."""
    first = run["ranks"][0]
    for res in run["ranks"][1:]:
        for name in ("bsp", "onebit", "clip"):
            np.testing.assert_array_equal(res[f"{name}_costs"],
                                          first[f"{name}_costs"])
            for k, v in part(first, name).items():
                np.testing.assert_array_equal(res[f"{name}/{k}"], v,
                                              err_msg=k)


def test_pp_interleaved_matches_fill_drain_exactly(run):
    """pp_interleave = 2 trains bit for bit as v = 1: the same costs and,
    unstacked, the same params (``tests/test_pipeline.py:195-208``)."""
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["v2_costs"], res["bsp_costs"])
        for k, v in part(res, "bsp_dense").items():
            np.testing.assert_array_equal(res["v2_dense/" + k], v, err_msg=k)


def test_pp_val_matches_jax_and_dense(run):
    """Validation after the 6 steps scores what the JAX pp run and the
    port's dense run score (cost within 1e-4, errors exactly)."""
    dense = run["ranks"][0]["dense_val"]
    for res in run["ranks"]:
        cost, err, err5 = res["bsp_val"]
        for dc, de, de5 in (run["jpp_val"], dense):
            assert abs(cost - dc) < 1e-4
            assert err == pytest.approx(de, abs=1e-6)
            assert err5 == pytest.approx(de5, abs=1e-6)


def test_pp_with_grad_accumulation_and_multi_step_dispatch(run):
    """n_subb = 2 traces the JAX pp run at n_subb 2; steps_per_call = 2
    ends where two single steps end (rtol 1e-5, atol 1e-5)."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["subb_costs"], run["subb_costs"],
                                   **COST_TOL)
        spc, two = part(res, "spc_dense"), part(res, "bsp_step2")
        for k, v in two.items():
            np.testing.assert_allclose(spc[k], v, rtol=1e-5, atol=1e-5)


def test_pp_grad_clip_matches_jax(run):
    """grad_clip on the pp layout (a stage's leaves' squares summed over
    the pipe group, the replicated ones counted once) traces the JAX pp
    run's costs, and clips: the costs leave the unclipped run's."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["clip_costs"], run["clip_costs"],
                                   **COST_TOL)
        assert abs(res["clip_costs"][-1] - res["bsp_costs"][3]) > 1e-3


def test_pp_onebit_matches_jax(run):
    """The onebit wire on the pp layout: each pipe rank compresses its own
    stage's leaves with the replicated ones, whose decoded means are then
    averaged over the pipe group; 8 steps trace the JAX pp run's costs and
    land on its params."""
    for res in run["ranks"]:
        c = res["onebit_costs"]
        np.testing.assert_allclose(c, run["onebit_costs"], **COST_TOL)
        assert np.mean(c[-3:]) < np.mean(c[:3])
        got = part(res, "onebit")
        for k, v in run["onebit"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
    ranks = run["ranks"]          # the pipe ranks' error feedback differs
    assert not np.array_equal(ranks[0]["onebit_ef"], ranks[1]["onebit_ef"])


def test_pp_checkpoint_resumes_bit_for_bit(run):
    """Save after 3 steps, load in a new session: params, Adam moments
    (and onebit's error feedback) bit for bit, and the next 3 steps cost
    what steps 4-6 of the unbroken run cost, bit for bit; at v = 1 and
    v = 2."""
    for res in run["ranks"]:
        for save, load in (("save", "load"), ("v2save", "v2load")):
            assert int(res[f"{load}_epoch"]) == 0
            for sfx in ("", "_m"):
                for k, v in part(res, save + sfx).items():
                    np.testing.assert_array_equal(
                        res[f"{load}_loaded{sfx}/{k}"], v, err_msg=k)
            np.testing.assert_array_equal(res[f"{load}_costs"],
                                          res["bsp_costs"][3:])
        np.testing.assert_array_equal(res["onebit_load_loaded_ef"],
                                      res["onebit_ef"])
        for k, v in part(res, "onebit").items():
            np.testing.assert_array_equal(res[f"onebit_load_loaded/{k}"], v)


def test_pp_checkpoint_holds_the_jax_pp_tree(run):
    """The pp checkpoint is one file of global arrays in the JAX package's
    pp tree: the stacked ``blocks`` leaves and the replicated ones, the
    same paths and shapes as the JAX pp checkpoint's (converted), within
    the params bound of it after the same 3 steps."""
    saved = part(run["ranks"][0], "save")
    with np.load(os.path.join(run["ckpt"], "bsp", "ckpt_epoch0.npz")) as z:
        got = [z[f"params__{i}"] for i in range(len(saved))]
        assert f"params__{len(saved)}" not in z.files
    assert set(saved) == set(run["jax_saved"])
    for (k, v), a in zip(saved.items(), got):
        np.testing.assert_array_equal(a, v, err_msg=k)
        np.testing.assert_allclose(a, run["jax_saved"][k], err_msg=k,
                                   **PARAM_TOL)
    assert not [d for d in os.listdir(os.path.join(run["ckpt"], "bsp"))
                if d.startswith(("pipe", "model"))]


def test_pp_loads_a_jax_pp_checkpoint(run):
    """A JAX pp = 2 checkpoint loads through ``convert.checkpoint_from_jax``
    into the port's pp layout: every rank's stage holds the JAX params and
    Adam moments bit for bit, and 3 more steps trace the JAX run's."""
    for res in run["ranks"]:
        assert int(res["jaxload_epoch"]) == 0
        for sfx in ("", "_m"):
            got = part(res, "jaxload_loaded" + sfx)
            for k, v in run["jax_saved" + sfx].items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_allclose(res["jaxload_costs"],
                                   run["jpp_costs"][3:], **COST_TOL)


def test_pp_jax_checkpoint_with_wire_state_waits_with_a9d(run):
    """A JAX pp checkpoint with the onebit wire's state (each pipe rank's
    error feedback of its own stage, ``[pp·n]`` a worker) loads into the
    port's onebit pp model: the params bit for bit, each pipe rank's error
    feedback its own (the two stages' differ, none is zero), and 3 more
    steps trace the JAX run's."""
    ranks = run["ranks"]
    for res in ranks:
        assert int(res["jaxload_onebit_epoch"]) == 0
        np.testing.assert_allclose(res["jaxload_onebit_costs"],
                                   run["onebit_costs"][3:6], **COST_TOL)
        ef = res["jaxload_onebit_loaded_ef"]
        assert np.isfinite(ef).all() and np.abs(ef).max() > 0
    assert not np.array_equal(ranks[0]["jaxload_onebit_loaded_ef"],
                              ranks[1]["jaxload_onebit_loaded_ef"])


def test_pp_generate_matches_dense(run):
    """Greedy tokens sampled from the pp layout (gathered, unstacked, on
    the dense twin) are the dense model's from the same params, with and
    without the KV cache."""
    for res in run["ranks"]:
        want = dense_tokens(part(res, "bsp_dense"), PROMPT, n_layer=N_LAYER)
        np.testing.assert_array_equal(res["bsp_gen"], want)
        np.testing.assert_array_equal(res["bsp_gen_kv0"], want)


def test_pp_grid_coordinates(run):
    """World rank (w·pp + p)·tp·sp + …: the pipe coordinate inside the
    worker's."""
    coords = [tuple(res["bsp_coord"]) for res in run["ranks"]]
    assert coords == [(w, p, 0, 0) for w in range(DP) for p in range(PP)]


def test_launcher_spawns_a_pp_world(tmp_path):
    """``--n-workers 1`` with ``pp=2``: the launcher spawns two ranks, a
    stage each, whose workers train the LM an epoch."""
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "theanompi_tpu_torch.models.transformer_lm",
         "--modelclass", "TransformerLM", "--n-workers", "1", "device=cpu",
         "pp=2", "pp_interleave=2", "compute_dtype=float32", "seq_len=16",
         "vocab=32", "d_model=32", "n_head=4", "n_layer=4", "batch_size=4",
         "synthetic_train=16", "synthetic_val=8", "epochs=1", "printFreq=2"],
        cwd=repo, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([here, repo])))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert "training finished" in r.stdout
