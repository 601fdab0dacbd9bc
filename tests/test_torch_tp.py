"""Tensor parallelism of the port (``parallel/tp.py`` over ``base.Grid``)
against the JAX package's (``theanompi_tpu/parallel/tp.py``) and the dense
model.

One world of 4 gloo ranks, tp = 2 × dp = 2 (``torch_mp_helper``, every
phase in one spawn), from the JAX dense model's initial weights; the JAX
package runs tp = 2 × dp = 2 and dense dp = 2 on the 8-device CPU mesh
meanwhile.  Tolerances are ``tests/test_tp.py``'s own: costs rtol 2e-4,
atol 2e-5 (the psums add in another order); params after 6 Adam steps
rtol 5e-3, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from theanompi_tpu.models import layers as JL

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import TransformerLM
from torch_mp_jax import (KEPT, dense_tokens, host, jax_async, jax_lm,
                          jax_train, jax_val, local_template, part,
                          port_ef, port_tree, powersgd_init_npz)

COST_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
TP, DP = 2, 2
PROMPT = [[3, 4, 5], [10, 11, 12]]
STRATEGIES = ("onebit", "topk", "powersgd1")
RULES = {"easgd": dict(sync_freq=2), "gosgd": dict(exch_prob=1.0)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    dense = jax_lm(DP)
    init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, dense.params), KEPT), str(tmp / "init.npz"))
    r = np.random.RandomState(0)
    np.savez(str(tmp / "head.npz"),
             logits=(r.randn(16, 32) * 3).astype(np.float32),
             labels=r.randint(0, 32, 16).astype(np.int32))
    # a JAX tp checkpoint after 3 steps, before the port world reads it
    jtp = jax_lm(DP, TP)
    jtp_costs = jax_train(jtp, 3)
    jckpt = str(tmp / "jax_ckpt")
    jtp.save(jckpt, epoch=0, count=3)
    jsaved = port_tree(host(jtp.step_state["params"]))
    jsaved_m = port_tree(host(jtp.step_state["opt_state"]["m"]))
    # PowerSGD's first q: the port draws other bits, so the ranks start
    # from the JAX run's
    jpsgd = jax_lm(DP, TP, exch_strategy="powersgd1")
    psgd_init = powersgd_init_npz(jpsgd, str(tmp / "psgd.npz"))
    spawned = mh.spawn("mp", DP * TP, tmp, "tp", dict(
        grid=dict(n_workers=DP, tp=TP), init_npz=init, prompt=PROMPT,
        head=str(tmp / "head.npz"), rules=RULES, strategies=STRATEGIES,
        strat_init={"powersgd1": psgd_init}, ckpt_dir=str(tmp / "ckpt"),
        cross_load={"sp2": dict(tp=1, sp=2)}, jax_ckpt=jckpt,
        worlds={name: dict(attn_impl=name[2:], seq_len=128, init_npz=None,
                           synthetic_train=32, synthetic_val=16)
                for name in ("tpflash", "tpreference")}))
    # the JAX side while the ranks run
    out = {"init": port_tree(dense.params), "jax_saved": jsaved,
           "jax_saved_m": jsaved_m}
    for i in range(3, 6):
        jtp.train_iter(i, None)
        jtp_costs.append(float(jtp.current_info["cost"]))
    out["jtp_costs"] = jtp_costs
    jtp.data.shuffle_data(0)
    out["jtp_val"] = jax_val(jtp)
    out["dense_costs"] = jax_train(dense, 6)
    out["dense"] = port_tree(host(dense.step_state["params"]))
    dense.data.shuffle_data(0)
    out["dense_val"] = jax_val(dense)
    out["subb_costs"] = jax_train(jax_lm(DP, n_subb=2), 4)
    for strat in STRATEGIES:
        # the compressed wires on the JAX tp layout, from the same init
        jm = jpsgd if strat == "powersgd1" else \
            jax_lm(DP, TP, exch_strategy=strat)
        out[f"j_{strat}_costs"] = jax_train(jm, 8)
        out[f"j_{strat}"] = port_tree(host(jm.step_state["params"]))
        out[f"j_{strat}_ef"] = jax.device_get(jm.step_state["extra"]["strat"])
    out["jlocal"] = local_template(jtp)      # one model rank's shapes
    for rule, kw in RULES.items():
        jm = jax_lm(DP, TP, **kw)
        out[f"j_{rule}_costs"] = jax_async(jm, rule, 4)
        jm.data.shuffle_data(0)
        out[f"j_{rule}_val"] = jax_val(jm)
    out["ranks"] = mh.collect(spawned)
    out["ckpt"] = str(tmp / "ckpt")
    return out


def test_tp_init_identical_to_dense(run):
    """Every rank's gathered initial params are the dense model's, and its
    own shard is its chunk of them along the layout's dim."""
    for wr, res in enumerate(run["ranks"]):
        init = part(res, "init")
        assert set(init) == set(run["init"])
        for k, v in run["init"].items():
            np.testing.assert_array_equal(init[k], v)
        m = wr % TP                             # world rank = w·tp + m
        for k, shard in part(res, "shard").items():
            full = run["init"][k]
            if shard.shape == full.shape:
                np.testing.assert_array_equal(shard, full)
                continue
            (d,) = [i for i, (a, b) in enumerate(zip(full.shape, shard.shape))
                    if a != b]
            assert full.shape[d] == TP * shard.shape[d]
            c = shard.shape[d]
            np.testing.assert_array_equal(
                shard, np.take(full, range(m * c, (m + 1) * c), axis=d))


def test_tp_bsp_training_matches_jax_and_dense(run):
    """6 BSP steps at tp 2 × dp 2: the costs of the JAX tp run and of the
    dense run, and the dense run's params (the JAX test's oracle for
    params: the JAX tp run's own params land up to 1.7e-3 from its dense
    run's on this mesh, the port's within 2.1e-5)."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["bsp_costs"], run["jtp_costs"],
                                   **COST_TOL)
        np.testing.assert_allclose(res["bsp_costs"], run["dense_costs"],
                                   **COST_TOL)
        got = part(res, "bsp")
        for k, v in run["dense"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)


def test_tp_ranks_hold_one_model(run):
    """Model ranks compute one loss; data-parallel ranks end with the same
    bits (BSP); so every rank's gathered params are equal."""
    first = run["ranks"][0]
    for res in run["ranks"][1:]:
        np.testing.assert_array_equal(res["bsp_costs"], first["bsp_costs"])
        for k, v in part(first, "bsp").items():
            np.testing.assert_array_equal(res["bsp/" + k], v)


def test_tp_val_matches_dense(run):
    """Validation after the 6 steps scores what the dense run's and the
    JAX tp run's score."""
    for res in run["ranks"]:
        cost, err, err5 = res["val"]
        for want in ("dense_val", "jtp_val"):
            dc, de, de5 = run[want]
            assert abs(cost - dc) < 1e-4, want
            assert err == pytest.approx(de, abs=1e-6), want
            assert err5 == pytest.approx(de5, abs=1e-6), want


def test_tp_loss_head_matches_dense_oracle(run):
    """The vocab-parallel CE, errors and the CE's gradient on logit shards
    against the dense heads (the JAX package's and the port's)."""
    import torch
    from theanompi_tpu_torch.models import layers as L
    r = np.random.RandomState(0)
    logits = (r.randn(16, 32) * 3).astype(np.float32)
    labels = r.randint(0, 32, 16).astype(np.int32)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    x = torch.from_numpy(logits).requires_grad_(True)
    y = torch.from_numpy(labels)
    dense = {}
    for tag, eps in (("head", 0.0), ("head_ls", 0.1)):
        x.grad = None
        c = L.softmax_cross_entropy(x, y, eps)
        c.backward()
        dense[tag] = (float(c), x.grad.numpy().copy())
        assert float(c) == pytest.approx(
            float(JL.softmax_cross_entropy(jl, jy, eps)), rel=1e-5)
    for wr, res in enumerate(run["ranks"]):
        m = wr % TP
        for tag in ("head", "head_ls"):
            assert float(res[f"{tag}_cost"]) == pytest.approx(dense[tag][0],
                                                              rel=1e-5)
            np.testing.assert_allclose(res[f"{tag}_grad"],
                                       dense[tag][1][:, m * 16:(m + 1) * 16],
                                       rtol=1e-5, atol=1e-7)
        assert float(res["head_err"]) == pytest.approx(
            float(JL.errors(jl, jy)))
        assert float(res["head_err5"]) == pytest.approx(
            float(JL.errors_top_x(jl, jy, 5)))


def test_tp_easgd_and_gosgd_smoke(run):
    """EASGD (sync_freq 2) and GoSGD (exch_prob 1) at tp 2 × dp 2: 4 steps
    and an exchange trace the JAX tp run's costs, and validation scores
    what the JAX run's scores."""
    for res in run["ranks"]:
        for rule in RULES:
            np.testing.assert_allclose(res[f"{rule}_costs"],
                                       run[f"j_{rule}_costs"], **COST_TOL)
            cost, err, err5 = res[f"{rule}_val"]
            jc, je, je5 = run[f"j_{rule}_val"]
            assert abs(cost - jc) < 1e-4, rule
            assert err == pytest.approx(je, abs=1e-6), rule
            assert err5 == pytest.approx(je5, abs=1e-6), rule


def test_tp_with_grad_accumulation_and_multi_step_dispatch(run):
    """n_subb = 2 traces the JAX dense run at n_subb 2; steps_per_call = 2
    ends where two single steps end."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["subb_costs"], run["subb_costs"],
                                   **COST_TOL)
        spc, two = part(res, "spc"), part(res, "bsp_step2")
        for k, v in two.items():
            np.testing.assert_allclose(spc[k], v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tp_compressed_strategies_train(run, strategy):
    """onebit, topk and PowerSGD compose with tp: 8 steps trace the JAX tp
    run's costs and land on its params, each model rank compresses its own
    shards (its error feedback differs from the other model rank's and is
    the JAX run's block of that rank), and the model
    ranks hold one model (the replicated leaves' decoded means averaged
    over the group)."""
    ranks = run["ranks"]
    jef = run[f"j_{strategy}_ef"]
    for wr, res in enumerate(ranks):
        c = res[f"{strategy}_costs"]
        np.testing.assert_allclose(c, run[f"j_{strategy}_costs"], **COST_TOL)
        assert np.mean(c[-3:]) < np.mean(c[:3])
        got = part(res, strategy)
        for k, v in run[f"j_{strategy}"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
        w, m = divmod(wr, TP)
        if strategy == "powersgd1":
            block = jax.tree.map(lambda a: a[w, m], jef)
        else:
            n = jef.shape[1] // TP
            block = jef[w, m * n:(m + 1) * n]
        want = port_ef(strategy, block, run["jlocal"],
                       mh.nest(part(res, "shard")))
        np.testing.assert_allclose(res[f"{strategy}_ef"], want, **PARAM_TOL)
    assert not np.array_equal(ranks[0][f"{strategy}_ef"],
                              ranks[1][f"{strategy}_ef"])
    for res in ranks[1:]:
        for k, v in part(ranks[0], strategy).items():
            np.testing.assert_array_equal(res[f"{strategy}/{k}"], v)


def test_tp_checkpoint_roundtrip(run):
    """Save after 3 steps, load into a new session: bit-identical params
    and Adam moments, and training continues."""
    for res in run["ranks"]:
        assert int(res["loaded_epoch"]) == 0
        for sfx in ("", "_m"):
            saved = part(res, "saved" + sfx)
            for k, v in part(res, "loaded" + sfx).items():
                np.testing.assert_array_equal(v, saved[k])
        assert np.isfinite(res["resumed_cost"])


def test_tp_checkpoint_holds_the_global_arrays(run):
    """The tp checkpoint is one of the dense layout: one file of the
    global params (the gathered ones, in the port's leaf order), no
    directory per model rank."""
    import os
    saved = part(run["ranks"][0], "saved")
    with np.load(os.path.join(run["ckpt"], "ckpt_epoch0.npz")) as z:
        got = [z[f"params__{i}"] for i in range(len(saved))]
        assert f"params__{len(saved)}" not in z.files
    for (k, v), a in zip(saved.items(), got):
        np.testing.assert_array_equal(a, v, err_msg=k)
    assert not [d for d in os.listdir(run["ckpt"]) if d.startswith("model")]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tp_checkpoint_carries_each_shards_wire_state(run, strategy):
    """A tp checkpoint under a compressed wire: each model rank resumes
    its own error feedback (and PowerSGD's q), and the params."""
    for res in run["ranks"]:
        np.testing.assert_array_equal(res[f"{strategy}_loaded_ef"],
                                      res[f"{strategy}_ef"])
        for k, v in part(res, strategy).items():
            np.testing.assert_array_equal(res[f"{strategy}_loaded/{k}"], v)


def test_tp_checkpoint_resumes_at_another_layout(run):
    """The tp = 2 × dp = 2 checkpoint resumes at sp = 2 × dp = 2: every
    rank holds the saved params and moments, and training goes on."""
    for res in run["ranks"]:
        assert int(res["sp2_epoch"]) == 0
        for sfx in ("", "_m"):
            saved = part(res, "saved" + sfx)
            for k, v in part(res, "sp2" + sfx).items():
                np.testing.assert_array_equal(v, saved[k], err_msg=k)
        assert np.isfinite(res["sp2_cost"])


def test_tp_loads_a_jax_tp_checkpoint(run):
    """A JAX tp = 2 checkpoint (global arrays) loads into the port's tp
    layout: every rank's shards are the JAX params and Adam moments."""
    for res in run["ranks"]:
        assert int(res["jax_epoch"]) == 0
        for sfx in ("", "_m"):
            got = part(res, "jax_loaded" + sfx)
            for k, v in run["jax_saved" + sfx].items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert np.isfinite(res["jax_resumed_cost"])


def test_tp_generate_matches_dense(run):
    """Greedy tokens sampled from the tp layout are the dense model's from
    the same (gathered) params, with and without the KV cache."""
    for res in run["ranks"]:
        want = dense_tokens(part(res, "bsp"), PROMPT)
        np.testing.assert_array_equal(res["gen"], want)
        np.testing.assert_array_equal(res["gen_kv0"], want)


# -- the grid, the launcher and what stays refused ---------------------------

def test_grid_coordinates_follow_the_jax_mesh_order():
    """World rank (w·tp + m)·sp + s: workers outermost, seq innermost
    (``theanompi_tpu/parallel/mesh.py:98-102``)."""
    from theanompi_tpu_torch.base import Grid
    coords = [(g.worker, g.model, g.seq)
              for g in (Grid(3, 2, 2, r) for r in range(12))]
    assert coords == [(w, m, s) for w in range(3) for m in range(2)
                      for s in range(2)]
    with pytest.raises(ValueError, match="outside"):
        Grid(2, 2, 1, 4)


def test_grid_coordinates_with_a_pipe_axis():
    """World rank ((w·pp + p)·tp + m)·sp + s: the pipe axis between the
    workers and the model axis (``theanompi_tpu/parallel/mesh.py:98-102``);
    ``lead`` is pipe 0, model 0, seq 0."""
    from theanompi_tpu_torch.base import Grid, model_parallel_degrees
    grids = [Grid(2, 2, 2, r, pp=3) for r in range(24)]
    assert [(g.worker, g.pipe, g.model, g.seq) for g in grids] == [
        (w, p, m, s) for w in range(2) for p in range(3) for m in range(2)
        for s in range(2)]
    assert [g.world_rank for g in grids if g.lead] == [0, 12]
    assert model_parallel_degrees({"pp": 3, "tp": 2}) == (2, 1, 3)
    with pytest.raises(ValueError, match="outside"):
        Grid(2, 1, 1, 4, pp=2)


@pytest.mark.parametrize("cfg,knob", [
    ({"pp": 4, "n_layer": 8, "pp_interleave": 3}, "pp_interleave"),
    ({"pp": 4, "n_layer": 8, "pp_interleave": 2, "pp_microbatches": 6},
     "pp_microbatches"),
    ({"pp": 1, "pp_interleave": 2}, "'pp'"),
    ({"pp": 1, "pp_microbatches": 4}, None)])
def test_pipeline_keys_are_checked_as_in_jax(cfg, knob):
    """The JAX package's build-time checks of the pipeline keys
    (``tests/test_pipeline.py:244-255``): n_layer % (pp·v), M % pp, v > 1
    at pp = 1, each naming its knob; and ``pp_microbatches`` at pp = 1
    accepted and ignored, as the JAX LM takes it."""
    if knob is None:
        m = TransformerLM(dict(mh.LM_CFG, device="cpu", **cfg))
        assert m.pp == 1 and m.param_specs() is None
        return
    with pytest.raises(ValueError, match=knob):
        TransformerLM(dict(mh.LM_CFG, device="cpu", **cfg))


def test_flash_under_sp_is_refused():
    """Sequence-sharded attention is the ring (the JAX package's check)."""
    with pytest.raises(ValueError, match="ring"):
        TransformerLM(dict(mh.LM_CFG, device="cpu", sp=2, seq_len=128,
                           attn_impl="flash"))


def test_launcher_spawns_a_tp_world(tmp_path):
    """``--n-workers 1`` with ``tp=2`` on the command line: the launcher
    spawns two ranks, whose workers build the tp LM and train an epoch."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "theanompi_tpu_torch.models.transformer_lm",
         "--modelclass", "TransformerLM", "--n-workers", "1", "device=cpu",
         "tp=2", "compute_dtype=float32", "seq_len=16", "vocab=32",
         "d_model=32", "n_head=4", "n_layer=2", "batch_size=4",
         "synthetic_train=16", "synthetic_val=8", "epochs=1", "printFreq=2"],
        cwd=repo, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([here, repo])))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert "training finished" in r.stdout


def test_tp_flash_attends_on_the_local_heads(run):
    """``attn_impl='flash'`` under tp (B10–B12 on each rank's heads; their
    plain versions on the CPU) trains as the reference attention does."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["tpflash_costs"],
                                   res["tpreference_costs"], **COST_TOL)
        np.testing.assert_array_equal(res["tpflash_gen"],
                                      res["tpreference_gen"])
