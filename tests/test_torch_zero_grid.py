"""ZeRO-1 on a model-parallel grid, and JAX grid checkpoints that carry a
wire's state or a ZeRO layout, against the JAX package.

One module fixture spawns one world of 4 gloo ranks (``torch_mp_helper``'s
``pp`` mode, every phase a session of its own) of the dense LM from the
JAX model's initial weights; the JAX package writes its checkpoints
before, and runs on past them meanwhile, on the 8-device CPU mesh.

* ``zero_opt`` at dp 2 × tp 2 (momentum and Adam, 5 steps) and at
  dp 2 × pp 2 (Adam, 4 steps) bit for bit the replicated optimizer on the
  same layout (``tests/test_zero.py:216, 249``);
* the chunk: each rank's state one ``ceil(local/dp)`` chunk of its own
  local flat layout, saved as the JAX package's boxed ``[dp, shards·chunk]``
  (``tests/test_zero.py:231``), and a resume bit for bit;
* EMA inside ZeRO at tp: the shadow bit for bit the plain EMA's
  (``tests/test_ema.py:145``);
* ``update_sharding`` and ``fsdp`` on a grid refused with the JAX
  package's reason;
* JAX dp 2 × tp 2 and dp 2 × pp 2 checkpoints with onebit, topk and
  PowerSGD state, and with a ZeRO layout, loading through
  ``convert.checkpoint_from_jax`` and continuing 2 steps within rtol 2e-4
  / atol 2e-5 of the JAX runs (``tests/test_tp.py``'s); at tp each rank's
  loaded wire state is the JAX rank's converted (rtol 5e-3 / atol 1e-5).
"""

import os

import jax
import numpy as np
import pytest

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from torch_mp_jax import (KEPT, jax_lm, jax_train, local_template, part,
                          port_ef)

COST_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
DP = 2
TPL = dict(n_workers=DP, tp=2)
PPL = dict(n_workers=DP, pp=2)
LAYOUTS = {"tp": TPL, "pp": PPL}
STRATEGIES = ("onebit", "topk", "powersgd1")


def _jax(layout, **kw):
    cfg = dict(LAYOUTS[layout])
    return jax_lm(cfg.pop("n_workers"), **cfg, **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zerogrid")
    dense = jax_lm(DP)
    init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, dense.params), KEPT), str(tmp / "init.npz"))
    # JAX grid checkpoints after 2 steps, before the world reads them
    jms, out = {}, {}
    for layout in LAYOUTS:
        for kind in STRATEGIES + ("zero",):
            kw = dict(zero_opt=True) if kind == "zero" else \
                dict(exch_strategy=kind)
            jm = _jax(layout, **kw)
            out[f"{layout}_{kind}_jcosts"] = jax_train(jm, 2)
            jm.save(str(tmp / f"j_{layout}_{kind}"), epoch=0, count=2)
            if layout == "tp" and kind != "zero":
                out[f"{layout}_{kind}_jef"] = jax.device_get(
                    jm.step_state["extra"]["strat"])
                out["jlocal"] = local_template(jm)
            jms[f"{layout}_{kind}"] = (jm, kw)
    ck = str(tmp / "ckpt")
    phases = {
        "tp_adam": dict(steps=5, cfg=TPL),
        "tp_adam_zero": dict(steps=5, init=True, save=ck,
                             cfg=dict(TPL, zero_opt=True)),
        "tp_adam_zero_resume": dict(load=ck, at=5, steps=1,
                                    cfg=dict(TPL, zero_opt=True)),
        "tp_adam_cont": dict(steps=6, cfg=TPL),
        "tp_mom": dict(steps=5, cfg=dict(TPL, optimizer="momentum")),
        "tp_mom_zero": dict(steps=5, cfg=dict(TPL, optimizer="momentum",
                                              zero_opt=True)),
        "pp_adam": dict(steps=4, cfg=PPL),
        "pp_adam_zero": dict(steps=4, cfg=dict(PPL, zero_opt=True)),
        "ema": dict(steps=4, canon=True, cfg=dict(TPL, ema_decay=0.9)),
        "ema_zero": dict(steps=4, canon=True,
                         cfg=dict(TPL, ema_decay=0.9, zero_opt=True)),
        "us": dict(refused=True, cfg=dict(TPL, update_sharding=True)),
        "fsdp": dict(refused=True, cfg=dict(PPL, fsdp=True)),
    }
    for name, (_, kw) in jms.items():
        layout, kind = name.split("_", 1)
        phases[f"j{name}"] = dict(
            jax_load=str(tmp / f"j_{name}"), at=2, steps=2, init=True,
            ef=kind != "zero", cfg=dict(LAYOUTS[layout], **kw))
    world = mh.spawn("pp", 4, tmp, "zerogrid", dict(
        init_npz=init, prompt=[[1, 2]], phases=phases))
    for name, (jm, _) in jms.items():
        costs = out.pop(f"{name}_jcosts")
        for i in range(2, 4):
            jm.train_iter(i, None)
            costs.append(float(jm.current_info["cost"]))
        out[f"j{name}_costs"] = costs[2:]
    out["ranks"] = mh.collect(world)
    out["ckpt"] = ck
    return out


def _same(res, a, b):
    np.testing.assert_array_equal(res[f"{a}_costs"], res[f"{b}_costs"])
    got = part(res, b)
    for k, v in part(res, a).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("base", ["tp_adam", "tp_mom", "pp_adam"])
def test_zero1_bit_equal_to_the_replicated_optimizer_on_the_grid(run, base):
    """dp 2 × tp 2 (Adam, momentum) and dp 2 × pp 2 (Adam): the ZeRO chunk
    of each rank's local shards trains bit for bit as the replicated
    optimizer on the same layout: costs and the global params; and the
    Adam moments, joined from the chunks, bit for bit the replicated
    ones."""
    for res in run["ranks"]:
        _same(res, base, base + "_zero")
        for k, v in part(res, base + "_m").items():
            np.testing.assert_array_equal(res[f"{base}_zero_m/{k}"], v,
                                          err_msg=k)


def test_zero1_state_is_a_chunk_of_the_local_shards(run):
    """Each rank's Adam moments are one ``ceil(local/dp)`` chunk of its own
    local flat layout (local: its tp shards), and the checkpoint holds
    them as the JAX package's boxed ``[dp, shards·chunk]``."""
    res = run["ranks"][0]
    local = sum(v.size for v in part(res, "tp_adam_zero_shard").values())
    chunk = -(-local // DP)
    assert set(res["tp_adam_zero_opt_sizes"]) == {chunk}
    with np.load(os.path.join(run["ckpt"], "ckpt_epoch0.npz")) as z:
        opt = [z[f] for f in z.files if f.startswith("opt_state__")]
    assert {a.shape for a in opt if a.ndim > 1} == {(DP, 2 * chunk)}


def test_zero1_on_the_grid_resumes_bit_for_bit(run):
    """5 steps, a save, a load in a new session and one more step: the
    cost and the params of 6 steps without the break, bit for bit."""
    for res in run["ranks"]:
        assert int(res["tp_adam_zero_resume_epoch"]) == 0
        for k, v in part(res, "tp_adam_zero").items():
            np.testing.assert_array_equal(
                res[f"tp_adam_zero_resume_loaded/{k}"], v, err_msg=k)
        np.testing.assert_array_equal(res["tp_adam_zero_resume_costs"],
                                      res["tp_adam_cont_costs"][5:])
        for k, v in part(res, "tp_adam_cont").items():
            np.testing.assert_array_equal(
                res[f"tp_adam_zero_resume/{k}"], v, err_msg=k)


def test_ema_inside_zero_at_tp_matches_plain_ema(run):
    """EMA × ZeRO × tp: the shadow of the chunks, gathered, is the plain tp
    EMA's bit for bit, and so are the params."""
    for res in run["ranks"]:
        _same(res, "ema", "ema_zero")
        for k, v in part(res, "ema_canon").items():
            np.testing.assert_array_equal(res[f"ema_zero_canon/{k}"], v,
                                          err_msg=k)


@pytest.mark.parametrize("key", ["us", "fsdp"])
def test_update_sharding_and_fsdp_refused_on_a_grid(run, key):
    """Only ``zero_opt`` composes with a grid in the JAX package:
    ``update_sharding`` and ``fsdp`` are refused there for pure
    data-parallel layouts only, and so here."""
    for res in run["ranks"]:
        msg = str(res[f"{key}_refused"])
        assert "data-parallel" in msg and "A9d" not in msg


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", STRATEGIES + ("zero",))
def test_jax_grid_checkpoint_with_state_continues(run, layout, kind):
    """A JAX checkpoint at dp 2 × tp 2 or dp 2 × pp 2 with the wire's state
    (each grid rank's own) or a ZeRO layout loads into the port's same
    layout, and 2 more steps trace the JAX run's; at tp each rank's loaded
    wire state is its JAX rank's block in the port's layout."""
    name = f"j{layout}_{kind}"
    ranks = run["ranks"]
    for wr, res in enumerate(ranks):
        assert int(res[f"{name}_epoch"]) == 0
        np.testing.assert_allclose(res[f"{name}_costs"],
                                   run[f"{name}_costs"], **COST_TOL)
        if kind == "zero":
            continue
        ef = res[f"{name}_loaded_ef"]
        assert np.isfinite(ef).all() and np.abs(ef).max() > 0
        if layout == "tp":
            w, m = divmod(wr, 2)
            jef = run[f"tp_{kind}_jef"]
            if kind == "powersgd1":
                block = jax.tree.map(lambda a: a[w, m], jef)
            else:
                n = jef.shape[1] // 2
                block = jef[w, m * n:(m + 1) * n]
            want = port_ef(kind, block, run["jlocal"],
                           mh.nest(part(res, f"{name}_shard")))
            np.testing.assert_allclose(ef, want, **PARAM_TOL)
