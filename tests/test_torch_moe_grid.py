"""The MoE on a model-parallel grid: expert parallelism (``ep`` over the
``model`` group) and the sequence all-to-all (experts over ``seq``), the
layer and the MoE LM, against the JAX package.

One module fixture spawns one world of 4 gloo ranks (``torch_mp_helper``'s
``pp`` mode, every phase a session of its own) and, before it, the layer's
2 ranks (``moe_layer`` mode); the JAX package runs the same layouts on the
8-device CPU mesh meanwhile.

* the layer at ep 2 and at seq_shards 2, float32, top-1 and top-2, train
  and eval, drop-free and default capacity, against the JAX ``MoE`` under
  ``shard_map`` on 2 devices: y and aux rtol 1e-5 / atol 1e-6, the
  gradients of x and every leaf rtol 1e-4 / atol 1e-6
  (``test_torch_moe.py``'s layer tolerances);
* the MoE LM at dp 2 × tp 2, dp 2 × sp 2, sp 2 × tp 2 and pp 2 × tp 2
  (``moe_every`` 1) against the JAX runs of the same layouts from the same
  init: costs rtol 2e-4 / atol 2e-5 (``tests/test_moe.py``'s), 3e-4 /
  3e-5 where sp shards the tokens (``tests/test_sp_lm.py``'s);
* ep 2 against ep 1 (``tests/test_moe.py:85``), top-2 at ep 2, a resume
  bit for bit, greedy tokens against the dense model's, and a JAX MoE tp
  checkpoint continuing in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from theanompi_tpu.jax_compat import shard_map
from theanompi_tpu.models.transformer_lm import MoETransformerLM as JMoELM
from theanompi_tpu.parallel.moe import MoE as JMoE

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import MoETransformerLM
from torch_mp_jax import dense_tokens, jax_lm, jax_train, jax_val, part

COST_TOL = dict(rtol=2e-4, atol=2e-5)
SP_COST_TOL = dict(rtol=3e-4, atol=3e-5)
Y_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
D, E, N = 16, 4, 48
PROMPT = [[3, 4, 5], [10, 11, 12]]
MOE = dict(moe_every=1, moe_experts=4)
# drop-free capacity and no aux term: every layout is the dense MoE LM
FREE = dict(capacity_factor=4.0, moe_aux=0.0)
CASES = {f"{axis}_k{k}_{cap}_{'train' if train else 'eval'}":
         dict(axis=axis, top_k=k, cf=1.25 if cap == "cap" else 100.0,
              train=train)
         for axis in ("model", "seq") for k in (1, 2)
         for cap in ("cap", "free") for train in (True, False)}
# the model layouts over 4 ranks, each against the JAX run of its own
LAYOUTS = {"dptp": dict(n_workers=2, tp=2), "dpsp": dict(n_workers=2, sp=2),
           "sptp": dict(n_workers=1, sp=2, tp=2),
           "pptp": dict(n_workers=1, pp=2, tp=2)}


def _layer_inputs(path):
    r = np.random.RandomState(5)
    jp = jax.tree.map(np.asarray, JMoE(D, E, mlp_ratio=2).init(
        jax.random.key(3)))
    jp["wg"] = (r.randn(D, E) * 0.5).astype(np.float32)    # real routing
    jp["b1"] = (r.randn(E, 2 * D) * 0.1).astype(np.float32)
    jp["b2"] = (r.randn(E, D) * 0.1).astype(np.float32)
    x = r.randn(N, D).astype(np.float32)
    ct = r.randn(N, D).astype(np.float32)
    np.savez(path, x=x, ct=ct, **jp)
    return dict(jp, x=x, ct=ct)


def _jax_layer(inp, c):
    """The JAX layer under ``shard_map`` on 2 devices: y (global), aux,
    and the gradients of ``sum(y · ct) + aux`` for x and every leaf."""
    axis = c["axis"]
    mesh = Mesh(np.array(jax.devices()[:2]), (axis,))
    kw = dict(ep=2, axis="model") if axis == "model" else \
        dict(seq_shards=2, seq_axis="seq")
    layer = JMoE(D, E, mlp_ratio=2, top_k=c["top_k"],
                 capacity_factor=c["cf"], compute_dtype=jnp.float32, **kw)
    spec = layer.specs()
    xs = P() if axis == "model" else P("seq", None)

    def body(p, x):
        return layer.apply(p, x, train=c["train"])

    f = shard_map(body, mesh=mesh, in_specs=(spec, xs),
                  out_specs=(xs, P()))
    ct = jnp.asarray(inp["ct"])

    def loss(p, x):
        y, aux = f(p, x)
        return jnp.sum(y * ct) + aux, (y, aux)

    params = {k: jnp.asarray(inp[k]) for k in spec}
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(inp["x"]))
    return dict(y=np.asarray(y), aux=float(aux), gx=np.asarray(gx),
                **{f"g{k}": np.asarray(v) for k, v in gp.items()})


def _jax_moe(layout, **kw):
    """The JAX MoE LM of one layout of :data:`LAYOUTS` (``n_workers`` as
    its dp)."""
    cfg = dict(LAYOUTS[layout])
    return jax_lm(cfg.pop("n_workers"), cls=JMoELM, **cfg, **MOE, **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moegrid")
    inp = _layer_inputs(str(tmp / "layer.npz"))
    layer = mh.spawn("moe_layer", 2, tmp, "moelayer", dict(
        inputs=str(tmp / "layer.npz"), cases=CASES))
    jdense = jax_lm(2, cls=JMoELM, **MOE)
    kept = MoETransformerLM(dict(mh.LM_CFG, device="cpu", **MOE)) \
        .kept_layout_paths()
    init = mh.save_init(convert.params_from_jax(
        jax.tree.map(np.asarray, jdense.params), kept),
        str(tmp / "init.npz"))
    # JAX MoE tp and sp checkpoints after 2 steps, before the world reads
    # them
    jcks = {}
    for layout in ("dptp", "dpsp"):
        jm = _jax_moe(layout)
        jcks[layout] = (jm, jax_train(jm, 2), str(tmp / f"jax_{layout}"))
        jm.save(jcks[layout][2], epoch=0, count=2)
    ckpt = str(tmp / "ckpt")
    four = dict(moe=True, steps=4, val=True, gen=True)
    phases = {name: dict(four, init=name in ("dptp", "dpsp"), cfg=cfg)
              for name, cfg in LAYOUTS.items()}
    phases.update({
        "ep1": dict(moe=True, steps=4, world=2, cfg=dict(n_workers=2)),
        "top2": dict(moe=True, steps=4,
                     cfg=dict(LAYOUTS["dptp"], moe_topk=2)),
        "ppsp_free": dict(moe=True, steps=4, cfg=dict(
            n_workers=1, pp=2, sp=2, pp_microbatches=2, **FREE)),
        "dense_free": dict(moe=True, steps=4, world=1,
                           cfg=dict(n_workers=1, **FREE))})
    for layout in ("dptp", "dpsp"):
        phases.update({
            f"save_{layout}": dict(moe=True, steps=2, save=f"{ckpt}_{layout}",
                                   cfg=LAYOUTS[layout]),
            f"resume_{layout}": dict(moe=True, load=f"{ckpt}_{layout}", at=2,
                                     steps=2, cfg=LAYOUTS[layout]),
            f"jaxload_{layout}": dict(moe=True, jax_load=jcks[layout][2],
                                      at=2, steps=2, cfg=LAYOUTS[layout])})
    world = mh.spawn("pp", 4, tmp, "moegrid", dict(
        init_npz=init, prompt=PROMPT, phases=phases, cfg=MOE))
    out = {"layer": {t: _jax_layer(inp, c) for t, c in CASES.items()}}
    with np.load(init) as z:
        out["init"] = {k: z[k] for k in z.files}
    for name in LAYOUTS:
        jm = _jax_moe(name)
        out[f"{name}_costs"] = jax_train(jm, 4)
        jm.data.shuffle_data(0)
        out[f"{name}_val"] = jax_val(jm)
    out["top2_costs"] = jax_train(_jax_moe("dptp", moe_topk=2), 4)
    for layout, (jm, costs, _) in jcks.items():
        for i in range(2, 4):
            jm.train_iter(i, None)
            costs.append(float(jm.current_info["cost"]))
        out[f"jaxload_{layout}_costs"] = costs[2:]
    out["layer_ranks"] = mh.collect(layer)
    out["ranks"] = mh.collect(world)
    return out


@pytest.mark.parametrize("tag", sorted(CASES))
def test_moe_layer_matches_jax_on_two_ranks(run, tag):
    """Each rank's y (ep: the whole, seq: its block) and aux against the
    JAX layer's; the gradients: ep, the router and x whole on each rank
    and each rank's experts its slice; seq, each rank's x block, the
    router summed over the ranks (each holds its block's share), each
    owner's experts whole."""
    c, j = CASES[tag], run["layer"][tag]
    ranks = run["layer_ranks"]
    e, n = E // 2, N // 2
    for i, res in enumerate(ranks):
        rows = slice(None) if c["axis"] == "model" else \
            slice(i * n, (i + 1) * n)
        np.testing.assert_allclose(res[f"{tag}_y"], j["y"][rows], **Y_TOL)
        np.testing.assert_allclose(res[f"{tag}_aux"], j["aux"], **Y_TOL)
        np.testing.assert_allclose(res[f"{tag}_gx"], j["gx"][rows],
                                   **GRAD_TOL)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(res[f"{tag}_g{k}"],
                                       j[f"g{k}"][i * e:(i + 1) * e],
                                       err_msg=k, **GRAD_TOL)
    gwg = [res[f"{tag}_gwg"] for res in ranks]
    if c["axis"] == "model":
        for g in gwg:
            np.testing.assert_allclose(g, j["gwg"], **GRAD_TOL)
    else:
        np.testing.assert_allclose(gwg[0] + gwg[1], j["gwg"], **GRAD_TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_lm_layout_matches_jax(run, layout):
    """4 Adam steps of the MoE LM (every block a MoE) on 4 gloo ranks trace
    the JAX run of the same layout from the same init (the aux inside the
    cost), and validation scores what the JAX run's scores."""
    tol = SP_COST_TOL if "sp" in LAYOUTS[layout] else COST_TOL
    for res in run["ranks"]:
        np.testing.assert_allclose(res[f"{layout}_costs"],
                                   run[f"{layout}_costs"], **tol)
        cost, err, err5 = res[f"{layout}_val"]
        jc, je, je5 = run[f"{layout}_val"]
        assert abs(cost - jc) < 1e-4
        assert err == pytest.approx(je, abs=1e-6)
        assert err5 == pytest.approx(je5, abs=1e-6)


@pytest.mark.parametrize("layout", ["dptp", "dpsp"])
def test_moe_lm_grid_init_and_expert_shards(run, layout):
    """The gathered initial params are the JAX dense model's bit for bit;
    at dp 2 × tp 2 (over the model group) and dp 2 × sp 2 (over the seq
    group) each rank holds half of every expert table, its experts, and
    the router whole; the two ranks of the group hold different ones."""
    ranks = run["ranks"]
    for res in ranks:
        for k, v in run["init"].items():
            np.testing.assert_array_equal(res[f"{layout}_init/{k}"], v,
                                          err_msg=k)
    shards = [part(res, f"{layout}_shard") for res in ranks[:2]]
    assert shards[0]["block0/moe/w1"].shape == (2, 32, 128)
    assert shards[0]["block0/moe/b2"].shape == (2, 32)
    assert shards[0]["block0/moe/wg"].shape == (32, 4)
    assert not np.array_equal(shards[0]["block0/moe/w1"],
                              shards[1]["block0/moe/w1"])
    np.testing.assert_array_equal(shards[0]["block0/moe/wg"],
                                  shards[1]["block0/moe/wg"])
    assert part(ranks[0], layout)["block0/moe/w1"].shape == (4, 32, 128)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_lm_grid_generate_matches_dense(run, layout):
    """Greedy tokens sampled from each layout (the expert tables gathered,
    on the dense twin), with and without the KV cache, are the dense MoE
    LM's from the same params."""
    for res in run["ranks"]:
        want = dense_tokens(part(res, f"{layout}_dense"), PROMPT,
                            cls=MoETransformerLM, **MOE)
        np.testing.assert_array_equal(res[f"{layout}_gen"], want)
        np.testing.assert_array_equal(res[f"{layout}_gen_kv0"], want)


def test_moe_ep2_matches_ep1(run):
    """ep 2 traces the ep 1 loss curve from the same init
    (``tests/test_moe.py:85``): routing is replicated, only the experts'
    placement and the sum's order differ."""
    ep1 = run["ranks"][0]["ep1_costs"]
    for res in run["ranks"]:
        np.testing.assert_allclose(res["dptp_costs"], ep1, **COST_TOL)


def test_moe_top2_at_ep2_matches_jax(run):
    for res in run["ranks"]:
        np.testing.assert_allclose(res["top2_costs"], run["top2_costs"],
                                   **COST_TOL)


@pytest.mark.parametrize("layout", ["dptp", "dpsp"])
def test_moe_grid_resumes_bit_for_bit(run, layout):
    """2 steps, a save (the global expert tables, gathered over the model
    or the seq group), a load in a new session and 2 more steps: the
    costs and the final params of the run without the break, bit for
    bit."""
    for res in run["ranks"]:
        np.testing.assert_array_equal(res[f"resume_{layout}_costs"],
                                      res[f"{layout}_costs"][2:])
        for k, v in part(res, layout).items():
            np.testing.assert_array_equal(res[f"resume_{layout}/{k}"], v,
                                          err_msg=k)


@pytest.mark.parametrize("layout", ["dptp", "dpsp"])
def test_jax_moe_tp_checkpoint_continues_in_port(run, layout):
    """A JAX MoE LM checkpoint at dp 2 × tp 2 or dp 2 × sp 2 (global
    expert tables) loads through ``convert.checkpoint_from_jax`` and 2
    more steps trace the JAX run's."""
    tol = SP_COST_TOL if "sp" in LAYOUTS[layout] else COST_TOL
    for res in run["ranks"]:
        assert int(res[f"jaxload_{layout}_epoch"]) == 0
        np.testing.assert_allclose(res[f"jaxload_{layout}_costs"],
                                   run[f"jaxload_{layout}_costs"], **tol)


def test_moe_pp_sp_matches_dense_when_drop_free(run):
    """pp 2 × sp 2 (every block a MoE, experts over seq inside each
    stage, 2 microbatches) with drop-free capacity and no aux term trains
    as the dense MoE LM: the costs within ``SP_COST_TOL`` (the JAX pp × sp
    program at dp 1 aborts in XLA's CPU all-reduce on this mesh, so the
    dense run is the oracle, as ``test_torch_pipeline_grid.py`` holds pp
    × sp)."""
    dense = run["ranks"][0]["dense_free_costs"]
    for res in run["ranks"]:
        np.testing.assert_allclose(res["ppsp_free_costs"], dense,
                                   **SP_COST_TOL)
