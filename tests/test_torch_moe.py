"""The port's mixture of experts (``parallel/moe.py``) and MoE LM against
the JAX package's, at one expert shard (``ep = 1``; the grids are
``test_torch_moe_grid.py``'s).

* the JAX package's ``tests/test_moe.py`` cases at ``ep = 1``: the uniform
  router against the scaled dense MLP (aux exactly 1), capacity dropping
  the overflow in training and none at inference, top-2 with identical
  experts equal to the dense MLP, top-2's priority dropping secondaries
  first, the LM converging and validating (top-1 and top-2), and a
  checkpoint round trip;
* the layer against the JAX layer from the same weights and input,
  float32, top-1 and top-2, with and without drops: output, aux and the
  gradients of the input and every leaf; the capacity rule;
* the MoE LM's loss and every gradient leaf against the JAX model's;
* the leaf layouts: every MoE leaf keeps the JAX layout (the router
  ``wg`` [d, E] among ``kept_layout_paths``), so the JAX-order flatten of
  the tree is the JAX package's bit for bit;
* the MoE LM under ``onebit`` and ``powersgd1`` at 2 gloo ranks
  (``torch_launch_helper``'s ``gan_lm`` mode) against the JAX workers:
  the 3-D expert leaves through each wire's JAX-order layout;
* the layer's sharded forms and the MoE LM's grid layouts as each rank
  builds them (``test_torch_moe_grid.py`` runs them on gloo ranks).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer_lm import MoETransformerLM as JMoELM
from theanompi_tpu.parallel.moe import MoE as JMoE
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import \
    MoETransformerLM as TMoELM
from theanompi_tpu_torch.parallel.moe import MoE as TMoE
from theanompi_tpu_torch.parallel.moe import top_k_lowest_first
from theanompi_tpu_torch.parallel import tp as TTP
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_gan import check_world_case, gan_lm_world  # noqa: E402
from test_torch_vgg import cpu_group  # noqa: E402,F401

CFG = dict(verbose=False, batch_size=8, seq_len=16, vocab=32,
           synthetic_train=64, synthetic_val=32, d_model=32, n_head=4,
           n_layer=2, moe_experts=4, moe_every=2)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(tree):
    return TH.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _layer(d, E, key=0, **kw):
    """The port's layer and its params from the JAX layer's init from
    ``key`` (every MoE leaf keeps the JAX layout: no conversion)."""
    moe = TMoE(d, E, compute_dtype="float32", **kw)
    jp = _host(JMoE(d, E, compute_dtype=jnp.float32, **kw).init(
        jax.random.key(key)))
    return moe, jp


def _mlp0(p, x):
    return torch.relu(x @ p["w1"][0] + p["b1"][0]) @ p["w2"][0] + p["b2"][0]


# -- the JAX package's tests/test_moe.py cases at ep = 1 ----------------------

def test_moe_uniform_router_matches_scaled_dense():
    """wg = 0: uniform probabilities, the argmax's ties to expert 0, gate
    1/E: the output is MLP_0(x)/E (rtol 1e-5 / atol 1e-6) and the aux
    exactly 1."""
    r = np.random.RandomState(0)
    moe, p = _layer(16, 4, mlp_ratio=2, capacity_factor=4.0)
    p = _t(dict(p, wg=np.zeros_like(p["wg"])))
    x = torch.from_numpy(r.randn(12, 16).astype(np.float32))
    y, aux = moe.apply(p, x)
    np.testing.assert_allclose(y.numpy(), _mlp0(p, x).numpy() / 4,
                               rtol=1e-5, atol=1e-6)
    assert float(aux) == 1.0


def test_moe_capacity_drops_overflow_tokens():
    """Training, every token routed to expert 0 with C = 2 < N: the rows
    past the capacity come out zero (they ride the block's residual);
    inference is drop-free."""
    r = np.random.RandomState(1)
    moe, p = _layer(8, 2, mlp_ratio=1, capacity_factor=0.4)
    wg = np.zeros((8, 2), np.float32)
    wg[:, 0] = 1.0
    p = _t(dict(p, wg=wg))
    x = torch.from_numpy(np.abs(r.randn(10, 8)).astype(np.float32))
    y, _ = moe.apply(p, x, train=True)
    assert moe.capacity(10, train=True) == 2
    assert not y[2:].any() and y[:2].abs().sum() > 0
    y_inf, _ = moe.apply(p, x, train=False)
    assert bool((y_inf.abs().sum(1) > 0).all())


def test_moe_top2_identical_experts_equals_dense():
    """Identical experts, drop-free: the normalized top-2 gates sum to 1,
    so the output is MLP(x) (rtol 1e-5 / atol 1e-6) whatever the router
    does."""
    r = np.random.RandomState(1)
    moe, p = _layer(16, 4, mlp_ratio=2, top_k=2, capacity_factor=100.0)
    for k in ("w1", "b1", "w2", "b2"):
        p[k] = np.broadcast_to(p[k][:1], p[k].shape)
    p = _t(p)
    x = torch.from_numpy(r.randn(24, 16).astype(np.float32))
    y, aux = moe.apply(p, x, train=True)
    np.testing.assert_allclose(y.numpy(), _mlp0(p, x).numpy(), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(float(aux))


def test_moe_top2_priority_capacity_drops_secondaries_first():
    """GShard priority: groups A (e0, then e1) and B (the mirror), 3 tokens
    each, C = 4: every primary survives and each expert keeps one
    secondary, the earliest, so only tokens 0 and 3 keep both routes (their
    output scale 1, the others' the primary gate)."""
    moe, p = _layer(4, 2, key=2, mlp_ratio=1, top_k=2, capacity_factor=1.0)
    for k in ("w1", "b1", "w2", "b2"):
        p[k] = np.broadcast_to(p[k][:1], p[k].shape)
    wg = np.zeros((4, 2), np.float32)
    wg[0, 0] = wg[1, 1] = 1.0
    p = _t(dict(p, wg=wg))
    a = [2.0, 1.0, 0.0, 0.0]
    b = [1.0, 2.0, 0.0, 0.0]
    x = torch.tensor([a, a, a, b, b, b])
    moe.capacity_factor = 4.0 / 6.0
    assert moe.capacity(6, True) == 4
    y, _ = moe.apply(p, x, train=True)
    scale = (y[:, 0] / _mlp0(p, x)[:, 0]).numpy()
    g_hi = float(np.exp(2) / (np.exp(2) + np.exp(1)))
    np.testing.assert_allclose(scale[[0, 3]], 1.0, rtol=1e-5)
    np.testing.assert_allclose(scale[[1, 2, 4, 5]], g_hi, rtol=1e-5)


def _port_lm(**kw):
    return TMoELM(dict(CFG, device="cpu", compute_dtype="float32", **kw))


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_converges_and_validates(cpu_group, topk):
    m = _port_lm(moe_topk=topk)
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    costs = []
    for c in range(1, 9):
        m.train_iter(c)
        costs.append(float(m.current_info["cost"]))
    assert np.isfinite(costs).all()
    assert np.mean(costs[-2:]) < np.mean(costs[:2])
    m.begin_val()
    m.val_iter(0)
    m.end_val()


def test_moe_checkpoint_roundtrip(cpu_group, tmp_path):
    """``save`` after 3 steps, ``load`` into a model of another seed: params
    and Adam state bit for bit."""
    m = _port_lm()
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    for c in (1, 2, 3):
        m.train_iter(c)
    m.save(str(tmp_path), epoch=0, count=3)
    m2 = _port_lm(seed=5)
    m2.compile_iter_fns()
    assert m2.load(str(tmp_path)) == 0
    for a, b in zip(TH.tree_leaves(m.params) + TH.tree_leaves(m.opt_state),
                    TH.tree_leaves(m2.params) + TH.tree_leaves(m2.opt_state)):
        assert torch.equal(a.detach(), b.detach())


# -- against the JAX layer and model ------------------------------------------

@pytest.mark.parametrize("n,cf", [(10, 3.0), (48, 1.0), (48, 0.5)])
@pytest.mark.parametrize("topk", [1, 2])
def test_capacity_rule_matches_jax(n, cf, topk):
    kw = dict(top_k=topk, capacity_factor=cf)
    j, t = JMoE(16, 4, **kw), TMoE(16, 4, **kw)
    for train in (True, False):
        assert t.capacity(n, train) == j.capacity(n, train)


def test_top_k_takes_the_lowest_index_among_ties():
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]])
    v, i = top_k_lowest_first(p, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("topk,cf", [(1, 1.0), (1, 0.5), (2, 1.0)])
def test_moe_layer_matches_jax(topk, cf, train):
    """y and aux (rtol 1e-5 / atol 1e-6) and the gradients of a random
    cotangent (plus aux) for x and every leaf (rtol 1e-4 / atol 1e-6),
    float32, 48 tokens over 4 experts, in training with capacity factor 1
    and 0.5 (tokens dropped) and drop-free at inference."""
    r = np.random.RandomState(3)
    d, E = 16, 4
    kw = dict(mlp_ratio=2, top_k=topk, capacity_factor=cf)
    jl = JMoE(d, E, compute_dtype=jnp.float32, **kw)
    p = _host(jl.init(jax.random.key(1)))
    p["wg"] = (r.randn(d, E) * 0.5).astype(np.float32)    # real routing
    p["b1"] = (r.randn(E, 2 * d) * 0.1).astype(np.float32)
    x = r.randn(48, d).astype(np.float32)
    ct = r.randn(48, d).astype(np.float32)

    def f(p, x):
        y, aux = jl.apply(p, x, train=train)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (jy, jaux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    tl = TMoE(d, E, compute_dtype="float32", **kw)
    tp = TH.tree_map(lambda a: a.requires_grad_(True), _t(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tl.apply(tp, tx, train=train)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    (torch.sum(y * torch.from_numpy(ct)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-6)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _twin(**kw):
    jm = JMoELM(dict(CFG, n_workers=1, compute_dtype=jnp.float32, **kw))
    tm = _port_lm(**kw)
    jp = _host(jm.params)
    tm.load_params(convert.params_from_jax(jp, tm.kept_layout_paths()))
    return jm, tm, jp


def test_moe_leaves_keep_the_jax_layout():
    """``kept_layout_paths`` holds every MoE leaf (the router ``wg`` [d, E],
    ``b1``/``b2`` [E, ·] and the 3-D experts) beside the embedding tables,
    the converter keeps them as they are, and ``flatten_tree_jax`` of the
    port's tree is the JAX package's ``flatten_tree`` bit for bit."""
    jm, tm, jp = _twin()
    kept = tm.kept_layout_paths()
    assert kept == {("embed", "w"), ("pos", "w")} | {
        ("block1", "moe", k) for k in ("wg", "w1", "b1", "w2", "b2")}
    for k in ("wg", "w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(tm.params["block1"]["moe"][k].detach(),
                                      jp["block1"]["moe"][k])
    want = np.asarray(JH.flatten_tree(jp, pad_to_multiple_of=256))
    got = TH.flatten_tree_jax(tm.params, pad_to_multiple_of=256, kept=kept)
    np.testing.assert_array_equal(got.detach().numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_lm_loss_and_gradients_match_jax(topk):
    """The MoE LM's training loss (cross-entropy plus 0.01·aux: rtol 1e-5)
    and every gradient leaf (rtol 1e-4 / atol 1e-5·max|leaf|), float32,
    from the JAX model's weights and batch."""
    jm, tm, jp = _twin(moe_topk=topk)
    batch = jm.data.next_train_batch(1)

    def loss(p):
        return jm.loss_and_metrics(p, {}, batch, None, True)[0]

    jc, jg = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, jp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cost, _ = tm.loss_and_metrics(tm.params, tm.bn_state, tb, None, True)
    np.testing.assert_allclose(float(cost), float(jc), rtol=1e-5)
    grads = torch.autograd.grad(cost, TH.tree_leaves(tm.params))
    want = convert.params_from_jax(_host(jg), tm.kept_layout_paths())
    for p, g in zip(TH.leaf_paths(tm.params), grads):
        w = TH.get_leaf(want, p)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg="/".join(p))


@pytest.mark.parametrize("case", ["moe_onebit", "moe_powersgd"])
def test_moe_lm_wires_two_ranks_match_jax_workers(case, tmp_path_factory):
    """One epoch (4 Adam steps) of the MoE LM under each wire at 2 gloo
    ranks against the JAX workers on a 2-device mesh, from the same
    weights: each rank's params (rtol 1e-4 / atol 1e-4) and Adam state, as
    ``test_torch_gan.check_world_case`` holds them; both ranks' replicas
    bit-equal."""
    ranks, jms = gan_lm_world(tmp_path_factory,
                              ("moe_onebit", "moe_powersgd"))
    kept = _port_lm().kept_layout_paths()
    check_world_case(ranks, jms[case], case, kept)
    for k in ranks[0]:
        if k.startswith(case + "/params"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                          err_msg=k)


@pytest.mark.parametrize("cfg", [{"tp": 2}, {"sp": 2}, {"pp": 2, "sp": 2}])
def test_model_parallel_layouts_wait_with_a9d(cfg):
    """The MoE LM builds at tp 2 (experts over the model group), sp 2
    (over the seq group) and pp 2 × sp 2 (every block a MoE, stacked over
    pipe, experts over seq one dim right): each rank of the grid holds its
    experts of the dense model's initial tables and the router whole
    (``tests/test_torch_moe_grid.py`` trains these layouts)."""
    from theanompi_tpu_torch.base import Grid
    tp, sp, pp = (cfg.get(k, 1) for k in ("tp", "sp", "pp"))
    every = dict(moe_every=1) if pp > 1 else {}
    dense = _port_lm(**every)
    for r in range(tp * sp * pp):
        g = Grid(1, tp, sp, r, pp=pp)
        m = _port_lm(grid=g, **cfg, **every)
        i = g.model if tp > 1 else g.seq
        e = 4 // (tp * sp)
        # the MoE block (block1; under pp the pipe rank's stacked row)
        want = dense.params[f"block{g.pipe if pp > 1 else 1}"]["moe"]
        got = m.params["block1"]["moe"] if pp == 1 else TH.tree_map(
            lambda a: a[0], m.params["blocks"]["moe"])
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(
                got[k].detach().numpy(),
                want[k][i * e:(i + 1) * e].detach().numpy(), err_msg=k)
        np.testing.assert_array_equal(got["wg"].detach().numpy(),
                                      want["wg"].detach().numpy())
        axes = {p[-1]: s for p, s in zip(
            TH.leaf_paths(m.params), m.split_axes_leaves())
            if "moe" in p}
        assert ("model" if tp > 1 else "seq") in axes["w1"]
        assert axes["wg"] == (("pipe",) if pp > 1 else ())


@pytest.mark.parametrize("kw", [{"ep": 2}, {"seq_shards": 2}])
def test_expert_parallel_forms_wait_with_a9d(kw):
    """The layer's sharded forms: at ep 2 the two ranks' parts, each run
    alone on its experts (the group ``tp.LOCAL``), add up to the ep 1 layer's
    output (rtol 1e-5 / atol 1e-6) with the same aux; at seq_shards 2 the
    expert tables split over seq and the model group splits nothing
    (``tests/test_torch_moe_grid.py`` runs both forms on 2 ranks)."""
    r = np.random.RandomState(4)
    moe, p = _layer(16, 4, mlp_ratio=2, capacity_factor=1.0)
    p["wg"] = (r.randn(16, 4) * 0.5).astype(np.float32)
    x = torch.from_numpy(r.randn(24, 16).astype(np.float32))
    if "ep" in kw:
        y1, aux1 = moe.apply(_t(p), x, train=True)
        ys = []
        for rank in (0, 1):
            part = TMoE(16, 4, mlp_ratio=2, capacity_factor=1.0,
                        compute_dtype="float32", rank=rank,
                        group=TTP.LOCAL, **kw)
            mine = {k: v if k == "wg" else v[2 * rank:2 * rank + 2]
                    for k, v in p.items()}
            y, aux = part.apply(_t(mine), x, train=True)
            assert float(aux) == float(aux1)
            ys.append(y)
        np.testing.assert_allclose((ys[0] + ys[1]).numpy(), y1.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert part.specs() == {"wg": None, "w1": 0, "b1": 0, "w2": 0,
                                "b2": 0} and part.seq_specs() is None
    else:
        part = TMoE(16, 4, compute_dtype="float32", **kw)
        assert part.specs() is None
        assert part.seq_specs() == {"wg": None, "w1": 0, "b1": 0, "w2": 0,
                                    "b2": 0}
        with pytest.raises(ValueError, match="divisible"):
            TMoE(16, 6, seq_shards=4)


def test_unjoined_tp_grid_model_raises():
    """A grid model whose groups were never joined refuses to run at tp 2
    (no model group: its layers would sum one rank's partial products);
    with the model group ``tp.LOCAL`` rank 0's part runs alone."""
    from theanompi_tpu_torch.base import Grid
    g = Grid(1, 2, 1, 0)
    m = _port_lm(grid=g, tp=2)
    x = torch.zeros(2, CFG["seq_len"], dtype=torch.long)
    with pytest.raises(ValueError, match="no model group"):
        m.apply_model(m.params, x, train=True, gen=None, state=None)
    with pytest.raises(ValueError, match="no model group"):
        TTP.reduce_from_model(torch.ones(3), None)
    g.model_group = TTP.LOCAL
    m = _port_lm(grid=g, tp=2)
    out = m.apply_model(m.params, x, train=True, gen=None, state=None)
    assert tuple(out.shape) == (2, CFG["seq_len"], CFG["vocab"] // 2)


def test_jax_moe_checkpoint_continues_in_port(cpu_group, tmp_path):
    """The JAX MoE LM trains 2 Adam steps and saves; the port (another
    seed) loads it through ``convert.checkpoint_from_jax``: params and
    Adam's moments exactly the JAX state (the MoE leaves kept as they
    are), the counts 2; both take step 3: cost rtol 1e-5."""
    jm = JMoELM(dict(CFG, n_workers=1, compute_dtype=jnp.float32))
    tm = _port_lm(seed=9)
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    jm.data.shuffle_data(0)
    for c in (1, 2):
        jm.train_iter(c)
    d = str(tmp_path / "jax_ckpt")
    jm.save(d, epoch=0, count=2)
    assert convert.checkpoint_from_jax(d, tm) == 0
    kept = tm.kept_layout_paths()
    st = jax.tree.map(lambda a: np.asarray(a)[0],
                      jax.device_get(jm.step_state))
    for name, want, got in (
            ("params", st["params"], tm.host_params()),
            ("m", st["opt_state"]["m"], tm.opt_state["m"]),
            ("v", st["opt_state"]["v"], tm.opt_state["v"])):
        want = convert.params_from_jax(want, kept)
        for p in TH.leaf_paths(want):
            np.testing.assert_array_equal(
                np.asarray(TH.get_leaf(got, p)), TH.get_leaf(want, p),
                err_msg=f"{name} {p}")
    assert {int(t) for t in TH.tree_leaves(tm.opt_state["t"])} == {2}
    jm.train_iter(3)
    tm.train_iter(3)
    np.testing.assert_allclose(float(tm.current_info["cost"]),
                               float(jm.current_info["cost"]), rtol=1e-5)
