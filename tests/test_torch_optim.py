"""The update layer of the port against the JAX package: ``grad_clip``,
the optimizers ``nesterov`` and ``rmsprop``, the EMA shadow, and ``sgd``
and ``momentum`` as ``torch._foreach_*`` passes.

* ``grad_clip`` under BSP at world 1 on the ``allreduce``, ``onebit`` and
  ``topk`` wires (the reduced gradient clipped), from the JAX twin's
  weights, at a clip of half the first step's reduced-gradient norm: with
  ``sgd``, lr 1 and no decay the update is minus the clipped gradient,
  which must be half the unclipped one and the JAX package's clipped one
  (rtol 1e-5 / atol 1e-7, ``tests/test_grad_clip.py``'s bound; onebit's
  decoded signs are exact, so its update is compared the same way); a
  clip above the norm leaves the update as it was, bit for bit.
* ``nesterov``, ``rmsprop`` and every optimizer under ``ema_wrap``, four
  steps with a changing learning rate, against the JAX optimizers:
  params and shadow rtol/atol 1e-6 (rmsprop's square average adds the
  same terms in another order: one ulp).
* ``sgd`` and ``momentum`` bit for bit the per-leaf loops they replace.
* Through the model, at world 1, three steps of ``TinyLRNNet`` under
  ``nesterov``, ``rmsprop`` (at lr 0.001, an rmsprop rate) and
  ``momentum`` with ``ema_decay``: params,
  optimizer state and shadow against the JAX model (rtol 1e-5 / atol
  1e-6, the trajectory tests' bound); validation scores the shadow (the
  live params before the first update) and the ``.npy`` snapshot holds
  it; a checkpoint of the shadow loads in place and resumes bit for bit;
  a JAX checkpoint with EMA, and one of EASGD's center and GoSGD's α,
  load through ``convert.checkpoint_from_jax``.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import exchanger as JEX
from theanompi_tpu.utils import opt as JO
from theanompi_tpu.utils.recorder import Recorder as JRecorder
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import exchanger as TEX
from theanompi_tpu_torch.utils import helper_funcs as TH
from theanompi_tpu_torch.utils import opt as TO
from theanompi_tpu_torch.utils.recorder import Recorder as TRecorder

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_vgg import _JTinyVGGNet, cpu_group  # noqa: E402,F401

TOPK_CHUNK = 256


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_row(jm, part):
    return jax.tree.map(lambda v: np.asarray(v)[0],
                        jax.device_get(jm.step_state[part]))


# -- grad_clip -------------------------------------------------------------

def _pair(wire, **cfg):
    """The JAX twin and the port's model from its weights, world 1, BSP on
    ``wire``, compiled."""
    cfg = dict(cfg, verbose=False, exch_strategy=wire)
    if wire == "allreduce":
        jm = _JTinyLRNNet(dict(cfg, n_workers=1))
        tm = helper.TinyLRNNet(dict(cfg, device="cpu"))
    else:
        jm = _JTinyVGGNet(dict(cfg, n_workers=1))
        tm = helper.TinyVGGNet(dict(cfg, device="cpu"))
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    jx, tx = JEX.BSP_Exchanger(jm.config), TEX.BSP_Exchanger(tm.config)
    if wire == "topk":
        jx.strategy.chunk = tx.strategy.chunk = TOPK_CHUNK
    jm.compile_iter_fns(jx)
    tm.compile_iter_fns(tx)
    return jm, tm


SGD1 = dict(optimizer="sgd", learning_rate=1.0, weight_decay=0.0)


def _port_update(wire, **cfg):
    """Minus the port's first update (= the clipped reduced gradient)."""
    jm, tm = _pair(wire, **SGD1, **cfg)
    p0 = tm.host_params()
    p0 = TH.tree_map(np.copy, p0)
    tm.train_iter(1)
    return TH.tree_map(lambda a, b: a - b, p0, tm.host_params()), jm, tm


@pytest.mark.parametrize("wire", ["allreduce", "onebit", "topk"])
def test_grad_clip_at_the_first_step_matches_jax(cpu_group, wire):
    raw, _, _ = _port_update(wire)
    norm = float(np.sqrt(sum(np.sum(np.square(l, dtype=np.float64))
                             for l in TH.tree_leaves(raw))))
    clip = norm / 2.0
    got, jm, tm = _port_update(wire, grad_clip=clip)
    jp0 = _host(jm.params)
    jm.train_iter(1)
    jp1 = _host(jm.canonical_host_params())
    want = convert.params_from_jax(jax.tree.map(lambda a, b: a - b, jp0,
                                                jp1))
    for path in TH.leaf_paths(got):
        g = TH.get_leaf(got, path)
        np.testing.assert_allclose(g, TH.get_leaf(raw, path) * 0.5,
                                   rtol=1e-5, atol=1e-7, err_msg=str(path))
        np.testing.assert_allclose(g, TH.get_leaf(want, path), rtol=1e-5,
                                   atol=1e-7, err_msg=str(path))
    loose, _, _ = _port_update(wire, grad_clip=norm * 10)
    for a, b in zip(TH.tree_leaves(loose), TH.tree_leaves(raw)):
        np.testing.assert_array_equal(a, b)


def test_grad_clip_keeps_the_scale_on_the_device():
    """The clip scale is a device tensor: ``_clip_grads`` on tensors under
    the meta device (where any read back to the host raises) runs, and a
    bfloat16 leaf keeps its dtype."""
    ex = TEX.Exchanger({"grad_clip": 1.0})
    g = {"a": torch.ones(4, 3, device="meta"),
         "b": torch.ones(3, dtype=torch.bfloat16, device="meta")}
    out = ex._clip_grads(g)
    assert out["a"].device.type == "meta" and out["b"].dtype == torch.bfloat16
    assert TEX.Exchanger({})._clip_grads(g) is g


# -- optimizers --------------------------------------------------------------

def _trees(seed):
    r = np.random.RandomState(seed)
    mk = lambda: {"a": {"w": r.randn(4, 3).astype(np.float32),
                        "b": r.randn(3).astype(np.float32)},
                  "c": {"w": r.randn(2, 2, 3, 5).astype(np.float32)}}
    return mk(), [mk() for _ in range(4)]


OPTS = [("nesterov", dict(mu=0.9, weight_decay=5e-4)),
        ("nesterov", dict(mu=0.5, weight_decay=0.0)),
        ("rmsprop", dict(weight_decay=0.0)),
        ("rmsprop", dict(decay=0.8, eps=1e-6, weight_decay=1e-2))]
EMA = [("sgd", dict(weight_decay=1e-3)), ("momentum", dict(mu=0.9)),
       ("nesterov", dict(mu=0.9)), ("rmsprop", dict()), ("adam", dict())]


@pytest.mark.parametrize("name,kw,ema", [o + (None,) for o in OPTS]
                         + [o + (0.9,) for o in EMA])
def test_optimizer_steps_match_jax(name, kw, ema):
    params, grads = _trees(0)
    jo, to = JO.get_optimizer(name, **kw), TO.get_optimizer(name, **kw)
    if ema:
        jo, to = JO.ema_wrap(jo, ema), TO.ema_wrap(to, ema)
    jp = jax.tree.map(jax.numpy.asarray, params)
    js = jo.init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = to.init(tp)
    lr = torch.zeros(())
    for g, rate in zip(grads, (0.1, 0.1, 0.01, 0.05)):
        jp, js = jo.update(jax.tree.map(jax.numpy.asarray, g), js, jp, rate)
        lr.fill_(rate)
        tp, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp, lr)
    pairs = [(tp, jp)] + ([(ts["ema"], js["ema"])] if ema else [])
    for t_tree, j_tree in pairs:
        for k in params:
            for n in params[k]:
                np.testing.assert_allclose(
                    t_tree[k][n].numpy(), np.asarray(j_tree[k][n]),
                    rtol=1e-6, atol=1e-6, err_msg=f"{k}/{n}")
    if ema:
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 4 == \
            int(js["t"])


def _per_leaf(name, mu, wd, params, state, grads, lr):
    """The loops ``sgd`` and ``momentum`` ran before their ``_foreach``
    passes."""
    with torch.no_grad():
        if name == "sgd":
            for p, g in zip(params, grads):
                p.sub_(lr * (g + wd * p))
            return
        for p, g, v in zip(params, grads, state):
            v.mul_(mu).sub_(lr * (g + wd * p))
            p.add_(v)


@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("sgd", 1e-3),
                                     ("momentum", 0.0),
                                     ("momentum", 5e-4)])
@pytest.mark.parametrize("tensor_lr", [False, True])
def test_foreach_sgd_and_momentum_equal_the_per_leaf_loops(name, wd,
                                                           tensor_lr):
    params, grads = _trees(3)
    o = TO.sgd(wd) if name == "sgd" else TO.momentum(0.9, wd)
    tp = TH.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = o.init(tp)
    ref_p = [torch.from_numpy(a.copy()) for a in TH.tree_leaves(params)]
    ref_v = [torch.zeros_like(p) for p in ref_p]
    for g, rate in zip(grads, (0.1, 0.1, 0.01, 0.05)):
        lr = torch.tensor(rate) if tensor_lr else rate
        gt = TH.tree_map(torch.from_numpy, g)
        o.update(gt, ts, tp, lr)
        _per_leaf(name, 0.9, wd, ref_p, ref_v, TH.tree_leaves(gt), lr)
    for a, b in zip(TH.tree_leaves(tp), ref_p):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if name == "momentum":
        for a, b in zip(TH.tree_leaves(ts), ref_v):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ema_seeds_its_shadow_on_the_device():
    """A load of the params between ``init`` and the first update is what
    the shadow starts from (``where(t == 0, p, e)``, on the device), as in
    the JAX package, whose shadow then tracks the loaded params."""
    params, grads = _trees(4)
    o = TO.ema_wrap(TO.sgd(), 0.5)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    st = o.init(tp)
    for p in TH.tree_leaves(tp):
        p.data.mul_(2.0)                 # a load after init
    start = [p.clone() for p in TH.tree_leaves(tp)]
    o.update(jax.tree.map(torch.from_numpy, grads[0]), st, tp, 0.1)
    for e, p0, p1 in zip(TH.tree_leaves(st["ema"]), start,
                         TH.tree_leaves(tp)):
        np.testing.assert_array_equal(e.numpy(),
                                      (0.5 * p0 + 0.5 * p1).numpy())


# -- through the model -------------------------------------------------------

# rmsprop at an rmsprop rate: its first steps move every weight by about
# lr/sqrt(1 - decay) whatever the gradient, so at TinyLRNNet's SGD rate
# (0.1: 0.32 a weight a step) the run blows up the packages' summation
# -order differences (1.7e-5 after three steps; one step of the optimizer
# alone agrees to an ulp, test_optimizer_steps_match_jax)
MODEL_CASES = [("nesterov", {}), ("rmsprop", {"learning_rate": 0.001}),
               ("momentum", {"ema_decay": 0.9})]


def _models(opt, **cfg):
    cfg = dict(cfg, optimizer=opt, verbose=False)
    jm = _JTinyLRNNet(dict(cfg, n_workers=1))
    tm = helper.TinyLRNNet(dict(cfg, device="cpu"))
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    return jm, tm


def _val_cost(m, rec):
    m.begin_val()
    for _ in range(m.data.n_batch_val):
        m.val_iter(3, rec)
    m.end_val()
    return rec.print_val_info(3)["val_cost"]


@pytest.mark.parametrize("opt,cfg", MODEL_CASES)
def test_model_trajectory_matches_jax(cpu_group, tmp_path, opt, cfg):
    jm, tm = _models(opt, **cfg)
    ema = "ema_decay" in cfg
    if ema:
        # before the first update validation scores the live params
        tm.begin_val()
        assert tm.val_params()[0] is tm.params
        tm.end_val()
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)
    jst = _jax_row(jm, "opt_state")
    jp = _jax_row(jm, "params")
    trees = [(tm.host_params(), jp)]
    if ema:
        trees += [(TH.tree_map(lambda t: t.numpy(), tm.opt_state["ema"]),
                   jst["ema"]),
                  (TH.tree_map(lambda t: t.numpy(), tm.opt_state["inner"]),
                   jst["inner"])]
        assert int(tm.opt_state["t"]) == 3 == int(jst["t"])
    else:
        trees += [(TH.tree_map(lambda t: t.numpy(), tm.opt_state), jst)]
    for got, want in trees:
        want = convert.params_from_jax(want)
        for path in TH.leaf_paths(want):
            np.testing.assert_allclose(TH.get_leaf(got, path),
                                       TH.get_leaf(want, path), rtol=1e-5,
                                       atol=1e-6, err_msg=str(path))
    np.testing.assert_allclose(_val_cost(tm, TRecorder({"verbose": False})),
                               _val_cost(jm, JRecorder({"verbose": False})),
                               rtol=1e-5)
    if not ema:
        return
    # validation reads the shadow, and so does the .npy snapshot
    tm.begin_val()
    assert tm.val_params()[0] is tm.opt_state["ema"]
    tm.end_val()
    tm.save(str(tmp_path), 0, 3)
    for path in TH.leaf_paths(tm.params):
        np.testing.assert_array_equal(
            np.load(tmp_path / "params_epoch0" / ("_".join(path) + ".npy")),
            TH.get_leaf(tm.opt_state["ema"], path).numpy())


def test_ema_checkpoint_loads_in_place_and_resumes(cpu_group, tmp_path):
    """The shadow and its count are checkpointed with the optimizer state
    and loaded into the tensors a captured step reads; training on from
    the load is bit for bit training on without a break."""
    _, a = _models("momentum", ema_decay=0.9)
    _, b = _models("momentum", ema_decay=0.9)
    for c in (1, 2):
        a.train_iter(c)
        b.train_iter(c)
    a.save(str(tmp_path), 0, 2)
    a.train_iter(3)
    leaves = b.train_fn._state_leaves()
    b.train_iter(3)                   # then the load puts b back at step 2
    assert b.load(str(tmp_path)) == 0
    assert b.train_fn._state_current(leaves)
    assert int(b.opt_state["t"]) == 2
    # the step's state identity check covers the shadow: a shadow in new
    # tensors makes a captured step capture again
    ema = b.opt_state["ema"]
    b.opt_state["ema"] = TH.tree_map(torch.clone, ema)
    assert not b.train_fn._state_current(leaves)
    b.opt_state["ema"] = ema
    b.train_iter(3)
    x, y = helper.state_arrays(a), helper.state_arrays(b)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_jax_checkpoint_with_ema_loads(cpu_group, tmp_path):
    """A JAX checkpoint of momentum under ``ema_decay`` (opt state
    ``{ema, inner, t}``) into the port: the shadow, the velocity and the
    count where the port keeps them; one more step each agrees."""
    jm, tm = _models("momentum", ema_decay=0.9)
    for c in (1, 2):
        jm.train_iter(c)
    d = str(tmp_path / "jax")
    jm.save(d, epoch=0, count=2)
    assert convert.checkpoint_from_jax(d, tm) == 0
    jst = _jax_row(jm, "opt_state")
    assert int(tm.opt_state["t"]) == 2
    for mine, theirs in ((tm.opt_state["ema"], jst["ema"]),
                         (tm.opt_state["inner"], jst["inner"])):
        want = convert.params_from_jax(theirs)
        for path in TH.leaf_paths(want):
            np.testing.assert_array_equal(
                TH.get_leaf(mine, path).numpy(), TH.get_leaf(want, path))
    jm.train_iter(3)
    tm.train_iter(3)
    np.testing.assert_allclose(float(tm.current_info["cost"]),
                               float(jm.current_info["cost"]), rtol=1e-5)


@pytest.mark.parametrize("rule,key", [("easgd", "center"),
                                      ("gosgd", "alpha")])
def test_jax_checkpoint_of_an_async_rule_loads(cpu_group, tmp_path, rule,
                                               key):
    """A JAX checkpoint of EASGD (its center) or GoSGD (its α), at world 1,
    into the port's model under the same rule."""
    cfg = {"verbose": False, "sync_freq": 2, "exch_prob": 1.0}
    jm = _JTinyLRNNet(dict(cfg, n_workers=1))
    tm = helper.TinyLRNNet(dict(cfg, device="cpu"))
    jx = JEX.get_exchanger(rule, jm.config)
    jm.compile_iter_fns(jx)
    tm.compile_iter_fns(TEX.get_exchanger(rule, tm.config))
    for c in (1, 2):
        jm.train_iter(c)
        jx.exchange(None, c)
    d = str(tmp_path / "jax")
    jm.save(d, epoch=0, count=2)
    assert convert.checkpoint_from_jax(d, tm) == 0
    extra = _jax_row(jm, "extra")
    if key == "alpha":
        assert float(tm.extra["alpha"]) == float(extra["alpha"])
        return
    want = convert.params_from_jax(extra["center"])
    for path in TH.leaf_paths(want):
        np.testing.assert_array_equal(
            TH.get_leaf(tm.extra["center"], path).numpy(),
            TH.get_leaf(want, path))
    want = convert.params_from_jax(_jax_row(jm, "params"))
    for path in TH.leaf_paths(want):
        np.testing.assert_array_equal(TH.get_leaf(tm.host_params(), path),
                                      TH.get_leaf(want, path))
