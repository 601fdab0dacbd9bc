"""The port's GANs (WGAN, LSGAN) against the JAX package's.

* ``ConvTranspose`` against ``lax.conv_transpose`` (SAME and VALID, the
  generator's k 5 / s 2 and other kernels and strides), float32: output and
  the input's and weight's gradients;
* the cases of the JAX package's ``tests/test_gan.py`` on the port: the
  alias modules, the generator's shape and tanh range, a finite step of
  each GAN, the ``n_critic`` gate and the clip, the gate under Adam (G's
  params and every G optimizer leaf bit-frozen off the cadence, G's counts
  lagging D's), the LSGAN loss arithmetic, the layouts a path-gating model
  refuses, the EMA composing with the gate (the shadow's G frozen at its
  seed, its D clipped), and WGAN refusing ``ema_decay`` with ``zero_opt``;
* a 4-step WGAN (RMSprop) and LSGAN (Adam) trajectory at ``n_critic`` 2,
  both packages from the same weights, batches and noise (the port's
  ``draw_z`` handed the JAX package's draw for each step), float32;
* a JAX GAN checkpoint (params, RMSprop or Adam state with Adam's per-leaf
  counts, G's BatchNorm state) continuing in the port;
* WGAN under BSP and LSGAN under GoSGD at 2 gloo ranks
  (``torch_launch_helper``'s ``gan_lm`` mode, one launch; the MoE LM's
  cases launch their own, ``test_torch_moe.py``) against the JAX workers
  on a 2-device mesh.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import gan as JG
from theanompi_tpu.models import layers as JL
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models import gan as TG
from theanompi_tpu_torch.models import layers as TL
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_launch_helper as lh  # noqa: E402
from test_torch_vgg import cpu_group  # noqa: E402,F401

CFG = dict(batch_size=4, synthetic_train=16, synthetic_val=8, base_width=8,
           z_dim=16, verbose=False)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax(cls, **kw):
    return getattr(JG, cls)(dict(CFG, n_workers=1, compute_dtype=jnp.float32,
                                 **kw))


def _port(cls, **kw):
    return getattr(TG, cls)(dict(CFG, device="cpu", compute_dtype="float32",
                                 **kw))


def jax_z(seed: int, rank: int, count: int, n: int, z_dim: int):
    """The JAX package's noise for step ``count`` on worker ``rank``: its
    step key ``fold_in(fold_in(key(seed + 2), rank), count)``, split in
    three, the first drawing ``z``."""
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed + 2), rank),
                           count)
    return np.asarray(jax.random.normal(jax.random.split(k, 3)[0],
                                        (n, z_dim)))


def feed_jax_z(tm, jm, rank: int = 0):
    """Make the port model's next ``draw_z`` return the JAX draw of the step
    its ``train_iter(count)`` takes."""
    step = tm.train_iter
    box = {}

    def train_iter(count, recorder=None):
        box["z"] = torch.from_numpy(jax_z(jm.seed, rank, count,
                                          tm.data.batch_size, tm.z_dim))
        step(count, recorder)

    tm.train_iter = train_iter
    tm.draw_z = lambda n, gen, device: box.pop("z").to(device)


# -- ConvTranspose ------------------------------------------------------------

@pytest.mark.parametrize("k,s,padding,hw", [
    (5, 2, "SAME", 4), (5, 2, "VALID", 4), (4, 2, "SAME", 3),
    (3, 1, "SAME", 5), (2, 3, "VALID", 3)])
def test_conv_transpose_matches_lax(k, s, padding, hw):
    """Output, and the gradients of a random cotangent with respect to the
    input and the weight, float32: rtol 1e-5 / atol 1e-6 (measured: 0 for
    the generator's k 5 / s 2, one float32 ulp elsewhere).  (2, 3, VALID)
    needs an ``output_padding``; (4, 2, SAME) pads more before than after."""
    r = np.random.RandomState(k * 10 + s)
    jl = JL.ConvTranspose(6, 3, k, stride=s, padding=padding,
                          activation="tanh", compute_dtype=jnp.float32)
    p = _host(jl.init(jax.random.key(0)))
    p["b"] = r.randn(3).astype(np.float32) * 0.1
    x = r.randn(2, hw, hw, 6).astype(np.float32)

    def f(p, x):
        return jl.apply(p, x)

    ref, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ct = r.randn(*ref.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(ct))
    tl = TL.ConvTranspose(6, 3, k, stride=s, padding=padding,
                          activation="tanh", compute_dtype="float32")
    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in
          convert.params_from_jax({"d": p})["d"].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tl.apply(tp, tx)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    want_w = convert.params_from_jax({"d": _host(gp)})["d"]
    for n in ("w", "b"):
        np.testing.assert_allclose(tp[n].grad.numpy(), want_w[n], rtol=1e-5,
                                   atol=1e-5)


def test_reshape_keeps_the_batch_dim():
    x = torch.arange(2 * 48.0).view(2, 48)
    got = TL.Reshape((4, 4, 3)).apply(None, x)
    ref = JL.Reshape((4, 4, 3)).apply(None, jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the JAX package's tests/test_gan.py cases --------------------------------

def test_reference_alias_paths_import():
    from theanompi_tpu_torch.models.lsgan import LSGAN
    from theanompi_tpu_torch.models.wgan import WGAN
    assert WGAN is TG.WGAN and LSGAN is TG.LSGAN


def test_generator_output_shape_and_range():
    m = _port("WGAN")
    z = torch.randn(3, m.z_dim, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        imgs = m.generate(m.params, z)
    assert tuple(imgs.shape) == (3, 32, 32, 3)
    assert bool((imgs.abs() <= 1.0).all())               # tanh


@pytest.mark.parametrize("cls", ["WGAN", "LSGAN"])
def test_gan_train_step_finite(cpu_group, cls):
    m = _port(cls)
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    for i in range(2):
        m.train_iter(i + 1)
    assert np.isfinite(float(m.current_info["cost"]))
    assert np.isfinite(float(m.current_info["error"]))


def _leaves(tree):
    return [t.detach().clone() for t in TH.tree_leaves(tree)]


@pytest.mark.parametrize("capture", [False, True])
def test_wgan_n_critic_gate_and_clip(cpu_group, capture):
    """G's params move only on ``count % n_critic == 0`` steps (and so do
    its RMSprop leaves); D's move on every step and stay inside the clip
    box.  ``capture=True`` runs the static step the card captures."""
    m = _port("WGAN", n_critic=3, clip=0.005)
    m.compile_iter_fns(capture=capture)
    m.data.shuffle_data(0)
    g0, sq0 = _leaves(m.params["G"]), _leaves(m.opt_state["G"])
    d0 = _leaves(m.params["D"])
    m.train_iter(1)                       # 1 % 3 != 0: G frozen
    for a, b in zip(g0 + sq0, _leaves(m.params["G"])
                    + _leaves(m.opt_state["G"])):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b)
               for a, b in zip(d0, _leaves(m.params["D"])))
    g1 = _leaves(m.params["G"])
    m.train_iter(2)                       # still frozen
    m.train_iter(3)                       # 3 % 3 == 0: G updates
    assert any(not torch.equal(a, b)
               for a, b in zip(g1, _leaves(m.params["G"])))
    for leaf in TH.tree_leaves(m.params["D"]):
        assert float(leaf.detach().abs().max()) <= 0.005


def test_n_critic_gate_holds_under_stateful_adam(cpu_group):
    """Zeroed gradients would not do: Adam's moments would still move G.
    G's params and its whole Adam state are bit-frozen on gated steps;
    after counts 4..8 G has updated twice (4, 8) and D five times, so G's
    counts read 2 and D's 5, each group in a count tensor of its own."""
    m = _port("LSGAN", n_critic=4)
    assert m.optimizer == "adam"
    m.compile_iter_fns()
    m.data.shuffle_data(0)

    def g_side():
        return _leaves(m.params["G"]) + [
            t.detach().clone() for p, t in zip(TH.leaf_paths(m.opt_state),
                                               TH.tree_leaves(m.opt_state))
            if "G" in p]

    m.train_iter(4)                       # 4 % 4 == 0: G updates, Adam warm
    s1 = g_side()
    m.train_iter(5)                       # gated
    s2 = g_side()
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    for c in (6, 7, 8):                   # 8 % 4 == 0: G moves again
        m.train_iter(c)
    assert any(not torch.equal(a, b)
               for a, b in zip(s2[:len(TH.tree_leaves(m.params["G"]))],
                               _leaves(m.params["G"])))
    t = m.opt_state["t"]
    g_ts = {id(c): int(c) for c in TH.tree_leaves(t["G"])}
    d_ts = {id(c): int(c) for c in TH.tree_leaves(t["D"])}
    assert set(g_ts.values()) == {2} and set(d_ts.values()) == {5}
    assert len(g_ts) == len(d_ts) == 1 and set(g_ts).isdisjoint(d_ts)


def test_lsgan_loss_math():
    sr = torch.tensor([1.0, 0.0])
    sf = torch.tensor([0.5, 0.5])
    np.testing.assert_allclose(float(TG.LSGAN.d_loss(None, sr, sf)),
                               0.5 * (0.5 + 0.25), rtol=1e-6)
    np.testing.assert_allclose(float(TG.LSGAN.g_loss(None, sf)), 0.5 * 0.25,
                               rtol=1e-6)


@pytest.mark.parametrize("cls,cfg,match", [
    ("WGAN", {"zero_opt": True}, "param paths"),
    ("LSGAN", {"n_critic": 2, "zero_opt": True}, "param paths"),
    ("WGAN", {"update_sharding": True}, "update_sharding chunks"),
    ("WGAN", {"fsdp": True}, "fsdp flattens"),
    ("LSGAN", {"fsdp": True}, "fsdp flattens"),
    ("WGAN", {"ema_decay": 0.99, "zero_opt": True}, "EMA shadow"),
])
def test_gan_refuses_flat_layouts(cls, cfg, match):
    """The JAX package's build-time refusals, with the key named: a gating
    GAN under ``zero_opt`` or ``update_sharding`` (BSP), any GAN under
    ``fsdp`` (its update hook is tree-wise), and WGAN under ``ema_decay``
    with ``zero_opt``.  The JAX package raises too."""
    for build, err in ((_jax, AssertionError), (_port, ValueError)):
        with pytest.raises(err, match=match):
            build(cls, **cfg)


def test_update_sharding_under_an_async_rule_is_not_refused():
    """Under another rule than BSP the optimizer state stays whole (only a
    center shards), so the JAX package builds the gating GAN, and the port
    too."""
    _port("WGAN", update_sharding=True, rule="easgd")
    _jax("WGAN", update_sharding=True, rule="easgd")


def test_gan_composes_with_ema(cpu_group):
    """The gate works through the EMA wrapper: on a gated step G's shadow
    keeps its seed (G's params), not zeros; D's shadow moves and WGAN
    projects it into the clip box."""
    m = _port("WGAN", n_critic=2, ema_decay=0.9)
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    p0 = {k: _leaves(m.params[k]) for k in ("G", "D")}
    m.train_iter(1)                       # gated
    st = m.opt_state
    assert set(st) == {"inner", "ema", "t"}
    for e, p in zip(TH.tree_leaves(st["ema"]["G"]), p0["G"]):
        assert torch.equal(e, p)
    assert max(float(e.abs().max())
               for e in TH.tree_leaves(st["ema"]["G"])) > 0.0
    m.train_iter(2)                       # G updates
    assert np.isfinite(float(m.current_info["cost"]))
    assert max(float((e - p).abs().max()) for e, p in
               zip(TH.tree_leaves(st["ema"]["D"]), p0["D"])) > 0.0
    for e in TH.tree_leaves(st["ema"]["D"]):
        assert float(e.abs().max()) <= m.clip
    assert int(st["t"]) == 2


# -- against the JAX model's trajectory ---------------------------------------

def _twins(cls, **kw):
    """The JAX GAN and the port's from its weights, compiled at world 1,
    the same shuffle, the port fed the JAX noise."""
    jm, tm = _jax(cls, **kw), _port(cls, **kw)
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    jm.data.shuffle_data(0)
    tm.data.shuffle_data(0)
    feed_jax_z(tm, jm)
    return jm, tm


def _assert_tree_close(pairs, name, atol_all, atol_bulk, rtol_bulk):
    """``pairs`` of (path, got, want) arrays, a state tree's leaves: every
    entry within ``atol_all``; 99% of all the tree's entries within
    ``atol_bulk`` + ``rtol_bulk``·|want|.  Held over the tree, not leaf by
    leaf: a leaf of summation noise alone (the bias of a conv a BatchNorm
    follows, whose true gradient is 0) steps either way in either
    package."""
    close = []
    for path, got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol_all,
                                   err_msg=f"{name} {path}")
        close.append(np.isclose(got, want, rtol=rtol_bulk,
                                atol=atol_bulk).reshape(-1))
    share = np.concatenate(close).mean()
    assert share >= 0.99, (name, share)


def _scale(tree) -> float:
    """The largest magnitude in a state tree: the scale its tolerances take
    (a leaf of summation noise alone, the gradient of a conv bias that a
    BatchNorm follows, has no scale of its own)."""
    return max(float(np.abs(TH.get_leaf(tree, p)).max())
               for p in TH.leaf_paths(tree)) or 1.0


def _check_state(jm, tm, lr):
    """Params after the steps: every entry within 8·lr, 99% of the tree's
    within rtol 1e-4 / atol 1e-6 (RMSprop's and Adam's first steps are
    sign-like: an entry whose gradient sits within the summation noise of
    zero, as a conv bias before a BatchNorm, steps ~lr either way); the
    optimizer's moments every entry within 0.5, 99% of them within 1e-4,
    of the tree's largest entry (plus rtol 1e-3); counts exactly; BN state
    rtol 1e-4 / atol 2·lr (a running mean holds 0.1 of each step's batch
    mean, which holds the noise-driven bias before it)."""
    st = jax.tree.map(lambda a: np.asarray(a)[0],
                      jax.device_get(jm.step_state))
    want = convert.params_from_jax(st["params"])
    got = tm.host_params()
    _assert_tree_close([(p, TH.get_leaf(got, p), TH.get_leaf(want, p))
                        for p in TH.leaf_paths(want)], "params", 8 * lr,
                       1e-6, 1e-4)
    opt = st["opt_state"]
    if "t" in opt:                        # Adam: per-leaf counts
        for p in TH.leaf_paths(opt["t"]):
            assert int(TH.get_leaf(tm.opt_state["t"], p)) == \
                int(TH.get_leaf(opt["t"], p)), p
        trees = {k: (opt[k], tm.opt_state[k]) for k in ("m", "v")}
    else:
        trees = {"sq": (opt, tm.opt_state)}
    for name, (j, t) in trees.items():
        j = convert.params_from_jax(j)
        scale = _scale(j)
        _assert_tree_close([(p, TH.get_leaf(t, p).numpy(), TH.get_leaf(j, p))
                            for p in TH.leaf_paths(j)], name, 0.5 * scale,
                           1e-4 * scale, 1e-3)
    for p in TH.leaf_paths(st["bn_state"]):
        np.testing.assert_allclose(TH.get_leaf(tm.bn_state, p).numpy(),
                                   TH.get_leaf(st["bn_state"], p), rtol=1e-4,
                                   atol=2 * lr, err_msg=str(p))


@pytest.mark.parametrize("cls", ["WGAN", "LSGAN"])
def test_trajectory_matches_jax(cpu_group, cls):
    """4 steps at ``n_critic`` 2 (G updates at 2 and 4): cost and G loss
    per step rtol 1e-4 / atol 1e-8 (WGAN's costs are near 0), then the
    state as ``_check_state`` holds it."""
    jm, tm = _twins(cls, n_critic=2)
    for c in (1, 2, 3, 4):
        jm.train_iter(c)
        tm.train_iter(c)
        for k in ("cost", "error"):
            np.testing.assert_allclose(float(tm.current_info[k]),
                                       float(jm.current_info[k]), rtol=1e-4,
                                       atol=1e-8, err_msg=f"{k} step {c}")
    _check_state(jm, tm, tm.learning_rate)


@pytest.mark.parametrize("cls", ["WGAN", "LSGAN"])
def test_jax_gan_checkpoint_continues_in_port(cpu_group, tmp_path, cls):
    """The JAX package trains 3 steps at ``n_critic`` 2 and saves; the port
    (another seed) loads it: params, optimizer state (Adam's per-leaf
    counts: G 1, D 3) and G's BN state exactly the JAX state.  Both take
    step 4 (a G step): as the trajectory test holds them."""
    jm = _jax(cls, n_critic=2)
    tm = _port(cls, n_critic=2, seed=77)
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    jm.data.shuffle_data(0)
    for c in (1, 2, 3):
        jm.train_iter(c)
    d = str(tmp_path / "jax_ckpt")
    jm.save(d, epoch=0, count=3)
    assert convert.checkpoint_from_jax(d, tm) == 0
    st = jax.tree.map(lambda a: np.asarray(a)[0],
                      jax.device_get(jm.step_state))
    want = convert.params_from_jax(st["params"])
    for p in TH.leaf_paths(want):
        np.testing.assert_array_equal(TH.get_leaf(tm.host_params(), p),
                                      TH.get_leaf(want, p))
    for p in TH.leaf_paths(st["bn_state"]):
        np.testing.assert_array_equal(TH.get_leaf(tm.bn_state, p).numpy(),
                                      TH.get_leaf(st["bn_state"], p))
    if cls == "LSGAN":
        t = tm.opt_state["t"]
        assert {int(c) for c in TH.tree_leaves(t["G"])} == {1}
        assert {int(c) for c in TH.tree_leaves(t["D"])} == {3}
        assert t["G"]["up1"]["w"] is not t["D"]["c1"]["w"]
    feed_jax_z(tm, jm)
    jm.train_iter(4)
    tm.train_iter(4)
    np.testing.assert_allclose(float(tm.current_info["cost"]),
                               float(jm.current_info["cost"]), rtol=1e-4,
                               atol=1e-8)
    _check_state(jm, tm, tm.learning_rate)


# -- 2 gloo ranks -------------------------------------------------------------

ENV = {"OMP_NUM_THREADS": "1",
       "PYTHONPATH": os.pathsep.join([HERE, os.path.dirname(HERE)])}
_WORLD = {}


def _jax_train(jm, rule_ex=None):
    """One epoch as the port's worker drives it: the shuffle of epoch 0
    (``seed``), each step, the rule's exchange hook after it."""
    jm.data.shuffle_data(jm.seed)
    for count in range(1, jm.data.n_batch_train + 1):
        jm.train_iter(count)
        jm.exchanger.exchange(None, count)


def _jax_cfg(case):
    rule, _, _, cfg = lh.GAN_LM_CASES[case]
    cfg = {k: v for k, v in cfg.items() if k != "compute_dtype"}
    return rule, dict(cfg, n_workers=2, rule=rule.lower(), verbose=False,
                      compute_dtype=jnp.float32, attn_impl="reference")


def _powersgd_npz(jm, cfg, path, case) -> str:
    """The JAX model's initial PowerSGD state (rank 0's row: every rank's
    is the same) in the port's order and layouts, as an npz the helper's
    ``MoELMFrom`` loads; returns its config item."""
    from theanompi_tpu_torch.models.transformer_lm import MoETransformerLM
    like = MoETransformerLM(dict(cfg, device="cpu", verbose=False))
    jst = jax.tree.map(lambda v: np.asarray(v)[0],
                       jax.device_get(jm.step_state["extra"]["strat"]))
    st = convert.powersgd_state_from_jax(jst, _host(jm.params), like.params,
                                         like.kept_layout_paths())
    np.savez(str(path), **{f"{i}/{k}": v for i, s in enumerate(st)
                           for k, v in s.items()})
    return f"strat_{case}={path}"


def gan_lm_world(tmp_path_factory, cases):
    """Every rank's results of the ``gan_lm`` helper mode at 2 ranks for
    ``cases``, from the JAX twins' weights and noise, and the trained JAX
    twins; one launch, cached (``test_torch_moe.py`` launches its own)."""
    if cases not in _WORLD:
        from theanompi_tpu.models.transformer_lm import MoETransformerLM
        from theanompi_tpu.parallel.exchanger import get_exchanger
        mp = pytest.MonkeyPatch()
        for k, v in ENV.items():
            mp.setenv(k, v)
        tmp = tmp_path_factory.mktemp("gan_lm_" + "_".join(cases))
        args, jax_models = [f"helper_cases={','.join(cases)}"], {}
        for case in cases:
            rule, cls, key, cfg = lh.GAN_LM_CASES[case]
            _, jcfg = _jax_cfg(case)
            jcls = MoETransformerLM if key == "moe" else getattr(
                JG, cls.replace("From", ""))
            jm = jcls(jcfg)
            if f"init_{key}" not in [a.split("=")[0] for a in args]:
                kept = frozenset()
                if key == "moe":
                    from theanompi_tpu_torch.models.transformer_lm import \
                        MoETransformerLM as TM
                    kept = TM(dict(cfg, device="cpu",
                                   verbose=False)).kept_layout_paths()
                init = convert.params_from_jax(_host(jm.params), kept)
                npz = str(tmp / f"init_{key}.npz")
                np.savez(npz, **{"/".join(p): TH.get_leaf(init, p)
                                 for p in TH.leaf_paths(init)})
                args.append(f"init_{key}={npz}")
                if key != "moe":
                    zn = str(tmp / f"z_{key}.npz")
                    n = jm.data.n_batch_train
                    np.savez(zn, **{f"{r}/{c}": jax_z(jm.seed, r, c,
                                                      cfg["batch_size"],
                                                      cfg["z_dim"])
                                    for r in (0, 1) for c in range(1, n + 1)})
                    args.append(f"z_{key}={zn}")
            jm.compile_iter_fns(get_exchanger(rule.lower(), jm.config))
            if jcfg.get("exch_strategy", "").startswith("powersgd"):
                args.append(_powersgd_npz(jm, cfg, tmp / f"{case}.npz",
                                          case))
            _jax_train(jm)
            jax_models[case] = jm
        out = str(tmp / "g")
        try:
            rc = lh.launch("bsp", "-", 2, "device=cpu", "helper_mode=gan_lm",
                           f"helper_out={out}", "epochs=1", "scale_lr=false",
                           *args, timeout_s=240)
        finally:
            mp.undo()
        assert rc == 0
        ranks = []
        for r in range(2):
            with np.load(f"{out}_r{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        _WORLD[cases] = (ranks, jax_models)
    return _WORLD[cases]


def check_world_case(ranks, jm, case, kept=frozenset(), atol_p=1e-4):
    """Each rank's params (rtol 1e-4 / atol ``atol_p``), optimizer state
    (every entry within 1e-2, 99% within 1e-4, of the moment tree's largest
    entry, plus rtol 1e-3) and BN state (rtol 1e-4) against the JAX worker
    of that rank."""
    st = jax.device_get(jm.step_state)
    for r, got in enumerate(ranks):
        row = jax.tree.map(lambda a: np.asarray(a)[r], st)
        for part, tree in (("params", convert.params_from_jax(
                row["params"], kept)), ("bn", row["bn_state"])):
            for p in TH.leaf_paths(tree):
                k = f"{case}/{part}/" + "/".join(p)
                np.testing.assert_allclose(got[k], TH.get_leaf(tree, p),
                                           rtol=1e-4, atol=atol_p,
                                           err_msg=f"rank {r} {k}")
        opt = row["opt_state"]
        subs = {"": opt} if "t" not in opt else {
            "m/": opt["m"], "v/": opt["v"]}
        for pre, sub in subs.items():
            sub = convert.params_from_jax(sub, kept)
            _assert_tree_close(
                [(p, got[f"{case}/opt/{pre}" + "/".join(p)],
                  TH.get_leaf(sub, p)) for p in TH.leaf_paths(sub)],
                f"rank {r} {case} opt {pre}", 1e-2 * _scale(sub),
                1e-4 * _scale(sub), 1e-3)
        if "t" in opt:
            for p in TH.leaf_paths(opt["t"]):
                k = f"{case}/opt/t/" + "/".join(p)
                assert int(got[k]) == int(TH.get_leaf(opt["t"], p)), k


@pytest.mark.parametrize("case", ["wgan_bsp", "lsgan_gosgd"])
def test_gan_two_ranks_match_jax_workers(case, tmp_path_factory):
    """WGAN under BSP (the replicas identical) and LSGAN under GoSGD at
    ``exch_prob`` 1.0 (each rank its own replica, G's Adam counts lagging
    D's), one epoch of 4 steps at ``n_critic`` 2 on 2 gloo ranks, against
    the JAX workers on a 2-device mesh, each rank fed its JAX noise."""
    ranks, jms = gan_lm_world(tmp_path_factory, ("wgan_bsp", "lsgan_gosgd"))
    check_world_case(ranks, jms[case], case, atol_p=1e-3 * (
        1 if case == "wgan_bsp" else 2))
    if case == "wgan_bsp":
        for k in ranks[0]:
            if k.startswith(case):
                np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                              err_msg=k)
