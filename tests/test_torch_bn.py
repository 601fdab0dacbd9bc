"""SAME pooling, BatchNorm and its running state in the port's step,
exchanger and checkpoints, against the JAX package.

* ``Pool`` with SAME windows, max and average, against the JAX layer at
  sizes whose XLA pad total is odd and even, with a low pad above 0 and
  windows larger than the stride: forward and input gradient.
* ``BatchNorm`` in train and eval mode, normalizing in float32
  (``norm_dtype=None``), folded in float32 (``norm_dtype`` float32 on a
  float32 input: the folded arithmetic at float32 precision) and folded in
  bfloat16: output, gradients and the running-stat update.
* A narrow ResNet (``torch_port_helper.TinyResNet``: ResNet-50's layers,
  two bottlenecks, 9 BatchNorms) under BSP at world 1 against the JAX
  package's trajectory with ``n_subb = 2`` (3 steps) and
  ``steps_per_call = 2`` (2 calls, 4 steps): costs, params, velocity and
  the BN running state.
* BSP at 2 gloo ranks: the running state bit-identical on both ranks and
  equal to the mean of the two ranks' own stats; ``save`` → ``load`` bit
  for bit; a checkpoint the JAX package wrote (allreduce, where the BN
  state is stored once, and onebit, where it is stored per worker) loaded
  by ``convert.checkpoint_from_jax`` and stepped on.

Everything is float32 unless a case says bfloat16; tolerances are stated
per test.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import layers as JL
from theanompi_tpu.models.resnet50 import ResNet50 as JResNet50
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models import layers as TL
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyData, cpu_group  # noqa: E402,F401
from test_torch_layers import _check, _x  # noqa: E402


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# -- SAME pooling --------------------------------------------------------------

# (input h, w, window, stride): the XLA SAME pads (low, high) per side are
# (1, 1) at 7/3/2, (0, 1) at 8/3/2 (odd total), (1, 1) at 9/3/1 (the
# inception pool), (2, 2) at 13/5/2, (1, 2) at 6/4/1 (odd total, low > 0),
# (0, 1) at 12/4/3, and 7×10 at 3/2 pads (1, 1) × (0, 1)
POOL_CASES = [(7, 7, 3, 2), (8, 8, 3, 2), (9, 9, 3, 1), (13, 13, 5, 2),
              (6, 6, 4, 1), (12, 12, 4, 3), (7, 10, 3, 2)]


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("h,w,k,s", POOL_CASES)
def test_same_pool_matches_jax(mode, h, w, k, s):
    """Forward and input gradient at rtol/atol 1e-5 (float32; the average
    sums its window in another order).  The inputs have no ties, so the max
    pool's gradient lands on the same element in both packages."""
    _check(JL.Pool(k, s, mode=mode, padding="SAME"),
           TL.Pool(k, s, mode=mode, padding="SAME"), _x((2, h, w, 5)))


def test_same_pool_keeps_nhwc_strides():
    """A padded max pool hands on an NHWC-contiguous tensor, so an LRN
    after it (GoogLeNet's stem) copies nothing."""
    x = torch.randn(2, 8, 8, 4)
    for k, s in ((3, 2), (3, 1)):
        assert TL.Pool(k, s, padding="SAME").apply(None, x).is_contiguous()


# -- BatchNorm -----------------------------------------------------------------

C = 6
# output, grads: float32 rtol 1e-4 / atol 1e-5; bfloat16 output and input
# gradient within two bf16 ulps (2^-7 relative, 2^-7 of the tensor's max
# absolute); the running state in float32 either way, rtol 1e-4 / atol 1e-6
BN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -7)}


def _bn_inputs(dtype, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(4, 5, 3, C) * 2.0 + 0.5).astype(np.float32)
    params = {"scale": (1.0 + 0.1 * r.randn(C)).astype(np.float32),
              "bias": (0.1 * r.randn(C)).astype(np.float32)}
    state = {"mean": (0.1 * r.randn(C)).astype(np.float32),
             "var": r.uniform(0.5, 2.0, C).astype(np.float32)}
    w = r.randn(*x.shape).astype(np.float32)
    return x, params, state, w


def _close(got, want, rtol, atol_frac, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_frac * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("nd", [None, "float32", "bfloat16"])
def test_batchnorm_matches_jax(nd, train):
    """Output, the gradients of ``sum(y·w)`` with respect to the input,
    ``scale`` and ``bias``, and (train) the updated running state, from the
    same params, state and input.  ``nd='bfloat16'`` runs on a bfloat16
    input (the folded bf16 path); the others on float32."""
    dt = "bfloat16" if nd == "bfloat16" else "float32"
    rtol, atol = BN_TOL[dt]
    x, params, state, w = _bn_inputs(dt)
    jl = JL.BatchNorm(C, norm_dtype=None if nd is None else
                      jnp.dtype(nd).type)
    tl = TL.BatchNorm(C, norm_dtype=nd)
    jx = jnp.asarray(x).astype(dt)

    def jloss(p, xx):
        y, new = jl.apply(p, xx, train=train, state=state)
        return jnp.sum(y.astype(jnp.float32) * w), (y, new)

    (_, (jy, jnew)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jx)

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tx = torch.from_numpy(x).to(TL.as_dtype(dt)).requires_grad_(True)
    ty = tl.apply(tp, tx, train=train, state=ts)
    assert ty.dtype == tx.dtype
    (ty.float() * torch.from_numpy(w)).sum().backward()
    _close(ty.detach().float(), jnp.asarray(jy, jnp.float32), rtol, atol, "y")
    _close(tx.grad.float(), jnp.asarray(gx, jnp.float32), rtol, atol, "dx")
    if dt == "float32":
        for k in params:
            _close(tp[k].grad, gp[k], rtol, atol, f"d{k}")
    else:
        # d(scale) and d(bias) sum 60 bf16 terms per channel, and XLA's CPU
        # reduction accumulates them in bf16: held to two bf16 ulps of the
        # sum of the terms' magnitudes, |w|·|x̂| and |w|
        xs = x.astype(np.float32)
        m, v = (xs.mean((0, 1, 2)), xs.var((0, 1, 2))) if train else \
            (state["mean"], state["var"])
        xhat = (xs - m) / np.sqrt(v + 1e-5)
        for k, terms in (("scale", np.abs(w * xhat)), ("bias", np.abs(w))):
            bound = 2.0 ** -7 * terms.sum((0, 1, 2))
            diff = np.abs(tp[k].grad.numpy() - np.asarray(gp[k]))
            assert (diff <= bound).all(), (k, diff, bound)
    if train:
        for k in state:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(jnew[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            assert not np.array_equal(ts[k].numpy(), state[k])
    else:
        assert jnew is None
        for k in state:                # eval reads the state, writes nothing
            np.testing.assert_array_equal(ts[k].numpy(), state[k])


def test_batchnorm_updates_its_state_in_place():
    """A training forward rewrites the running-stat tensors it was given
    (the same storage, as a captured step needs) and records nothing for
    autograd on them."""
    x, params, state, _ = _bn_inputs("float32")
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    TL.BatchNorm(C).apply(tp, torch.from_numpy(x).requires_grad_(True),
                          train=True, state=ts)
    for k, v in ts.items():
        assert v.data_ptr() == ptrs[k] and not v.requires_grad
        assert v.grad_fn is None


# -- a narrow ResNet under BSP -------------------------------------------------

class _JTinyResNet(JResNet50):
    """The JAX twin of ``torch_port_helper.TinyResNet``."""

    stages = helper.TinyResNet.stages
    batch_size = 8
    epochs = 1
    learning_rate = 0.01
    seed = 13

    def build_model(self):
        self.config.setdefault("compute_dtype", jnp.float32)
        self.config.setdefault("n_class", helper.N_CLASS)
        super().build_model()
        self.data = _JTinyData(self.config, self.batch_size)


def _jax_row(jm, part):
    return jax.tree.map(lambda v: np.asarray(v)[0],
                        jax.device_get(jm.step_state[part]))


def _pair(**cfg):
    jm = _JTinyResNet(dict(cfg, n_workers=1, verbose=False))
    tm = helper.TinyResNet(dict(cfg, device="cpu", verbose=False))
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    return jm, tm


def _check_state(jm, tm, rtol=1e-4, atol=1e-5):
    """params, velocity and the BN state, leaf by leaf (JAX paths)."""
    want = convert.params_from_jax(_host(jm.canonical_host_params()))
    got = tm.host_params()
    vel = convert.params_from_jax(_jax_row(jm, "opt_state"))
    bn = convert.bn_state_from_jax(_jax_row(jm, "bn_state"))
    assert TH.jax_leaf_paths(bn) == TH.jax_leaf_paths(tm.bn_state)
    for path in TH.jax_leaf_paths(want):
        name = "/".join(path)
        np.testing.assert_allclose(TH.get_leaf(got, path),
                                   TH.get_leaf(want, path), rtol=rtol,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(TH.get_leaf(tm.opt_state, path).numpy(),
                                   TH.get_leaf(vel, path), rtol=rtol,
                                   atol=atol, err_msg=f"velocity {name}")
    for path in TH.jax_leaf_paths(bn):
        np.testing.assert_allclose(TH.get_leaf(tm.bn_state, path).numpy(),
                                   TH.get_leaf(bn, path), rtol=1e-4,
                                   atol=1e-6, err_msg="/".join(path))


@pytest.mark.parametrize("cfg,counts", [
    ({"n_subb": 2}, (1, 2, 3)),
    ({"steps_per_call": 2}, (2, 4))])
def test_narrow_resnet_trajectory_matches_jax(cpu_group, cfg, counts):
    """Both packages from the same weights and data: each call's mean cost
    to rtol 1e-5; at the end params and velocity to rtol 1e-4 / atol 1e-5,
    the BN running state to rtol 1e-4 / atol 1e-6.  float32; the sums run in
    another order, and BatchNorm over 2–32 elements a channel divides by
    small standard deviations, so the params get the BN tier (1e-4), not
    the plain CNNs' 1e-5.  ``n_subb = 2`` threads the running state
    through both micro-batches of each step, in order."""
    jm, tm = _pair(**cfg)
    bn0 = [t.clone() for t in TH.tree_leaves(tm.bn_state)]
    for count in counts:
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(np.asarray(jm.current_info["cost"])),
                                   rtol=1e-5)
    assert all(not torch.equal(a, b) for a, b in
               zip(bn0, TH.tree_leaves(tm.bn_state)))
    _check_state(jm, tm)


def test_narrow_resnet_validation_reads_the_running_stats(cpu_group):
    """After two steps, a validation batch scores with the running stats:
    cost and errors as the JAX package's to rtol 1e-4, and the state
    unchanged by it."""
    jm, tm = _pair()
    for c in (1, 2):
        jm.train_iter(c)
        tm.train_iter(c)
    before = [t.clone() for t in TH.tree_leaves(tm.bn_state)]
    tm.val_iter(0)
    batch = tm.data.next_val_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jc, (je, _) = jm.val_metrics(jm.canonical_host_params(),
                                 jax.tree.map(jnp.asarray,
                                              _jax_row(jm, "bn_state")), jb)
    with torch.no_grad():
        tc, (te, _) = tm.val_metrics(tm.params, tm.bn_state,
                                     {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)
    assert float(te) == float(je)
    assert all(torch.equal(a, b) for a, b in
               zip(before, TH.tree_leaves(tm.bn_state)))


def test_bn_state_is_step_state(cpu_group):
    """The captured step's identity check covers the BN tensors, so a load
    that replaced one would capture again."""
    tm = helper.TinyResNet({"device": "cpu", "verbose": False})
    tm.compile_iter_fns(capture=True)
    leaves = tm.train_fn._state_leaves()
    for t in TH.tree_leaves(tm.bn_state):
        assert any(t is s for s in leaves)
    assert len(TH.tree_leaves(tm.bn_state)) == 18


def test_bn_state_identical_across_two_gloo_ranks(tmp_path):
    """Two ranks train one epoch (3 steps) of the narrow ResNet on the two
    halves of each batch: after each step's ``sync_bn`` the running state
    is bit-identical on both ranks and, at the last step, bit for bit the
    float32 mean ``(a + b) / 2`` of the two ranks' own stats, which
    differ; the params stay identical too."""
    r0, r1 = helper.run_ranks("train", 2, tmp_path, "bn", 8, "TinyResNet")
    assert sorted(r0) == sorted(r1)
    bn = sorted(k for k in r0 if k.startswith("bn/"))
    assert len(bn) == 18
    for k in r0:
        if not k.startswith("bn_local/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for k in bn:
        a, b = r0["bn_local/" + k[3:]], r1["bn_local/" + k[3:]]
        assert not np.array_equal(a, b), k
        np.testing.assert_array_equal(r0[k], (a + b) / np.float32(2),
                                      err_msg=k)


def test_save_load_round_trip_with_bn_state(cpu_group, tmp_path):
    """Two steps, a checkpoint, and a fresh model (another seed) loading it:
    params, velocity and the BN state bit for bit, written into the
    tensors the model already had; the next step of both bit for bit."""
    a = helper.TinyResNet({"device": "cpu", "verbose": False})
    a.compile_iter_fns()
    a.data.shuffle_data(0)
    for c in (1, 2):
        a.train_iter(c)
    a.save(str(tmp_path), 0, 2)
    b = helper.TinyResNet({"device": "cpu", "verbose": False, "seed": 77})
    b.compile_iter_fns()
    ids = [id(t) for t in TH.tree_leaves(b.bn_state)]
    assert b.load(str(tmp_path)) == 0
    assert ids == [id(t) for t in TH.tree_leaves(b.bn_state)]
    sa, sb = helper.state_arrays(a), helper.state_arrays(b)
    assert sorted(sa) == sorted(sb) and any(k.startswith("bn/") for k in sa)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    a.train_iter(3)
    b.train_iter(3)
    assert float(a.current_info["cost"]) == float(b.current_info["cost"])
    sa, sb = helper.state_arrays(a), helper.state_arrays(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["allreduce", "onebit"])
def test_jax_resnet_checkpoint_loads_and_continues(cpu_group, tmp_path,
                                                   strategy):
    """The JAX package trains the narrow ResNet 2 steps and saves (its BN
    state once under allreduce, per worker under onebit); the port loads it
    into a model of another seed: params, velocity and BN state exactly the
    JAX state.  Both take step 3: cost rtol 1e-5; params, velocity and BN
    state as the trajectory test holds them."""
    cfg = {"exch_strategy": strategy}
    jm = _JTinyResNet(dict(cfg, n_workers=1, verbose=False))
    tm = helper.TinyResNet(dict(cfg, device="cpu", verbose=False, seed=77))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    jm.data.shuffle_data(1)
    for c in (1, 2):
        jm.train_iter(c)
    d = str(tmp_path / "jax_ckpt")
    jm.save(d, epoch=0, count=2)
    assert convert.checkpoint_from_jax(d, tm) == 0
    bn = convert.bn_state_from_jax(_jax_row(jm, "bn_state"))
    for path in TH.jax_leaf_paths(bn):
        np.testing.assert_array_equal(
            TH.get_leaf(tm.bn_state, path).numpy(), TH.get_leaf(bn, path))
    want = convert.params_from_jax(_host(jm.canonical_host_params()))
    for path in TH.jax_leaf_paths(want):
        np.testing.assert_array_equal(TH.get_leaf(tm.host_params(), path),
                                      TH.get_leaf(want, path))
    jm.train_iter(3)
    tm.train_iter(3)
    np.testing.assert_allclose(float(tm.current_info["cost"]),
                               float(jm.current_info["cost"]), rtol=1e-5)
    _check_state(jm, tm)
