"""Cifar10 and the CNN zoo of the port against the JAX package.

* Parameter counts of full-width GoogLeNet, ResNet-50 and Cifar10 against
  ``model_param_counts.json``.
* Full-width GoogLeNet (crop 80, the smallest side whose aux heads pool a
  window, batch 2): eval logits, the eval cost, the training cost with both
  aux heads (0.3 each) and every parameter's gradient.
* Full-width ResNet-50, batch 2: eval logits from non-trivial running
  stats (crop 32), and one training forward's cost and updated running
  state (crop 64).
* ``Cifar10_model``: 3 BSP steps against the JAX package's; its synthetic
  set, and a set read from pickle files the test writes, bit-equal to the
  JAX package's, rank by rank.
* The entry points: ``BSP().init(..., modelfile='theanompi_tpu_torch.
  models.googlenet' | '...resnet50' | '...cifar10')`` trains on the CPU
  when asked to, and refuses without a card otherwise; the registry and
  the VGG-11 alias module.

Both packages run from the same numpy-seeded weights (a JAX twin whose
``init_params`` draws them with numpy; ``convert.params_from_jax`` and
``convert.bn_state_from_jax`` carry them to the port), float32, dropout
rates zeroed in both (the packages draw different dropout bits).
Tolerances: logits rtol 1e-4 / atol 1e-5·max|logit|, costs rtol 1e-4,
gradients rtol 1e-4 / atol 1e-5·max|leaf|, BN state rtol 1e-4 / atol
1e-4·max|leaf|: float32 through 22 (GoogLeNet) and 53 (ResNet-50) layers
whose sums run in another order in XLA and oneDNN.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import registry as JREG
from theanompi_tpu.models.cifar10 import Cifar10_model as JCifar
from theanompi_tpu.models.data.cifar10 import Cifar10_data as JCifarData
from theanompi_tpu.models.googlenet import GoogLeNet as JGoogLeNet
from theanompi_tpu.models.resnet50 import ResNet50 as JResNet50
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models import registry as TREG
from theanompi_tpu_torch.models.cifar10 import Cifar10_model as TCifar
from theanompi_tpu_torch.models.data.cifar10 import \
    Cifar10_data as TCifarData
from theanompi_tpu_torch.models.googlenet import GoogLeNet as TGoogLeNet
from theanompi_tpu_torch.models.resnet50 import ResNet50 as TResNet50
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import cpu_group  # noqa: E402,F401

CFG = {"batch_size": 2, "synthetic_batches": 1, "synthetic_val_batches": 1,
       "verbose": False}


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def numpy_params(shapes, seed):
    """A JAX-layout params tree of ``shapes`` drawn with numpy: He-normal
    weights (fan-in over all dims but the last), biases 0.1·N(0, 1),
    BatchNorm scales 1 + 0.1·N(0, 1)."""
    r = np.random.RandomState(seed)

    def draw(path, s):
        if len(s.shape) >= 2:
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (r.randn(*s.shape) * std).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * r.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def numpy_init(cls):
    """The JAX model class with its weights drawn by :func:`numpy_params`
    (the same tree, without a compile per weight shape)."""
    class Twin(cls):
        def init_params(self, key):
            return numpy_params(jax.eval_shape(super().init_params, key), 0)
    return Twin


def _zero_dropout(layers):
    for layer in layers:
        _zero_dropout(getattr(layer, "layers", ()))
        if type(layer).__name__ == "Dropout":
            layer.rate = 0.0


def _pair(jcls, tcls, **cfg):
    jm = numpy_init(jcls)(dict(CFG, **cfg, n_workers=1,
                               compute_dtype=jnp.float32))
    tm = tcls(dict(CFG, **cfg, device="cpu", compute_dtype="float32"))
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    return jm, tm


def _close(got, want, rtol, atol_frac, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max(),
                               err_msg=what)


def _batch(hw, seed):
    r = np.random.RandomState(seed)
    x = r.randn(2, hw, hw, 3).astype(np.float32)
    y = r.randint(0, 1000, 2).astype(np.int32)
    return x, y


def test_param_counts_match_the_recorded_counts():
    want = json.load(open(os.path.join(REPO, "model_param_counts.json")))
    for name, cls, cfg in (("googlenet", TGoogLeNet, CFG),
                           ("resnet50", TResNet50, CFG),
                           ("cifar10", TCifar, {"synthetic_train": 256})):
        m = cls(dict(cfg, device="cpu", verbose=False))
        n = sum(p.numel() for p in TH.tree_leaves(m.params))
        assert n == want[name]["params"], name


def test_googlenet_full_width_matches_jax():
    """Crop 80 (aux side ⌈80/16⌉ = 5 → one 5×5/3 window), batch 2:
    eval logits, the eval cost (main head only), the training cost (main
    + 0.3·(aux1 + aux2)) and the gradient of every parameter, the aux
    heads' included."""
    jm, tm = _pair(JGoogLeNet, TGoogLeNet, crop_size=80)
    _zero_dropout(jm._parts.values())
    _zero_dropout(tm.layers().values())
    assert sorted(TH.jax_leaf_paths(tm.params)) == \
        sorted(TH.jax_leaf_paths(_host(jm.params)))
    x, y = _batch(80, 0)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jl = jax.jit(lambda p: jm.apply_model(p, jb["x"], train=False, rng=None,
                                          state={})[0])(jm.params)
    with torch.no_grad():
        tl = tm.apply_model(tm.params, tb["x"], train=False, gen=None,
                            state=tm.bn_state)
        tc_eval, _ = tm.loss_and_metrics(tm.params, tm.bn_state, tb, None,
                                         False)
    assert tl.shape == (2, 1000)
    _close(tl.numpy(), jl, 1e-4, 1e-5, "logits")
    jc_eval, _ = jax.jit(lambda p: jm.loss_and_metrics(
        p, {}, jb, None, False))(jm.params)
    np.testing.assert_allclose(float(tc_eval), float(jc_eval), rtol=1e-4)

    (jc, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_and_metrics(p, {}, jb, None, True),
        has_aux=True))(jm.params)
    tc, _ = tm.loss_and_metrics(tm.params, tm.bn_state, tb, None, True)
    grads = torch.autograd.grad(tc, TH.tree_leaves(tm.params))
    np.testing.assert_allclose(float(tc.detach()), float(jc), rtol=1e-4)
    assert float(tc.detach()) > float(tc_eval) + 0.3   # the aux terms
    it = iter(grads)
    tg = TH.tree_map(lambda _: next(it).numpy(), tm.params)
    wg = convert.params_from_jax(_host(jg))
    for path in TH.jax_leaf_paths(wg):
        _close(TH.get_leaf(tg, path), TH.get_leaf(wg, path), 1e-4, 1e-5,
               "d " + "/".join(path))


def _random_bn_state(tree, r):
    if set(tree) == {"mean", "var"}:
        return {"mean": (0.1 * r.randn(*tree["mean"].shape)).astype(
                    np.float32),
                "var": r.uniform(0.5, 2.0, tree["var"].shape).astype(
                    np.float32)}
    return {k: _random_bn_state(v, r) for k, v in tree.items()}


def test_resnet50_full_width_matches_jax():
    """Eval logits at crop 32 from running stats drawn from a seed (mean
    0.1·N(0, 1), var U(0.5, 2)) set in both packages; then one training
    forward at crop 64: its cost, and every BatchNorm's updated running
    state.  The training forward runs at 64, not 32: at crop 32 res5's
    BatchNorms see 2 values a channel (batch 2 × 1 × 1), and normalize each
    to ±1 by the sign of their difference, which float32 noise flips where
    the two are within rounding of each other; at 64 they see 8."""
    jm, tm = _pair(JResNet50, TResNet50)
    jbn = _random_bn_state(_host(jm.bn_state), np.random.RandomState(5))
    tm.load_bn_state(convert.bn_state_from_jax(jbn))
    assert TH.jax_leaf_paths(tm.host_bn_state()) == TH.jax_leaf_paths(jbn)
    assert len(TH.tree_leaves(jbn)) == 2 * 53
    x, _ = _batch(32, 1)
    jl = jax.jit(lambda p, s: jm.apply_model(p, jnp.asarray(x), train=False,
                                             rng=None, state=s)[0])(
        jm.params, jbn)
    with torch.no_grad():
        tl = tm.apply_model(tm.params, torch.from_numpy(x), train=False,
                            gen=None, state=tm.bn_state)
    _close(tl.numpy(), jl, 1e-4, 1e-5, "logits")

    x, y = _batch(64, 2)
    jc, (_, jnew) = jax.jit(lambda p, s: jm.loss_and_metrics(
        p, s, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, None, True))(
        jm.params, jbn)
    with torch.no_grad():
        tc, _ = tm.loss_and_metrics(tm.params, tm.bn_state,
                                    {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y)}, None, True)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)
    want = convert.bn_state_from_jax(_host(jnew))
    got = tm.host_bn_state()
    for path in TH.jax_leaf_paths(want):
        _close(TH.get_leaf(got, path), TH.get_leaf(want, path), 1e-4, 1e-4,
               "/".join(path))
        assert not np.array_equal(TH.get_leaf(got, path),
                                  TH.get_leaf(jbn, path))


def test_resnet50_bn_norm_dtype_selects_the_folded_path():
    """``bn_norm_dtype`` reaches every BatchNorm, as in the JAX package
    (``'none'`` and no key: float32 normalization)."""
    def bns(m):
        out = []

        def walk(layer):
            if type(layer).__name__ == "BatchNorm":
                out.append(layer)
            for sub in layer.sublayers().values():
                walk(sub)
        walk(m.trunk)
        return out

    for nd, want in (("bfloat16", torch.bfloat16), ("none", None),
                     (None, None)):
        cfg = dict(CFG, device="cpu")
        if nd is not None:
            cfg["bn_norm_dtype"] = nd
        layers = bns(TResNet50(cfg))
        assert len(layers) == 53
        assert {b.norm_dtype for b in layers} == {want}


# -- Cifar10 -------------------------------------------------------------------

CIFAR = {"batch_size": 32, "synthetic_train": 96, "synthetic_val": 32,
         "verbose": False}


def test_cifar10_three_steps_match_jax(cpu_group):
    """3 BSP steps at world 1, float32, dropout zeroed: each cost rtol
    1e-5, then params and velocity rtol 1e-5 / atol 1e-6 (the plain CNNs'
    trajectory bounds: no BatchNorm, sums in another order)."""
    jm = JCifar(dict(CIFAR, n_workers=1, compute_dtype=jnp.float32))
    tm = TCifar(dict(CIFAR, device="cpu", compute_dtype="float32"))
    _zero_dropout(jm.seq.layers)
    _zero_dropout(tm.seq.layers)
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]),
                                   rtol=1e-5)
    want = convert.params_from_jax(_host(jm.canonical_host_params()))
    vel = convert.params_from_jax(jax.tree.map(
        lambda v: np.asarray(v)[0],
        jax.device_get(jm.step_state["opt_state"])))
    got = tm.host_params()
    for path in TH.jax_leaf_paths(want):
        np.testing.assert_allclose(TH.get_leaf(got, path),
                                   TH.get_leaf(want, path), rtol=1e-5,
                                   atol=1e-6, err_msg="/".join(path))
        np.testing.assert_allclose(TH.get_leaf(tm.opt_state, path).numpy(),
                                   TH.get_leaf(vel, path), rtol=1e-5,
                                   atol=1e-6, err_msg="/".join(path))


def _same_data(cfg, size=1, b=8):
    """Rank r's batches are rows r·b..(r+1)·b of the JAX package's global
    batch, after the same shuffle, bit for bit; the set and its mean too."""
    jd = JCifarData(dict(cfg, size=size, process_count=1, process_index=0),
                    b)
    jd.shuffle_data(3)
    ref = [jd.next_train_batch(1), jd.next_train_batch(2),
           jd.next_val_batch(0)]
    for r in range(size):
        td = TCifarData(dict(cfg, size=size, rank=r), b)
        assert td.synthetic == jd.synthetic
        for k in ("x_train", "y_train", "x_val", "y_val", "mean"):
            np.testing.assert_array_equal(getattr(td, k), getattr(jd, k))
        td.shuffle_data(3)
        got = [td.next_train_batch(1), td.next_train_batch(2),
               td.next_val_batch(0)]
        for g, e in zip(got, ref):
            for k in ("x", "y"):
                np.testing.assert_array_equal(g[k], e[k][r * b:(r + 1) * b])


@pytest.mark.parametrize("size", [1, 2])
def test_cifar10_synthetic_set_is_jax_bit_for_bit(size):
    _same_data({"synthetic_train": 64, "synthetic_val": 32}, size)


def _write_pickles(d, n=20, seed=0):
    r = np.random.RandomState(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        b = {b"data": r.randint(0, 256, (n, 3 * 32 * 32), dtype=np.uint8),
             b"labels": [int(v) for v in r.randint(0, 10, n)]}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(b, f)


@pytest.mark.parametrize("how", ["data_dir", "env"])
def test_cifar10_pickle_files_read_as_jax(tmp_path, monkeypatch, how):
    """The ``cifar-10-batches-py`` layout (5 training pickles and a test
    pickle, rows of 3·32·32 uint8 CHW), found through ``data_dir`` or
    ``$CIFAR10_DIR``: images, labels, mean and batches bit-equal to the
    JAX package's, at 2 ranks."""
    _write_pickles(str(tmp_path))
    cfg = {}
    if how == "data_dir":
        cfg["data_dir"] = str(tmp_path)
    else:
        monkeypatch.setenv("CIFAR10_DIR", str(tmp_path))
    td = TCifarData(dict(cfg), 8)
    assert not td.synthetic and td.x_train.shape == (100, 32, 32, 3)
    _same_data(cfg, size=2)


# -- entry points, registry, alias ---------------------------------------------

@pytest.mark.parametrize("modelfile,modelclass,cfg", [
    ("cifar10", "Cifar10_model", {"batch_size": 16, "synthetic_train": 32,
                                  "synthetic_val": 16}),
    ("googlenet", "GoogLeNet", {"batch_size": 2, "synthetic_batches": 1,
                                "n_class": 10}),
    ("resnet50", "ResNet50", {"batch_size": 2, "synthetic_batches": 1,
                              "n_class": 10, "learning_rate": 0.01}),
    ("resnet50", "ResNet50", {"batch_size": 2, "synthetic_batches": 1,
                              "n_class": 10, "learning_rate": 0.01,
                              "bn_norm_dtype": "bfloat16"})])
def test_bsp_session_trains_the_zoo_on_the_cpu(modelfile, modelclass, cfg):
    """One epoch through ``BSP().init(devices=1, modelfile=...)`` with
    ``device='cpu'`` (bf16 compute, the models' defaults; ResNet-50 with
    both BatchNorm normalize dtypes): finite costs, and a ResNet's
    running state moved off its init."""
    rule = helper.run_session(modelclass, 1,
                              modelfile=f"theanompi_tpu_torch.models."
                                        f"{modelfile}",
                              synthetic_val_batches=1, **cfg)
    rec = rule.recorder
    costs = [r["cost"] for r in rec.train_records] + \
        [r["val_cost"] for r in rec.epoch_records]
    assert costs and np.all(np.isfinite(costs)), costs
    means = [s["mean"] for s in _bn_layers(rule.model.bn_state)]
    assert (len(means) == 53) == (modelclass == "ResNet50")
    assert all(bool(m.abs().sum() > 0) for m in means)


def _bn_layers(tree):
    if "mean" in tree:
        return [tree]
    return [s for v in tree.values() for s in _bn_layers(v)]


@pytest.mark.parametrize("cls", [TGoogLeNet, TResNet50, TCifar])
def test_the_zoo_refuses_without_a_card(cls):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        cls({"verbose": False, "synthetic_batches": 1,
             "synthetic_train": 256})


def test_registry_names_the_ports_modules():
    """The JAX registry's names, less the model the port lacks; each entry
    imports and names a model class."""
    import importlib
    assert set(TREG.MODELS) == set(JREG.MODELS) - {"moe_lm"}
    for name, (modfile, cls, extra) in TREG.MODELS.items():
        jfile, jcls, jextra = JREG.MODELS[name]
        assert modfile == jfile.replace("theanompi_tpu.",
                                        "theanompi_tpu_torch.")
        assert (cls, extra) == (jcls, jextra)
        assert isinstance(getattr(importlib.import_module(modfile), cls),
                          type)


def test_vggnet_11_shallow_alias_module():
    from theanompi_tpu_torch.models import vggnet_11_shallow, vggnet_16
    assert vggnet_11_shallow.VGGNet_11_shallow is vggnet_16.VGGNet_11_shallow
