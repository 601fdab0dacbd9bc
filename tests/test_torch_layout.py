"""Which 2-D leaves keep the JAX package's layout is the layer's to say.

A layer names the leaves it keeps (``Layer.kept_layout``: ``Embedding``'s
``w``, ``[vocab, dim]`` in both packages); the model collects their paths
(``ModelBase.kept_layout_paths``), and ``convert.py``, the topk wire and
PowerSGD take that set.  So the name of a layer decides nothing: here an
``FC`` named ``embed`` takes the transposed layout everywhere and an
``Embedding`` named ``tok`` keeps ``[vocab, dim]``, each against the JAX
package's own layout of the same layers (its ``flatten_tree``, its
PowerSGD state, the float64 PowerSGD exchange on its layout, and the jnp
topk oracles).  One case makes every matrix square, so that a wrong
orientation keeps every shape.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import layers as JL
from theanompi_tpu.ops import compress as JC
from theanompi_tpu.parallel import strategies as JS
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.model_base import ModelBase
from theanompi_tpu_torch.models.transformer_lm import TransformerLM
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_powersgd import _reference  # noqa: E402
from test_torch_vgg import cpu_group  # noqa: E402,F401

SHAPES = [(12, 16, 20), (16, 16, 16)]       # (vocab, dim, fc out)


class _Swapped(ModelBase):
    """An ``Embedding`` named ``tok`` and an ``FC`` named ``embed``."""

    def build_model(self):
        v, d, o = self.config["shape"]
        self.seq = L.Sequential([
            L.Embedding(v, d, compute_dtype="float32", name="tok"),
            L.FC(d, o, activation=None, compute_dtype="float32",
                 name="embed")])


def _models(shape):
    """The port's model and the JAX package's parameters of the same
    layers."""
    v, d, o = shape
    model = _Swapped({"shape": shape, "device": "cpu", "verbose": False})
    k1, k2 = jax.random.split(jax.random.key(7))
    jtree = {"tok": JL.Embedding(v, d, name="tok").init(k1),
             "embed": JL.FC(d, o, name="embed").init(k2)}
    return model, jax.tree.map(np.asarray, jtree)


def _port_tree(model, jtree):
    """``jtree`` in the port's layouts, as tensors in the model's leaf
    order (the strategies' state follows it)."""
    conv = convert.params_from_jax(jtree, model.kept_layout_paths())
    it = iter([torch.from_numpy(TH.get_leaf(conv, p))
               for p in TH.leaf_paths(model.params)])
    return TH.tree_map(lambda _: next(it), model.params)


def _exchanger(model, strategy):
    ex = BSP_Exchanger({"exch_strategy": strategy})
    ex.prepare(model, 1)
    return ex.strategy


def test_layers_declare_the_kept_leaves():
    model, _ = _models(SHAPES[0])
    assert model.kept_layout_paths() == {("tok", "w")}
    lm = TransformerLM({"device": "cpu", "verbose": False, "n_layer": 1,
                        "vocab": 32, "seq_len": 16, "d_model": 16,
                        "n_head": 2})
    assert lm.kept_layout_paths() == {("embed", "w"), ("pos", "w")}
    assert helper.TinyVGGNet({"device": "cpu", "verbose": False}) \
        .kept_layout_paths() == frozenset()
    assert _exchanger(model, "topk").kept_layout == {("tok", "w")}


@pytest.mark.parametrize("shape", SHAPES)
def test_convert_follows_the_layer_not_its_name(shape):
    """``params_from_jax`` with the model's set: the FC named ``embed``
    transposed, the table named ``tok`` as it is; the result loads into
    the model."""
    model, jtree = _models(shape)
    conv = convert.params_from_jax(jtree, model.kept_layout_paths())
    np.testing.assert_array_equal(conv["embed"]["w"], jtree["embed"]["w"].T)
    np.testing.assert_array_equal(conv["tok"]["w"], jtree["tok"]["w"])
    model.load_params(conv)
    assert model.params["embed"]["w"].shape == (shape[2], shape[1])


@pytest.mark.parametrize("shape", SHAPES)
def test_topk_wire_follows_the_layer_not_its_name(cpu_group, shape):
    """The topk strategy the exchanger prepares: its flat order is the JAX
    package's ``flatten_tree`` bit for bit, and one world-1 exchange is
    the jnp oracles' decode of their encode, state included."""
    model, jtree = _models(shape)
    kept = model.kept_layout_paths()
    strat = _exchanger(model, "topk")
    strat.chunk, strat.k = 64, 3
    r = np.random.RandomState(sum(shape))
    jgrads = jax.tree.map(lambda a: r.randn(*a.shape).astype(np.float32),
                          jtree)
    grads = _port_tree(model, jgrads)
    c = np.asarray(JH.flatten_tree(jgrads, pad_to_multiple_of=64))
    np.testing.assert_array_equal(
        TH.flatten_tree_jax(grads, 64, kept).numpy().view(np.int32),
        c.view(np.int32))
    state = strat.init_state(grads)
    wv, wi, wn = JC.topk_encode_jnp(jnp.asarray(c.reshape(-1, 64)), 3)
    want = np.asarray(JC.topk_decode_jnp(wv[None], wi[None], 64))
    mean, new = strat(grads, state, size=1)
    np.testing.assert_array_equal(new.numpy(), np.asarray(wn).reshape(-1))
    n = sum(a.size for a in jax.tree.leaves(jgrads))
    np.testing.assert_array_equal(TH.flatten_tree_jax(mean, 1, kept).numpy(),
                                  want[:n])


@pytest.mark.parametrize("shape", SHAPES)
def test_powersgd_follows_the_layer_not_its_name(cpu_group, shape):
    """The PowerSGD strategy the exchanger prepares: each leaf's ``q`` has
    the JAX package's shape, and one world-1 exchange from the JAX
    package's state is the float64 algorithm on the JAX layout (rtol 1e-4
    / atol 1e-5, as in ``test_torch_powersgd.py``), mean and ``e``."""
    model, jtree = _models(shape)
    kept = model.kept_layout_paths()
    strat = _exchanger(model, "powersgd1")
    jstate = JS.PowerSGD(1).init_state(jtree)
    got = dict(zip(TH.leaf_paths(model.params),
                   strat.init_state(model.params)))
    for path, js in zip(TH.jax_leaf_paths(jtree), jstate):
        assert tuple(got[path]["q"].shape) == tuple(np.shape(js["q"])), path
    st = convert.powersgd_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         jtree, model.params, kept)
    st = [{k: torch.from_numpy(v) for k, v in s.items()} for s in st]
    r = np.random.RandomState(sum(shape) + 1)
    jgrads = jax.tree.map(lambda a: r.randn(*a.shape).astype(np.float32),
                          jtree)
    grads = _port_tree(model, jgrads)
    st_j = {p: {"q": np.asarray(js["q"]), "e": np.asarray(js["e"])}
            for p, js in zip(TH.jax_leaf_paths(jtree), jstate)}
    want, (want_e,) = _reference([jgrads], [st_j], 1)
    mean, new = strat(grads, st, size=1)
    for p in TH.jax_leaf_paths(jtree):
        np.testing.assert_allclose(
            TH.to_jax_layout(TH.get_leaf(mean, p), p, kept).numpy(), want[p],
            rtol=1e-4, atol=1e-5, err_msg=str(p))
    for p, s in zip(TH.leaf_paths(model.params), new):
        if p in want_e:
            e = TH.to_jax_layout(s["e"], p, kept).reshape(
                want_e[p].shape).numpy()
            np.testing.assert_allclose(e, want_e[p], rtol=1e-4, atol=1e-5,
                                       err_msg=str(p))
