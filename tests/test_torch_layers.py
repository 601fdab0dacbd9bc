"""The port's layers against the JAX package's, at narrow widths.

Weights are drawn by the JAX layer, converted with
``theanompi_tpu_torch.convert`` and loaded into the port's layer; inputs are
numpy from a seed.  Forward outputs and the gradients of ``sum(y * w)``
(random ``w``) with respect to the input and every parameter must agree.
Everything is float32 (``compute_dtype``) and the tolerance is rtol/atol
1e-5: the convolutions and products sum in a different order in XLA and
in torch, a few ulps at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import layers as JL
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _port_params(jp):
    if jp is None:
        return None
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return {k: torch.from_numpy(v).requires_grad_(True) for k, v in tp.items()}


def _check(jlayer, tlayer, x, train=False, seed=0):
    jp = jlayer.init(jax.random.key(seed))
    tp = _port_params(jp)
    y_ref = jlayer.apply(jp, jnp.asarray(x), train=train)
    w = np.random.RandomState(seed + 1).randn(*y_ref.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jlayer.apply(p, xx, train=train) * w)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tlayer.apply(tp, xt, train=train)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    if jp is not None:
        gp_port = convert.params_from_jax(jax.tree.map(np.asarray, gp))
        for k in tp:
            np.testing.assert_allclose(tp[k].grad.numpy(), gp_port[k],
                                       err_msg=k, **TOL)


def _x(shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CONV_CASES = [
    # (in, out, kernel, stride, padding, groups, input hw)
    (3, 8, 5, 2, "VALID", 1, 15),       # conv1-style VALID stride
    (8, 12, 3, 1, 1, 2, 9),             # two groups, int padding
    (4, 8, 3, 1, "SAME", 2, 8),         # SAME, symmetric
    (4, 6, 3, 2, "SAME", 1, 8),         # SAME stride 2: asymmetric padding
    (6, 6, 5, 1, 2, 3, 7),              # three groups, pad 2 (conv2-style)
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_matches_jax(case):
    cin, cout, k, s, pad, g, hw = case
    kw = dict(stride=s, padding=pad, groups=g, w_init=("normal", 0.1),
              b_init=("constant", 0.1))
    _check(JL.Conv(cin, cout, k, compute_dtype=jnp.float32, **kw),
           TL.Conv(cin, cout, k, compute_dtype="float32", **kw),
           _x((2, hw, hw, cin)))


@pytest.mark.parametrize("activation", ["relu", None, "tanh"])
def test_fc_matches_jax(activation):
    kw = dict(w_init=("normal", 0.1), b_init=("constant", 0.1),
              activation=activation)
    _check(JL.FC(24, 10, compute_dtype=jnp.float32, **kw),
           TL.FC(24, 10, compute_dtype="float32", **kw), _x((3, 24)))


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("size,stride,hw", [(3, 2, 13), (2, 2, 8),
                                            (3, 2, 27)])
def test_pool_matches_jax(mode, size, stride, hw):
    _check(JL.Pool(size, stride, mode=mode), TL.Pool(size, stride, mode=mode),
           _x((2, hw, hw, 5)))


def test_lrn_layer_matches_jax():
    _check(JL.LRN(), TL.LRN(), _x((2, 4, 4, 96)) * 3)


def test_dropout_eval_is_identity():
    x = torch.from_numpy(_x((4, 6)))
    assert torch.equal(TL.Dropout(0.5).apply(None, x, train=False), x)


def test_dropout_train_keeps_scaled_values():
    """Bits differ from jax.random; the law is the JAX layer's: each entry
    is 0 or x/keep, about keep of them kept."""
    x = torch.ones(200, 50)
    gen = torch.Generator().manual_seed(0)
    y = TL.Dropout(0.5).apply(None, x, train=True, gen=gen)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.03


def test_flatten_order_matches_jax_through_fc():
    """Conv → Flatten → FC: the FC weight converts by a plain transpose only
    if both sides flatten NHWC in (h, w, c) order."""
    mk = lambda L, cd: L.Sequential([
        L.Conv(3, 4, 3, padding="VALID", w_init=("normal", 0.1),
               compute_dtype=cd, name="c"),
        L.Flatten(),
        L.FC(5 * 5 * 4, 6, w_init=("normal", 0.1), activation=None,
             compute_dtype=cd, name="f")])
    js, ts = mk(JL, jnp.float32), mk(TL, "float32")
    jp = js.init(jax.random.key(5))
    tp = {k: _port_params(v) for k, v in jp.items()}
    x = _x((2, 7, 7, 3))
    y_ref, _ = js.apply(jp, jnp.asarray(x))
    y = ts.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_softmax_cross_entropy_and_grad_match_jax(eps):
    r = np.random.RandomState(9)
    logits = r.randn(8, 10).astype(np.float32) * 3
    labels = r.randint(0, 10, 8).astype(np.int32)
    ref = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   eps)
    gref = jax.grad(lambda l: JL.softmax_cross_entropy(
        l, jnp.asarray(labels), eps))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = TL.softmax_cross_entropy(lt, torch.from_numpy(labels), eps)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gref), **TOL)


def test_error_heads_match_jax():
    """Top-1 and top-5 error on logits without ties (torch.topk and
    lax.top_k may break ties differently)."""
    r = np.random.RandomState(11)
    logits = r.permutation(64 * 20).reshape(64, 20).astype(np.float32)
    labels = r.randint(0, 20, 64).astype(np.int32)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    assert float(TL.errors(tl, ty)) == float(JL.errors(jl, jy))
    for k in (1, 5, 30):
        assert float(TL.errors_top_x(tl, ty, k)) == \
            float(JL.errors_top_x(jl, jy, k))


@pytest.mark.parametrize("scheme", [("normal", 0.01), ("constant", 0.1),
                                    "xavier", "he"])
def test_init_weight_schemes(scheme):
    """Same law as the JAX package's init_weight (the bits differ)."""
    gen = torch.Generator().manual_seed(0)
    shape = (3, 3, 64, 128)
    w = TL.init_weight(gen, shape, scheme).numpy()
    ref = np.asarray(JL.init_weight(jax.random.key(0), shape, scheme))
    assert w.shape == ref.shape and w.dtype == np.float32
    np.testing.assert_allclose(w.mean(), ref.mean(), atol=3e-3)
    np.testing.assert_allclose(w.std(), ref.std(), rtol=0.02, atol=1e-7)
