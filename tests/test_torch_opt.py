"""The port's optimizers against the JAX package's, over several steps with
a learning rate that changes between them (where ``torch.optim.SGD``'s
momentum form would part from the JAX formula).  float32; rtol/atol 1e-6,
a few ulps of the updated values (Adam's moments to rtol 1e-5: its
bias-corrected step divides by √v, and the two packages fuse the moment
updates differently)."""

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.utils import opt as JO
from theanompi_tpu_torch.utils import opt as TO


def _trees(seed):
    r = np.random.RandomState(seed)
    mk = lambda: {"a": {"w": r.randn(4, 3).astype(np.float32),
                        "b": r.randn(3).astype(np.float32)},
                  "c": {"w": r.randn(2, 2, 3, 5).astype(np.float32)}}
    return mk(), [mk() for _ in range(4)]


@pytest.mark.parametrize("name,kw", [
    ("momentum", dict(mu=0.9, weight_decay=5e-4)),
    ("momentum", dict(mu=0.5, weight_decay=0.0)),
    ("sgd", dict(weight_decay=1e-3)),
    ("adam", dict(weight_decay=0.0)),
    ("adam", dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=1e-2)),
])
def test_optimizer_steps_match_jax(name, kw):
    params, grads = _trees(0)
    jo, to = JO.get_optimizer(name, **kw), TO.get_optimizer(name, **kw)
    jp = jax.tree.map(jax.numpy.asarray, params)
    js = jo.init(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = to.init(tp)
    for g, lr in zip(grads, (0.1, 0.1, 0.01, 0.05)):
        jp, js = jo.update(jax.tree.map(jax.numpy.asarray, g), js, jp, lr)
        tp, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp, lr)
    for k in params:
        for n in params[k]:
            np.testing.assert_allclose(tp[k][n].numpy(), np.asarray(jp[k][n]),
                                       rtol=1e-6, atol=1e-6)
            if name == "adam":
                for mo in ("m", "v"):
                    np.testing.assert_allclose(
                        ts[mo][k][n].numpy(), np.asarray(js[mo][k][n]),
                        rtol=1e-5, atol=1e-7, err_msg=f"{mo} {k}/{n}")
                assert ts["t"][k][n] == int(js["t"][k][n]) == len(grads)


def test_update_is_in_place():
    params, grads = _trees(1)
    tp = jax.tree.map(torch.from_numpy, params)
    o = TO.momentum(0.9, 0.0)
    vel = o.init(tp)
    w = tp["a"]["w"]
    tp2, vel2 = o.update(jax.tree.map(torch.from_numpy, grads[0]), vel, tp,
                         0.1)
    assert tp2["a"]["w"] is w and vel2 is vel
    assert not np.array_equal(w.numpy(), _trees(1)[0]["a"]["w"])


def test_unknown_optimizer_raises():
    """An optimizer neither package has raises, naming the ones there are
    (``rmsprop`` and ``nesterov`` among them now that they are ported)."""
    with pytest.raises(ValueError, match="'lamb'.*'nesterov'.*'rmsprop'"):
        TO.get_optimizer("lamb")


def test_adam_updates_in_place():
    params, grads = _trees(2)
    tp = jax.tree.map(torch.from_numpy, params)
    o = TO.adam()
    st = o.init(tp)
    w, m = tp["a"]["w"], st["m"]["a"]["w"]
    tp2, st2 = o.update(jax.tree.map(torch.from_numpy, grads[0]), st, tp,
                        0.1)
    assert tp2["a"]["w"] is w and st2["m"]["a"]["w"] is m
    # the step counts too: one 0-d int32 tensor, shared by every leaf
    assert st2["t"]["a"]["w"] is st["t"]["c"]["w"]
    assert st2["t"]["a"]["w"].dtype == torch.int32
    assert int(st2["t"]["a"]["w"]) == 1
