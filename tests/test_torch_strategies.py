"""The port's exchange strategies and BSP exchanger on a world-1 gloo group.

The two-rank mean itself is checked end to end in
``test_torch_alexnet_bsp.py`` and ``test_torch_vgg.py``; these pin each
strategy's arithmetic under the ``(tree, state) -> (mean, new_state)``
contract and the names the config resolves.  ``NoComm`` and ``AllReduce``
are exact (world 1 reduces nothing, so every result is a fixed sequence of
float32/bfloat16 roundings); ``OneBit`` is held against the JAX package's
own test of the same identity.
"""

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.base import MeshProcess
from theanompi_tpu_torch.ops import compress
from theanompi_tpu_torch.parallel import exchanger as X
from theanompi_tpu_torch.parallel import strategies as S


@pytest.fixture
def cpu_group():
    proc = MeshProcess({"device": "cpu", "verbose": False})
    proc.get_internode_comm()
    yield proc
    proc.close()


def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {"conv": {"w": torch.from_numpy(r.randn(4, 3, 3, 3).astype(
        np.float32)), "b": torch.from_numpy(r.randn(4).astype(np.float32))}}


@pytest.mark.parametrize("name,resolved,wire", [
    ("allreduce", "allreduce", None), ("ar", "allreduce", None),
    ("nccl32", "allreduce", None), ("nccl16", "allreduce16", torch.bfloat16),
    ("bf16", "allreduce16", torch.bfloat16), ("none", "none", None),
    ("nocomm", "none", None)])
def test_strategy_mean_on_one_rank(cpu_group, name, resolved, wire):
    """World 1: the mean is the input itself, through the wire's type; the
    stateless strategies hand their state back untouched."""
    strat = S.get_strategy(name)
    assert strat.name == resolved
    assert not strat.stateful and strat.init_state(_tree()) == ()
    want = _tree()
    got, state = strat(_tree(), (), size=1)
    assert state == ()
    for k in ("w", "b"):
        w = want["conv"][k]
        if wire is not None:
            w = w.to(wire).float()
        assert torch.equal(got["conv"][k], w), (name, k)


def test_strategy_divides_by_size(cpu_group):
    """``size`` divides the sum: the world-1 sum is the input, so size 4
    returns a quarter of it (what a 4-rank group of equal inputs gives)."""
    got, _ = S.get_strategy("allreduce")(_tree(), (), size=4)
    want = _tree()
    for k in ("w", "b"):
        assert torch.equal(got["conv"][k], want["conv"][k] * 0.25)


@pytest.mark.parametrize("name", ["onebit", "compressed"])
def test_onebit_names_resolve(name):
    strat = S.get_strategy(name)
    assert isinstance(strat, S.OneBit) and strat.name == "onebit"
    assert strat.stateful and strat.flattens


def test_onebit_identical_inputs_decode_exactly(cpu_group):
    """The JAX package's ``test_onebit_identical_inputs_decode_exactly`` at
    world 1: the mean is scale·sign(base) and the error state holds
    base − that, with scale = mean|base| (rtol 1e-4 / atol 1e-5, that
    test's bound: the scale's mean sums in another order than numpy's)."""
    r = np.random.RandomState(4)
    base = r.randn(compress.PACK_ALIGN).astype(np.float32)
    strat = S.get_strategy("onebit")
    tree = {"g": torch.from_numpy(base.copy())}
    state = strat.init_state(tree)
    assert state.shape == (compress.PACK_ALIGN,) and not state.any()
    out, state = strat(tree, state, size=1)
    scale = np.abs(base).mean()
    expect = scale * np.where(base >= 0, 1.0, -1.0)
    np.testing.assert_allclose(out["g"].numpy(), expect, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), base - expect, rtol=1e-4,
                               atol=1e-5)


def test_onebit_pads_and_keeps_error_in_the_pad(cpu_group):
    """A tree whose size is no multiple of PACK_ALIGN: the state has the
    padded length, the scale is taken over the true elements only, and
    the pad (c = 0, sign bit 1) keeps the residual −scale, exactly."""
    tree = _tree(1)
    n = 4 * 27 + 4
    strat = S.OneBit()
    state = strat.init_state(tree)
    assert state.shape == (compress.PACK_ALIGN,)
    out, state = strat(tree, state, size=1)
    flat = np.concatenate([tree["conv"]["w"].numpy().ravel(),
                           tree["conv"]["b"].numpy().ravel()])
    scale = np.float32(np.abs(flat).mean() + np.float32(1e-12))
    assert out["conv"]["w"].shape == (4, 3, 3, 3)
    np.testing.assert_allclose(np.abs(out["conv"]["b"].numpy()), scale,
                               rtol=1e-6)
    pad = state[n:].numpy()
    np.testing.assert_allclose(pad, -scale, rtol=1e-6)
    assert np.all(pad == pad[0])


def test_bsp_exchanger_carries_the_strategy_state(cpu_group):
    """``extra_state_template`` is ``{"strat": zeros}`` for onebit and
    ``{}`` for a stateless strategy; ``step_update`` returns the new
    state in ``extra``."""
    class _M:
        params = _tree()
        opt = type("O", (), {"update": staticmethod(
            lambda g, s, p, lr: (p, s))})
        kept_layout_paths = staticmethod(frozenset)
    for name, stateful in (("onebit", True), ("allreduce", False)):
        ex = X.BSP_Exchanger({"exch_strategy": name})
        ex.prepare(_M(), 1)
        extra = ex.extra_state_template()
        assert ("strat" in extra) == stateful
        _, _, new = ex.step_update(_M.params, (), _tree(2), extra, 0.1)
        assert set(new) == set(extra)
        if stateful:
            assert new["strat"].shape == extra["strat"].shape
            assert new["strat"].any()


@pytest.mark.parametrize("name", ["topk", "powersgd1"])
def test_bsp_exchanger_carries_topk_and_powersgd_state(cpu_group, name):
    """topk's state is a flat tensor padded to its chunk; PowerSGD's a
    list over the leaves of ``{"q", "e"}``: ``extra_state_template``
    makes it and ``step_update`` hands the strategy's new one back, of
    the same structure."""
    r = np.random.RandomState(3)
    params = {"fc": {"w": torch.from_numpy(r.randn(8, 12).astype(np.float32)),
                     "b": torch.zeros(8)}}

    class _M:
        opt = type("O", (), {"update": staticmethod(
            lambda g, s, p, lr: (p, s))})
        kept_layout_paths = staticmethod(frozenset)
    _M.params = params
    ex = X.BSP_Exchanger({"exch_strategy": name})
    ex.prepare(_M(), 1)
    extra = ex.extra_state_template()
    grads = {"fc": {"w": params["fc"]["w"] * 0.5, "b": torch.ones(8)}}
    _, _, new = ex.step_update(params, (), grads, extra, 0.1)
    if name == "topk":
        assert extra["strat"].shape == new["strat"].shape == (8192,)
        assert new["strat"].any()
    else:
        assert [s["e"].shape for s in extra["strat"]] == \
            [(8, 12), (0, 0)]
        assert [s["q"].shape for s in new["strat"]] == [(8, 1), (0, 1)]
        assert new["strat"][0]["e"].shape == (8, 12)


def test_bucketed_wire_raises():
    with pytest.raises(NotImplementedError, match="bucket"):
        X.BSP_Exchanger({"exch_strategy": "onebit", "bucket_bytes": 1 << 20})


def test_unknown_names_raise():
    for name in ("ring", "asa16"):
        with pytest.raises(ValueError, match=name):
            S.get_strategy(name)
    with pytest.raises(ValueError, match="easgd"):
        X.get_exchanger("easgd")
    with pytest.raises(NotImplementedError, match="params"):
        X.BSP_Exchanger({"exch_mode": "params"})
