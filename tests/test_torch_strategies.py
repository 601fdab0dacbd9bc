"""The port's exchange strategies and BSP exchanger on a world-1 gloo group.

The two-rank mean itself is checked end to end in
``test_torch_alexnet_bsp.py``; these pin each strategy's arithmetic and the
names the config resolves, exactly (no tolerance: world 1 reduces nothing,
so every result is a fixed sequence of float32/bfloat16 roundings).
"""

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.base import MeshProcess
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
    """World 1: the mean is the input itself, through the wire's type."""
    strat = S.get_strategy(name)
    assert strat.name == resolved
    want = _tree()
    got = strat(_tree(), size=1)
    for k in ("w", "b"):
        w = want["conv"][k]
        if wire is not None:
            w = w.to(wire).float()
        assert torch.equal(got["conv"][k], w), (name, k)


def test_strategy_divides_by_size(cpu_group):
    """``size`` divides the sum: the world-1 sum is the input, so size 4
    returns a quarter of it (what a 4-rank group of equal inputs gives)."""
    got = S.get_strategy("allreduce")(_tree(), size=4)
    want = _tree()
    for k in ("w", "b"):
        assert torch.equal(got["conv"][k], want["conv"][k] * 0.25)


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="onebit"):
        S.get_strategy("onebit")
    with pytest.raises(ValueError, match="easgd"):
        X.get_exchanger("easgd")
    with pytest.raises(NotImplementedError, match="params"):
        X.BSP_Exchanger({"exch_mode": "params"})
