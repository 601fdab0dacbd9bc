"""The port's model, data, step and BSP rule against the JAX package.

* full-width AlexNet forward, batch 2, ``n_class=10``, float32, eval mode,
  from the JAX model's weights through ``convert.py``;
* the synthetic ImageNet stream, rank by rank;
* a 3-step loss and parameter trajectory of a Conv → LRN → Pool → FC model
  (no dropout) through both packages' normal step paths;
* the BSP invariant on gloo: 2 processes on batch b equal 1 process on 2b.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import layers as JL
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.models.data import DataBase as JDataBase
from theanompi_tpu.models.data.imagenet import ImageNet_data as JImageNet
from theanompi_tpu.models.model_base import ModelBase as JModelBase
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.base import MeshProcess
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.models.data.imagenet import \
    ImageNet_data as TImageNet

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_alexnet_full_width_forward_matches_jax():
    """Logits agree to rtol 1e-5 / atol 1e-5·max|logit|: float32 throughout,
    but the 9216- and 4096-wide products and the 11×11 conv sum in another
    order in XLA and in oneDNN (about 1e-6 of the logits' scale after eight
    layers; the two images' logits differ by ~1e-2 of it, so the bound still
    tells them apart)."""
    cfg = {"batch_size": 2, "n_class": 10, "synthetic_batches": 1,
           "synthetic_val_batches": 1, "verbose": False}
    jm = JAlexNet(dict(cfg, n_workers=1, compute_dtype=jnp.float32))
    tm = TAlexNet(dict(cfg, device="cpu", compute_dtype="float32"))
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    x = (np.random.RandomState(0).randn(2, 227, 227, 3) * 50).astype(
        np.float32)
    ref, _ = jm.apply_model(jm.params, jnp.asarray(x), train=False, rng=None,
                            state={})
    ref = np.asarray(ref)
    with torch.no_grad():
        got = tm.apply_model(tm.params, torch.from_numpy(x), train=False,
                             gen=None, state=tm.bn_state).numpy()
    assert got.shape == (2, 10)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    # the eval head: same cost and errors on the same labels
    y = np.array([3, 7], np.int32)
    jc = float(JL.softmax_cross_entropy(jnp.asarray(ref), jnp.asarray(y)))
    with torch.no_grad():
        tc, _ = tm.val_metrics(tm.params, tm.bn_state,
                               {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tc), jc, rtol=1e-5)


@pytest.mark.parametrize("size,aug_per_image", [(1, False), (2, False),
                                                (2, True)])
def test_synthetic_imagenet_stream_matches_jax(size, aug_per_image):
    """Rank r's batches are rows r·b..(r+1)·b of the JAX package's global
    batch for the same config and seed, bit for bit."""
    b = 2
    cfg = {"size": size, "synthetic_batches": 2, "n_class": 10,
           "aug_per_image": aug_per_image, "process_count": 1,
           "process_index": 0}
    jd = JImageNet(cfg, b)
    ref = [jd.next_train_batch(1), jd.next_train_batch(2),
           jd.next_val_batch(0)]
    for r in range(size):
        td = TImageNet(dict(cfg, rank=r), b)
        got = [td.next_train_batch(1), td.next_train_batch(2),
               td.next_val_batch(0)]
        for g, e in zip(got, ref):
            np.testing.assert_array_equal(g["x"], e["x"][r * b:(r + 1) * b])
            np.testing.assert_array_equal(g["y"], e["y"][r * b:(r + 1) * b])


class _JTinyData(JDataBase):
    def __init__(self, config=None, batch_size=8):
        super().__init__(config, batch_size)
        self.x_train, self.y_train = helper.tiny_arrays()
        self.x_val, self.y_val = self.x_train[:16], self.y_train[:16]
        self._finalize()


class _JTinyLRNNet(JModelBase):
    """The JAX twin of ``torch_port_helper.TinyLRNNet``."""

    batch_size = 8
    learning_rate = 0.1
    momentum = 0.9
    weight_decay = 0.0005
    seed = 3

    def build_model(self):
        f32 = jnp.float32
        self.seq = JL.Sequential([
            JL.Conv(3, 16, 3, padding=1, w_init=("normal", 0.3),
                    b_init=("constant", 0.1), compute_dtype=f32, name="conv"),
            JL.LRN(k=1.0, alpha=0.5, name="lrn"),
            JL.Pool(3, 2, mode="max", name="pool"),
            JL.Flatten(),
            JL.FC(3 * 3 * 16, 5, w_init=("normal", 0.1), activation=None,
                  compute_dtype=f32, name="fc"),
        ])
        self.data = _JTinyData(self.config, self.batch_size)


@pytest.fixture
def cpu_group():
    proc = MeshProcess({"device": "cpu", "verbose": False})
    proc.get_internode_comm()
    yield proc
    proc.close()


def test_three_step_trajectory_matches_jax(cpu_group):
    """Loss per step and the parameters and momentum after 3 BSP steps
    (world 1) agree to rtol 1e-5 / atol 1e-6: float32, same data, same
    initial weights; only summation order differs."""
    jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
    tm = helper.TinyLRNNet({"device": "cpu", "verbose": False})
    tm.load_params(convert.params_from_jax(_host(jm.params)))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm.current_info["error"]),
                                   float(jm.current_info["error"]))
    want = convert.params_from_jax(_host(jm.canonical_host_params()))
    got = tm.host_params()
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n], want[k][n], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}/{n}")
    vel = jax.tree.map(lambda v: np.asarray(v)[0],
                       jax.device_get(jm.step_state["opt_state"]))
    want_v = convert.params_from_jax(vel)
    for k in want_v:
        for n in want_v[k]:
            np.testing.assert_allclose(tm.opt_state[k][n].numpy(),
                                       want_v[k][n], rtol=1e-5, atol=1e-7,
                                       err_msg=f"velocity {k}/{n}")


def test_session_api_trains_on_cpu():
    """``BSP().init(...).wait()`` end to end on the CPU: one epoch, the
    recorder's records, and the process group left again."""
    import torch.distributed as dist
    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=1, modelfile="torch_port_helper",
              modelclass="TinyLRNNet", device="cpu", printFreq=2,
              verbose=False)
    rec = rule.wait()
    assert not dist.is_initialized()
    assert len(rec.train_records) == 3              # iters 2, 4, 6
    assert all(np.isfinite(r["cost"]) for r in rec.train_records)
    assert len(rec.epoch_records) == 1
    assert rule.model.params["conv"]["w"].device.type == "cpu"


def _run_ranks(world, bs, tmp_path, tag):
    """Rank 0's parameters after one epoch of ``TinyLRNNet`` at ``world``
    gloo ranks of batch ``bs``."""
    return helper.run_ranks("train", world, tmp_path, tag, bs)[0]


def test_bsp_two_gloo_ranks_equal_one_rank_on_double_batch(tmp_path):
    """The defining BSP invariant, over a real gloo group: 2 processes of
    batch 8 (all_reduce-mean of their gradients) train as 1 process of
    batch 16.  rtol 2e-4 / atol 2e-5, the JAX package's bound for the same
    invariant (tests/test_bsp_equivalence.py): a mean of two half-batch
    means sums in another order than one full-batch mean, and three
    momentum steps at lr 0.1 carry that into the weights' last digits."""
    p2 = _run_ranks(2, 8, tmp_path, "w2")
    p1 = _run_ranks(1, 16, tmp_path, "w1")
    assert sorted(p1) == sorted(p2)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    init = helper.TinyLRNNet({"device": "cpu"}).host_params()
    assert not np.allclose(p1["fc/w"], init["fc"]["w"])   # it trained
