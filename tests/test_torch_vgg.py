"""VGG-16 and the onebit wire of the port against the JAX package.

* full-width VGG-16 forward, batch 1, ``n_class=10``, float32, eval mode,
  from the JAX model's weights through ``convert.py``;
* a 3-step BSP trajectory of a small VGG block under
  ``exch_strategy='onebit'`` through both packages' normal step paths:
  cost, parameters, momentum, and the error-feedback state (through
  ``convert.flat_from_jax``, pad included);
* onebit over two gloo processes: each rank's decoded mean against the JAX
  oracles' composition of both ranks' inputs, and BSP's invariant — every
  rank decodes the same mean, so the ranks' parameters stay bit-identical
  while their error states differ.
"""

import gc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import layers as JL
from theanompi_tpu.models.data import DataBase as JDataBase
from theanompi_tpu.models.model_base import ModelBase as JModelBase
from theanompi_tpu.models.vggnet_16 import VGGNet_16 as JVGG16
from theanompi_tpu.ops import compress as JC
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.base import MeshProcess
from theanompi_tpu_torch.models.vggnet_16 import VGGNet_16 as TVGG16

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_vgg16_full_width_forward_matches_jax():
    """Logits agree to rtol 1e-5 / atol 1e-5·max|logit|, the AlexNet
    test's bound with the same reason: float32 throughout, but the 3×3
    convolutions and the 25088- and 4096-wide products sum in another order
    in XLA and in oneDNN, about 1e-6 of the logits' scale after sixteen
    layers."""
    cfg = {"batch_size": 1, "n_class": 10, "synthetic_batches": 1,
           "synthetic_val_batches": 1, "verbose": False}
    jm = JVGG16(dict(cfg, n_workers=1, compute_dtype=jnp.float32))
    tm = TVGG16(dict(cfg, device="cpu", compute_dtype="float32"))
    jp = _host(jm.params)
    assert sorted(jp) == sorted(tm.params)
    tm.load_params(convert.params_from_jax(jp))
    del jp
    x = (np.random.RandomState(0).randn(1, 224, 224, 3) * 50).astype(
        np.float32)
    ref, _ = jm.apply_model(jm.params, jnp.asarray(x), train=False, rng=None,
                            state={})
    ref = np.asarray(ref)
    with torch.no_grad():
        got = tm.apply_model(tm.params, torch.from_numpy(x), train=False,
                             gen=None).numpy()
    del jm, tm
    gc.collect()
    assert got.shape == (1, 10)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


def test_vgg_models_and_hyperparameters_match_jax():
    """VGG-16 and VGG-11: the same layers, parameter shapes (in each
    package's layout), counts and hyperparameters; no weights are drawn
    at full width."""
    from theanompi_tpu.models import vggnet_16 as jv
    from theanompi_tpu_torch.models import vggnet_16 as tv
    for blocks in ("_VGG16_BLOCKS", "_VGG11_BLOCKS"):
        assert getattr(jv, blocks) == getattr(tv, blocks)
        jseq = jv._vgg_stack(getattr(jv, blocks), jnp.float32, 1000)
        tseq = tv._vgg_stack(getattr(tv, blocks), "float32", 1000)
        assert [type(l).__name__ for l in jseq.layers] == \
            [type(l).__name__ for l in tseq.layers]
        assert jseq._keys == tseq._keys
    n = sum(l.in_ch * l.out_ch * 9 + l.out_ch if hasattr(l, "kernel")
            else l.n_in * l.n_out + l.n_out
            for l in tseq.layers if hasattr(l, "w_init"))
    assert n == 132_863_336                              # VGG-11, 1000 classes
    for name in ("batch_size", "epochs", "learning_rate", "momentum",
                 "weight_decay", "lr_adjust_epochs", "n_class"):
        assert getattr(tv.VGGNet_16, name) == getattr(jv.VGGNet_16, name), name
    assert tv.VGGNet is tv.VGGNet_16
    assert tv.VGGNet_11_shallow.blocks == jv.VGGNet_11_shallow.blocks


def test_vgg16_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TVGG16({"batch_size": 1, "synthetic_batches": 1})


class _JTinyData(JDataBase):
    def __init__(self, config=None, batch_size=8):
        super().__init__(config, batch_size)
        self.x_train, self.y_train = helper.tiny_arrays()
        self.x_val, self.y_val = self.x_train[:16], self.y_train[:16]
        self._finalize()


class _JTinyVGGNet(JModelBase):
    """The JAX twin of ``torch_port_helper.TinyVGGNet``."""

    batch_size = 8
    learning_rate = 0.05
    momentum = 0.9
    weight_decay = 0.0005
    seed = 5

    def build_model(self):
        self.seq = JL.Sequential(helper.tiny_vgg_layers(JL, jnp.float32))
        self.data = _JTinyData(self.config, self.batch_size)


@pytest.fixture
def cpu_group():
    proc = MeshProcess({"device": "cpu", "verbose": False})
    proc.get_internode_comm()
    yield proc
    proc.close()


def test_onebit_three_step_trajectory_matches_jax(cpu_group):
    """3 BSP steps at world 1 under ``exch_strategy='onebit'``, both
    packages from the same weights and data.

    Tolerances: cost rtol 1e-5 and params/momentum rtol 1e-5 / atol 1e-6,
    as for the allreduce trajectory — float32, the gradients differ only in
    summation order (~1e-7 relative).  The onebit wire adds one source: the
    scale mean|c| sums its elements in another order in each package (the
    flat orders differ), ~1 ulp.  The error-feedback state is
    ``|c| − scale`` or ``scale − |c|``.  Where |c| ≈ scale that difference
    cancels, so the element's relative error is large while its absolute
    error is the absolute error of ``c`` itself: c carries three steps of
    gradients summed in another order in each package, ~1e-6 of |c| ≈
    scale, on top of the scale's ulp.  A bound from the scale's error alone
    (atol 1e-6·scale) is too tight: one element came out 6.7e-8 apart at
    scale 0.061 (relative 1.2e-4).  So the state is held to atol
    1e-5·scale (ten times c's error) besides rtol 1e-5.  A sign that
    flipped between the packages on an element whose |c| is within float32
    noise of 0 would move that element by 2·scale; the test counts such
    elements and expects none for this data."""
    jm = _JTinyVGGNet({"n_workers": 1, "verbose": False,
                       "exch_strategy": "onebit"})
    tm = helper.TinyVGGNet({"device": "cpu", "verbose": False,
                            "exch_strategy": "onebit"})
    jp0 = _host(jm.params)
    tm.load_params(convert.params_from_jax(jp0))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    assert tm.extra["strat"].shape == (JC.PACK_ALIGN,)
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]),
                                   rtol=1e-5)
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
    jstate = np.asarray(jax.device_get(jm.step_state["extra"]["strat"]))[0]
    want_s = convert.flat_from_jax(jstate, jp0, tm.params)
    got_s = tm.extra["strat"].numpy()
    n_true = sum(v.size for d in got.values() for v in d.values())
    scale = float(np.abs(got_s[:n_true]).mean())
    flipped = np.abs(got_s - want_s) > scale
    assert not flipped.any(), (
        f"{int(flipped.sum())} elements' signs differ between the packages")
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5 * scale)
    # the pad: c = 0 at step 1 (bit 1, residual −scale), and from then on
    # one value over the whole pad, of JAX's sign (its value is in the
    # bound above)
    pad = got_s[n_true:]
    assert np.all(pad == pad[0]) and pad[0] != 0
    np.testing.assert_array_equal(np.sign(pad), np.sign(want_s[n_true:]))


def test_onebit_two_gloo_ranks_match_the_oracle_composition(tmp_path):
    """Each rank's decoded mean equals ``unpack_signs_weighted_mean_jnp``
    of both ranks' packed signs and scales from the JAX oracles; each
    rank's new error state equals ``signed_residual_jnp`` of its own input.
    The signs are equal bit for bit; the scales are means that sum in
    another order in torch and in XLA, an ulp apart.  A decoded element is
    (±s0 ± s1)/2, and where the signs differ that cancels, so the bound is
    rtol 1e-6 plus atol 1e-6·max scale (a few ulps of the scale), and the
    same atol for the states (|c| − s)."""
    ranks = helper.run_ranks("onebit", 2, tmp_path, "ob")
    n_true = helper.TinyVGGNet({"device": "cpu", "verbose": False})
    n_true = sum(int(p.numel()) for d in n_true.params.values()
                 for p in d.values())
    packs, scales, states = [], [], []
    for r in ranks:
        flat = jnp.asarray(r["flat"])
        assert flat.shape == (JC.PACK_ALIGN,)
        packed, absc = JC.pack_signs_encode_jnp(flat, jnp.zeros_like(flat))
        scale = jnp.mean(absc[:n_true]) + 1e-12
        packs.append(packed)
        scales.append(scale)
        states.append(np.asarray(JC.signed_residual_jnp(absc, packed, scale)))
    want = np.asarray(JC.unpack_signs_weighted_mean_jnp(
        jnp.stack(packs), jnp.stack(scales), 2))
    atol = 1e-6 * max(float(s) for s in scales)
    for r, s_want in zip(ranks, states):
        np.testing.assert_allclose(r["mean"], want[:n_true], rtol=1e-6,
                                   atol=atol)
        np.testing.assert_allclose(r["state"], s_want, rtol=1e-6, atol=atol)
    # the two ranks decode the same bits and scales: one mean, exactly
    np.testing.assert_array_equal(ranks[0]["mean"], ranks[1]["mean"])


def test_onebit_bsp_two_gloo_ranks_stay_identical(tmp_path):
    """Two ranks train one epoch (3 steps) of the VGG block on different
    halves of each batch under onebit: every rank decodes the same mean, so
    their parameters are bit-identical, while their error-feedback states,
    made from their own gradients, differ."""
    r0, r1 = helper.run_ranks("train", 2, tmp_path, "vgg", 8, "TinyVGGNet",
                              "onebit")
    assert sorted(r0) == sorted(r1)
    for k in r0:
        if k != "extra/strat":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["extra/strat"].shape == (JC.PACK_ALIGN,)
    assert not np.array_equal(r0["extra/strat"], r1["extra/strat"])
    init = helper.TinyVGGNet({"device": "cpu"}).host_params()
    assert not np.allclose(r0["fc/w"], init["fc"]["w"])     # it trained
