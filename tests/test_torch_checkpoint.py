"""Checkpoints of the port (``utils/checkpoint.py``, ``ModelBase.save`` /
``load``, the worker's ``ckpt_dir`` / ``resume``) and
``convert.checkpoint_from_jax``.

* the files: atomic writes, no temporary left behind, ``LATEST`` falling
  back to the newest valid epoch;
* save, kill, resume: a run of two epochs equals, bit for bit, one epoch
  that ends in a checkpoint followed by a new session that resumes from it
  (params, optimizer state, the strategy's state), for TinyLRNNet
  (momentum, with and without ``para_load``), TinyVGGNet under onebit, topk
  and powersgd1, TinyFileNet on batch files, and the tiny LM (Adam), at
  world 1 and at 2 gloo ranks; and mid-epoch through ``save``/``load``;
* a checkpoint the JAX package wrote loads through
  ``convert.checkpoint_from_jax`` exactly (the conversion only permutes),
  and the port's next step matches the JAX package's next step within the
  parity tests' tolerances (stated at each check)."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JBSP
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger as TBSP
from theanompi_tpu_torch.utils import checkpoint as ckpt
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_lm_wires import _models  # noqa: E402
from test_torch_vgg import _JTinyVGGNet, cpu_group  # noqa: E402,F401


def _state(i):
    return {"params": {"a": {"w": np.full((2, 3), i, np.float32)}},
            "opt_state": {"a": {"w": np.zeros((2, 3), np.float32)}},
            "extra": {}}


def test_writes_are_atomic_and_leave_no_temporary(tmp_path):
    d = str(tmp_path)
    cursor = {"shuffle_seed": 3, "train_ptr": 2,
              "aug_rng_keys": np.arange(4, dtype=np.uint32)}
    ckpt.save_checkpoint(d, _state(1), epoch=0, count=5, cursor=cursor,
                         params_npy=_state(1)["params"])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_epoch0.json",
                                     "ckpt_epoch0.npz", "params_epoch0"]
    np.testing.assert_array_equal(
        np.load(os.path.join(d, "params_epoch0", "a_w.npy")),
        _state(1)["params"]["a"]["w"])
    out = ckpt.load_checkpoint(d, _state(0))
    np.testing.assert_array_equal(out["params"]["a"]["w"],
                                  _state(1)["params"]["a"]["w"])
    assert out["_meta"]["count"] == 5
    assert out["_cursor"]["train_ptr"] == 2
    np.testing.assert_array_equal(out["_cursor"]["aug_rng_keys"],
                                  np.arange(4, dtype=np.uint32))


def test_a_failed_write_keeps_the_old_file(tmp_path):
    p = str(tmp_path / "f")
    ckpt._fsync_write(p, lambda f: f.write(b"old"))

    def boom(f):
        f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError):
        ckpt._fsync_write(p, boom)
    assert open(p, "rb").read() == b"old"


def test_latest_falls_back_to_the_newest_valid_epoch(tmp_path, capsys):
    d = str(tmp_path)
    assert ckpt.latest_epoch(d) is None
    assert ckpt.load_checkpoint(d, _state(0)) is None
    assert ckpt.peek_meta(d) is None
    for e in range(3):
        ckpt.save_checkpoint(d, _state(e), epoch=e, count=e)
    assert ckpt.latest_epoch(d) == 2
    # epoch 2's archive torn (a writer killed mid-save), 1's sidecar torn
    with open(os.path.join(d, "ckpt_epoch2.npz"), "r+b") as f:
        f.truncate(40)
    with open(os.path.join(d, "ckpt_epoch1.json"), "w") as f:
        f.write("{\"epoch\": ")
    assert not ckpt.checkpoint_valid(d, 2)
    assert ckpt.latest_epoch(d) == 0
    assert "newest valid epoch 0" in capsys.readouterr().err
    out = ckpt.load_checkpoint(d, _state(9))
    assert out["_meta"]["epoch"] == 0
    np.testing.assert_array_equal(out["params"]["a"]["w"], 0)
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("garbage")
    assert ckpt.latest_epoch(d) == 0


def test_a_leaf_of_another_shape_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, _state(1), epoch=0, count=0)
    bad = _state(0)
    bad["params"]["a"]["w"] = np.zeros((3, 2), np.float32)
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        ckpt.load_checkpoint(d, bad)


def _same_states(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CASES = [
    ("TinyLRNNet", "allreduce", {}),
    ("TinyLRNNet", "allreduce", {"para_load": True}),
    ("TinyVGGNet", "onebit", {}),
    ("TinyVGGNet", "topk", {}),
    ("TinyVGGNet", "powersgd1", {}),
    ("TinyLM", "allreduce", {}),
    ("TinyFileNet", "allreduce", {"para_load": True, "aug_per_image": True}),
]


@pytest.mark.parametrize("model,strategy,cfg", CASES)
def test_save_kill_resume_replays_bit_identically(tmp_path, model, strategy,
                                                  cfg):
    if model == "TinyFileNet":
        cfg = dict(cfg, data_dir=helper.write_imagenet_dir(
            str(tmp_path / "data"), n_train=5, hw=16))
    d = str(tmp_path / "ckpt")
    kw = dict(exch_strategy=strategy, **cfg)
    full = helper.run_session(model, 2, **kw).model
    helper.run_session(model, 1, ckpt_dir=d, **kw)
    assert ckpt.latest_epoch(d) == 0
    again = helper.run_session(model, 2, ckpt_dir=d, resume=True,
                               record_dir=str(tmp_path / "rec"), **kw).model
    _same_states(helper.state_arrays(full), helper.state_arrays(again))
    assert ckpt.latest_epoch(d) == 1


@pytest.mark.parametrize("model,strategy", [
    ("TinyLRNNet", "allreduce"), ("TinyVGGNet", "onebit"),
    ("TinyVGGNet", "powersgd1"), ("TinyLM", "allreduce")])
def test_resume_at_two_gloo_ranks(tmp_path, model, strategy):
    """Each rank trains two epochs; then one epoch ending in a checkpoint
    (rank 0 writes; the strategy's per-rank state gathered) and a resumed
    second: both ranks end bit-identical to their uninterrupted runs."""
    d = str(tmp_path / "ckpt")
    ranks = helper.run_ranks("resume", 2, tmp_path, "res", model, strategy,
                             d, timeout=240)
    for r in ranks:
        full = {k[5:]: v for k, v in r.items() if k.startswith("full/")}
        res = {k[8:]: v for k, v in r.items() if k.startswith("resumed/")}
        _same_states(full, res)
    # BSP: the ranks' params are identical
    for k in ranks[0]:
        if k.startswith("resumed/params"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    meta = ckpt.peek_meta(d)
    assert meta["n_workers"] == 2
    # the JAX package's identical_parts: a stateful strategy's ranks keep
    # every part their own
    assert meta["boxed_parts"] == (
        [] if strategy == "allreduce"
        else ["bn_state", "extra", "opt_state", "params"])


def test_mid_epoch_save_and_load_under_para_load(cpu_group, tmp_path):
    """``save`` after 3 of 6 steps and ``load`` into a fresh model: the rest
    of the epoch trains the same bits (the consumed cursor, not the
    producer's, is saved)."""
    d = helper.write_imagenet_dir(str(tmp_path / "data"), n_train=6, hw=16)
    cfg = {"device": "cpu", "verbose": False, "data_dir": d,
           "para_load": True, "aug_per_image": True}
    a = helper.TinyFileNet(cfg)
    a.compile_iter_fns()
    a.data.shuffle_data(0)
    for c in range(1, 4):
        a.train_iter(c)
    a.save(str(tmp_path / "ckpt"), epoch=0, count=3)
    b = helper.TinyFileNet(cfg)
    b.compile_iter_fns()
    assert b.load(str(tmp_path / "ckpt")) == 0
    _same_states(helper.state_arrays(a), helper.state_arrays(b))
    assert b.data.get_cursor()["train_ptr"] == 3
    for c in range(4, 7):
        a.train_iter(c)
        b.train_iter(c)
    _same_states(helper.state_arrays(a), helper.state_arrays(b))


def test_refused_layouts(cpu_group, tmp_path):
    m = helper.TinyLRNNet({"device": "cpu", "verbose": False,
                           "async_ckpt": True})
    m.compile_iter_fns()
    with pytest.raises(NotImplementedError, match="async_ckpt"):
        m.save(str(tmp_path), 0)
    ok = helper.TinyLRNNet({"device": "cpu", "verbose": False})
    ok.compile_iter_fns()
    ok.save(str(tmp_path), 0)
    meta_path = tmp_path / "ckpt_epoch0.json"
    meta = json.loads(meta_path.read_text())
    meta["n_workers"] = 4
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="4 workers"):
        ok.load(str(tmp_path))


# -- a checkpoint the JAX package wrote -----------------------------------

def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_vel(jm):
    return jax.tree.map(lambda v: np.asarray(v)[0],
                        jax.device_get(jm.step_state["opt_state"]))


@pytest.mark.parametrize("twin,strategy", [
    ("lrn", "allreduce"), ("vgg", "onebit"), ("vgg", "topk"),
    ("vgg", "powersgd1")])
def test_jax_checkpoint_loads_and_continues(cpu_group, tmp_path, twin,
                                            strategy):
    """The JAX package trains 2 steps and saves; the port loads that
    checkpoint into a model of its own init (another seed) and both take
    step 3.  Loaded params and velocity equal the JAX state exactly (a
    permutation of the same float32 values); the strategy's state too.
    After the step: cost rtol 1e-5, params rtol 1e-5 / atol 1e-6, velocity
    rtol 1e-5 / atol 1e-7 (the trajectory tests' bounds: float32, sums in
    another order).  The onebit state is held as the VGG trajectory holds
    it (rtol 1e-5, atol 1e-5·scale, no sign flip), topk's and PowerSGD's
    e at rtol 1e-5 / atol 1e-6."""
    JM, TM = {"lrn": (_JTinyLRNNet, helper.TinyLRNNet),
              "vgg": (_JTinyVGGNet, helper.TinyVGGNet)}[twin]
    jm = JM({"n_workers": 1, "verbose": False, "exch_strategy": strategy})
    tm = TM({"device": "cpu", "verbose": False, "exch_strategy": strategy,
             "seed": 77})
    jx, tx = JBSP(jm.config), TBSP(tm.config)
    if strategy == "topk":
        jx.strategy.chunk = tx.strategy.chunk = 256
    jm.compile_iter_fns(jx)
    tm.compile_iter_fns(tx)
    jm.data.shuffle_data(1)
    for c in (1, 2):
        jm.train_iter(c)
    d = str(tmp_path / "jax_ckpt")
    jm.save(d, epoch=0, count=2)
    assert convert.checkpoint_from_jax(d, tm) == 0
    jp = _host(jm.canonical_host_params())
    want = convert.params_from_jax(jp)
    for k in want:
        for n in want[k]:
            np.testing.assert_array_equal(tm.host_params()[k][n], want[k][n])
    want_v = convert.params_from_jax(_jax_vel(jm))
    for k in want_v:
        for n in want_v[k]:
            np.testing.assert_array_equal(tm.opt_state[k][n].numpy(),
                                          want_v[k][n])
    assert tm.data.get_cursor()["train_ptr"] == 2
    jm.train_iter(3)
    tm.train_iter(3)
    np.testing.assert_allclose(float(tm.current_info["cost"]),
                               float(jm.current_info["cost"]), rtol=1e-5)
    want = convert.params_from_jax(_host(jm.canonical_host_params()))
    got = tm.host_params()
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n], want[k][n], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}/{n}")
    want_v = convert.params_from_jax(_jax_vel(jm))
    for k in want_v:
        for n in want_v[k]:
            np.testing.assert_allclose(tm.opt_state[k][n].numpy(),
                                       want_v[k][n], rtol=1e-5, atol=1e-7)
    if strategy == "allreduce":
        return
    jst = jax.tree.map(lambda v: np.asarray(v)[0],
                       jax.device_get(jm.step_state["extra"]["strat"]))
    st = tm.extra["strat"]
    if strategy == "onebit":
        want_s = convert.flat_from_jax(jst, jp, tm.params)
        got_s = st.numpy()
        n_true = sum(v.size for d_ in got.values() for v in d_.values())
        scale = float(np.abs(got_s[:n_true]).mean())
        assert not (np.abs(got_s - want_s) > scale).any()
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5,
                                   atol=1e-5 * scale)
    elif strategy == "topk":
        np.testing.assert_allclose(st.numpy(), jst, rtol=1e-5, atol=1e-6)
    else:
        want_s = convert.powersgd_state_from_jax(jst, jp, tm.params)
        for g, w in zip(st, want_s):
            np.testing.assert_allclose(g["e"].numpy(), w["e"], rtol=1e-5,
                                       atol=1e-6)


def test_jax_lm_checkpoint_with_adam_loads_and_continues(cpu_group,
                                                         tmp_path):
    """The LM under Adam: params, both moments and the per-leaf step counts
    load exactly.  The next step equals, bit for bit, the port's step from
    the same JAX state set leaf by leaf through the converters that the
    trajectory tests hold against JAX (``params_from_jax`` of the params
    and both moments, the counts, the cursor), and its cost equals JAX's
    next cost to rtol 1e-5.

    Its parameters are not held against JAX's step 3 here: on this batch
    one ReLU pre-activation of block0's fc1 (unit 31) lies 2.8e-9 from 0,
    below float32 rounding at the 0.44 scale of its row, so XLA and oneDNN
    take opposite sides of the kink; that unit's gradient differs by ~5e-4
    and Adam, dividing by sqrt(v) ~ 5e-4, turns it into parameter changes
    of ~1e-3.  The three-step trajectories of ``test_torch_lm_wires.py``
    hold the LM against JAX where no activation sits on a kink."""
    jm, tm, _ = _models(32, "allreduce", 32)
    _, ref, _ = _models(32, "allreduce", 32)
    jm.data.shuffle_data(0)
    for c in (1, 2):
        jm.train_iter(c)
    d = str(tmp_path / "jax_ckpt")
    jm.save(d, epoch=0, count=2)
    assert convert.checkpoint_from_jax(d, tm) == 0
    assert {int(t) for t in TH.tree_leaves(tm.opt_state["t"])} == {2}
    kept = tm.kept_layout_paths()
    want = convert.params_from_jax(_host(jm.canonical_host_params()), kept)
    jst = _jax_vel(jm)
    for path in TH.jax_leaf_paths(want):
        np.testing.assert_array_equal(TH.get_leaf(tm.host_params(), path),
                                      TH.get_leaf(want, path))
        for mom in ("m", "v"):
            np.testing.assert_array_equal(
                TH.get_leaf(tm.opt_state[mom], path).numpy(),
                TH.get_leaf(convert.params_from_jax(jst[mom], kept), path))
    # the same state by hand, into a second port model
    ref.load_params(want)
    for mom in ("m", "v"):
        TH.tree_map(lambda t, a: t.copy_(torch.from_numpy(a)),
                    ref.opt_state[mom], convert.params_from_jax(jst[mom],
                                                                kept))
    TH.tree_map(lambda t: t.fill_(2), ref.opt_state["t"])
    ref.data.set_cursor(jm.data.get_cursor())
    jm.train_iter(3)
    tm.train_iter(3)
    ref.train_iter(3)
    np.testing.assert_allclose(float(tm.current_info["cost"]),
                               float(jm.current_info["cost"]), rtol=1e-5)
    _same_states(helper.state_arrays(tm), helper.state_arrays(ref))
