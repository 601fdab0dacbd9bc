"""The one-program step of the port (``parallel/steps.py``,
``parallel/graph.py``): ``steps_per_call`` windows and the train step
captured in a CUDA graph.

On the CPU:

* ``steps_per_call = 2`` against the JAX package's ``steps_per_call = 2``
  (its ``lax.scan`` over a ``[2, ...]`` window), both packages from the
  same weights, data and wire state, float32, no dropout: ``TinyLRNNet``
  under ``allreduce``, ``TinyVGGNet`` under ``onebit``, ``topk`` (chunk
  256) and ``powersgd1``, and the tiny LM under Adam;
* the port's ``steps_per_call = k`` bit for bit k single steps (dropout
  on: step j of a window draws from its own count);
* the static step (what the card captures: static input buffers, state
  rewritten in place, a tensor learning rate, device-side Adam counts)
  run on the CPU bit for bit the eager step;
* Adam's device-side bias corrections against the JAX package's float32
  ``1 - b**t``, and ``opt.load_state`` keeping the count tensors a
  captured step reads;
* ``para_load`` window mode: two epochs with a leftover batch, the
  consumed cursor, a mid-epoch save and resume at ``steps_per_call = 2``
  bit for bit the uninterrupted run;
* the recorder's stride gate and the worker's count stride against the
  JAX package's, and ``sync_each_iter``'s ``wait`` bucket.

On the card (``cuda``, skipped here): the captured step ≡ the eager step
over 8 steps for each wire and for Adam, the launch counters counting
replays, and a planted host sync refused at capture.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer_lm import TransformerLM as JLM
from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JBSP
from theanompi_tpu.utils.recorder import Recorder as JRecorder
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import graph as graph_lib
from theanompi_tpu_torch.parallel import steps
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger as TBSP
from theanompi_tpu_torch.utils import helper_funcs as TH
from theanompi_tpu_torch.utils import opt as TO
from theanompi_tpu_torch.utils.recorder import Recorder as TRecorder

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_transformer_lm import _assert_bulk_close  # noqa: E402
from test_torch_vgg import _JTinyVGGNet, cpu_group  # noqa: E402,F401

SPC = 2
TOPK_CHUNK = 256
LM_CFG = dict(vocab=64, d_model=32, n_head=2, n_layer=2, seq_len=48,
              batch_size=4, synthetic_train=16, synthetic_val=4,
              attn_impl="reference")


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_row(jm, part):
    return jax.tree.map(lambda v: np.asarray(v)[0],
                        jax.device_get(jm.step_state[part]))


def _pair(case, spc):
    """The JAX model and the port's from its weights (and wire state),
    each compiled with ``steps_per_call = spc``."""
    cfg = {"verbose": False, "steps_per_call": spc}
    if case == "lm":
        jm = JLM(dict(cfg, **LM_CFG, n_workers=1, compute_dtype=jnp.float32))
        tm = helper.TinyLM(dict(cfg, **LM_CFG, device="cpu"))
    elif case == "allreduce":
        jm = _JTinyLRNNet(dict(cfg, n_workers=1))
        tm = helper.TinyLRNNet(dict(cfg, device="cpu"))
    else:
        cfg["exch_strategy"] = case
        jm = _JTinyVGGNet(dict(cfg, n_workers=1))
        tm = helper.TinyVGGNet(dict(cfg, device="cpu"))
    kept = tm.kept_layout_paths()
    jp0 = _host(jm.params)
    tm.load_params(convert.params_from_jax(jp0, kept))
    jx, tx = JBSP(jm.config), TBSP(tm.config)
    if case == "topk":
        jx.strategy.chunk = tx.strategy.chunk = TOPK_CHUNK
    jm.compile_iter_fns(jx)
    tm.compile_iter_fns(tx)
    if case == "powersgd1":
        st0 = convert.powersgd_state_from_jax(
            _jax_row(jm, "extra")["strat"], jp0, tm.params, kept)
        for cur, s in zip(tm.extra["strat"], st0):
            for k in ("q", "e"):
                cur[k].copy_(torch.from_numpy(s[k]))
    return jm, tm, jp0


@pytest.mark.parametrize("case", ["allreduce", "onebit", "topk", "powersgd1",
                                  "lm"])
def test_steps_per_call_matches_jax_steps_per_call(cpu_group, case):
    """Both packages at ``steps_per_call = k``, each call's mean cost to
    rtol 1e-5, then the end state as the one-step trajectories hold it.
    The CNNs, two calls of two steps (``test_torch_alexnet_bsp.py``,
    ``test_torch_vgg.py``): params rtol 1e-5 / atol 1e-6, momentum rtol
    1e-5 / atol 1e-7; the wire's state: topk's (the JAX order) rtol 1e-5 /
    atol 1e-6, PowerSGD's ``e`` rtol 1e-5 / atol 1e-6, onebit's rtol 1e-5
    / atol 1e-5·scale (``test_torch_vgg.py`` says why).  The LM under
    Adam, one call of three steps, in the two tiers of
    ``test_torch_transformer_lm.py``'s Adam trajectory (which says why:
    Adam's first steps are sign-like; here one entry of ``ln2.scale``
    ends 2.7e-5 apart, as it does after three single steps), and its
    counts exactly.  float32; the packages differ in summation order
    only."""
    spc, calls = (3, 1) if case == "lm" else (SPC, 2)
    jm, tm, jp0 = _pair(case, spc)
    kept = tm.kept_layout_paths()
    for count in range(spc, spc * calls + 1, spc):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(np.asarray(jm.current_info["cost"])),
                                   rtol=1e-5)
    want = convert.params_from_jax(_host(jm.canonical_host_params()), kept)
    got = tm.host_params()
    jst = _jax_row(jm, "opt_state")
    if case == "lm":
        for path in TH.jax_leaf_paths(want):
            _assert_bulk_close(TH.get_leaf(got, path), TH.get_leaf(want, path),
                               "/".join(path), 1e-4, 1e-6, 1e-4)
        for mom in ("m", "v"):
            w = convert.params_from_jax(jst[mom], kept)
            for path in TH.jax_leaf_paths(w):
                scale = np.abs(TH.get_leaf(w, path)).max()
                _assert_bulk_close(
                    TH.get_leaf(tm.opt_state[mom], path).numpy(),
                    TH.get_leaf(w, path), f"{mom} {path}", 1e-2 * scale,
                    1e-4 * scale, 0)
        assert {int(t) for t in TH.tree_leaves(tm.opt_state["t"])} == \
            {int(t) for t in jax.tree.leaves(jst["t"])} == {spc}
        return
    for path in TH.jax_leaf_paths(want):
        np.testing.assert_allclose(TH.get_leaf(got, path),
                                   TH.get_leaf(want, path), rtol=1e-5,
                                   atol=1e-6, err_msg="/".join(path))
    w = convert.params_from_jax(jst, kept)
    for path in TH.jax_leaf_paths(w):
        np.testing.assert_allclose(TH.get_leaf(tm.opt_state, path).numpy(),
                                   TH.get_leaf(w, path), rtol=1e-5,
                                   atol=1e-7, err_msg=f"velocity {path}")
    if case in ("allreduce", "lm"):
        return
    jstate = _jax_row(jm, "extra")["strat"]
    if case == "topk":
        np.testing.assert_allclose(tm.extra["strat"].numpy(),
                                   np.asarray(jstate), rtol=1e-5, atol=1e-6)
    elif case == "powersgd1":
        want_s = convert.powersgd_state_from_jax(jstate, jp0, tm.params,
                                                 kept)
        for w, g in zip(want_s, tm.extra["strat"]):
            np.testing.assert_allclose(g["e"].numpy(), w["e"], rtol=1e-5,
                                       atol=1e-6)
    else:
        want_s = convert.flat_from_jax(np.asarray(jstate), jp0, tm.params)
        got_s = tm.extra["strat"].numpy()
        scale = float(np.abs(got_s).mean())
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5,
                                   atol=1e-5 * scale)


def _model(case, **cfg):
    base = {"device": "cpu", "verbose": False}
    if case == "lm":
        return helper.TinyLM(dict(base, **LM_CFG, **cfg))
    if case in ("allreduce", "dropout"):
        cls = helper.TinyDropNet if case == "dropout" else helper.TinyLRNNet
        return cls(dict(base, **cfg))
    if case == "bn":
        return helper.TinyResNet(dict(base, **cfg))
    return helper.TinyVGGNet(dict(base, exch_strategy=case, **cfg))


def _same(a, b):
    x, y = helper.state_arrays(a), helper.state_arrays(b)
    assert sorted(x) == sorted(y)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


CASES = ["allreduce", "dropout", "onebit", "topk", "powersgd1", "lm", "bn"]


@pytest.mark.parametrize("case", CASES)
def test_steps_per_call_equals_single_steps_bit_for_bit(cpu_group, case):
    """One call of k = 3 steps over a [3, ...] window against three calls
    of one step, from the same state and batches: the same costs and the
    same params, optimizer, BN and wire state, bit for bit (``dropout``:
    TinyLRNNet with a dropout layer; each step of the window draws from
    its own count's stream; ``bn``: TinyResNet, whose running state each
    step of the window updates and syncs in turn)."""
    k = 3
    one, many = _model(case), _model(case, steps_per_call=k)
    one.compile_iter_fns()
    many.compile_iter_fns()
    batches = [one.data.next_train_batch(c) for c in range(1, k + 1)]
    costs = [float(one.train_fn(b, 0.05, c)[0][0])
             for c, b in enumerate(batches, 1)]
    cost, _ = many.train_fn(batches, 0.05, k)
    assert cost.shape == (k,)
    np.testing.assert_array_equal(cost.numpy(), np.float32(costs))
    _same(one, many)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("spc", [1, 2])
def test_static_step_on_cpu_bit_equal_to_the_eager_step(cpu_group, case,
                                                        spc):
    """The step the card captures, run on the CPU: the batch copied into
    static buffers it owns (the same tensors every call), the state
    rewritten in place (the same tensors after every call), the learning
    rate a tensor it refills, Adam's counts on the device; over three calls
    (the rate changes after the second) it is bit for bit the eager
    step."""
    eager = _model(case, steps_per_call=spc)
    static = _model(case, steps_per_call=spc)
    eager.compile_iter_fns(capture=False)
    static.compile_iter_fns(capture=True)
    assert not static.train_fn.graphed and static.train_fn.capture
    leaves = static.train_fn._state_leaves()
    bufs = None
    for i, lr in enumerate((0.05, 0.05, 0.02)):
        count = (i + 1) * spc
        b = [eager.data.next_train_batch(count - spc + 1 + j)
             for j in range(spc)]
        b = b[0] if spc == 1 else b
        inputs = static.train_fn.take(b)
        assert bufs is None or inputs is bufs
        bufs = inputs
        got = static.train_fn(inputs, lr, count)
        want = eager.train_fn(b, lr, count)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert all(a is b for a, b in zip(static.train_fn._state_leaves(),
                                      leaves))
    assert static.train_fn._lr_host == 0.02
    _same(eager, static)


def test_a_static_step_refuses_another_batch_shape(cpu_group):
    m = _model("allreduce")
    m.compile_iter_fns(capture=True)
    m.train_fn.take(m.data.next_train_batch(1))
    with pytest.raises(ValueError, match="static step takes"):
        m.train_fn.take({"x": np.zeros((4, 8, 8, 3), np.float32),
                         "y": np.zeros(4, np.int32)})


@pytest.mark.parametrize("b1,b2", [(0.9, 0.999), (0.8, 0.99)])
def test_adam_corrections_on_device_match_jax_float32(b1, b2):
    """Adam's bias corrections, now computed from the count tensor, against
    the JAX package's float32 ``1 - b**t`` for t = 1..3000: within one ulp
    of 1 (2⁻²³, absolute: ``b**t`` may round differently by an ulp, and
    ``1 - b**t`` keeps that absolute error)."""
    t = np.arange(1, 3001)
    tf = torch.from_numpy(t.astype(np.int32)).float()
    jt = jnp.asarray(t, jnp.int32).astype(jnp.float32)
    for b in (b1, b2):
        np.testing.assert_allclose((1 - b ** tf).numpy(),
                                   np.asarray(1 - b ** jt), rtol=0,
                                   atol=2.0 ** -23)


def test_adam_counts_load_in_place_and_regroup():
    """``load_state`` writes the counts into the tensors a captured step
    reads while every leaf holds one value; counts that differ by leaf
    (as the JAX package may store them) regroup into one shared tensor per
    value, and the next update adds one to each group."""
    tp = {"a": {"w": torch.ones(2, 3), "b": torch.ones(3)},
          "c": {"w": torch.ones(4)}}
    o = TO.adam()
    st = o.init(tp)
    shared = st["t"]["a"]["w"]
    host = {"m": TH.tree_map(lambda p: np.full(p.shape, 0.5, np.float32),
                             tp),
            "v": TH.tree_map(lambda p: np.ones(p.shape, np.float32), tp),
            "t": TH.tree_map(lambda p: np.int32(7), tp)}
    st = TO.load_state(st, host)
    assert all(t is shared for t in TH.tree_leaves(st["t"]))
    assert int(shared) == 7 and float(st["m"]["c"]["w"][0]) == 0.5
    host["t"] = {"a": {"w": np.int32(3), "b": np.int32(5)},
                 "c": {"w": np.int32(3)}}
    st = TO.load_state(st, host)
    assert st["t"]["a"]["w"] is st["t"]["c"]["w"]
    assert st["t"]["a"]["b"] is not st["t"]["a"]["w"]
    grads = TH.tree_map(torch.ones_like, tp)
    o.update(grads, st, tp, 0.1)
    assert [int(t) for t in TH.tree_leaves(st["t"])] == [4, 6, 4]


# -- para_load window mode ---------------------------------------------------

def _file_session(tmp_path, epochs, **cfg):
    d = helper.write_imagenet_dir(str(tmp_path / "data"), n_train=5, hw=16)
    return helper.run_session("TinyFileNet", epochs, data_dir=d, **cfg)


@pytest.mark.parametrize("workers", [1, 2])
def test_window_mode_two_epochs_with_a_leftover_batch(tmp_path, workers):
    """Five batches an epoch at ``steps_per_call = 2``: two windows and one
    batch dropped per epoch, two epochs, no deadlock; the same params and
    state, bit for bit, as the same run without ``para_load`` (which takes
    the k batches on the step's thread)."""
    runs = [_file_session(tmp_path / str(p), 2, steps_per_call=2,
                          para_load=p, para_load_workers=workers).model
            for p in (False, True)]
    assert runs[1].data.window == 2
    _same(*runs)


def test_window_mode_cursor_and_mid_epoch_resume(cpu_group, tmp_path):
    """At ``steps_per_call = 2`` under ``para_load``: after one window the
    consumed cursor is two batches in although the producer ran ahead; a
    checkpoint there, loaded into a fresh model, trains the second window
    bit for bit as the uninterrupted model does."""
    d = helper.write_imagenet_dir(str(tmp_path / "data"), n_train=5, hw=16)
    cfg = {"device": "cpu", "verbose": False, "data_dir": d,
           "para_load": True, "steps_per_call": 2, "para_load_workers": 2}
    full = helper.TinyFileNet(cfg)
    full.compile_iter_fns()
    full.data.shuffle_data(0)
    full.train_iter(2)
    assert full.data.get_cursor()["train_ptr"] == 2
    ck = str(tmp_path / "ck")
    full.save(ck, 0, 2)
    full.train_iter(4)
    resumed = helper.TinyFileNet(cfg)
    resumed.compile_iter_fns()
    assert resumed.load(ck) == 0
    resumed.train_iter(4)
    np.testing.assert_array_equal(
        float(resumed.current_info["cost"]), float(full.current_info["cost"]))
    _same(full, resumed)
    full.data.close()
    resumed.data.close()


# -- the loop: recorder gate, worker stride, sync_each_iter -------------------

@pytest.mark.parametrize("print_freq,stride", [(4, 1), (4, 2), (5, 2),
                                               (3, 4), (1, 3)])
def test_print_gate_and_average_follow_jax(print_freq, stride):
    """The counts at which each package's recorder prints, and the averaged
    cost it prints, over 24 calls of ``stride`` steps each."""
    cfg = {"printFreq": print_freq, "verbose": False}
    jr, tr = JRecorder(cfg), TRecorder(cfg)
    for i in range(1, 25):
        count = i * stride
        c = np.float32(i * 0.25)
        for r in (jr, tr):
            r.train_error(count, c, c, 8)
        a, b = jr.print_train_info(count, stride), \
            tr.print_train_info(count, stride)
        assert (a is None) == (b is None), count
        if a is not None:
            assert a["cost"] == b["cost"] and a["iter"] == b["iter"]


def _worker_counts(tmp_path, epochs, resume=False, **cfg):
    """The counts a BSP worker hands ``train_iter``, and the epochs it
    ran."""
    from theanompi_tpu_torch.worker import BSP_Worker
    w = BSP_Worker(dict({"device": "cpu", "verbose": False, "epochs": epochs,
                         "scale_lr": False, "printFreq": 1000,
                         "ckpt_dir": str(tmp_path), "resume": resume},
                        **cfg))
    try:
        model = w.build_model("torch_port_helper", "TinyLRNNet")
        seen = []
        inner = model.train_iter

        def spy(count, recorder=None):
            seen.append(count)
            inner(count, recorder)
        model.train_iter = spy
        w.run(model)
    finally:
        w.close()
    return seen


def test_worker_strides_count_and_resumes_at_the_strided_count(tmp_path):
    """Six batches an epoch at ``steps_per_call = 4``: one call a epoch
    (count 4, then 8), the two left over dropped; a run resumed after
    epoch 0 starts at ``1 · (6 // 4) · 4 = 4``, the JAX worker's count."""
    assert _worker_counts(tmp_path / "a", 2, steps_per_call=4) == [4, 8]
    _worker_counts(tmp_path / "b", 1, steps_per_call=4)
    assert _worker_counts(tmp_path / "b", 2, resume=True,
                          steps_per_call=4) == [8]
    assert _worker_counts(tmp_path / "c", 1) == [1, 2, 3, 4, 5, 6]


def test_steps_per_call_above_an_epoch_is_refused(cpu_group):
    m = _model("allreduce", steps_per_call=7)
    with pytest.raises(ValueError, match="exceeds n_batch_train=6"):
        m.compile_iter_fns()


def test_sync_each_iter_fills_the_wait_bucket(cpu_group):
    """``sync_each_iter``: the step's metrics are read back in the call
    (host floats), and the time of that read lands in ``wait``."""
    m = _model("allreduce", sync_each_iter=True)
    m.compile_iter_fns()
    rec = TRecorder({"verbose": False})
    m.train_iter(1, rec)
    assert isinstance(m.current_info["cost"], float)
    assert "wait" in rec.t_sec_total
    m2 = _model("allreduce")
    m2.compile_iter_fns()
    rec2 = TRecorder({"verbose": False})
    m2.train_iter(1, rec2)
    assert isinstance(m2.current_info["cost"], torch.Tensor)
    assert "wait" not in rec2.t_sec_total
    assert m.current_info["cost"] == float(m2.current_info["cost"])


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def card_group():
    from theanompi_tpu_torch.base import MeshProcess
    _card()
    proc = MeshProcess({"device": "cuda", "verbose": False})
    proc.get_internode_comm()
    yield proc
    proc.close()


def _card_model(case, **cfg):
    base = {"device": "cuda", "verbose": False}
    if case == "lm":
        return helper.TinyLM(dict(base, **LM_CFG, **cfg))
    if case == "allreduce":
        return helper.TinyDropNet(dict(base, **cfg))
    if case == "bn":
        return helper.TinyResNet(dict(base, **cfg))
    return helper.TinyVGGNet(dict(base, exch_strategy=case, **cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["allreduce", "onebit", "topk", "powersgd1",
                                  "lm", "bn"])
@pytest.mark.parametrize("spc", [1, 2])
def test_graph_equals_eager_on_card(card_group, monkeypatch, case, spc):
    """8 steps captured against 8 eager, from the same weights and batches
    (cuDNN deterministic on both): the same costs and state, bit for bit;
    the captured step is a replay from its second call on, and the LRN
    kernels (``allreduce``: TinyDropNet, which has an LRN) and the wires'
    kernels count as many launches in both runs."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = []
    for capture in (False, True):
        for k in graph_lib.kernel_wrappers():
            k.launches = 0
        m = _card_model(case, steps_per_call=spc)
        m.compile_iter_fns(capture=capture)
        m.data.shuffle_data(0)
        costs = []
        for c in range(spc, 8 + 1, spc):
            m.train_iter(c)
            costs.append(float(m.current_info["cost"]))
        torch.cuda.synchronize()
        assert m.train_fn.graphed == capture
        runs.append((m, costs, {k.__name__: k.launches
                                for k in graph_lib.kernel_wrappers()}))
    (a, ca, la), (b, cb, lb) = runs
    assert ca == cb
    assert la == lb
    _same(a, b)


@pytest.mark.cuda
def test_launch_counters_count_replays(card_group):
    """One eager call (the capture's warm-up), then replays: the onebit
    kernels count one launch a step, so 4 calls of 2 steps count 8 each,
    as the eager step does; the capture itself counts none."""
    for k in graph_lib.kernel_wrappers():
        k.launches = 0
    m = _card_model("onebit", steps_per_call=2)
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    from theanompi_tpu_torch.ops import compress
    m.train_iter(2)
    assert compress.pack_signs_encode_cuda.launches == 2
    assert m.train_fn._graph.launches[compress.pack_signs_encode_cuda] == 2
    for c in (4, 6, 8):
        m.train_iter(c)
    for k in (compress.pack_signs_encode_cuda, compress.signed_residual_cuda,
              compress.unpack_signs_wsum_cuda):
        assert k.launches == 8, k.__name__


@pytest.mark.cuda
def test_a_host_sync_in_the_step_is_refused_at_capture(card_group):
    """A loss that reads a value back to the host cannot be captured: the
    first call raises ``CaptureError`` naming the line, and no later call
    runs the step eagerly instead (each raises again)."""
    class Syncing(helper.TinyLRNNet):
        def loss_and_metrics(self, params, bn_state, batch, gen, train):
            cost, err = super().loss_and_metrics(params, bn_state, batch,
                                                 gen, train)
            if float(cost.detach()) < 0:             # the planted host sync
                cost = cost * 0
            return cost, err

    m = Syncing({"device": "cuda", "verbose": False})
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    for c in (1, 2):
        with pytest.raises(graph_lib.CaptureError, match=r"test_torch_steps"
                           r"\.py:\d+ `if float\(cost\.detach\(\)\)"):
            m.train_iter(c)
        assert m.train_fn._graph is None
