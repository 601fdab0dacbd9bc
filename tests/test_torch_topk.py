"""The port's topk wire against the JAX package's.

* the plain encode and decode (what a CPU tensor runs, and what the CUDA
  kernels B7/B8 are held against on the card) equal the jnp oracles
  ``topk_encode_jnp`` / ``topk_decode_jnp`` bit for bit: ties, all-zero
  rows, ±0.0, k = 1 and k = chunk, 1, 3 and 8 workers, the ``/size`` fold
  (bf16 values compared through their int16 bits);
* the JAX-order flatten equals the JAX package's ``flatten_tree`` bit for
  bit, and its inverse gives the port's leaves back;
* a 3-step BSP trajectory of a small VGG block under
  ``exch_strategy='topk'`` with a chunk of 256 (so the block spans several
  chunks and the flat order matters) through both packages' step paths;
* topk over two gloo processes: each rank's mean against the oracles'
  composition of both ranks' inputs, and two ranks training with
  bit-identical parameters and different error states;
* on the card (``cuda`` marker), B7 and B8 against the plain versions.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops import compress as J
from theanompi_tpu.parallel import strategies as JS
from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JBSP
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.ops import compress as T
from theanompi_tpu_torch.parallel import strategies as S
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger as TBSP
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_vgg import _host, _JTinyVGGNet, cpu_group  # noqa: E402,F401

CHUNK = 64


def _rows(seed, rows=8, chunk=CHUNK):
    """Random rows with an all-zero row (−0.0 in it), a row of equal
    magnitudes of both signs, and planted ties across a normal row."""
    r = np.random.RandomState(seed)
    c = r.randn(rows, chunk).astype(np.float32)
    c[1] = 0.0
    c[1, 3::5] = -0.0
    c[2] = np.float32(0.5)
    c[2, ::3] = -0.5
    c[3, 5::7] = c[3, 5]
    c[4, ::2] = -c[4, 1::2]
    return c


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _wire(vals, idx):
    """JAX (bf16, int16) arrays → the port's tensors."""
    return (torch.from_numpy(_jbits(vals).copy()).view(torch.bfloat16),
            torch.from_numpy(np.asarray(idx).copy()))


def test_stable_sort_is_lax_top_k_order():
    """Equal magnitudes: the lower index first, as ``lax.top_k``."""
    a = np.array([[1, 3, 3, 2, 3]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(a), 5)
    _, got, _ = T.topk_encode(torch.from_numpy(a), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[1, 2, 4, 3, 0]])


@pytest.mark.parametrize("k", [1, 5, 13, CHUNK])
def test_topk_encode_plain_bit_equal(k):
    c = _rows(k)
    wv, wi, wn = J.topk_encode_jnp(jnp.asarray(c), k)
    tv, ti, tn = T.topk_encode(torch.from_numpy(c), k)
    assert tv.dtype == torch.bfloat16 and ti.dtype == torch.int16
    assert tv.shape == ti.shape == (c.shape[0], k)
    np.testing.assert_array_equal(_bf16_bits(tv), _jbits(wv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tn.numpy().view(np.int32), _jbits(wn))
    # the all-zero row sends offsets 0..k−1: |−0.0| ties with |+0.0|
    np.testing.assert_array_equal(ti[1].numpy(), np.arange(k))
    # the input is left as it was
    np.testing.assert_array_equal(c, _rows(k))


@pytest.mark.parametrize("w", [1, 3, 8])
def test_topk_decode_plain_bit_equal(w):
    vals, idx = zip(*[J.topk_encode_jnp(jnp.asarray(_rows(20 + i)), 7)[:2]
                      for i in range(w)])
    av, ai = jnp.stack(vals), jnp.stack(idx)
    tv, ti = _wire(av, ai)
    for size in sorted({1, 3, w}):
        want = np.asarray(J.topk_decode_jnp(av, ai, CHUNK, size))
        got = T.topk_decode(tv, ti, CHUNK, size)
        assert got.shape == (8 * CHUNK,)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32), err_msg=str(size))


def test_encode_decode_round_trip_carries_the_mass():
    """One worker, size 1: decode + new state = c, exactly where nothing
    was sent, and to the bf16 rounding (the state's residual) where it
    was: the error feedback loses nothing."""
    c = torch.from_numpy(_rows(3))
    v, i, state = T.topk_encode(c, 9)
    dense = T.topk_decode(v[None], i[None], CHUNK).view(c.shape)
    np.testing.assert_array_equal((dense + state).numpy(), c.numpy())


@pytest.mark.parametrize("kernel,args", [
    ("topk_encode_cuda", lambda: (torch.zeros(4, CHUNK), 3)),
    ("topk_decode_cuda", lambda: (torch.zeros(1, 4, 3, dtype=torch.bfloat16),
                                  torch.zeros(1, 4, 3, dtype=torch.int16),
                                  CHUNK)),
])
def test_kernel_wrappers_refuse_cpu_tensors(kernel, args):
    fn = getattr(T, kernel)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args())
    assert fn.launches == before


def test_topk_wrappers_refuse_bad_shapes_and_dtypes():
    with pytest.raises(TypeError, match="float32"):
        T.topk_encode(torch.zeros(2, CHUNK, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="32768"):
        T.topk_encode(torch.zeros(1, 2 * 32768), 1)
    with pytest.raises(ValueError, match="k = 0"):
        T.topk_encode(torch.zeros(2, CHUNK), 0)
    with pytest.raises(ValueError, match="k = 65"):
        T.topk_encode_cuda(torch.zeros(2, CHUNK), CHUNK + 1)
    with pytest.raises(TypeError, match="int16"):
        T.topk_decode(torch.zeros(1, 2, 3, dtype=torch.bfloat16),
                      torch.zeros(1, 2, 3, dtype=torch.int32), CHUNK)
    with pytest.raises(ValueError, match="one shape"):
        T.topk_decode(torch.zeros(1, 2, 3, dtype=torch.bfloat16),
                      torch.zeros(1, 2, 4, dtype=torch.int16), CHUNK)


def _jax_tree(seed=6):
    r = np.random.RandomState(seed)
    return {"fc": {"w": r.randn(6, 5).astype(np.float32),
                   "b": r.randn(5).astype(np.float32)},
            "conv": {"w": r.randn(3, 3, 2, 4).astype(np.float32),
                     "b": r.randn(4).astype(np.float32)}}


def test_flatten_tree_jax_bit_equal_to_the_jax_package():
    """The port's tree (its own key order, PyTorch layouts) flattens in
    the JAX order to the JAX package's ``flatten_tree`` of the same
    parameters, pad included; ``unflatten_like_jax`` returns the port's
    leaves (as views) from it."""
    jtree = _jax_tree()
    conv = convert.params_from_jax(jtree)
    ttree = {k: {n: torch.from_numpy(conv[k][n]) for n in ("w", "b")}
             for k in ("fc", "conv")}            # not the sorted order
    want = np.asarray(JH.flatten_tree(jtree, pad_to_multiple_of=128))
    got = TH.flatten_tree_jax(ttree, pad_to_multiple_of=128)
    assert got.shape == (128,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    back = TH.unflatten_like_jax(ttree, got)
    assert list(back) == ["fc", "conv"]
    for k in ttree:
        for n in ttree[k]:
            assert back[k][n].shape == ttree[k][n].shape
            assert torch.equal(back[k][n], ttree[k][n]), (k, n)
            assert back[k][n].data_ptr() >= got.data_ptr()      # a view


@pytest.mark.parametrize("name,kw,chunk,k", [
    ("topk", {}, 8192, 82), ("topk", {"chunk": 256}, 256, 3),
    ("topk", {"k": 5}, 8192, 5), ("TopK", {"ratio": 0.05}, 8192, 410)])
def test_topk_names_and_k_match_jax(name, kw, chunk, k):
    strat, ref = S.get_strategy(name, **kw), JS.get_strategy(name, **kw)
    assert isinstance(strat, S.TopK) and strat.name == ref.name == "topk"
    assert strat.stateful and strat.flattens
    assert (strat.chunk, strat._k_c()) == (ref.chunk, ref._k_c()) == (chunk, k)
    with pytest.raises(AssertionError, match="int16"):
        S.TopK(chunk=1 << 16)


def test_topk_world_one_is_the_oracles(cpu_group):
    """One rank: the mean is the decode of its own encode of the JAX-order
    flat vector + state, and the state is the encode's residual state."""
    strat = S.TopK(chunk=CHUNK, k=4)
    r = np.random.RandomState(8)
    tree = {"b": torch.from_numpy(r.randn(50).astype(np.float32)),
            "a": torch.from_numpy(r.randn(10, 12).astype(np.float32))}
    state = strat.init_state(tree)
    assert state.shape == (192,) and not state.any()
    state += torch.from_numpy(r.randn(192).astype(np.float32)) * 0.1
    jtree = {"b": tree["b"].numpy(), "a": tree["a"].numpy().T}
    c = np.asarray(JH.flatten_tree(jtree, pad_to_multiple_of=CHUNK)) \
        + state.numpy()
    wv, wi, wn = J.topk_encode_jnp(jnp.asarray(c.reshape(3, CHUNK)), 4)
    want = np.asarray(J.topk_decode_jnp(wv[None], wi[None], CHUNK))
    mean, new = strat(tree, state.clone(), size=1)
    np.testing.assert_array_equal(new.numpy(), np.asarray(wn).reshape(-1))
    np.testing.assert_array_equal(TH.flatten_tree_jax(mean).numpy(),
                                  want[:170])
    assert mean["a"].shape == (10, 12)


def test_topk_three_step_trajectory_matches_jax(cpu_group):
    """3 BSP steps at world 1 under ``exch_strategy='topk'`` with a chunk
    of 256 set on both exchangers (the block's 973 parameters span four
    chunks), both packages from the same weights and data.

    Tolerances: cost rtol 1e-5, params and momentum rtol 1e-5 / atol
    1e-6, as for the allreduce trajectory: float32, the gradients differ
    only in summation order (~1e-7 relative).  The wire adds no error of
    its own: the encode and decode are bit-equal to the oracles, and the
    state is the JAX package's element for element (the port keeps it in
    the JAX order), held to rtol 1e-5 / atol 1e-6.  The same entries are
    selected in both packages (a selection that differed would move an
    element by a whole gradient value, far outside the bound)."""
    cfg = {"verbose": False, "exch_strategy": "topk"}
    jm = _JTinyVGGNet(dict(cfg, n_workers=1))
    tm = helper.TinyVGGNet(dict(cfg, device="cpu"))
    jp0 = _host(jm.params)
    tm.load_params(convert.params_from_jax(jp0))
    jx, tx = JBSP(jm.config), TBSP(tm.config)
    jx.strategy.chunk = tx.strategy.chunk = 256
    jm.compile_iter_fns(jx)
    tm.compile_iter_fns(tx)
    assert tm.extra["strat"].shape == (1024,)
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)
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
    got_s = tm.extra["strat"].numpy()
    assert got_s.any()
    np.testing.assert_allclose(got_s, jstate, rtol=1e-5, atol=1e-6)


def test_topk_two_gloo_ranks_match_the_oracle_composition(tmp_path):
    """Each rank's mean equals ``topk_decode_jnp`` of both ranks' encodes
    (``topk_encode_jnp`` of their JAX-order inputs), bit for bit: the
    encode is exact, the int32 wire words carry the bits through gloo,
    and the decode adds in rank order; each rank's state is its own
    encode's."""
    ranks = helper.run_ranks("topk", 2, tmp_path, "tk")
    like = helper.TinyVGGNet({"device": "cpu", "verbose": False}).params
    vals, idx, states = [], [], []
    for r in ranks:
        grads = TH.unflatten_like(like, torch.from_numpy(r["flat"]))
        c = TH.flatten_tree_jax(grads, pad_to_multiple_of=256).numpy()
        v, i, s = J.topk_encode_jnp(jnp.asarray(c.reshape(-1, 256)), 3)
        vals.append(v)
        idx.append(i)
        states.append(np.asarray(s).reshape(-1))
    want = np.asarray(J.topk_decode_jnp(jnp.stack(vals), jnp.stack(idx),
                                        256, 2))
    for r, s_want in zip(ranks, states):
        mean = TH.unflatten_like(like, torch.from_numpy(r["mean"]))
        np.testing.assert_array_equal(
            TH.flatten_tree_jax(mean).numpy().view(np.int32),
            want[:r["mean"].shape[0]].view(np.int32))
        np.testing.assert_array_equal(r["state"], s_want)
    np.testing.assert_array_equal(ranks[0]["mean"], ranks[1]["mean"])


def test_topk_bsp_two_gloo_ranks_stay_identical(tmp_path):
    """Two ranks train one epoch (3 steps) of the VGG block under topk:
    every rank decodes the same rows, so their parameters are
    bit-identical, while their error states differ."""
    r0, r1 = helper.run_ranks("train", 2, tmp_path, "tkt", 8, "TinyVGGNet",
                              "topk")
    assert sorted(r0) == sorted(r1)
    for k in r0:
        if k != "extra/strat":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["extra/strat"].shape == (8192,)
    assert not np.array_equal(r0["extra/strat"], r1["extra/strat"])
    init = helper.TinyVGGNet({"device": "cpu"}).host_params()
    assert not np.allclose(r0["conv2/w"], init["conv2"]["w"])  # it trained


@pytest.mark.cuda
@pytest.mark.parametrize("rows,chunk,k", [(64, 8192, 82), (3, 32768, 328),
                                          (16, 256, 256), (40, 1000, 1)])
def test_topk_kernels_match_plain_on_card(rows, chunk, k):
    """B7 equal to the plain encode bit for bit (value bits, offsets, new
    state), with an all-zero row, planted ties and ±0.0; B8 equal to the
    plain decode bit for bit at 1, 4 and 8 workers and with the /size
    fold.  Chunk 32768 takes shared memory past 48 KB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = np.random.RandomState(chunk)
    c = r.randn(rows, chunk).astype(np.float32)
    c[0] = 0.0
    c[0, 1::3] = -0.0
    c[1, ::4] = c[1, 0]
    c[-1, 7::11] = -c[-1, 7]
    c2 = torch.from_numpy(c).cuda()
    kv, ki, ks = T.topk_encode_cuda(c2, k)
    pv, pi, ps = T.topk_encode_plain(c2, k)
    assert torch.equal(kv.view(torch.int16), pv.view(torch.int16))
    assert torch.equal(ki, pi)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    for w in (1, 4, 8):
        av = torch.stack([torch.roll(kv, i, 0) for i in range(w)])
        ai = torch.stack([torch.roll(ki, i, 0) for i in range(w)])
        for size in (1, w):
            got = T.topk_decode_cuda(av, ai, chunk, size)
            want = T.topk_decode_plain(av, ai, chunk, size)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(T.topk_encode(c2, k)[2], ks)      # the public route
