"""The port's transformer LM against the JAX package's.

* the synthetic token stream, bit for bit, rank by rank;
* ``convert.params_from_jax``: embedding tables kept ``[vocab, dim]``,
  every projection transposed (the square ``wq``/``wk``/``wv``/``wo`` keep
  their shape either way, so a missed or extra transpose shows only in the
  values);
* a tiny LM's logits (T=128, d=64, 2 heads, 2 layers, float32), both
  attention paths of the port against the JAX model;
* a 3-step Adam trajectory under BSP at world 1: the port with
  ``attn_impl='flash'`` (the plain versions on the CPU) against the JAX
  model with ``attn_impl='reference'``.  The JAX model's own flash path
  raises inside its ``shard_map`` step on jax 0.9.0 (the packaged kernel's
  ``out_shape`` carries no ``vma``), so the reference path, which computes
  the same math, is the comparison; the op-level test
  (``test_torch_flash_attention.py``) holds the port's flash against the
  TPU kernel itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer_lm import LMData as JLMData
from theanompi_tpu.models.transformer_lm import TransformerLM as JLM
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.base import MeshProcess
from theanompi_tpu_torch.models.transformer_lm import LMData as TLMData
from theanompi_tpu_torch.models.transformer_lm import TransformerLM as TLM
from theanompi_tpu_torch.utils.helper_funcs import tree_leaves

TINY = dict(seq_len=128, d_model=64, n_head=2, n_layer=2, vocab=96,
            batch_size=4, synthetic_train=16, synthetic_val=8, verbose=False)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX tiny LM (float32, attn_impl='reference') and its params."""
    jm = JLM(dict(TINY, n_workers=1, compute_dtype=jnp.float32))
    return jm, _host(jm.params)


def _port(attn_impl, params=None, **kw):
    tm = TLM(dict(TINY, device="cpu", compute_dtype="float32",
                  attn_impl=attn_impl, **kw))
    if params is not None:
        tm.load_params(convert.params_from_jax(params,
                                               tm.kept_layout_paths()))
    return tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """f32 statistics with the population variance, output in the input's
    dtype: f32 to 2e-6; bf16 to one bf16 rounding of the same f32 value."""
    from theanompi_tpu.models import layers as JL
    from theanompi_tpu_torch.models import layers as TL
    r = np.random.RandomState(4)
    x = (r.randn(3, 5, 64) * 2 + 0.5).astype(np.float32)
    params = {"scale": r.rand(64).astype(np.float32) + 0.5,
              "bias": r.randn(64).astype(np.float32)}
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(JL.LayerNorm(64).apply(
        jax.tree.map(jnp.asarray, params), jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TL.LayerNorm(64).apply(jax.tree.map(torch.from_numpy, params), tx)
    assert got.dtype == tx.dtype
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_multi_head_attention_matches_jax(attn_impl):
    """[B, T, D] in and out, float32, causal, both attention paths against
    the JAX layer (reference attention) from the same weights: 1e-6."""
    from theanompi_tpu.models import layers as JL
    from theanompi_tpu_torch.models import layers as TL
    jl = JL.MultiHeadAttention(64, 4, compute_dtype=jnp.float32)
    params = _host(jl.init(jax.random.key(1)))
    x = np.random.RandomState(5).randn(2, 128, 64).astype(np.float32)
    ref = np.asarray(jl.apply(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x)))
    tl = TL.MultiHeadAttention(64, 4, compute_dtype="float32",
                               attn_impl=attn_impl)
    tp = {k: torch.from_numpy(v) for k, v in
          convert.params_from_jax({"attn": params})["attn"].items()}
    got = tl.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [1, 2])
def test_lm_data_stream_matches_jax(size):
    """Rank r's batches are rows r·b..(r+1)·b of the JAX package's global
    batch, bit for bit, after the same shuffle."""
    b = 2
    cfg = {"size": size, "seq_len": 32, "vocab": 50, "synthetic_train": 12,
           "synthetic_val": 8, "process_count": 1, "process_index": 0}
    jd = JLMData(cfg, b)
    jd.shuffle_data(5)
    ref = [jd.next_train_batch(1), jd.next_train_batch(2),
           jd.next_val_batch(0)]
    for r in range(size):
        td = TLMData(dict(cfg, rank=r), b)
        td.shuffle_data(5)
        got = [td.next_train_batch(1), td.next_train_batch(2),
               td.next_val_batch(0)]
        for g, e in zip(got, ref):
            for k in ("x", "y"):
                assert g[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], e[k][r * b:(r + 1) * b])


def test_convert_keeps_embeddings_and_transposes_projections(jax_tiny):
    _, params = jax_tiny
    conv = convert.params_from_jax(params,
                                   _port("reference").kept_layout_paths())
    for name in ("embed", "pos"):
        np.testing.assert_array_equal(conv[name]["w"], params[name]["w"])
    for blk in ("block0", "block1"):
        for w in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(conv[blk]["attn"][w],
                                          params[blk]["attn"][w].T)
        for fc in ("fc1", "fc2"):
            np.testing.assert_array_equal(conv[blk][fc]["w"],
                                          params[blk][fc]["w"].T)
            np.testing.assert_array_equal(conv[blk][fc]["b"],
                                          params[blk][fc]["b"])
    np.testing.assert_array_equal(conv["head"]["w"], params["head"]["w"].T)
    # the port's own init has the same shapes as the converted tree
    shapes = jax.tree.map(np.shape, conv)
    assert jax.tree.map(lambda p: tuple(p.shape), _port("flash").params) \
        == shapes


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_tiny_lm_logits_match_jax(jax_tiny, attn_impl):
    """Logits agree to 1e-5 (float32; the products sum in another order in
    XLA and in torch, ~3e-7 measured)."""
    jm, params = jax_tiny
    tm = _port(attn_impl, params)
    x = JLMData(dict(TINY), 4).next_train_batch(1)["x"]
    ref, _ = jm.apply_model(jm.params, jnp.asarray(x), train=False, rng=None,
                            state={})
    with torch.no_grad():
        got = tm.apply_model(tm.params, torch.from_numpy(x), train=False,
                             gen=None, state=tm.bn_state)
    assert got.shape == (4, 128, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.fixture
def cpu_group():
    proc = MeshProcess({"device": "cpu", "verbose": False})
    proc.get_internode_comm()
    yield proc
    proc.close()


def _assert_bulk_close(got, want, name, atol_all, atol_bulk, rtol_bulk):
    """Every entry within ``atol_all``; 99% of them within ``atol_bulk`` +
    ``rtol_bulk``·|want|."""
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_all, err_msg=name)
    close = np.isclose(got, want, rtol=rtol_bulk, atol=atol_bulk)
    assert close.mean() >= 0.99, (name, close.mean())


def test_three_step_adam_trajectory_matches_jax(cpu_group):
    """Loss per step (rtol 1e-5), and the parameters and Adam moments after
    3 BSP steps (world 1), from the same data and initial weights, float32.

    The gradients agree to summation order, but Adam's first steps are
    sign-like: an entry whose gradient is within that noise of zero may
    step by up to lr = 3e-3 one way in one package and the other way in the
    other, and the next steps' gradients inherit the difference.  So each
    leaf is held in two tiers: 99% of its entries tightly (params rtol 1e-4
    / atol 1e-6; moments atol 1e-4 of the leaf's largest entry — the
    attention backward forms dS from dP − di, near-equal terms, and the two
    packages take different backward algorithms, the flash formula against
    XLA's autodiff of a softmax), and every entry loosely (params atol
    lr/30 = 1e-4, moments 1e-2 of the leaf's largest entry).  A wrong
    transpose or a wrong formula moves most entries and fails the tight
    tier."""
    jm = JLM(dict(TINY, n_workers=1, compute_dtype=jnp.float32))
    tm = _port("flash", _host(jm.params))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)
    kept = tm.kept_layout_paths()
    want = convert.params_from_jax(_host(jm.canonical_host_params()), kept)
    got = tm.host_params()
    for path, w in _leaves(want):
        _assert_bulk_close(_get(got, path), w, "/".join(path), 1e-4, 1e-6,
                           1e-4)
    jst = jax.tree.map(lambda v: np.asarray(v)[0],
                       jax.device_get(jm.step_state["opt_state"]))
    for moment in ("m", "v"):
        for path, w in _leaves(convert.params_from_jax(jst[moment], kept)):
            scale = np.abs(w).max()
            _assert_bulk_close(_get(tm.opt_state[moment], path).numpy(), w,
                               f"{moment} {'/'.join(path)}", 1e-2 * scale,
                               1e-4 * scale, 0)
    assert {np.asarray(t).item() for t in jax.tree.leaves(jst["t"])} == {3}
    assert {int(t) for t in tree_leaves(tm.opt_state["t"])} == {3}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("cfg,err", [
    ({"tp": 2}, ValueError),          # ported: needs a world of that grid
    ({"pp": 2}, ValueError),          # ported: needs a world of that grid
    ({"sp": 2}, ValueError),          # ported: needs a world of that grid
    ({"seq_len": 192, "attn_impl": "flash"}, ValueError),
    ({"attn_impl": "ring"}, ValueError),
])
def test_unported_options_raise(cfg, err):
    with pytest.raises(err):
        TLM(dict(TINY, device="cpu", **cfg))


def test_session_api_trains_lm_on_cpu():
    """``BSP().init(...).wait()`` on the tiny LM with the flash path (plain
    versions on the CPU): finite costs, and the loss falls on the learnable
    stream."""
    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.transformer_lm",
              modelclass="TransformerLM", device="cpu", attn_impl="flash",
              seq_len=128, d_model=64, n_head=2, n_layer=2, vocab=32,
              batch_size=4, synthetic_train=32, synthetic_val=4, epochs=1,
              printFreq=1, verbose=False)
    rec = rule.wait()
    costs = [r["cost"] for r in rec.train_records]
    assert len(costs) == 8 and all(np.isfinite(costs))
    assert costs[-1] < costs[0]
    assert rule.model.params["block0"]["attn"]["wq"].device.type == "cpu"
