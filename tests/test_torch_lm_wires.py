"""The transformer LM under the compressed wires, against the JAX package.

The LM's embedding tables (``embed.w`` [vocab, dim] and ``pos.w``
[seq_len, dim]) keep their layout in both packages, where every other 2-D
weight is transposed, so the wires must lay a leaf out as the model
declares it (``ModelBase.kept_layout_paths``):

* ``helper_funcs.flatten_tree_jax`` of the LM's tree is the JAX package's
  ``flatten_tree`` bit for bit (the topk wire's flat order);
* a 3-step BSP trajectory at world 1 under ``exch_strategy='powersgd1'`` and
  under ``'topk'`` (chunk 256, so that the tables span several chunk rows),
  both packages from the same weights (``convert.params_from_jax``), data
  and initial wire state (``convert.powersgd_state_from_jax``; topk starts
  at zero), both with ``attn_impl='reference'`` (the JAX model's flash path
  cannot run inside its step on jax 0.9.0; see
  ``test_torch_transformer_lm.py``).  One case sets vocab == seq_len ==
  d_model, so that both tables are square and a wrong orientation keeps
  every shape;
* the build-time refusal of the flash kernels' unsupported dtypes on a
  CUDA device, checked without a card.
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
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import TransformerLM as TLM
from theanompi_tpu_torch.models.transformer_lm import check_flash_dtype
from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger as TBSP
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_vgg import cpu_group  # noqa: E402,F401

TOPK_CHUNK = 256


def _tiny(seq_len, strategy, vocab=64):
    return dict(vocab=vocab, d_model=32, n_head=2, n_layer=2, seq_len=seq_len,
                batch_size=4, synthetic_train=12, synthetic_val=4,
                attn_impl="reference", exch_strategy=strategy, verbose=False)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _models(seq_len, strategy, vocab):
    """The JAX LM and the port's from its weights, float32, each compiled
    with its BSP exchanger (topk with a chunk of TOPK_CHUNK)."""
    cfg = _tiny(seq_len, strategy, vocab)
    jm = JLM(dict(cfg, n_workers=1, compute_dtype=jnp.float32))
    tm = TLM(dict(cfg, device="cpu", compute_dtype="float32"))
    jp0 = _host(jm.params)
    tm.load_params(convert.params_from_jax(jp0, tm.kept_layout_paths()))
    jx, tx = JBSP(jm.config), TBSP(tm.config)
    if strategy == "topk":
        jx.strategy.chunk = tx.strategy.chunk = TOPK_CHUNK
    jm.compile_iter_fns(jx)
    tm.compile_iter_fns(tx)
    return jm, tm, jp0


def test_flatten_tree_jax_of_the_lm_bit_equal_to_the_jax_package():
    """The LM's tree (tables [vocab, dim], projections [out, in] in the
    port) flattens to the JAX package's ``flatten_tree`` of the same
    parameters, and ``unflatten_like_jax`` gives the port's leaves back."""
    jm = JLM(dict(_tiny(32, "allreduce"), n_workers=1,
                  compute_dtype=jnp.float32))
    kept = TLM(dict(_tiny(32, "allreduce"), device="cpu")).kept_layout_paths()
    assert kept == {("embed", "w"), ("pos", "w")}
    jp = _host(jm.params)
    ttree = TH.tree_map(torch.from_numpy, convert.params_from_jax(jp, kept))
    want = np.asarray(JH.flatten_tree(jp, pad_to_multiple_of=TOPK_CHUNK))
    got = TH.flatten_tree_jax(ttree, pad_to_multiple_of=TOPK_CHUNK, kept=kept)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    back = TH.unflatten_like_jax(ttree, got, kept)
    for path in TH.leaf_paths(ttree):
        assert torch.equal(TH.get_leaf(back, path), TH.get_leaf(ttree, path))


def _check_trajectory_end(jm, tm):
    """Params and Adam moments after the steps, to the VGG trajectories'
    tolerances (params rtol 1e-5 / atol 1e-6, moments rtol 1e-5 / atol
    1e-7)."""
    kept = tm.kept_layout_paths()
    want = convert.params_from_jax(_host(jm.canonical_host_params()), kept)
    got = tm.host_params()
    for path in TH.jax_leaf_paths(want):
        np.testing.assert_allclose(TH.get_leaf(got, path),
                                   TH.get_leaf(want, path), rtol=1e-5,
                                   atol=1e-6, err_msg="/".join(path))
    jst = jax.tree.map(lambda v: np.asarray(v)[0],
                       jax.device_get(jm.step_state["opt_state"]))
    for moment in ("m", "v"):
        want_m = convert.params_from_jax(jst[moment], kept)
        for path in TH.jax_leaf_paths(want_m):
            np.testing.assert_allclose(
                TH.get_leaf(tm.opt_state[moment], path).numpy(),
                TH.get_leaf(want_m, path), rtol=1e-5, atol=1e-7,
                err_msg=f"{moment} {'/'.join(path)}")


@pytest.mark.parametrize("vocab,seq_len", [(32, 32), (64, 48)])
def test_powersgd1_lm_three_step_trajectory_matches_jax(cpu_group, vocab,
                                                        seq_len):
    """3 Adam steps under ``powersgd1``, both packages from the JAX
    package's initial state.  Costs rtol 1e-5; params and moments as in
    ``_check_trajectory_end``; ``e`` rtol 1e-5 / atol 1e-6, ``q`` too up to
    each column's sign (the tolerances of the VGG trajectory,
    ``test_torch_powersgd.py``).  At vocab = seq_len = d_model = 32 both
    tables are square."""
    jm, tm, jp0 = _models(seq_len, "powersgd1", vocab)

    def jax_state():
        return jax.tree.map(lambda v: np.asarray(v)[0],
                            jax.device_get(jm.step_state["extra"]["strat"]))

    kept = tm.kept_layout_paths()
    st0 = convert.powersgd_state_from_jax(jax_state(), jp0, tm.params, kept)
    paths = TH.leaf_paths(tm.params)
    for name, dim in (("embed", vocab), ("pos", seq_len)):
        s = st0[paths.index((name, "w"))]
        assert s["e"].shape == (dim, 32) and s["q"].shape == (32, 1)
    tm.extra["strat"] = [{k: torch.from_numpy(v) for k, v in s.items()}
                         for s in st0]
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)
    _check_trajectory_end(jm, tm)
    want_s = convert.powersgd_state_from_jax(jax_state(), jp0, tm.params,
                                             kept)
    for path, w, g in zip(paths, want_s, tm.extra["strat"]):
        q = g["q"].numpy()
        assert q.shape == w["q"].shape, path
        sign = np.where((w["q"] * q).sum(0) < 0, -1.0, 1.0)
        np.testing.assert_allclose(q, w["q"] * sign, rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))
        np.testing.assert_allclose(g["e"].numpy(), w["e"], rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("vocab,seq_len", [(32, 32), (64, 48)])
def test_topk_lm_three_step_trajectory_matches_jax(cpu_group, vocab,
                                                   seq_len):
    """3 Adam steps under ``topk`` with a chunk of 256: costs rtol 1e-5,
    params and moments as in ``_check_trajectory_end``, and the error
    state, which the port keeps in the JAX order, element for element
    (rtol 1e-5 / atol 1e-6, the VGG trajectory's)."""
    jm, tm, _ = _models(seq_len, "topk", vocab)
    n = sum(int(p.numel()) for p in TH.tree_leaves(tm.params))
    assert tm.extra["strat"].shape == (n + (-n) % TOPK_CHUNK,)
    for count in (1, 2, 3):
        jm.train_iter(count)
        tm.train_iter(count)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)
    _check_trajectory_end(jm, tm)
    jstate = np.asarray(jax.device_get(jm.step_state["extra"]["strat"]))[0]
    got_s = tm.extra["strat"].numpy()
    assert got_s.any()
    np.testing.assert_allclose(got_s, jstate, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("attn_impl,dtype,device,refused", [
    ("flash", torch.float32, "cuda", False),    # the float32 kernels
    ("flash", torch.float16, "cuda:0", True),
    ("flash", torch.bfloat16, "cuda", False),
    ("flash", torch.float32, "cpu", False),      # the plain versions
    ("reference", torch.float32, "cuda", False),
])
def test_flash_dtype_checked_at_build(attn_impl, dtype, device, refused):
    """``TransformerLM.build_model`` runs this check: flash with a compute
    dtype other than bfloat16 or float32 is refused on a CUDA device (the
    kernels' two instantiations), with a message that names them; no card
    is needed to check it."""
    if refused:
        with pytest.raises(ValueError,
                           match="B10-B12 take bfloat16 or float32"):
            check_flash_dtype(attn_impl, dtype, torch.device(device))
    else:
        check_flash_dtype(attn_impl, dtype, torch.device(device))


def test_flash_float32_builds_on_cpu():
    """The CPU route keeps every dtype: a float32 flash LM builds and runs
    its plain versions."""
    tm = TLM(dict(_tiny(128, "allreduce"), attn_impl="flash", device="cpu",
                  compute_dtype="float32"))
    x = torch.zeros(1, 128, dtype=torch.int64)
    assert tm.apply_model(tm.params, x, train=False, gen=None,
                          state=tm.bn_state).dtype == \
        torch.float32
