"""The port's LM sampler (``TransformerLM.generate``) against the JAX
package's.

* the JAX package's ``tests/test_generate.py`` one-rank cases on the port
  (trained at world 1 on the global batch those cases spread over their
  mesh): greedy continuation of the learnable +1 stream, greedy
  determinism and seeded sampling, the KV-cache sampler against the
  full-forward one (dense, and MoE with its drop-free inference routing),
  an untrained MoE model, and the overflow and empty-prompt refusals;
* greedy tokens equal to the JAX sampler's from the same converted
  parameters, float32, with and without the KV cache, dense and MoE;
* the KV path's layers against the full forward: ``apply_prefill``'s
  output is ``apply``'s and its cache the projected K/V, and each decode
  step's output the full forward's row at that position;
* ``generate`` reading the canonical params (the EMA shadow).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer_lm import \
    MoETransformerLM as JMoELM
from theanompi_tpu.models.transformer_lm import TransformerLM as JLM
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import \
    MoETransformerLM as TMoELM
from theanompi_tpu_torch.models.transformer_lm import TransformerLM as TLM
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_vgg import cpu_group  # noqa: E402,F401

CFG = dict(verbose=False, seq_len=32, vocab=16, synthetic_train=512,
           synthetic_val=64, noise=0.0, d_model=64, n_head=4, n_layer=2,
           learning_rate=3e-3)
MOE = dict(moe_experts=4, moe_every=2)


def _port(cls=TLM, batch_size=16, **kw):
    return cls(dict(CFG, batch_size=batch_size, device="cpu",
                    compute_dtype="float32", **kw))


def _train(model, n_steps):
    model.compile_iter_fns()
    model.data.shuffle_data(0)
    for i in range(n_steps):
        model.train_iter(i + 1)
    return model


# -- the JAX package's tests/test_generate.py cases ---------------------------

def test_generate_learns_the_increment_rule(cpu_group):
    """60 steps at the 4-rank case's global batch (64): greedy continuations
    follow the +1 rule for at least 80% of the tokens."""
    model = _train(_port(batch_size=64), 60)
    prompt = np.array([[3, 4, 5, 6], [11, 12, 13, 14]], np.int32)
    out = model.generate(prompt, max_new_tokens=8)
    assert out.shape == (2, 8) and out.dtype == np.int32
    want = np.stack([np.arange(7, 15) % 16, np.arange(15, 23) % 16])
    assert float(np.mean(out == want)) >= 0.8, (out, want)


def test_generate_greedy_is_deterministic_sampling_varies(cpu_group):
    model = _train(_port(batch_size=32), 10)
    p = np.array([[1, 2, 3]], np.int32)
    np.testing.assert_array_equal(model.generate(p, max_new_tokens=6),
                                  model.generate(p, max_new_tokens=6))
    s1 = model.generate(p, max_new_tokens=6, temperature=2.0, seed=1)
    s2 = model.generate(p, max_new_tokens=6, temperature=2.0, seed=2)
    assert s1.shape == (1, 6) and not np.array_equal(s1, s2)
    np.testing.assert_array_equal(
        s1, model.generate(p, max_new_tokens=6, temperature=2.0, seed=1))


def test_kv_cache_matches_full_forward_decode(cpu_group):
    """Greedy: at least 90% of the tokens agree (the two paths sum in
    other orders, so a near-tied logit may flip); sampled with one seed:
    80% (the JAX test's shares)."""
    model = _train(_port(batch_size=64), 40)
    prompt = np.array([[2, 3, 4], [9, 10, 11]], np.int32)
    kv = model.generate(prompt, max_new_tokens=10, kv_cache=True)
    full = model.generate(prompt, max_new_tokens=10, kv_cache=False)
    assert np.mean(kv == full) >= 0.9, (kv, full)
    kv_s = model.generate(prompt, max_new_tokens=6, temperature=1.0, seed=7)
    full_s = model.generate(prompt, max_new_tokens=6, temperature=1.0,
                            seed=7, kv_cache=False)
    assert np.mean(kv_s == full_s) >= 0.8, (kv_s, full_s)


def test_generate_moe_and_untrained():
    moe = _port(TMoELM, **MOE)
    out = moe.generate(np.array([0, 1, 2], np.int32), max_new_tokens=4)
    assert out.shape == (1, 4)
    assert ((0 <= out) & (out < CFG["vocab"])).all()


def test_moe_kv_cache_matches_full_forward(cpu_group):
    """MoE blocks decode through the cache too (per-token, drop-free
    routing at inference): at least 85% of the tokens agree over a
    4-row batch."""
    moe = _train(_port(TMoELM, batch_size=64, **MOE), 40)
    prompt = np.array([[2, 3, 4], [8, 9, 10], [11, 12, 13], [1, 2, 3]],
                      np.int32)
    kv = moe.generate(prompt, max_new_tokens=8, kv_cache=True)
    full = moe.generate(prompt, max_new_tokens=8, kv_cache=False)
    assert np.mean(kv == full) >= 0.85, (kv, full)


def test_generate_rejects_overflow():
    model = _port()
    with pytest.raises(AssertionError, match="seq_len"):
        model.generate(np.zeros((1, 30), np.int32), max_new_tokens=8)
    with pytest.raises(AssertionError, match="prompt token"):
        model.generate(np.zeros((1, 0), np.int32), max_new_tokens=2)
    with pytest.raises(AssertionError, match="max_new_tokens"):
        model.generate(np.zeros((1, 3), np.int32), max_new_tokens=0)


# -- against the JAX sampler --------------------------------------------------

def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("moe", [False, True])
def test_greedy_tokens_equal_the_jax_sampler(moe):
    """The JAX model trained 30 steps; its greedy tokens and the port's
    from the converted params, float32, token for token, with the KV cache
    and without."""
    jcls, tcls = (JMoELM, TMoELM) if moe else (JLM, TLM)
    kw = MOE if moe else {}
    jm = jcls(dict(CFG, batch_size=16, n_workers=1,
                   compute_dtype=jnp.float32, **kw))
    jm.compile_iter_fns()
    jm.data.shuffle_data(0)
    for c in range(1, 31):
        jm.train_iter(c)
    tm = _port(tcls, **kw)
    params = convert.params_from_jax(_host(jm.canonical_host_params()),
                                     tm.kept_layout_paths())
    prompt = np.array([[2, 3, 4, 5], [9, 10, 11, 12], [0, 7, 1, 3]],
                      np.int32)
    for kv in (True, False):
        want = jm.generate(prompt, max_new_tokens=12, kv_cache=kv)
        got = tm.generate(prompt, max_new_tokens=12, kv_cache=kv,
                          params=params)
        np.testing.assert_array_equal(got, want, err_msg=f"kv {kv}")


@pytest.mark.parametrize("moe", [False, True])
def test_prefill_and_decode_match_the_full_forward(moe):
    """Every block's ``apply_prefill`` returns ``apply``'s output (exactly:
    the same operations) and its projected K/V; then the decode steps from
    position 5 on, each fed the full forward's hidden row, give that row's
    output (rtol 1e-5 / atol 1e-5)."""
    tm = _port(TMoELM, **MOE) if moe else _port()
    p = tm.params
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(2, CFG["seq_len"], 64).astype(np.float32))
    with torch.no_grad():
        for blk in tm.blocks:
            full = blk.apply(p[blk.name], x)
            full = full[0] if isinstance(full, tuple) else full
            y, (k, v) = blk.apply_prefill(p[blk.name], x)
            assert torch.equal(y, full)
            h = blk.ln1.apply(p[blk.name]["ln1"], x)
            assert torch.equal(k, blk.attn._proj(p[blk.name]["attn"], h,
                                                 "wk"))
            cache = (k.clone(), v.clone())
            cache[0][:, :, 5:] = 0.0              # the decode rewrites these
            cache[1][:, :, 5:] = 0.0
            for pos in range(5, 12):
                y1, cache = blk.apply_decode(p[blk.name], x[:, pos:pos + 1],
                                             cache, pos)
                np.testing.assert_allclose(y1[:, 0].numpy(),
                                           full[:, pos].numpy(), rtol=1e-5,
                                           atol=1e-5)
            torch.testing.assert_close(cache[0][:, :, :12], k[:, :, :12])


def test_generate_reads_the_ema_shadow(cpu_group):
    """Under ``ema_decay`` the sampler's default params are the shadow
    (``canonical_params``), not the live replica."""
    model = _train(_port(ema_decay=0.5), 5)
    prompt = np.array([[1, 2, 3]], np.int32)
    shadow = TH.tree_map(lambda t: t.detach().clone(),
                         model.opt_state["ema"])
    np.testing.assert_array_equal(
        model.generate(prompt, max_new_tokens=5),
        model.generate(prompt, max_new_tokens=5, params=shadow))
