"""The rest of the LM at one rank: token files and ``remat``.

* ``TokenFileData`` against the JAX package's on token files the test
  writes (raw ``.bin`` in ``uint16`` and ``uint32``, ``.npy``): every
  batch of an epoch bit for bit, after the common-seed shuffle, rank by
  rank at 2 ranks; the resume cursor (a data object set to the cursor
  mid-epoch continues the stream); the out-of-vocabulary assertion;
* ``data_dir`` selecting the token files in ``TransformerLM`` (and the MoE
  model), a few BSP steps from them, and the same steps as the JAX model
  takes from the same files and weights;
* ``remat``: the loss and every gradient leaf equal to the plain forward's
  on the CPU, bit for bit (the same operations recomputed), through the
  eager step and the static step the card captures (3 steps, params and
  Adam state bit for bit).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.data.tokens import TokenFileData as JTok
from theanompi_tpu.models.transformer_lm import TransformerLM as JLM
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.data.tokens import TokenFileData as TTok
from theanompi_tpu_torch.models.transformer_lm import \
    MoETransformerLM as TMoELM
from theanompi_tpu_torch.models.transformer_lm import TransformerLM as TLM
from theanompi_tpu_torch.utils import helper_funcs as TH

import sys
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_vgg import cpu_group  # noqa: E402,F401


def write_tokens(d, n_train, n_val, vocab, dtype="uint16", kind="bin",
                 seed=0):
    """``train`` and ``val`` token files of ``n_*`` random ids below
    ``vocab`` under ``d``: raw little-endian (``.bin``) or ``.npy``."""
    r = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    for split, n in (("train", n_train), ("val", n_val)):
        a = r.randint(0, vocab, n).astype(dtype)
        if kind == "bin":
            a.tofile(os.path.join(d, f"{split}.bin"))
        else:
            np.save(os.path.join(d, f"{split}.npy"), a)
    return d


@pytest.mark.parametrize("dtype,kind", [("uint16", "bin"), ("uint32", "bin"),
                                        ("uint16", "npy")])
@pytest.mark.parametrize("size", [1, 2])
def test_token_batches_bit_equal_to_jax(tmp_path, dtype, kind, size):
    """Two epochs (shuffles 3 and 4) and the validation batches, rank r's
    rows r·b..(r+1)·b of the JAX package's global batch, int32, bit for
    bit; a data object given the JAX object's cursor mid-epoch continues
    its stream."""
    d = write_tokens(str(tmp_path), 1000, 300, 500, dtype, kind)
    b, T = 3, 16
    cfg = {"data_dir": d, "token_dtype": dtype, "size": size,
           "process_count": 1, "process_index": 0}
    jd = JTok(cfg, b, T, vocab=500)
    ports = [TTok(dict(cfg, rank=r), b, T, vocab=500) for r in range(size)]
    assert ports[0].n_batch_train == jd.n_batch_train > 2
    for epoch in (3, 4):
        jd.shuffle_data(epoch)
        for td in ports:
            td.shuffle_data(epoch)
        for count in range(jd.n_batch_train):
            want = jd.next_train_batch(count)
            for r, td in enumerate(ports):
                got = td.next_train_batch(count)
                for k in ("x", "y"):
                    assert got[k].dtype == np.int32
                    np.testing.assert_array_equal(
                        got[k], want[k][r * b:(r + 1) * b])
    for _ in range(jd.n_batch_val):
        want = jd.next_val_batch(0)
        for r, td in enumerate(ports):
            np.testing.assert_array_equal(td.next_val_batch(0)["x"],
                                          want["x"][r * b:(r + 1) * b])
    jd.shuffle_data(5)
    jd.next_train_batch(1)
    jd.next_train_batch(2)
    resumed = TTok(dict(cfg, rank=0), b, T, vocab=500)
    resumed.set_cursor(jd.get_cursor())
    np.testing.assert_array_equal(resumed.next_train_batch(3)["x"],
                                  jd.next_train_batch(3)["x"][:b])


def test_out_of_vocab_token_is_refused(tmp_path):
    """A corpus with an id at or past the model's vocabulary fails the
    batch, in both packages, with the same message."""
    d = write_tokens(str(tmp_path), 400, 100, 70)
    for cls in (JTok, TTok):
        data = cls({"data_dir": d}, 2, 16, vocab=64)
        with pytest.raises(AssertionError, match="vocab=64"):
            for c in range(data.n_batch_train):
                data.next_train_batch(c)


def test_missing_token_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="train.bin"):
        TTok({"data_dir": str(tmp_path)}, 2, 16)


TINY = dict(seq_len=32, d_model=32, n_head=2, n_layer=2, vocab=64,
            batch_size=4, verbose=False)


@pytest.mark.parametrize("cls", [TLM, TMoELM])
def test_data_dir_selects_token_files(tmp_path, cls):
    d = write_tokens(str(tmp_path), 2000, 300, 64)
    m = cls(dict(TINY, device="cpu", data_dir=d))
    assert isinstance(m.data, TTok) and m.data._vocab == 64


def test_lm_from_token_files_matches_jax(cpu_group, tmp_path):
    """3 Adam steps of the LM from the same token files and weights: the
    cost of each step rtol 1e-5 (float32, reference attention)."""
    d = write_tokens(str(tmp_path), 2000, 300, 64)
    cfg = dict(TINY, data_dir=d, attn_impl="reference")
    jm = JLM(dict(cfg, n_workers=1, compute_dtype=jnp.float32))
    tm = TLM(dict(cfg, device="cpu", compute_dtype="float32"))
    tm.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(jm.params)),
        tm.kept_layout_paths()))
    jm.compile_iter_fns()
    tm.compile_iter_fns()
    jm.data.shuffle_data(1)
    tm.data.shuffle_data(1)
    for c in (1, 2, 3):
        jm.train_iter(c)
        tm.train_iter(c)
        np.testing.assert_allclose(float(tm.current_info["cost"]),
                                   float(jm.current_info["cost"]), rtol=1e-5)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_remat_gradients_equal_the_plain_forward(attn_impl):
    """``remat`` recomputes each block's forward in the backward: the loss
    and every gradient leaf are the plain forward's bit for bit."""
    cfg = dict(TINY, seq_len=128, device="cpu", compute_dtype="float32",
               attn_impl=attn_impl, synthetic_train=8, synthetic_val=4)
    plain, remat = TLM(cfg), TLM(dict(cfg, remat=True))
    batch = {k: torch.from_numpy(v)
             for k, v in plain.data.next_train_batch(1).items()}
    out = []
    for m in (plain, remat):
        cost, _ = m.loss_and_metrics(m.params, m.bn_state, batch, None, True)
        out.append((cost, torch.autograd.grad(cost,
                                              TH.tree_leaves(m.params))))
    assert torch.equal(out[0][0], out[1][0])
    for p, a, b in zip(TH.leaf_paths(plain.params), out[0][1], out[1][1]):
        assert torch.equal(a, b), p


def test_remat_is_inert_outside_training():
    """Validation and sampling run the plain forward (no checkpoint
    wrapper), as the JAX package's ``train and remat``."""
    cfg = dict(TINY, device="cpu", compute_dtype="float32", remat=True,
               synthetic_train=8, synthetic_val=4)
    m = TLM(cfg)
    x = torch.from_numpy(m.data.next_val_batch(0)["x"])
    with torch.no_grad():
        a = m.apply_model(m.params, x, train=False, gen=None, state=None)
    b = TLM(dict(cfg, remat=False)).apply_model(m.params, x, train=False,
                                                gen=None, state=None)
    assert torch.equal(a, b.detach())


@pytest.mark.parametrize("capture", [False, True])
def test_remat_steps_bit_equal_to_plain(cpu_group, capture):
    """3 BSP steps with and without ``remat``, eager and through the static
    step: costs, params and Adam state bit for bit."""
    cfg = dict(TINY, device="cpu", compute_dtype="float32",
               synthetic_train=16, synthetic_val=4)
    states = []
    for remat in (False, True):
        m = TLM(dict(cfg, remat=remat))
        m.compile_iter_fns(capture=capture)
        m.data.shuffle_data(0)
        costs = []
        for c in (1, 2, 3):
            m.train_iter(c)
            costs.append(m.current_info["cost"].clone())
        states.append(costs + [t.detach().clone() for t in
                               TH.tree_leaves(m.params)
                               + TH.tree_leaves(m.opt_state)])
    for a, b in zip(*states):
        assert torch.equal(a, b)
