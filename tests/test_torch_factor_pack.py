"""The port's PowerSGD factor products against the JAX package's.

The plain ``matmul_pack`` (what a CPU tensor runs, and what the CUDA kernel
B9 is held against on the card) against the jnp oracle
``matmul_pack_jnp``, in both orientations: the port reads the JAX
package's matrix ``M`` through its transpose ``A`` (``transpose=True``
gives ``Aᵀ q = M q``) and the other product reads ``A`` as it is.  The pad
rows are exactly 0.

Bound: both sides are float32 dot products of length n summed in another
order (XLA's and oneDNN's blocking on the CPU; the kernel's on the card),
so each element is within ``2·γ_n·Σ|a_k q_k|`` of the other, γ_n =
n·u/(1 − n·u), u = 2⁻²⁴ (the standard bound on a float32 dot product,
taken once for each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops import factor_pack as JF
from theanompi_tpu_torch.ops import factor_pack as TF

U = 2.0 ** -24


def dot_bound(m: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Per element of ``m @ q``: 2·γ_n·(|m| @ |q|), n = the inner length."""
    n = m.shape[1]
    gamma = n * U / (1 - n * U)
    return 2 * gamma * (np.abs(m).astype(np.float64) @ np.abs(q))


@pytest.mark.parametrize("rows,cols,rank", [(27, 64, 2), (72, 8, 1),
                                            (4096, 512, 2), (5, 32, 3),
                                            (64, 9, 4)])
@pytest.mark.parametrize("transpose", [False, True])
def test_matmul_pack_plain_matches_the_oracle(rows, cols, rank, transpose):
    r = np.random.RandomState(rows + cols)
    m = r.randn(rows, cols).astype(np.float32)          # the JAX matrix
    q = r.randn(cols, rank).astype(np.float32)
    rows_pad = JF.pad_rows(rows)
    assert TF.pad_rows(rows) == rows_pad
    want = np.asarray(JF.matmul_pack_jnp(jnp.asarray(m), jnp.asarray(q),
                                         rows_pad))
    a = torch.from_numpy(np.ascontiguousarray(m.T) if transpose else m)
    got = TF.matmul_pack(a, torch.from_numpy(q), transpose=transpose).numpy()
    assert got.shape == (rows_pad, rank)
    np.testing.assert_array_equal(got[rows:], 0.0)
    assert not np.signbit(got[rows:]).any()              # +0.0
    err = np.abs(got[:rows].astype(np.float64) - want[:rows])
    assert (err <= dot_bound(m, q)).all(), err.max()


def test_explicit_rows_pad_and_refusals():
    a, q = torch.ones(10, 6), torch.ones(6, 2)
    got = TF.matmul_pack(a, q, rows_pad=24)
    assert got.shape == (24, 2) and (got[:10] == 6).all() and \
        not got[10:].any()
    with pytest.raises(ValueError, match="rows_pad 12"):
        TF.matmul_pack(a, q, rows_pad=12)
    with pytest.raises(ValueError, match="rows_pad 8"):
        TF.matmul_pack(a, q, rows_pad=8)
    with pytest.raises(ValueError, match="times q"):
        TF.matmul_pack(a, q, transpose=True)
    with pytest.raises(TypeError, match="float32"):
        TF.matmul_pack(a.double(), q)
    before = TF.matmul_pack_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        TF.matmul_pack_cuda(a, q)
    assert TF.matmul_pack_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(64, 27), (512, 4608), (4096, 4096),
                                       (1000, 4096), (37, 1001)])
@pytest.mark.parametrize("rank", [1, 2, 5])
def test_matmul_pack_kernel_matches_plain_on_card(rows, cols, rank):
    """B9 in both orientations against ``torch.matmul`` (TF32 off) within
    the dot-product bound above; pad rows exactly +0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(rows * cols + rank)
    a = torch.randn(rows, cols, generator=g, device="cuda")
    for transpose, inner in ((False, cols), (True, rows)):
        q = torch.randn(inner, rank, generator=g, device="cuda")
        got = TF.matmul_pack_cuda(a, q, transpose=transpose)
        want = TF.matmul_pack_plain(a, q, transpose=transpose)
        n_out = cols if transpose else rows
        assert got.shape == want.shape == (TF.pad_rows(n_out), rank)
        pad = got[n_out:]
        assert not pad.any() and not torch.signbit(pad).any()
        m = a.t() if transpose else a
        bound = 2 * inner * U / (1 - inner * U) * (m.abs() @ q.abs())
        err = (got[:n_out] - want[:n_out]).abs()
        assert bool((err <= bound).all()), float(err.max())
