"""The port's LRN against the JAX package's.

``theanompi_tpu_torch.ops.lrn.lrn_plain`` (what a CPU tensor runs, and what
the CUDA kernels are held against on the card) must equal
``theanompi_tpu.ops.lrn.lrn_jnp`` forward and in its gradient (``jax.grad``).
Tolerances are those of ``tests/test_lrn_pallas.py``: float32 rtol/atol 2e-6
forward, 2e-5 gradient — the band sum is a float32 product whose summation
order differs between XLA and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops.lrn import lrn_jnp
from theanompi_tpu_torch.ops import lrn as port_lrn

CASES = [
    # (shape, beta): C = 96 / 256 (AlexNet lrn1 / lrn2), a ragged row count
    # (105 rows, no tile multiple), a 2-D input, and a general beta
    ((2, 5, 7, 96), 0.75),
    ((1, 3, 5, 256), 0.75),
    ((3, 5, 7, 96), 0.6),
    ((37, 256), 0.6),
    ((2, 4, 4, 13), 0.75),
]


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    # ~unit scale with some large values so d departs from k
    x = (r.randn(*shape) * 3.0).astype(np.float32)
    dy = r.randn(*shape).astype(np.float32)
    return x, dy


def _lrn_oracle(x, n, k, alpha, beta):
    """The same formula in float64 NumPy: the band sum as a loop over the
    window, no product with a band matrix."""
    x64 = x.astype(np.float64)
    sq, half = x64 * x64, n // 2
    ssum = np.stack([sq[..., max(0, i - half):i + half + 1].sum(-1)
                     for i in range(x.shape[-1])], -1)
    return x64 * (k + (alpha / n) * ssum) ** -beta


@pytest.mark.parametrize("shape,beta", CASES)
def test_lrn_plain_forward_matches_jax(shape, beta):
    """Each side computes from its own copy of the inputs; the float64
    oracle names the side that moved when the two disagree."""
    x, _ = _inputs(shape)
    ref = np.asarray(lrn_jnp(jnp.array(x, copy=True), 5, 2.0, 1e-4, beta))
    got = port_lrn.lrn(torch.tensor(x), 5, 2.0, 1e-4, beta).numpy()
    want = _lrn_oracle(x, 5, 2.0, 1e-4, beta)
    moved = (f"max |port - float64 oracle| {np.abs(got - want).max():.3g}, "
             f"max |jax - float64 oracle| {np.abs(ref - want).max():.3g}")
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6, err_msg=moved)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6, err_msg=moved)


@pytest.mark.parametrize("shape,beta", CASES)
def test_lrn_plain_grad_matches_jax_grad(shape, beta):
    x, dy = _inputs(shape, seed=1)
    ref = np.asarray(jax.grad(
        lambda v: jnp.sum(lrn_jnp(v, 5, 2.0, 1e-4, beta) * dy))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    port_lrn.lrn(xt, 5, 2.0, 1e-4, beta).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,beta", CASES)
def test_lrn_bwd_plain_matches_jax_grad(shape, beta):
    """The closed-form backward (B2's division-free t, no autograd) equals
    ``jax.grad`` of ``lrn_jnp`` at the gradient's float32 tolerance, for
    β = 0.75 and β = 0.6."""
    x, dy = _inputs(shape, seed=1)
    ref = np.asarray(jax.grad(
        lambda v: jnp.sum(lrn_jnp(v, 5, 2.0, 1e-4, beta) * dy))(
            jnp.asarray(x)))
    got = port_lrn.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                 5, 2.0, 1e-4, beta).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_lrn_plain_wide_window_and_large_alpha():
    """n=7 and alpha=1e-2 put the window edges and the d^-beta path to
    work harder than AlexNet's constants."""
    x, _ = _inputs((2, 3, 3, 96), seed=2)
    ref = np.asarray(lrn_jnp(jnp.asarray(x), 7, 1.0, 1e-2, 0.75))
    got = port_lrn.lrn_plain(torch.from_numpy(x), 7, 1.0, 1e-2, 0.75).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


def test_lrn_bf16_io_float32_math():
    """bf16 in, bf16 out, f32 inside: equal to the JAX formula on the same
    bf16 input (one bf16 rounding of the output either side; the f32
    internals agree to 2e-6, far below a bf16 ulp, so the results round
    alike except at rare ties — atol one bf16 ulp at this scale)."""
    x, _ = _inputs((2, 5, 5, 96), seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = port_lrn.lrn(xb).float().numpy()
    assert port_lrn.lrn(xb).dtype == torch.bfloat16
    ref = np.asarray(lrn_jnp(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), 5, 2.0, 1e-4, 0.75).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor raises
    before anything is built or counted."""
    x = torch.zeros(2, 3, 3, 96)
    before = (port_lrn.lrn_fwd_cuda.launches, port_lrn.lrn_bwd_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port_lrn.lrn_fwd_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        port_lrn.lrn_bwd_cuda(x, x)
    assert (port_lrn.lrn_fwd_cuda.launches,
            port_lrn.lrn_bwd_cuda.launches) == before


def test_cuda_request_without_cuda_raises():
    """An entry point that did not ask for the CPU raises on a machine
    without CUDA; it does not move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from theanompi_tpu_torch.models.alex_net import AlexNet
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlexNet({"batch_size": 2, "synthetic_batches": 1})
    from theanompi_tpu_torch.base import MeshProcess
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshProcess({}).get_internode_comm()


# B2's tile (elements of whole rows) and the depth of its ring of x and dy,
# as csrc/lrn.cu's kBwdTile and kBwdStages
BWD_TILE, BWD_STAGES = 2048, 2


def _ring_rows(c: int) -> int:
    """Rows of C channels that make every block of B2's persistent grid
    wrap its ring at least twice: 2 · stages tiles for each of at most 8
    resident blocks (2048 threads of 256) on every SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * BWD_STAGES * 8 * sms * (BWD_TILE // c)


def _card_tols(dtype):
    """f32: 2e-6 forward / 2e-5 gradient as above.  bf16: outputs are
    rounded to bf16 once after f32 math on both sides — one bf16 ulp
    (2^-8 relative) at the values' scale."""
    if dtype == "float32":
        return dict(rtol=2e-6, atol=2e-6), dict(rtol=2e-5, atol=2e-5)
    return (dict(rtol=2.0 ** -7, atol=2.0 ** -7),) * 2


def _card_inputs(shape, dtype, offset=0):
    """x and dy on the card; ``offset`` > 0 makes dy a contiguous view
    that many elements into a larger buffer (unaligned: B2's VEC = 1
    path)."""
    dt = getattr(torch, dtype)
    x, dy = _inputs(shape, seed=4)
    xc = torch.from_numpy(x).cuda().to(dt)
    buf = torch.zeros(dy.size + offset, dtype=dt, device="cuda")
    buf[offset:] = torch.from_numpy(dy).cuda().to(dt).reshape(-1)
    return xc, buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n,beta,offset", [
    ((4, 55, 55, 96), 5, 0.75, 0),    # AlexNet lrn1 / lrn2, 16-byte vectors
    ((4, 27, 27, 256), 5, 0.75, 0),
    ((4, 56, 56, 64), 5, 0.75, 0),    # GoogLeNet lrn1 / lrn2
    ((4, 56, 56, 192), 5, 0.75, 0),
    ("ring", 5, 0.75, 0),             # every block wraps B2's ring twice
    ((107, 96), 5, 0.75, 0),          # a short last tile (5 × 21 + 2 rows)
    ((1, 96), 5, 0.75, 0),            # a single row
    ((2, 2048), 5, 0.75, 0),          # C = MAX_CHANNELS: one row a tile
    ((3, 9, 9, 96), 5, 0.75, 1),      # unaligned dy: the VEC = 1 path
    ((2, 2048), 5, 0.6, 1),
    ((3, 5, 7, 13), 5, 0.75, 0),      # C not a multiple of the vector width
    ((2, 9, 9, 96), 7, 0.6, 0),       # wider window, the exp/log power
    ((5, 64), 1, 0.75, 0),            # window of one channel
])
def test_kernels_match_plain_on_card(shape, n, beta, offset, dtype):
    """B1/B2 against the plain version on the card (skips without one),
    B2 also against the closed-form ``lrn_bwd_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if shape == "ring":
        shape = (_ring_rows(64), 64)
    xc, dyc = _card_inputs(shape, dtype, offset)
    hyper = (n, 2.0, 1e-2, beta)
    y = port_lrn.lrn_fwd_cuda(xc, *hyper)
    xp = xc.clone().requires_grad_(True)
    yp = port_lrn.lrn_plain(xp, *hyper)
    yp.backward(dyc)
    dx = port_lrn.lrn_bwd_cuda(xc, dyc, *hyper)
    closed = port_lrn.lrn_bwd_plain(xc, dyc, *hyper)
    torch.cuda.synchronize()
    tol_y, tol_g = _card_tols(dtype)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yp.detach().float().cpu().numpy(), **tol_y)
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               xp.grad.float().cpu().numpy(), **tol_g)
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               closed.float().cpu().numpy(), **tol_g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [
    ((4, 27, 27, 256), 0), ("ring", 0), ((3, 9, 9, 96), 1)])
def test_bwd_kernel_is_deterministic_on_card(shape, offset, dtype):
    """B2 has no atomics: two runs on the same inputs are bit-equal, and
    each call launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shape == "ring":
        shape = (_ring_rows(64), 64)
    xc, dyc = _card_inputs(shape, dtype, offset)
    before = port_lrn.lrn_bwd_cuda.launches
    a = port_lrn.lrn_bwd_cuda(xc, dyc)
    b = port_lrn.lrn_bwd_cuda(xc, dyc)
    torch.cuda.synchronize()
    assert port_lrn.lrn_bwd_cuda.launches == before + 2
    assert torch.equal(a.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32),
                       b.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32))
