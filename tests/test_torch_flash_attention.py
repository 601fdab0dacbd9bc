"""The port's flash attention against JAX's packaged TPU kernel.

``theanompi_tpu_torch.ops.flash_attention.flash_attention`` on CPU tensors
(the plain versions behind ``FlashAttentionFunction``) must equal
``jax.experimental.pallas.ops.tpu.flash_attention`` — the kernel the JAX
package's ``MultiHeadAttention`` calls for ``attn_impl='flash'`` — run in
Pallas's TPU interpret mode on the CPU, forward and in its VJP, causal, with
``sm_scale = hd**-0.5``.  float32 inputs from a numpy seed.  atol 1e-5: the
two sides sum the same f32 products in another order (the TPU kernel in
128-wide blocks with an online softmax, the plain version over whole rows);
the measured difference is ~2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import \
    flash_attention as jax_flash_attention

from theanompi_tpu_torch.ops import flash_attention as F

SHAPES = [(2, 2, 256, 64), (1, 2, 128, 32)]
ATOL = 1e-5


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(*shape).astype(np.float32) for _ in range(4))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    """Inputs and the TPU kernel's o, dq, dk, dv (interpret mode), once per
    shape."""
    shape = request.param
    q, k, v, do = _inputs(shape)
    scale = shape[-1] ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
            a, b, c, causal=True, sm_scale=scale),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return {"inputs": (q, k, v, do), "o": np.asarray(o),
            "grads": [np.asarray(g) for g in grads]}


def test_forward_matches_tpu_kernel(case):
    q, k, v, _ = case["inputs"]
    got = F.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), case["o"], rtol=0, atol=ATOL)


def test_autograd_gradients_match_tpu_kernel_vjp(case):
    q, k, v, do = case["inputs"]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    F.flash_attention(*ts).backward(torch.from_numpy(do))
    for name, t, want in zip("qkv", ts, case["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")


def test_plain_backward_matches_tpu_kernel_vjp(case):
    """``flash_bwd_plain`` called directly on the forward's o and lse."""
    q, k, v, do = map(torch.from_numpy, case["inputs"])
    o, lse = F.flash_fwd_plain(q, k, v)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    for name, got, want in zip("qkv", F.flash_bwd_plain(q, k, v, o, lse, do),
                               case["grads"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")


def test_lse_is_the_row_logsumexp():
    """lse = log Σ_k exp(s) over the causal keys, in f32."""
    q, k, v, _ = map(torch.from_numpy, _inputs((1, 2, 128, 32), seed=1))
    _, lse = F.flash_fwd_plain(q, k, v)
    s = (q @ k.transpose(-1, -2)) * 32 ** -0.5
    s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1),
                      float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_bf16_plain_rounds_p_before_pv():
    """bf16 in, bf16 out; p is rounded to bf16 before the p·v product, as
    the TPU kernel does (flash_attention.py:470): the output equals the f32
    formula with that rounding, to one bf16 rounding of the result."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs((1, 1, 128, 64), seed=2))
    o, _ = F.flash_fwd_plain(q, k, v)
    assert o.dtype == torch.bfloat16
    s = (q.float() @ k.float().transpose(-1, -2)) * 0.125
    s = s + torch.where(torch.ones(128, 128, dtype=torch.bool).triu(1),
                        F.MASK_VALUE, 0.0)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1, keepdim=True)
    np.testing.assert_allclose(o.float().numpy(), want.numpy(), rtol=2 ** -8,
                               atol=0)


def test_non_causal_matches_softmax():
    q, k, v, _ = map(torch.from_numpy, _inputs((1, 2, 128, 32), seed=3))
    got = F.flash_attention(q, k, v, causal=False)
    want = torch.softmax((q @ k.transpose(-1, -2)) * 32 ** -0.5, -1) @ v
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor raises
    before anything is built or counted."""
    x = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    stat = torch.zeros(1, 1, 64)
    before = [f.launches for f in F.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_bwd_dkv_cuda(x, x, x, x, stat, stat)
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_bwd_dq_cuda(x, x, x, x, stat, stat)
    assert [f.launches for f in F.KERNELS] == before


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 1, 96, 64), torch.bfloat16, "multiple of 64"),   # T % 64
    ((1, 1, 128, 48), torch.bfloat16, "multiple of 64"),  # head dim 48
    ((1, 128, 64), torch.bfloat16, "multiple of 64"),     # not 4-D
    ((1, 1, 128, 64), torch.float32, "bfloat16"),         # f32 on the card
])
def test_kernel_checks_refuse_bad_inputs(shape, dtype, match):
    """What the kernels do not take raises with a clear message: the
    wrappers' dtype and shape checks, run here on meta tensors (a CUDA
    tensor meets the same checks after its device check)."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises((ValueError, TypeError), match=match):
        F.check_layout("flash_fwd_cuda", x, x, x)


def test_mismatched_shapes_raise():
    x = torch.zeros(1, 1, 64, 32)
    with pytest.raises(ValueError, match="differ"):
        F.flash_attention(x, x, torch.zeros(1, 1, 128, 32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(shape, strided, seed=0):
    """q, k, v, dO on the card: contiguous, or as the model hands them
    (transposed views of [B, T, H, hd])."""
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk():
        if strided:
            return torch.randn(b, t, h, d, generator=g, device="cuda").to(
                torch.bfloat16).transpose(1, 2)
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    return mk(), mk(), mk(), mk()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,strided", [
    ((2, 2, 256, 64), True, False),
    ((1, 2, 128, 32), True, False),
    ((1, 2, 256, 128), True, False),
    ((4, 8, 512, 64), True, True),     # q, k, v as the model hands them
    ((2, 2, 256, 64), False, True),
    ((2, 2, 192, 64), True, True),     # T a multiple of 64, not of 128
    ((1, 3, 320, 32), False, True),
    ((2, 2, 256, 128), False, True),   # hd 128, non-causal, strided
    ((1, 4, 640, 64), True, True),     # B·H·T/64 = 40 CTAs < 132 SMs
])
def test_kernels_match_plain_on_card(card, shape, causal, strided):
    """B10–B12 against the plain versions on the card (skips without one).
    rtol/atol 2^-7 (of max|plain|): both sides round their f32 sums to bf16
    once, summed in another order, and round p and dS to bf16 at the same
    points — one or two bf16 ulps."""
    q, k, v, do = _card_inputs(shape, strided)
    o, lse = F.flash_fwd_cuda(q, k, v, causal)
    di = F.attention_di(o, do)
    dk, dv = F.flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal)
    dq = F.flash_bwd_dq_cuda(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    po, plse = F.flash_fwd_plain(q, k, v, causal)
    want = dict(zip(("dq", "dk", "dv"),
                    F.flash_bwd_plain(q, k, v, o, lse, do, causal)))
    for name, got, ref in (("o", o, po), ("dq", dq, want["dq"]),
                           ("dk", dk, want["dk"]), ("dv", dv, want["dv"])):
        ref = ref.float().cpu().numpy()
        np.testing.assert_allclose(got.float().cpu().numpy(), ref,
                                   rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_allclose(lse.cpu().numpy(), plse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    if strided:
        assert o.stride() == q.stride()      # o comes back laid out like q


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((4, 8, 512, 64), True),
    ((2, 2, 256, 128), False),
])
def test_kernels_are_deterministic_on_card(card, shape, causal):
    """B10, B11 and B12 sum each output tile in one CTA in a fixed order,
    with no atomics: two runs on the same inputs give bit-identical o, lse,
    dk, dv and dq."""
    q, k, v, do = _card_inputs(shape, strided=True)
    o, lse = F.flash_fwd_cuda(q, k, v, causal)
    di = F.attention_di(o, do)
    dk, dv = F.flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal)
    dq = F.flash_bwd_dq_cuda(q, k, v, do, lse, di, causal)
    o2, lse2 = F.flash_fwd_cuda(q, k, v, causal)
    dk2, dv2 = F.flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal)
    dq2 = F.flash_bwd_dq_cuda(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    for name, a, b in (("o", o, o2), ("lse", lse, lse2), ("dk", dk, dk2),
                       ("dv", dv, dv2), ("dq", dq, dq2)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b.view(torch.int32)), name
