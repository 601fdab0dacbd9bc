"""The float32 flash kernels: B10–B12 in float32
(``csrc/flash_attention_f32.cu``).

On the CPU: the kernels' checks take float32 as well as bfloat16 and refuse
float16, the float32 wrappers refuse CPU tensors without counting, and the
model's dispatch picks each dtype's wrappers.  The float32 plain versions
are held against JAX's packaged TPU kernel in interpret mode by
``tests/test_torch_flash_attention.py``.

On the card (``-m cuda``; skipped without one): each float32 kernel against its
float32 plain version, TF32 off, within :data:`F32_TOL` of max|plain| — a
float32 summation-order bound: an output sums up to T = 640 products, each
sum's reordering moves it by at most n·2⁻²⁴ of the largest partial sum
(2⁻¹⁴·⁷ at n = 640), and expf/logf differ by an ulp or two from torch's;
2⁻¹⁴ (6.1e-5) holds both.  A TF32 product (10-bit mantissa) would be ~1e-3
away and fails it.  And a rerun gives the same bits.
"""

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.ops import flash_attention as F

F32_TOL = 2.0 ** -14


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 3, 64, 32),
                                   (1, 2, 192, 128)])
def test_kernel_checks_take_both_dtypes(shape, dtype):
    """bfloat16 and float32 pass the kernels' dtype and shape checks (meta
    tensors: no card needed)."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    F.check_layout("flash_fwd_cuda", x, x, x)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3,
    (torch.float64,) * 3,
    (torch.float32, torch.bfloat16, torch.float32),    # mixed
])
def test_kernel_checks_refuse_other_dtypes(dtypes):
    """float16 (and any other dtype, or a mix) is refused with a message
    that names both dtypes the kernels take."""
    ts = [torch.empty(1, 1, 128, 64, dtype=d, device="meta") for d in dtypes]
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        F.check_layout("flash_fwd_cuda", *ts)


def test_float32_wrappers_refuse_cpu_tensors():
    """The float32 wrappers never run the plain version: a CPU tensor raises
    before anything is built or counted."""
    x = torch.zeros(1, 1, 64, 64)
    stat = torch.zeros(1, 1, 64)
    before = [f.launches for f in F.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_fwd_f32_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_bwd_dkv_f32_cuda(x, x, x, x, stat, stat)
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_bwd_dq_f32_cuda(x, x, x, x, stat, stat)
    assert [f.launches for f in F.KERNELS] == before


def test_each_dtype_has_its_own_counted_wrappers():
    """Six wrappers, each with a count of its own; a float32 tensor goes to
    the float32 three, a bfloat16 one to the bfloat16 three."""
    assert len(F.KERNELS) == len({id(f) for f in F.KERNELS}) == 6
    assert all(isinstance(f.launches, int) for f in F.KERNELS)
    f32 = torch.empty(1, 1, 64, 64, device="meta")
    bf = f32.to(torch.bfloat16)
    assert F._kernels(f32) == (F.flash_fwd_f32_cuda, F.flash_bwd_dkv_f32_cuda,
                               F.flash_bwd_dq_f32_cuda)
    assert F._kernels(bf) == (F.flash_fwd_cuda, F.flash_bwd_dkv_cuda,
                              F.flash_bwd_dq_cuda)
    # a meta tensor reaches the float32 wrapper, which refuses its device
    with pytest.raises(ValueError, match="flash_fwd_f32_cuda"):
        F._fwd_cuda(f32, f32, f32, True, None)


def test_float32_cpu_route_is_plain_and_uncounted():
    """On CPU tensors the op runs the plain versions in float32: the same
    numbers as calling them, no kernel counted."""
    r = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(r.randn(1, 2, 128, 32).astype(np.float32))
                   for _ in range(4))
    before = [f.launches for f in F.KERNELS]
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = F.flash_attention(*ts)
    o.backward(do)
    po, lse = F.flash_fwd_plain(q, k, v)
    assert torch.equal(o.detach(), po)
    for t, want in zip(ts, F.flash_bwd_plain(q, k, v, po, lse, do)):
        assert torch.equal(t.grad, want)
    assert [f.launches for f in F.KERNELS] == before


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card_inputs(shape, strided, seed=0):
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk():
        if strided:
            return torch.randn(b, t, h, d, generator=g,
                               device="cuda").transpose(1, 2)
        return torch.randn(shape, generator=g, device="cuda")

    return mk(), mk(), mk(), mk()


def _run(q, k, v, do, causal):
    o, lse = F.flash_fwd_f32_cuda(q, k, v, causal)
    di = F.attention_di(o, do)
    dk, dv = F.flash_bwd_dkv_f32_cuda(q, k, v, do, lse, di, causal)
    dq = F.flash_bwd_dq_f32_cuda(q, k, v, do, lse, di, causal)
    return o, lse, dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,strided", [
    ((2, 2, 256, 64), True, False),
    ((1, 2, 128, 32), True, False),
    ((1, 2, 256, 128), True, False),
    ((4, 8, 512, 64), True, True),     # as the model hands them
    ((2, 2, 256, 64), False, True),
    ((2, 2, 192, 64), True, True),     # T a multiple of 64, not of 128
    ((1, 4, 640, 64), True, True),
    ((2, 2, 256, 128), False, True),
])
def test_f32_kernels_match_plain_on_card(card, shape, causal, strided):
    q, k, v, do = _card_inputs(shape, strided)
    o, lse, dq, dk, dv = _run(q, k, v, do, causal)
    torch.cuda.synchronize()
    po, plse = F.flash_fwd_plain(q, k, v, causal)
    pdq, pdk, pdv = F.flash_bwd_plain(q, k, v, o, lse, do, causal)
    for name, got, ref in (("o", o, po), ("lse", lse, plse), ("dq", dq, pdq),
                           ("dk", dk, pdk), ("dv", dv, pdv)):
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=F32_TOL,
                                   atol=F32_TOL * np.abs(ref).max(),
                                   err_msg=name)
    if strided:
        assert o.stride() == q.stride()


@pytest.mark.cuda
def test_f32_kernels_are_deterministic_on_card(card):
    q, k, v, do = _card_inputs((4, 8, 512, 64), strided=True)
    first = _run(q, k, v, do, True)
    again = _run(q, k, v, do, True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
