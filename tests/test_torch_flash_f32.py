"""The float32 flash kernels: B10–B12 in float32
(``csrc/flash_attention_f32.cu``).

On the CPU: the kernels' checks take float32 as well as bfloat16 and refuse
float16, the float32 wrappers refuse CPU tensors without counting, and the
model's dispatch picks each dtype's wrappers.  The float32 plain versions
are held against JAX's packaged TPU kernel in interpret mode by
``tests/test_torch_flash_attention.py``.

The split-TF32 arithmetic of B11 and B12 on the CPU: an emulation of the
kernels' split (x = hi + lo, both rounded to TF32; products of TF32 values
exact, sums in float32) runs the backward's products three passes per
product (lo·hi + hi·lo + hi·hi) within :data:`F32_TOL` of float64 at the
LM's head dim, and one TF32 pass outside it; the kernels'
index maps (the conversion pass's reads and stores, the transposed copy's
row permutation against the accumulator-to-fragment mapping) are replayed
in Python: the permuted sum is the product, and every warp access hits 32
different banks.

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


# -- the split-TF32 arithmetic of B11 and B12 ----------------------------------

HI_MASK = np.uint32(0xffffe000)        # the 19 bits a TF32 keeps


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32, to nearest, ties away
    (``cvt.rna.tf32.f32``)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & HI_MASK).view(np.float32)


def split_tf32(x: np.ndarray):
    """The kernels' split (``split`` in the source): hi = x rounded to
    TF32, lo = x − hi (exact in float32) rounded to TF32."""
    x = np.asarray(x, np.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_split(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as B11 and B12 take it: lo·hi + hi·lo + hi·hi, each a product
    of TF32 values (exact in float32), summed in float32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    mm = lambda x, y: np.matmul(x, y, dtype=np.float32)  # noqa: E731
    return (mm(al, bh) + mm(ah, bl)) + mm(ah, bh)


def matmul_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in one TF32 pass (both operands rounded), float32 sums."""
    return np.matmul(tf32_round(a), tf32_round(b), dtype=np.float32)


def _backward(q, k, v, do, mm, dtype):
    """dq, dk, dv of causal attention from the plain formula
    (``flash_bwd_plain``'s), every product through ``mm``, the rest in
    ``dtype``; o and lse from float64."""
    t, d = q.shape[-2:]
    scale = d ** -0.5
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    above = np.triu(np.ones((t, t), bool), 1)
    s64 = q64 @ np.swapaxes(k64, -1, -2) * scale + np.where(
        above, F.MASK_VALUE, 0.0)
    lse = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) + \
        s64.max(-1)
    o = np.exp(s64 - lse[..., None]) @ v64
    di = (o * do.astype(np.float64)).sum(-1)
    c = lambda x: np.asarray(x, dtype)  # noqa: E731
    s = c(mm(q, np.swapaxes(k, -1, -2))) * c(scale) + c(
        np.where(above, F.MASK_VALUE, 0.0))
    p = c(np.exp(s - c(lse)[..., None]))
    dv = mm(np.swapaxes(p, -1, -2), do)
    dp = c(mm(do, np.swapaxes(v, -1, -2)))
    ds = c(p * (dp - c(di)[..., None]) * c(scale))
    return (mm(ds, k), mm(np.swapaxes(ds, -1, -2), q), dv)


def _split_case(seed=0, shape=(1, 2, 256, 64)):
    r = np.random.RandomState(seed)
    q, k, v, do = (r.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    mm64 = lambda a, b: np.asarray(a, np.float64) @ np.asarray(  # noqa: E731
        b, np.float64)
    want = _backward(q, k, v, do, mm64, np.float64)
    return (q, k, v, do), want


def _over_tol(got, want) -> float:
    """max |got − want| / (F32_TOL·(max|want| + |want|)): at most 1 within
    the tolerance the card check holds the kernels to."""
    lim = F32_TOL * (np.abs(want).max() + np.abs(want))
    return float((np.abs(np.asarray(got, np.float64) - want) / lim).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("out", ["dq", "dk", "dv"])
def test_split_tf32_backward_within_f32_tol(seed, out):
    """Three passes of truncated TF32 parts, every product of the backward
    (s, dP, dV, dK, dQ) at hd 64, causal: within F32_TOL of float64."""
    ins, want = _split_case(seed)
    got = _backward(*ins, matmul_split, np.float32)
    i = "dq dk dv".split().index(out)
    assert _over_tol(got[i], want[i]) <= 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_one_pass_tf32_backward_fails_f32_tol(seed):
    """One TF32 pass (rounded operands, what TF32 matmul gives) is outside
    F32_TOL of float64 on dQ, dK and dV alike: the split is needed."""
    ins, want = _split_case(seed)
    got = _backward(*ins, matmul_tf32, np.float32)
    assert min(_over_tol(g, w) for g, w in zip(got, want)) > 1.0


def test_split_parts_sum_to_float32_within_2_pow_22():
    """hi and lo are TF32 values (low 13 bits zero), |lo| ≤ 2⁻¹¹ |x|, and
    hi + lo leaves at most 2⁻²² of |x|, of either sign, over seeded values
    of many magnitudes."""
    r = np.random.RandomState(5)
    x = (r.standard_normal(100000) * 10.0 ** r.uniform(-6, 6, 100000)
         ).astype(np.float32)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & ~HI_MASK).any()
    x64 = x.astype(np.float64)
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(x64)).all()
    err = x64 - hi - lo.astype(np.float64)
    assert (np.abs(err) <= 2.0 ** -22 * np.abs(x64)).all()
    assert (err > 0).any() and (err < 0).any()


def _swz(r: int, c: int, rows: int) -> int:
    """csrc/flash_attention_f32.cu ``swz``: byte offset of (r, c) in a
    float32 tile of ``rows`` rows, 32-column boxes, 128-byte swizzle."""
    off = (c >> 5) * rows * 128 + r * 128 + (c & 31) * 4
    return off ^ ((off >> 3) & 0x70)


def _split_tile_accesses(D: int, R: int):
    """The conversion pass's warp instructions as ``split_tile`` computes
    them: for each (warp, g, par, m), the 32 lanes' (row, column) read,
    raw/lo offset and transposed position and offset."""
    for warp in range(4):
        for g in range(warp, R // 8, 4):
            for par in range(2):
                for m in range(D // 8):
                    lanes = []
                    for lane in range(32):
                        j, dd = lane >> 3, lane & 7
                        r, pos = 8 * g + 2 * j + par, 8 * g + j + 4 * par
                        o = ((m >> 2) * R * 128 + r * 128 + (dd & 3) * 4
                             + (((2 * (m & 3) + (dd >> 2)) ^ (r & 7)) << 4))
                        tc = (pos & 31) >> 2
                        ot = ((pos >> 5) * D * 128 + (pos & 3) * 4
                              + (8 * m + dd) * 128 + ((tc ^ dd) << 4))
                        lanes.append((r, 8 * m + dd, o, pos, ot))
                    yield lanes


@pytest.mark.parametrize("D,R", [(32, 32), (64, 32), (128, 32), (64, 64)])
def test_split_tile_layout_and_banks(D, R):
    """The conversion pass reads the TMA layout, writes lo in it and the
    transposed copy in the layout wgmma reads ([D][R], 128-byte swizzle),
    covers every element once, and each warp instruction hits 32 different
    banks on the read, the lo store and the transposed stores."""
    seen = set()
    for lanes in _split_tile_accesses(D, R):
        for r, d, o, pos, ot in lanes:
            assert o == _swz(r, d, R) and ot == _swz(d, pos, D)
            assert pos == 8 * (r // 8) + (r % 8) // 2 + 4 * (r % 2)
            seen.add((r, d))
        assert len({(o >> 2) & 31 for _, _, o, _, _ in lanes}) == 32
        assert len({(ot >> 2) & 31 for *_, ot in lanes}) == 32
    assert seen == {(r, d) for r in range(R) for d in range(D)}


def test_fragment_permutation_identity():
    """Accumulator to A without a shuffle: thread (g, t) feeds columns 2t
    and 2t+1 of each 8-column block of a 64 x N score accumulator as k = t
    and t + 4 of the TF32 k8 fragment ({x[4j], x[4j+2], x[4j+1],
    x[4j+3]}); with B the transposed copy whose position 8g + j + 4 par
    holds row 8g + 2j + par, the products summed in that order are the
    product (integers: exact in float64)."""
    r = np.random.RandomState(2)
    n, d = 32, 64
    acc = r.randint(-8, 8, (64, n)).astype(np.float64)   # scores: M x K
    rows = r.randint(-8, 8, (n, d)).astype(np.float64)   # streamed: K x N
    a_log = np.zeros_like(acc)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            x = {}                     # the thread's accumulator elements
            for i in range(n // 2):    # i = 4 jb + 2 half + e
                row = 16 * w + g + 8 * ((i >> 1) & 1)
                x[i] = acc[row, 8 * (i >> 2) + 2 * t + (i & 1)]
            for jb in range(n // 8):
                frag = (x[4 * jb], x[4 * jb + 2], x[4 * jb + 1],
                        x[4 * jb + 3])
                for a, val in enumerate(frag):   # a0..a3: (g|g+8, t|t+4)
                    a_log[16 * w + g + 8 * (a & 1),
                          8 * jb + t + 4 * (a >> 1)] = val
    b_log = np.zeros_like(rows)
    for row in range(n):
        b_log[8 * (row // 8) + (row % 8) // 2 + 4 * (row % 2)] = rows[row]
    assert not np.array_equal(a_log, acc)
    np.testing.assert_array_equal(a_log @ b_log, acc @ rows)


# -- B10 f32's arithmetic -------------------------------------------------------

ROWS = 32                  # keys of a streamed tile (kRows in the source)


def _mm(a, b):
    return np.matmul(a, b, dtype=np.float32)


def _split_product(a, b):
    """a @ b as one split-TF32 wgmma chain sums it: the small terms
    (lo·hi + hi·lo) first, then hi·hi."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (_mm(al, bh) + _mm(ah, bl)) + _mm(ah, bh)


def _tf32_product(a, b):
    """a @ b in one TF32 pass (the control)."""
    return _mm(tf32_round(a), tf32_round(b))


def replay_fwd_f32(q, k, v, causal, product=_split_product):
    """B10 f32's arithmetic in numpy float32: keys in tiles of 32; each k8
    step of s = q kᵀ a fresh ``product`` folded into the float32 scores;
    the scores scaled, the mask added above the diagonal; the online
    softmax (m per row, l rescaled and added to, o rescaled by
    exp(m_old − m_new) every tile); each tile's p v a fresh ``product``
    folded into o; o / l and lse = m + log l at the end.  (Tiles wholly
    above the diagonal, which the kernel skips, add exactly nothing here:
    their p is 0 and their max below m.)"""
    t, d = q.shape[-2:]
    scale = np.float32(d ** -0.5)
    above = np.triu(np.ones((t, t), bool), 1)
    mask = np.where(above, np.float32(F.MASK_VALUE), np.float32(0))
    o = np.zeros(q.shape, np.float32)
    m = np.full(q.shape[:-1], -np.inf, np.float32)
    l = np.zeros(q.shape[:-1], np.float32)
    for j in range(t // ROWS):
        keys = slice(j * ROWS, (j + 1) * ROWS)
        kt = np.swapaxes(k[..., keys, :], -1, -2)
        s = None
        for kk in range(d // 8):
            c = slice(8 * kk, 8 * kk + 8)
            step = product(q[..., c], kt[..., c, :])
            s = step if s is None else s + step
        x = s * scale
        if causal:
            x = x + mask[:, keys]
        m_new = np.maximum(m, x.max(-1))
        alpha = np.exp(m - m_new)
        p = np.exp(x - m_new[..., None])
        l = l * alpha + p.sum(-1, dtype=np.float32)
        o = o * alpha[..., None] + product(p, v[..., keys, :])
        m = m_new
    return o / l[..., None], m + np.log(l)


FWD_CASES = [((1, 2, 256, 64), True), ((1, 2, 128, 32), False)]


@pytest.fixture(scope="module", params=FWD_CASES,
                ids=lambda c: "x".join(map(str, c[0])) + ("" if c[1]
                                                          else "-noncausal"))
def jax_fwd(request):
    """Inputs from a numpy seed and the JAX package's float32 flash forward
    on them (JAX's packaged TPU kernel, which theanompi_tpu/models/layers.py
    calls for attn_impl='flash', in Pallas's TPU interpret mode): o, and
    lse = m + log l from its residuals."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as jfa
    shape, causal = request.param
    r = np.random.RandomState(11)
    q, k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    b, h, t, d = shape
    with pltpu.force_tpu_interpret_mode():
        o, l, m = jfa._flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, True,
            causal, d ** -0.5, jfa.BlockSizes.get_default(b, h, t, t, d),
            False)
    return (q, k, v, causal), np.asarray(o), np.asarray(m) + np.log(
        np.asarray(l))


def test_b10_f32_replay_within_f32_tol_of_jax(jax_fwd):
    """The kernel's arithmetic (split TF32, a fold per k-step and per tile,
    the softmax rescaled every 32 keys) within F32_TOL of the JAX package's
    float32 flash forward, on o and lse."""
    ins, want_o, want_lse = jax_fwd
    o, lse = replay_fwd_f32(*ins)
    assert _over_tol(o, want_o) <= 1.0
    assert _over_tol(lse, want_lse) <= 1.0


def test_b10_f32_one_pass_tf32_fails_f32_tol(jax_fwd):
    """The same forward with one TF32 pass a product (no lo terms) is
    outside F32_TOL of the JAX package's: the split is needed."""
    ins, want_o, want_lse = jax_fwd
    o, lse = replay_fwd_f32(*ins, product=_tf32_product)
    assert max(_over_tol(o, want_o), _over_tol(lse, want_lse)) > 1.0


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
