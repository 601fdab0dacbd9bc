"""The port's onebit compression against the JAX package's.

The plain versions of ``theanompi_tpu_torch.ops.compress`` (what a CPU
tensor runs, and what the CUDA kernels B3–B6 are held against on the card)
must equal the jnp oracles of ``theanompi_tpu.ops.compress`` — what the JAX
package runs off the TPU — bit for bit for the pack, the encode and the
residual, and within rtol/atol 1e-6 for the weighted decode (the JAX
package's own bound: the W-way sum may run in another order).

The inputs hold exact ``+0.0`` and ``-0.0`` (sign bit 1 either way) and
tiny normal values.  Subnormals are left out on purpose: XLA's CPU backend
flushes them to zero, so on the CPU the JAX package is no reference for
them.

Words are int32 in the port and uint32 in JAX, with the same bits: the
comparison views the port's as uint32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops import compress as J
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch.ops import compress as T
from theanompi_tpu_torch.utils import helper_funcs as TH

N = 2 * T.PACK_ALIGN


def _vec(seed):
    r = np.random.RandomState(seed)
    v = r.randn(N).astype(np.float32)
    v[::97] = 0.0
    v[5::101] = -0.0
    v[7::103] = 1e-30
    v[9::107] = -1e-30
    v[11::109] = np.finfo(np.float32).tiny
    return v


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_constants_match_jax():
    assert (T.BLOCK_ROWS, T.LANES, T.PACK_ALIGN) == \
        (J.BLOCK_ROWS, J.LANES, J.PACK_ALIGN)


def test_pack_signs_plain_bit_equal():
    c = _vec(0)
    want = np.asarray(J.pack_signs_jnp(jnp.asarray(c)))
    got = T.pack_signs_plain(torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == (N // 4096, 128)
    np.testing.assert_array_equal(_u32(got), want)
    # the public function routes a CPU tensor to the plain version
    np.testing.assert_array_equal(_u32(T.pack_signs(torch.from_numpy(c))),
                                  want)


def test_zero_signs_are_one():
    """+0.0 and −0.0 both pack to 1 (the c == 0 convention the residual's
    bit-exactness rests on); negatives and NaN to 0."""
    c = np.zeros(T.PACK_ALIGN, np.float32)
    c[1] = -0.0
    c[2] = -1.0
    c[3] = np.nan
    u = T.unpack_signs(T.pack_signs(torch.from_numpy(c))).numpy()
    assert u[0] == 1 and u[1] == 1 and u[2] == -1 and u[3] == -1
    np.testing.assert_array_equal(
        u, np.asarray(J.unpack_signs_jnp(J.pack_signs_jnp(jnp.asarray(c)))))


def test_pack_signs_encode_plain_bit_equal():
    f, s = _vec(1), _vec(2)
    wp, wa = J.pack_signs_encode_jnp(jnp.asarray(f), jnp.asarray(s))
    gp, ga = T.pack_signs_encode(torch.from_numpy(f), torch.from_numpy(s))
    np.testing.assert_array_equal(_u32(gp), np.asarray(wp))
    np.testing.assert_array_equal(_bits(ga.numpy()), _bits(wa))


@pytest.mark.parametrize("scale", [0.7, 1e-3])
def test_signed_residual_plain_bit_equal(scale):
    f, s = _vec(3), _vec(4)
    wp, wa = J.pack_signs_encode_jnp(jnp.asarray(f), jnp.asarray(s))
    want = J.signed_residual_jnp(wa, wp, jnp.float32(scale))
    gp, ga = T.pack_signs_encode(torch.from_numpy(f), torch.from_numpy(s))
    got = T.signed_residual(ga, gp, torch.tensor(scale, dtype=torch.float32))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # and it is the unfused c − scale·sign(where(c == 0, 1, c)), exactly
    c = f + s
    sc = np.float32(scale)
    legacy = c - sc * np.sign(np.where(c == 0, np.float32(1), c))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(legacy))


@pytest.mark.parametrize("w", [1, 3, 8])
def test_unpack_signs_weighted_sum_plain(w):
    packed = np.stack([np.asarray(J.pack_signs_jnp(jnp.asarray(_vec(10 + i))))
                       for i in range(w)])
    scales = np.random.RandomState(w).rand(w).astype(np.float32) + 0.1
    want = np.asarray(J.unpack_signs_weighted_sum_jnp(jnp.asarray(packed),
                                                      jnp.asarray(scales)))
    tp = torch.from_numpy(packed.view(np.int32))
    got = T.unpack_signs_weighted_sum(tp, torch.from_numpy(scales)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the /size mean, folded into the scales as the JAX package does
    want_m = np.asarray(J.unpack_signs_weighted_mean_jnp(
        jnp.asarray(packed), jnp.asarray(scales), w))
    got_m = T.unpack_signs_weighted_mean(tp, torch.from_numpy(scales), w)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-6, atol=1e-6)


def test_unpack_round_trips_pack():
    c = _vec(5)
    signs = T.unpack_signs(T.pack_signs(torch.from_numpy(c))).numpy()
    np.testing.assert_array_equal(signs, np.where(c >= 0, 1.0, -1.0))
    np.testing.assert_array_equal(
        signs, np.asarray(J.unpack_signs_jnp(J.pack_signs_jnp(
            jnp.asarray(c)))))


@pytest.mark.parametrize("kernel,args", [
    ("pack_signs_cuda", lambda v, w: (v,)),
    ("pack_signs_encode_cuda", lambda v, w: (v, v)),
    ("signed_residual_cuda", lambda v, w: (v, w, torch.ones(()))),
    ("unpack_signs_wsum_cuda", lambda v, w: (w[None], torch.ones(1))),
])
def test_kernel_wrappers_refuse_cpu_tensors(kernel, args):
    """A kernel wrapper never runs the plain version: a CPU tensor raises
    before anything is built or counted."""
    fn = getattr(T, kernel)
    v = torch.zeros(T.PACK_ALIGN)
    w = torch.zeros((T.PACK_ALIGN // 4096, 128), dtype=torch.int32)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args(v, w))
    assert fn.launches == before


def test_wrappers_refuse_bad_lengths_and_dtypes():
    with pytest.raises(ValueError, match="multiple of 32768"):
        T.pack_signs(torch.zeros(1000))
    with pytest.raises(ValueError, match="multiple of 32768"):
        T.pack_signs_cuda(torch.zeros(T.PACK_ALIGN + 128))
    with pytest.raises(TypeError, match="float32"):
        T.pack_signs(torch.zeros(T.PACK_ALIGN, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        T.pack_signs_encode_cuda(torch.zeros(T.PACK_ALIGN),
                                 torch.zeros(T.PACK_ALIGN,
                                             dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        T.unpack_signs(torch.zeros((8, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="m % 8"):
        T.unpack_signs_wsum_cuda(torch.zeros((1, 5, 128), dtype=torch.int32),
                                 torch.ones(1))


def test_flatten_round_trip_and_jax_order():
    """``flatten_tree`` pads with zeros, ``unflatten_like`` returns views
    in each leaf's shape, and the JAX package's flat vector of the same
    parameters (sorted keys, JAX layouts) maps onto the port's through
    ``convert.flat_from_jax``, pad included."""
    from theanompi_tpu_torch import convert
    r = np.random.RandomState(6)
    jtree = {"fc": {"w": r.randn(6, 5).astype(np.float32),
                    "b": r.randn(5).astype(np.float32)},
             "conv": {"w": r.randn(3, 3, 2, 4).astype(np.float32),
                      "b": r.randn(4).astype(np.float32)}}
    ttree = convert.params_from_jax(jtree)
    # the port's own order: its tree's insertion order (here not the
    # sorted one), w before b
    ttree = {k: {"w": torch.from_numpy(ttree[k]["w"]),
                 "b": torch.from_numpy(ttree[k]["b"])} for k in ("fc", "conv")}
    n = TH.tree_size(ttree)
    assert n == 3 * 3 * 2 * 4 + 4 + 30 + 5
    flat = TH.flatten_tree(ttree, pad_to_multiple_of=128)
    assert flat.shape == (128,) and not flat[n:].any()
    back = TH.unflatten_like(ttree, flat)
    for k in ttree:
        for p in ttree[k]:
            assert torch.equal(back[k][p], ttree[k][p])
            assert back[k][p].data_ptr() >= flat.data_ptr()   # a view
    jflat = np.asarray(JH.flatten_tree(jtree, pad_to_multiple_of=128)).copy()
    jflat[n:] = np.arange(128 - n)           # the pad region passes as it is
    want = flat.numpy().copy()
    want[n:] = np.arange(128 - n)
    np.testing.assert_array_equal(convert.flat_from_jax(jflat, jtree, ttree),
                                  want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 3])
def test_kernels_match_plain_on_card(n_blocks):
    """B3, B5, B6 and B4 at W=1 equal their plain versions bit for bit;
    B4 at W=4 and W=8 within rtol/atol 1e-6 (its Σ2·s·bit − Σs
    reassociates the plain Σ±s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = n_blocks * T.PACK_ALIGN
    r = np.random.RandomState(n_blocks)
    f = torch.from_numpy(r.randn(n).astype(np.float32)).cuda()
    s = torch.from_numpy(r.randn(n).astype(np.float32)).cuda()
    f[::97] = 0.0
    f[5::101] = -0.0
    s[5::101] = -0.0
    assert torch.equal(T.pack_signs_cuda(f), T.pack_signs_plain(f))
    kp, ka = T.pack_signs_encode_cuda(f, s)
    pp, pa = T.pack_signs_encode_plain(f, s)
    assert torch.equal(kp, pp)
    assert torch.equal(ka.view(torch.int32), pa.view(torch.int32))
    scale = pa.mean()
    kr = T.signed_residual_cuda(ka, kp, scale)
    pr = T.signed_residual_plain(pa, pp, scale)
    assert torch.equal(kr.view(torch.int32), pr.view(torch.int32))
    one = torch.ones(1, device="cuda")
    assert torch.equal(T.unpack_signs_wsum_cuda(kp[None], one),
                       T.unpack_signs_plain(kp))
    assert torch.equal(T.unpack_signs(kp), T.unpack_signs_plain(kp))
    for w in (1, 4, 8):
        allp = torch.stack([T.pack_signs_plain(torch.roll(f, i))
                            for i in range(w)])
        sc = torch.rand(w, device="cuda") + 0.1
        got = T.unpack_signs_wsum_cuda(allp, sc)
        want = T.unpack_signs_weighted_sum_plain(allp, sc)
        if w == 1:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
