"""The port's PowerSGD factor products against the JAX package's.

One leaf (``matmul_pack``) and a whole factor pass (``matmul_pack_group``:
every leaf's tile at its cumulative ``pad_rows`` offset of one staging
buffer, the JAX strategy's ``jnp.concatenate`` of tiles), with the plan
that cuts a pass into the kernel's work items (``plan``, ``tile_table``).

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
    before = TF.matmul_pack_group_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        TF.matmul_pack_cuda(a, q)
    assert TF.matmul_pack_group_cuda.launches == before


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


# A [rows, cols] of VGG-16's 16 compressible weights at 1000 classes (the
# port's layout: a conv's out_ch by in_ch·3·3, an FC's [out, in]), and
# ragged ones: rows and cols not multiples of 8 or 4, a single row
VGG16_SHAPES = [(64, 27), (64, 576), (128, 576), (128, 1152), (256, 1152),
                (256, 2304), (256, 2304), (512, 2304), (512, 4608),
                (512, 4608), (512, 4608), (512, 4608), (512, 4608),
                (4096, 25088), (4096, 4096), (1000, 4096)]
RAGGED_SHAPES = [(37, 1001), (13, 7), (1, 130), (129, 5), (300, 131)]


def _group_inputs(shapes, transposes, rank, seed):
    """The JAX matrices M, factors q and the port's A of each leaf (A = Mᵀ
    where the leaf is transposed), from numpy."""
    r = np.random.RandomState(seed)
    ms, qs, mats = [], [], []
    for (rows, cols), t in zip(shapes, transposes):
        a = r.randn(rows, cols).astype(np.float32)
        m = a.T if t else a                         # the product's matrix
        q = r.randn(m.shape[1], rank).astype(np.float32)
        ms.append(m)
        qs.append(q)
        mats.append(a)
    return ms, qs, mats


@pytest.mark.parametrize("rank", [1, 2, 5])
def test_matmul_pack_group_plain_matches_the_jax_concatenation(rank):
    """The plain group against the JAX package's staging buffer,
    ``jnp.concatenate`` of ``matmul_pack_jnp`` tiles (its strategy's
    P and Q passes), leaves in mixed orientations with ragged rows and
    C % 4 != 0: every row within the dot-product bound, pad rows +0,
    each tile at the cumulative ``pad_rows`` offset."""
    shapes = RAGGED_SHAPES + [(64, 27), (40, 12)]
    transposes = [i % 2 == 0 for i in range(len(shapes))]
    ms, qs, mats = _group_inputs(shapes, transposes, rank, rank)
    want = np.asarray(jnp.concatenate([
        JF.matmul_pack_jnp(jnp.asarray(m), jnp.asarray(q),
                           JF.pad_rows(m.shape[0]))
        for m, q in zip(ms, qs)]))
    got = TF.matmul_pack_group([torch.from_numpy(a) for a in mats],
                               [torch.from_numpy(q) for q in qs],
                               transposes).numpy()
    assert got.shape == want.shape
    off = 0
    for m, q in zip(ms, qs):
        rows = m.shape[0]
        tile = got[off:off + TF.pad_rows(rows)]
        assert not tile[rows:].any() and not np.signbit(tile[rows:]).any()
        err = np.abs(tile[:rows].astype(np.float64) - want[off:off + rows])
        assert (err <= dot_bound(m, q)).all(), err.max()
        off += TF.pad_rows(rows)
    assert off == got.shape[0]


def _plan_key(shapes, transposes):
    return tuple((r, c, TF.pad_rows(c if t else r), t)
                 for (r, c), t in zip(shapes, transposes))


@pytest.mark.parametrize("shapes,transposes", [
    (VGG16_SHAPES, [True] * 16),                 # the P pass
    (VGG16_SHAPES, [False] * 16),                # the Q' pass
    (RAGGED_SHAPES, [True, False, True, False, True]),
    ([(9, 33 + i) for i in range(70)], [i % 3 == 0 for i in range(70)]),
])
def test_tile_table_covers_every_leaf_once(shapes, transposes):
    """Every CTA of the plan: each leaf's A is covered exactly once, each
    work item covers its leaf's output rows (pad included) once, and the
    leaves' tiles start at the cumulative ``pad_rows``; a pass of more
    than 64 leaves takes more than one launch."""
    key = _plan_key(shapes, transposes)
    launches = TF.plan(key)
    assert sum(n for _, n, _, _ in launches) == len(shapes)
    assert len(launches) == -(-len(shapes) // TF.MAX_LEAVES)
    offs = [d[0] for _, _, _, descs in launches for d in descs]
    assert offs == list(np.cumsum([0] + [k[2] for k in key])[:-1])
    tiles = TF.tile_table(key)
    for i, (rows, cols, rows_pad, t) in enumerate(key):
        cover = np.zeros((rows, cols), np.int32)
        out = np.zeros(rows_pad, np.int32)
        mine = [tl for tl in tiles if tl[0] == i]
        assert len(mine) % TF.CLUSTER == 0
        for _, (o0, o1), (r0, r1), (c0, c1) in mine:
            cover[r0:r1, c0:c1] += 1
        for _, (o0, o1), _, _ in mine[::TF.CLUSTER]:
            out[o0 - offs[i]:o1 - offs[i]] += 1
        assert (cover == 1).all(), (i, rows, cols, t)
        assert (out == 1).all(), (i, rows_pad)


def test_group_refusals():
    a, q = torch.ones(10, 6), torch.ones(6, 2)
    with pytest.raises(ValueError, match="one of each per leaf"):
        TF.matmul_pack_group([a, a], [q], [False, False])
    with pytest.raises(ValueError, match="one of each per leaf"):
        TF.matmul_pack_group([a], [q], [False, True])
    with pytest.raises(ValueError, match="one of each per leaf"):
        TF.matmul_pack_group_plain([], [], [])
    with pytest.raises(ValueError, match="no leaves"):
        TF.matmul_pack_group([], [], [])
    with pytest.raises(ValueError, match="one rank"):
        TF.matmul_pack_group([a, a], [q, torch.ones(6, 3)], [False, False])
    with pytest.raises(ValueError, match="times q"):
        TF.matmul_pack_group([a, a], [q, q], [False, True])
    with pytest.raises(TypeError, match="float32"):
        TF.matmul_pack_group([a, a.double()], [q, q.double()],
                             [False, False])
    before = TF.matmul_pack_group_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        TF.matmul_pack_group_cuda([a], [q], [False])
    assert TF.matmul_pack_group_cuda.launches == before


def _card_group(shapes, transposes, rank, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mats, qs = [], []
    for (rows, cols), t in zip(shapes, transposes):
        mats.append(torch.randn(rows, cols, generator=g, device="cuda"))
        qs.append(torch.randn(rows if t else cols, rank, generator=g,
                              device="cuda"))
    return mats, qs


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,transposes", [
    (VGG16_SHAPES, [True] * 16), (VGG16_SHAPES, [False] * 16),
    (RAGGED_SHAPES, [True, False, True, False, True]),
    (RAGGED_SHAPES, [False, True, False, True, False])])
@pytest.mark.parametrize("rank", [1, 2, 5])
def test_matmul_pack_group_kernel_matches_plain_on_card(shapes, transposes,
                                                         rank):
    """The grouped B9 against the plain group (``torch.matmul``, TF32 off)
    within the dot-product bound per leaf, pad rows +0; a second run bit
    for bit equal; each leaf's tile equal, bit for bit, to the one-leaf
    entry's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    mats, qs = _card_group(shapes, transposes, rank, len(shapes) + rank)
    got = TF.matmul_pack_group_cuda(mats, qs, transposes)
    assert torch.equal(TF.matmul_pack_group_cuda(mats, qs, transposes)
                       .view(torch.int32), got.view(torch.int32))
    for a, q, t, tile in _check_group(got, mats, qs, transposes):
        one = TF.matmul_pack_cuda(a, q, transpose=t)
        assert torch.equal(one.view(torch.int32), tile.view(torch.int32))


def _check_group(got, mats, qs, transposes):
    """``got`` against the plain group within the dot-product bound per
    leaf, pad rows +0; yields each leaf's ``(a, q, transpose, tile)``."""
    want = TF.matmul_pack_group_plain(mats, qs, transposes)
    assert got.shape == want.shape
    off = 0
    for a, q, t in zip(mats, qs, transposes):
        m = a.t() if t else a
        rows, inner = m.shape
        tile = got[off:off + TF.pad_rows(rows)]
        pad = tile[rows:]
        assert not pad.any() and not torch.signbit(pad).any()
        bound = 2 * inner * U / (1 - inner * U) * (m.abs() @ q.abs())
        err = (tile[:rows] - want[off:off + rows]).abs()
        assert bool((err <= bound).all()), float(err.max())
        yield a, q, t, tile
        off += TF.pad_rows(rows)


@pytest.mark.cuda
def test_matmul_pack_group_launches_once_per_pass_on_card():
    """One launch for a pass of up to 64 leaves, two for 70; the one-leaf
    entry is a pass of one leaf, counted on the group wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shapes, launches in ((VGG16_SHAPES, 1),
                             ([(9, 33 + i) for i in range(70)], 2)):
        n = len(shapes)
        mats, qs = _card_group(shapes, [True] * n, 2, n)
        before = TF.matmul_pack_group_cuda.launches
        got = TF.matmul_pack_group_cuda(mats, qs, [True] * n)
        assert TF.matmul_pack_group_cuda.launches - before == launches
        TF.matmul_pack_cuda(mats[0], qs[0], transpose=True)
        assert TF.matmul_pack_group_cuda.launches - before == launches + 1
        assert len(list(_check_group(got, mats, qs, [True] * n))) == n
