"""The port's bucketed wire (``theanompi_tpu_torch/parallel/buckets.py``)
against the JAX package's (``theanompi_tpu/parallel/buckets.py``,
``tests/test_buckets.py``).

* The plan: the port's ``plan_buckets`` of TinyLRNNet, TinyVGGNet, AlexNet
  and VGG-16 equals the JAX package's of the same model at several
  ``bucket_bytes`` — the same buckets, their members as JAX leaf paths,
  sizes and dtypes — and so does every strategy's ``n_buckets``
  (full-width models as shapes only: no weights drawn).
* ``pack``/``unpack`` round trips bit for bit; empty leaves ride nowhere.
* On a world-1 gloo group: each bucketed strategy (allreduce, nccl16,
  onebit and topk over several buckets each, PowerSGD's dense remainder)
  gives its monolithic mean and state bit for bit, and the B4 and B8
  decodes into ``out=`` slices equal the whole decode.
* Through ``torch_launch_helper``'s ``buckets`` mode, one launch at 2 gloo
  ranks and one at 4: every case of ``tests/test_buckets.py:169-183``
  (BSP allreduce, nccl16, params, onebit, topk, PowerSGD; EASGD, ASGD,
  GoSGD perm/iid/shift) and the fused EASGD cadence at
  ``steps_per_call=4`` (``:193-198``), trained on the monolithic wire and
  at ``BUCKET_BYTES``.  At 2 ranks every case is bit for bit the same in
  params, optimizer state and rule state.  At 4 ranks the wires that
  gather or send (onebit, topk, GoSGD) are too; the wires that SUM over
  the ranks are not, because gloo's ring all-reduce adds an element's
  four terms in an order that follows the element's offset in its buffer
  (``test_gloo_sum_order_follows_the_buffer`` shows it on gloo alone):
  those are held exchange by exchange within the bound of a reassociated
  sum, and their float32 trajectories within rtol 1e-5 / atol 1e-6.  The
  replicas stay bit-identical in every case.
* The collectives a step issues (counted by wrapping ``dist.all_reduce``,
  ``dist.all_gather`` and ``dist.batch_isend_irecv``) follow
  ``n_buckets``: this ports ``test_bucketed_bsp_window_collective_count``
  (``:247-266``), which reads the JAX profiler's trace, by counting calls.

The masked-membership case (``tests/test_buckets.py:201-210``) waits for
elastic membership (A10, ``set_active_ranks``).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.models.vggnet_16 import VGGNet_16 as JVGG16
from theanompi_tpu.parallel import buckets as JB
from theanompi_tpu.parallel import strategies as JS
from theanompi_tpu_torch.base import MeshProcess
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.models.vggnet_16 import VGGNet_16 as TVGG16
from theanompi_tpu_torch.ops import compress
from theanompi_tpu_torch.parallel import buckets as TB
from theanompi_tpu_torch.parallel import strategies as TS
from theanompi_tpu_torch.utils.helper_funcs import (jax_leaf_paths,
                                                    tree_leaves, tree_map)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_launch_helper as lh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_vgg import _JTinyVGGNet  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")])}


# -- shapes of both packages' models, no weights drawn --------------------------

def _jax_shapes(jcls, **cfg):
    class Shapes(jcls):
        def init_params(self, key):
            return jax.eval_shape(super().init_params, key)
    return Shapes(dict({"n_workers": 1, "verbose": False}, **cfg)).params


def _port_shapes(tcls, **cfg):
    """The port model's params as untouched ``torch.empty`` tensors (their
    pages never written, so a full-width model costs no memory)."""
    class Shapes(tcls):
        def init_params(self, gen):
            with torch.device("meta"):
                meta = L.init_parts(self.layers(), None)
            return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                            meta)
    return Shapes(dict({"device": "cpu", "verbose": False}, **cfg)).params


_MODELS = {
    "TinyLRNNet": (lambda: _JTinyLRNNet({"n_workers": 1,
                                         "verbose": False}).params,
                   lambda: helper.TinyLRNNet({"device": "cpu",
                                              "verbose": False}).params),
    "TinyVGGNet": (lambda: _JTinyVGGNet({"n_workers": 1,
                                         "verbose": False}).params,
                   lambda: helper.TinyVGGNet({"device": "cpu",
                                              "verbose": False}).params),
    "AlexNet": (lambda: _jax_shapes(JAlexNet, batch_size=1,
                                    synthetic_batches=1),
                lambda: _port_shapes(TAlexNet, batch_size=1,
                                     synthetic_batches=1)),
    "VGG16": (lambda: _jax_shapes(JVGG16, batch_size=1, synthetic_batches=1),
              lambda: _port_shapes(TVGG16, batch_size=1,
                                   synthetic_batches=1)),
}
_CACHE = {}


def _pair(model):
    if model not in _CACHE:
        j, t = _MODELS[model]
        _CACHE[model] = (j(), t())
    return _CACHE[model]


def _jax_paths(tree):
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


BUCKET_SIZES = (0, 256, 1 << 16, 1 << 20, 4 << 20, 64 << 20)


@pytest.mark.parametrize("bucket_bytes", BUCKET_SIZES)
@pytest.mark.parametrize("model", list(_MODELS))
def test_plan_equals_jax(model, bucket_bytes):
    jp, tp = _pair(model)
    want = JB.plan_buckets(jp, bucket_bytes)
    got = TB.plan_buckets(tp, bucket_bytes)
    assert got.n_buckets == want.n_buckets > 0
    assert (got.n_leaves, got.empty_leaf_ids) == (want.n_leaves,
                                                  want.empty_leaf_ids)
    jpaths, tpaths = _jax_paths(jp), jax_leaf_paths(tp)
    for g, w in zip(got.buckets, want.buckets):
        assert g.dtype == w.dtype and g.sizes == w.sizes
        assert [tpaths[i] for i in g.leaf_ids] == \
            [jpaths[i] for i in w.leaf_ids]
    assert TB.plan_signature(got) == JB.plan_signature(want)
    assert TB.count_buckets(tp, bucket_bytes) == want.n_buckets


@pytest.mark.parametrize("name", ["none", "allreduce", "nccl16", "ring",
                                  "asa16", "onebit", "topk", "powersgd",
                                  "powersgd1"])
@pytest.mark.parametrize("model", list(_MODELS))
def test_strategy_n_buckets_equals_jax(model, name):
    jp, tp = _pair(model)
    for bb in BUCKET_SIZES[1:]:
        assert TS.get_strategy(name).n_buckets(tp, bb) == \
            JS.get_strategy(name).n_buckets(jp, bb), bb


def test_card_counts_at_4_mib():
    """The numbers ``chip_smoke.py`` holds the card's runs to
    (``WIRE_N_BUCKETS``), here against the JAX package's plan."""
    mib4 = TB.DEFAULT_BUCKET_BYTES
    for model, want in (("VGG16", {"onebit": 132, "topk": 2, "powersgd": 1,
                                   "allreduce": 19}),
                        ("AlexNet", {"allreduce": 8})):
        jp, tp = _pair(model)
        for name, n in want.items():
            assert TS.get_strategy(name).n_buckets(tp, mib4) == n
            assert JS.get_strategy(name).n_buckets(jp, mib4) == n


# -- pack / unpack --------------------------------------------------------------

def _tree(seed=0, **shapes):
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(r.randn(*s).astype(np.float32))
            for k, s in shapes.items()}


def test_pack_unpack_bit_exact_round_trip():
    t = _tree(b=(11,), a=(7, 3), c=(2, 2, 2), d=(5, 4, 3, 3))
    for bb in (0, 16, 64, 1 << 20):
        plan = TB.plan_buckets(t, bb)
        vecs = TB.pack(t, plan)
        assert [v.numel() for v in vecs] == [b.size for b in plan.buckets]
        out = TB.unpack(vecs, t, plan)
        assert list(out) == list(t)                  # the tree's own order
        for k in t:
            assert out[k].shape == t[k].shape
            assert torch.equal(out[k], t[k])
        # a bucket's vector is its members in the JAX order, each in the
        # port's own layout
        for b, v in zip(plan.buckets, vecs):
            keys = [jax_leaf_paths(t)[i][0] for i in b.leaf_ids]
            assert torch.equal(v, torch.cat([t[k].reshape(-1)
                                             for k in keys]))


def test_plan_empty_scalar_and_mixed_dtype_leaves():
    t = {"a": torch.zeros(()), "b": torch.zeros(0), "c": torch.zeros(4, 0),
         "d": torch.zeros(3), "e": torch.zeros(10, dtype=torch.bfloat16),
         "f": torch.zeros(2)}
    plan = TB.plan_buckets(t, 1 << 20)
    assert plan.empty_leaf_ids == (1, 2)
    assert [b.dtype for b in plan.buckets] == ["float32", "bfloat16",
                                               "float32"]
    assert [b.size for b in plan.buckets] == [4, 10, 2]
    assert plan.buckets[1].nbytes() == 20
    out = TB.unpack(TB.pack(t, plan), t, plan)
    assert out["b"] is t["b"] and out["c"] is t["c"]
    assert out["e"].dtype == torch.bfloat16


def test_plan_oversized_leaf_is_its_own_bucket():
    t = {"small": torch.zeros(8), "big": torch.zeros(4096),
         "tail": torch.zeros(8)}
    plan = TB.plan_buckets(t, 1024)
    assert [b.sizes for b in plan.buckets] == [(4096,), (8, 8)]
    # a one-leaf bucket packs as a view of its (contiguous) leaf
    assert TB.pack(t, plan)[0].data_ptr() == t["big"].data_ptr()


# -- one rank: every bucketed wire against its monolithic twin ------------------

@pytest.fixture
def cpu_group():
    proc = MeshProcess({"device": "cpu", "verbose": False})
    proc.get_internode_comm()
    yield proc
    proc.close()


def _big_tree(seed):
    """Leaves of several sizes, ~2.6 pack blocks and 11 topk chunk rows."""
    return {"conv": _tree(seed, w=(4, 3, 3, 3), b=(4,)),
            "fc1": _tree(seed + 1, w=(300, 280), b=(300,)),
            "fc2": _tree(seed + 2, w=(10, 300), b=(10,))}


def _run(name, bb, seed=0):
    s = TS.get_strategy(name)
    s.bucket_bytes = bb
    g = _big_tree(seed)
    state = s.init_state(g)
    outs = []
    for step in range(2):                   # a second call reads the state
        mean, state = s(tree_map(lambda x: x + step, g), state, size=1)
        outs.append([x.clone() for x in tree_leaves(mean)])
    return outs, [x.clone() for x in tree_leaves(state)]


@pytest.mark.parametrize("name,bb,n", [
    ("allreduce", 4096, 4), ("nccl16", 4096, 4), ("onebit", 4, 3),
    ("onebit", 1 << 17, 3), ("onebit", 1 << 18, 2), ("topk", 328, 11),
    ("topk", 1000, 4), ("powersgd", 1024, 3), ("powersgd1", 1 << 20, 1)])
def test_bucketed_strategy_equals_monolithic(cpu_group, name, bb, n):
    s = TS.get_strategy(name)
    assert s.n_buckets(_big_tree(0), bb) == n
    mono, st_m = _run(name, 0)
    buck, st_b = _run(name, bb)
    for a, b in zip(mono + [st_m], buck + [st_b]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_bucketed_all_reduce_in_place(cpu_group):
    t = _big_tree(3)
    want = {k: {n: v * 1.0 for n, v in d.items()} for k, d in t.items()}
    leaves = tree_leaves(t)
    for bb in (0, 2048):
        assert TB.bucketed_all_reduce(t, bb) is t
        assert all(a is b for a, b in zip(tree_leaves(t), leaves))
        for x, y in zip(tree_leaves(t), tree_leaves(want)):
            assert torch.equal(x, y)


def test_decodes_into_slices_equal_the_whole(cpu_group):
    """B4's and B8's plain versions into ``out=`` slices of one mean (as
    the bucketed wires call them) equal one whole decode; a wrong slice is
    refused."""
    r = np.random.RandomState(0)
    c = torch.from_numpy(r.randn(3 * compress.PACK_ALIGN).astype(np.float32))
    words = torch.stack([compress.pack_signs(c), compress.pack_signs(-c)])
    scales = torch.tensor([0.5, 0.25])
    whole = compress.unpack_signs_weighted_mean(words, scales, 2)
    out = torch.empty_like(whole)
    for a in range(0, words.shape[1], 8):
        n = 8 * 32 * compress.LANES
        compress.unpack_signs_weighted_mean(words[:, a:a + 8], scales, 2,
                                            out=out[a * 32 * 128:][:n])
    assert torch.equal(out, whole)
    c2 = c.view(-1, 8192)[:11]
    vals, idx, _ = compress.topk_encode(c2, 82)
    allv, alli = torch.stack([vals, vals]), torch.stack([idx, idx])
    whole = compress.topk_decode(allv, alli, 8192, 2)
    out = torch.empty_like(whole)
    for a in range(0, 11, 4):
        compress.topk_decode(allv[:, a:a + 4], alli[:, a:a + 4], 8192, 2,
                             out=out[a * 8192:(a + allv[:, a:a + 4].shape[1])
                                     * 8192])
    assert torch.equal(out, whole)
    with pytest.raises(ValueError, match="out"):
        compress.topk_decode(allv, alli, 8192, 2, out=out[:8192])


# -- worlds of 2 and 4 gloo ranks -----------------------------------------------

_WORLDS = {}


def _world(world, tmp_path_factory):
    """Every rank's results of the ``buckets`` helper mode at ``world``
    ranks; one launch, cached."""
    if world not in _WORLDS:
        mp = pytest.MonkeyPatch()
        for k, v in ENV.items():
            mp.setenv(k, v)
        out = str(tmp_path_factory.mktemp(f"buckets{world}") / "b")
        try:
            rc = lh.launch("bsp", "-", world, "device=cpu",
                           "helper_mode=buckets", f"helper_out={out}",
                           f"batch_size={8 // world}", "epochs=1",
                           "scale_lr=false", timeout_s=120)
        finally:
            mp.undo()
        assert rc == 0
        ranks = []
        for r in range(world):
            with np.load(f"{out}_r{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        _WORLDS[world] = ranks
    return _WORLDS[world]


# wires whose collectives sum over the ranks (an all-reduce); the others
# gather (onebit, topk) or send (GoSGD)
SUMMING = {"bsp-allreduce", "bsp-nccl16", "bsp-params", "bsp-powersgd",
           "easgd", "asgd", "easgd-spc4"}


def _state_keys(ranks, case):
    pre = f"{case}/mono/"
    return sorted(k[len(pre):] for k in ranks[0]
                  if k.startswith(pre) and not k.endswith("/calls"))


def _shared(case, key) -> bool:
    """State every rank holds the same: all of it under BSP grads mode but
    the error feedback; the params after a params-mode or ASGD exchange;
    EASGD's and ASGD's center; nothing of GoSGD's."""
    part = key.split("/")[0]
    if case in ("bsp-allreduce", "bsp-nccl16"):
        return True
    if case in ("bsp-onebit", "bsp-topk", "bsp-powersgd"):
        return part != "extra"
    return {"bsp-params": ("params",), "asgd": ("params", "extra"),
            "easgd": ("extra",), "easgd-spc4": ("extra",)}.get(
                case, ()).__contains__(part)


@pytest.mark.parametrize("case", list(lh.BUCKET_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_bucketed_equals_monolithic(world, case, tmp_path_factory):
    ranks = _world(world, tmp_path_factory)
    keys = _state_keys(ranks, case)
    assert any(k.startswith("params/") for k in keys)
    assert any(k.startswith("opt/") for k in keys)
    assert int(ranks[0][f"{case}/n_buckets"]) > 1
    for r, st in enumerate(ranks):
        for k in keys:
            mono, buck = st[f"{case}/mono/{k}"], st[f"{case}/buck/{k}"]
            if world == 2 or case not in SUMMING:
                np.testing.assert_array_equal(buck, mono,
                                              err_msg=f"rank {r} {k}")
            elif case != "bsp-nccl16":
                # another order of float32 sums, compounded over the steps
                np.testing.assert_allclose(buck, mono, rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {r} {k}")
    for wire in ("mono", "buck"):
        for k in keys:
            if not _shared(case, k):
                continue
            for r, st in enumerate(ranks[1:], 1):
                np.testing.assert_array_equal(
                    st[f"{case}/{wire}/{k}"], ranks[0][f"{case}/{wire}/{k}"],
                    err_msg=f"{wire} rank {r} {k}")


@pytest.mark.parametrize("name", lh.SUM_WIRES)
def test_four_rank_sums_within_reassociation_bound(name, tmp_path_factory):
    """One exchange of the same inputs at 4 ranks: the bucketed mean is the
    monolithic one up to the order of each element's four-term sum, on
    every rank alike.  Bound: (W − 1) roundings of partial sums no larger
    than Σ|x_w|, each within the unit roundoff of the summing dtype, for
    each of the two orders, then ÷ 4 (float32; bfloat16
    for nccl16, whose inputs are rounded to bfloat16 first), and for
    PowerSGD the decode of the same factors — its dense leaves alone are
    bucketed, its factors ride one stacked all-reduce either way."""
    ranks = _world(4, tmp_path_factory)
    u = 2.0 ** -9 if name == "nccl16" else 2.0 ** -24   # unit roundoff
    pre = f"sum/{name}/in/"
    paths = [k[len(pre):] for k in ranks[0] if k.startswith(pre)]
    n_diff = 0
    for p in paths:
        absum = sum(np.abs(st[pre + p]) for st in ranks) * (1 + 2 * u)
        bound = 2 * 3 * u * absum / 4
        for st in ranks:
            mono = st[f"sum/{name}/mono/{p}"]
            buck = st[f"sum/{name}/buck/{p}"]
            assert (np.abs(buck - mono) <= bound).all(), p
            n_diff += int((buck != mono).sum())
            np.testing.assert_array_equal(buck, ranks[0][f"sum/{name}/buck/"
                                                         f"{p}"])
    if name != "powersgd1":
        assert n_diff > 0        # gloo's order did move (see the docstring)


def test_gloo_sum_order_follows_the_buffer(tmp_path_factory):
    """Why the summing wires are not bit for bit at 4 ranks: one exchange
    of the same inputs, monolithic and bucketed, differs in low bits on
    gloo alone (the strategy's arithmetic around the all-reduce is the
    same), while the 2-rank launch is bit for bit (a two-term sum
    commutes)."""
    ranks = _world(4, tmp_path_factory)
    mono = [v for k, v in ranks[0].items() if k.startswith("sum/allreduce/"
                                                           "mono/")]
    buck = [ranks[0][k.replace("/mono/", "/buck/")] for k in ranks[0]
            if k.startswith("sum/allreduce/mono/")]
    assert any(not np.array_equal(a, b) for a, b in zip(mono, buck))
    ranks2 = _world(2, tmp_path_factory)
    for k in _state_keys(ranks2, "bsp-allreduce"):
        np.testing.assert_array_equal(ranks2[0][f"bsp-allreduce/mono/{k}"],
                                      ranks2[0][f"bsp-allreduce/buck/{k}"])


@pytest.mark.parametrize("case", list(lh.BUCKET_CASES))
def test_collectives_a_step_follow_n_buckets(case, tmp_path_factory):
    """One more call of the step and its due exchange: all-reduces,
    all-gathers and point-to-point messages, monolithic and bucketed.  The
    step's metrics are one all-reduce; onebit gathers its scales once."""
    st = _world(2, tmp_path_factory)[0]
    nb = int(st[f"{case}/n_buckets"])
    mono, buck = st[f"{case}/mono/calls"], st[f"{case}/buck/calls"]
    n_leaves, rule_cfg = 6, lh.BUCKET_CASES[case][1]
    exchanges = 2 if case == "easgd-spc4" else 1
    if case.startswith("gosgd"):
        if rule_cfg.get("gosgd_peers", "perm") != "iid":
            # one round: a send and a receive a message
            assert list(mono) == [1, 0, 2] and list(buck) == [1, 0, 2 * (nb + 1)]
        else:
            assert buck[2] == mono[2] * (nb + 1)
        return
    if case == "bsp-onebit":
        assert list(mono) == [1, 2, 0] and list(buck) == [1, 1 + nb, 0]
    elif case == "bsp-topk":
        assert list(mono) == [1, 1, 0] and list(buck) == [1, nb, 0]
    elif case == "bsp-powersgd":
        # the two factor all-reduces, then the dense leaves (3 biases)
        assert list(mono) == [1 + 2 + 3, 0, 0]
        assert list(buck) == [1 + 2 + nb, 0, 0]
    else:
        assert list(mono) == [1 + exchanges * n_leaves, 0, 0]
        assert list(buck) == [1 + exchanges * nb, 0, 0]
