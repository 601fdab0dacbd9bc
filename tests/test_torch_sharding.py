"""Data-parallel state sharding in the port (``zero_opt``,
``update_sharding``, ``fsdp``) against plain BSP and against the JAX
package, and the checkpoint parts each rank owns.

* ``plan_tree``'s schema against the JAX plan (path, ``sharded``, ``chunk``
  and ``pad`` per leaf) at 2 and 4 workers and two ``ushard_min_bytes``;
  the ragged P = 10, N = 4 chunking; the host-boxed round trips, and
  FSDP's aligned layout, as identities.
* ``identical_parts`` and the saved ``boxed_parts`` against the JAX
  package's for the same config (C8: ``exch_strategy='none'`` saves every
  part per rank), and the ``zero``/``fsdp`` meta facts.
* The JAX package's refusals, with the key's name.
* Through ``torch_launch_helper``'s ``shard`` mode, one launch at 2 gloo
  ranks and one at 4, from the JAX twin's weights:
  - each key against plain BSP: bit for bit at 2 ranks, and at 4 for
    ``zero_opt`` and ``update_sharding``; FSDP at 4 ranks within rtol 1e-5
    / atol 1e-6, as ``tests/test_torch_buckets.py`` holds the 4-rank
    summing wires: gloo's reduce-scatter adds an element's four terms in
    another order than its all-reduce (one of each, of the same flat
    gradient, within the reassociated sum's bound); the composition with ``n_subb``,
    ``steps_per_call``, ``ema_decay`` and ``grad_clip`` likewise (FSDP
    clips by one scalar sum over the chunks, another order of the norm's
    terms: held at rtol 1e-5 / atol 1e-6 at either world);
  - each key against the JAX package's workers at the same world size,
    params and momentum unsharded, within rtol 1e-5 / atol 1e-6 (float32;
    gradients from oneDNN and XLA);
  - the EASGD and ASGD centers and PowerSGD's error feedback under
    ``update_sharding`` ≡ unsharded, bit for bit;
  - the state is the partition: ⌈P/N⌉ elements a rank;
  - at 2 ranks, each key and C8's ``none`` wire: two epochs straight ≡ one,
    a checkpoint and a resumed second, on each rank; a JAX ZeRO-1 and a
    JAX FSDP checkpoint loaded through ``convert.checkpoint_from_jax`` and
    trained one more epoch, against the JAX package's own second epoch.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import exchanger as JX
from theanompi_tpu.parallel import update_sharding as JUS
from theanompi_tpu.utils import helper_funcs as JH
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import exchanger as TX
from theanompi_tpu_torch.parallel import fsdp as TF
from theanompi_tpu_torch.parallel import update_sharding as TUS
from theanompi_tpu_torch.utils import checkpoint as ckpt
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_launch_helper as lh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")])}
BATCH = {2: 8, 4: 4}
TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = {"zero": {"zero_opt": True}, "ushard": dict(lh._US),
        "fsdp": {"fsdp": True}}


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_like(params):
    """The JAX layout's tree of a port tree's shapes (zeros)."""
    return {k: {n: np.zeros(TH.to_jax_layout(v, (k, n)).shape, np.float32)
                for n, v in sub.items()} for k, sub in params.items()}


# -- the plan and the layouts -------------------------------------------------

_MODELS = {"TinyLRNNet": helper.TinyLRNNet, "TinyVGGNet": helper.TinyVGGNet,
           "TinyWideNet": lh.TinyWideNet}


@pytest.mark.parametrize("min_bytes", [TUS.DEFAULT_MIN_BYTES, 1024])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", list(_MODELS))
def test_plan_equals_jax(model, n, min_bytes):
    params = _MODELS[model]({"device": "cpu", "verbose": False}).params
    got = TUS.plan_tree(params, n, min_bytes=min_bytes)
    want = JUS.plan_tree(_jax_like(params), n, min_bytes=min_bytes)
    assert [(l.path, l.sharded, l.chunk, l.pad, l.size) for l in got.leaves] \
        == [(l.path, l.sharded, l.chunk, l.pad, l.size) for l in want.leaves]
    assert got.any_sharded == want.any_sharded
    assert (got.n_workers, got.min_bytes) == (n, min_bytes)
    assert not TUS.plan_tree(params, 1, min_bytes=0).any_sharded


def test_ragged_chunking_and_host_round_trips():
    """P = 10 over N = 4: chunk 3, padded 12, the pad zeros; a rank's
    window past the end is empty; the host-boxed rows round trip, and each
    rank's ``shard_tree`` is its row."""
    assert (TUS.chunk_size(10, 4), TUS.padded_size(10, 4)) == (3, 12)
    assert TUS.window(10, 3, 3) == (9, 10) and TUS.window(9, 3, 3) == (9, 9)
    tree = {"a": {"w": torch.arange(10.0)},
            "b": {"w": torch.arange(24.0).reshape(2, 3, 4), "b": torch.ones(3)}}
    plan = TUS.plan_tree(tree, 4, min_bytes=40)
    assert [(l.path, l.sharded, l.chunk, l.pad) for l in plan.leaves] == [
        ("['a']['w']", True, 3, 2), ("['b']['b']", False, 3, 0),
        ("['b']['w']", True, 6, 0)]
    host = TH.tree_map(lambda t: t.numpy(), tree)
    boxed = TUS.shard_host_boxed(host, plan)
    assert boxed["a"]["w"].shape == (4, 3)
    np.testing.assert_array_equal(boxed["a"]["w"][3], [9, 0, 0])
    back = TUS.unshard_boxed(boxed, plan)
    for p in TH.leaf_paths(host):
        np.testing.assert_array_equal(TH.get_leaf(back, p),
                                      TH.get_leaf(host, p))
    for r in range(4):
        mine = TUS.shard_tree(tree, plan, r)
        np.testing.assert_array_equal(mine["a"]["w"].numpy(),
                                      boxed["a"]["w"][r])
        assert mine["b"]["b"] is tree["b"]["b"]
    # the JAX package's rows of the same (JAX-layout) tree
    jb = JUS.shard_host_boxed(host, JUS.plan_tree(host, 4, min_bytes=40))
    np.testing.assert_array_equal(jb["a"]["w"], boxed["a"]["w"])


def test_fsdp_layout_aligned_and_round_trips():
    params = helper.TinyLRNNet({"device": "cpu", "verbose": False}).params
    host = TH.tree_map(lambda t: t.detach().numpy(), params)
    for n in (1, 2, 4):
        lay = TF.FsdpLayout(params, n)
        assert all(o % TF.ALIGN == 0 for o in lay.offsets)
        assert lay.n_total == TH.tree_size(params) == 1173
        assert lay.chunk == -(-lay.total // n) and lay.padded == n * lay.chunk
        rows = lay.chunk_host(host)
        back = lay.host_params_from_chunks(rows)
        for p in TH.leaf_paths(host):
            np.testing.assert_array_equal(TH.get_leaf(back, p),
                                          TH.get_leaf(host, p))
        dense = np.concatenate([l.reshape(-1) for l in TH.tree_leaves(host)])
        np.testing.assert_array_equal(lay.from_dense(dense), rows)


def test_center_plan_rows_are_each_ranks_chunks():
    """An EASGD center under ``update_sharding`` at 2 ranks: the rank's
    extra state holds its window of each large center leaf
    (``extra_state_template``), row r of ``extra_host_boxed``; GoSGD's α is
    never planned."""
    class Stub:
        params = lh.TinyWideNet({"device": "cpu", "verbose": False}).params

    rows, mine = None, []
    for rank in (0, 1):
        m = Stub()
        m.rank = rank
        ex = TX.EASGD_Exchanger({"update_sharding": True})
        ex.prepare(m, 2)
        assert ex.update_plan().any_sharded
        mine.append(ex.extra_state_template()["center"])
        rows = ex.extra_host_boxed(2)["center"]
    for p in TH.leaf_paths(rows):
        for rank in (0, 1):
            got = TH.get_leaf(mine[rank], p).numpy()
            want = TH.get_leaf(rows, p)[rank]
            np.testing.assert_array_equal(got, want)
    g = TX.GOSGD_Exchanger({"update_sharding": True})
    m = Stub()
    m.rank = 0
    g.prepare(m, 2)
    assert g.update_plan() is None


def test_flat_shard_opt_refuses_model_parallel_arguments():
    """On a grid the template is the rank's local shards, and its state is
    one ``ceil(local/N)`` chunk of their flat layout
    (``tests/test_torch_zero_grid.py`` trains it there); the JAX form's
    layout arguments are not taken."""
    from theanompi_tpu_torch.utils.opt import momentum
    local = {"w": torch.zeros(5), "b": torch.zeros(2)}
    for rank in (0, 1):
        st = TUS.flat_shard_opt(momentum(), 2, local, rank).init(local)
        assert tuple(st["opt"].shape) == (4,)       # ceil(7 / 2)
    with pytest.raises(TypeError, match="model_shards"):
        TUS.flat_shard_opt(momentum(), 2, {"w": torch.zeros(4)}, 0,
                           model_shards=2)


# -- checkpoint parts (C8) ----------------------------------------------------

_PART_CASES = [
    ("bsp", {}), ("bsp", {"exch_strategy": "none"}),
    ("bsp", {"exch_strategy": "onebit"}), ("bsp", {"exch_strategy": "nccl16"}),
    ("bsp", {"exch_mode": "params"}), ("bsp", {"zero_opt": True}),
    ("bsp", {"update_sharding": True}), ("bsp", {"fsdp": True}),
    ("easgd", {}), ("gosgd", {})]


@pytest.mark.parametrize("rule,cfg", _PART_CASES)
def test_identical_parts_equal_jax(rule, cfg):
    got = TX.get_exchanger(rule, cfg).identical_parts()
    want = JX.get_exchanger(rule, cfg).identical_parts()
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("cfg", [
    {}, {"exch_strategy": "none"}, {"exch_strategy": "onebit"},
    {"zero_opt": True}, {"update_sharding": True}, {"fsdp": True},
    {"fsdp": True, "ema_decay": 0.9}])
def test_saved_boxed_parts_and_layout_meta_equal_jax(cfg, tmp_path):
    """A world-1 session saves the parts the JAX package would box, and
    ZeRO-1's and FSDP's layout facts under the JAX keys; the same config
    resumes from it bit for bit."""
    d = str(tmp_path / "ck")
    model = "TinyVGGNet" if cfg.get("exch_strategy") == "onebit" \
        else "TinyLRNNet"
    full = helper.run_session(model, 2, **cfg).model
    helper.run_session(model, 1, ckpt_dir=d, **cfg)
    meta = ckpt.peek_meta(d)
    ident = set(JX.get_exchanger("bsp", cfg).identical_parts())
    assert meta["boxed_parts"] == sorted(
        {"params", "opt_state", "bn_state", "extra"} - ident)
    if cfg.get("zero_opt"):
        assert meta["zero"] == {"n": 1, "shards": 1, "local_total": 1173}
    if cfg.get("fsdp"):
        lay = TF.FsdpLayout(full.params, 1)
        assert meta["fsdp"] == {"n": 1, "chunk": lay.chunk, "total": 1173}
    again = helper.run_session(model, 2, ckpt_dir=d, resume=True,
                               **cfg).model
    a, b = helper.state_arrays(full), helper.state_arrays(again)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("rule,cfg,match", [
    ("BSP", {"update_sharding": True, "zero_opt": True}, "zero_opt"),
    ("BSP", {"update_sharding": True, "fsdp": True}, "fsdp"),
    ("BSP", {"update_sharding": True, "ema_decay": 0.9}, "ema_decay"),
    ("BSP", {"fsdp": True, "zero_opt": True}, "fsdp with zero_opt"),
    ("BSP", {"fsdp": True, "exch_strategy": "onebit"}, "fsdp requires"),
    ("BSP", {"fsdp": True, "exch_mode": "params"}, "fsdp requires"),
    ("BSP", {"fsdp": True, "bucket_bytes": 1024}, "bucket_bytes"),
    ("EASGD", {"fsdp": True}, "fsdp requires"),
    ("BSP", {"zero_opt": True, "exch_strategy": "none"},
     "zero_opt requires BSP grads"),
    ("BSP", {"zero_opt": True, "exch_mode": "params"},
     "zero_opt requires BSP grads"),
    ("ASGD", {"zero_opt": True}, "zero_opt requires BSP grads"),
])
def test_jax_refusals_name_the_key(rule, cfg, match):
    import theanompi_tpu_torch as T
    r = getattr(T, rule)()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", verbose=False, **cfg)
    with pytest.raises(ValueError, match=match):
        r.wait()


@pytest.mark.parametrize("rule", ["BSP", "ASGD", "EASGD"])
def test_update_sharding_at_world_one_is_inert(rule):
    """At one rank the plan shards nothing: the JAX package accepts the key
    under every rule and trains the unsharded bits."""
    kw = {} if rule == "BSP" else {"sync_freq": 2}
    a = helper.run_session("TinyLRNNet", 1, rule=rule, **kw)
    b = helper.run_session("TinyLRNNet", 1, rule=rule, update_sharding=True,
                           ushard_min_bytes=0, **kw)
    assert b.model._ushard_plan is None
    assert b.model.exchanger.update_plan() is None
    sa, sb = helper.state_arrays(a.model), helper.state_arrays(b.model)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


# -- launched worlds ----------------------------------------------------------

_WORLDS = {}


def _jax_cfg(world, key):
    cfg = {"n_workers": world, "batch_size": BATCH[world], "verbose": False}
    return dict(cfg, **KEYS[key]) if key else cfg


def _jax_unsharded(jm):
    """The JAX model's params (rank 0's replica) and momentum in the
    port's layout; under EASGD also the center."""
    st = _host(jm.step_state)
    if "center" in st["extra"]:
        return tuple(convert.params_from_jax(_host(t)) for t in (
            jax.tree.map(lambda a: a[0], st["params"]),
            jax.tree.map(lambda a: a[0], st["opt_state"]),
            JX._canonical_center(jm.exchanger, st)))
    params = jm.canonical_host_params()
    opt = st["opt_state"]
    if jm._fsdp is not None:
        vel = jm._fsdp.host_params_from_chunks(opt)
    elif jm._zero_layout is not None:
        flat = np.asarray(opt["opt"]).reshape(-1)[:JH.tree_size(jm.params)]
        vel = JH.unflatten_like(_host(jm.params), flat)
    elif jm._ushard_plan is not None:
        vel = JUS.unshard_boxed(opt["opt"], jm._ushard_plan)
    else:
        vel = jax.tree.map(lambda a: a[0], opt)
    return (convert.params_from_jax(_host(params)),
            convert.params_from_jax(_host(vel)))


def _jax_train(jm, epochs, start=0, ckpt_dir=None):
    """The JAX twin driven as its worker drives it (the rule's exchange
    hook after each step), ``ckpt_dir`` receiving a checkpoint after each
    epoch."""
    n = jm.data.n_batch_train
    for epoch in range(start, epochs):
        jm.adjust_hyperp(epoch)
        jm.data.shuffle_data(epoch + jm.seed)
        for count in range(epoch * n + 1, (epoch + 1) * n + 1):
            jm.train_iter(count)
            jm.exchanger.exchange(None, count)
        if ckpt_dir:
            jm.save(ckpt_dir, epoch, (epoch + 1) * n)


def _world(world, tmp_path_factory):
    """Every rank's results of the ``shard`` helper mode at ``world`` ranks,
    from the JAX twin's weights; at 2 ranks with a JAX ZeRO-1 and a JAX
    FSDP checkpoint of epoch 0 to load, and the JAX package's epoch-1
    results beside them.  One launch, cached."""
    if world not in _WORLDS:
        mp = pytest.MonkeyPatch()
        for k, v in ENV.items():
            mp.setenv(k, v)
        tmp = tmp_path_factory.mktemp(f"shard{world}")
        jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
        init = convert.params_from_jax(_host(jm.params))
        npz = str(tmp / "init.npz")
        np.savez(npz, **{"/".join(p): TH.get_leaf(init, p)
                         for p in TH.leaf_paths(init)})
        extra, jax_next = [], {}
        if world == 2:
            for case, (rule, cfg) in lh.JAX_CKPT_CASES.items():
                d = str(tmp / f"jax_{case}")
                cfg = dict(_jax_cfg(2, None), **cfg, rule=rule)
                jm = _JTinyLRNNet(cfg)
                jm.compile_iter_fns(JX.get_exchanger(rule, cfg))
                _jax_train(jm, 2, ckpt_dir=d)
                jax_next[case] = _jax_unsharded(jm)
                extra.append(f"jax_{case}={d}")
        out = str(tmp / "s")
        try:
            rc = lh.launch("bsp", "-", world, "device=cpu",
                           "helper_mode=shard", f"helper_out={out}",
                           f"batch_size={BATCH[world]}", "epochs=1",
                           "scale_lr=false", f"init_npz={npz}", *extra,
                           timeout_s=240)
        finally:
            mp.undo()
        assert rc == 0
        ranks = []
        for r in range(world):
            with np.load(f"{out}_r{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        _WORLDS[world] = (ranks, jax_next)
    return _WORLDS[world]


def _keys(st, case, kinds=("params/", "opt/", "canon/", "center/",
                           "strat/")):
    pre = f"{case}/"
    return sorted(k[len(pre):] for k in st if k.startswith(pre)
                  and k[len(pre):].startswith(kinds))


def _bit_equal(world, case):
    return world == 2 or case in ("zero", "ushard", "zero-mix", "easgd-us",
                                  "asgd-us", "powersgd-us")


@pytest.mark.parametrize("case", list(lh.SHARD_TWINS))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_equals_unsharded(world, case, tmp_path_factory):
    ranks, _ = _world(world, tmp_path_factory)
    twin = lh.SHARD_TWINS[case]
    clip_sum = case == "fsdp-mix"
    for r, st in enumerate(ranks):
        keys = _keys(st, case)
        assert keys == _keys(st, twin) and keys
        for k in keys:
            got, want = st[f"{case}/{k}"], st[f"{twin}/{k}"]
            if _bit_equal(world, case) and not clip_sum:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_allclose(got, want, err_msg=f"rank {r} {k}",
                                           **TOL)
            # BSP's replicas, and every rank's copy of a center, agree
            if k.startswith(("canon/", "center/")) or not (
                    k.startswith("strat/") or case.endswith("gd-us")):
                np.testing.assert_array_equal(got, ranks[0][f"{case}/{k}"])


def test_four_rank_reduce_scatter_within_reassociation_bound(
        tmp_path_factory):
    """One reduce-scatter and one all-reduce of the same flat gradient at 4
    ranks: each rank's chunk is its window of the all-reduce up to the order
    of each element's four-term sum: (W − 1) roundings of partial sums no
    larger than Σ|x_w| in each of the two orders (float32)."""
    ranks, _ = _world(4, tmp_path_factory)
    u = 2.0 ** -24
    absum = sum(np.abs(st["rs/in"]) for st in ranks) * (1 + 2 * u)
    n_diff = 0
    for r, st in enumerate(ranks):
        lo, hi = r * 250, (r + 1) * 250
        want, got = st["rs/allreduce"][lo:hi], st["rs/scatter"]
        assert (np.abs(got - want) <= 2 * 3 * u * absum[lo:hi]).all()
        n_diff += int((got != want).sum())
    ranks2, _ = _world(2, tmp_path_factory)
    for r, st in enumerate(ranks2):
        np.testing.assert_array_equal(st["rs/scatter"],
                                      st["rs/allreduce"][r * 500:
                                                         (r + 1) * 500])


@pytest.mark.parametrize("world", [2, 4])
def test_shard_round_trip_is_the_identity(world, tmp_path_factory):
    ranks, _ = _world(world, tmp_path_factory)
    like = lh.TinyWideNet({"device": "cpu", "verbose": False}).params
    like = dict(like, ragged={"v": torch.zeros(10)})
    r = np.random.RandomState(5)
    want = TH.tree_map(lambda p: r.randn(*p.shape).astype(np.float32), like)
    for st in ranks:
        for p in TH.leaf_paths(want):
            np.testing.assert_array_equal(
                st["roundtrip/" + "/".join(map(str, p))], TH.get_leaf(want, p))


@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("world", [2, 4])
def test_each_key_matches_jax_workers(world, key, tmp_path_factory):
    ranks, _ = _world(world, tmp_path_factory)
    jm = _JTinyLRNNet(_jax_cfg(world, key))
    jm.compile_iter_fns()
    _jax_train(jm, 1)
    want_p, want_v = _jax_unsharded(jm)
    for path in TH.leaf_paths(want_p):
        name = "/".join(path)
        for r, st in enumerate(ranks):
            np.testing.assert_allclose(st[f"{key}/params/{name}"],
                                       TH.get_leaf(want_p, path),
                                       err_msg=f"rank {r} {name}", **TOL)
            np.testing.assert_allclose(st[f"{key}/opt/{name}"],
                                       TH.get_leaf(want_v, path),
                                       err_msg=f"rank {r} velocity {name}",
                                       **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_state_is_the_partition(world, tmp_path_factory):
    """Per rank: ZeRO-1's optimizer state ⌈P/N⌉, each sharded leaf's
    ⌈size/N⌉ under ``update_sharding`` (the rest whole), FSDP's params and
    state ⌈total/N⌉ of the aligned layout; plain BSP P each."""
    ranks, _ = _world(world, tmp_path_factory)
    p = 1173
    plan = TUS.plan_tree(helper.TinyLRNNet({"device": "cpu",
                                            "verbose": False}).params,
                         world, min_bytes=lh.USHARD_MIN_BYTES)
    ushard = sum(l.chunk for l in plan.leaves)
    fs = TF.FsdpLayout(helper.TinyLRNNet({"device": "cpu",
                                          "verbose": False}).params, world)
    for st in ranks:
        assert int(st["plain/elems/params"]) == int(st["plain/elems/opt"]) \
            == p
        assert int(st["zero/elems/opt"]) == -(-p // world)
        assert int(st["ushard/elems/opt"]) == ushard < p
        assert int(st["fsdp/elems/params"]) == int(st["fsdp/elems/opt"]) \
            == fs.chunk == -(-fs.total // world)
        # update_sharding's centers
        assert int(st["easgd-us/elems/params"]) == p


@pytest.mark.parametrize("case", list(lh.RESUME_CASES))
def test_resume_bit_equal_on_each_rank(case, tmp_path_factory):
    """Two epochs straight against one, a checkpoint and a resumed second:
    every rank's own state, bit for bit.  Under ``none`` (C8) the ranks'
    states differ, and each resumes its own."""
    ranks, _ = _world(2, tmp_path_factory)
    for r, st in enumerate(ranks):
        pre = f"resume/{case}/full/"
        keys = [k[len(pre):] for k in st if k.startswith(pre)]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(st[f"resume/{case}/resumed/{k}"],
                                          st[pre + k],
                                          err_msg=f"rank {r} {k}")
    if case == "none":
        assert any(not np.array_equal(ranks[0][f"resume/none/full/{k}"],
                                      ranks[1][f"resume/none/full/{k}"])
                   for k in ("opt/0", "params/conv/w"))


@pytest.mark.parametrize("case", list(lh.JAX_CKPT_CASES))
def test_jax_checkpoint_continues_in_port(case, tmp_path_factory):
    """A JAX session at 2 workers (ZeRO-1, ``update_sharding``, FSDP, and
    EASGD with its center under ``update_sharding``) saved after epoch 0;
    the port at 2 gloo ranks loads it through
    ``convert.checkpoint_from_jax`` and trains epoch 1: params and momentum
    (rank 0's), and the center, within rtol 1e-5 / atol 1e-6 of the JAX
    package's own epoch 1."""
    ranks, jax_next = _world(2, tmp_path_factory)
    want = dict(zip(("params", "opt", "center"), jax_next[case]))
    for kind, tree in want.items():
        for path in TH.leaf_paths(tree):
            name = "/".join(path)
            # EASGD's replicas are their own: rank 0's against the JAX
            # package's worker 0
            rows = ranks[:1] if case == "easgd-us" and kind != "center" \
                else ranks
            for r, st in enumerate(rows):
                np.testing.assert_allclose(st[f"jax/{case}/{kind}/{name}"],
                                           TH.get_leaf(tree, path),
                                           err_msg=f"rank {r} {kind} {name}",
                                           **TOL)
