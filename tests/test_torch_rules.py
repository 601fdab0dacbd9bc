"""The port's async rules (EASGD, ASGD, GoSGD inside the step) against the
JAX package, and their invariants.

* At 2 gloo ranks (``torch_port_helper.run_ranks('rules', ...)``), from
  the JAX twin's weights: EASGD (``sync_freq`` 2, ``grad_clip`` biting on
  the local gradient), ASGD (``sync_freq`` 2) and GoSGD (``exch_prob``
  1.0, where ``jax.random.bernoulli`` always sends and the one route of
  two ranks is the swap in every peers mode) for two epochs through the
  session API, against the JAX rule on a 2-device CPU mesh driven as its
  worker drives it: every rank's params, optimizer state and rule state
  (center, α), the validation costs and the ``.npy`` snapshot of the
  canonical params; and the narrow ResNet under EASGD, each rank's own
  BatchNorm stats (apart from the other rank's) and validation on their
  replica mean.  float32; the packages differ in summation order only:
  rtol 1e-5 / atol 1e-6 (EASGD's clip scale, from a norm summed in
  another order, moves its updates by a few ulps more: rtol 2e-5; the
  ResNet's BatchNorm: rtol 1e-4 / atol 1e-5, ``test_torch_bn.py``'s).
* A GoSGD run that sends half the time, checkpointed after one epoch and
  resumed in a new session: bit for bit the uninterrupted run on both
  ranks (the draws come from the count, not from a stream).
* GoSGD at 3 ranks in every peers mode: Σα conserved (rtol 1e-6), α > 0,
  the α-weighted sum of the params conserved by pure gossip (rtol 1e-5)
  and the replicas' spread smaller after it.
* At world 1 on the CPU: the routing tables bit-equal to the JAX
  package's; ``steps_per_call = 4`` (the exchange fused into the window)
  bit for bit four single steps through the worker's hook, on the static
  step the card captures; BN state local under EASGD and validation on
  the replica-mean running stats; the refused modes and keys.

On the card (``cuda``, skipped here): EASGD and GoSGD captured (the train
step and the exchange, each a CUDA graph) against eager, 8 steps at
``steps_per_call`` 1 and 2, bit for bit.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.parallel import exchanger as JEX
from theanompi_tpu.parallel import topology as JT
from theanompi_tpu.utils.recorder import Recorder as JRecorder
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import exchanger as TEX
from theanompi_tpu_torch.parallel import topology as TT
from theanompi_tpu_torch.utils import helper_funcs as TH
from theanompi_tpu_torch.utils.recorder import Recorder as TRecorder

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet, cpu_group  # noqa: E402,F401
from test_torch_bn import _JTinyResNet  # noqa: E402

# (rtol, atol) of params, optimizer and rule state, and rtol of the
# validation costs; EASGD's clip scale, from a norm summed in another
# order, moves its updates by a few ulps more; the narrow ResNet's
# BatchNorm divides by 2-32 elements a channel (test_torch_bn.py's bound)
TOL = {"easgd": (2e-5, 1e-6), "asgd": (1e-5, 1e-6), "gosgd": (1e-5, 1e-6),
       "easgd_bn": (1e-4, 1e-5)}


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _bn_case(case):
    return helper.RULE_CASES[case].get("modelclass") == "TinyResNetFrom"


def _port_paths(case="easgd"):
    cls = helper.TinyResNet if _bn_case(case) else helper.TinyLRNNet
    return TH.leaf_paths(cls({"device": "cpu", "verbose": False}).params)


def _init_npz(jm, path):
    init = convert.params_from_jax(_host(jm.params))
    np.savez(path, **{"/".join(p): TH.get_leaf(init, p)
                      for p in TH.leaf_paths(init)})
    return path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each of the 2 ranks' results of the ``rules`` runs, from the JAX
    twins' initial weights."""
    tmp = tmp_path_factory.mktemp("rules")
    npz = _init_npz(_JTinyLRNNet({"n_workers": 1, "verbose": False}),
                    str(tmp / "init.npz"))
    bn_npz = _init_npz(_JTinyResNet({"n_workers": 1, "verbose": False}),
                       str(tmp / "init_bn.npz"))
    ck = str(tmp / "ck")
    ranks = helper.run_ranks("rules", 2, tmp, "rules", npz, bn_npz, ck,
                             timeout=300)
    return ranks, ck


def _jax_run(case):
    """The JAX rule at 2 workers, driven as its worker drives it (epoch
    schedule, common-seed shuffle, the exchange hook after each step,
    validation at each epoch's end): the model and its validation
    costs."""
    cfg = dict(helper.RULE_CASES[case])
    rule = cfg.pop("rule")
    cls = _JTinyResNet if cfg.pop("modelclass", None) else _JTinyLRNNet
    jm = cls(dict(cfg, n_workers=2, verbose=False))
    ex = JEX.get_exchanger(rule, jm.config)
    jm.compile_iter_fns(ex)
    count, vals = 0, []
    for epoch in range(helper.RULE_EPOCHS):
        jm.adjust_hyperp(epoch)
        jm.data.shuffle_data(epoch + jm.seed)
        for _ in range(jm.data.n_batch_train):
            count += 1
            jm.train_iter(count)
            ex.exchange(None, count)
        rec = JRecorder({"verbose": False})
        jm.begin_val()
        for _ in range(jm.data.n_batch_val):
            jm.val_iter(count, rec)
        jm.end_val()
        vals.append(rec.print_val_info(count)["val_cost"])
    return jm, vals


def _check_tree(got_leaves, want_tree, rtol, atol, what, paths):
    want = convert.params_from_jax(want_tree)
    for path, g in zip(paths, got_leaves):
        np.testing.assert_allclose(g, TH.get_leaf(want, path), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", list(helper.RULE_CASES))
def test_rule_at_two_gloo_ranks_matches_jax(two_ranks, case):
    """Every rank's params, velocity and rule state, the validation costs
    (the center, or the consensus, scored with the replica-mean BN stats)
    and the ``.npy`` snapshot against the JAX rule; under ``easgd_bn``
    each rank's own BatchNorm stats too, which stay apart."""
    ranks, ck = two_ranks
    jm, jvals = _jax_run(case)
    rtol, atol = TOL[case]
    state = _host(jm.step_state)
    paths = _port_paths(case)
    for r, res in enumerate(ranks):
        row = jax.tree.map(lambda a: a[r], state)
        _check_tree([res[f"{case}/params/" + "/".join(p)] for p in paths],
                    row["params"], rtol, atol, f"rank {r} params", paths)
        _check_tree([res[f"{case}/opt/{i}"] for i in range(len(paths))],
                    row["opt_state"], rtol, atol, f"rank {r} velocity",
                    paths)
        if case == "gosgd":
            np.testing.assert_allclose(res["gosgd/extra/0"],
                                       row["extra"]["alpha"], rtol=1e-6)
        else:
            _check_tree([res[f"{case}/extra/{i}"]
                         for i in range(len(paths))],
                        row["extra"]["center"], rtol, atol,
                        f"rank {r} center", paths)
        if _bn_case(case):
            bn = convert.bn_state_from_jax(row["bn_state"])
            for i, path in enumerate(TH.leaf_paths(bn)):
                np.testing.assert_allclose(
                    res[f"{case}/bn/{i}"], TH.get_leaf(bn, path),
                    rtol=1e-4, atol=1e-6, err_msg=f"rank {r} bn {path}")
        np.testing.assert_allclose(res[f"{case}/val_cost"], jvals,
                                   rtol=rtol)
    # the replicas really differ (the rule is not BSP in disguise), and
    # the center copies do not
    p0, p1 = (ranks[r][f"{case}/params/" + "/".join(paths[0])]
              for r in (0, 1))
    if case.startswith("easgd"):
        assert not np.array_equal(p0, p1)
    if _bn_case(case):
        assert not np.array_equal(ranks[0][f"{case}/bn/0"],
                                  ranks[1][f"{case}/bn/0"])
    if case != "gosgd":
        for i in range(len(paths)):
            np.testing.assert_array_equal(ranks[0][f"{case}/extra/{i}"],
                                          ranks[1][f"{case}/extra/{i}"])
    # the .npy snapshot holds the canonical params
    canon = convert.params_from_jax(_host(jm.canonical_host_params()))
    snap = os.path.join(ck, case, f"params_epoch{helper.RULE_EPOCHS - 1}")
    for p in paths:
        np.testing.assert_allclose(
            np.load(os.path.join(snap, "_".join(p) + ".npy")),
            TH.get_leaf(canon, p), rtol=rtol, atol=atol, err_msg=str(p))


def test_easgd_clips_the_local_gradient():
    """The EASGD run's ``grad_clip`` bites: each rank's first local
    gradient (its rows of the first batch, from the JAX twin's weights)
    has a norm above it, so the trajectory test above holds the clipped
    local update."""
    jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
    init = convert.params_from_jax(_host(jm.params))
    clip = helper.RULE_CASES["easgd"]["grad_clip"]
    for r in range(2):
        m = helper.TinyLRNNet({"device": "cpu", "verbose": False,
                               "rank": r, "size": 2})
        m.load_params(init)
        m.data.shuffle_data(m.seed)
        b = {k: torch.from_numpy(v)
             for k, v in m.data.next_train_batch(1).items()}
        cost, _ = m.loss_and_metrics(m.params, m.bn_state, b, None, True)
        g = torch.autograd.grad(cost, TH.tree_leaves(m.params))
        norm = float(torch.sqrt(sum((x * x).sum() for x in g)))
        assert norm > clip, (r, norm)


def test_async_checkpoint_resumes_bit_equal(two_ranks):
    """GoSGD sending half the time, at 2 ranks: one epoch, a checkpoint
    (every rank's params, velocity, α and BN state), a new session
    resumed from it for the second epoch: each rank bit for bit the
    uninterrupted run."""
    ranks, _ = two_ranks
    for res in ranks:
        full = {k[len("resume/full/"):]: v for k, v in res.items()
                if k.startswith("resume/full/")}
        again = {k[len("resume/resumed/"):]: v for k, v in res.items()
                 if k.startswith("resume/resumed/")}
        assert sorted(full) == sorted(again) and full
        for k in full:
            np.testing.assert_array_equal(again[k], full[k], err_msg=k)
    a0, a1 = (float(r["resume/full/extra/0"]) for r in ranks)
    np.testing.assert_allclose(a0 + a1, 2.0, rtol=1e-6)


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gossip")
    return helper.run_ranks("gossip", 3, tmp, "gossip", timeout=300)


@pytest.mark.parametrize("peers", ["perm", "shift", "iid"])
def test_gosgd_three_ranks_conserves_alpha_and_mixes(three_ranks, peers):
    ranks = three_ranks
    alpha = np.stack([r[f"{peers}/alpha"] for r in ranks])   # [rank, exch]
    np.testing.assert_allclose(alpha.sum(0), 3.0, rtol=1e-6)
    assert (alpha > 0).all()
    assert len({tuple(a) for a in alpha}) > 1, "no rank's α moved apart"
    keys = [k[len(f"{peers}/before/"):] for k in ranks[0]
            if k.startswith(f"{peers}/before/")]

    def weighted(stage, a):
        return sum(float((r[f"{peers}/{stage}/{k}"].astype(np.float64)
                          * w).sum()) for r, w in zip(ranks, a)
                   for k in keys)

    def spread(stage):
        return sum(float(np.ptp(np.stack([r[f"{peers}/{stage}/{k}"]
                                          for r in ranks]), axis=0).mean())
                   for k in keys)

    np.testing.assert_allclose(weighted("after", alpha[:, -1]),
                               weighted("before", np.ones(3)), rtol=1e-5)
    assert spread("before") > 0
    assert spread("after") < spread("before")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_topology_tables_bit_equal_to_jax(n):
    for seed in (0x605, 0x605 + 3):
        np.testing.assert_array_equal(TT.derangements(n, 16, seed=seed),
                                      JT.derangements(n, 16, seed=seed))
    maps = TT.iid_maps(n, 16, seed=0x1d1)
    np.testing.assert_array_equal(maps, JT.iid_maps(n, 16, seed=0x1d1))
    for m in maps:
        assert TT.collision_rounds(m) == JT.collision_rounds(m)
    np.testing.assert_array_equal(
        TT.embed_active(TT.derangements(2, 4), [0, n - 1], n),
        JT.embed_active(JT.derangements(2, 4), [0, n - 1], n))


def test_gosgd_routes_pick_one_table_on_every_rank():
    """Every rank picks the same routing from ``(gosgd_seed, count)``; a
    round's senders and receivers are distinct, and each sender sends
    once; ``perm`` routes by the JAX package's derangements."""
    for peers in ("perm", "shift", "iid"):
        picks = []
        for rank in range(5):
            ex = TEX.GOSGD_Exchanger({"gosgd_peers": peers})
            ex.prepare(type("M", (), {"rank": rank})(), 5)
            picks.append([ex.rounds(c) for c in range(1, 20)])
        assert all(p == picks[0] for p in picks)
        for rounds in picks[0]:
            senders = [s for r in rounds for s, _ in r]
            assert sorted(senders) == list(range(5))
            for r in rounds:
                assert len({s for s, _ in r}) == len({d for _, d in r}) \
                    == len(r)
                assert all(s != d for s, d in r)
            if peers == "perm":
                dest = dict(rounds[0])
                assert any((np.array([dest[i] for i in range(5)]) == p).all()
                           for p in JT.derangements(5, 16, seed=0x605))


def _rule_model(rule, spc, modelclass="TinyLRNNet", **cfg):
    """A worker of ``rule`` on the CPU and its model, built as a session
    builds them."""
    from theanompi_tpu_torch.worker import WORKERS
    w = WORKERS[rule](dict({"device": "cpu", "verbose": False,
                            "steps_per_call": spc}, **cfg))
    return w, w.build_model("torch_port_helper", modelclass)


FUSED = [("easgd", {"sync_freq": 2}), ("easgd", {"sync_freq": 3}),
         ("easgd", {"sync_freq": 4}), ("asgd", {"sync_freq": 1}),
         ("asgd", {"sync_freq": 2}), ("gosgd", {"exch_prob": 0.5})]


@pytest.mark.parametrize("rule,cfg", FUSED,
                         ids=[f"{r}-{'-'.join(map(str, c.values()))}"
                              for r, c in FUSED])
def test_fused_window_equals_single_steps_bit_for_bit(rule, cfg):
    """8 steps as two ``steps_per_call = 4`` windows of the static step
    (the exchange inside the window when a step's count is due; with
    ``sync_freq`` 3 the two windows differ in phase) against 8 single
    static steps, each followed by the worker's exchange hook: the same
    costs, params, optimizer state and rule state, bit for bit."""
    runs = []
    for spc in (1, 4):
        w, m = _rule_model(rule, spc, modelclass="TinyDropNet",
                           batch_size=4, **cfg)
        try:
            m.compile_iter_fns(w.exchanger, capture=True)
            assert w.exchanger.fused == (spc > 1)
            assert (m.exchange_fn is None) == (spc > 1)
            m.data.shuffle_data(0)
            costs = []
            for c in range(spc, 9, spc):
                m.train_iter(c)
                w.exchanger.exchange(None, c)
                costs.append(float(m.current_info["cost"]))
            runs.append((m, costs))
        finally:
            w.close()
    (one, c1), (many, c4) = runs
    np.testing.assert_array_equal(
        np.float32([np.float32(c1[:4]).mean(), np.float32(c1[4:]).mean()]),
        np.float32(c4))
    x, y = helper.state_arrays(one), helper.state_arrays(many)
    assert sorted(x) == sorted(y)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_fused_phase_picks_the_exchanging_steps(cpu_group):
    """Which steps of a window end in an exchange follows the window's
    phase against ``sync_freq``: with k = 4 and ``sync_freq`` 3 the window
    of counts 1-4 exchanges after 3, the one of 5-8 after 6."""
    w, m = _rule_model("easgd", 4, sync_freq=3)
    try:
        m.compile_iter_fns(w.exchanger, capture=True)
        seen = []
        body = w.exchanger.exchange_body
        w.exchanger.exchange_body = lambda c, g=None: (seen.append(c),
                                                       body(c, g))
        m.data.shuffle_data(0)
        m.train_iter(4)
        assert m.train_fn._phase() == 1
        m.train_iter(8)
        assert m.train_fn._phase() == 2
        assert seen == [3, 6]
    finally:
        w.close()


def test_easgd_keeps_bn_local_and_validates_on_the_replica_mean(cpu_group):
    """Under EASGD the step leaves the BatchNorm running stats as each
    rank's forward wrote them (no ``sync_bn`` all-reduce: a spy sees
    none), and ``begin_val`` scores the center with the stats' mean over
    the ranks, in new tensors: the training stats are not written."""
    import torch.distributed as dist
    w, m = _rule_model("easgd", 1, modelclass="TinyResNet", sync_freq=2)
    try:
        m.compile_iter_fns(w.exchanger)
        m.data.shuffle_data(0)
        calls = []
        real = dist.all_reduce
        dist.all_reduce = lambda t, *a, **k: (calls.append(t.numel()),
                                              real(t, *a, **k))[1]
        try:
            m.train_iter(1)
        finally:
            dist.all_reduce = real
        # the metrics' all-reduce only: 2 values a step
        assert calls == [2]
        bn = [t.clone() for t in TH.tree_leaves(m.bn_state)]
        m.train_iter(2)
        w.exchanger.exchange(None, 2)
        m.begin_val()
        params, vbn = m.val_params()
        assert params is m.extra["center"]
        for a, b in zip(TH.tree_leaves(vbn), TH.tree_leaves(m.bn_state)):
            assert a is not b
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        rec = TRecorder({"verbose": False})
        m.val_iter(2, rec)
        m.end_val()
        assert m._val is None
        assert any(not torch.equal(a, b) for a, b in
                   zip(bn, TH.tree_leaves(m.bn_state)))
    finally:
        w.close()


@pytest.mark.parametrize("rule", ["EASGD", "ASGD", "GOSGD"])
def test_session_api_trains_each_rule_on_cpu(rule):
    """``<RULE>().init(devices=1, ...).wait()`` end to end: finite costs, a
    validation record, and the rule's state where it belongs."""
    import theanompi_tpu_torch as T
    r = getattr(T, rule)()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", printFreq=2, verbose=False, sync_freq=2)
    rec = r.wait()
    assert len(rec.train_records) == 3
    assert all(np.isfinite(x["cost"]) for x in rec.train_records)
    assert np.isfinite(rec.epoch_records[-1]["val_cost"])
    assert ("alpha" if rule == "GOSGD" else "center") in r.model.extra


@pytest.mark.parametrize("rule,cfg,exc,match", [
    # async islands: one device an island (devices=2 over one island)
    ("EASGD", {"easgd_mode": "async", "async_islands": 1, "devices": 2},
     NotImplementedError, "more than one device"),
    ("BSP", {"exch_mode": "gradients"}, ValueError, "exch_mode"),
    ("BSP", {"exch_strategy": "ring8"}, ValueError, "ring8"),
    # the JAX package's sharding refusals (at world 1 it accepts
    # update_sharding under ASGD as inert)
    ("BSP", {"update_sharding": True, "zero_opt": True}, ValueError,
     "update_sharding with zero_opt"),
    ("BSP", {"fsdp": True, "exch_strategy": "onebit"}, ValueError,
     "fsdp requires BSP grads"),
    ("BSP", {"fsdp": True, "bucket_bytes": 1024}, ValueError,
     "bucket_bytes"),
    ("GOSGD", {"gosgd_peers": "ring"}, ValueError, "gosgd_peers"),
    ("EASGD", {"ema_decay": 0.9}, ValueError, "ema_decay requires BSP"),
    ("BSP", {"ema_decay": 0.9, "exch_strategy": "none"}, ValueError,
     "ema_decay requires BSP"),
])
def test_refused_modes_and_keys_raise(rule, cfg, exc, match):
    import theanompi_tpu_torch as T
    cfg = dict(cfg)
    r = getattr(T, rule)()
    r.init(devices=cfg.pop("devices", 1), modelfile="torch_port_helper",
           modelclass="TinyLRNNet", device="cpu", verbose=False, **cfg)
    with pytest.raises(exc, match=match):
        r.wait()


@pytest.mark.parametrize("key", ["lease_dir", "chaos_dir"])
def test_island_lease_and_chaos_keys_run(key, tmp_path):
    """The islands' membership keys run: ``lease_dir`` beats one lease an
    island (its id the worker id), ``chaos_dir`` is read at an exchange
    round, its ``corrupt`` trigger consumed and applied."""
    import json
    import os
    import theanompi_tpu_torch as T
    from theanompi_tpu_torch.parallel import membership
    d = str(tmp_path / key)
    rec = str(tmp_path / "rec")
    cfg = {"easgd_mode": "async", "async_islands": 2, "sync_freq": 2,
           "run_seconds": 3, "island_base": 4, "record_dir": rec, key: d}
    if key == "chaos_dir":
        os.makedirs(d)
        with open(os.path.join(d, "corrupt_w5.json"), "w") as f:
            json.dump({"target": 5, "scale": 0.5}, f)
    r = T.EASGD()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", verbose=False, **cfg)
    tr = r.wait()
    assert all(i["exchanges"] >= 1 for i in tr.stats()["islands"])
    if key == "lease_dir":
        docs = membership.read_leases(d)
        assert sorted(docs) == [4, 5]
        assert all(doc["status"] == "live" and doc["step"] >= 1 and
                   doc["pid"] == os.getpid() for doc in docs.values())
    else:
        assert os.listdir(d) == []               # the trigger consumed
        with open(os.path.join(rec, "telemetry_rank0.jsonl")) as f:
            evs = [json.loads(ln) for ln in f if ln.strip()]
        assert [(e["island"], e["scale"]) for e in evs
                if e["ev"] == "corrupt_applied"] == [(5, 0.5)]


def test_island_corrupt_adds_in_place_to_the_first_jax_leaf(tmp_path):
    """The ``corrupt`` perturbation: the trigger's scale added to the first
    params leaf in the JAX package's flatten order, in place (the tensor
    the step reads keeps its storage), every other leaf untouched; a
    trigger without a scale adds 1e-3."""
    import json
    import os
    import threading
    from theanompi_tpu_torch.parallel.async_easgd import (CenterLink,
                                                          ElasticCenter,
                                                          IslandRunner)
    from theanompi_tpu_torch.utils.helper_funcs import (jax_leaf_paths,
                                                        leaf_paths,
                                                        tree_leaves)
    m = helper.TinyLRNNet({"device": "cpu", "verbose": False})
    link = CenterLink(m, ElasticCenter(alpha=0.5), 0)
    runner = IslandRunner(0, None, {}, None, 2, threading.Event())
    first = leaf_paths(m.params).index(jax_leaf_paths(m.params)[0])
    for scale, want in ((0.25, 0.25), (0.0, 1e-3)):
        path = str(tmp_path / "corrupt_w0.json")
        with open(path, "w") as f:
            json.dump({"target": 0, "scale": scale}, f)
        before = [t.clone() for t in tree_leaves(m.params)]
        ptrs = [t.data_ptr() for t in tree_leaves(m.params)]
        runner._corrupt(link, path)
        assert not os.path.exists(path)
        after = tree_leaves(m.params)
        assert [t.data_ptr() for t in after] == ptrs
        for i, (a, b) in enumerate(zip(before, after)):
            want_i = a + want if i == first else a
            assert torch.equal(b, want_i), i
    runner._corrupt(link, str(tmp_path / "absent.json"))    # no trigger
    assert all(torch.equal(a, b) for a, b in zip(after,
                                                 tree_leaves(m.params)))


@pytest.mark.parametrize("rule,cfg", [
    ("BSP", {"exch_mode": "gradients"}), ("BSP", {"exch_strategy": "ring8"}),
    ("GOSGD", {"gosgd_peers": "ring"})])
def test_refused_exchanger_leaves_no_process_group(rule, cfg):
    """A config the exchanger refuses raises from the worker's constructor,
    after the worker joined its process group: the group is left again,
    so a later session in the same process can start (C7)."""
    import torch.distributed as dist
    import theanompi_tpu_torch as T
    r = getattr(T, rule)()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", verbose=False, **cfg)
    with pytest.raises((NotImplementedError, ValueError)):
        r.wait()
    assert not dist.is_initialized()


def test_membership_and_captured_gossip_at_world_two_are_refused():
    """BSP refuses a change of membership with the JAX package's message
    (its reaction is the supervised world restart; the async rules'
    masked membership is ``tests/test_torch_mesh_membership.py``'s), and
    GoSGD's exchange is not captured at world > 1 (A6)."""
    with pytest.raises(NotImplementedError, match="launcher --supervise"):
        TEX.BSP_Exchanger({}).set_active_ranks([0])
    for cls in (TEX.EASGD_Exchanger, TEX.ASGD_Exchanger,
                TEX.GOSGD_Exchanger):
        assert cls({}).supports_elastic()
    ex = TEX.GOSGD_Exchanger({})
    ex.prepare(type("M", (), {"rank": 0})(), 1)
    ex.check_capture()                      # world 1: the identity route
    ex.prepare(type("M", (), {"rank": 0})(), 2)
    with pytest.raises(NotImplementedError, match="A6"):
        ex.check_capture()


@pytest.mark.cuda
@pytest.mark.parametrize("rule,cfg", [("easgd", {"sync_freq": 2}),
                                      ("gosgd", {"exch_prob": 0.5})])
@pytest.mark.parametrize("spc", [1, 2])
def test_graph_equals_eager_on_card(monkeypatch, rule, cfg, spc):
    """8 steps captured (the step, and at ``steps_per_call`` 1 the
    exchange in a graph of its own) against 8 eager, from the same
    weights, batches and gossip draws, cuDNN deterministic: costs, params,
    velocity and rule state bit for bit, and the LRN kernels' launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theanompi_tpu_torch.parallel import graph as graph_lib
    from theanompi_tpu_torch.worker import WORKERS
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = []
    for capture in (False, True):
        for k in graph_lib.kernel_wrappers():
            k.launches = 0
        w = WORKERS[rule](dict({"verbose": False, "steps_per_call": spc},
                               **cfg))
        try:
            m = w.build_model("torch_port_helper", "TinyLRNNet")
            m.compile_iter_fns(w.exchanger, capture=capture)
            m.data.shuffle_data(0)
            costs = []
            for c in range(spc, 9, spc):
                m.train_iter(c)
                w.exchanger.exchange(None, c)
                costs.append(float(m.current_info["cost"]))
            torch.cuda.synchronize()
            assert m.train_fn.graphed == capture
            if spc == 1:
                assert m.exchange_fn.graphed == capture
            runs.append((helper.state_arrays(m), costs,
                         {k.__name__: k.launches
                          for k in graph_lib.kernel_wrappers()}))
        finally:
            w.close()
    (a, ca, la), (b, cb, lb) = runs
    assert ca == cb and la == lb
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
