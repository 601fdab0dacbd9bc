"""BSP's ``exch_mode='params'`` and the ``Ring`` strategies of the port
against the JAX package.

* The six ring names resolve to ``Ring`` (``ring16``/``asa16``/``copper16``
  with the bfloat16 wire); at world 1 the ring is the identity.
* One exchange at 4 gloo ranks (``torch_launch_helper``'s ``params_ring``
  mode, one launch) of a gradient tree of ``TinyVGGNet``'s shapes drawn
  from the seed ``100 + rank``, against the JAX ``Ring`` over 4 workers on
  the same inputs: ``ring`` and ``asa32`` within rtol 1e-5 / atol 1e-6,
  ``ring16`` and ``copper16`` within ``tests/test_strategies.py:84``'s
  bfloat16 bound (rtol and atol 0.05), and beyond both, bit for bit the
  JAX ring's result (the chunks are cut in the JAX flat order, so each
  element's partial sums meet in the JAX ring's order); every rank holds
  the same bits.
* Trained at 4 ranks, one epoch from the JAX twin's weights: ``ring``
  against the JAX package's ring at 4 workers, and params mode against
  the JAX package's params mode, params and rank 0's momentum within
  rtol 1e-5 / atol 1e-6.
* Params mode at 2 ranks (one launch) against the NumPy oracle of
  ``tests/test_bsp_equivalence.py:58-106`` (rtol 2e-6, atol 1e-7): each
  rank's local momentum step on its own rows' gradient (the port's loss,
  plain autograd, no process group, no exchanger), then the parameters
  averaged.  The replicas are identical after each exchange while their
  momenta differ, and a params-mode checkpoint resumes bit-equal, the
  per-rank momentum included.
* At world 1 on the CPU: params mode ≡ grads mode, the fused
  ``steps_per_call = 2`` window ≡ single steps with the worker's hook,
  and ``ema_decay`` refused under params mode.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.jax_compat import shard_map
from theanompi_tpu.parallel import steps as JSteps
from theanompi_tpu.parallel.mesh import (WORKER_AXIS, worker_local_sharding,
                                         worker_mesh)
from theanompi_tpu.parallel.strategies import get_strategy as j_strategy
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.parallel import strategies as TS
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
# the port's leaf order (``opt/<i>`` follows it)
PORT_PATHS = TH.leaf_paths(helper.TinyLRNNet({"device": "cpu",
                                              "verbose": False}).params)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# -- names and world 1 ------------------------------------------------------------

@pytest.mark.parametrize("name,wire", [
    ("asa32", None), ("ring", None), ("copper", None),
    ("asa16", torch.bfloat16), ("ring16", torch.bfloat16),
    ("copper16", torch.bfloat16)])
def test_ring_names_resolve(name, wire):
    s = TS.get_strategy(name)
    assert isinstance(s, TS.Ring) and s.wire_dtype is wire and s.flattens
    assert s.name == ("ring" if wire is None else "ring16")
    assert s.n_buckets({"w": torch.zeros(3)}, 1024) is None


def test_ring_at_world_one_is_the_identity():
    g = {"w": torch.randn(3, 2)}
    out, st = TS.get_strategy("ring16")(g, (), size=1)
    assert out is g and st == ()


# -- launched worlds ----------------------------------------------------------------

_WORLDS = {}


def _world(world, tmp_path_factory):
    """Every rank's results of the ``params_ring`` helper mode at ``world``
    ranks, from the JAX twin's weights; one launch, cached."""
    if world not in _WORLDS:
        mp = pytest.MonkeyPatch()
        for k, v in ENV.items():
            mp.setenv(k, v)
        tmp = tmp_path_factory.mktemp(f"params_ring{world}")
        jm = _JTinyLRNNet({"n_workers": 1, "verbose": False})
        init = convert.params_from_jax(_host(jm.params))
        npz = str(tmp / "init.npz")
        np.savez(npz, **{"/".join(p): TH.get_leaf(init, p)
                         for p in TH.leaf_paths(init)})
        out = str(tmp / "p")
        try:
            rc = lh.launch("bsp", "-", world, "device=cpu",
                           "helper_mode=params_ring", f"helper_out={out}",
                           f"batch_size={BATCH[world]}", "epochs=1",
                           "scale_lr=false", f"init_npz={npz}",
                           timeout_s=120)
        finally:
            mp.undo()
        assert rc == 0
        ranks = []
        for r in range(world):
            with np.load(f"{out}_r{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        _WORLDS[world] = (ranks, init)
    return _WORLDS[world]


def _jax_ring(name, per_rank):
    """The JAX package's strategy ``name`` over 4 workers, each worker's
    tree its rank's port tree in the JAX layout; the outputs back in the
    port's layout, per worker."""
    like = per_rank[0]
    boxed = jax.tree.map(lambda *xs: np.stack(xs), *[
        {"/".join(p): TH.to_jax_layout(TH.get_leaf(t, p), p).numpy()
         for p in TH.leaf_paths(t)} for t in per_rank])
    strat = j_strategy(name)

    def body(tree):
        out, _ = strat(JSteps.unbox(tree), (), axis=WORKER_AXIS, size=4)
        return JSteps.box(out)

    mesh = worker_mesh(4)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(WORKER_AXIS),),
                           out_specs=P(WORKER_AXIS)))
    sh = worker_local_sharding(mesh)
    got = _host(fn(jax.tree.map(lambda x: jax.device_put(x, sh), boxed)))
    return [{k: TH.from_jax_layout(torch.from_numpy(np.array(v[w])),
                                   tuple(k.split("/"))).numpy()
             for k, v in got.items()} for w in range(4)], like


@pytest.mark.parametrize("name", lh.RING_NAMES)
def test_ring_exchange_matches_jax_ring_at_four(name, tmp_path_factory):
    ranks, _ = _world(4, tmp_path_factory)
    pre = f"ring/{name}/in/"
    keys = [k[len(pre):] for k in ranks[0] if k.startswith(pre)]
    per_rank = [{tuple(k.split("/")): torch.from_numpy(st[pre + k])
                 for k in keys} for st in ranks]
    per_rank = [_nest(t) for t in per_rank]
    want, _ = _jax_ring(name, per_rank)
    tol = dict(rtol=1e-5, atol=1e-6) if name in ("ring", "asa32") else \
        dict(rtol=0.05, atol=0.05)
    mean = {k: sum(st[pre + k] for st in ranks) / 4 for k in keys}
    for r, st in enumerate(ranks):
        for k in keys:
            got = st[f"ring/{name}/out/{k}"]
            np.testing.assert_allclose(got, want[r][k], err_msg=k, **tol)
            np.testing.assert_allclose(got, mean[k], err_msg=k, **tol)
            # the same hops in the same order over the same bits: the JAX
            # ring's result exactly
            np.testing.assert_array_equal(got, want[r][k], err_msg=k)
            np.testing.assert_array_equal(got, ranks[0][f"ring/{name}/out/"
                                                        f"{k}"])


def _nest(flat):
    """``{(layer, leaf): t}`` → ``{layer: {leaf: t}}``."""
    out = {}
    for (a, b), t in flat.items():
        out.setdefault(a, {})[b] = t
    return out


def _jax_run(case_cfg, world):
    """The JAX twin at ``world`` workers, driven as its worker drives it,
    the exchange hook after each step."""
    jm = _JTinyLRNNet({"n_workers": world, "batch_size": BATCH[world],
                       "verbose": False, **case_cfg})
    jm.compile_iter_fns()
    jm.adjust_hyperp(0)
    jm.data.shuffle_data(0 + jm.seed)
    for count in range(1, jm.data.n_batch_train + 1):
        jm.train_iter(count)
        jm.exchanger.exchange(None, count)
    st = _host(jm.step_state)
    return (convert.params_from_jax(jax.tree.map(lambda a: a[0],
                                                 st["params"])),
            convert.params_from_jax(jax.tree.map(lambda a: a[0],
                                                 st["opt_state"])))


@pytest.mark.parametrize("case", list(lh.PARAMS_RING_CASES))
def test_four_ranks_match_jax_four_workers(case, tmp_path_factory):
    """Params and rank 0's momentum after one epoch at rtol 1e-5 / atol
    1e-6 (float32; the gradients from oneDNN and XLA; ``asa16`` rounds
    each hop to bfloat16 in both, so a last-bit difference in a gradient
    can move a rounding: held at the bfloat16 bound of
    ``tests/test_strategies.py:84``)."""
    ranks, init = _world(4, tmp_path_factory)
    want_p, want_v = _jax_run(lh.PARAMS_RING_CASES[case], 4)
    tol = dict(rtol=0.05, atol=0.05) if case == "asa16" else \
        dict(rtol=1e-5, atol=1e-6)
    for i, path in enumerate(PORT_PATHS):
        name = "/".join(path)
        np.testing.assert_allclose(ranks[0][f"{case}/params/{name}"],
                                   TH.get_leaf(want_p, path), err_msg=name,
                                   **tol)
        np.testing.assert_allclose(ranks[0][f"{case}/opt/{i}"],
                                   TH.get_leaf(want_v, path),
                                   err_msg="velocity " + name, **tol)
        for st in ranks[1:]:
            np.testing.assert_array_equal(st[f"{case}/params/{name}"],
                                          ranks[0][f"{case}/params/{name}"])


def _oracle(init, world, steps):
    """test_bsp_equivalence.py's params-mode oracle in NumPy: each rank's
    gradient from the port's loss by plain autograd on its own rows, the
    momentum step ``v = mu·v − lr·(g + wd·p)``, ``p += v``, then the mean of
    the parameters."""
    paths = TH.leaf_paths(init)
    models = [helper.TinyLRNNet({"device": "cpu", "verbose": False,
                                 "size": world, "rank": w,
                                 "batch_size": BATCH[world]})
              for w in range(world)]
    m0 = models[0]
    lr, mu, wd = np.float32(m0.current_lr), np.float32(m0.momentum), \
        np.float32(m0.weight_decay)
    for m in models:
        m.data.shuffle_data(0 + m.seed)
    ps = [{p: np.array(TH.get_leaf(init, p)) for p in paths}
          for _ in range(world)]
    vs = [{p: np.zeros_like(v) for p, v in ps[0].items()}
          for _ in range(world)]
    for step in range(1, steps + 1):
        for w, m in enumerate(models):
            b = m.data.next_train_batch(step)
            params = TH.tree_map(lambda _: None, init)
            leaves = [torch.tensor(ps[w][p], requires_grad=True)
                      for p in paths]
            it = iter(leaves)
            params = TH.tree_map(lambda _: next(it), params)
            batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            cost, _ = m.loss_and_metrics(params, m.bn_state, batch, None,
                                         True)
            grads = torch.autograd.grad(cost, leaves)
            for p, g in zip(paths, grads):
                step_ = (wd * ps[w][p] + g.numpy()) * lr
                vs[w][p] = vs[w][p] * mu - step_
                ps[w][p] = ps[w][p] + vs[w][p]
        avg = {p: (sum(ps[w][p] for w in range(world))
                   * np.float32(1.0 / world)) for p in paths}
        ps = [{p: v.copy() for p, v in avg.items()} for _ in range(world)]
    return avg, vs


def test_params_mode_two_ranks_match_numpy_oracle(tmp_path_factory):
    ranks, init = _world(2, tmp_path_factory)
    steps = helper.N_TRAIN // (2 * BATCH[2])
    avg, vs = _oracle(init, 2, steps)
    for i, p in enumerate(PORT_PATHS):
        name = "/".join(p)
        for r, st in enumerate(ranks):
            np.testing.assert_allclose(st[f"params/params/{name}"], avg[p],
                                       rtol=2e-6, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(st[f"params/opt/{i}"], vs[r][p],
                                       rtol=2e-6, atol=1e-7,
                                       err_msg=f"rank {r} velocity {name}")


@pytest.mark.parametrize("world", [2, 4])
def test_params_mode_replicas_identical_momenta_their_own(world,
                                                          tmp_path_factory):
    ranks, _ = _world(world, tmp_path_factory)
    for i, p in enumerate(PORT_PATHS):
        name = "/".join(p)
        for st in ranks[1:]:
            np.testing.assert_array_equal(st[f"params/params/{name}"],
                                          ranks[0][f"params/params/{name}"])
            # each rank's momentum follows its own gradients
            assert not np.array_equal(st[f"params/opt/{i}"],
                                      ranks[0][f"params/opt/{i}"])


def test_params_mode_checkpoint_resumes_bit_equal(tmp_path_factory):
    """Two epochs without a break against one epoch, a checkpoint and a
    resumed second epoch, per rank: params, each rank's own momentum."""
    ranks, _ = _world(2, tmp_path_factory)
    for r, st in enumerate(ranks):
        keys = sorted(k[len("resume/full/"):] for k in st
                      if k.startswith("resume/full/"))
        assert any(k.startswith("opt/") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(st[f"resume/resumed/{k}"],
                                          st[f"resume/full/{k}"],
                                          err_msg=f"rank {r} {k}")
    assert not np.array_equal(ranks[0]["resume/full/opt/0"],
                              ranks[1]["resume/full/opt/0"])


# -- world 1 -------------------------------------------------------------------------

def _state(rule):
    return {k: v for k, v in helper.state_arrays(rule.model).items()}


@pytest.mark.parametrize("cfg", [{}, {"exch_strategy": "onebit"},
                                 {"exch_strategy": "ring16"},
                                 {"bucket_bytes": 256}])
def test_params_mode_equals_grads_mode_at_world_one(cfg):
    """One rank: the mean of one replica is itself (onebit's of the
    params, not of the gradients, differs: held for allreduce, ring16 and
    the bucketed wire), so both modes train the same bits; params mode
    builds the exchange step, grads mode none."""
    if cfg.get("exch_strategy") == "onebit":
        r = helper.run_session("TinyLRNNet", 1, exch_mode="params", **cfg)
        assert r.model.exchange_fn is not None
        assert r.model.extra["strat"].shape[0] % 32768 == 0
        assert all(np.isfinite(v).all() for v in _state(r).values())
        return
    a = helper.run_session("TinyLRNNet", 1, **cfg)
    b = helper.run_session("TinyLRNNet", 1, exch_mode="params", **cfg)
    assert a.model.exchange_fn is None and b.model.exchange_fn is not None
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_params_mode_fused_window_equals_single_steps():
    a = helper.run_session("TinyLRNNet", 1, exch_mode="params",
                           exch_strategy="ring")
    b = helper.run_session("TinyLRNNet", 1, exch_mode="params",
                           exch_strategy="ring", steps_per_call=2)
    assert b.model.exchanger.fused and b.model.exchange_fn is None
    sa, sb = _state(a), _state(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_ema_and_unknown_mode_refused():
    import theanompi_tpu_torch as T
    r = T.BSP()
    r.init(devices=1, modelfile="torch_port_helper", modelclass="TinyLRNNet",
           device="cpu", verbose=False, exch_mode="params", ema_decay=0.9)
    with pytest.raises(ValueError, match="ema_decay requires BSP grads"):
        r.wait()
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    with pytest.raises(ValueError, match="exch_mode"):
        BSP_Exchanger({"exch_mode": "both"})
