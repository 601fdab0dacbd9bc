"""Models and per-rank entries for the launcher's tests
(``tests/test_torch_launcher.py``, ``tests/test_torch_islands_world.py``).

Imports only ``theanompi_tpu_torch`` and ``torch_port_helper`` (no JAX):
it runs in every rank's process, either as the launcher's modelfile
(``--modelfile torch_launch_helper``) or as each rank's module in place
of the worker (:func:`launch`: the launcher's rank lines and
``run_world``), where it takes the worker's arguments and two keys of
its own, ``helper_mode`` and ``helper_out``:

* ``helper_mode=wires``: joins the launcher's world once and trains each
  of ``WIRE_CASES`` (allreduce, onebit, topk, PowerSGD at rank 1, and the
  narrow ResNet's ``sync_bn`` under allreduce) through the ``BSP`` session
  in it, then writes every case's final state to
  ``<helper_out>_r<rank>.npz`` (``<case>/<key>``, keys as
  ``torch_port_helper.state_arrays`` makes them).
* ``helper_mode=buckets``: joins the world once and trains each of
  ``BUCKET_CASES`` twice through its rule's session, on the monolithic
  wire and at ``bucket_bytes=BUCKET_BYTES``, writing both runs' final state
  (``<case>/mono/<key>``, ``<case>/buck/<key>``), the exchanger's
  ``n_buckets`` (``<case>/n_buckets``) and the collectives one more step
  and its exchange issued on each wire (``<case>/<wire>/calls``:
  all-reduces, all-gathers, point-to-point messages); at 4 ranks also
  one exchange of ``SUM_WIRES`` on a gradient tree of ``TinyWideNet``'s
  shapes drawn from the seed ``100 + rank``, on both wires
  (``sum/<name>/<wire>/<path>``).
* ``helper_mode=params_ring``: joins the world once; at 4 ranks runs one
  exchange of each ``RING_NAMES`` strategy on a gradient tree of
  ``TinyVGGNet``'s shapes drawn from the seed ``100 + rank``
  (``ring/<name>/in/<path>``, ``ring/<name>/out/<path>``) and trains
  ``PARAMS_RING_CASES``; at 2 ranks trains ``params`` (the oracle's case)
  and ``resume`` (params mode two epochs without a break, then one epoch,
  a checkpoint in ``<helper_out>_ckpt`` and a resumed second epoch:
  ``resume/full/...``, ``resume/resumed/...``).
* ``helper_mode=shard``: joins the world once and trains each of
  ``SHARD_CASES`` (``zero_opt``, ``update_sharding`` and ``fsdp``, each
  beside its unsharded twin) through its rule's session on
  ``TinyLRNNetFrom``, writing the state in the unsharded layout
  (``<case>/params/<path>``, ``<case>/opt/<path>``, ``<case>/canon/<path>``,
  ``<case>/center/<path>``) and the elements this rank holds
  (``<case>/elems/params``, ``<case>/elems/opt``); ``roundtrip/<path>``: a
  tree of ``TinyWideNet``'s shapes and one ragged leaf of 10 elements,
  sharded and gathered back; at 2 ranks also ``resume/<case>/full/...``
  and ``resume/<case>/resumed/...`` (two epochs straight against one, a
  checkpoint and a resumed second, ``RESUME_CASES``), and, for each
  ``jax_<case>=<dir>`` given (``JAX_CKPT_CASES``), a checkpoint the JAX
  package wrote after one epoch loaded through
  ``convert.checkpoint_from_jax`` and trained one more epoch
  (``jax/<case>/...``).
* ``helper_mode=islands``: this rank's island of an async world
  (``AsyncEASGDTrainer``), each island stopping after
  ``helper_exchanges`` exchanges; writes this rank's params at the start
  (``init``) and each exchange's parts (``ex/<j>/...``, in the center's
  layout: the params before and after, the anchor before, ``dev_in``
  after, and on the island's rank 0 what was pulled and pushed), the
  final params and optimizer state, and the center's leaves and its
  updates by island (global rank 0, when it holds the center).
"""

import atexit
import contextlib
import json
import os
import signal
import sys
import time

import numpy as np

from theanompi_tpu_torch import convert
from theanompi_tpu_torch.worker import parse_config

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_port_helper import (TinyLRNNet, TinyLRNNetFrom,  # noqa: E402,F401
                               TinyResNet, TinyVGGNet, _FromNpz,
                               state_arrays)


class TinyVGGNetFrom(_FromNpz, TinyVGGNet):
    """:class:`TinyVGGNet` from ``config['init_npz']``."""


class SleepyNet(TinyLRNNetFrom):
    """:class:`TinyLRNNetFrom` sleeping ``iter_sleep`` seconds after each
    step: an epoch long enough to be killed in."""

    def train_iter(self, count, recorder=None):
        super().train_iter(count, recorder)
        time.sleep(float(self.config.get("iter_sleep", 0.0)))


class CrashNet(TinyLRNNet):
    """Raises at step ``crash_at`` on rank ``crash_rank`` (every rank when
    it is -1)."""

    def train_iter(self, count, recorder=None):
        if count == int(self.config.get("crash_at", 1)) and \
                int(self.config.get("crash_rank", -1)) in (-1, self.rank):
            raise RuntimeError(f"CrashNet: rank {self.rank} fails at step "
                               f"{count}")
        super().train_iter(count, recorder)


class ModulesNet(TinyLRNNet):
    """Writes, as its process exits, which of ``jax`` and the JAX package
    its process imported, to ``<modules_out>_r<rank>.json``."""

    def __init__(self, config=None):
        super().__init__(config)
        atexit.register(self._modules, str(self.config["modules_out"]),
                        self.rank)

    @staticmethod
    def _modules(out, rank):
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "theanompi_tpu"
                     or m.startswith("theanompi_tpu."))
        with open(f"{out}_r{rank}.json", "w") as f:
            json.dump({"bad": bad, "n": len(sys.modules)}, f)


# the wires held at 2 and 4 ranks: (modelclass, config); init_npz is the
# config's (allreduce) or init_vgg_npz (onebit)
WIRE_CASES = {
    "allreduce": ("TinyLRNNetFrom", dict(exch_strategy="allreduce")),
    "onebit": ("TinyVGGNetFrom", dict(exch_strategy="onebit",
                                      init_key="init_vgg_npz")),
    "topk": ("TinyVGGNet", dict(exch_strategy="topk")),
    "powersgd": ("TinyVGGNet", dict(exch_strategy="powersgd1")),
    "sync_bn": ("TinyResNet", dict(exch_strategy="allreduce")),
}


class TinyWideNet(TinyLRNNetFrom):
    """Conv(3→8, 3×3 SAME) → LRN → Pool(3/2) → FC(72 → 960, relu) →
    FC(960 → 5), float32, 75,109 params: at ``BUCKET_BYTES`` the conv's
    two leaves share a bucket and every other leaf is one of its own (5
    buckets of 6 leaves), onebit ships 3 buckets (a pack block each) and
    topk 4 (3 of its 10 chunk rows each)."""

    def build_model(self):
        from torch_port_helper import C_IN, N_CLASS, TinyData
        from theanompi_tpu_torch.models import layers as L
        self.seq = L.Sequential([
            L.Conv(C_IN, 8, 3, padding=1, w_init=("normal", 0.3),
                   b_init=("constant", 0.1), compute_dtype="float32",
                   name="conv"),
            L.LRN(k=1.0, alpha=0.5, name="lrn"),
            L.Pool(3, 2, mode="max", name="pool"),
            L.Flatten(),
            L.FC(3 * 3 * 8, 960, w_init=("normal", 0.1), activation="relu",
                 compute_dtype="float32", name="fc1"),
            L.FC(960, N_CLASS, w_init=("normal", 0.1), activation=None,
                 compute_dtype="float32", name="fc2")])
        self.data = TinyData(self.config, self.batch_size)


BUCKET_BYTES = 1024
# the JAX package's tests/test_buckets.py cases: (rule, config)
BUCKET_CASES = {
    "bsp-allreduce": ("BSP", {}),
    "bsp-nccl16": ("BSP", {"exch_strategy": "nccl16"}),
    "bsp-params": ("BSP", {"exch_mode": "params"}),
    "bsp-onebit": ("BSP", {"exch_strategy": "onebit"}),
    "bsp-topk": ("BSP", {"exch_strategy": "topk"}),
    "bsp-powersgd": ("BSP", {"exch_strategy": "powersgd1"}),
    "easgd": ("EASGD", {"sync_freq": 2}),
    "asgd": ("ASGD", {"sync_freq": 1}),
    "gosgd-perm": ("GOSGD", {"exch_prob": 0.9}),
    "gosgd-iid": ("GOSGD", {"exch_prob": 0.9, "gosgd_peers": "iid"}),
    "gosgd-shift": ("GOSGD", {"exch_prob": 0.9, "gosgd_peers": "shift"}),
    "easgd-spc4": ("EASGD", {"sync_freq": 2, "steps_per_call": 4}),
}


@contextlib.contextmanager
def count_collectives():
    """Counts of ``dist.all_reduce`` and ``dist.all_gather`` calls, and of
    the point-to-point sends and receives ``dist.batch_isend_irecv`` was
    handed, inside the block."""
    import torch.distributed as dist
    calls = {"all_reduce": 0, "all_gather": 0, "batch_isend_irecv": 0}
    saved = {k: getattr(dist, k) for k in calls}

    def counted(k):
        def fn(*a, **kw):
            calls[k] += len(a[0]) if k == "batch_isend_irecv" else 1
            return saved[k](*a, **kw)
        return fn

    for k in calls:
        setattr(dist, k, counted(k))
    try:
        yield calls
    finally:
        for k, f in saved.items():
            setattr(dist, k, f)


def _session(rule, modelclass, config, **cfg):
    import theanompi_tpu_torch as T
    r = getattr(T, rule)()
    r.init(devices=int(config["n_workers"]),
           modelfile="torch_launch_helper", modelclass=modelclass,
           **dict(config, **cfg, verbose=False, printFreq=1000))
    r.wait()
    return r


def buckets(config, out):
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess(dict(config, verbose=False))
    proc.get_internode_comm()
    res = {}
    try:
        if int(config["n_workers"]) == 4:
            res.update(sum_wires(proc.rank))
        for case, (rule, cfg) in BUCKET_CASES.items():
            for wire, bb in (("mono", 0), ("buck", BUCKET_BYTES)):
                r = _session(rule, "TinyWideNet", config, bucket_bytes=bb,
                             **cfg)
                m = r.model
                res.update({f"{case}/{wire}/{k}": v
                            for k, v in state_arrays(m).items()})
                # one more call of the step and its exchange (due: the
                # count a multiple of every case's cadence)
                k = int(m.steps_per_call)
                count = 4 * k * (1 + m.data.n_batch_train)
                with count_collectives() as calls:
                    m.train_iter(count)
                    m.exchanger.exchange(None, count)
                res[f"{case}/{wire}/calls"] = np.array(
                    [calls["all_reduce"], calls["all_gather"],
                     calls["batch_isend_irecv"]])
                if bb:
                    n = m.exchanger.n_buckets()
                    res[f"{case}/n_buckets"] = np.int64(-1 if n is None
                                                        else n)
    finally:
        proc.close()
    np.savez(f"{out}_r{proc.rank}.npz", **res)


# the summing wires, held exchange by exchange at 4 ranks
SUM_WIRES = ("allreduce", "nccl16", "powersgd1")


def sum_wires(rank: int) -> dict:
    """One exchange of each ``SUM_WIRES`` strategy, monolithic and at
    ``BUCKET_BYTES``, of the same gradient tree (``TinyWideNet``'s shapes,
    the seed ``100 + rank``)."""
    import torch
    from theanompi_tpu_torch.parallel.strategies import get_strategy
    from theanompi_tpu_torch.utils.helper_funcs import (leaf_paths,
                                                        tree_leaves,
                                                        tree_map)
    like = TinyWideNet({"device": "cpu", "verbose": False}).params
    out = {}
    for name in SUM_WIRES:
        for wire, bb in (("mono", 0), ("buck", BUCKET_BYTES)):
            r = np.random.RandomState(100 + rank)
            g = tree_map(lambda p: torch.from_numpy(
                r.randn(*p.shape).astype(np.float32)), like)
            if wire == "mono":
                out.update({f"sum/{name}/in/" + "/".join(p): v.numpy().copy()
                            for p, v in zip(leaf_paths(g), tree_leaves(g))})
            s = get_strategy(name)
            s.bucket_bytes = bb
            mean, _ = s(g, s.init_state(g), size=4)
            out.update({f"sum/{name}/{wire}/" + "/".join(p):
                        v.contiguous().numpy().copy()
                        for p, v in zip(leaf_paths(mean), tree_leaves(mean))})
    return out


RING_NAMES = ("ring", "asa32", "ring16", "copper16")
# trained at 4 ranks against the JAX package's 4 workers
PARAMS_RING_CASES = {
    "ring": {"exch_strategy": "ring"},
    "asa16": {"exch_strategy": "asa16"},
    "params": {"exch_mode": "params"},
}


def ring_grads(rank: int):
    """A gradient tree of ``TinyVGGNet``'s shapes (the port's layout) drawn
    from the seed ``100 + rank``."""
    import torch
    from theanompi_tpu_torch.utils.helper_funcs import tree_map
    like = TinyVGGNet({"device": "cpu", "verbose": False}).params
    r = np.random.RandomState(100 + rank)
    return tree_map(lambda p: torch.from_numpy(
        r.randn(*p.shape).astype(np.float32)), like)


def params_ring(config, out):
    from theanompi_tpu_torch.base import MeshProcess
    from theanompi_tpu_torch.parallel.strategies import get_strategy
    from theanompi_tpu_torch.utils.helper_funcs import (leaf_paths,
                                                        tree_leaves)
    proc = MeshProcess(dict(config, verbose=False))
    proc.get_internode_comm()
    res = {}
    try:
        world = int(config["n_workers"])
        if world == 4:
            for name in RING_NAMES:
                g = ring_grads(proc.rank)
                for p, v in zip(leaf_paths(g), tree_leaves(g)):
                    res[f"ring/{name}/in/" + "/".join(p)] = v.numpy().copy()
                mean, _ = get_strategy(name)(g, (), size=world)
                for p, v in zip(leaf_paths(mean), tree_leaves(mean)):
                    res[f"ring/{name}/out/" + "/".join(p)] = \
                        v.contiguous().numpy().copy()
            cases = PARAMS_RING_CASES
        else:
            cases = {"params": PARAMS_RING_CASES["params"]}
        for case, cfg in cases.items():
            r = _session("BSP", "TinyLRNNetFrom", config, **cfg)
            res.update({f"{case}/{k}": v
                        for k, v in state_arrays(r.model).items()})
        if world == 2:
            ck = f"{out}_ckpt"
            full = _session("BSP", "TinyLRNNetFrom", config, epochs=2,
                            exch_mode="params")
            res.update({f"resume/full/{k}": v
                        for k, v in state_arrays(full.model).items()})
            _session("BSP", "TinyLRNNetFrom", config, epochs=1,
                     exch_mode="params", ckpt_dir=ck)
            again = _session("BSP", "TinyLRNNetFrom", config, epochs=2,
                             exch_mode="params", ckpt_dir=ck, resume=True)
            res.update({f"resume/resumed/{k}": v
                        for k, v in state_arrays(again.model).items()})
    finally:
        proc.close()
    np.savez(f"{out}_r{proc.rank}.npz", **res)


# update_sharding's threshold in the shard cases: TinyLRNNet's two weights
# shard, its biases stay whole
USHARD_MIN_BYTES = 1024
_US = {"update_sharding": True, "ushard_min_bytes": USHARD_MIN_BYTES}
_MIX = {"n_subb": 2, "steps_per_call": 3, "ema_decay": 0.9,
        "grad_clip": 0.5}
# (rule, config); each sharded case's unsharded twin is SHARD_TWINS'
SHARD_CASES = {
    "plain": ("BSP", {}),
    "zero": ("BSP", {"zero_opt": True}),
    "ushard": ("BSP", dict(_US)),
    "fsdp": ("BSP", {"fsdp": True}),
    "mix": ("BSP", dict(_MIX)),
    "zero-mix": ("BSP", dict(_MIX, zero_opt=True)),
    "fsdp-mix": ("BSP", dict(_MIX, fsdp=True)),
    "easgd": ("EASGD", {"sync_freq": 2}),
    "easgd-us": ("EASGD", dict(_US, sync_freq=2)),
    "asgd": ("ASGD", {}),
    "asgd-us": ("ASGD", dict(_US)),
    "powersgd": ("BSP", {"exch_strategy": "powersgd1"}),
    "powersgd-us": ("BSP", dict(_US, exch_strategy="powersgd1")),
}
SHARD_TWINS = {"zero": "plain", "ushard": "plain", "fsdp": "plain",
               "zero-mix": "mix", "fsdp-mix": "mix", "easgd-us": "easgd",
               "asgd-us": "asgd", "powersgd-us": "powersgd"}
# resumed at 2 ranks: each key, and C8's measurement-only wire
RESUME_CASES = {"zero": {"zero_opt": True}, "ushard": dict(_US),
                "fsdp": {"fsdp": True}, "none": {"exch_strategy": "none"}}
# the JAX package's checkpoints continued in the port at 2 ranks:
# (rule, config)
JAX_CKPT_CASES = {"zero": ("bsp", {"zero_opt": True}),
                  "ushard": ("bsp", dict(_US)),
                  "fsdp": ("bsp", {"fsdp": True}),
                  "easgd-us": ("easgd", dict(_US, sync_freq=2))}


def unsharded_arrays(model) -> dict:
    """A model's state in the unsharded layout as flat npz entries
    (``params/<path>``: :meth:`live_params`; ``opt/<path>``: the momentum
    velocity; ``canon/<path>``: the canonical params, the EMA shadow or the
    center; ``center/<path>``, ``strat/<i>``) and the elements of the
    params part and the optimizer state this rank holds.  A collective
    under a sharded layout: every rank calls."""
    from theanompi_tpu_torch.utils.helper_funcs import leaf_paths, tree_leaves

    def flat(prefix, tree):
        return {f"{prefix}/" + "/".join(map(str, p)):
                np.array(v.detach().cpu().numpy()) for p, v in
                zip(leaf_paths(tree), tree_leaves(tree))}

    st = model.unsharded_opt_state()
    vel = st["inner"] if isinstance(st, dict) and "inner" in st else st
    out = dict(flat("params", model.live_params()), **flat("opt", vel),
               **flat("canon", model.canonical_params()))
    if "center" in model.extra:
        out.update(flat("center",
                        model.exchanger.unshard_extra(model.extra)["center"]))
    if "strat" in model.extra:
        out.update({f"strat/{i}": np.array(l.detach().cpu().numpy()) for i, l
                    in enumerate(tree_leaves(model.extra["strat"]))})
    out["elems/params"] = np.int64(sum(
        l.numel() for l in tree_leaves(model._state_parts()["params"])))
    out["elems/opt"] = np.int64(sum(
        l.numel() for l in tree_leaves(model.opt_state) if l.dim()))
    return out


def roundtrip(rank: int, world: int) -> dict:
    """``TinyWideNet``'s shapes and a ragged 10-element leaf, drawn from the
    seed 5: sharded at ``USHARD_MIN_BYTES`` and gathered back."""
    import torch
    from theanompi_tpu_torch.parallel import update_sharding as us
    from theanompi_tpu_torch.utils.helper_funcs import (leaf_paths,
                                                        tree_leaves,
                                                        tree_map)
    like = TinyWideNet({"device": "cpu", "verbose": False}).params
    like = dict(like, ragged={"v": torch.zeros(10)})
    r = np.random.RandomState(5)
    tree = tree_map(lambda p: torch.from_numpy(
        r.randn(*p.shape).astype(np.float32)), like)
    plan = us.plan_tree(tree, world, min_bytes=40)
    back = us.unshard_tree(us.shard_tree(tree, plan, rank), plan)
    out = {"roundtrip/" + "/".join(map(str, p)): v.numpy().copy()
           for p, v in zip(leaf_paths(back), tree_leaves(back))}
    # one flat gradient of 1000 values from the seed 100 + rank: its
    # reduce-scatter (SUM) and its all-reduce
    g = torch.from_numpy(np.random.RandomState(100 + rank).randn(
        1000).astype(np.float32))
    mine = g.new_empty(1000 // world)
    us.reduce_scatter_into(mine, g.clone())
    total = g.clone()
    import torch.distributed as dist
    dist.all_reduce(total)
    out.update({"rs/in": g.numpy(), "rs/scatter": mine.numpy(),
                "rs/allreduce": total.numpy()})
    return out


def from_jax_ckpt(config, ckpt_dir, case) -> dict:
    """A port model of ``config`` and ``JAX_CKPT_CASES[case]`` loaded from
    the JAX package's checkpoint of epoch 0 and trained epoch 1 as the
    worker trains it (the rule's exchange after each due step)."""
    from theanompi_tpu_torch import convert
    from theanompi_tpu_torch.parallel.exchanger import get_exchanger
    rule, cfg = JAX_CKPT_CASES[case]
    c = dict(config, **cfg, rule=rule, verbose=False,
             size=int(config["n_workers"]))
    m = TinyLRNNetFrom(c)
    ex = get_exchanger(rule, c)
    m.compile_iter_fns(ex)
    assert convert.checkpoint_from_jax(ckpt_dir, m, epoch=0) == 0
    n = m.data.n_batch_train
    m.adjust_hyperp(1)
    m.data.shuffle_data(1 + m.seed)
    for count in range(n + 1, 2 * n + 1):
        m.train_iter(count)
        ex.exchange(None, count)
    return unsharded_arrays(m)


def shard(config, out):
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess(dict(config, verbose=False))
    proc.get_internode_comm()
    res = {}
    try:
        world = int(config["n_workers"])
        jax_ckpts = {k[4:]: config.pop(k) for k in list(config)
                     if k.startswith("jax_")}
        res.update(roundtrip(proc.rank, world))
        for case, (rule, cfg) in SHARD_CASES.items():
            r = _session(rule, "TinyLRNNetFrom", config, **cfg)
            res.update({f"{case}/{k}": v
                        for k, v in unsharded_arrays(r.model).items()})
        if world == 2:
            for case, cfg in RESUME_CASES.items():
                ck = f"{out}_ckpt_{case}"
                full = _session("BSP", "TinyLRNNetFrom", config, epochs=2,
                                **cfg)
                _session("BSP", "TinyLRNNetFrom", config, epochs=1,
                         ckpt_dir=ck, **cfg)
                again = _session("BSP", "TinyLRNNetFrom", config, epochs=2,
                                 ckpt_dir=ck, resume=True, **cfg)
                for tag, m in (("full", full.model), ("resumed", again.model)):
                    res.update({f"resume/{case}/{tag}/{k}": v
                                for k, v in state_arrays(m).items()})
            for case, d in jax_ckpts.items():
                res.update({f"jax/{case}/{k}": v for k, v in
                            from_jax_ckpt(config, d, case).items()})
    finally:
        proc.close()
    np.savez(f"{out}_r{proc.rank}.npz", **res)


def wires(config, out):
    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess(dict(config, verbose=False))
    proc.get_internode_comm()           # every case's session reuses it
    res = {}
    try:
        for name, (cls, cfg) in WIRE_CASES.items():
            cfg = dict(cfg)
            npz = config.get(cfg.pop("init_key", "init_npz"))
            rule = BSP()
            rule.init(devices=proc.size, modelfile="torch_launch_helper",
                      modelclass=cls, **dict(config, **cfg, init_npz=npz,
                                             verbose=False, printFreq=1000))
            rule.wait()
            res.update({f"{name}/{k}": v
                        for k, v in state_arrays(rule.model).items()})
    finally:
        proc.close()
    np.savez(f"{out}_r{proc.rank}.npz", **res)


def _center_flat(model):
    return np.concatenate([x.reshape(-1) for x in convert.
                           center_leaves_from_params(
                               model.params,
                               frozenset(model.kept_layout_paths()))])


def islands(config, modelclass, out):
    from theanompi_tpu_torch.parallel import async_easgd as TA
    k = int(config.pop("helper_exchanges", 3))
    cls = globals()[modelclass]
    exchanges, init = [], []
    call0, seed0 = TA.CenterLink._call, TA.CenterLink.seed

    def seed(self, mean=False):
        init.append(_center_flat(self.model))
        return seed0(self, mean)

    def call(self, fn, *args):
        got = call0(self, fn, *args)
        ex = exchanges[-1]
        if args:
            ex["pushed"] = np.concatenate([np.array(x).reshape(-1)
                                           for x in args[0]])
        if got[0] is not None:
            ex["pulled"] = np.concatenate([np.array(x).reshape(-1)
                                           for x in got[0]])
        return got

    def exchange(base):
        def run(self):
            exchanges.append({"before": _center_flat(self.model),
                              "anchor": self.dev_in.numpy().copy()})
            parts = base(self)
            exchanges[-1].update(after=_center_flat(self.model),
                                 got=self.dev_in.numpy().copy())
            if len(exchanges) >= k:
                tr.stop_event.set()
            return parts
        return run

    TA.CenterLink._call = call
    TA.CenterLink.seed = seed
    TA.CenterLink.easgd = exchange(TA.CenterLink.easgd)
    TA.CenterLink.asgd = exchange(TA.CenterLink.asgd)
    tr = TA.AsyncEASGDTrainer(cls, dict(config, verbose=False),
                              rule=config["rule"])
    tr.start()
    runner = tr.islands[0]
    runner.join()
    held = isinstance(tr.center, TA.ElasticCenter)
    center = tr.center.pull_leaves() if held else None
    tr.stop_and_join()
    m = runner.model
    res = {}
    for j, ex in enumerate(exchanges):
        res.update({f"ex/{j}/{key}": v for key, v in ex.items()})
    res.update({k: v for k, v in state_arrays(m).items()
                if k.startswith(("params/", "opt/"))})
    if held:
        res.update({f"center/{i}": x for i, x in enumerate(center)})
        res["by_island"] = np.array(json.dumps(
            tr.center.stats_snapshot()["by_island"]))
    if init:
        res["init"] = init[0]
    res["steps"] = np.int64(runner.steps_done)
    res["island"] = np.int64(runner.island_id)
    np.savez(f"{out}_r{config['rank']}.npz", **res)


@contextlib.contextmanager
def deadline(seconds: int):
    """Raise ``TimeoutError`` in the main thread after ``seconds``: a
    launcher run in this process then stops its ranks on the way out."""
    def expire(*_):
        raise TimeoutError(f"still running after {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def launch(rule, modelclass, world, *kv, timeout_s: int = 300) -> int:
    """A world of ``world`` processes of this module, each started with the
    line the launcher composes for that rank of the worker, run by the
    launcher's ``run_world`` for at most ``timeout_s``; returns its exit
    code.  The ranks inherit this process's environment (the tests set
    ``OMP_NUM_THREADS`` and ``PYTHONPATH``)."""
    from theanompi_tpu_torch import launcher as TL
    init = f"tcp://127.0.0.1:{TL.free_port()}"
    cmds = []
    for r in range(world):
        cmd = TL.compose_worker_cmd(rule, "torch_launch_helper", modelclass,
                                    list(kv), r, world, r, init)
        cmd[cmd.index(TL.WORKER_MODULE)] = "torch_launch_helper"
        cmds.append(cmd)
    with deadline(timeout_s):
        return TL.run_world(cmds)


def main(argv):
    rule, _, modelclass = argv[:3]
    config = dict(parse_config(argv[3:]), rule=rule, device="cpu")
    mode, out = config.pop("helper_mode"), config.pop("helper_out")
    if mode == "wires":
        wires(config, out)
    elif mode == "buckets":
        buckets(config, out)
    elif mode == "params_ring":
        params_ring(config, out)
    elif mode == "shard":
        shard(config, out)
    else:
        islands(config, modelclass, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
