"""Per-rank entries of the elastic tests (``tests/test_torch_mesh_
membership.py``, ``tests/test_torch_refit.py``): one process a rank of a
gloo world, started by ``torch_port_helper.run_ranks(..., script=
'torch_elastic_helper.py')``.  Imports only ``theanompi_tpu_torch`` and
``torch_port_helper`` (no JAX).  :class:`FailingNet` is the async
checkpoint tests' model (``tests/test_torch_async_ckpt.py``).

    python tests/torch_elastic_helper.py mesh <rank> <world> <init_method> \
        <out> <init_npz>

joins one group of ``world`` ranks and, for each of ``MESH_CASES``, builds
``TinyLRNNetFrom`` (the JAX twin's weights from ``<init_npz>``) under the
case's rule, with a ``MembershipController`` driving a ``MeshReactor``
(every rank the same sequence): ``STEPS`` steps from the shuffle of seed
0, each followed by the exchange hook; after step 2 the controller demotes
``demoted(case, world)``, after step 4 it readmits them.  It writes each
case's state (``<case>/<when>/<key>``, keys as
``torch_port_helper.state_arrays`` makes them, plus ``center/<i>``, the
full center) at ``when`` = ``x3pre`` / ``x3post`` (around step 3's
exchange, while demoted), ``x5pre`` / ``x5post`` (around step 5's, after
the readmission) and ``end``; under the fused cadence (``steps_per_call``
2) only ``end``.  The ``easgd`` case runs the numerics plane at every step
and writes step 3's per-worker digest and beacon flag (``easgd/beacon``,
``[world, 2]``).

    python tests/torch_elastic_helper.py refit <rank> <world> \
        <init_method> <out> <ckpt_root> [jax_<case>=<dir> ...]

checkpoints of one world resumed on another, in one launch of 4 ranks:
each of ``REFIT_CASES`` trained ``REFIT_STEPS`` steps and saved by all 4
ranks (``<ckpt_root>/w4/<case>``) and by ranks 0 and 1 alone
(``.../w2/<case>``); then ranks 0 and 1 load each 4-rank file and all 4
ranks load each 2-rank file, and train 2 more steps.  Writes each
phase's state in the unsharded layout (``<phase>/<case>/<key>``, keys as
``torch_launch_helper.unsharded_arrays`` makes them, ``opt`` the inner
state's first moment) and the costs of the steps after a load; a load
that must be refused writes its message (``<phase>/<case>/refused``).
With ``jax_<case>=<dir>`` (a JAX checkpoint written at 4 workers under
``JAX_CASES[case]``), ranks 0 and 1 load it through
``convert.checkpoint_from_jax`` too (``jax/<case>/...``, or
``jax/<case>/refused``).
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_port_helper import TinyLRNNetFrom, state_arrays  # noqa: E402

STEPS = 6
BATCH = 4


class FailingNet(TinyLRNNetFrom):
    """:class:`TinyLRNNetFrom` whose first step of its second epoch raises
    (the async checkpoint tests' unwinding worker)."""

    def train_iter(self, count, recorder=None):
        if count > self.data.n_batch_train:
            raise RuntimeError("a step failed")
        super().train_iter(count, recorder)
# (rule, config) of each masked-membership case
MESH_CASES = {
    "easgd": ("easgd", {"sync_freq": 1, "alpha": 0.5, "numerics": True,
                        "numerics_every": 1}),
    "easgd-buck": ("easgd", {"sync_freq": 1, "alpha": 0.5,
                             "bucket_bytes": 256}),
    "easgd-us": ("easgd", {"sync_freq": 1, "alpha": 0.5,
                           "update_sharding": True, "ushard_min_bytes": 64}),
    "easgd-fused": ("easgd", {"sync_freq": 1, "alpha": 0.5,
                              "steps_per_call": 2}),
    "asgd": ("asgd", {"sync_freq": 1}),
    "asgd-buck": ("asgd", {"sync_freq": 1, "bucket_bytes": 256}),
    "gosgd": ("gosgd", {"exch_prob": 1.0}),
    "gosgd-buck": ("gosgd", {"exch_prob": 1.0, "bucket_bytes": 256}),
    "gosgd-iid": ("gosgd", {"exch_prob": 1.0, "gosgd_peers": "iid"}),
    "gosgd-shift": ("gosgd", {"exch_prob": 1.0, "gosgd_peers": "shift"}),
    "gosgd-fused": ("gosgd", {"exch_prob": 1.0, "steps_per_call": 2}),
    "gosgd-one": ("gosgd", {"exch_prob": 1.0}),
}
# the cases a 2-rank world runs: the monolithic and bucketed wires
MESH_CASES_2 = ("easgd", "easgd-buck", "asgd", "asgd-buck", "gosgd",
                "gosgd-buck")


def demoted(case: str, world: int) -> list:
    """The ranks demoted after step 2: rank 2 of 4 (rank 1 of 2); under
    ``gosgd-one`` every rank but 1."""
    if case == "gosgd-one":
        return [r for r in range(world) if r != 1]
    return [2 if world == 4 else 1]


def _snapshot(model, ex) -> dict:
    out = state_arrays(model)
    if "center" in model.extra:
        from theanompi_tpu_torch.utils.helper_funcs import tree_leaves
        out.update({f"center/{i}": l.detach().cpu().numpy().copy()
                    for i, l in enumerate(tree_leaves(ex.canonical_params()))})
    return out


def _group(rank, world, init_method):
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess({"device": "cpu", "rank": int(rank),
                        "n_workers": int(world), "init_method": init_method,
                        "verbose": False})
    proc.get_internode_comm()
    return proc


def mesh_case(proc, case: str, init_npz: str) -> dict:
    from theanompi_tpu_torch.parallel import membership as mb
    from theanompi_tpu_torch.parallel.exchanger import get_exchanger
    rule, cfg = MESH_CASES[case]
    c = dict(proc.config, batch_size=BATCH, init_npz=init_npz, rule=rule,
             **cfg)
    m = TinyLRNNetFrom(c)
    ex = get_exchanger(rule, m.config)
    m.compile_iter_fns(ex)
    ctl = mb.MembershipController(reactors=[mb.MeshReactor(ex, m)])
    for w in range(proc.size):
        ctl.join(w)
    m.data.shuffle_data(0)
    spc = int(m.steps_per_call)
    res = {}

    def snap(when):
        res.update({f"{case}/{when}/{k}": v
                    for k, v in _snapshot(m, ex).items()})

    for count in range(spc, STEPS + 1, spc):
        m.train_iter(count)
        if spc == 1 and count in (3, 5):
            snap(f"x{count}pre")
        ex.exchange(None, count)
        if spc == 1 and count in (3, 5):
            snap(f"x{count}post")
        if count == 3 and m.numerics_aux is not None:
            aux = m.numerics_aux
            res[f"{case}/beacon"] = np.array(
                [[float(d), float(b)] for d, b in zip(aux["digest"],
                                                      aux["beacon"])])
        if count == 2:
            for d in demoted(case, proc.size):
                ctl.demote(d)
        elif count == 4:
            for d in demoted(case, proc.size):
                ctl.readmit(d)
    snap("end")
    res[f"{case}/active_end"] = np.int64(-1 if ex.active_key() is None
                                         else len(ex.active_key()))
    return res


def mesh(rank, world, init_method, out, init_npz):
    proc = _group(rank, world, init_method)
    res = {}
    try:
        cases = MESH_CASES if proc.size == 4 else MESH_CASES_2
        for case in cases:
            res.update(mesh_case(proc, case, init_npz))
    finally:
        proc.close()
    np.savez(f"{out}_r{rank}.npz", **res)


REFIT_STEPS = 3
# (rule, config, refused) of each checkpoint saved on one world and loaded
# on another; a refused case's load must raise
REFIT_CASES = {
    "bsp": ("bsp", {}, False),
    "zero": ("bsp", {"zero_opt": True, "optimizer": "adam",
                     "learning_rate": 0.01}, False),
    "fsdp": ("bsp", {"fsdp": True, "optimizer": "adam",
                     "learning_rate": 0.01}, False),
    "topk": ("bsp", {"exch_strategy": "topk"}, True),
    "gosgd": ("gosgd", {"exch_prob": 0.5}, True),
}

# (rule, config) of the JAX checkpoints of 4 workers the 2-rank world
# converts; EASGD's per-worker replicas must be refused
JAX_CASES = {"zero": ("bsp", {"zero_opt": True}),
             "fsdp": ("bsp", {"fsdp": True}),
             "easgd": ("easgd", {"sync_freq": 2})}


def _model(proc, rule, cfg, modelclass=TinyLRNNetFrom, **more):
    from theanompi_tpu_torch.parallel.exchanger import get_exchanger
    c = dict(proc.config, batch_size=BATCH, rule=rule, **cfg, **more)
    m = modelclass(c)
    ex = get_exchanger(rule, m.config)
    m.compile_iter_fns(ex)
    return m, ex


def _train(m, ex, first, n):
    costs = []
    for count in range(first, first + n):
        m.train_iter(count)
        ex.exchange(None, count)
        costs.append(float(m.current_info["cost"]))
    return np.float32(costs)


def _arrays(m, prefix) -> dict:
    from torch_launch_helper import unsharded_arrays
    return {f"{prefix}/{k}": v for k, v in unsharded_arrays(m).items()}


def _phase(rank, world, init_method, name):
    """This rank's group of the phase ``name`` (a store of its own) on the
    first ``world`` ranks; None on the others."""
    if int(rank) >= world:
        return None
    return _group(rank, world, f"{init_method}_{name}")


def refit(rank, world, init_method, out, ckpt_root, *jax_dirs):
    from theanompi_tpu_torch import convert
    res = {}
    for w in (4, 2):
        proc = _phase(rank, w, init_method, f"save{w}")
        if proc is None:
            continue
        try:
            for case, (rule, cfg, _) in REFIT_CASES.items():
                m, ex = _model(proc, rule, cfg)
                m.data.shuffle_data(0)
                _train(m, ex, 1, REFIT_STEPS)
                m.save(os.path.join(ckpt_root, f"w{w}", case), epoch=0,
                       count=REFIT_STEPS)
                res.update(_arrays(m, f"save{w}/{case}"))
        finally:
            proc.close()
    for src, w in ((4, 2), (2, 4)):
        name = f"load{src}to{w}"
        proc = _phase(rank, w, init_method, name)
        if proc is None:
            continue
        try:
            for case, (rule, cfg, refused) in REFIT_CASES.items():
                m, ex = _model(proc, rule, cfg)
                d = os.path.join(ckpt_root, f"w{src}", case)
                if refused:
                    try:
                        m.load(d)
                    except ValueError as e:
                        res[f"{name}/{case}/refused"] = str(e)
                    continue
                res[f"{name}/{case}/epoch"] = np.int64(m.load(d))
                res.update(_arrays(m, f"{name}/{case}"))
                res[f"{name}/{case}/costs"] = _train(m, ex, REFIT_STEPS + 1,
                                                     2)
                res.update(_arrays(m, f"{name}/{case}/after"))
            if w == 2:
                # another model config: refused by name
                from torch_port_helper import TinyVGGNet
                for case in ("zero", "fsdp"):
                    m, _ = _model(proc, "bsp", REFIT_CASES[case][1],
                                  TinyVGGNet)
                    try:
                        m.load(os.path.join(ckpt_root, "w4", case))
                    except ValueError as e:
                        res[f"{name}/{case}-other/refused"] = str(e)
                # a JAX checkpoint of 4 workers
                for arg in jax_dirs:
                    case, _, d = arg[len("jax_"):].partition("=")
                    rule, cfg = JAX_CASES[case]
                    m, _ = _model(proc, rule, cfg)
                    try:
                        res[f"jax/{case}/epoch"] = np.int64(
                            convert.checkpoint_from_jax(d, m))
                    except ValueError as e:
                        res[f"jax/{case}/refused"] = str(e)
                        continue
                    res.update(_arrays(m, f"jax/{case}"))
        finally:
            proc.close()
    np.savez(f"{out}_r{rank}.npz", **res)


def main(argv):
    torch.set_num_threads(1)
    {"mesh": mesh, "refit": refit}[argv[0]](*argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
