"""Model-parallel worlds of the port on CPU gloo: one process a rank.

``python torch_mp_helper.py <mode> <world_rank> <world> <init> <out>
<args_json>`` runs one rank of ``mode`` (``tp``, ``sp``, ``ring``) through
its phases, each a session of its own (a ``base.MeshProcess`` over the
grid its config names, on a store file of its own), and writes
``<out>_r<world_rank>.npz``.  :func:`spawn` starts the world and
:func:`collect` waits for it, so a test can run the JAX side meanwhile.
Every rank runs on one CPU thread (``torch_port_helper.RANK_ENV``).

The LM is :class:`MPLM`, the port's ``TransformerLM`` whose initial params
are the global tree in ``config['init_npz']`` (port layout, leaves keyed by
their ``/``-joined paths: the JAX model's weights, converted), stacked
under ``pp`` and cut to this rank's shards; :class:`MPMoELM` is the MoE
LM's counterpart.  ``pp`` mode runs the pipeline worlds' phases
(``test_torch_pipeline*.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from theanompi_tpu_torch.models.model_base import ModelBase
from theanompi_tpu_torch.models.transformer_lm import (MoETransformerLM,
                                                       TransformerLM)
from theanompi_tpu_torch.utils.helper_funcs import (leaf_paths, tree_leaves,
                                                    tree_map)

HERE = os.path.dirname(os.path.abspath(__file__))

# the LM of the JAX package's tests/test_tp.py and test_sp_lm.py
LM_CFG = dict(verbose=False, batch_size=8, seq_len=16, vocab=32,
              synthetic_train=64, synthetic_val=32, d_model=32, n_head=4,
              n_layer=2, compute_dtype="float32", scale_lr=False)


class _FromNpz:
    """Initial params from ``config['init_npz']``'s global ones, sharded."""

    def init_params(self, gen):
        path = self.config.get("init_npz")
        if not path:
            return super().init_params(gen)
        dense = ModelBase.init_params(self, gen)
        with np.load(path) as z:
            it = iter([torch.from_numpy(z["/".join(map(str, p))])
                       for p in leaf_paths(dense)])
        return self.shard_params(self._stacked(tree_map(lambda _: next(it),
                                                        dense)))


class MPLM(_FromNpz, TransformerLM):
    """The LM from ``config['init_npz']``'s global params, sharded."""


class MPMoELM(_FromNpz, MoETransformerLM):
    """The MoE LM from ``config['init_npz']``'s global params, sharded."""


def save_init(params, path):
    """A port-layout global params tree to ``path`` (``MPLM``'s input)."""
    np.savez(path, **{"/".join(map(str, p)): np.asarray(v, np.float32)
                      for p, v in zip(leaf_paths(params),
                                      tree_leaves(params))})
    return path


def nest(flat_tree):
    """A ``/``-keyed dict as the nested tree it was flattened from."""
    out = {}
    for k, v in flat_tree.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def powersgd_state(path, model):
    """The JAX package's PowerSGD state saved by
    ``torch_mp_jax.powersgd_init_npz`` (its list of ``{"q", "e"}`` over its
    local template), converted to ``model``'s local shards."""
    from theanompi_tpu_torch import convert
    with np.load(path) as z:
        st, local = {}, {}
        for k in z.files:
            kind, rest = k.split("/", 1)
            if kind == "state":
                i, name = rest.split("/")
                st.setdefault(int(i), {})[name] = z[k]
            else:
                local[rest] = z[k]
    return convert.powersgd_state_from_jax(
        [st[i] for i in range(len(st))], nest(local), model.params,
        model.kept_layout_paths())


def flat(prefix, tree):
    """``{prefix/path: array}`` copies (a CPU tensor's ``.numpy()`` shares
    the storage the next step rewrites)."""
    return {f"{prefix}/" + "/".join(map(str, p)): np.array(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        for p, v in zip(leaf_paths(tree), tree_leaves(tree))}


class Session:
    """One phase's process group and model: ``with Session(...) as (proc,
    model)``."""

    def __init__(self, cfg, rank, init, phase, modelclass=MPLM):
        from theanompi_tpu_torch.base import MeshProcess
        self.proc = MeshProcess(dict(cfg, device="cpu", rank=rank,
                                     init_method=f"{init}_{phase}"))
        self.modelclass = modelclass

    def __enter__(self):
        self.proc.get_internode_comm()
        return self.proc, self.modelclass(self.proc.config)

    def __exit__(self, *exc):
        self.proc.close()


def train(model, rule="bsp", n_steps=6, spc=1, after=None, strat=None):
    """``n_steps`` steps as the JAX package's tests take them (the data
    shuffled with seed 0, ``train_iter(count)`` counting from 0); returns
    the costs.  ``after(i, model)`` runs after call i; ``strat`` (a list of
    ``{"q", "e"}`` arrays) is written over the PowerSGD state first."""
    from theanompi_tpu_torch.parallel.exchanger import get_exchanger
    model.compile_iter_fns(get_exchanger(rule, model.config))
    if strat is not None:
        for have, want in zip(model.extra["strat"], strat):
            for k, v in want.items():
                have[k].copy_(torch.from_numpy(np.asarray(v)))
    model.data.shuffle_data(0)
    costs = []
    for i in range(n_steps // spc):
        model.train_iter(i * spc + spc - 1)
        costs.append(float(model.current_info["cost"]))
        if after is not None:
            after(i, model)
    return costs


def gathered(model, tree=None):
    """The global params (a collective over the model group)."""
    return model.gather_params(tree_map(
        lambda p: p.detach(), model.params if tree is None else tree))


def val_first_batch(model):
    model.data.shuffle_data(0)
    model.begin_val()
    batch = model._take(model.data.next_val_batch(0))
    out = [float(v) for v in model.val_fn(batch)]
    model.end_val()
    return out


# -- modes ------------------------------------------------------------------

def _mp_phases(rank, init, args, res):
    """The tp or sp world's phases (``args['grid']``: tp, sp, n_workers)."""
    cfg = dict(LM_CFG, **args["grid"], init_npz=args["init_npz"])
    with Session(cfg, rank, init, "bsp") as (proc, m):
        res.update(flat("init", gathered(m)))
        res.update(flat("shard", m.params))
        at2 = {}
        res["bsp_costs"] = train(
            m, after=lambda i, mm: at2.update(flat("bsp_step2", gathered(mm)))
            if i == 1 else None)
        res.update(at2)
        res.update(flat("bsp", gathered(m)))
        res["val"] = val_first_batch(m)
        if args.get("head"):
            res.update(_head(m.grid, args["head"]))
        res["gen"] = m.generate(args["prompt"], 4)
        res["gen_kv0"] = m.generate(args["prompt"], 4, kv_cache=False)
    with Session(dict(cfg, n_subb=2), rank, init, "subb") as (proc, m):
        res["subb_costs"] = train(m, n_steps=4)
    with Session(dict(cfg, steps_per_call=2), rank, init, "spc") as (proc, m):
        train(m, n_steps=2, spc=2)
        res.update(flat("spc", gathered(m)))
    for rule, kw in args.get("rules", {}).items():
        with Session(dict(cfg, **kw), rank, init, rule) as (proc, m):
            res[f"{rule}_costs"] = train(m, rule=rule, n_steps=4)
            m.exchanger.exchange(None, m.exchanger.exchange_freq)
            res[f"{rule}_val"] = val_first_batch(m)
    for strat in args.get("strategies", ()):
        with Session(dict(cfg, exch_strategy=strat), rank, init,
                     strat) as (proc, m):
            init_st = args.get("strat_init", {}).get(strat)
            res[f"{strat}_costs"] = train(
                m, n_steps=8,
                strat=init_st and powersgd_state(init_st, m))
            res.update(flat(strat, gathered(m)))
            res[f"{strat}_ef"] = _ef(m)
            if args.get("ckpt_dir"):
                m.save(os.path.join(args["ckpt_dir"], strat), epoch=0,
                       count=8)
        if args.get("ckpt_dir"):
            # the per-shard state saved as global arrays and resumed
            with Session(dict(cfg, exch_strategy=strat), rank, init,
                         strat + "_load") as (proc, m):
                from theanompi_tpu_torch.parallel.exchanger import \
                    BSP_Exchanger
                m.compile_iter_fns(BSP_Exchanger(m.config))
                m.load(os.path.join(args["ckpt_dir"], strat))
                res.update(flat(strat + "_loaded", gathered(m)))
                res[f"{strat}_loaded_ef"] = _ef(m)
    if args.get("ckpt_dir"):
        d = args["ckpt_dir"]
        with Session(cfg, rank, init, "save") as (proc, m):
            train(m, n_steps=3)
            m.save(d, epoch=0, count=3)
            res.update(flat("saved", gathered(m)))
            res.update(flat("saved_m", gathered(m, m.opt_state["m"])))
        with Session(cfg, rank, init, "load") as (proc, m):
            from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
            m.compile_iter_fns(BSP_Exchanger(m.config))
            res["loaded_epoch"] = m.load(d)
            res.update(flat("loaded", gathered(m)))
            res.update(flat("loaded_m", gathered(m, m.opt_state["m"])))
            m.data.shuffle_data(0)
            m.train_iter(3)
            res["resumed_cost"] = float(m.current_info["cost"])
    for name, extra in args.get("cross_load", {}).items():
        # the checkpoint resumed on another grid of the same processes
        with Session(dict(cfg, **extra), rank, init, name) as (proc, m):
            from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
            m.compile_iter_fns(BSP_Exchanger(m.config))
            res[f"{name}_epoch"] = m.load(args["ckpt_dir"])
            res.update(flat(name, gathered(m)))
            res.update(flat(name + "_m", gathered(m, m.opt_state["m"])))
            m.data.shuffle_data(0)
            m.train_iter(3)
            res[f"{name}_cost"] = float(m.current_info["cost"])
    if args.get("jax_ckpt"):
        with Session(cfg, rank, init, "jaxckpt") as (proc, m):
            from theanompi_tpu_torch import convert
            from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
            m.compile_iter_fns(BSP_Exchanger(m.config))
            res["jax_epoch"] = convert.checkpoint_from_jax(args["jax_ckpt"],
                                                          m)
            res.update(flat("jax_loaded", gathered(m)))
            res.update(flat("jax_loaded_m", gathered(m, m.opt_state["m"])))
            m.data.shuffle_data(0)
            m.train_iter(3)
            res["jax_resumed_cost"] = float(m.current_info["cost"])
    for name, extra in args.get("worlds", {}).items():
        # another grid over the same processes (e.g. tp × sp at dp 1),
        # trained, validated, sampled, saved and loaded in a new session
        wcfg = dict(cfg, **extra)
        with Session(wcfg, rank, init, name) as (proc, m):
            res[f"{name}_costs"] = train(m)
            res.update(flat(name, gathered(m)))
            res[f"{name}_val"] = val_first_batch(m)
            res[f"{name}_gen"] = m.generate(args["prompt"], 4)
            if args.get("ckpt_dir"):
                m.save(os.path.join(args["ckpt_dir"], name), epoch=0,
                       count=6)
        if args.get("ckpt_dir"):
            with Session(wcfg, rank, init, name + "_load") as (proc, m):
                from theanompi_tpu_torch.parallel.exchanger import \
                    BSP_Exchanger
                m.compile_iter_fns(BSP_Exchanger(m.config))
                m.load(os.path.join(args["ckpt_dir"], name))
                res.update(flat(name + "_loaded", gathered(m)))


def dense_of(model, tree=None):
    """The global params (or a params-shaped ``tree``) in the dense layout:
    gathered, the pp stack unstacked (a collective)."""
    return model._unstacked(gathered(model, tree))


def _pp_phases(rank, init, args, res):
    """The pipeline worlds' phases: ``args['phases']`` maps a name to a
    phase, a session of its own of ``args['cfg']`` updated by the phase's
    ``cfg``, on the first ``world`` ranks only where it names one.  A phase
    trains ``steps`` steps (``spc`` a call, under ``rule``), or loads a
    checkpoint first (``load``: the port's; ``jax_load``: the JAX
    package's, through ``convert``) and trains ``steps`` more from count
    ``at``; it records its costs, its global params (``<name>/...``) and
    in the dense layout (``<name>_dense/...``), and where asked its
    initial params, the params after step 2 (``step2``), validation,
    greedy tokens, the Adam moments (ZeRO-1's joined), the sizes of the
    optimizer state's tensors, the canonical params (``canon``: the EMA
    shadow), the wire's state, and saves (``save``).  A ``refused`` phase
    records the message of the ``compile_iter_fns`` it must refuse."""
    from theanompi_tpu_torch import convert
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    base = dict(LM_CFG, init_npz=args["init_npz"], **args.get("cfg", {}))
    for name, ph in args["phases"].items():
        if rank >= ph.get("world", rank + 1):
            continue
        cls = MPMoELM if ph.get("moe") else MPLM
        with Session(dict(base, **ph.get("cfg", {})), rank, init, name,
                     cls) as (proc, m):
            if ph.get("init"):
                res.update(flat(f"{name}_init", dense_of(m)))
                res.update(flat(f"{name}_shard", m.params))
            if ph.get("refused"):
                # a layout the compile must refuse: its message
                try:
                    m.compile_iter_fns(BSP_Exchanger(m.config))
                except ValueError as e:
                    res[f"{name}_refused"] = str(e)
                continue
            src = ph.get("load") or ph.get("jax_load")
            if src:
                m.compile_iter_fns(BSP_Exchanger(m.config))
                res[f"{name}_epoch"] = convert.checkpoint_from_jax(src, m) \
                    if ph.get("jax_load") else m.load(src)
                res.update(flat(f"{name}_loaded", gathered(m)))
                _record_m(res, f"{name}_loaded_m", m)
                if ph.get("ef"):
                    res[f"{name}_loaded_ef"] = _ef(m)
                costs = []            # the data cursor is the checkpoint's
                for i in range(ph["at"], ph["at"] + ph.get("steps", 1)):
                    m.train_iter(i)
                    costs.append(float(m.current_info["cost"]))
                res[f"{name}_costs"] = costs
            else:
                at2 = {}

                def after(i, mm):
                    if i == 1 and ph.get("step2"):
                        at2.update(flat(f"{name}_step2", dense_of(mm)))

                res[f"{name}_costs"] = train(
                    m, rule=ph.get("rule", "bsp"), n_steps=ph.get("steps", 6),
                    spc=ph.get("spc", 1), after=after)
                res.update(at2)
            res.update(flat(name, gathered(m)))
            res.update(flat(f"{name}_dense", dense_of(m)))
            _record_m(res, f"{name}_m", m)
            res[f"{name}_opt_sizes"] = np.array(
                [int(t.numel()) for t in tree_leaves(m.opt_state)
                 if isinstance(t, torch.Tensor) and t.dim()])
            if ph.get("canon"):
                res.update(flat(f"{name}_canon", m.canonical_host_params()))
            if ph.get("ef"):
                res[f"{name}_ef"] = _ef(m)
            if ph.get("val"):
                res[f"{name}_val"] = val_first_batch(m)
            if ph.get("gen"):
                res[f"{name}_gen"] = m.generate(args["prompt"], 4)
                res[f"{name}_gen_kv0"] = m.generate(args["prompt"], 4,
                                                    kv_cache=False)
            if ph.get("save"):
                m.save(ph["save"], epoch=0, count=ph.get("steps", 6))
            if m.grid is not None:
                res[f"{name}_coord"] = [m.grid.worker, m.grid.pipe,
                                        m.grid.model, m.grid.seq]


def _record_m(res, key, model):
    """Adam's first moment (an EMA's inner one), gathered into the global
    params layout (ZeRO-1's chunks joined first), as ``key/...``; nothing
    for another optimizer."""
    st = model.unsharded_opt_state()
    st = st.get("inner", st)
    if "m" in st:
        res.update(flat(key, gathered(model, st["m"])))


def _ef(model):
    """The strategy state's arrays flattened end to end."""
    return np.concatenate([t.reshape(-1).numpy()
                           for t in tree_leaves(model.extra["strat"])
                           if isinstance(t, torch.Tensor)])


def _head(grid, path):
    """The vocab-parallel loss and error heads on this model rank's shard
    of fixed logits: each cost and the gradient of the loss (plain, and
    with label smoothing 0.1)."""
    from theanompi_tpu_torch.parallel import tp as tplib
    with np.load(path) as z:
        logits, labels = z["logits"], torch.from_numpy(z["labels"])
    v_loc = logits.shape[1] // grid.tp
    loc = logits[:, grid.model * v_loc:(grid.model + 1) * v_loc]
    out = {}
    for tag, eps in (("head", 0.0), ("head_ls", 0.1)):
        x = torch.from_numpy(np.ascontiguousarray(loc)).requires_grad_(True)
        cost = tplib.tp_softmax_cross_entropy(x, labels, grid.model_group,
                                              grid.model, eps)
        cost.backward()
        out[f"{tag}_cost"] = float(cost)
        out[f"{tag}_grad"] = x.grad.numpy()
    x = torch.from_numpy(np.ascontiguousarray(loc))
    out["head_err"] = float(tplib.tp_errors(x, labels, grid.model_group,
                                            grid.model))
    out["head_err5"] = float(tplib.tp_errors_top_x(
        x, labels, grid.model_group, grid.model, 5))
    return out


def _ring(rank, init, args, res):
    """Ring attention alone over the seq groups of each grid in
    ``args['grids']`` (``{tag: grid config}``): forward and the gradients
    of ``sum(out · w)`` of this rank's block, causal and not."""
    from theanompi_tpu_torch.base import MeshProcess
    from theanompi_tpu_torch.ops.ring_attention import ring_attention
    with np.load(args["inputs"]) as z:
        q, k, v, w = (torch.from_numpy(z[n]) for n in "qkvw")
    for tag, grid in args["grids"].items():
        proc = MeshProcess(dict(grid, device="cpu", rank=rank,
                                init_method=f"{init}_{tag}", verbose=False))
        proc.get_internode_comm()
        try:
            g = proc.grid
            t = q.shape[2] // g.sp
            blk = slice(g.seq * t, (g.seq + 1) * t)
            for causal in (False, True):
                ts = [a[:, :, blk].clone().requires_grad_(True)
                      for a in (q, k, v)]
                out = ring_attention(*ts, group=g.seq_group, causal=causal)
                (out * w[:, :, blk]).sum().backward()
                key = f"{tag}_{'causal' if causal else 'full'}"
                res[f"{key}_out"] = out.detach().numpy()
                for n, a in zip("qkv", ts):
                    res[f"{key}_d{n}"] = a.grad.numpy()
            res[f"{tag}_seq"] = g.seq
        finally:
            proc.close()


def _moe_layer(rank, init, args, res):
    """The MoE layer alone on 2 ranks, for each case of ``args['cases']``
    (``{tag: {"axis": "model" or "seq", "top_k", "cf", "train"}}``):
    experts over the model group (``ep`` 2) or over the seq group (the
    all-to-all, ``seq_shards`` 2, each rank a half of the tokens).  Saves
    ``y``, ``aux`` and the gradients of ``sum(y · ct) + aux`` for this
    rank's x (its block under seq) and leaves (its experts)."""
    from theanompi_tpu_torch.base import MeshProcess
    from theanompi_tpu_torch.parallel.moe import MoE
    with np.load(args["inputs"]) as z:
        inp = {k: z[k] for k in z.files}
    d, E = inp["wg"].shape
    for axis in ("model", "seq"):
        cases = {t: c for t, c in args["cases"].items() if c["axis"] == axis}
        grid = dict(n_workers=1, tp=2) if axis == "model" else \
            dict(n_workers=1, sp=2)
        proc = MeshProcess(dict(grid, device="cpu", rank=rank,
                                init_method=f"{init}_moe_{axis}",
                                verbose=False))
        proc.get_internode_comm()
        try:
            g = proc.grid
            i = getattr(g, axis)
            kw = dict(ep=2, rank=i, group=g.model_group) if axis == "model" \
                else dict(seq_shards=2, seq_group=g.seq_group)
            for tag, c in cases.items():
                moe = MoE(d, E, mlp_ratio=2, top_k=c["top_k"],
                          capacity_factor=c["cf"], compute_dtype="float32",
                          **kw)
                e = E // 2
                p = {k: torch.from_numpy(np.ascontiguousarray(
                    inp[k] if k == "wg" else inp[k][i * e:(i + 1) * e]))
                    .requires_grad_(True) for k in MoE.kept_layout}
                rows = slice(None) if axis == "model" else slice(
                    i * len(inp["x"]) // 2, (i + 1) * len(inp["x"]) // 2)
                x = torch.from_numpy(np.ascontiguousarray(
                    inp["x"][rows])).requires_grad_(True)
                y, aux = moe.apply(p, x, train=c["train"])
                (torch.sum(y * torch.from_numpy(inp["ct"][rows]))
                 + aux).backward()
                res[f"{tag}_y"] = y.detach().numpy()
                res[f"{tag}_aux"] = float(aux)
                res[f"{tag}_gx"] = x.grad.numpy()
                for k, v in p.items():
                    res[f"{tag}_g{k}"] = v.grad.numpy()
        finally:
            proc.close()


def main(argv):
    torch.set_num_threads(1)
    mode, rank, _world, init, out, args = argv
    args = json.loads(args)
    res = {}
    {"mp": _mp_phases, "ring": _ring, "pp": _pp_phases,
     "moe_layer": _moe_layer}[mode](
        int(rank), init, args, res)
    np.savez(f"{out}_r{rank}.npz", **res)
    return 0


def spawn(mode, world, tmp_path, tag, args):
    """Start ``world`` ranks of ``mode``; returns what :func:`collect`
    takes."""
    sys.path.insert(0, HERE)
    from torch_port_helper import RANK_ENV
    init = "file://" + os.path.join(str(tmp_path), f"store_{tag}")
    out = os.path.join(str(tmp_path), f"out_{tag}")
    env = dict(os.environ, **RANK_ENV, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mp_helper.py"), mode,
         str(r), str(world), init, out, json.dumps(args)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs, out


def collect(spawned, timeout=300):
    """Each rank's output dict, in world-rank order (asserts every rank
    exited 0, with its log)."""
    procs, out = spawned
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = []
    for r in range(len(procs)):
        with np.load(f"{out}_r{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
