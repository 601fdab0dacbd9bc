"""The JAX side of the model-parallel parity tests (``test_torch_tp.py``,
``test_torch_sp.py``, ``test_torch_pipeline*.py``): the JAX package's LM on
the 8-device CPU mesh at a ``worker_mesh(dp, tp=, sp=, pp=)``, trained as
``tests/test_tp.py`` trains it, and its trees in the port's layout."""

import jax
import jax.numpy as jnp
import numpy as np

from theanompi_tpu.models.transformer_lm import TransformerLM as JLM
from theanompi_tpu.parallel import steps as jsteps
from theanompi_tpu.parallel.exchanger import BSP_Exchanger as JBSP
from theanompi_tpu.parallel.mesh import worker_mesh

import torch_mp_helper as mh
from theanompi_tpu_torch import convert
from theanompi_tpu_torch.models.transformer_lm import TransformerLM
from theanompi_tpu_torch.utils.helper_funcs import (get_leaf, jax_leaf_paths,
                                                    leaf_paths, tree_leaves)


def jax_lm(dp, tp=1, sp=1, pp=1, cls=JLM, **kw):
    cfg = {**mh.LM_CFG, "compute_dtype": jnp.float32,
           "mesh": worker_mesh(dp, tp=tp, sp=sp, pp=pp), "size": dp,
           "rank": 0, "tp": tp, "sp": sp, "pp": pp, **kw}
    cfg.pop("scale_lr")
    return cls(cfg)


def jax_train(m, n, exch=None):
    m.compile_iter_fns(exch or JBSP(m.config))
    m.data.shuffle_data(0)
    costs = []
    for i in range(n):
        m.train_iter(i, None)
        costs.append(float(m.current_info["cost"]))
    return costs


def jax_async(m, rule, n):
    """``n`` steps of an async rule, then its exchange (``tests/test_tp.py``'s
    smoke); returns the costs."""
    from theanompi_tpu.parallel.exchanger import get_exchanger
    exch = get_exchanger(rule, m.config)
    costs = jax_train(m, n, exch)
    exch.exchange(None, exch.exchange_freq)
    return costs


def host(tree):
    return jax.device_get(jsteps.unbox(jsteps.tree_to_host(tree)))


KEPT = TransformerLM(dict(mh.LM_CFG, device="cpu")).kept_layout_paths()


def port_tree(jtree):
    """A JAX params-shaped tree in the port's layout, ``/``-keyed (a pp
    tree's stacked ``blocks`` leaves kept in the JAX layout, as the port
    keeps them)."""
    jtree = jax.tree.map(np.asarray, jtree)
    kept = KEPT | {p for p in jax_leaf_paths(jtree) if p[0] == "blocks"}
    t = convert.params_from_jax(jtree, kept)
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in zip(leaf_paths(t), tree_leaves(t))}


def local_template(jm):
    """The JAX model's params as one model rank sees them (its local
    shards' shapes, JAX layout)."""
    return jsteps.local_param_template(jm.params, jm.param_specs(), jm.mesh)


def powersgd_init_npz(jm, path):
    """The JAX tp model's initial PowerSGD state (worker 0, model rank 0's
    row: every rank's is the same) and its local template, as the npz
    ``torch_mp_helper`` sets a rank's state from; returns ``path``."""
    jm.compile_iter_fns(JBSP(jm.config))
    st = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jax.device_get(jm.step_state["extra"]["strat"]))
    jl = local_template(jm)
    np.savez(path, **{f"state/{i}/{k}": v for i, s in enumerate(st)
                      for k, v in s.items()},
             **{"local/" + "/".join(p): np.zeros(np.shape(
                 get_leaf(jl, p)), np.float32) for p in jax_leaf_paths(jl)})
    return path


def port_ef(strategy, jstate, jlocal, like):
    """One rank's block of a JAX strategy state (``[tp·n]`` flat, or each
    PowerSGD array's ``[tp, ...]`` row taken already) in the port's layout,
    flattened as ``torch_mp_helper`` flattens the port's: onebit's flat
    vector reordered to the port's leaf order, topk's kept in the JAX
    order, PowerSGD's per-leaf ``q`` and ``e`` converted."""
    if strategy == "onebit":
        return convert.flat_from_jax(jstate, jlocal, like, KEPT)
    if strategy == "topk":
        return np.asarray(jstate)
    st = convert.powersgd_state_from_jax(jstate, jlocal, like, KEPT)
    return np.concatenate([np.asarray(a).reshape(-1) for d in st
                           for a in (d["q"], d["e"])])


def part(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def jax_val(m):
    m.begin_val()
    dev = jsteps.put_batch(m.mesh, m.data.next_val_batch(0))
    cost, err, err5 = m.val_fn(m._val_params_boxed, m._val_bn_boxed, dev)
    return [float(np.mean(np.asarray(a))) for a in (cost, err, err5)]


def dense_tokens(flat_params, prompt, n=4, cls=TransformerLM, **cfg):
    """The port's dense LM's (``cls``, the dense LM by default) greedy
    tokens from ``/``-keyed global params (what a model-parallel layout
    must sample)."""
    dense = cls(dict(mh.LM_CFG, device="cpu", **cfg))
    params = {}
    for p in leaf_paths(dense.params):
        node = params
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = flat_params["/".join(map(str, p))]
    return dense.generate(prompt, n, params=params)
