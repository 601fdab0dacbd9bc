"""JAX parameter trees → the port's.

The JAX package keeps conv weights HWIO ``[kh, kw, in/groups, out]`` and FC
weights ``[in, out]``; the port keeps PyTorch's OIHW
``[out, in/groups, kh, kw]`` and ``[out, in]``.  Both group a grouped
conv's output channels the same way (group g owns outputs
``g·out/groups .. (g+1)·out/groups``), so a conv converts by a plain
transpose, and because the port flattens NHWC activations in (h, w, c)
order, as the JAX package does, so does the FC after a ``Flatten`` (VGG's
``fc6`` after ``[7, 7, 512]`` included).  The transformer's projections
(``wq``, ``wk``, ``wv``, ``wo``, ``fc1``, ``fc2``, ``head``) are FC weights
and transpose too.  Its embedding tables are ``[vocab, dim]`` in both
packages and are kept: every function here takes ``kept``, the paths of
such leaves, which the model declares (``ModelBase.kept_layout_paths``;
empty, the default, for the CNNs).  Vectors (biases, LayerNorm) are
unchanged.  A momentum velocity or Adam moment tree has the params' shapes
and converts the same way.  The composite models' trees (GoogLeNet's
``stem/conv1/w``, ``stage3/3a/b2/3x3/w``, ...; ResNet-50's
``trunk/res2_1/a/conv/w``, ...) hold the same keys in both packages and
convert leaf by leaf; their BatchNorm running state (1-D ``mean`` and
``var``) needs no transpose (:func:`bn_state_from_jax`).

An async center (``parallel/async_easgd.ElasticCenter``, served by either
package) holds the JAX layouts as a flat list in ``jax.tree.leaves``
order (keys sorted): :func:`params_from_center_leaves` lays such a list,
or a center snapshot's (``center_server.load_snapshot``), out as a port
model's params, and :func:`center_leaves_from_params` goes the other way.

Input and output are trees (nested dicts) of numpy arrays.
:func:`checkpoint_from_jax` applies them to a whole checkpoint the JAX
package wrote (any ported rule and optimizer, EMA included), into a port
model.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .utils.helper_funcs import (_jax_shape, get_leaf, jax_leaf_paths,
                                 leaf_paths, tree_map)


def _to_port(a, path, kept: frozenset) -> np.ndarray:
    """One leaf at ``path`` (its keys from the root) in the port's layout."""
    a = np.asarray(a, dtype=np.float32)
    if a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if a.ndim == 2 and path not in kept:
        return np.ascontiguousarray(a.T)
    return a.copy()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(tree, path)


def params_from_jax(tree, kept: frozenset = frozenset()):
    """JAX layout → port layout (params, momentum velocity, Adam moments);
    the 2-D leaves at the paths in ``kept`` as they are."""
    return _map_with_path(lambda a, path: _to_port(a, path, kept), tree)


def params_from_center_leaves(leaves, like, kept: frozenset = frozenset()):
    """An async center's leaves (the JAX layouts, in the JAX package's
    sorted-key order) → ``like``'s tree (a port model's params: its
    structure and key order) of float32 port-layout arrays."""
    paths = jax_leaf_paths(like)
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} center leaves for a model of "
                         f"{len(paths)}")
    by_path = {}
    for p, a in zip(paths, leaves):
        want = _jax_shape(tuple(np.shape(get_leaf(like, p))), p, kept)
        if tuple(np.shape(a)) != want:
            raise ValueError(f"center leaf {p} has shape {np.shape(a)}, "
                             f"the model wants {want}")
        by_path[p] = _to_port(a, p, kept)
    return _like_port(like, by_path)


def center_leaves_from_params(params, kept: frozenset = frozenset()) -> list:
    """A port tree of params (numpy or tensors) → the center's leaves:
    float32 JAX layouts in the JAX package's sorted-key order."""
    out = []
    for p in jax_leaf_paths(params):
        a = get_leaf(params, p)
        # a copy: on the CPU a tensor's numpy view shares its storage
        a = np.array(a.detach().cpu() if hasattr(a, "detach") else a,
                     dtype=np.float32)
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2 and p not in kept:
            a = a.T
        out.append(np.ascontiguousarray(a))
    return out


def bn_state_from_jax(tree):
    """The JAX package's BatchNorm running state (a tree of 1-D ``mean`` and
    ``var``) as float32 numpy arrays: the same values at the same paths."""
    return tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _check_same_leaves(name, jax_params, like):
    if sorted(jax_leaf_paths(jax_params)) != sorted(leaf_paths(like)):
        raise ValueError(f"{name}: the port tree and the JAX tree hold "
                         f"different leaves")


def flat_from_jax(flat, jax_params, like,
                  kept: frozenset = frozenset()) -> np.ndarray:
    """A flat vector in the JAX package's order (``flatten_tree`` of its
    params: sorted keys, JAX layouts) → the same values in the port's order
    (``flatten_tree`` of ``like``, the port's tree: its own key order,
    PyTorch layouts).  A pad region past the leaves is kept as it is.

    The onebit error-feedback state is such a vector; a checkpoint written
    by the JAX package carries it.  (The topk state needs no conversion:
    the port keeps it in the JAX order, ``helper_funcs.flatten_tree_jax``.)"""
    _check_same_leaves("flat_from_jax", jax_params, like)
    flat = np.asarray(flat, dtype=np.float32)
    segs, ofs = {}, 0
    for path in jax_leaf_paths(jax_params):
        shape = np.shape(get_leaf(jax_params, path))
        n = int(np.prod(shape))
        segs[path] = _to_port(flat[ofs:ofs + n].reshape(shape), path, kept)
        ofs += n
    return np.concatenate([segs[p].reshape(-1) for p in leaf_paths(like)]
                          + [flat[ofs:]])


def powersgd_state_from_jax(jstate, jax_params, like,
                            kept: frozenset = frozenset()) -> list:
    """The JAX package's PowerSGD state (a list of ``{"q", "e"}`` in its
    sorted leaf order; ``e`` is the leaf's ``[rows, cols]`` matrix) → the
    port's (the same list in the port's leaf order, ``e`` in the port
    leaf's shape).  ``q`` is ``[cols of M, rank]`` in both packages, for
    every leaf, and is kept as it is: the port multiplies it with its leaf
    as M itself (a leaf in ``kept``) or as Mᵀ (every other matrix); ``e``
    is reshaped to the JAX leaf's shape and converted like a parameter.
    Incompressible leaves keep their empty state."""
    _check_same_leaves("powersgd_state_from_jax", jax_params, like)
    paths = jax_leaf_paths(jax_params)
    if len(jstate) != len(paths):
        raise ValueError(f"powersgd_state_from_jax: {len(jstate)} states "
                         f"for {len(paths)} leaves")
    by_path = {}
    for path, st in zip(paths, jstate):
        q = np.asarray(st["q"], dtype=np.float32).copy()
        e = np.asarray(st["e"], dtype=np.float32)
        if e.size:
            e = _to_port(e.reshape(np.shape(get_leaf(jax_params, path))),
                         path, kept)
        by_path[path] = {"q": q, "e": e.copy()}
    return [by_path[p] for p in leaf_paths(like)]


def _set_leaf(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _from_paths(paths, values) -> dict:
    """A nested dict with ``values`` at ``paths``."""
    out: dict = {}
    for p, v in zip(paths, values):
        _set_leaf(out, p, v)
    return out


def _like_port(tree_like, by_path: dict):
    """``tree_like``'s structure with the value at each leaf's path."""
    paths = iter(leaf_paths(tree_like))
    return tree_map(lambda _: by_path[next(paths)], tree_like)


def checkpoint_from_jax(ckpt_dir: str, model,
                        epoch: Optional[int] = None) -> Optional[int]:
    """Load a checkpoint that the JAX package wrote into ``model`` (a port
    model after ``compile_iter_fns``, of the same layers, optimizer, rule
    and exchange strategy): params, optimizer state (the velocity of
    momentum and nesterov, rmsprop's square average, Adam's moments and
    per-leaf step counts; under ``ema_decay`` the shadow, its count and
    the inner state), the BatchNorm running state, the rule's state (an
    EASGD/ASGD center, GoSGD's α) or the strategy's (onebit's error
    feedback through :func:`flat_from_jax`; topk's, which the port keeps
    in the JAX order, as it is; PowerSGD's through
    :func:`powersgd_state_from_jax`) and the data cursor.  A part the JAX
    package stored per worker (``[n_workers, ...]``, every part under an
    async rule) gives this rank its own row.  Returns the epoch loaded,
    or None when there is none.

    JAX PRNG keys have no torch counterpart: the checkpoint's step and
    exchange keys are not read, and the model's generators keep the
    streams its config's seed started (the dropout bits differ from JAX's
    anyway, ``steps.step_seed``)."""
    from .utils import checkpoint as ckpt_lib
    from .utils import opt as opt_lib
    import torch

    meta = ckpt_lib.peek_meta(ckpt_dir, epoch)
    if meta is None:
        return None
    epoch = int(meta["epoch"])
    boxed = set(meta.get("boxed_parts", ()))
    kept = frozenset(model.kept_layout_paths())
    params = model.params
    jpaths = jax_leaf_paths(params)
    with np.load(os.path.join(ckpt_dir, f"ckpt_epoch{epoch}.npz")) as z:
        def part(key):
            n = sum(1 for f in z.files if f.startswith(key + "__"))
            leaves = [z[f"{key}__{i}"] for i in range(n)]
            if key in boxed:
                if int(meta.get("n_workers", 1)) != model.size:
                    raise ValueError(
                        f"{ckpt_dir}: '{key}' holds the state of "
                        f"{meta.get('n_workers')} workers; this run has "
                        f"{model.size}")
                leaves = [a[model.rank] for a in leaves]
            return leaves

        def jax_tree(leaves):        # a params-shaped JAX tree, sorted order
            shapes = [_jax_shape(tuple(get_leaf(params, p).shape), p, kept)
                      for p in jpaths]
            for p, a, s in zip(jpaths, leaves, shapes):
                if tuple(a.shape) != s:
                    raise ValueError(f"{ckpt_dir}: leaf {p} has shape "
                                     f"{a.shape}, the port model wants {s}")
            return _from_paths(jpaths, leaves)

        def port_tree(leaves):
            conv = params_from_jax(jax_tree(leaves), kept)
            return _like_port(params, {p: get_leaf(conv, p) for p in jpaths})

        n = len(jpaths)
        jparams = jax_tree(part("params"))
        new_params = port_tree(part("params"))

        def opt_tree(cur, opt):
            """The JAX optimizer state's leaves (sorted keys) in the port's
            structure ``cur``."""
            if isinstance(cur, dict) and set(cur) == {"inner", "ema", "t"}:
                # ema_wrap: sorted keys ema, inner, t
                if len(opt) < n + 1:
                    raise ValueError(f"{ckpt_dir}: opt_state has "
                                     f"{len(opt)} leaves, too few for EMA")
                return {"inner": opt_tree(cur["inner"], opt[n:-1]),
                        "ema": port_tree(opt[:n]), "t": int(opt[-1])}
            if isinstance(cur, dict) and set(cur) == {"m", "v", "t"}:
                if len(opt) != 3 * n:    # sorted keys: m, t, v
                    raise ValueError(f"{ckpt_dir}: opt_state has "
                                     f"{len(opt)} leaves, Adam's has {3 * n}")
                t = {p: int(a) for p, a in zip(jpaths, opt[n:2 * n])}
                return {"m": port_tree(opt[:n]), "v": port_tree(opt[2 * n:]),
                        "t": _like_port(params, t)}
            if opt:                  # momentum, nesterov, rmsprop
                return port_tree(opt)
            return cur

        new_opt = opt_tree(model.opt_state, part("opt_state"))
        bn = part("bn_state")
        bpaths = jax_leaf_paths(model.bn_state)
        if len(bn) != len(bpaths):
            raise ValueError(f"{ckpt_dir}: bn_state has {len(bn)} leaves, "
                             f"the port model's {len(bpaths)}")
        for p, a in zip(bpaths, bn):
            if tuple(a.shape) != tuple(get_leaf(model.bn_state, p).shape):
                raise ValueError(f"{ckpt_dir}: bn_state leaf {p} has shape "
                                 f"{a.shape}")
        new_bn = _like_port(model.bn_state,
                            dict(zip(bpaths, bn_state_from_jax(bn))))
        extra = part("extra")
        new_extra = {}
        if "center" in model.extra:           # EASGD, ASGD
            new_extra = {"center": port_tree(extra)}
        elif "alpha" in model.extra:          # GoSGD
            new_extra = {"alpha": np.float32(extra[0])}
        elif model.extra:
            strat = model.exchanger.strategy
            st = model.extra["strat"]
            if isinstance(st, list):        # PowerSGD: sorted keys e, q
                jstate = [{"e": extra[2 * i], "q": extra[2 * i + 1]}
                          for i in range(len(extra) // 2)]
                new_extra = {"strat": powersgd_state_from_jax(
                    jstate, jparams, params, kept)}
            elif strat.name == "topk":
                new_extra = {"strat": np.asarray(extra[0], np.float32)}
            else:
                new_extra = {"strat": flat_from_jax(extra[0], jparams,
                                                    params, kept)}
        cursor = dict(meta.get("cursor", {}))
        for f in z.files:
            if f.startswith("_cursor__"):
                cursor[f[len("_cursor__"):]] = z[f]

    model.load_params(new_params)
    model.load_bn_state(new_bn)

    def put(cur_leaf, new_leaf):
        if isinstance(cur_leaf, torch.Tensor):
            with torch.no_grad():
                cur_leaf.copy_(torch.as_tensor(np.asarray(new_leaf)))
            return cur_leaf
        return new_leaf

    # in place, Adam's counts into its device count tensors
    model.opt_state = opt_lib.load_state(model.opt_state, new_opt)
    if new_extra:
        model.extra = tree_map(put, model.extra, new_extra)
    if cursor and hasattr(model.data, "set_cursor"):
        model.data.set_cursor(cursor)
    return epoch
