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
package wrote (any ported rule and optimizer, EMA included, and the
sharded layouts ``zero_opt``, ``update_sharding`` and ``fsdp``), into a
port model.  A sharded part's rows are the JAX package's chunks of its own
flat layout: they are joined back into full leaves (or the full flat
vector), converted, and cut again into the port's chunks.
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


def _dense_from_jax_rows(rows, n_total: int, jax_like, like,
                         kept: frozenset = frozenset()) -> np.ndarray:
    """``[N, chunk]`` rows of the JAX package's flat chunk layout (ZeRO-1's
    optimizer state, FSDP's params and state: ``flatten_tree``, its sorted
    order and layouts, zero-padded) → the port's dense flat vector of the
    ``n_total`` values (``helper_funcs.flatten_tree`` of ``like``)."""
    flat = np.asarray(rows, np.float32).reshape(-1)[:n_total]
    return flat_from_jax(flat, jax_like, like, kept)


def _param_suffix(path, param_paths: set):
    """The parameter path that ``path`` (a leaf of a params-shaped subtree
    of an optimizer or extra state) ends with, or None."""
    for i in range(len(path)):
        if tuple(path[i:]) in param_paths:
            return tuple(path[i:])
    return None


def _sharded_rows_from_jax(cur_tree, jax_leaves, rank: int, chunk_row,
                           plan=None, jax_shapes=None,
                           kept: frozenset = frozenset()):
    """A sharded state part of the JAX package (its boxed ``[N, ...]``
    leaves, in sorted-key order) → this rank's values in the structure of
    ``cur_tree`` (the port's part).  A 0-d leaf (a step count) takes its
    row; a leaf in the flat chunk layout goes through ``chunk_row`` (JAX
    rows → the port's row); under ``plan`` (``update_sharding``, the port's
    leaf-wise plan keyed by parameter path) a sharded leaf's rows are
    joined, converted and cut again, and a whole one converted."""
    from .parallel.update_sharding import window
    paths = jax_leaf_paths(cur_tree)
    if len(paths) != len(jax_leaves):
        raise ValueError(f"{len(jax_leaves)} leaves in the JAX part, "
                         f"{len(paths)} in the port's")
    vals = {}
    for path, rows in zip(paths, jax_leaves):
        cur = get_leaf(cur_tree, path)
        rows = np.asarray(rows)
        if cur.dim() == 0:
            vals[path] = rows[rank]
        elif plan is None:
            vals[path] = chunk_row(rows)
        else:
            pp = _param_suffix(path, set(plan))
            lp = plan[pp]
            jshape = jax_shapes[pp]
            full = rows.reshape(-1)[:lp.size].reshape(jshape) \
                if lp.sharded else rows[rank]
            port = _to_port(full, pp, kept).reshape(-1)
            if lp.sharded:
                lo, hi = window(lp.size, rank, lp.chunk)
                row = np.zeros(lp.chunk, np.float32)
                row[:hi - lo] = port[lo:hi]
                port = row
            vals[path] = port.reshape(tuple(cur.shape))
    return _like_port(cur_tree, vals)


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
    rank = model.rank
    fsdp, zero = model._fsdp, model._zero_layout
    uplan = model._ushard_plan
    cplan = model.exchanger.update_plan()
    for key, mine in (("fsdp", fsdp), ("zero", zero)):
        if (key in meta) != (mine is not None):
            raise ValueError(f"{ckpt_dir}: the checkpoint's layout "
                             f"{'has' if key in meta else 'lacks'} {key!r}, "
                             f"the port model's does not match")
    # shapes only: the JAX layout's params (no values)
    jax_shapes = {p: _jax_shape(tuple(get_leaf(params, p).shape), p, kept)
                  for p in jpaths}
    jax_like = _from_paths(jpaths, [np.broadcast_to(np.float32(0), jax_shapes[p])
                                    for p in jpaths])
    n_total = sum(int(np.prod(s)) for s in jax_shapes.values())

    def chunk_row(rows):
        """JAX flat chunk rows → this rank's row of the port's layout."""
        dense = _dense_from_jax_rows(rows, n_total, jax_like, params, kept)
        if fsdp is not None:
            return fsdp.from_dense(dense)[rank]
        n = int(zero["n"])
        c = -(-n_total // n)
        return np.pad(dense, (0, c * n - n_total)).reshape(n, c)[rank]

    def leaf_plan(plan, prefix=()):
        return None if plan is None else {
            tuple(p[len(prefix):]): lp for p, lp in
            zip(jax_leaf_paths(model.extra if prefix else params),
                plan.leaves)}

    with np.load(os.path.join(ckpt_dir, f"ckpt_epoch{epoch}.npz")) as z:
        def part(key, rows=False):
            n = sum(1 for f in z.files if f.startswith(key + "__"))
            leaves = [z[f"{key}__{i}"] for i in range(n)]
            if key in boxed:
                if int(meta.get("n_workers", 1)) != model.size:
                    raise ValueError(
                        f"{ckpt_dir}: '{key}' holds the state of "
                        f"{meta.get('n_workers')} workers; this run has "
                        f"{model.size}")
                if not rows:
                    leaves = [a[model.rank] for a in leaves]
            elif rows:
                raise ValueError(f"{ckpt_dir}: '{key}' is not stored per "
                                 f"worker; the port model shards it")
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
        if fsdp is not None:
            jparams = jax_like
            new_params = chunk_row(part("params", rows=True)[0])
        else:
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

        if fsdp is not None or zero is not None or uplan is not None:
            new_opt = _sharded_rows_from_jax(
                model.opt_state, part("opt_state", rows=True), rank,
                chunk_row, leaf_plan(uplan), jax_shapes, kept)
        else:
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
        extra = part("extra", rows=cplan is not None)
        new_extra = {}
        if cplan is not None:                 # a center under the plan
            new_extra = _sharded_rows_from_jax(
                model.extra, extra, rank, None, leaf_plan(cplan, ("center",)),
                jax_shapes, kept)
        elif "center" in model.extra:         # EASGD, ASGD
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

    if fsdp is not None:
        with torch.no_grad():
            fsdp.shard.copy_(torch.from_numpy(np.ascontiguousarray(new_params)))
        fsdp.gather_params()
    else:
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
