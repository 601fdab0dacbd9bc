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
and converts the same way.

Input and output are trees (nested dicts) of numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .utils.helper_funcs import get_leaf, jax_leaf_paths, leaf_paths


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
