"""JAX parameter trees → the port's.

The JAX package keeps conv weights HWIO ``[kh, kw, in/groups, out]`` and FC
weights ``[in, out]``; the port keeps PyTorch's OIHW
``[out, in/groups, kh, kw]`` and ``[out, in]``.  Both group a grouped
conv's output channels the same way (group g owns outputs
``g·out/groups .. (g+1)·out/groups``), so a conv converts by a plain
transpose, and because the port flattens NHWC activations in (h, w, c)
order, as the JAX package does, so does the FC after a ``Flatten`` (VGG's
``fc6`` after ``[7, 7, 512]`` included).  Vectors (biases) are unchanged.
A momentum velocity tree has the params' shapes and converts the same way.

Input and output are trees (nested dicts) of numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .utils.helper_funcs import get_leaf, jax_leaf_paths, leaf_paths, tree_map


def _to_port(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    if a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a.copy()


def params_from_jax(tree):
    """JAX layout → port layout (params or momentum velocity)."""
    return tree_map(_to_port, tree)


def _check_same_leaves(name, jax_params, like):
    if sorted(jax_leaf_paths(jax_params)) != sorted(leaf_paths(like)):
        raise ValueError(f"{name}: the port tree and the JAX tree hold "
                         f"different leaves")


def flat_from_jax(flat, jax_params, like) -> np.ndarray:
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
        segs[path] = _to_port(flat[ofs:ofs + n].reshape(shape))
        ofs += n
    return np.concatenate([segs[p].reshape(-1) for p in leaf_paths(like)]
                          + [flat[ofs:]])


def powersgd_state_from_jax(jstate, jax_params, like) -> list:
    """The JAX package's PowerSGD state (a list of ``{"q", "e"}`` in its
    sorted leaf order; ``e`` is the leaf's ``[rows, cols]`` matrix) → the
    port's (the same list in the port's leaf order, ``e`` in the port
    leaf's shape).  ``q`` is ``[cols, rank]`` in both and is kept as it is;
    ``e`` is reshaped to the JAX leaf's shape and converted like a
    parameter.  Incompressible leaves keep their empty state."""
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
            e = _to_port(e.reshape(np.shape(get_leaf(jax_params, path))))
        by_path[path] = {"q": q, "e": e.copy()}
    return [by_path[p] for p in leaf_paths(like)]
