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

from .utils.helper_funcs import tree_map


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


def _jax_leaf_order(tree):
    """``(path, leaf)`` in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [(((k,) + p), l) for k in sorted(tree)
                for p, l in _jax_leaf_order(tree[k])]
    return [((), tree)]


def _port_leaf_paths(tree, path=()):
    """Leaf paths in the port's ``tree_leaves`` order (insertion order)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _port_leaf_paths(v, path + (k,))]
    return [path]


def flat_from_jax(flat, jax_params, like) -> np.ndarray:
    """A flat vector in the JAX package's order (``flatten_tree`` of its
    params: sorted keys, JAX layouts) → the same values in the port's order
    (``flatten_tree`` of ``like``, the port's tree: its own key order,
    PyTorch layouts).  A pad region past the leaves is kept as it is.

    The error-feedback state of the compressed wire is such a vector; a
    checkpoint written by the JAX package carries it."""
    flat = np.asarray(flat, dtype=np.float32)
    segs, ofs = {}, 0
    for path, leaf in _jax_leaf_order(jax_params):
        shape = np.shape(leaf)
        n = int(np.prod(shape))
        segs[path] = _to_port(flat[ofs:ofs + n].reshape(shape))
        ofs += n
    paths = _port_leaf_paths(like)
    if sorted(paths) != sorted(segs):
        raise ValueError("flat_from_jax: the port tree and the JAX tree hold "
                         "different leaves")
    return np.concatenate([segs[p].reshape(-1) for p in paths] + [flat[ofs:]])


