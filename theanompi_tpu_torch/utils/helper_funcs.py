"""Parameter-tree helpers.

Counterpart of ``theanompi_tpu/utils/helper_funcs.py`` for the part the port
uses: a model's parameters are a nested dict ``{layer: {"w": ..., "b": ...}}``
of tensors, the same shape of tree as the JAX package's pytree, and these
walk it.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more trees of the same structure
    (nested dicts, lists and tuples; everything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in a fixed order (dict insertion order, depth first)."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]

