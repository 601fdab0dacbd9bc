"""Parameter-tree helpers.

Counterpart of ``theanompi_tpu/utils/helper_funcs.py`` for the part the port
uses: a model's parameters are a nested dict ``{layer: {"w": ..., "b": ...}}``
of tensors, the same shape of tree as the JAX package's pytree, and these
walk it, and pack it into one flat float32 vector for the strategies that
work on one (the compressed wire).

**Flat order.** Leaves come in dict insertion order, depth first: a layer's
``"w"`` before its ``"b"``, each leaf flattened in its own (PyTorch) layout.
The JAX package's ``jax.tree.leaves`` sorts dict keys and keeps HWIO /
``[in, out]`` weights, so its flat vector is a permutation of this one;
``convert.flat_from_jax`` maps it onto the port's.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


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


def tree_size(tree) -> int:
    """Number of elements over all leaves."""
    return sum(int(l.numel()) for l in tree_leaves(tree))


def flatten_tree(tree, pad_to_multiple_of: int = 1) -> torch.Tensor:
    """All leaves concatenated as one float32 vector, in :func:`tree_leaves`
    order, zero-padded at the end to a multiple of ``pad_to_multiple_of``."""
    leaves = [l.reshape(-1).float() for l in tree_leaves(tree)]
    pad = (-sum(l.numel() for l in leaves)) % max(1, pad_to_multiple_of)
    if pad:
        leaves.append(leaves[0].new_zeros(pad))
    return torch.cat(leaves)


def unflatten_like(tree, flat: torch.Tensor):
    """Inverse of :func:`flatten_tree`: views of ``flat`` in each leaf's
    shape (a copy only where the leaf's dtype differs); the pad is
    dropped."""
    it = iter(tree_leaves(tree))
    ofs = 0

    def take(_):
        nonlocal ofs
        l = next(it)
        n = l.numel()
        v = flat[ofs:ofs + n].view(l.shape)
        ofs += n
        return v if v.dtype == l.dtype else v.to(l.dtype)

    return tree_map(take, tree)
