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
``convert.flat_from_jax`` maps it onto the port's.  The onebit wire does
not depend on the order and uses the port's.

**JAX order.** :func:`flatten_tree_jax` and :func:`unflatten_like_jax` lay
the same tree out as the JAX package's ``flatten_tree`` does: keys sorted
at every level, 4-D conv weights as HWIO (``w.permute(2, 3, 1, 0)``), 2-D
FC weights as ``[in, out]``, and the 2-D leaves whose paths are in
``kept`` as they are (embedding tables, ``[vocab, dim]`` in both
packages).  The layer declares which of its leaves those are
(``models.layers.Layer.kept_layout``) and the model hands the set over
(``ModelBase.kept_layout_paths``): a leaf's layout is not guessed from its
shape or its name.  The topk wire selects per fixed-size chunk of the flat
vector, so its compressor, and its error state, are the JAX package's only
in this order.
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


def jax_leaf_paths(tree, path=()):
    """Leaf paths in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in jax_leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in jax_leaf_paths(v, path + (i,))]
    return [path]


def get_leaf(tree, path):
    """The leaf of ``tree`` at ``path`` (a tuple of keys and indices)."""
    for k in path:
        tree = tree[k]
    return tree


def to_jax_layout(t: torch.Tensor, path,
                  kept: frozenset = frozenset()) -> torch.Tensor:
    """A view of the port-layout leaf at ``path`` in the JAX package's
    layout: OIHW → HWIO, ``[out, in]`` → ``[in, out]``; a 2-D leaf whose
    path is in ``kept`` (an embedding table) and vectors as they are."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2 and path not in kept:
        return t.t()
    return t


def from_jax_layout(t: torch.Tensor, path,
                    kept: frozenset = frozenset()) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout`: HWIO → OIHW, ``[in, out]`` →
    ``[out, in]``, as a view."""
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    if t.dim() == 2 and path not in kept:
        return t.t()
    return t


def _jax_shape(shape, path, kept: frozenset) -> tuple:
    """The JAX layout's shape of the port-layout leaf at ``path`` of
    ``shape``."""
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    if len(shape) == 2 and path not in kept:
        return (shape[1], shape[0])
    return tuple(shape)


def flatten_tree_jax(tree, pad_to_multiple_of: int = 1,
                     kept: frozenset = frozenset()) -> torch.Tensor:
    """All leaves as one float32 vector in the JAX package's flat order
    and layouts (see the module docstring; ``kept``: the paths of the 2-D
    leaves kept as they are), zero-padded at the end to a multiple of
    ``pad_to_multiple_of``: one copy per leaf into the vector."""
    paths = jax_leaf_paths(tree)
    leaves = [get_leaf(tree, p) for p in paths]
    n = sum(int(l.numel()) for l in leaves)
    n_pad = n + (-n) % max(1, pad_to_multiple_of)
    flat = torch.empty(n_pad, dtype=torch.float32, device=leaves[0].device)
    ofs = 0
    for p, l in zip(paths, leaves):
        j = to_jax_layout(l, p, kept)
        flat[ofs:ofs + l.numel()].view(j.shape).copy_(j)
        ofs += l.numel()
    flat[n:].zero_()
    return flat


def unflatten_like_jax(tree, flat: torch.Tensor,
                       kept: frozenset = frozenset()):
    """Inverse of :func:`flatten_tree_jax`: each leaf of ``tree`` as a view
    of ``flat`` in the port's shape (strided: a conv or FC weight is a
    permuted view of its JAX-layout segment; a copy only where the leaf's
    dtype differs); the pad is dropped."""
    views, ofs = {}, 0
    for p in jax_leaf_paths(tree):
        l = get_leaf(tree, p)
        n = int(l.numel())
        v = from_jax_layout(
            flat[ofs:ofs + n].view(_jax_shape(l.shape, p, kept)), p, kept)
        views[p] = v if v.dtype == l.dtype else v.to(l.dtype)
        ofs += n
    paths = iter(leaf_paths(tree))
    return tree_map(lambda _: views[next(paths)], tree)


def leaf_paths(tree, path=()):
    """Leaf paths in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, path + (i,))]
    return [path]
