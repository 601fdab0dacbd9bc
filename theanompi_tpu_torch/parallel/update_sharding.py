"""Leaf-wise update-plane sharding over the data-parallel ranks.

Counterpart of ``theanompi_tpu/parallel/update_sharding.py``.  Under a rule
whose update-plane state is identical on every rank (BSP's optimizer
moments, where every rank applies the same reduced gradient; the EASGD and
ASGD centers), each rank keeps only its ``[chunk]`` window of that state:

* :func:`plan_tree` stamps a :class:`LeafPlan` per leaf: a leaf of at least
  ``min_bytes`` (config ``ushard_min_bytes``, default
  :data:`DEFAULT_MIN_BYTES`) and at least ``n_workers`` elements is
  sharded as a zero-padded, evenly divisible flat chunk; smaller leaves
  stay whole on every rank.  Leaves are planned in the JAX package's order
  (``helper_funcs.jax_tree_leaves``: dict keys sorted) under the JAX key
  paths, so the port's plan of a model is the JAX plan leaf by leaf.
* :func:`shard_tree` cuts this rank's windows; :func:`unshard_tree`
  rebuilds the full leaves with ONE ``all_gather_into_tensor`` per dtype
  over every sharded chunk packed together, each leaf then copying its
  column block back.  The values are exactly the chunks the ranks cut, so
  element-wise update math on disjoint chunks followed by the gather is
  bit-identical to the replicated update.
* :func:`shard_opt` wraps an optimizer so its state lives on the per-leaf
  chunks; :func:`flat_shard_opt` is the one-flat-chunk configuration,
  ZeRO-1 (``parallel/zero.py``).

A leaf is flattened in the port's own layout (OIHW, ``[out, in]``), not the
JAX package's: the update is element-wise, so the order of a flat leaf
changes no value, and the port copies no permuted views.  A chunk row is
therefore not the JAX package's row of the same leaf; ``convert.py`` maps
the rows of a JAX checkpoint.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.helper_funcs import (get_leaf, jax_leaf_paths, leaf_paths,
                                  tree_leaves, tree_map, tree_size)
from ..utils.opt import OptPair

# below this many bytes a leaf stays whole on every rank: sharding a bias
# buys nothing and costs a gather lane (the JAX package's threshold)
DEFAULT_MIN_BYTES = 65536


def chunk_size(n_total: int, n_workers: int) -> int:
    """ceil(P/N): the per-rank chunk of an N-way flat partition."""
    return -(-int(n_total) // int(n_workers))


def padded_size(n_total: int, n_workers: int) -> int:
    """``chunk_size·N``: the evenly divisible padded flat length (P = 10,
    N = 4 → chunk 3, padded 12); the pad is zeros, explicitly."""
    return chunk_size(n_total, n_workers) * int(n_workers)


def keystr(path) -> str:
    """A leaf path as ``jax.tree_util.keystr`` writes it: ``['conv']['w']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def all_gather_into(out: torch.Tensor, inp: torch.Tensor) -> None:
    """``dist.all_gather_into_tensor``: the name both the card's torch and
    this one have (newer releases mark it deprecated in favour of a name
    older ones lack)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, inp)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor) -> None:
    """``dist.reduce_scatter_tensor`` with SUM: rank r's ``out`` is the sum
    over the ranks of ``inp``'s r-th ``out``-sized block."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*reduce_scatter_tensor")
        dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM)


class LeafPlan(NamedTuple):
    """The schema entry for one update-plane leaf."""
    path: str            # the JAX key path, for reports and errors
    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int
    sharded: bool        # flat-chunked over the ranks
    chunk: int           # the per-rank chunk (== size when not sharded)
    pad: int             # chunk·N − size (0 when not sharded)


class UpdatePlan(NamedTuple):
    """A :class:`LeafPlan` per leaf, in the JAX package's leaf order."""
    leaves: Tuple[LeafPlan, ...]
    n_workers: int
    min_bytes: int

    @property
    def any_sharded(self) -> bool:
        return any(l.sharded for l in self.leaves)


def plan_tree(template, n_workers: int, *,
              min_bytes: int = DEFAULT_MIN_BYTES) -> UpdatePlan:
    """The leaf-wise schema of ``template`` (a tree of tensors): a leaf is
    sharded when its bytes reach ``min_bytes`` and it has at least
    ``n_workers`` elements; ``n_workers == 1`` shards nothing."""
    out = []
    for path in jax_leaf_paths(template):
        leaf = get_leaf(template, path)
        shape = tuple(leaf.shape)
        size = int(leaf.numel())
        sharded = (n_workers > 1 and size >= n_workers
                   and size * leaf.element_size() >= min_bytes)
        chunk = chunk_size(size, n_workers) if sharded else size
        out.append(LeafPlan(keystr(path), shape, leaf.dtype, size, sharded,
                            chunk, chunk * n_workers - size if sharded
                            else 0))
    return UpdatePlan(tuple(out), int(n_workers), int(min_bytes))


def _planned(tree, plan: UpdatePlan):
    """``tree``'s leaf paths and leaves in the plan's order."""
    paths = jax_leaf_paths(tree)
    if len(paths) != len(plan.leaves):
        raise ValueError(f"tree has {len(paths)} leaves, plan has "
                         f"{len(plan.leaves)}: the plan must be built on the "
                         f"same template")
    return paths, [get_leaf(tree, p) for p in paths]


def _rebuild(tree, paths, values):
    """``tree``'s structure with ``values`` (given in ``paths`` order)."""
    by_path = dict(zip(paths, values))
    it = iter(leaf_paths(tree))
    return tree_map(lambda _: by_path[next(it)], tree)


def window(flat_len: int, rank: int, chunk: int) -> Tuple[int, int]:
    """``[lo, hi)``: the part of rank ``rank``'s chunk that lies inside a
    flat vector of ``flat_len`` (empty past its end)."""
    lo = rank * chunk
    return min(lo, flat_len), min(lo + chunk, flat_len)


def shard_tree(tree, plan: UpdatePlan, rank: int):
    """Each sharded leaf → this rank's ``[chunk]`` window of its zero-padded
    flat (a new tensor of the leaf's dtype); every other leaf passes as it
    is (the same tensor)."""
    paths, leaves = _planned(tree, plan)
    out = []
    for leaf, lp in zip(leaves, plan.leaves):
        if not lp.sharded:
            out.append(leaf)
            continue
        c = leaf.new_zeros(lp.chunk)
        lo, hi = window(lp.size, rank, lp.chunk)
        if hi > lo:
            c[:hi - lo].copy_(leaf.reshape(-1)[lo:hi])
        out.append(c)
    return _rebuild(tree, paths, out)


def reshard_into(chunks, full, plan: UpdatePlan, rank: int) -> None:
    """The store half of an unshard → update → reshard round trip: each
    sharded leaf's window of ``full`` copied into its chunk in ``chunks``,
    in place (the pad lanes untouched); ``full``'s other leaves into
    ``chunks``' where they are different tensors."""
    _, cs = _planned(chunks, plan)
    _, fs = _planned(full, plan)
    dst, src = [], []
    for c, f, lp in zip(cs, fs, plan.leaves):
        if not lp.sharded:
            if c is not f:
                dst.append(c)
                src.append(f)
            continue
        lo, hi = window(lp.size, rank, lp.chunk)
        if hi > lo:
            dst.append(c[:hi - lo])
            src.append(f.reshape(-1)[lo:hi])
    if dst:
        torch._foreach_copy_(dst, src)


def unshard_tree(chunked, plan: UpdatePlan, out=None):
    """The full leaves from every rank's chunks: per dtype, the sharded
    chunks packed into one ``[C_total]`` vector, ONE
    ``all_gather_into_tensor`` into ``[N, C_total]``, and each leaf's
    column block back (pad trimmed).  ``out`` (a tree like ``chunked``'s
    full shapes) receives the sharded leaves in place and is returned;
    without it they are new tensors.  Unsharded leaves pass as they are.
    The round trip with :func:`shard_tree` is the identity bit for bit."""
    paths, leaves = _planned(chunked, plan)
    dests = _planned(out, plan)[1] if out is not None else None
    result = list(dests) if dests is not None else list(leaves)
    if dests is not None:
        for i, lp in enumerate(plan.leaves):
            if not lp.sharded and dests[i] is not leaves[i]:
                dests[i].copy_(leaves[i])
    by_dtype: dict = {}
    for i, lp in enumerate(plan.leaves):
        if lp.sharded:
            by_dtype.setdefault(lp.dtype, []).append(i)
    n = plan.n_workers
    for dtype, idxs in by_dtype.items():
        vec = leaves[idxs[0]] if len(idxs) == 1 else \
            torch.cat([leaves[i] for i in idxs])
        gathered = vec.new_empty(n * vec.numel())
        all_gather_into(gathered, vec.contiguous())
        gathered = gathered.view(n, -1)
        dst, src, off = [], [], 0
        for i in idxs:
            lp = plan.leaves[i]
            if dests is None:
                result[i] = vec.new_empty(lp.shape)
            flat = result[i].view(-1)
            for r in range(n):
                lo, hi = window(lp.size, r, lp.chunk)
                if hi > lo:
                    dst.append(flat[lo:hi])
                    src.append(gathered[r, off:off + hi - lo])
            off += lp.chunk
        torch._foreach_copy_(dst, src)
    return out if out is not None else _rebuild(chunked, paths, result)


def chunk_template(template, plan: UpdatePlan):
    """The per-rank template an optimizer's state is made from: sharded
    leaves as ``[chunk]`` zeros of the leaf's dtype and device, the others
    as they are."""
    paths, leaves = _planned(template, plan)
    return _rebuild(template, paths, [
        l.new_zeros(lp.chunk) if lp.sharded else l
        for l, lp in zip(leaves, plan.leaves)])


def shard_host_boxed(tree, plan: UpdatePlan):
    """Host-side ``[N, ...]`` rows of a tree of arrays: a sharded leaf as
    its ``[N, chunk]`` padded rows (row i is rank i's chunk), every other
    leaf broadcast to N rows (numpy)."""
    paths = jax_leaf_paths(tree)
    n, out = plan.n_workers, []
    for p, lp in zip(paths, plan.leaves):
        a = np.asarray(get_leaf(tree, p))
        if lp.sharded:
            out.append(np.pad(a.reshape(-1), (0, lp.pad)).reshape(
                n, lp.chunk))
        else:
            out.append(np.broadcast_to(a[None], (n,) + a.shape).copy())
    return _rebuild(tree, paths, out)


def unshard_boxed(boxed, plan: UpdatePlan):
    """Inverse of :func:`shard_host_boxed`: a sharded leaf's ``[N, chunk]``
    rows concatenated back to its full value (pad trimmed), every other
    leaf's row 0.  Array-method algebra only (numpy or tensors)."""
    paths, leaves = _planned(boxed, plan)
    return _rebuild(boxed, paths, [
        l.reshape(-1)[:lp.size].reshape(lp.shape) if lp.sharded else l[0]
        for l, lp in zip(leaves, plan.leaves)])


def shard_opt(opt: OptPair, plan: UpdatePlan, rank: int) -> OptPair:
    """``opt`` with its state on this rank's per-leaf chunks: ``update``
    cuts the (reduced) gradient's and the params' windows, runs the inner
    update on them in place, and rebuilds the params with
    :func:`unshard_tree`.  Pad lanes are zeros in params and gradient, and
    every optimizer maps zeros to zeros, so the pad never leaks.  Needs
    the same gradient on every rank (BSP grads mode)."""

    def init(params):
        return {"opt": opt.init(chunk_template(params, plan))}

    @torch.no_grad()
    def update(grads, st, params, lr):
        my_g = shard_tree(grads, plan, rank)
        my_p = shard_tree(params, plan, rank)
        _, st["opt"] = opt.update(my_g, st["opt"], my_p, lr)
        unshard_tree(my_p, plan, out=params)
        return params, st

    return OptPair(init, update)


def _flat_window(leaves, lo: int, hi: int):
    """``(segments of leaves, [a, b) offsets into the window)`` for the
    part of the flat concatenation of ``leaves`` (the port's order and
    layouts) that lies in ``[lo, hi)``."""
    segs, offs, ofs = [], [], 0
    for l in leaves:
        n = int(l.numel())
        a, b = max(lo, ofs), min(hi, ofs + n)
        if b > a:
            segs.append(l.reshape(-1)[a - ofs:b - ofs])
            offs.append((a - lo, b - lo))
        ofs += n
    return segs, offs


def flat_shard_opt(opt: OptPair, n_workers: int, params_template, rank: int,
                   model_shards: int = 1, pspecs=None,
                   model_axes: tuple = ()) -> OptPair:
    """ZeRO-1: one ``ceil(P/N)`` chunk of the whole flattened params per
    rank (the port's flat order and layouts, float32).  ``update`` copies
    this rank's window of the reduced gradient and of the params into
    ``[chunk]`` buffers (pad zeros), runs the inner update on them in
    place, gathers every rank's chunk with one ``all_gather_into_tensor``
    and copies the result back into the params.  The model-parallel
    arguments of the JAX package's form are refused: tensor and pipeline
    layouts are not ported (A9d)."""
    if model_shards != 1 or pspecs is not None or model_axes:
        raise NotImplementedError(
            "flat_shard_opt under model parallelism (model_shards, pspecs, "
            "model_axes) is not ported yet (A9d)")
    n_total = tree_size(params_template)
    chunk = chunk_size(n_total, n_workers)
    padded = chunk * n_workers
    lo, hi = rank * chunk, (rank + 1) * chunk

    def take(leaves) -> torch.Tensor:
        buf = torch.zeros(chunk, dtype=torch.float32, device=leaves[0].device)
        segs, offs = _flat_window(leaves, lo, hi)
        if segs:
            torch._foreach_copy_([buf[a:b] for a, b in offs], segs)
        return buf

    def init(params):
        dev = tree_leaves(params)[0].device
        return {"opt": opt.init(torch.zeros(chunk, dtype=torch.float32,
                                            device=dev))}

    @torch.no_grad()
    def update(grads, st, params, lr):
        ps = tree_leaves(params)
        my_p = take(ps)
        _, st["opt"] = opt.update(take(tree_leaves(grads)), st["opt"], my_p,
                                  lr)
        full = my_p.new_empty(padded)
        all_gather_into(full, my_p)
        sizes = [int(p.numel()) for p in ps]
        torch._foreach_copy_(ps, [v.view_as(p) for v, p in
                                  zip(full[:n_total].split(sizes), ps)])
        return params, st

    return OptPair(init, update)
