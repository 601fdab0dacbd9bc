"""Bucketed collectives: the exchange wire in slices.

Counterpart of ``theanompi_tpu/parallel/buckets.py``, the one bucket
planner and pack/collect/unpack engine every wire shares.  Instead of one
collective per leaf (the monolithic wire), a payload crosses as
~``bucket_bytes`` slices, every slice's collective issued with
``async_op=True`` before the first is waited on, so that several are in
flight at once (NCCL/DDP buckets).

* :func:`plan_buckets` — a pure function of the tree's structure and its
  leaves' sizes and dtypes (never their values).  It walks the leaves in
  the JAX package's order (``helper_funcs.jax_tree_leaves``: dict keys
  sorted), not the port's, and closes a bucket greedily once it holds
  ``bucket_bytes``, so that the port's plan of a model is the JAX
  package's plan of the same model: the same buckets with the same
  members.  Buckets are dtype-homogeneous (a dtype change closes the
  current one: packing never casts), and a leaf of ``bucket_bytes`` or
  more is a bucket of its own, never split and never merged.
* :func:`pack` / :func:`unpack` — leaves ↔ one 1-D vector per bucket,
  each leaf flattened in its own (PyTorch) layout: ``reshape`` and
  ``torch.cat`` out, views back, so the round trip is bit-exact.  The
  element order inside a bucket does not matter to the collectives that
  ride it: a sum, a gather or a send is element-wise.
* :func:`bucketed_collect` and :func:`bucketed_all_reduce` (≙
  ``bucketed_psum``) — every bucket's collective started before the
  first is waited on.  ``bucket_bytes <= 0`` takes the per-leaf
  monolithic path.

Bucketed ≡ monolithic bit for bit wherever the collective's sum of an
element does not depend on where the element sits in its buffer: a
gather, a point-to-point send, a sum over two ranks (float addition
commutes), and every collective at world 1.  A ring all-reduce over three
ranks or more (gloo's, NCCL's) starts each segment of its buffer at
another rank, so the order in which an element's terms are added follows
its offset, and bucketing changes the low bits of such sums
(``tests/test_torch_buckets.py`` shows it and holds them within a few
ulps).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.helper_funcs import (get_leaf, jax_leaf_paths, jax_tree_leaves,
                                  leaf_paths, tree_map)

DEFAULT_BUCKET_BYTES = 4 << 20          # ~4 MiB, the DDP/NCCL sweet spot


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.float32`` → ``float32``),
    as the JAX package's plan names it."""
    return str(dtype).rsplit(".", 1)[-1]


class Bucket(NamedTuple):
    """One wire slice: which leaves ride together."""

    dtype: str                 # numpy dtype name: buckets never mix dtypes
    leaf_ids: Tuple[int, ...]  # indices into the JAX-order leaf list
    sizes: Tuple[int, ...]     # element count per member leaf (same order)

    @property
    def size(self) -> int:
        return sum(self.sizes)

    def nbytes(self) -> int:
        return self.size * torch.empty(
            (), dtype=getattr(torch, self.dtype)).element_size()


class BucketPlan(NamedTuple):
    """The whole schedule: every non-empty leaf in exactly one bucket, in
    the JAX package's leaf order; empty leaves ride nowhere."""

    bucket_bytes: int
    buckets: Tuple[Bucket, ...]
    n_leaves: int
    empty_leaf_ids: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def plan_buckets(tree, bucket_bytes: int = DEFAULT_BUCKET_BYTES
                 ) -> BucketPlan:
    """The bucket plan of ``tree`` (tensors, or anything with ``shape``,
    ``numel()`` and ``dtype``): the JAX package's ``plan_buckets`` over
    the same leaves.  ``bucket_bytes <= 0`` gives one bucket per dtype
    run."""
    bucket_bytes = int(bucket_bytes)
    leaves = jax_tree_leaves(tree)
    buckets: List[Bucket] = []
    empty: List[int] = []
    cur_ids: List[int] = []
    cur_sizes: List[int] = []
    cur_dtype = None
    cur_bytes = 0

    def close():
        nonlocal cur_ids, cur_sizes, cur_dtype, cur_bytes
        if cur_ids:
            buckets.append(Bucket(cur_dtype, tuple(cur_ids),
                                  tuple(cur_sizes)))
        cur_ids, cur_sizes, cur_dtype, cur_bytes = [], [], None, 0

    for i, leaf in enumerate(leaves):
        size = int(leaf.numel())
        if size == 0:
            empty.append(i)
            continue
        dt = _dtype_name(leaf.dtype)
        nbytes = size * leaf.element_size()
        if cur_dtype is not None and dt != cur_dtype:
            close()                       # dtype-homogeneous buckets only
        if bucket_bytes > 0 and nbytes >= bucket_bytes:
            close()                       # an oversized leaf: its own
            buckets.append(Bucket(dt, (i,), (size,)))    # bucket, unsplit
            continue
        cur_ids.append(i)
        cur_sizes.append(size)
        cur_dtype = dt
        cur_bytes += nbytes
        if bucket_bytes > 0 and cur_bytes >= bucket_bytes:
            close()
    close()
    return BucketPlan(bucket_bytes, tuple(buckets), len(leaves),
                      tuple(empty))


def plan_signature(plan: BucketPlan) -> str:
    """``<bucket_bytes>:<n_buckets>b/<n_leaves>l``, as the JAX package's."""
    return f"{plan.bucket_bytes}:{plan.n_buckets}b/{plan.n_leaves}l"


def count_buckets(tree, bucket_bytes: int) -> int:
    """Collectives one bucketed exchange of ``tree`` issues."""
    return plan_buckets(tree, bucket_bytes).n_buckets


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack(tree, plan: BucketPlan) -> List[torch.Tensor]:
    """Leaves → one contiguous 1-D vector per bucket, dtype kept (a
    one-leaf bucket is a view of its leaf when the leaf is contiguous)."""
    leaves = jax_tree_leaves(tree)
    assert len(leaves) == plan.n_leaves, (
        f"plan built for {plan.n_leaves} leaves, tree has {len(leaves)}")
    out = []
    for b in plan.buckets:
        segs = [leaves[i].reshape(-1) for i in b.leaf_ids]
        out.append(segs[0] if len(segs) == 1 else torch.cat(segs))
    return out


def unpack(vectors: Sequence[torch.Tensor], tree, plan: BucketPlan):
    """Inverse of :func:`pack`: a tree shaped like ``tree`` whose leaves are
    views of ``vectors`` (empty leaves are ``tree``'s own)."""
    assert len(vectors) == plan.n_buckets
    paths = jax_leaf_paths(tree)
    got = {}
    for b, vec in zip(plan.buckets, vectors):
        ofs = 0
        for i, size in zip(b.leaf_ids, b.sizes):
            got[paths[i]] = vec[ofs:ofs + size].view(
                get_leaf(tree, paths[i]).shape)
            ofs += size
    it = iter(leaf_paths(tree))
    return tree_map(lambda leaf: got.get(next(it), leaf), tree)


# ---------------------------------------------------------------------------
# bucketed collectives
# ---------------------------------------------------------------------------

def bucketed_collect(tree, plan: BucketPlan,
                     start_fn: Callable[[torch.Tensor], Any],
                     done_fn: Callable[[Any], torch.Tensor]):
    """The schedule every bucketed wire shares: pack, start EVERY bucket's
    collective (``start_fn``, which issues it with ``async_op=True``)
    before the first ``done_fn`` waits on one, then unpack."""
    tickets = [start_fn(vec) for vec in pack(tree, plan)]
    return unpack([done_fn(t) for t in tickets], tree, plan)


def all_reduce_start(vec: torch.Tensor):
    """An asynchronous SUM all-reduce of ``vec`` in place: the ticket
    :func:`all_reduce_done` takes."""
    return vec, dist.all_reduce(vec, async_op=True)


def all_reduce_done(ticket) -> torch.Tensor:
    """Wait on an :func:`all_reduce_start` (on the card the current stream
    waits on the collective's; the host does not) and return its vector."""
    vec, work = ticket
    work.wait()
    return vec


def all_gather_start(t: torch.Tensor, size: int):
    """An asynchronous gather of every rank's ``t`` into a new
    ``[size, *t.shape]``, in rank order."""
    out = t.new_empty((size,) + tuple(t.shape))
    return out, dist.all_gather(list(out.unbind(0)), t, async_op=True)


all_gather_done = all_reduce_done


@torch.no_grad()
def bucketed_all_reduce(tree, bucket_bytes: int, plan: BucketPlan = None,
                        wire_dtype: torch.dtype = None):
    """Each leaf of ``tree`` replaced IN PLACE by its SUM over the ranks;
    returns ``tree``.  ``bucket_bytes <= 0`` (and no ``plan``): one
    synchronous all-reduce a leaf, the monolithic wire; else one
    asynchronous all-reduce a bucket, all started before the first wait,
    and the sums copied back into the leaves.  ``wire_dtype`` sums a copy
    of each bucket in that dtype (cast → sum → cast back, element-wise
    the monolithic wire's cast of each leaf)."""
    if plan is None:
        if int(bucket_bytes) <= 0:
            assert wire_dtype is None, "the monolithic wire casts per leaf"
            for leaf in jax_tree_leaves(tree):
                dist.all_reduce(leaf)
            return tree
        plan = plan_buckets(tree, bucket_bytes)
    start = all_reduce_start if wire_dtype is None else \
        (lambda v: all_reduce_start(v.to(wire_dtype)))
    copy_into(tree, bucketed_collect(tree, plan, start, all_reduce_done))
    return tree


def copy_into(dst_tree, src_tree) -> None:
    """``dst`` leaves ← ``src`` leaves, in one multi-tensor pass, skipping
    the leaves that are the same tensor (or a view of the same memory)."""
    dst, src = [], []
    for d, s in zip(jax_tree_leaves(dst_tree), jax_tree_leaves(src_tree)):
        if s is d or (s.numel() and s.data_ptr() == d.data_ptr()
                      and s.shape == d.shape):
            continue
        dst.append(d)
        src.append(s)
    if dst:
        torch._foreach_copy_(dst, src)
