"""Collective exchange strategies.

Counterpart of ``theanompi_tpu/parallel/strategies.py`` for ``NoComm``,
``AllReduce`` (with its bfloat16 wire) and the compressed wires with error
feedback, ``OneBit`` (signs), ``TopK`` (the largest entries of each chunk)
and ``PowerSGD`` (low-rank factors), on ``torch.distributed``: NCCL for
tensors on the card, gloo for CPU tensors, whichever group the process
initialized (``base.MeshProcess``).

Every strategy is called as ``strategy(tree, state, size=N)`` and returns
``(mean_tree, state)``: the **mean** of its input tree over the ranks,
and its per-rank state for the next step (``()`` for a stateless
strategy; ``init_state(params)`` makes the first: a flat tensor for onebit
and topk, a per-leaf list for PowerSGD).  The state is rewritten IN PLACE
and returned as the same object, every tensor of it too, so a captured
step (``parallel/graph.py``) finds the next step's state where the last
one left it.  ``NoComm`` and ``AllReduce`` reduce in place: the gradient
tensors they are handed hold the mean on return.

``Ring`` is the reference's hand-written alltoall-sum-allgather
(``Exch_asa32/asa16``, ``Exch_copper(16)``): a reduce-scatter, then an
allgather, over ``2(size − 1)`` point-to-point hops to the right
neighbour.

``bucket_bytes > 0`` (set by the exchanger from its config) splits each
strategy's collectives into ~``bucket_bytes`` slices
(``parallel/buckets.py``), every slice's collective started before the
first is waited on: ``AllReduce`` and PowerSGD's dense remainder by the
planner's buckets of leaves, onebit by aligned slices of its packed sign
rows (each decoded by B4 into its slice of the mean), topk by slices of
its chunk rows (each decoded by B8).  ``Ring`` is a chunk pipeline of
its own and does not bucket.
"""

from __future__ import annotations

import math
from itertools import accumulate
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..ops import compress as compress_ops
from ..ops import factor_pack
from ..utils.helper_funcs import (flatten_tree, flatten_tree_jax,
                                  jax_leaf_paths, jax_tree_leaves,
                                  leaf_paths, tree_leaves,
                                  tree_map, tree_size, unflatten_like,
                                  unflatten_like_jax)
from . import buckets

#: The deliberate roundings (the lint's dtype-flow reads this).
NONBITEXACT = {
    "Ring.__call__": "the chunk a rank owns is rounded to the wire dtype "
                     "before the allgather, so every rank, the owner too, "
                     "holds the same bits",
}


class Strategy:
    """Base: ``(tree, state, *, size) -> (mean_tree, new_state)``."""

    name = "base"
    stateful = False
    # True when the strategy works on one flattened vector, not leaf-wise
    flattens = False
    # True when its state is a list over the leaves (PowerSGD's)
    leafwise_state = False
    # paths of the 2-D leaves the JAX package stores in the port's layout
    # (the model's ``kept_layout_paths``, which the exchanger hands over);
    # every other 2-D leaf is the JAX one transposed
    kept_layout: frozenset = frozenset()
    # > 0: the collectives in ~bucket_bytes slices (``parallel/buckets.py``);
    # 0: the monolithic wire.  Set by the exchanger from its config
    bucket_bytes = 0

    def init_state(self, params) -> Any:
        """Per-rank persistent state, rewritten in place by each call."""
        return ()

    def n_buckets(self, params, bucket_bytes: int) -> Optional[int]:
        """Wire slices one exchange of a ``params``-shaped payload ships at
        ``bucket_bytes``: the planner's buckets of the float32 leaves here;
        the compressed wires count their packed layouts; None where the
        wire does not bucket."""
        return buckets.count_buckets(params, bucket_bytes)

    def __call__(self, tree, state, *, size: int):
        raise NotImplementedError


class NoComm(Strategy):
    """The per-rank mean WITHOUT the collective — for measuring what the
    exchange costs by difference.  Training with it breaks BSP: replicas
    diverge."""

    name = "none"

    def n_buckets(self, params, bucket_bytes: int):
        return None                       # no collective, nothing to slice

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        inv = 1.0 / size
        for g in tree_leaves(tree):
            g.mul_(inv)
        return tree, state


class AllReduce(Strategy):
    """``all_reduce`` sum, then ÷ size.  ``wire_dtype=torch.bfloat16``
    reduces a bfloat16 copy (cast → sum → cast back), the float32 master
    gradient untouched until the result lands in it."""

    def __init__(self, wire_dtype: Optional[torch.dtype] = None):
        self.wire_dtype = wire_dtype
        self.name = "allreduce" if wire_dtype is None else "allreduce16"

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        inv = 1.0 / size
        wd = self.wire_dtype
        if self.bucket_bytes > 0:
            # one asynchronous all-reduce a bucket, the wire cast per bucket
            buckets.bucketed_all_reduce(tree, self.bucket_bytes,
                                        wire_dtype=wd)
            torch._foreach_mul_(tree_leaves(tree), inv)
            return tree, state
        for g in tree_leaves(tree):
            if wd is None:
                dist.all_reduce(g)
                g.mul_(inv)
            else:
                w = g.to(wd)
                dist.all_reduce(w)
                g.copy_(w.to(g.dtype)).mul_(inv)
        return tree, state


class Ring(Strategy):
    """Explicit chunked ring: reduce-scatter, then allgather, over
    point-to-point hops (the reference's ``Exch_asa32/asa16`` and
    ``Exch_copper(16)``; the JAX package's ``Ring`` over ``ppermute``).

    The tree is flattened in the JAX package's order and layouts
    (``flatten_tree_jax``), padded to a multiple of ``size`` and split into
    ``size`` chunks, so that each element lands in the chunk it lands in
    there and its partial sums meet in the same order.  Each of the
    ``2(size − 1)`` hops sends one chunk to the right neighbour and
    receives one from the left, one ``batch_isend_irecv`` pair.  The
    accumulator is float32; ``wire_dtype=torch.bfloat16`` casts each hop's
    payload, and the chunk a rank owns is rounded to bfloat16 before the
    allgather, so that every rank, the owner too, holds the same bits.  At
    world 1 it returns the tree unchanged.  The route is fixed, so a
    captured step replays it."""

    flattens = True

    def __init__(self, wire_dtype: Optional[torch.dtype] = None):
        self.wire_dtype = wire_dtype
        self.name = "ring" if wire_dtype is None else "ring16"

    def n_buckets(self, params, bucket_bytes: int):
        # a chunk pipeline already: the planner does not re-slice it
        return None

    def _hop(self, cur: torch.Tensor, right: int, left: int) -> torch.Tensor:
        """``cur`` to the right neighbour; what the left one sent, as
        float32."""
        wd = self.wire_dtype
        send = cur if wd is None else cur.to(wd)
        got = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, right),
                                           dist.P2POp(dist.irecv, got, left)]):
            req.wait()
        return got if wd is None else got.float()

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        if size == 1:
            return tree, state
        rank = dist.get_rank()
        right, left = (rank + 1) % size, (rank - 1) % size
        flat = flatten_tree_jax(tree, pad_to_multiple_of=size,
                                kept=self.kept_layout)
        acc = flat.view(size, -1)
        # reduce-scatter: after hop s the partial sum of chunk
        # (rank − s − 1) holds s + 2 ranks' terms
        cur = acc[rank]
        for s in range(size - 1):
            idx = (rank - s - 1) % size
            cur = acc[idx].add_(self._hop(cur, right, left))
        mine = (rank + 1) % size
        out = torch.empty_like(acc)
        cur = torch.div(acc[mine], size, out=out[mine])
        if self.wire_dtype is not None:
            cur.copy_(cur.to(self.wire_dtype))
        # allgather: each hop forwards the chunk received last
        for s in range(size - 1):
            cur = out[(rank - s) % size]
            cur.copy_(self._hop(out[(rank - s + 1) % size], right, left))
        return unflatten_like_jax(tree, out.view(-1), self.kept_layout), state


def _all_gather(t: torch.Tensor, size: int) -> torch.Tensor:
    """``[size, *t.shape]``: every rank's ``t``, in rank order."""
    out = t.new_empty((size,) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t)
    return out


class OneBit(Strategy):
    """1-bit sign compression with error feedback (BASELINE.json config 5).

    Each rank adds its carried error to its gradient, ``c = g + state``,
    sends the sign bits of ``c`` (packed 32 to a word) and one scale,
    ``mean|c|``, and keeps the residual ``c − scale·sign(c)`` as the next
    step's state.  Every rank decodes the same gathered bits and scales, so
    all ranks apply the same mean.  On the card the three passes are the
    kernels B5 (encode), B6 (residual) and B4 (decode) of
    ``ops/compress.py``; no value is read back to the host."""

    name = "onebit"
    stateful = True
    flattens = True

    def init_state(self, params) -> torch.Tensor:
        n = tree_size(params)
        padded = n + (-n) % compress_ops.PACK_ALIGN
        dev = tree_leaves(params)[0].device
        return torch.zeros(padded, dtype=torch.float32, device=dev)

    @staticmethod
    def _segment_elems(bucket_bytes: int) -> int:
        """float32 elements a wire bucket decodes, rounded down to whole
        pack blocks (PACK_ALIGN): its packed rows are then a multiple of 8,
        as B4 takes them, and the blockwise pack and decode make the
        bucketed mean the monolithic one bit for bit."""
        return max(compress_ops.PACK_ALIGN,
                   (int(bucket_bytes) // 4 // compress_ops.PACK_ALIGN)
                   * compress_ops.PACK_ALIGN)

    def n_buckets(self, params, bucket_bytes: int):
        n = tree_size(params)
        n += (-n) % compress_ops.PACK_ALIGN
        return max(1, -(-n // self._segment_elems(bucket_bytes)))

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        flat = flatten_tree(tree, pad_to_multiple_of=compress_ops.PACK_ALIGN)
        n_true = tree_size(tree)
        packed, absc = compress_ops.pack_signs_encode(flat, state)
        # the scale over the true length: the zero pad would deflate it
        scale = absc[:n_true].mean() + 1e-12
        compress_ops.signed_residual(absc, packed, scale, out=state)
        all_scales = _all_gather(scale, size)          # [size]
        if self.bucket_bytes > 0:
            # packed once; each bucket gathers its aligned slice of packed
            # rows (all started before the first wait) and B4 decodes it,
            # with the global scales, into its slice of one mean
            rows = self._segment_elems(self.bucket_bytes) // (
                32 * compress_ops.LANES)
            words = 32 * compress_ops.LANES
            mean = torch.empty_like(flat)
            tickets = [(a, buckets.all_gather_start(packed[a:a + rows], size))
                       for a in range(0, packed.shape[0], rows)]
            for a, t in tickets:
                got = buckets.all_gather_done(t)
                compress_ops.unpack_signs_weighted_mean(
                    got, all_scales, size,
                    out=mean[a * words:(a + got.shape[1]) * words])
        else:
            all_packed = _all_gather(packed, size)     # n/8 bytes per rank
            mean = compress_ops.unpack_signs_weighted_mean(
                all_packed, all_scales, size)
        return unflatten_like(tree, mean), state


def _topk_wire_start(vals: torch.Tensor, idx: torch.Tensor, size: int):
    """Start gathering all ranks' (bf16 values, int16 offsets) [rows, k].

    Neither NCCL nor gloo gathers int16, so each slot travels as one int32
    word holding the value's bits and the offset's (the int16 pair
    ``[value, offset]`` read as one word): 4 bytes per slot, the JAX
    package's wire bytes."""
    wire = torch.stack([vals.view(torch.int16), idx], dim=-1)   # [rows, k, 2]
    return buckets.all_gather_start(wire.view(torch.int32).squeeze(-1), size)


def _topk_wire_done(ticket):
    """The gathered (values, offsets) [size, rows, k], in rank order."""
    got = buckets.all_gather_done(ticket)
    pairs = got.view(torch.int16).unflatten(-1, (-1, 2))     # [size, rows, k, 2]
    return (pairs[..., 0].view(torch.bfloat16).contiguous(),
            pairs[..., 1].contiguous())


class TopK(Strategy):
    """Chunk-local top-k sparsification with error feedback
    (BASELINE.json config 5, beside onebit).

    ``c = g + state`` in the JAX package's flat order
    (``helper_funcs.flatten_tree_jax``) is viewed as ``[n / chunk, chunk]``
    rows; each rank sends the ``k_c = ratio·chunk`` largest |c| of every
    row as bf16 values and int16 offsets, and keeps ``c`` with the bf16
    rounding residual written over the sent entries as the next step's
    state.  Every rank decodes the same gathered rows into the same mean.
    On the card the encode and the decode are the kernels B7 and B8 of
    ``ops/compress.py``.  Wire bytes per rank: 4·k_c per row, ~5.5 MB a
    step for VGG-16 (onebit: 17.3 MB; float32: 553 MB)."""

    name = "topk"
    stateful = True
    flattens = True

    CHUNK = 8192          # ≤ 2^15 for int16 offsets

    def __init__(self, ratio: float = 0.01, k: Optional[int] = None,
                 chunk: Optional[int] = None):
        self.ratio = ratio
        self.k = k                    # per-row override (mostly for tests)
        self.chunk = int(chunk or self.CHUNK)
        # signed int16 offsets: anything past 2^15 − 1 would wrap negative
        assert self.chunk <= 1 << 15, "int16 offsets need chunk ≤ 32768"

    def init_state(self, params) -> torch.Tensor:
        n = tree_size(params)
        dev = tree_leaves(params)[0].device
        return torch.zeros(n + (-n) % self.chunk, dtype=torch.float32,
                           device=dev)

    def _k_c(self) -> int:
        """Selected entries per chunk row."""
        return self.k or max(1, int(round(self.chunk * self.ratio)))

    @staticmethod
    def _rows_per_bucket(k_c: int, bucket_bytes: int) -> int:
        """Chunk rows a wire bucket carries: a row ships 4·k_c bytes."""
        return max(1, int(bucket_bytes) // (4 * k_c))

    def n_buckets(self, params, bucket_bytes: int):
        n = tree_size(params)
        n_chunks = -(-n // self.chunk)
        return max(1, -(-n_chunks // self._rows_per_bucket(self._k_c(),
                                                           bucket_bytes)))

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        c = flatten_tree_jax(tree, pad_to_multiple_of=self.chunk,
                             kept=self.kept_layout)
        c.add_(state)                                  # c = flat + state
        wire_vals, wire_idx, _ = compress_ops.topk_encode(
            c.view(-1, self.chunk), self._k_c(),
            out=state.view(-1, self.chunk))
        if self.bucket_bytes > 0:
            # each bucket's chunk rows gathered (all started before the
            # first wait) and decoded by B8 into their own rows of one
            # mean: chunk r only ever lands in [r·chunk, (r+1)·chunk)
            rows = self._rows_per_bucket(wire_vals.shape[1],
                                         self.bucket_bytes)
            mean = torch.empty_like(c)
            tickets = [(a, _topk_wire_start(wire_vals[a:a + rows],
                                            wire_idx[a:a + rows], size))
                       for a in range(0, wire_vals.shape[0], rows)]
            for a, t in tickets:
                all_vals, all_idx = _topk_wire_done(t)
                compress_ops.topk_decode(
                    all_vals, all_idx, self.chunk, size,
                    out=mean[a * self.chunk:
                             (a + all_vals.shape[1]) * self.chunk])
        else:
            all_vals, all_idx = _topk_wire_done(
                _topk_wire_start(wire_vals, wire_idx, size))
            mean = compress_ops.topk_decode(all_vals, all_idx, self.chunk,
                                            size)
        return unflatten_like_jax(tree, mean, self.kept_layout), state


class PowerSGD(Strategy):
    """Rank-r low-rank compression with error feedback (PowerSGD, Vogels
    et al. 2019, arXiv:1905.13727).  Per matrix-shaped leaf, with the
    leaf's error ``e`` and a shared warm-started ``Q``:

        M' = M + e;  P = mean(M' Q);  P̂ = qr(P).Q;  Q' = mean(M'ᵀ P̂)
        M̂ = P̂ Q'ᵀ;   e' = M' − M̂

    The JAX package's ``M`` is its leaf in its layout,
    ``leaf.reshape(-1, shape[-1])``.  The port keeps the leaf in PyTorch's
    layout, ``A = leaf.reshape(shape[0], -1)``.  For a conv or FC weight
    that is ``M`` transposed (for a conv, with M's rows permuted, which P̂'s
    span and so M̂ do not depend on), so ``P = Aᵀ Q``, ``Q' = A P̂`` and
    ``M̂ᵀ = Q' P̂ᵀ``.  A leaf in ``kept_layout`` (an embedding table, a
    MoE layer's ``[E, d, f]`` expert weights) keeps its layout in both
    packages, so ``A`` is ``M`` itself, ``leaf.reshape(-1, shape[-1])``,
    and ``P = A Q``, ``Q' = Aᵀ P̂``, ``M̂ = P̂ Q'ᵀ``.  ``e`` keeps the leaf's own
    shape.  All P factors are one call of B9 (``ops/factor_pack.py``
    ``matmul_pack_group``, each leaf with its transpose flag), which writes
    them into one zero-padded staging buffer for one ``all_reduce``; then
    all Q factors likewise; leaves too small to win (vectors, and
    min(rows, cols) ≤ 4r) are reduced exactly.  ``torch.linalg.qr`` and
    the decode product are library calls, as in the JAX package they are
    XLA's.

    State: a list over the leaves in the port's order (``tree_leaves``),
    ``{"q": [cols of M, r], "e": leaf shape}``, empty for an incompressible
    leaf.  The first ``q`` of leaf ``i`` is drawn from a generator seeded
    ``1905 + i`` on the CPU, the same on every rank (the JAX package's
    distribution; other bits)."""

    stateful = True
    flattens = False
    leafwise_state = True

    def __init__(self, rank: int = 2):
        self.rank = int(rank)
        assert self.rank >= 1
        self.name = f"powersgd{self.rank}"

    def _matrix(self, shape, path=None) -> tuple:
        """The shape of A, the leaf at ``path`` as a matrix: M for a leaf
        in ``kept_layout`` (all but the last dim by the last), else
        ``shape[0]`` by the rest (Mᵀ)."""
        if path in self.kept_layout:
            return math.prod(shape[:-1]), int(shape[-1])
        return int(shape[0]), math.prod(shape[1:])

    def _compressible(self, shape, path=None) -> bool:
        """The JAX package's ``min(rows, cols) > 4r`` on its matrix M,
        taken on A, which is M or Mᵀ."""
        if len(shape) < 2:
            return False
        return min(self._matrix(shape, path)) > 4 * self.rank

    def n_buckets(self, params, bucket_bytes: int):
        # the factor all-reduces are one stacked collective each already;
        # the planner buckets the dense remainder
        dense = self._dense(params)
        return buckets.count_buckets(dense, bucket_bytes) if dense else 0

    def _dense(self, tree) -> list:
        """The incompressible leaves, in the JAX package's leaf order."""
        return [l for p, l in zip(jax_leaf_paths(tree), jax_tree_leaves(tree))
                if not self._compressible(l.shape, p)]

    def init_state(self, params) -> list:
        state = []
        for i, (path, l) in enumerate(zip(leaf_paths(params),
                                          tree_leaves(params))):
            if self._compressible(l.shape, path):
                rows, cols = self._matrix(l.shape, path)
                if path not in self.kept_layout:
                    cols = rows                 # M's columns are A's rows
                gen = torch.Generator().manual_seed(1905 + i)
                q = torch.randn((cols, self.rank), generator=gen)
                state.append({"q": q.to(l.device),
                              "e": torch.zeros(l.shape, dtype=torch.float32,
                                               device=l.device)})
            else:
                state.append({
                    "q": torch.zeros((0, self.rank), device=l.device),
                    "e": torch.zeros((0, 0), device=l.device)})
        return state

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        inv = 1.0 / size
        leaves = tree_leaves(tree)
        assert len(leaves) == len(state), (len(leaves), len(state))
        out = list(leaves)
        paths = leaf_paths(tree)
        comp = [i for i, g in enumerate(leaves)
                if self._compressible(g.shape, paths[i])]
        # A is M transposed, except for a leaf kept in the JAX layout,
        # where it is M
        flip = {i: paths[i] not in self.kept_layout for i in comp}

        def stacked_mean(buf):
            dist.all_reduce(buf)
            return buf.mul_(inv)

        if comp:
            # A' = g + e in the leaf's layout, as the matrix A
            mats = [(leaves[i].float() + state[i]["e"]).reshape(
                self._matrix(leaves[i].shape, paths[i])) for i in comp]
            # P = M' Q and Q' = M'ᵀ P̂, with M' = A'ᵀ or A'
            m_shape = [m.shape[::-1] if flip[i] else m.shape
                       for i, m in zip(comp, mats)]
            # each factor's first row in its staging buffer
            p_off = accumulate((factor_pack.pad_rows(s[0]) for s in m_shape),
                               initial=0)
            q_off = accumulate((factor_pack.pad_rows(s[1]) for s in m_shape),
                               initial=0)
            p_all = stacked_mean(factor_pack.matmul_pack_group(
                mats, [state[i]["q"] for i in comp],
                [flip[i] for i in comp]))
            phs = [torch.linalg.qr(p_all[o:o + s[0]]).Q.contiguous()
                   for o, s in zip(p_off, m_shape)]
            q_all = stacked_mean(factor_pack.matmul_pack_group(
                mats, phs, [not flip[i] for i in comp]))
            for i, m, s, ph, o in zip(comp, mats, m_shape, phs, q_off):
                g = leaves[i]
                qn = q_all[o:o + s[1]]
                # M̂ in A's layout: M̂ᵀ = Q' P̂ᵀ, or M̂ = P̂ Q'ᵀ
                mhat = qn @ ph.t() if flip[i] else ph @ qn.t()
                out[i] = mhat.view(g.shape).to(g.dtype)
                state[i]["q"].copy_(qn)
                torch.sub(m, mhat, out=state[i]["e"].view(m.shape))

        # the dense remainder, reduced in place: one all-reduce a leaf, or
        # the planner's buckets of it
        dense = self._dense(tree)
        if dense:
            buckets.bucketed_all_reduce(dense, self.bucket_bytes)
            torch._foreach_mul_(dense, inv)
        it = iter(out)
        return tree_map(lambda _: next(it), tree), state


def get_strategy(name: str, **kwargs) -> Strategy:
    """Resolve a strategy by its reference-compatible config string;
    ``kwargs`` go to ``topk`` and ``powersgd``."""
    name = name.lower()
    table = {
        "none": NoComm,
        "nocomm": NoComm,
        "allreduce": AllReduce,
        "ar": AllReduce,
        "nccl32": AllReduce,
        "nccl16": lambda: AllReduce(wire_dtype=torch.bfloat16),
        "bf16": lambda: AllReduce(wire_dtype=torch.bfloat16),
        "asa32": Ring,
        "ring": Ring,
        "copper": Ring,
        "asa16": lambda: Ring(wire_dtype=torch.bfloat16),
        "ring16": lambda: Ring(wire_dtype=torch.bfloat16),
        "copper16": lambda: Ring(wire_dtype=torch.bfloat16),
        "onebit": OneBit,
        "compressed": OneBit,
        "topk": lambda: TopK(**kwargs),
        "powersgd": lambda: PowerSGD(**kwargs),
    }
    if name.startswith("powersgd") and name[8:].isdigit():
        # 'powersgd4' etc.; an explicit rank kwarg must not silently lose
        assert "rank" not in kwargs or int(kwargs["rank"]) == int(name[8:]), \
            f"strategy name {name!r} conflicts with rank={kwargs['rank']}"
        return PowerSGD(rank=int(name[8:]))
    try:
        return table[name]()
    except KeyError:
        raise ValueError(f"unknown exchange strategy {name!r}; have "
                         f"{sorted(table)}")
