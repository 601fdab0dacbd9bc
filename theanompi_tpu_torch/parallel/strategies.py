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
                                  leaf_paths, tree_leaves, tree_map,
                                  tree_size, unflatten_like,
                                  unflatten_like_jax)


class Strategy:
    """Base: ``(tree, state, *, size) -> (mean_tree, new_state)``."""

    name = "base"
    stateful = False
    # True when the strategy works on one flattened vector, not leaf-wise
    flattens = False
    # paths of the 2-D leaves the JAX package stores in the port's layout
    # (the model's ``kept_layout_paths``, which the exchanger hands over);
    # every other 2-D leaf is the JAX one transposed
    kept_layout: frozenset = frozenset()

    def init_state(self, params) -> Any:
        """Per-rank persistent state, rewritten in place by each call."""
        return ()

    def __call__(self, tree, state, *, size: int):
        raise NotImplementedError


class NoComm(Strategy):
    """The per-rank mean WITHOUT the collective — for measuring what the
    exchange costs by difference.  Training with it breaks BSP: replicas
    diverge."""

    name = "none"

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
        for g in tree_leaves(tree):
            if wd is None:
                dist.all_reduce(g)
                g.mul_(inv)
            else:
                w = g.to(wd)
                dist.all_reduce(w)
                g.copy_(w.to(g.dtype)).mul_(inv)
        return tree, state


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

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        flat = flatten_tree(tree, pad_to_multiple_of=compress_ops.PACK_ALIGN)
        n_true = tree_size(tree)
        packed, absc = compress_ops.pack_signs_encode(flat, state)
        # the scale over the true length: the zero pad would deflate it
        scale = absc[:n_true].mean() + 1e-12
        compress_ops.signed_residual(absc, packed, scale, out=state)
        all_scales = _all_gather(scale, size)          # [size]
        all_packed = _all_gather(packed, size)         # n/8 bytes per rank
        mean = compress_ops.unpack_signs_weighted_mean(all_packed, all_scales,
                                                       size)
        return unflatten_like(tree, mean), state


def _gather_topk_wire(vals: torch.Tensor, idx: torch.Tensor, size: int):
    """All ranks' (bf16 values, int16 offsets) [rows, k], in rank order.

    Neither NCCL nor gloo gathers int16, so each slot travels as one int32
    word holding the value's bits and the offset's (the int16 pair
    ``[value, offset]`` read as one word): 4 bytes per slot, the JAX
    package's wire bytes."""
    wire = torch.stack([vals.view(torch.int16), idx], dim=-1)   # [rows, k, 2]
    got = _all_gather(wire.view(torch.int32).squeeze(-1), size)
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

    @torch.no_grad()
    def __call__(self, tree, state, *, size: int):
        c = flatten_tree_jax(tree, pad_to_multiple_of=self.chunk,
                             kept=self.kept_layout)
        c.add_(state)                                  # c = flat + state
        wire_vals, wire_idx, _ = compress_ops.topk_encode(
            c.view(-1, self.chunk), self._k_c(),
            out=state.view(-1, self.chunk))
        all_vals, all_idx = _gather_topk_wire(wire_vals, wire_idx, size)
        mean = compress_ops.topk_decode(all_vals, all_idx, self.chunk, size)
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
    ``M̂ᵀ = Q' P̂ᵀ``.  A leaf in ``kept_layout`` (an embedding table)
    keeps its layout in both packages, so ``A`` is ``M`` itself and
    ``P = A Q``, ``Q' = Aᵀ P̂``, ``M̂ = P̂ Q'ᵀ``.  ``e`` keeps the leaf's own
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

    def __init__(self, rank: int = 2):
        self.rank = int(rank)
        assert self.rank >= 1
        self.name = f"powersgd{self.rank}"

    def _compressible(self, shape) -> bool:
        """The JAX package's ``min(rows, cols) > 4r`` on its matrix M, taken
        on A (``shape[0]`` by the rest), which is M or Mᵀ."""
        if len(shape) < 2:
            return False
        return min(math.prod(shape[1:]), int(shape[0])) > 4 * self.rank

    def init_state(self, params) -> list:
        state = []
        for i, (path, l) in enumerate(zip(leaf_paths(params),
                                          tree_leaves(params))):
            if self._compressible(l.shape):
                cols = l.shape[1] if path in self.kept_layout else l.shape[0]
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
        comp = [i for i, g in enumerate(leaves)
                if self._compressible(g.shape)]
        paths = leaf_paths(tree)
        # A is M transposed, except for a leaf kept in the JAX layout,
        # where it is M
        flip = {i: paths[i] not in self.kept_layout for i in comp}

        def stacked_mean(buf):
            dist.all_reduce(buf)
            return buf.mul_(inv)

        if comp:
            # A' = g + e in the leaf's layout, [shape[0], rest]
            mats = [(leaves[i].float() + state[i]["e"]).reshape(
                leaves[i].shape[0], -1) for i in comp]
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

        for i, g in enumerate(leaves):
            if i not in comp:
                dist.all_reduce(g)
                g.mul_(inv)
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
        raise ValueError(f"unknown or not yet ported exchange strategy "
                         f"{name!r}; have {sorted(table)}")
