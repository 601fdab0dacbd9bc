"""Pipeline parallelism: fill/drain and interleaved microbatch pipelining
over a ``pipe`` group of ranks.

Counterpart of ``theanompi_tpu/parallel/pipeline.py``.  The transformer's
homogeneous block stack is split over ``pp`` pipeline stages (the ``pipe``
group of ``base.Grid``); microbatches stream through the stages with one
send/receive hop a tick.

The schedule is the JAX package's table, a pure function of ``(pp, v, M)``
(:func:`build_schedule`, copied with :func:`stage_permutation`,
:func:`_validate`, :func:`microbatch` and :func:`unmicrobatch`):

* **Fill/drain** (``interleave=1``): each rank holds ``L/pp`` consecutive
  layers; ``M + pp − 1`` ticks; the hop is the partial shift ``i → i+1``.
* **Interleaved virtual stages** (``interleave=v > 1``): each rank holds
  ``v`` chunks of ``L/(pp·v)`` layers, chunk ``k`` of rank ``r`` being
  global stage ``k·pp + r``; ``v·M + pp − 1`` ticks over the full ring.
  The stacked layer rows are in :func:`stage_permutation` order, so a
  rank's contiguous rows are its chunks.

:func:`pipeline_apply` walks the table tick by tick on every rank of the
pipe group: global stage 0 (rank 0) injects the tick's microbatch, every
other slot takes the state received at the last hop; a rank runs chunk
``chunk[t, rank]`` only where ``real[t, rank]`` is set (a bubble tick
passes its input on); the last rank collects the final stage's outputs,
broadcast to the group at the end.  Each hop posts its send and its
receive together, as ``ops/ring_attention._shift`` does.

The backward is driven by hand (:class:`_Pipeline`, an
``autograd.Function``).  The forward keeps only each real tick's input,
and the backward recomputes each chunk's forward (the JAX package's
``remat=True``, which its LM leaves on) and walks the ticks in reverse:
each rank takes dOut from its successor (plus, on the last rank, the
collected slot's gradient), back-propagates the chunk, and sends dIn to
its predecessor.  Every rank thus posts the same sequence of hops, which
autograd's own order of nodes would not guarantee (a hop whose received
state feeds nothing on a rank would never run its backward there).  The
gradient of the injected microbatches, rank 0's, is broadcast to the
group, as the JAX transpose-psum of the pipe-replicated input gives it
(every pipe rank's embedding gradient is then the dense model's).
``with_aux`` carries a stage's scalar (the MoE's load-balance loss),
summed over the real ticks and over the group.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class Schedule(NamedTuple):
    """The per-tick schedule table (``pipeline.py:69`` there): per tick and
    rank ``chunk`` (which local chunk runs), ``real`` (does the slot carry
    a microbatch), ``micro`` (which one); per tick ``inject_idx`` /
    ``inject`` (global stage 0's feed) and ``collect_idx`` / ``collect``
    (the last global stage's output slot); ``perm`` the hop, ``(src,
    dst)`` pairs: the partial shift at ``v = 1``, the full ring above."""

    pp: int
    v: int
    m: int
    ticks: int
    chunk: np.ndarray
    real: np.ndarray
    micro: np.ndarray
    inject_idx: np.ndarray
    inject: np.ndarray
    collect_idx: np.ndarray
    collect: np.ndarray
    perm: Tuple[Tuple[int, int], ...]


def build_schedule(pp: int, v: int, m: int) -> Schedule:
    """The schedule table for ``pp`` ranks × ``v`` virtual chunks × ``m``
    microbatches (the JAX package's, array for array)."""
    pp, v, m = int(pp), int(v), int(m)
    if pp < 1 or v < 1 or m < 1:
        raise ValueError(f"build_schedule: pp={pp}, v={v}, m={m} must all "
                         "be >= 1")
    if v == 1:
        ticks = m + pp - 1
        t = np.arange(ticks)
        u = t[:, None] - np.arange(pp)[None, :]          # microbatch t-rank
        real = (u >= 0) & (u < m)
        chunk = np.zeros((ticks, pp), np.int32)
        micro = np.clip(u, 0, m - 1).astype(np.int32)
        inject_idx = np.clip(t, 0, m - 1).astype(np.int32)
        inject = np.ones(ticks, bool)
        collect_idx = np.clip(t - (pp - 1), 0, m - 1).astype(np.int32)
        collect = t >= pp - 1
        perm = tuple((i, i + 1) for i in range(pp - 1))
    else:
        if m % pp:
            raise ValueError(
                f"build_schedule: interleaved collect needs the microbatch "
                f"count divisible by pp — n_micro={m} % pp={pp} != 0 "
                f"(raise/align the 'pp_microbatches' config knob)")
        groups = m // pp
        span = v * pp                 # ticks one microbatch group occupies
        ticks = groups * span + pp - 1
        u = np.arange(ticks)[:, None] - np.arange(pp)[None, :]
        real = (u >= 0) & (u < groups * span)
        q = np.mod(u, span)
        chunk = np.where(real, q // pp, 0).astype(np.int32)
        micro = np.where(real, (u // span) * pp + np.mod(u, pp), 0)
        micro = np.clip(micro, 0, m - 1).astype(np.int32)
        # the wrap from the last rank re-enters rank 0 as its next chunk's
        # input; injection replaces it only on chunk-0 ticks, when the
        # wrapped value is an output already collected
        inject = real[:, 0] & (q[:, 0] < pp)
        inject_idx = np.where(inject, micro[:, 0], 0).astype(np.int32)
        collect = real[:, -1] & (q[:, -1] // pp == v - 1)
        collect_idx = np.where(collect, micro[:, -1], 0).astype(np.int32)
        perm = tuple((i, (i + 1) % pp) for i in range(pp))
    return Schedule(pp, v, m, ticks, chunk, real, micro, inject_idx, inject,
                    collect_idx, collect, perm)


def stage_permutation(n_layer: int, pp: int, v: int) -> np.ndarray:
    """Stacked row → depth-order layer of the interleaved layout: rank
    ``r`` holds rows ``[r·L/pp, (r+1)·L/pp)``, its chunks ``k`` (global
    stage ``k·pp + r``) in order.  The identity at ``v = 1``."""
    n_layer, pp, v = int(n_layer), int(pp), int(v)
    if n_layer % (pp * v):
        raise ValueError(
            f"stage_permutation: n_layer={n_layer} not divisible by "
            f"pp*v={pp * v} (config knobs 'n_layer', 'pp', 'pp_interleave')")
    c = n_layer // (pp * v)
    return np.asarray([(k * pp + r) * c + i
                       for r in range(pp) for k in range(v)
                       for i in range(c)], dtype=np.int64)


def _validate(pp: int, v: int, m: int, local_layers: int) -> None:
    """Errors for degenerate schedules, each naming its config knob."""
    if m < pp:
        raise ValueError(
            f"pipeline_apply: n_micro={m} < pp={pp} — the schedule is all "
            f"warm-up/drain bubble and some stages never see a real "
            f"microbatch; raise the 'pp_microbatches' config knob to at "
            f"least pp (default 2*pp)")
    if v > 1:
        if m % pp:
            raise ValueError(
                f"pipeline_apply: interleaved collect streams microbatches "
                f"in groups of pp — n_micro={m} is not divisible by "
                f"pp={pp}; align the 'pp_microbatches' config knob")
        if local_layers % v:
            raise ValueError(
                f"pipeline_apply: {local_layers} local layers do not split "
                f"into pp_interleave={v} chunks — n_layer must be "
                f"divisible by pp*pp_interleave (config knobs 'n_layer', "
                f"'pp_interleave')")


def microbatch(x, n_micro: int):
    """Split the leading batch dim into ``[n_micro, b/n_micro, ...]``."""
    b = x.shape[0]
    assert b % n_micro == 0, \
        f"batch {b} not divisible by pp_microbatches={n_micro}"
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(y):
    return y.reshape((-1,) + tuple(y.shape[2:]))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _hop(t: torch.Tensor, group, to: Optional[int],
         frm: Optional[int]) -> Optional[torch.Tensor]:
    """Send ``t`` to group rank ``to`` and receive its like from ``frm``
    (either may be None), both posted before any wait; the received tensor
    or None."""
    works, out = [], None
    if to is not None:
        works.append(group.send([t.contiguous()], to, 0))
    if frm is not None:
        out = torch.empty_like(t)
        works.append(group.recv([out], frm, 0))
    for w in works:
        w.wait()
    return out


def _broadcast(t: torch.Tensor, group, root: int) -> torch.Tensor:
    """``t`` of group rank ``root`` on every rank (in place)."""
    import torch.distributed as dist
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    group.broadcast([t], opts).wait()
    return t


class _Plan:
    """What one call needs besides tensors: the schedule, this rank, its
    ring neighbours and the chunk function."""

    def __init__(self, stage_fn, group, v, m, local_layers, with_aux):
        self.pp = 1 if group is None else group.size()
        self.rank = 0 if group is None else group.rank()
        self.v = 1 if self.pp == 1 else int(v)
        _validate(self.pp, self.v, m, local_layers)
        self.sched = build_schedule(self.pp, self.v, m)
        self.c = local_layers // self.v
        self.group, self.stage_fn, self.with_aux = group, stage_fn, with_aux
        dst = dict(self.sched.perm)
        src = {d: s for s, d in self.sched.perm}
        self.succ, self.pred = dst.get(self.rank), src.get(self.rank)
        self.last = self.pp - 1

    def chunk(self, leaves, k: int) -> list:
        """Chunk ``k``'s rows of the local stacked leaves."""
        return [l[k * self.c:(k + 1) * self.c] for l in leaves]

    def run(self, rows, x):
        """The chunk on ``x``: ``(y, aux)`` (aux None without with_aux)."""
        out = self.stage_fn(rows, x)
        return out if self.with_aux else (out, None)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plan: _Plan, x_micro, *leaves):
        s, r = plan.sched, plan.rank
        state = torch.zeros_like(x_micro[0])
        outputs = torch.zeros_like(x_micro)
        aux_acc = torch.zeros((), dtype=torch.float32, device=x_micro.device)
        saved = {}
        for t in range(s.ticks):
            inp = x_micro[int(s.inject_idx[t])] \
                if r == 0 and s.inject[t] else state
            if s.real[t, r]:
                k = int(s.chunk[t, r])
                out, aux = plan.run(plan.chunk(leaves, k), inp)
                if aux is not None:
                    aux_acc = aux_acc + aux.float()
                saved[t] = inp
            else:
                out = inp
            if r == plan.last and s.collect[t]:
                outputs[int(s.collect_idx[t])] = out
            if t + 1 < s.ticks and plan.group is not None:
                got = _hop(out, plan.group, plan.succ, plan.pred)
                state = torch.zeros_like(out) if got is None else got
        if plan.group is not None:
            # only the last rank collected: its outputs on every rank, and
            # the aux summed over the stages
            _broadcast(outputs, plan.group, plan.last)
            if plan.with_aux:
                from .tp import all_reduce
                aux_acc = all_reduce(aux_acc, plan.group)
        ctx.plan, ctx.saved = plan, saved
        ctx.save_for_backward(*leaves)
        return outputs, aux_acc

    @staticmethod
    def backward(ctx, g_outputs, g_aux):
        plan, saved = ctx.plan, ctx.saved
        leaves = [l.detach() for l in ctx.saved_tensors]
        s, r = plan.sched, plan.rank
        g_x = torch.zeros((s.m,) + tuple(g_outputs.shape[1:]),
                          dtype=g_outputs.dtype, device=g_outputs.device)
        # per chunk, its rows as leaves of their own: each real tick's
        # recomputed graph accumulates into their .grad
        chunks = [[x.detach().requires_grad_(True)
                   for x in plan.chunk(leaves, k)] for k in range(plan.v)]
        g_recv = None
        for t in reversed(range(s.ticks)):
            g = g_recv
            if r == plan.last and s.collect[t]:
                y = g_outputs[int(s.collect_idx[t])]
                g = y if g is None else g + y
            if g is None:
                g = torch.zeros_like(g_outputs[0])
            if s.real[t, r]:
                k = int(s.chunk[t, r])
                inp = saved.pop(t).detach().requires_grad_(True)
                with torch.enable_grad():
                    out, aux = plan.run(chunks[k], inp)
                outs, grads = [out], [g]
                if aux is not None and g_aux is not None:
                    outs.append(aux.float())
                    grads.append(g_aux)
                torch.autograd.backward(outs, grads,
                                        inputs=[inp] + chunks[k])
                g = inp.grad
            if r == 0 and s.inject[t]:
                if s.real[t, 0]:
                    g_x[int(s.inject_idx[t])] = g
                g = torch.zeros_like(g)
            if t > 0 and plan.group is not None:
                g_recv = _hop(g, plan.group, plan.pred, plan.succ)
        if plan.group is not None:
            _broadcast(g_x, plan.group, 0)
        g_leaves = []
        for j, l in enumerate(leaves):
            parts = [chunks[k][j].grad for k in range(plan.v)]
            parts = [torch.zeros_like(chunks[k][j]) if p is None else p
                     for k, p in enumerate(parts)]
            g_leaves.append(parts[0] if plan.v == 1 else torch.cat(parts))
        return (None, g_x) + tuple(g_leaves)


def pipeline_apply(stage_fn: Callable, stage_params: List[torch.Tensor],
                   x_micro: torch.Tensor, group=None, *,
                   with_aux: bool = False, interleave: int = 1):
    """Stream ``x_micro`` (``[M, mb, ...]``, the same on every rank of the
    pipe ``group``) through the stages; returns the ``[M, mb, ...]``
    outputs on every rank (and, ``with_aux``, the stages' aux summed over
    the real ticks and the group).

    ``stage_fn(rows, x)`` applies a contiguous run of layers to one
    microbatch (same shape in and out): ``rows`` are ``stage_params``
    (this rank's stacked leaves, a leading local layer dim, in
    :func:`stage_permutation` order at ``interleave > 1``) cut to the
    chunk's rows; with ``with_aux`` it returns ``(y, aux_scalar)``.
    ``group`` None is one stage.  Every chunk's forward is recomputed in
    the backward (the JAX package's default ``remat=True``)."""
    leaves = list(stage_params)
    plan = _Plan(stage_fn, group, interleave, int(x_micro.shape[0]),
                 int(leaves[0].shape[0]), with_aux)
    out, aux = _Pipeline.apply(plan, x_micro, *leaves)
    return (out, aux) if with_aux else out
