"""Softmax attention in plain torch ops, and the ring over a sequence group.

Counterpart of ``theanompi_tpu/ops/ring_attention.py``:

* :func:`attention_reference` (``attn_impl='reference'``), which XLA ran as
  an einsum chain: f32 scores, an f32 softmax, output in q's dtype.
* :func:`ring_attention` (``:37-104`` there): exact attention with the
  sequence sharded over a process group (the ``seq`` group of
  ``base.Grid``), each rank holding one ``[B, H, T/n, hd]`` block of q, k
  and v.  The forward takes the local block, then n − 1 hops that rotate
  K/V one rank forward (rank i sends to i + 1 and receives from i − 1, so
  after j hops rank i holds the block of rank i − j), accumulating an f32
  online softmax with causal masking in GLOBAL positions (``NEG_INF`` on
  masked scores, masked p re-zeroed: a row with no valid key yet keeps
  ``m = NEG_INF``, where ``exp(s − m)`` would be 1).  The backward sends
  the gradient the other way round the ring: it walks the hops in reverse,
  each K/V block travelling one rank back with the dK/dV summed so far,
  so the block that rank i held at hop j reaches rank i − 1 for hop
  j − 1 and, at hop 0, its owner with its whole gradient.  p is rebuilt
  from the row statistic ``lse = m + log l`` (no [T, T] matrix is kept).
  The collectives are the group's own ``send``/``recv``, posted together
  each hop.  No TPU kernel: the JAX package runs the ring as jnp ops under
  ``lax.ppermute``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device softmax attention of ``[B, H, T, hd]`` q, k, v."""
    d = q.shape[-1]
    scale = (1.0 / (d ** 0.5)) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        valid = torch.arange(tq, device=s.device)[:, None] >= \
            torch.arange(tk, device=s.device)[None, :]
        s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _shift(tensors, group, to: int, frm: int):
    """Send each tensor to group rank ``to`` and receive its like from
    ``frm``, all posted before any wait."""
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    works = []
    for tag, (t, o) in enumerate(zip(tensors, outs)):
        works.append(group.send([t.contiguous()], to, tag))
        works.append(group.recv([o], frm, tag))
    for w in works:
        w.wait()
    return outs


def _valid(idx: int, src: int, t_loc: int, device) -> torch.Tensor:
    """``[t_loc, t_loc]``: a query of rank ``idx``'s block may see a key of
    rank ``src``'s (global positions)."""
    q_pos = idx * t_loc + torch.arange(t_loc, device=device)
    k_pos = src * t_loc + torch.arange(t_loc, device=device)
    return q_pos[:, None] >= k_pos[None, :]


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, idx = group.size(), group.rank()
        t_loc = q.shape[2]
        qf = q.float() * scale
        o = torch.zeros_like(qf)
        m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        kj, vj = k, v
        for j in range(n):
            if j:
                kj, vj = _shift((kj, vj), group, (idx + 1) % n,
                                (idx - 1) % n)
            src = (idx - j) % n
            s = torch.matmul(qf, kj.float().transpose(-1, -2))
            if causal:
                valid = _valid(idx, src, t_loc, q.device)
                s = torch.where(valid, s, torch.full((), NEG_INF,
                                                     device=q.device))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = torch.where(valid, p, torch.zeros((), device=q.device))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.matmul(p, vj.float())
            m = m_new
        out = o / l[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, idx = group.size(), group.rank()
        t_loc = q.shape[2]
        qf = q.float() * scale
        dof = do.float()
        di = (out * dof).sum(-1, keepdim=True)
        dq = torch.zeros_like(qf)
        back, ahead = (idx - 1) % n, (idx + 1) % n
        # the block held at the last hop, n - 1: rank idx + 1's
        kj, vj = (k, v) if n == 1 else _shift((k, v), group, back, ahead)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for j in range(n - 1, -1, -1):
            if j < n - 1:
                kj, vj, dk, dv = _shift((kj, vj, dk, dv), group, back, ahead)
            src = (idx - j) % n
            s = torch.matmul(qf, kj.float().transpose(-1, -2))
            p = torch.exp(s - lse[..., None])
            if causal:
                p = torch.where(_valid(idx, src, t_loc, q.device), p,
                                torch.zeros((), device=q.device))
            dv = dv + torch.matmul(p.transpose(-1, -2), dof)
            ds = p * (torch.matmul(dof, vj.float().transpose(-1, -2)) - di)
            dq = dq + torch.matmul(ds, kj.float())
            dk = dk + torch.matmul(ds.transpose(-1, -2), qf)
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's ``[B, H, T_local, hd]`` block of q, k
    and v with the sequence sharded over ``group`` (block i on group rank
    i), differentiable; returns this rank's block of the output in q's
    dtype.  ``scale`` defaults to ``1/sqrt(hd)``."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"ring_attention: q, k, v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} differ")
    d = q.shape[-1]
    scale = (1.0 / (d ** 0.5)) if scale is None else float(scale)
    return _RingAttention.apply(q, k, v, group, bool(causal), scale)
