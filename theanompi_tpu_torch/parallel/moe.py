"""Mixture of experts at one expert shard.

Counterpart of ``theanompi_tpu/parallel/moe.py``'s ``MoE`` at ``ep = 1``
and ``seq_shards = 1``: a top-k mixture of 2-layer MLP experts with the
Switch (top-1) or GShard (top-2) routing, its capacity and its load-balance
loss.  Expert parallelism (``ep > 1``, over the JAX package's ``'model'``
axis) and the sequence-sharded all-to-all dispatch wait with tensor and
sequence parallelism.

The JAX layer dispatches through a one-hot ``[N, E, C]`` tensor and two
einsums; at the LM's validation batch (8192 tokens, E = 4, C = N at
inference) that one-hot is 1 GiB of float32 a block.  Each kept slot holds
exactly one token, so the port dispatches by index instead: every
(token, choice) that keeps its slot is copied into row ``e·C + c`` of an
``[E·C + 1, d]`` buffer (the dropped ones into the last row, which nothing
reads), the experts run as batched products over ``[E, C, d]``, and the
combine gathers each choice's slot back and sums the k gated rows in
choice order, in float32.  The picks are exact, so at float32 the layer
equals the JAX one to the products' summation order.  No index depends on
a value read back to the host: the step stays capturable.

Routing follows the JAX layer exactly: float32 router logits and softmax,
the top-k taken lowest index first among equal probabilities (as
``lax.top_k``; ``torch.topk`` promises no order for ties), the k gates
renormalized to sum 1 when k > 1, slots claimed by a cumulative sum in
token order, every primary choice before any secondary, and the capacity
computed in Python as ``capacity()`` computes it (drop-free, C = N, at
inference).

All of the layer's leaves keep the JAX layout: the router ``wg``
``[d, E]``, ``w1`` ``[E, d, f]``, ``b1`` ``[E, f]``, ``w2`` ``[E, f, d]``,
``b2`` ``[E, d]`` (``kept_layout``): a per-expert table has no PyTorch
layout to prefer, and every wire then lays the 3-D leaves out as the JAX
package does without a rule of its own.
"""

from __future__ import annotations

import math

import torch

from ..models import layers as L


def top_k_lowest_first(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest values, descending,
    the lowest index first among equal values (``torch.argmax`` returns the
    first maximum); ``(values, indices)``, each ``[..., k]``."""
    vals, idx = [], []
    p = probs
    for j in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        if j + 1 < k:
            p = p.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


class MoE(L.Layer):
    """Top-k mixture of 2-layer ReLU MLP experts.  ``apply`` returns
    ``(y, aux)``: the combined output and the scalar load-balance loss
    (``E · Σ_e f_e · P_e`` on the primary choice, 1.0 at uniform
    routing)."""

    kept_layout = ("wg", "w1", "b1", "w2", "b2")

    def __init__(self, dim, n_experts, mlp_ratio=4, ep: int = 1,
                 capacity_factor: float = 1.25, w_init=("normal", 0.02),
                 compute_dtype=torch.bfloat16, seq_shards: int = 1,
                 top_k: int = 1, name: str = "moe"):
        if int(ep) != 1:
            raise NotImplementedError("expert parallelism (ep > 1) is not "
                                      "ported yet (A9d)")
        if int(seq_shards) != 1:
            raise NotImplementedError("the MoE's sequence all-to-all "
                                      "(seq_shards > 1) is not ported yet "
                                      "(A9d)")
        if not 1 <= int(top_k) <= n_experts:
            raise ValueError(f"top_k={top_k} with {n_experts} experts")
        self.top_k = int(top_k)
        self.dim, self.n_experts, self.hidden = dim, n_experts, mlp_ratio * dim
        self.capacity_factor = float(capacity_factor)
        self.w_init = w_init
        self.compute_dtype = L.as_dtype(compute_dtype)
        self.name = name

    def init(self, gen):
        E, d, f = self.n_experts, self.dim, self.hidden
        return {"wg": L.init_weight(gen, (d, E), self.w_init),
                "w1": L.init_weight(gen, (E, d, f), self.w_init),
                "b1": torch.zeros(E, f),
                "w2": L.init_weight(gen, (E, f, d), self.w_init),
                "b2": torch.zeros(E, d)}

    def capacity(self, n_tokens: int, train: bool = True) -> int:
        """Token slots per expert: the Switch bound when training (scaled
        by k, GShard's), every token at inference (drop-free)."""
        if not train:
            return max(1, n_tokens)
        return max(1, int(math.ceil(
            n_tokens * self.top_k / self.n_experts * self.capacity_factor)))

    def route(self, xf: torch.Tensor, wg: torch.Tensor, C: int):
        """Routing of ``xf`` ``[N, d]``: ``(slots, gates, aux)``, ``slots``
        k × ``[N]`` rows of the ``[E·C + 1, d]`` dispatch buffer (``E·C``
        for a dropped choice), ``gates`` k × ``[N]`` float32 (0 where
        dropped)."""
        E, K = self.n_experts, self.top_k
        probs = torch.softmax(torch.matmul(xf.float(), wg.float()), dim=-1)
        topv, topi = top_k_lowest_first(probs, K)
        if K > 1:
            topv = topv / topv.sum(-1, keepdim=True)
        # the choices as [E, N] one-hots: the slots' running count is a
        # scan along the contiguous token dim (a scan along an outer dim
        # of E = 4 columns runs nearly serially on the card)
        experts = torch.arange(E, device=xf.device)[:, None]
        assigns = [(topi[:, j][None, :] == experts).float() for j in range(K)]
        aux = E * torch.sum(assigns[0].mean(1) * probs.mean(0))
        slots, gates = [], []
        base = torch.zeros((E, 1), device=xf.device)
        for j, a in enumerate(assigns):
            pos = torch.cumsum(a, dim=1) - 1.0 + base               # [E, N]
            kept = (pos < C).float() * a
            base = base + kept.sum(1, keepdim=True)
            e = topi[:, j]
            c = torch.gather(pos, 0, e[None, :])[0].long()
            keep = torch.gather(kept, 0, e[None, :])[0] > 0
            slots.append(torch.where(keep, e * C + c,
                                     torch.full_like(e, E * C)))
            gates.append(topv[:, j] * keep.float())
        return slots, gates, aux

    def apply(self, params, x, *, train=False, gen=None):
        cd = self.compute_dtype
        shape = x.shape
        E, d = self.n_experts, self.dim
        xf = x.reshape(-1, d)
        C = self.capacity(xf.shape[0], train)
        slots, gates, aux = self.route(xf, params["wg"], C)
        xc = xf.to(cd)
        xe = xc.new_zeros((E * C + 1, d))
        for s in slots:
            xe = xe.index_copy(0, s, xc)
        xe = xe[:E * C].view(E, C, d)
        h = torch.relu(torch.bmm(xe, params["w1"].to(cd))
                       + params["b1"][:, None, :].to(cd))
        ye = torch.bmm(h, params["w2"].to(cd)) \
            + params["b2"][:, None, :].to(cd)
        ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
        y = None
        for s, g in zip(slots, gates):
            term = ye.index_select(0, s).float() * g.to(cd).float()[:, None]
            y = term if y is None else y + term
        return y.to(cd).reshape(shape).to(x.dtype), aux
