"""Mixture of experts, with expert parallelism and the sequence all-to-all.

Counterpart of ``theanompi_tpu/parallel/moe.py``'s ``MoE``: a top-k
mixture of 2-layer MLP experts with the Switch (top-1) or GShard (top-2)
routing, its capacity and its load-balance loss, at one expert shard or
sharded over a grid axis:

* ``ep > 1`` (expert parallelism over the ``model`` group, ``moe.py:
  183-210`` there): the routing, the capacity and the dispatch are
  computed from the replicated activations, identical on every model
  rank; rank r holds experts ``r·E/ep … (r+1)·E/ep − 1``, dispatches only
  to their slots, runs them and combines its own slots; one all-reduce
  over the group sums the ranks' outputs.
* ``seq_shards > 1`` with ``ep = 1`` (the tokens sharded over the ``seq``
  group, ``_apply_seq_a2a``, ``:212-246``): the experts shard over
  ``seq``.  Each rank routes its own token block at the capacity of that
  block, gathers its slots ``[S, e_loc, C, d]`` grouped by the owner of
  their expert, and one all-to-all ships each group to its owner, which
  runs its experts over the ``S·C`` slots of every source; a second
  all-to-all brings them back for the local combine.
* both (sp × tp): the experts stay on ``model`` and the ``ep`` path runs
  on the local token block.

Under ``seq_shards > 1`` the load-balance statistic averages the routing
fractions ``f_e`` and mean probabilities ``P_e`` over ``seq`` before their
product (``:159-164``), the exact global aux.

The JAX layer dispatches through a one-hot ``[N, E, C]`` tensor and two
einsums; at the LM's validation batch (8192 tokens, E = 4, C = N at
inference) that one-hot is 1 GiB of float32 a block.  Each kept slot holds
exactly one token, so the port dispatches by index instead: every
(token, choice) that keeps its slot is copied into row ``e·C + c`` of an
``[E·C + 1, d]`` buffer (the dropped ones into the last row, which nothing
reads; under ``ep`` the buffer holds the rank's ``e_loc`` experts and every
other expert's choices go to the last row too), the experts run as batched
products over ``[E, C, d]``, and the combine gathers each choice's slot
back and sums the k gated rows in choice order, in float32.  The picks are
exact, so at float32 the layer equals the JAX one to the products'
summation order.  No index depends on a value read back to the host: the
step stays capturable.

Routing follows the JAX layer exactly: float32 router logits and softmax,
the top-k taken lowest index first among equal probabilities (as
``lax.top_k``; ``torch.topk`` promises no order for ties), the k gates
renormalized to sum 1 when k > 1, slots claimed by a cumulative sum in
token order, every primary choice before any secondary, and the capacity
computed in Python as ``capacity()`` computes it (drop-free, C = N, at
inference).

Gradients follow the port's model-parallel rule (``parallel/tp.py``):
every model rank back-propagates the same replicated loss, and a
replicated leaf's gradient comes out whole and equal on every rank.  Under
``ep`` the tokens and the gates enter the rank's experts through
``tp.copy_to_model`` (identity forward, all-reduce backward), so the
router ``wg`` and the input get the gradient of every rank's experts,
while the aux, which every rank computes whole, is counted once.  Under
the sequence all-to-all each rank's gradient is its token block's share
(summed over ``seq`` by the model, ``TransformerLM.reduce_model_grads``),
except the expert tables, whose owner sees every source's slots.

All of the layer's leaves keep the JAX layout: the router ``wg``
``[d, E]``, ``w1`` ``[E, d, f]``, ``b1`` ``[E, f]``, ``w2`` ``[E, f, d]``,
``b2`` ``[E, d]`` (``kept_layout``): a per-expert table has no PyTorch
layout to prefer, and every wire then lays the 3-D leaves out as the JAX
package does without a rule of its own.  ``init`` draws the global tables;
the model cuts each rank's experts from them (:meth:`MoE.specs`,
:meth:`MoE.seq_specs`).
"""

from __future__ import annotations

import math

import torch

from ..models import layers as L
from .tp import copy_to_model, reduce_from_model


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


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: block ``s`` of ``x``'s leading dim sent to group rank
    ``s``, and block ``s`` of the result received from rank ``s``."""
    import torch.distributed as dist
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    group.alltoall_base(out, x, [], [], dist.AllToAllOptions()).wait()
    return out


class _AllToAll(torch.autograd.Function):
    """The all-to-all forward; its inverse, the same exchange, backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def seq_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` over the leading dim, differentiable."""
    return _AllToAll.apply(x, group)


class MoE(L.Layer):
    """Top-k mixture of 2-layer ReLU MLP experts.  ``apply`` returns
    ``(y, aux)``: the combined output and the scalar load-balance loss
    (``E · Σ_e f_e · P_e`` on the primary choice, 1.0 at uniform
    routing), equal on every rank of the groups the layer spans.

    ``ep`` ranks of ``group`` (the model group), this one ``rank``, share
    the experts; ``seq_shards`` ranks of ``seq_group`` share the tokens.
    A ``group`` of ``tp.LOCAL`` runs rank ``rank``'s part alone: its
    experts' share of the output, which the caller sums over the ranks."""

    kept_layout = ("wg", "w1", "b1", "w2", "b2")

    def __init__(self, dim, n_experts, mlp_ratio=4, ep: int = 1,
                 capacity_factor: float = 1.25, w_init=("normal", 0.02),
                 compute_dtype=torch.bfloat16, seq_shards: int = 1,
                 top_k: int = 1, name: str = "moe", rank: int = 0,
                 group=None, seq_group=None):
        self.ep, self.seq_shards = int(ep), int(seq_shards)
        if n_experts % self.ep:
            raise ValueError(f"n_experts={n_experts} not divisible by "
                             f"ep={self.ep}")
        if self.seq_shards > 1 and self.ep == 1 and \
                n_experts % self.seq_shards:
            raise ValueError(f"n_experts={n_experts} not divisible by "
                             f"sp={self.seq_shards} (experts shard over "
                             f"'seq')")
        if not 1 <= int(top_k) <= n_experts:
            raise ValueError(f"top_k={top_k} with {n_experts} experts")
        if not 0 <= int(rank) < self.ep:
            raise ValueError(f"expert rank {rank} outside ep={self.ep}")
        self.top_k = int(top_k)
        self.dim, self.n_experts, self.hidden = dim, n_experts, mlp_ratio * dim
        self.capacity_factor = float(capacity_factor)
        self.w_init = w_init
        self.compute_dtype = L.as_dtype(compute_dtype)
        self.rank, self.group, self.seq_group = int(rank), group, seq_group
        self.name = name

    def init(self, gen):
        E, d, f = self.n_experts, self.dim, self.hidden
        return {"wg": L.init_weight(gen, (d, E), self.w_init),
                "w1": L.init_weight(gen, (E, d, f), self.w_init),
                "b1": torch.zeros(E, f),
                "w2": L.init_weight(gen, (E, f, d), self.w_init),
                "b2": torch.zeros(E, d)}

    def _expert_dims(self) -> dict:
        return {"wg": None, "w1": 0, "b1": 0, "w2": 0, "b2": 0}

    def specs(self):
        """The dim of each leaf the model group splits (``specs()``,
        ``moe.py:106-118`` there: the expert tables on their leading dim,
        the router replicated); None unless ``ep > 1``."""
        return self._expert_dims() if self.ep > 1 else None

    def seq_specs(self):
        """The dim of each leaf the seq group splits: the expert tables'
        leading dim under the sequence all-to-all; None otherwise."""
        return self._expert_dims() \
            if self.seq_shards > 1 and self.ep == 1 else None

    def capacity(self, n_tokens: int, train: bool = True) -> int:
        """Token slots per expert (per source shard under the sequence
        all-to-all): the Switch bound when training (scaled by k,
        GShard's), every token at inference (drop-free)."""
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
        f_e, p_e = assigns[0].mean(1), probs.mean(0)
        if self.seq_shards > 1 and self.seq_group is not None:
            # the global fractions: the blocks' means averaged before the
            # product (each rank back-propagates its block's share)
            from .sp import sp_mean
            f_e, p_e = sp_mean(f_e, self.seq_group), sp_mean(p_e,
                                                             self.seq_group)
        aux = E * torch.sum(f_e * p_e)
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

    def _experts(self, params, xe: torch.Tensor) -> torch.Tensor:
        """The experts of the local tables on ``xe`` ``[e, R, d]``: one
        batched product per layer."""
        cd = self.compute_dtype
        h = torch.relu(torch.bmm(xe, params["w1"].to(cd))
                       + params["b1"][:, None, :].to(cd))
        return torch.bmm(h, params["w2"].to(cd)) \
            + params["b2"][:, None, :].to(cd)

    @staticmethod
    def _dispatch(xc: torch.Tensor, slots, n_slots: int) -> torch.Tensor:
        """``[n_slots, d]``: row ``s`` the token that claimed slot ``s``
        (zeros where none did); a slot index of ``n_slots`` drops."""
        xe = xc.new_zeros((n_slots + 1, xc.shape[-1]))
        for s in slots:
            xe = xe.index_copy(0, s, xc)
        return xe[:n_slots]

    @staticmethod
    def _combine(ye: torch.Tensor, slots, gates, cd) -> torch.Tensor:
        """Each token's k gated slot rows summed in choice order, in
        float32; ``ye`` ``[n_slots, d]``, a slot of ``n_slots`` reads
        zeros."""
        ye = torch.cat([ye, ye.new_zeros((1, ye.shape[-1]))])
        y = None
        for s, g in zip(slots, gates):
            term = ye.index_select(0, s).float() * g.to(cd).float()[:, None]
            y = term if y is None else y + term
        return y

    def apply(self, params, x, *, train=False, gen=None):
        cd = self.compute_dtype
        shape = x.shape
        E, d = self.n_experts, self.dim
        xf = x.reshape(-1, d)
        C = self.capacity(xf.shape[0], train)
        slots, gates, aux = self.route(xf, params["wg"], C)
        if self.ep > 1:
            y = self._apply_ep(params, xf, slots, gates, C)
        elif self.seq_shards > 1:
            y = self._apply_seq_a2a(params, xf, slots, gates, C)
        else:
            xe = self._dispatch(xf.to(cd), slots, E * C).view(E, C, d)
            ye = self._experts(params, xe).reshape(E * C, d)
            y = self._combine(ye, slots, gates, cd)
        return y.to(cd).reshape(shape).to(x.dtype), aux

    def _apply_ep(self, params, xf, slots, gates, C):
        """This rank's ``E/ep`` experts on their slots, the ranks' float32
        outputs summed over the model group (``moe.py:183-210`` there)."""
        cd = self.compute_dtype
        e_loc = self.n_experts // self.ep
        n_loc, lo = e_loc * C, self.rank * e_loc * C
        # the slots of this rank's experts, every other choice dropped
        mine = [torch.where((s >= lo) & (s < lo + n_loc), s - lo,
                            torch.full_like(s, n_loc)) for s in slots]
        g = self.group
        xc = copy_to_model(xf, g).to(cd)
        gl = copy_to_model(torch.stack(gates, 1), g).unbind(1)
        xe = self._dispatch(xc, mine, n_loc).view(e_loc, C, self.dim)
        ye = self._experts(params, xe).reshape(n_loc, self.dim)
        return reduce_from_model(self._combine(ye, mine, gl, cd), g)

    def _apply_seq_a2a(self, params, xf, slots, gates, C):
        """The experts on the seq ranks (``_apply_seq_a2a``, ``moe.py:
        212-246`` there): this block's slots ``[S, e_loc, C, d]`` to their
        owners, the owner's experts over every source's, and back."""
        cd = self.compute_dtype
        S, E, d = self.seq_shards, self.n_experts, self.dim
        e_loc = E // S
        xe = self._dispatch(xf.to(cd), slots, E * C).view(S, e_loc, C, d)
        xe = seq_all_to_all(xe, self.seq_group)     # dim 0: the source
        ye = self._experts(params, xe.transpose(0, 1).reshape(
            e_loc, S * C, d))
        ye = ye.view(e_loc, S, C, d).transpose(0, 1)
        ye = seq_all_to_all(ye, self.seq_group)     # dim 0: the owner
        return self._combine(ye.reshape(E * C, d), slots, gates, cd)
