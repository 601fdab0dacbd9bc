"""Sequence parallelism for the transformer LM over the ``seq`` group.

Counterpart of ``theanompi_tpu/parallel/sp.py``: the sequence dimension is
sharded over a ``seq`` group of ``sp`` ranks (``base.Grid``), each holding
``T/sp`` tokens of every row.  Everything per token (embeddings,
LayerNorm, MLP, head, per-token loss) runs on the local block; attention
is the exact ring of ``ops/ring_attention.py``.  The params stay
replicated over ``seq``: each rank's gradient is its block's share, and
the step sums them over the group (``TransformerLM.reduce_model_grads``),
as shard_map's transpose-psum does in the JAX package.

* :class:`RingMultiHeadAttention` (``sp.py:31`` there): the dense layer's
  params and projections, the ring for the attention itself.
* :func:`sp_mean` (``:61``): a per-block scalar averaged over the group
  (equal block sizes, so the mean of means is the global mean).
* :class:`TPRingMultiHeadAttention` (``:68``): head-sharded AND
  sequence-sharded, the tensor-parallel layer with the ring as its
  ``_attend``.
"""

from __future__ import annotations

import torch

from ..models import layers as L
from ..ops.ring_attention import ring_attention
from .tp import TPMultiHeadAttention, all_reduce


class RingMultiHeadAttention(L.MultiHeadAttention):
    """Causal attention over a sequence-sharded ``[B, T/sp, D]`` block:
    local projections, the ring over ``seq_group`` in global positions."""

    def __init__(self, dim, n_head, causal: bool = True, seq_group=None,
                 **kwargs):
        super().__init__(dim, n_head, causal=causal, **kwargs)
        self.seq_group = seq_group

    def _attend(self, q, k, v):
        return ring_attention(q, k, v, group=self.seq_group,
                              causal=self.causal)


class _SeqMean(torch.autograd.Function):
    """The mean over the group forward; the gradient times 1/n backward
    (each rank back-propagates its own block's share, summed with the
    params' gradients afterwards)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.size()
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sp_mean(x: torch.Tensor, group) -> torch.Tensor:
    """A per-block scalar averaged over the seq group (differentiable)."""
    return _SeqMean.apply(x, group)


class TPRingMultiHeadAttention(TPMultiHeadAttention):
    """``n_head/tp`` heads of a ``[B, T/sp, D]`` block: the tensor-parallel
    projections, the ring over ``seq_group`` on the local heads."""

    def __init__(self, dim, n_head, tp: int, causal: bool = True,
                 group=None, seq_group=None, **kwargs):
        super().__init__(dim, n_head, tp, causal=causal, group=group,
                         **kwargs)
        self.seq_group = seq_group

    def _attend(self, q, k, v):
        return ring_attention(q, k, v, group=self.seq_group,
                              causal=self.causal)
