"""Tensor (model) parallelism over the ``model`` group.

Counterpart of ``theanompi_tpu/parallel/tp.py``: Megatron-style intra-layer
parallelism for the transformer LM over a ``model`` group of ``tp`` ranks
(``base.Grid``), composed with every data-parallel rule over the
``workers`` group.

* **Column-parallel** linear: the weight's OUTPUT rows (``[out, in]`` in
  the port) and the bias sharded; a plain ``layers.FC`` applied to the
  local shard IS the layer.  Its replicated input enters through
  :func:`copy_to_model` (identity forward, all-reduce backward).
* **Row-parallel** linear (:class:`RowFC`): the weight's INPUT columns
  sharded; the partial products are summed by :func:`reduce_from_model`
  (all-reduce forward, identity backward) before the replicated bias.
* **Attention** (:class:`TPMultiHeadAttention`): q/k/v column-parallel, so
  each rank owns ``n_head/tp`` whole heads (B10–B12 run on them under
  ``attn_impl='flash'``); the output projection row-parallel.
* **Embedding** (:class:`VocabParallelEmbedding`): the vocabulary sharded;
  out-of-shard ids give zeros, one all-reduce assembles the rows.
* **Vocab-parallel loss** (:func:`tp_softmax_cross_entropy`,
  :func:`tp_errors`, :func:`tp_errors_top_x`) on the ``[N, V/tp]`` logit
  shards, never the full ``[N, V]``.

JAX derives each collective's transpose from shard_map's varying-axes
typing (``tp.py:30-34`` there).  Here each collective is an
``autograd.Function`` with the matching backward, placed so that every
model rank back-propagates the same replicated loss: the gradients of the
replicated leaves (LayerNorms, ``pos``, row biases) then come out whole and
equal on every model rank, as the dense model's (``tests/test_torch_tp.py``
holds them against it).  Each ``group`` argument is a process group of its
own (``base.Grid.model_group``), used through its methods.
"""

from __future__ import annotations

import torch

from ..models import layers as L


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A new tensor: ``x`` summed (or ``op``) over ``group``."""
    import torch.distributed as dist
    y = x.detach().clone().contiguous()
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM if op is None else op
    group.allreduce([y], opts).wait()
    return y


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, *x.shape]``: every group rank's ``x``, in rank order."""
    x = x.detach().contiguous()
    outs = [torch.empty_like(x) for _ in range(group.size())]
    group.allgather([outs], [x]).wait()
    return torch.stack(outs)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated activation
    entering column-parallel weights."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product (or of the embedding's rows, or of the loss's
    shard sums)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Local:
    """The type of :data:`LOCAL`."""

    def __repr__(self) -> str:
        return "tp.LOCAL"


LOCAL = _Local()
"""A model group that stands for one rank's part run alone: with it
:func:`copy_to_model` and :func:`reduce_from_model` return their input,
and the caller adds up what the group's all-reduces would add (the rank
parts of ``chip_smoke.py``'s ep rank phase).  A group of None, a grid
whose groups were never joined, raises instead."""


def _joined(group):
    if group is None:
        raise ValueError("a model-parallel layer has no model group: join "
                         "the grid's groups (base.Grid.join), or pass "
                         "tp.LOCAL to run one rank's part alone")
    return group


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_CopyToGroup`; ``x`` itself for :data:`LOCAL`."""
    return x if group is LOCAL else _CopyToGroup.apply(x, _joined(group))


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_ReduceFromGroup`; ``x`` itself for :data:`LOCAL` (the
    rank's partial sum, which the caller adds up)."""
    return x if group is LOCAL else _ReduceFromGroup.apply(x, _joined(group))


# ---------------------------------------------------------------------------
# TP layers (global-shape init, sliced by the model's layout; local apply)
# ---------------------------------------------------------------------------

class ColumnFC(L.FC):
    """Column-parallel linear: :class:`layers.FC` on the local
    ``[out/tp, in]`` shard, its input through :func:`copy_to_model`."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def apply(self, params, x, *, train=False, gen=None):
        return super().apply(params, copy_to_model(x, self.group),
                             train=train, gen=gen)


class RowFC(L.FC):
    """Row-parallel linear (``tp.py:74``): the local ``[out, in/tp]``
    shard's partial product summed over the group before the replicated
    bias."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def apply(self, params, x, *, train=False, gen=None):
        cd = self.compute_dtype
        y = torch.matmul(x.to(cd), params["w"].to(cd).t())
        y = reduce_from_model(y, self.group) + params["b"].to(cd)
        return L._activate(y, self.activation)


class TPMultiHeadAttention(L.MultiHeadAttention):
    """Head-sharded attention (``tp.py:93``): ``n_head/tp`` whole heads a
    rank; q/k/v column-parallel, the output projection row-parallel (one
    all-reduce).  ``_attend`` is the dense layer's (B10–B12 under
    ``'flash'``) on the local heads."""

    def __init__(self, dim, n_head, tp: int, causal: bool = True,
                 group=None, **kwargs):
        super().__init__(dim, n_head, causal=causal, **kwargs)
        if n_head % tp or dim % tp:
            raise ValueError(f"n_head={n_head} and dim={dim} must divide by "
                             f"tp={tp}")
        self.tp = tp
        self.group = group

    def _proj(self, params, x, name):
        cd = self.compute_dtype
        b, t, _ = x.shape
        y = torch.matmul(x.to(cd), params[name].to(cd).t())
        return y.view(b, t, self.n_head // self.tp, -1).transpose(1, 2)

    def _out(self, params, o):
        cd = self.compute_dtype
        b, h_loc, t, hd = o.shape
        o = o.transpose(1, 2).reshape(b, t, h_loc * hd)
        return reduce_from_model(
            torch.matmul(o.to(cd), params["wo"].to(cd).t()), self.group)

    def apply(self, params, x, *, train=False, gen=None):
        return super().apply(params, copy_to_model(x, self.group),
                             train=train, gen=gen)


class VocabParallelEmbedding(L.Embedding):
    """Vocabulary-sharded embedding (``tp.py:130``): the local
    ``[vocab/tp, dim]`` rows; out-of-shard ids give zeros, one all-reduce
    assembles the dense vectors."""

    def __init__(self, vocab, dim, tp: int, rank: int = 0, group=None,
                 **kwargs):
        super().__init__(vocab, dim, **kwargs)
        if vocab % tp:
            raise ValueError(f"vocab={vocab} not divisible by tp={tp}")
        self.tp, self.rank, self.group = tp, rank, group

    def apply(self, params, x, *, train=False, gen=None):
        w = params["w"]
        v_loc = self.vocab // self.tp
        loc = x.long() - self.rank * v_loc
        ok = (loc >= 0) & (loc < v_loc)
        rows = w[loc.clamp(0, v_loc - 1)] * ok[..., None]
        return reduce_from_model(rows, self.group).to(self.compute_dtype)


# ---------------------------------------------------------------------------
# vocab-parallel loss / metric heads (logits sharded [N, V/tp])
# ---------------------------------------------------------------------------

def _labels_here(labels, rank: int, v_loc: int):
    loc = labels.long() - rank * v_loc
    ok = (loc >= 0) & (loc < v_loc)
    return loc.clamp(0, v_loc - 1), ok


def tp_softmax_cross_entropy(local_logits, labels, group, rank: int,
                             label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean NLL over vocab-sharded logits (``tp.py:155``): the shard-local
    sum-exp and label log-likelihood, one all-reduce each; the max taken
    over the group without a gradient (``pmax_sg``, :51: its contribution
    cancels).  ``label_smoothing`` adds the full-vocab logit mean (one more
    all-reduce).  Equal on every model rank."""
    import torch.distributed as dist
    l32 = local_logits.float()
    v_loc = l32.shape[-1]
    lmax = all_reduce(l32.amax(-1), group, dist.ReduceOp.MAX)
    z = reduce_from_model(torch.exp(l32 - lmax[:, None]).sum(-1), group)
    logz = torch.log(z) + lmax
    loc, ok = _labels_here(labels, rank, v_loc)
    ll_loc = torch.gather(l32, -1, loc[:, None])[:, 0]
    ll = reduce_from_model(torch.where(ok, ll_loc, torch.zeros_like(ll_loc)),
                           group)
    nll = torch.mean(logz - ll)
    if label_smoothing:
        eps = float(label_smoothing)
        mean_logit = reduce_from_model(l32.sum(-1), group) / \
            (v_loc * group.size())
        return (1.0 - eps) * nll + eps * torch.mean(logz - mean_logit)
    return nll


@torch.no_grad()
def tp_errors(local_logits, labels, group, rank: int) -> torch.Tensor:
    """Top-1 error over vocab-sharded logits (``tp.py:184``): each shard's
    (max, argmax) pair gathered ``[tp, N]``, the first maximal shard
    chosen (the dense argmax's first index)."""
    l32 = local_logits.float()
    v_loc = l32.shape[-1]
    mx, arg = l32.max(-1)
    vals = all_gather(mx, group)                                  # [tp, N]
    args = all_gather(arg + rank * v_loc, group)
    pred = torch.gather(args, 0, vals.argmax(0)[None])[0]
    return torch.mean((pred != labels.long()).float())


@torch.no_grad()
def tp_errors_top_x(local_logits, labels, group, rank: int,
                    x: int = 5) -> torch.Tensor:
    """Top-x error (``tp.py:197``): each shard's top-x (clamped to its
    width) gathered ``[tp, N, x]`` and merged; tp·x candidates cover the
    global top-x."""
    l32 = local_logits.float()
    v_loc = l32.shape[-1]
    vals, idx = torch.topk(l32, min(x, v_loc), dim=-1)
    vals = all_gather(vals, group)                       # [tp, N, x_loc]
    idx = all_gather(idx + rank * v_loc, group)
    n = l32.shape[0]
    vals = vals.transpose(0, 1).reshape(n, -1)
    idx = idx.transpose(0, 1).reshape(n, -1)
    sel = torch.topk(vals, min(x, vals.shape[-1]), dim=-1).indices
    top = torch.gather(idx, -1, sel)
    hit = torch.any(top == labels.long()[:, None], dim=-1)
    return torch.mean((~hit).float())
