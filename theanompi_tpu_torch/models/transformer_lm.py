"""Decoder-only transformer language models.

Counterpart of ``theanompi_tpu/models/transformer_lm.py``: ``LMData`` (the
synthetic token stream, bit-equal to the JAX package's) or, with
``data_dir``, the token files of ``data/tokens.py``; the pre-LN
``Block``, ``TransformerLM`` and the sparse-FFN ``MoETransformerLM`` (its
``MoEBlock``s' mixtures of experts, ``parallel/moe.py``), trained under
the same model contract as the CNN zoo::

    BSP().init(devices=1, modelfile='theanompi_tpu_torch.models.transformer_lm',
               modelclass='TransformerLM', attn_impl='flash', ...)

``attn_impl='flash'`` runs every attention through the hand-written kernels
B10–B12 on the card (``ops/flash_attention.py``), in bfloat16 or float32:
on a CUDA device another compute dtype is refused when the model is built
(:func:`check_flash_dtype`); ``'reference'`` runs through torch ops.
``remat`` recomputes each block's forward in the backward
(``torch.utils.checkpoint``; B10 then runs twice a block a step).
:meth:`TransformerLM.generate` samples continuations, with the KV cache
(one prefill forward through B10, then one token a step) or by the full
forward a token.

``tp``, ``pp`` and ``sp`` lay the dense LM over a model-parallel grid of
ranks (``base.Grid``): ``tp`` shards heads, MLP columns, the vocabulary of
the embedding and of the head over the ``model`` group (``parallel/tp.py``;
B10–B12 run on each rank's ``n_head/tp`` heads), ``pp`` the block stack
over the ``pipe`` group, ``pp_microbatches`` microbatches streaming through
``pp`` stages of ``pp_interleave`` chunks each (``parallel/pipeline.py``),
and ``sp`` the tokens over the ``seq`` group with ring attention
(``parallel/sp.py``).  Each rank holds its shard of every leaf
(:meth:`TransformerLM.param_specs`: the dims its grid axes split), made
from the dense model's initial params, and feeds its worker's rows and its
seq block of tokens.  Under ``pp`` the params are the JAX package's tree:
``blocks`` holds every block leaf stacked on a leading layer dim in
``stage_permutation`` order, in the JAX layout (``[in, out]`` weights),
and the pipe group splits that dim.  The MoE LM runs on the same grids:
its experts shard over the ``model`` group at ``tp > 1`` (expert
parallelism, ``ep = tp``), over the ``seq`` group at ``sp > 1`` with
``tp = 1`` (the sequence all-to-all), and its blocks over ``pipe`` when
every block is a MoE (``moe_every = 1``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.moe import MoE
from ..utils.helper_funcs import (from_jax_layout, get_leaf, leaf_paths,
                                  to_jax_layout, tree_leaves, tree_map)
from . import layers as L
from .data import DataBase
from .model_base import ModelBase


class LMData(DataBase):
    """Synthetic next-token-prediction data: x[t+1] = x[t] + 1 (mod V) with
    ``noise`` probability of a random token — learnable one-step rule."""

    def __init__(self, config=None, batch_size=16, seq_len=64, vocab=64,
                 n_train=1024, n_val=256, noise=0.05):
        super().__init__(config, batch_size)
        seq_len = int(self.config.get("seq_len", seq_len))
        vocab = int(self.config.get("vocab", vocab))
        n_train = int(self.config.get("synthetic_train", n_train))
        n_val = int(self.config.get("synthetic_val", n_val))
        noise = float(self.config.get("noise", noise))

        def make(n, seed):
            r = np.random.RandomState(seed)
            start = r.randint(0, vocab, (n, 1))
            seq = (start + np.arange(seq_len + 1)) % vocab
            flip = r.rand(n, seq_len + 1) < noise
            seq = np.where(flip, r.randint(0, vocab, seq.shape), seq)
            return seq.astype(np.int32)

        train, val = make(n_train, 101), make(n_val, 202)
        self.x_train, self.y_train = train[:, :-1], train[:, 1:]
        self.x_val, self.y_val = val[:, :-1], val[:, 1:]
        self._finalize()

    def _make_batch(self, x, y, train):
        # token ids stay int32 (the base class casts images to float32)
        return {"x": np.ascontiguousarray(x, dtype=np.int32),
                "y": np.ascontiguousarray(y, dtype=np.int32)}


class Block(L.Layer):
    """Pre-LN transformer block: LN→MHA→residual, LN→MLP→residual.

    With a ``grid`` of ``tp > 1`` the attention is head-sharded and the MLP
    column→row-parallel over the model group; with ``sp > 1`` the
    attention is the ring over the seq group (both: heads and tokens).
    Same init and math as the dense block."""

    def __init__(self, dim, n_head, mlp_ratio=4, cd=torch.bfloat16,
                 attn_impl="reference", name="block", grid=None):
        from ..parallel import sp as splib
        from ..parallel import tp as tplib
        self.name = name
        tp, sp = (grid.tp, grid.sp) if grid is not None else (1, 1)
        self.tp = tp
        self.ln1 = L.LayerNorm(dim, name="ln1")
        kw = dict(compute_dtype=cd, name="attn")
        if tp > 1 and sp > 1:
            self.attn = splib.TPRingMultiHeadAttention(
                dim, n_head, tp, group=grid.model_group,
                seq_group=grid.seq_group, **kw)
        elif tp > 1:
            self.attn = tplib.TPMultiHeadAttention(
                dim, n_head, tp, group=grid.model_group,
                attn_impl=attn_impl, **kw)
        elif sp > 1:
            self.attn = splib.RingMultiHeadAttention(
                dim, n_head, seq_group=grid.seq_group, **kw)
        else:
            self.attn = L.MultiHeadAttention(dim, n_head, attn_impl=attn_impl,
                                             **kw)
        self.ln2 = L.LayerNorm(dim, name="ln2")
        col, row = (L.FC, L.FC) if tp == 1 else (
            lambda *a, **k: tplib.ColumnFC(*a, group=grid.model_group, **k),
            lambda *a, **k: tplib.RowFC(*a, group=grid.model_group, **k))
        self.fc1 = col(dim, mlp_ratio * dim, w_init=("normal", 0.02),
                       activation="relu", compute_dtype=cd, name="fc1")
        self.fc2 = row(mlp_ratio * dim, dim, w_init=("normal", 0.02),
                       activation=None, compute_dtype=cd, name="fc2")

    def model_dims(self) -> dict:
        """The dim of each leaf (port layout) the model group splits, None
        where it is replicated (``transformer_lm.py:98-110`` there); every
        leaf None at ``tp = 1``."""
        m = (lambda d: d) if self.tp > 1 else (lambda d: None)
        ln = {"scale": None, "bias": None}
        return {"ln1": ln, "attn": {"wq": m(0), "wk": m(0), "wv": m(0),
                                    "wo": m(1)},
                "ln2": dict(ln), "fc1": {"w": m(0), "b": m(0)},
                "fc2": {"w": m(1), "b": None}}

    def specs(self):
        """:meth:`model_dims`, or None when the model group splits
        nothing."""
        return self.model_dims() if self.tp > 1 else None

    def seq_dims(self):
        """The dims the seq group splits (a partial tree: the leaves it
        names), or None: the dense block's params are whole on every seq
        rank."""
        return None

    def sublayers(self):
        return {"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                "fc1": self.fc1, "fc2": self.fc2}

    def _mlp(self, params, h):
        return self.fc2.apply(params["fc2"], self.fc1.apply(params["fc1"], h))

    def apply(self, params, x, *, train=False, gen=None):
        h = self.ln1.apply(params["ln1"], x)
        x = x + self.attn.apply(params["attn"], h, train=train)
        return x + self._mlp(params, self.ln2.apply(params["ln2"], x))

    # -- the KV-cache path (inference) ---------------------------------------

    def apply_prefill(self, params, x):
        """The forward, and the attention's K/V cache."""
        h = self.ln1.apply(params["ln1"], x)
        a, cache = self.attn.apply_prefill(params["attn"], h)
        x = x + a
        return x + self._mlp(params, self.ln2.apply(params["ln2"], x)), cache

    def apply_decode(self, params, x1, cache, pos: int):
        h = self.ln1.apply(params["ln1"], x1)
        a, cache = self.attn.apply_decode(params["attn"], h, cache, pos)
        x1 = x1 + a
        return (x1 + self._mlp(params, self.ln2.apply(params["ln2"], x1)),
                cache)


class MoEBlock(Block):
    """A block whose MLP is a top-k mixture of experts (``parallel/moe.py``;
    ``transformer_lm.py:164-229`` there).  On a ``grid`` the attention is
    the dense block's, and the MoE's experts shard over the model group
    (``ep = tp``) or, at ``tp = 1``, over the seq group (``seq_shards =
    sp``).  ``apply`` returns ``(y, aux)``: the load-balance loss rides up
    to the model's loss.  The KV-cache path runs the MoE per token as the
    full forward does (drop-free at inference) and drops the aux, a
    training statistic."""

    def __init__(self, dim, n_head, n_experts, mlp_ratio=4, cd=torch.bfloat16,
                 capacity_factor=1.25, top_k=1, attn_impl="reference",
                 name="moe_block", grid=None):
        super().__init__(dim, n_head, mlp_ratio=mlp_ratio, cd=cd,
                         attn_impl=attn_impl, name=name, grid=grid)
        del self.fc1, self.fc2
        kw = {} if grid is None else dict(
            ep=grid.tp, seq_shards=grid.sp, rank=grid.model,
            group=grid.model_group, seq_group=grid.seq_group)
        self.moe = MoE(dim, n_experts, mlp_ratio=mlp_ratio, top_k=top_k,
                       capacity_factor=capacity_factor, compute_dtype=cd,
                       name="moe", **kw)

    def model_dims(self) -> dict:
        dims = super().model_dims()
        del dims["fc1"], dims["fc2"]
        dims["moe"] = self.moe.specs() or {k: None for k in
                                           MoE.kept_layout}
        return dims

    def seq_dims(self):
        ms = self.moe.seq_specs()
        return None if ms is None else {"moe": ms}

    def sublayers(self):
        return {"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                "moe": self.moe}

    def _mlp(self, params, h):
        return self.moe.apply(params["moe"], h)[0]

    def apply(self, params, x, *, train=False, gen=None):
        h = self.ln1.apply(params["ln1"], x)
        x = x + self.attn.apply(params["attn"], h, train=train)
        y, aux = self.moe.apply(params["moe"], self.ln2.apply(params["ln2"],
                                                               x),
                                train=train)
        return x + y, aux


def check_flash_dtype(attn_impl: str, compute_dtype: torch.dtype,
                      device) -> None:
    """Refuse ``attn_impl='flash'`` on a CUDA device with a compute dtype
    that the flash kernels B10–B12 have no instantiation for (they take
    bfloat16 and float32).  On the CPU the plain versions compute any
    dtype."""
    from ..ops.flash_attention import DTYPES
    if attn_impl == "flash" and torch.device(device).type == "cuda" and \
            compute_dtype not in DTYPES:
        raise ValueError(f"attn_impl='flash' on {device} needs "
                         f"compute_dtype bfloat16 or float32: the flash "
                         f"kernels B10-B12 take bfloat16 or float32; got "
                         f"{compute_dtype}")


class Split:
    """The grid axes that split one leaf: the dim the ``pipe`` group
    splits, the dim the ``model`` group splits and the dim the ``seq``
    group splits (None where the axis holds the leaf whole)."""

    AXES = ("pipe", "model", "seq")
    __slots__ = AXES

    def __init__(self, pipe=None, model=None, seq=None):
        self.pipe, self.model, self.seq = pipe, model, seq

    def axes(self) -> tuple:
        return tuple(a for a in self.AXES if getattr(self, a) is not None)


def _dim(tree, path):
    """The value at ``path`` of a partial tree of dims (None where the
    tree, or the path in it, is missing)."""
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _nest(paths, values) -> dict:
    """A nested dict holding ``values`` at ``paths``."""
    out: dict = {}
    for p, v in zip(paths, values):
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = v
    return out


class TransformerLM(ModelBase):
    batch_size = 16
    epochs = 10
    n_subb = 1
    learning_rate = 3e-3
    optimizer = "adam"
    weight_decay = 0.0
    momentum = 0.9
    vocab = 64
    d_model = 128
    n_head = 4
    n_layer = 2
    seq_len = 64

    def build_model(self) -> None:
        cd = L.as_dtype(self.config.get("compute_dtype", torch.bfloat16))
        for k in ("vocab", "d_model", "n_head", "n_layer", "seq_len"):
            if k in self.config:
                setattr(self, k, int(self.config[k]))
        self.tp = int(self.config.get("tp", 1))
        self.sp = int(self.config.get("sp", 1))
        # read once here: the captured step's forward reads no config knob
        # (a knob changed later would not reach a replayed graph)
        self.remat = bool(self.config.get("remat", False))
        self._check_pipeline()
        attn_impl = str(self.config.get("attn_impl", "reference"))
        if attn_impl == "flash" and self.seq_len % 128:
            # the JAX package's build-time check, kept for the same configs
            raise ValueError(f"attn_impl='flash' needs seq_len a multiple of "
                             f"the kernel's 128-wide blocks; got "
                             f"{self.seq_len}")
        if attn_impl != "reference" and self.sp > 1:
            # sequence-sharded attention is the ring (the JAX package's
            # assertion), so a flash request fails rather than run it
            raise ValueError(f"attn_impl={attn_impl!r} does not apply under "
                             f"sp > 1 (sequence-sharded attention is the "
                             f"ring)")
        check_flash_dtype(attn_impl, cd, self.device)
        grid = self.config.get("grid")
        if self.tp * self.sp * self.pp > 1:
            # the JAX package's mesh check: the grid this rank joined
            want = (self.tp, self.sp, self.pp)
            if grid is None or (grid.tp, grid.sp, grid.pp) != want:
                raise ValueError(
                    f"tp={self.tp}, sp={self.sp}, pp={self.pp} need a world "
                    f"of that grid (base.MeshProcess with the same keys); "
                    f"got {None if grid is None else (grid.tp, grid.sp, grid.pp)}")
            if self.seq_len % self.sp:
                raise ValueError(f"seq_len={self.seq_len} not divisible by "
                                 f"sp={self.sp}")
        else:
            grid = None
        self.grid = grid
        if self.tp > 1:
            from ..parallel import tp as tplib
            self.embed = tplib.VocabParallelEmbedding(
                self.vocab, self.d_model, self.tp, rank=grid.model,
                group=grid.model_group, compute_dtype=cd)
            self.head = tplib.ColumnFC(
                self.d_model, self.vocab, w_init=("normal", 0.02),
                activation=None, compute_dtype=cd, name="head",
                group=grid.model_group)
        else:
            self.embed = L.Embedding(self.vocab, self.d_model,
                                     compute_dtype=cd)
            self.head = L.FC(self.d_model, self.vocab,
                             w_init=("normal", 0.02), activation=None,
                             compute_dtype=cd, name="head")
        self.pos = L.Embedding(self.seq_len, self.d_model, compute_dtype=cd,
                               name="pos")
        self.blocks = [Block(self.d_model, self.n_head, cd=cd,
                             attn_impl=attn_impl, name=f"block{i}",
                             grid=grid)
                       for i in range(self.n_layer)]
        self.ln_f = L.LayerNorm(self.d_model, name="ln_f")
        if self.config.get("data_dir"):
            # a real corpus: nanoGPT-style flat token files, memory-mapped
            from .data.tokens import TokenFileData
            self.data = TokenFileData(self.config, self.batch_size,
                                      self.seq_len, vocab=self.vocab)
        else:
            self.data = LMData(self.config, self.batch_size)

    def _check_pipeline(self) -> None:
        """The pipeline keys, as the JAX package checks them
        (``transformer_lm.py:268-297`` there, and ``pipeline._validate``
        at build time rather than at the first step): ``pp_microbatches``
        defaults to ``2·pp`` and is ignored at ``pp = 1``;
        ``pp_interleave > 1`` needs ``pp > 1``, ``n_layer`` divisible by
        ``pp·pp_interleave`` and the microbatches by ``pp``."""
        self.pp = int(self.config.get("pp", 1))
        self.pp_microbatches = int(self.config.get("pp_microbatches", 0))
        self.pp_interleave = int(self.config.get("pp_interleave", 1))
        if self.pp == 1:
            if self.pp_interleave > 1:
                raise ValueError(
                    f"pp_interleave={self.pp_interleave} needs pipeline "
                    f"parallelism — set the 'pp' config knob > 1 (got "
                    f"pp={self.pp})")
            return
        if self.n_layer % self.pp:
            raise ValueError(f"n_layer={self.n_layer} not divisible by "
                             f"pp={self.pp}")
        self.pp_microbatches = self.pp_microbatches or 2 * self.pp
        from ..parallel import pipeline as pl
        pl._validate(self.pp, self.pp_interleave, self.pp_microbatches,
                     self.n_layer // self.pp)

    def layers(self):
        return dict({"embed": self.embed, "pos": self.pos, "ln_f": self.ln_f,
                     "head": self.head}, **{b.name: b for b in self.blocks})

    # -- the model-parallel layout ------------------------------------------

    def param_specs(self):
        """Per leaf of the params, the dims the grid axes split (a
        :class:`Split`); None for a layout that splits nothing (``tp = pp
        = 1`` and no MoE experts over ``seq``; ``transformer_lm.py:334-376``
        there: the seq group holds every dense leaf whole).  Under ``pp``
        the pipe group splits each ``blocks`` leaf's leading layer dim, and
        a tp or sp dim of a block leaf is the JAX layout's, one right of
        the stacking dim."""
        if self.tp == 1 and self.pp == 1 and \
                all(b.seq_dims() is None for b in self.blocks):
            return None
        tp = 0 if self.tp > 1 else None
        top = {"embed": {"w": Split(model=tp)}, "pos": {"w": Split()},
               "ln_f": {"scale": Split(), "bias": Split()},
               "head": {"w": Split(model=tp), "b": Split(model=tp)}}
        if self.pp == 1:
            return {**top, **{b.name: self._block_splits(b)
                              for b in self.blocks}}
        spec, seq = self.blocks[0].specs(), self.blocks[0].seq_dims()

        def stacked(path):
            d, s = _dim(spec, path), _dim(seq, path)
            if d is not None and self._blk_ndim[path] == 2 and \
                    path not in self._blk_kept:
                d = 1 - d                  # [out, in] → the JAX [in, out]
            return Split(pipe=0, model=None if d is None else d + 1,
                         seq=None if s is None else s + 1)

        return {**top, "blocks": _nest(self._blk_paths,
                                       [stacked(p) for p in self._blk_paths])}

    @staticmethod
    def _block_splits(blk):
        """One block's leaves' :class:`Split`: its model and seq dims."""
        dims, seq = blk.model_dims(), blk.seq_dims()
        paths = leaf_paths(dims)
        return _nest(paths, [Split(model=get_leaf(dims, p),
                                   seq=_dim(seq, p)) for p in paths])

    def _dims(self, tree):
        """Per leaf of a params-shaped ``tree``: its :class:`Split` (a
        scalar such as Adam's count is held whole)."""
        return tree_map(lambda a, s: Split() if np.ndim(a) == 0 else s, tree,
                        self.param_specs())

    def _chunk(self, a, dim: int, axis: str):
        """This rank's chunk of ``a`` (a tensor or an array) along ``dim``
        over the grid ``axis``, contiguous and of its own."""
        n, i = self.grid.size(axis), getattr(self.grid, axis)
        if isinstance(a, torch.Tensor):
            return a.chunk(n, dim=dim)[i].clone(
                memory_format=torch.contiguous_format)
        return np.ascontiguousarray(np.split(np.asarray(a), n, axis=dim)[i])

    def shard_params(self, tree):
        """This rank's shard of a global params-shaped tree of tensors or
        arrays: each split leaf's chunk along each axis's dim."""
        if self.param_specs() is None:
            return tree

        def cut(a, s):
            for axis in Split.AXES:
                if getattr(s, axis) is not None:
                    a = self._chunk(a, getattr(s, axis), axis)
            return a

        return tree_map(cut, tree, self._dims(tree))

    def gather_params(self, tree):
        """The global tree of a local params-shaped one: each split leaf's
        shards gathered over the seq group, the model group, then the pipe
        group, and joined (a collective: every rank of those groups
        calls)."""
        if self.param_specs() is None:
            return tree
        from ..parallel.tp import all_gather

        def join(a, s):
            for axis in reversed(Split.AXES):
                d = getattr(s, axis)
                if d is not None:
                    a = torch.cat(list(all_gather(a, self.grid.group(axis))),
                                  dim=d)
            return a

        return tree_map(join, tree, self._dims(tree))

    def _split_axes(self) -> tuple:
        """The grid axes, seq first, then model, then pipe, that split
        some leaf."""
        split = set().union(*self.split_axes_leaves())
        return tuple(a for a in reversed(Split.AXES) if a in split)

    def _params_like(self, tree, fn):
        """``tree`` with ``fn`` applied to each subtree shaped as the params
        (the params, Adam's moments and counts, an EMA shadow, a center)."""
        if not isinstance(tree, dict):
            return tree
        if leaf_paths(tree) == leaf_paths(self.params):
            return fn(tree)
        return {k: self._params_like(v, fn) for k, v in tree.items()}

    def global_state(self, parts):
        """The state parts as global arrays, as a checkpoint holds them (a
        collective over the grid's groups): each params-shaped subtree
        gathered (:meth:`gather_params`); a strategy's state, which each
        rank keeps for its own shards, joined in the JAX package's shapes:
        a flat vector the seq ranks' end to end where the seq group splits
        a leaf, then the model ranks', then the pipe ranks'
        (``[pp·tp·n]``), each array of a per-leaf state on a leading
        ``[tp]`` axis, then ``[pp]`` (``[pp, tp, ...]``); and ZeRO-1's
        chunks of the rank's local flat layout every grid rank's end to
        end (``[pp·tp·sp·chunk]``, the row of the JAX package's boxed
        ``[dp, shards·chunk]``: :meth:`_zero_gather`)."""
        if self.grid is None:
            return parts
        if self._zero_layout is not None and "opt_state" in parts:
            parts = dict(parts, opt_state=self._zero_gather(
                parts["opt_state"]))
        if self.param_specs() is None:
            return parts
        from ..parallel.tp import all_gather
        out = {k: self._params_like(v, self.gather_params)
               for k, v in parts.items()}
        st = parts.get("extra", {}).get("strat")
        if st is not None:
            for axis in self._split_axes():
                g = self.grid.group(axis)
                st = all_gather(st, g).reshape(-1) \
                    if isinstance(st, torch.Tensor) else \
                    tree_map(lambda a, g=g: all_gather(a, g), st)
            out["extra"] = dict(out["extra"], strat=st)
        return out

    def local_state(self, parts):
        """This rank's state from global parts (host arrays or tensors):
        the inverse of :meth:`global_state`."""
        if self.grid is None:
            return parts
        if self._zero_layout is not None and "opt_state" in parts:
            parts = dict(parts, opt_state=self._zero_chunk(
                parts["opt_state"]))
        if self.param_specs() is None:
            return parts
        out = {k: self._params_like(v, self.shard_params)
               for k, v in parts.items()}
        st = out.get("extra", {}).get("strat")
        if st is not None:
            for axis in reversed(self._split_axes()):
                i = getattr(self.grid, axis)
                st = tree_map(lambda a, i=i: a[i], st) \
                    if isinstance(st, list) else self._chunk(st, 0, axis)
            out["extra"] = dict(out["extra"], strat=st)
        return out

    def _zero_gather(self, st):
        """ZeRO-1's state with each ``[chunk]`` leaf gathered over the seq,
        model and pipe groups: ``[shards·chunk]``, chunk ``(p·tp + m)·sp +
        s`` the rank's at that coordinate (the JAX package's ``P(workers,
        <model axes>)`` order); scalars as they are (a collective)."""
        from ..parallel.tp import all_gather

        def join(a):
            if not isinstance(a, torch.Tensor) or a.dim() == 0:
                return a
            for axis in reversed(Split.AXES):
                if self.grid.size(axis) > 1:
                    a = all_gather(a, self.grid.group(axis)).reshape(-1)
            return a

        return tree_map(join, st)

    def _zero_chunk(self, st):
        """This grid rank's ``[chunk]`` of each ``[shards·chunk]`` leaf of a
        global ZeRO-1 state: :meth:`_zero_gather`'s inverse."""
        g = self.grid

        def cut(a):
            if np.ndim(a) == 0:
                return a
            c = np.shape(a)[0] // (g.pp * g.tp * g.sp)
            return a[g.shard * c:(g.shard + 1) * c]

        return tree_map(cut, st)

    def init_params(self, gen):
        """The dense model's initial params (the same draws), in the pp
        tree under ``pp`` (:meth:`_stacked`), cut to this rank's shards."""
        return self.shard_params(self._stacked(super().init_params(gen)))

    def _perm(self) -> np.ndarray:
        from ..parallel.pipeline import stage_permutation
        return stage_permutation(self.n_layer, self.pp, self.pp_interleave)

    def _stacked(self, dense):
        """A dense global tree in the pp layout (``transformer_lm.py:
        382-393`` there): every block leaf in the JAX layout, stacked on a
        leading layer dim, row ``j`` holding layer ``stage_permutation[j]``;
        the tree itself at ``pp = 1``.  Notes a block's leaf paths,
        dims and kept leaves, which the pp layout reads."""
        blk = self.blocks[0]
        self._blk_paths = leaf_paths(dense[blk.name])
        self._blk_ndim = {p: get_leaf(dense[blk.name], p).dim()
                          for p in self._blk_paths}
        self._blk_kept = frozenset(blk.kept_layout_paths())
        if self.pp == 1:
            return dense
        out = {k: v for k, v in dense.items()
               if k not in {b.name for b in self.blocks}}
        out["blocks"] = _nest(self._blk_paths,
                              self.stack_rows(dense, self._perm()))
        return out

    def stack_rows(self, dense, layers) -> list:
        """The blocks ``layers`` (depth indices) of a dense tree, each
        leaf in the JAX layout stacked on a leading layer dim: the
        ``blocks`` leaves of the pp tree, in ``tree_leaves`` order, which
        :meth:`stage_fn`'s chunk function takes."""
        rows = [dense[self.blocks[int(i)].name] for i in layers]
        return [torch.stack([to_jax_layout(get_leaf(r, p), p, self._blk_kept)
                             for r in rows]) for p in self._blk_paths]

    def _unstacked(self, tree):
        """A global pp tree in the dense layout: the stacked rows unstacked
        through the inverse permutation (``transformer_lm.py:587-607``
        there), each leaf in the port's layout."""
        if self.pp == 1:
            return tree
        out = {k: v for k, v in tree.items() if k != "blocks"}
        inv = np.argsort(self._perm())
        stack = [get_leaf(tree["blocks"], p) for p in self._blk_paths]
        for i, blk in enumerate(self.blocks):
            j = int(inv[i])
            out[blk.name] = _nest(self._blk_paths, [
                from_jax_layout(a[j], p, self._blk_kept)
                for a, p in zip(stack, self._blk_paths)])
        return out

    def kept_layout_paths(self) -> frozenset:
        """The leaves kept in the JAX layout; under ``pp`` every ``blocks``
        leaf is."""
        kept = super().kept_layout_paths()
        if self.pp == 1:
            return kept
        names = {b.name for b in self.blocks}
        return frozenset({p for p in kept if p[0] not in names}
                         | {("blocks",) + p for p in self._blk_paths})

    def split_axes_leaves(self) -> list:
        """Per leaf (``tree_leaves`` order): the grid axes that split it,
        ``"pipe"`` before ``"model"`` (``()`` where it is whole)."""
        if self.param_specs() is None:
            return [()] * len(tree_leaves(self.params))
        return [s.axes() for s in tree_leaves(self._dims(self.params))]

    def reduce_model_grads(self, grads) -> None:
        """The step's gradient leaves, summed in place over the seq group:
        each seq rank's is its token block's share (the loss is
        :func:`parallel.sp.sp_mean` of the blocks'), except a leaf the seq
        group splits (the MoE's experts under the sequence all-to-all),
        whose owner has seen every block's slots.  The pipe group needs
        nothing: each pipe rank computes the head on the broadcast
        outputs, and the pipeline broadcasts its input's gradient, so a
        leaf it does not split has the dense gradient on every stage."""
        if self.sp > 1:
            from ..parallel.tp import all_reduce
            for g, axes in zip(grads, self.split_axes_leaves()):
                if "seq" not in axes:
                    g.copy_(all_reduce(g, self.grid.seq_group))

    def _local_tokens(self, batch):
        """This rank's block of tokens: ``[B, T/sp]`` of x and y under sp
        (``batch_spec``, :401-406 there: rows over workers, tokens over
        seq)."""
        if self.sp == 1:
            return batch
        t = batch["x"].shape[-1] // self.sp
        s = self.grid.seq
        return {k: v[..., s * t:(s + 1) * t] for k, v in batch.items()}

    def _pos_ids(self, t: int, device):
        """Global positions of a ``[B, t]`` token block (offset by the seq
        rank under sp)."""
        pos = torch.arange(t, device=device)
        return pos + self.grid.seq * t if self.sp > 1 else pos

    def _embed(self, params, x, pos):
        """Token plus position embeddings of ``x`` ``[B, t]`` at the
        positions ``pos`` ``[t]``."""
        return self.embed.apply(params["embed"], x) + \
            self.pos.apply(params["pos"], pos)[None]

    def _head(self, params, h):
        return self.head.apply(params["head"],
                               self.ln_f.apply(params["ln_f"], h))

    def stage_fn(self, train: bool):
        """The pipeline's chunk function: a run of stacked block rows
        (JAX layout) applied in turn, each row's leaves viewed in the
        port's layout; ``(y, aux)`` for MoE blocks (the aux summed over the
        rows)."""
        tpl, paths, kept = self.blocks[0], self._blk_paths, self._blk_kept

        def stage(rows, h):
            aux = None
            for i in range(rows[0].shape[0]):
                p = _nest(paths, [from_jax_layout(r[i], q, kept)
                                  for r, q in zip(rows, paths)])
                out = tpl.apply(p, h, train=train)
                if isinstance(out, tuple):
                    h, a = out
                    aux = a if aux is None else aux + a
                else:
                    h = out
            return h if aux is None else (h, aux)

        return stage

    def _pipeline(self, params, h, train: bool, with_aux: bool = False):
        """``h`` ``[B, t, D]`` through the pipe group's stages
        (``transformer_lm.py:423-436`` there): ``pp_microbatches``
        microbatches streamed through the schedule; with ``with_aux`` also
        the stages' aux summed over the real ticks."""
        from ..parallel import pipeline as pl
        out = pl.pipeline_apply(
            self.stage_fn(train), tree_leaves(params["blocks"]),
            pl.microbatch(h, self.pp_microbatches), self.grid.pipe_group,
            with_aux=with_aux, interleave=self.pp_interleave)
        if with_aux:
            return pl.unmicrobatch(out[0]), out[1]
        return pl.unmicrobatch(out)

    def apply_model(self, params, x, *, train: bool, gen, state):
        h = self._embed(params, x, self._pos_ids(x.shape[1], x.device))
        if self.pp > 1:
            # each chunk is recomputed in the backward already
            return self._head(params, self._pipeline(params, h, train))
        remat = train and self.remat
        for blk in self.blocks:
            if remat:
                # the block's forward again in the backward: its activations
                # are not kept.  It draws no random numbers, so no RNG state
                # is saved (reading the CUDA one would break a capture)
                h = checkpoint(
                    lambda p, x, _b=blk: _b.apply(p, x, train=True),
                    params[blk.name], h, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                h = blk.apply(params[blk.name], h, train=train)
        return self._head(params, h)

    def _flat(self, params, batch, train):
        batch = self._local_tokens(batch)
        logits = self.apply_model(params, batch["x"], train=train, gen=None,
                                  state=None)
        return logits.reshape(-1, logits.shape[-1]), batch["y"].reshape(-1)

    def _heads(self, flat, y, smoothing: float = 0.0, top5: bool = False):
        """Cost, error (and top-5 error) of ``[N, V]`` logits, or of their
        vocab shards under tp; averaged over the seq blocks under sp."""
        if self.tp > 1:
            from ..parallel import tp as tplib
            g = self.grid
            out = [tplib.tp_softmax_cross_entropy(flat, y, g.model_group,
                                                  g.model, smoothing),
                   tplib.tp_errors(flat, y, g.model_group, g.model)]
            if top5:
                out.append(tplib.tp_errors_top_x(flat, y, g.model_group,
                                                 g.model, 5))
        else:
            out = [L.softmax_cross_entropy(flat, y, smoothing),
                   L.errors(flat, y)]
            if top5:
                out.append(L.errors_top_x(flat, y, 5))
        if self.sp > 1:
            from ..parallel.sp import sp_mean
            out = [sp_mean(v, self.grid.seq_group) for v in out]
        return out

    def loss_and_metrics(self, params, bn_state, batch, gen, train: bool):
        flat, y = self._flat(params, batch, train)
        cost, err = self._heads(flat, y, self._label_smoothing(train))
        return cost, err

    def val_metrics(self, params, bn_state, batch):
        flat, y = self._flat(params, batch, False)
        cost, err, err5 = self._heads(flat, y, top5=True)
        return cost, (err, err5)

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0, kv_cache: bool = True, params=None):
        """Sample continuations of ``prompt`` (``[B, p]`` or ``[p]`` token
        ids): greedy at ``temperature=0`` (``argmax``, the first index on
        ties, as ``jnp.argmax``), else categorical at that temperature,
        drawn from a generator seeded ``seed`` on the model's device (the
        JAX package's law, other bits).  Returns ``[B, max_new_tokens]``
        int32 token ids.

        On a fixed ``[B, seq_len]`` token buffer.  ``kv_cache=True``: one
        prefill forward over the buffer (kernel B10 once a layer on the
        card) builds each layer's K/V cache and the head runs on the
        prompt's last row alone; then each step embeds only the new token
        and attends to the cache.  ``kv_cache=False``: the full forward
        over the buffer for every token.  A Python loop over the steps.
        ``params`` (port layout; default :meth:`canonical_params`: the
        EMA shadow when on, an async rule's center or consensus)."""
        if self.grid is not None:
            # a model-parallel layout: every rank gathers the global params
            # (unstacked into blocks under pp) and samples on a dense twin
            # (the same model)
            return self._dense_twin().generate(
                prompt, max_new_tokens, temperature=temperature, seed=seed,
                kv_cache=kv_cache, params=self._gathered_dense_params(params))
        prompt = np.asarray(prompt, dtype=np.int64)
        if prompt.ndim == 1:
            prompt = prompt[None]
        b, p_len = prompt.shape
        assert p_len >= 1, "generate() needs at least one prompt token"
        assert max_new_tokens >= 1, "generate() needs max_new_tokens >= 1"
        assert p_len + max_new_tokens <= self.seq_len, (
            f"prompt {p_len} + {max_new_tokens} new tokens exceeds "
            f"seq_len={self.seq_len} (the position-embedding table)")
        dev = self.device
        params = self.canonical_params() if params is None else tree_map(
            lambda a: a.to(dev) if isinstance(a, torch.Tensor)
            else torch.as_tensor(np.asarray(a), device=dev), params)
        toks = torch.zeros((b, self.seq_len), dtype=torch.int64, device=dev)
        toks[:, :p_len] = torch.from_numpy(prompt).to(dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        body = self._gen_body_kv if kv_cache else self._gen_body
        new = body(params, toks, p_len, gen, float(temperature),
                   int(max_new_tokens))
        return new.to(torch.int32).cpu().numpy()

    def _dense_twin(self):
        """A ``tp = sp = 1`` copy of this model (same dims and class) on
        this rank's device, built once: the sampler of a model-parallel
        layout (``transformer_lm.py:569-588`` there)."""
        if getattr(self, "_twin", None) is None:
            cfg = {k: v for k, v in self.config.items()
                   if k not in ("grid", "tp", "sp", "pp", "data_dir",
                                "pp_microbatches", "pp_interleave")}
            cfg.update(size=1, rank=0, verbose=False, batch_size=1,
                       synthetic_train=2, synthetic_val=2)
            self._twin = type(self)(cfg)
        return self._twin

    def _gathered_dense_params(self, params=None):
        """The dense layout's params: :meth:`canonical_params` (or
        ``params``, this rank's shards) with every split leaf gathered over
        the model and pipe groups, the stacked blocks unstacked; the seq
        group holds them whole (a collective: every rank of those groups
        calls)."""
        params = self.canonical_params() if params is None else tree_map(
            lambda a: torch.as_tensor(np.asarray(a)) if not isinstance(
                a, torch.Tensor) else a, params)
        return self._unstacked(self.gather_params(
            tree_map(lambda a: a.detach(), params)))

    def _next_token(self, row, gen, temp: float):
        """Greedy or categorical choice from one ``[B, V]`` logit row (the
        Gumbel-max draw of ``jax.random.categorical``)."""
        if temp <= 0:
            return torch.argmax(row, dim=-1)
        u = torch.rand(row.shape, generator=gen, device=row.device)
        return torch.argmax(row.float() / max(temp, 1e-6)
                            - torch.log(-torch.log(u)), dim=-1)

    def _gen_body(self, params, toks, start, gen, temp, max_new):
        """The full-forward sampler: the whole buffer's forward a token."""
        out = []
        for pos in range(start, start + max_new):
            logits = self.apply_model(params, toks, train=False, gen=None,
                                      state=None)
            nxt = self._next_token(logits[:, pos - 1], gen, temp)
            toks[:, pos] = nxt
            out.append(nxt)
        return torch.stack(out, dim=1)

    def _gen_body_kv(self, params, toks, start, gen, temp, max_new):
        """The KV-cache sampler: one prefill, then a token a step."""
        t = toks.shape[1]
        h = self._embed(params, toks, torch.arange(t, device=toks.device))
        caches = []
        for blk in self.blocks:
            h, cache = blk.apply_prefill(params[blk.name], h)
            caches.append(cache)
        # the head on the one row consumed, not on the whole buffer
        nxt = self._next_token(self._head(params, h[:, start - 1:start])[:, 0],
                               gen, temp)
        out = [nxt]
        for pos in range(start, start + max_new - 1):
            x1 = self._embed(params, nxt[:, None],
                             torch.tensor([pos], device=toks.device))
            for i, blk in enumerate(self.blocks):
                x1, caches[i] = blk.apply_decode(params[blk.name], x1,
                                                 caches[i], pos)
            nxt = self._next_token(self._head(params, x1)[:, 0], gen, temp)
            out.append(nxt)
        return torch.stack(out, dim=1)


class MoETransformerLM(TransformerLM):
    """The sparse-FFN variant: every ``moe_every``-th block's MLP is a top-k
    (``moe_topk``, 1 or 2) mixture of ``moe_experts`` experts with capacity
    factor ``capacity_factor``; the load-balance loss, averaged over the
    MoE blocks, joins the objective with the coefficient ``moe_aux``.
    ``remat`` applies to the dense model only, as in the JAX package.  At
    ``tp > 1`` the experts shard over the model group beside the
    tensor-parallel attention, at ``sp > 1`` (``tp = 1``) over the seq
    group; ``pp`` needs every block a MoE (``moe_every = 1``)."""

    moe_experts = 4
    moe_every = 2          # every k-th block is MoE (1 = all blocks)
    moe_topk = 1           # experts per token (2 = GShard-style top-2)
    moe_aux = 0.01
    capacity_factor = 1.25

    def build_model(self) -> None:
        for k in ("moe_experts", "moe_every", "moe_topk"):
            if k in self.config:
                setattr(self, k, int(self.config[k]))
        if int(self.config.get("pp", 1)) > 1 and self.moe_every != 1:
            raise ValueError(
                "pipeline parallelism needs a homogeneous block stack: the "
                "mixed MoE/dense stack (moe_every > 1) does not stack over "
                "'pipe'; use moe_every=1 (every block MoE) with pp")
        super().build_model()
        # the JAX package's checks (transformer_lm.py:687-694 there)
        if self.tp > 1 and self.moe_experts % self.tp:
            raise ValueError(f"moe_experts={self.moe_experts} not divisible "
                             f"by tp/ep={self.tp}")
        if self.sp > 1 and self.tp == 1 and self.moe_experts % self.sp:
            raise ValueError(f"moe_experts={self.moe_experts} not divisible "
                             f"by sp={self.sp} (experts shard over 'seq')")
        cd = L.as_dtype(self.config.get("compute_dtype", torch.bfloat16))
        for k in ("moe_aux", "capacity_factor"):
            if k in self.config:
                setattr(self, k, float(self.config[k]))
        attn_impl = str(self.config.get("attn_impl", "reference"))
        self.blocks = [
            MoEBlock(self.d_model, self.n_head, self.moe_experts, cd=cd,
                     capacity_factor=self.capacity_factor,
                     top_k=self.moe_topk, attn_impl=attn_impl,
                     name=f"block{i}", grid=self.grid)
            if (i + 1) % self.moe_every == 0 else
            Block(self.d_model, self.n_head, cd=cd, attn_impl=attn_impl,
                  name=f"block{i}", grid=self.grid)
            for i in range(self.n_layer)]

    def _forward(self, params, x, *, train: bool):
        """Logits and the load-balance loss's mean over the MoE blocks;
        under ``pp`` the mean of the microbatches' (each stage's aux rides
        the pipeline: ``transformer_lm.py:711-742`` there, a known
        deviation from the dense model's, whose routing fractions are the
        whole batch's).  ``x`` is the rank's token block under ``sp``."""
        h = self._embed(params, x, self._pos_ids(x.shape[1], x.device))
        if self.pp > 1:
            h, aux = self._pipeline(params, h, train, with_aux=True)
            return self._head(params, h), \
                aux / (self.pp_microbatches * self.n_layer)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n_moe = 0
        for blk in self.blocks:
            out = blk.apply(params[blk.name], h, train=train)
            if isinstance(blk, MoEBlock):
                h, a = out
                aux = aux + a
                n_moe += 1
            else:
                h = out
        return self._head(params, h), aux / max(n_moe, 1)

    def apply_model(self, params, x, *, train: bool, gen, state):
        return self._forward(params, x, train=train)[0]

    def loss_and_metrics(self, params, bn_state, batch, gen, train: bool):
        """The dense LM's cost and error heads (vocab-parallel under tp,
        averaged over the seq blocks under sp) plus ``moe_aux`` times the
        aux, which every rank holds whole."""
        batch = self._local_tokens(batch)
        logits, aux = self._forward(params, batch["x"], train=train)
        cost, err = self._heads(logits.reshape(-1, logits.shape[-1]),
                                batch["y"].reshape(-1),
                                self._label_smoothing(train))
        return cost + self.moe_aux * aux, err
