"""Layer library.

Counterpart of ``theanompi_tpu/models/layers.py`` for the layers the CNN
slices run: ``init_weight``, ``Sequential``, ``Conv`` (with groups), ``FC``,
``Pool``, ``LRN``, ``Dropout``, ``Flatten``, ``Activation`` and the loss and
error heads; and for the transformer LM's: ``LayerNorm``, ``Embedding`` and
``MultiHeadAttention``.

As in the JAX package a layer is a small object holding static
hyperparameters; ``init(gen)`` returns its parameter tree and
``apply(params, x, train=..., gen=...)`` is a function of its arguments.

* **Activations are NHWC**, as the JAX layers, so the model's input and
  every public tensor compare directly with the JAX package.  A conv views
  its input as NCHW with ``permute`` (channels-last strides, which cuDNN
  takes as they are) and views the result back, so the LRN kernels receive
  contiguous channel rows.
* **Weights are in PyTorch's layout:** conv ``[out, in/groups, kh, kw]``,
  FC and attention projections ``[out, in]``; embedding tables stay
  ``[vocab, dim]``.  ``convert.py`` maps the JAX trees onto them.  A layer
  names the leaves it keeps in the JAX layout (``Layer.kept_layout``:
  ``Embedding``'s ``w``); the model collects their paths
  (``ModelBase.kept_layout_paths``) for ``convert.py`` and the wires.
* **Casts mirror the JAX layers'**, not autocast: conv and FC inputs and
  weights go to ``compute_dtype`` (bfloat16 by default) and the bias is
  added in that type; params stay float32; the loss is taken on float32
  logits.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.lrn import lrn as lrn_op
from ..ops.ring_attention import attention_reference


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", "float32")."""
    if isinstance(d, torch.dtype):
        return d
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(d)]


# ---------------------------------------------------------------------------
# Weight init
# ---------------------------------------------------------------------------

def init_weight(gen: torch.Generator, shape: Sequence[int],
                scheme: Union[str, Tuple[str, float]]) -> torch.Tensor:
    """One float32 weight array, drawn on the CPU from ``gen``.

    ``shape`` is in the JAX package's layout (conv HWIO, FC ``[in, out]``),
    so fans are computed as there; layers permute to their own layout.
    Scheme forms: ``('normal', std)``, ``('constant', c)``, ``'xavier'``
    (Glorot uniform), ``'he'`` (He normal, fan-in)."""
    kind, arg = scheme if isinstance(scheme, tuple) else (scheme, None)
    shape = tuple(shape)
    if kind == "normal":
        std = 0.01 if arg is None else arg
        return std * torch.randn(shape, generator=gen)
    if kind == "constant":
        return torch.full(shape, 0.0 if arg is None else float(arg))
    fan_in, fan_out = _fans(shape)
    if kind == "xavier":
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit
    if kind == "he":
        return math.sqrt(2.0 / fan_in) * torch.randn(shape, generator=gen)
    raise ValueError(f"unknown init scheme {kind!r}")


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[:-2]))     # conv HWIO
    return rf * shape[-2], rf * shape[-1]


# ---------------------------------------------------------------------------
# Layer base + Sequential
# ---------------------------------------------------------------------------

class Layer:
    name: str = "layer"
    # keys of this layer's 2-D leaves stored as the JAX package stores them
    # (an embedding table, [vocab, dim] in both); every other 2-D weight is
    # the JAX one transposed
    kept_layout: Tuple[str, ...] = ()

    def init(self, gen: torch.Generator) -> Any:
        return None

    def sublayers(self) -> Dict[str, "Layer"]:
        """Child layers by their key in this layer's params."""
        return {}

    def kept_layout_paths(self) -> set:
        """Paths, from this layer's params, of the leaves that keep the JAX
        layout: its own ``kept_layout`` and its sublayers'."""
        out = {(k,) for k in self.kept_layout}
        for key, sub in self.sublayers().items():
            out |= {(key,) + p for p in sub.kept_layout_paths()}
        return out

    def apply(self, params, x, *, train: bool = False,
              gen: Optional[torch.Generator] = None):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class Sequential(Layer):
    """Composes layers; params are a dict keyed by unique layer names
    (a repeated name gets ``_1``, ``_2``... as in the JAX package)."""

    def __init__(self, layers: List[Layer]):
        self.layers = layers
        seen: Dict[str, int] = {}
        self._keys = []
        for l in layers:
            n = l.name
            if n in seen:
                seen[n] += 1
                n = f"{n}_{seen[l.name]}"
            else:
                seen[n] = 0
            self._keys.append(n)

    def sublayers(self) -> Dict[str, Layer]:
        return dict(zip(self._keys, self.layers))

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        params = {}
        for k, layer in zip(self._keys, self.layers):
            p = layer.init(gen)
            if p is not None:
                params[k] = p
        return params

    def apply(self, params, x, *, train=False, gen=None):
        for k, layer in zip(self._keys, self.layers):
            x = layer.apply(params.get(k), x, train=train, gen=gen)
        return x


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _activate(x, kind: Optional[str]):
    if kind is None or kind == "linear":
        return x
    if kind == "relu":
        return torch.relu(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "leaky_relu":
        return F.leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# Conv / FC / Pool / LRN / Dropout / Flatten / Activation
# ---------------------------------------------------------------------------

class Conv(Layer):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1,
                 padding: Union[str, int] = "SAME", groups: int = 1,
                 w_init=("normal", 0.01), b_init=("constant", 0.0),
                 activation: Optional[str] = "relu",
                 compute_dtype=torch.bfloat16, name: str = "conv"):
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel, self.stride = _pair(kernel), _pair(stride)
        if isinstance(padding, str):
            padding = padding.upper()
            if padding not in ("SAME", "VALID"):
                raise ValueError(f"padding {padding!r}")
        self.padding = padding
        self.groups = groups
        self.w_init, self.b_init = w_init, b_init
        self.activation = activation
        self.compute_dtype = as_dtype(compute_dtype)
        self.name = name

    def init(self, gen):
        kh, kw = self.kernel
        w = init_weight(gen, (kh, kw, self.in_ch // self.groups, self.out_ch),
                        self.w_init)
        b = init_weight(gen, (self.out_ch,), self.b_init)
        return {"w": w.permute(3, 2, 0, 1).contiguous(), "b": b}

    def _pads(self, h: int, w: int):
        """(left, right, top, bottom) zero padding of XLA's SAME/VALID or an
        explicit int, as F.pad orders it."""
        if self.padding == "VALID":
            return (0, 0, 0, 0)
        if isinstance(self.padding, int):
            p = self.padding
            return (p, p, p, p)
        out = []
        for size, k, s in ((w, self.kernel[1], self.stride[1]),
                           (h, self.kernel[0], self.stride[0])):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            out += [total // 2, total - total // 2]
        return tuple(out)

    def apply(self, params, x, *, train=False, gen=None):
        cd = self.compute_dtype
        xc = x.to(cd).permute(0, 3, 1, 2)          # NHWC → NCHW view
        pads = self._pads(xc.shape[2], xc.shape[3])
        if pads[0] == pads[1] and pads[2] == pads[3]:
            y = F.conv2d(xc, params["w"].to(cd), stride=self.stride,
                         padding=(pads[2], pads[0]), groups=self.groups)
        else:                                       # asymmetric SAME
            y = F.conv2d(F.pad(xc, pads), params["w"].to(cd),
                         stride=self.stride, groups=self.groups)
        y = y.permute(0, 2, 3, 1) + params["b"].to(cd)
        return _activate(y, self.activation)


class FC(Layer):
    def __init__(self, n_in: int, n_out: int, w_init=("normal", 0.005),
                 b_init=("constant", 0.0), activation: Optional[str] = "relu",
                 compute_dtype=torch.bfloat16, name: str = "fc"):
        self.n_in, self.n_out = n_in, n_out
        self.w_init, self.b_init = w_init, b_init
        self.activation = activation
        self.compute_dtype = as_dtype(compute_dtype)
        self.name = name

    def init(self, gen):
        w = init_weight(gen, (self.n_in, self.n_out), self.w_init)
        b = init_weight(gen, (self.n_out,), self.b_init)
        return {"w": w.t().contiguous(), "b": b}

    def apply(self, params, x, *, train=False, gen=None):
        cd = self.compute_dtype
        y = torch.matmul(x.to(cd), params["w"].to(cd).t())
        y = y + params["b"].to(cd)
        return _activate(y, self.activation)


class Pool(Layer):
    """Max or average pooling over NHWC; VALID windows."""

    def __init__(self, size=2, stride=None, mode: str = "max",
                 padding: str = "VALID", name: str = "pool"):
        self.size = _pair(size)
        self.stride = _pair(stride if stride is not None else self.size)
        if mode not in ("max", "avg"):
            raise ValueError(f"pool mode {mode!r}")
        if padding != "VALID":
            raise NotImplementedError("SAME pooling is not ported yet")
        self.mode, self.padding = mode, padding
        self.name = name

    def apply(self, params, x, *, train=False, gen=None):
        xc = x.permute(0, 3, 1, 2)
        if self.mode == "max":
            y = F.max_pool2d(xc, self.size, self.stride, padding=0,
                             ceil_mode=False)
        else:
            y = F.avg_pool2d(xc, self.size, self.stride, padding=0,
                             ceil_mode=False)
        return y.permute(0, 2, 3, 1)


class LRN(Layer):
    """Cross-channel local response normalization:
    ``b = a / (k + alpha/n * sum_window a^2)^beta``.

    A CUDA tensor always goes through the hand-written kernels (B1/B2),
    a CPU tensor through their plain version; ``impl`` is kept for config
    compatibility with the JAX package and chooses nothing."""

    def __init__(self, n: int = 5, k: float = 2.0, alpha: float = 1e-4,
                 beta: float = 0.75, impl: str = "band", name: str = "lrn"):
        self.n, self.k, self.alpha, self.beta = n, k, alpha, beta
        self.impl = impl
        self.name = name

    def apply(self, params, x, *, train=False, gen=None):
        # the kernels take contiguous channel rows; conv outputs in
        # channels-last memory already are, so this copies nothing there
        return lrn_op(x.contiguous(), self.n, self.k, self.alpha, self.beta)


class Dropout(Layer):
    def __init__(self, rate: float = 0.5, name: str = "dropout"):
        self.rate = rate
        self.name = name

    def apply(self, params, x, *, train=False, gen=None):
        if not train or self.rate == 0.0:
            return x
        if gen is None:
            raise ValueError("Dropout in train mode needs a generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class Flatten(Layer):
    """Flattens NHWC in (h, w, c) order, as the JAX layer, so that the next
    FC's weight converts from the JAX package by a plain transpose."""

    def __init__(self, name: str = "flatten"):
        self.name = name

    def apply(self, params, x, *, train=False, gen=None):
        return x.reshape(x.shape[0], -1)


class Activation(Layer):
    def __init__(self, kind: str = "relu", name: str = "act"):
        self.kind = kind
        self.name = name

    def apply(self, params, x, *, train=False, gen=None):
        return _activate(x, self.kind)


class LayerNorm(Layer):
    """Layer normalization over the trailing feature dim: f32 statistics
    (population variance), output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, name: str = "ln"):
        self.dim, self.eps = dim, eps
        self.name = name

    def init(self, gen):
        return {"scale": torch.ones(self.dim), "bias": torch.zeros(self.dim)}

    def apply(self, params, x, *, train=False, gen=None):
        y = F.layer_norm(x.float(), (self.dim,), params["scale"],
                         params["bias"], self.eps)
        return y.to(x.dtype)


class Embedding(Layer):
    """Token embedding lookup: a float32 ``[vocab, dim]`` table, output cast
    to ``compute_dtype``.  The table is ``[vocab, dim]`` in the JAX package
    too, so it keeps its layout."""

    kept_layout = ("w",)

    def __init__(self, vocab: int, dim: int, w_init=("normal", 0.02),
                 compute_dtype=torch.bfloat16, name: str = "embed"):
        self.vocab, self.dim = vocab, dim
        self.w_init = w_init
        self.compute_dtype = as_dtype(compute_dtype)
        self.name = name

    def init(self, gen):
        return {"w": init_weight(gen, (self.vocab, self.dim), self.w_init)}

    def apply(self, params, x, *, train=False, gen=None):
        return params["w"].to(self.compute_dtype)[x.long()]


class MultiHeadAttention(Layer):
    """Causal multi-head self-attention over ``[B, T, D]``.

    The q/k/v/o projections are products in ``compute_dtype`` with
    ``[out, in]`` weights.  ``attn_impl='reference'`` attends through
    :func:`ops.ring_attention.attention_reference` (torch ops);
    ``'flash'`` through :func:`ops.flash_attention.flash_attention`, which on
    a CUDA tensor always launches kernel B10 (and B11/B12 in the backward).
    q, k and v reach it as ``[B, H, T, hd]`` views of the ``[B, T, D]``
    products, and the kernels write its output laid out as ``[B, T, H, hd]``,
    so on the card no copy is made on either side."""

    def __init__(self, dim: int, n_head: int, causal: bool = True,
                 w_init=("normal", 0.02), compute_dtype=torch.bfloat16,
                 attn_impl: str = "reference", name: str = "attn"):
        if dim % n_head:
            raise ValueError(f"dim {dim} not divisible by n_head {n_head}")
        if attn_impl not in ("reference", "flash"):
            raise ValueError(f"attn_impl {attn_impl!r}; have 'reference', "
                             f"'flash'")
        self.dim, self.n_head, self.causal = dim, n_head, causal
        self.w_init = w_init
        self.compute_dtype = as_dtype(compute_dtype)
        self.attn_impl = attn_impl
        self.name = name

    def _attend(self, q, k, v):
        """[B, H, T, hd] → [B, H, T, hd] softmax attention."""
        if self.attn_impl == "flash":
            return flash_attention(q, k, v, causal=self.causal,
                                   sm_scale=1.0 / (q.shape[-1] ** 0.5))
        return attention_reference(q, k, v, causal=self.causal)

    def init(self, gen):
        mk = lambda: init_weight(gen, (self.dim, self.dim), self.w_init).t()
        return {n: mk().contiguous() for n in ("wq", "wk", "wv", "wo")}

    def _proj(self, params, x, name):
        cd = self.compute_dtype
        b, t, _ = x.shape
        y = torch.matmul(x.to(cd), params[name].to(cd).t())
        return y.view(b, t, self.n_head, -1).transpose(1, 2)   # [B,H,T,hd]

    def apply(self, params, x, *, train=False, gen=None):
        cd = self.compute_dtype
        b, t, d = x.shape
        o = self._attend(self._proj(params, x, "wq"),
                         self._proj(params, x, "wk"),
                         self._proj(params, x, "wv"))
        o = o.transpose(1, 2).reshape(b, t, d)
        return torch.matmul(o.to(cd), params["wo"].to(cd).t())


# ---------------------------------------------------------------------------
# Loss / error heads
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean NLL of integer ``labels`` under softmax(logits), in float32;
    ``label_smoothing=ε`` gives (1−ε)·NLL + ε·mean_k(−log p_k)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    nll = torch.mean(logz - ll)
    if label_smoothing:
        eps = float(label_smoothing)
        uniform = logz - torch.mean(logits, dim=-1)
        return (1.0 - eps) * nll + eps * torch.mean(uniform)
    return nll


def errors(logits, labels) -> torch.Tensor:
    """Top-1 error rate."""
    return torch.mean((torch.argmax(logits, dim=-1) != labels).float())


def errors_top_x(logits, labels, x: int = 5) -> torch.Tensor:
    """Top-x error rate, x clamped to the class count."""
    x = min(x, logits.shape[-1])
    topk = torch.topk(logits, x, dim=-1).indices
    hit = torch.any(topk == labels[:, None], dim=-1)
    return torch.mean((~hit).float())
