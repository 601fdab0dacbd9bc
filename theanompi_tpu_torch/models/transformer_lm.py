"""Decoder-only transformer language model.

Counterpart of ``theanompi_tpu/models/transformer_lm.py`` for the dense
model on one device per rank (``tp = pp = sp = 1``): ``LMData`` (the
synthetic token stream, bit-equal to the JAX package's), the pre-LN
``Block`` and ``TransformerLM``, trained under the same model contract as
the CNN zoo::

    BSP().init(devices=1, modelfile='theanompi_tpu_torch.models.transformer_lm',
               modelclass='TransformerLM', attn_impl='flash', ...)

``attn_impl='flash'`` runs every attention through the hand-written kernels
B10–B12 on the card (``ops/flash_attention.py``), which take bfloat16 only:
on a CUDA device another compute dtype is refused when the model is built
(:func:`check_flash_dtype`); ``'reference'`` runs through torch ops.
Tensor, pipeline and sequence parallelism, ``remat``, real token files
(``data_dir``), ``generate`` and the MoE model are not ported yet and
raise.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """Pre-LN transformer block: LN→MHA→residual, LN→MLP→residual."""

    def __init__(self, dim, n_head, mlp_ratio=4, cd=torch.bfloat16,
                 attn_impl="reference", name="block"):
        self.name = name
        self.ln1 = L.LayerNorm(dim, name="ln1")
        self.attn = L.MultiHeadAttention(dim, n_head, compute_dtype=cd,
                                         attn_impl=attn_impl, name="attn")
        self.ln2 = L.LayerNorm(dim, name="ln2")
        self.fc1 = L.FC(dim, mlp_ratio * dim, w_init=("normal", 0.02),
                        activation="relu", compute_dtype=cd, name="fc1")
        self.fc2 = L.FC(mlp_ratio * dim, dim, w_init=("normal", 0.02),
                        activation=None, compute_dtype=cd, name="fc2")

    def sublayers(self):
        return {"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                "fc1": self.fc1, "fc2": self.fc2}

    def init(self, gen):
        return {k: layer.init(gen) for k, layer in self.sublayers().items()}

    def apply(self, params, x, *, train=False, gen=None):
        h = self.ln1.apply(params["ln1"], x)
        x = x + self.attn.apply(params["attn"], h, train=train)
        h = self.fc1.apply(params["fc1"], self.ln2.apply(params["ln2"], x))
        return x + self.fc2.apply(params["fc2"], h)


def check_flash_dtype(attn_impl: str, compute_dtype: torch.dtype,
                      device) -> None:
    """Refuse ``attn_impl='flash'`` with a compute dtype other than
    bfloat16 on a CUDA device: the flash kernels B10–B12 take bfloat16
    only.  On the CPU the plain versions compute any dtype."""
    if attn_impl == "flash" and torch.device(device).type == "cuda" and \
            compute_dtype != torch.bfloat16:
        raise ValueError(f"attn_impl='flash' on {device} needs "
                         f"compute_dtype bfloat16: the flash kernels B10-B12 "
                         f"take bfloat16 only; got {compute_dtype}")


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
        for k in ("tp", "pp", "sp"):
            if int(self.config.get(k, 1)) != 1:
                raise NotImplementedError(f"{k} > 1 is not ported yet")
        for k in ("remat", "data_dir"):
            if self.config.get(k):
                raise NotImplementedError(f"config {k!r} is not ported yet")
        attn_impl = str(self.config.get("attn_impl", "reference"))
        if attn_impl == "flash" and self.seq_len % 128:
            # the JAX package's build-time check, kept for the same configs
            raise ValueError(f"attn_impl='flash' needs seq_len a multiple of "
                             f"the kernel's 128-wide blocks; got "
                             f"{self.seq_len}")
        check_flash_dtype(attn_impl, cd, self.device)
        self.embed = L.Embedding(self.vocab, self.d_model, compute_dtype=cd)
        self.pos = L.Embedding(self.seq_len, self.d_model, compute_dtype=cd,
                               name="pos")
        self.blocks = [Block(self.d_model, self.n_head, cd=cd,
                             attn_impl=attn_impl, name=f"block{i}")
                       for i in range(self.n_layer)]
        self.ln_f = L.LayerNorm(self.d_model, name="ln_f")
        self.head = L.FC(self.d_model, self.vocab, w_init=("normal", 0.02),
                         activation=None, compute_dtype=cd, name="head")
        self.data = LMData(self.config, self.batch_size)

    def layers(self):
        return dict({"embed": self.embed, "pos": self.pos, "ln_f": self.ln_f,
                     "head": self.head}, **{b.name: b for b in self.blocks})

    def init_params(self, gen):
        return {k: layer.init(gen) for k, layer in self.layers().items()}

    def apply_model(self, params, x, *, train: bool, gen):
        t = x.shape[1]
        h = self.embed.apply(params["embed"], x) + \
            self.pos.apply(params["pos"], torch.arange(t, device=x.device))[None]
        for blk in self.blocks:
            h = blk.apply(params[blk.name], h, train=train)
        h = self.ln_f.apply(params["ln_f"], h)
        return self.head.apply(params["head"], h)

    def _flat(self, params, batch, train):
        logits = self.apply_model(params, batch["x"], train=train, gen=None)
        return logits.reshape(-1, logits.shape[-1]), batch["y"].reshape(-1)

    def loss_and_metrics(self, params, batch, gen, train: bool):
        flat, y = self._flat(params, batch, train)
        cost = L.softmax_cross_entropy(flat, y, self._label_smoothing(train))
        return cost, L.errors(flat, y)

    def val_metrics(self, params, batch):
        flat, y = self._flat(params, batch, False)
        return L.softmax_cross_entropy(flat, y), (L.errors(flat, y),
                                                  L.errors_top_x(flat, y, 5))

    def generate(self, *args, **kwargs):
        raise NotImplementedError("generate (the KV-cache sampler) is not "
                                  "ported yet")


class MoETransformerLM(TransformerLM):
    """The sparse-FFN variant of the JAX package: not ported yet."""

    def __init__(self, config=None):
        raise NotImplementedError("MoETransformerLM is not ported yet")
