"""ResNet-50.

Counterpart of ``theanompi_tpu/models/resnet50.py``, layer for layer at the
same widths and init schemes: the He et al. 2015 bottleneck network,
ImageNet-1k, batch 32 per rank, 3×224×224 NHWC input; a 7×7/2 conv with
BatchNorm, a SAME 3×3/2 max pool, four stages of bottlenecks (a projection
shortcut on each stage's first block), global average pooling and a
2048 → 1000 FC; momentum SGD (0.9), weight decay 1e-4, lr 0.1 ÷10 at
epochs 30/60/80.  The residual add and its ReLU are in the compute dtype
(bfloat16 by default).  It is the zoo's model with BatchNorm running
state: ``model.bn_state`` (``{"trunk": ...}``), updated in place by every
training forward and averaged over the ranks after every step.
``bn_norm_dtype='bfloat16'`` normalizes in bf16 with float32 statistics
(``layers.BatchNorm``).
"""

from __future__ import annotations

import torch

from . import layers as L
from .data.imagenet import ImageNet_data
from .model_base import ModelBase


class ConvBN(L.Layer):
    """conv (no activation) → BatchNorm → ReLU (optional)."""

    has_state = True

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding="SAME",
                 relu=True, cd="bfloat16", bn_nd=None, name="convbn"):
        self.name = name
        self.conv = L.Conv(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, w_init="he", activation=None,
                           compute_dtype=cd, name="conv")
        self.bn = L.BatchNorm(out_ch, norm_dtype=bn_nd, name="bn")
        self.relu = relu

    def sublayers(self):
        return {"conv": self.conv, "bn": self.bn}

    def apply(self, params, x, *, train=False, gen=None, state=None):
        y = self.conv.apply(params["conv"], x)
        y = self.bn.apply(params["bn"], y, train=train, state=state["bn"])
        return torch.relu(y) if self.relu else y


class Bottleneck(L.Layer):
    """1×1 → 3×3 (stride) → 1×1 ConvBNs, with an identity or a projection
    (1×1 ConvBN, stride) shortcut; ReLU after the add."""

    has_state = True

    def __init__(self, in_ch, mid_ch, out_ch, stride=1, project=False,
                 cd="bfloat16", bn_nd=None, name="block"):
        self.name = name
        self.a = ConvBN(in_ch, mid_ch, 1, cd=cd, bn_nd=bn_nd, name="a")
        self.b = ConvBN(mid_ch, mid_ch, 3, stride=stride, cd=cd, bn_nd=bn_nd,
                        name="b")
        self.c = ConvBN(mid_ch, out_ch, 1, relu=False, cd=cd, bn_nd=bn_nd,
                        name="c")
        self.project = project
        if project:
            self.proj = ConvBN(in_ch, out_ch, 1, stride=stride, relu=False,
                               cd=cd, bn_nd=bn_nd, name="proj")

    def sublayers(self):
        subs = {"a": self.a, "b": self.b, "c": self.c}
        if self.project:
            subs["proj"] = self.proj
        return subs

    def apply(self, params, x, *, train=False, gen=None, state=None):
        def run(name, inp):
            return getattr(self, name).apply(params[name], inp, train=train,
                                             state=state[name])

        y = run("c", run("b", run("a", x)))
        sc = run("proj", x) if self.project else x
        return torch.relu(y + sc)


class ResNet50(ModelBase):
    batch_size = 32
    epochs = 90
    n_subb = 1
    learning_rate = 0.1
    momentum = 0.9
    weight_decay = 0.0001
    lr_adjust_epochs = (30, 60, 80)
    n_class = 1000

    # (mid_ch, out_ch, n_blocks, first_stride) per stage
    stages = ((64, 256, 3, 1), (128, 512, 4, 2),
              (256, 1024, 6, 2), (512, 2048, 3, 2))

    def build_model(self) -> None:
        cd = self.config.get("compute_dtype", "bfloat16")
        # 'bfloat16': normalize in bf16 with float32 statistics; default
        # (None or 'none') normalizes in float32
        bn_nd = self.config.get("bn_norm_dtype")
        if bn_nd == "none":
            bn_nd = None
        nc = self.config.get("n_class", self.n_class)
        layers = [
            ConvBN(3, 64, 7, stride=2, padding=3, cd=cd, bn_nd=bn_nd,
                   name="conv1"),
            L.Pool(3, 2, mode="max", padding="SAME", name="pool1"),
        ]
        in_ch = 64
        for si, (mid, out, reps, stride) in enumerate(self.stages, start=2):
            for bi in range(reps):
                layers.append(Bottleneck(
                    in_ch, mid, out, stride=stride if bi == 0 else 1,
                    project=(bi == 0), cd=cd, bn_nd=bn_nd,
                    name=f"res{si}_{bi + 1}"))
                in_ch = out
        self.trunk = L.Sequential(layers)
        self.fc = L.FC(2048, nc, w_init=("normal", 0.01), activation=None,
                       compute_dtype=cd, name="softmax")
        self.data = ImageNet_data(self.config, self.batch_size, crop=224)

    def layers(self):
        return {"trunk": self.trunk, "fc": self.fc}

    def apply_model(self, params, x, *, train, gen, state):
        y = self.trunk.apply(params["trunk"], x, train=train, gen=gen,
                             state=state["trunk"])
        y = torch.mean(y, dim=(1, 2))             # global average pool
        return self.fc.apply(params["fc"], y)
