"""GoogLeNet (Inception v1) with its two auxiliary classifiers.

Counterpart of ``theanompi_tpu/models/googlenet.py``, layer for layer at the
same widths and init schemes: ImageNet-1k, batch 32 per rank, 3×224×224
NHWC input; the stem (7×7/2 conv, SAME 3×3/2 max pool, LRN, 1×1 and 3×3
convs, LRN, SAME max pool), nine inception modules, global average
pooling, dropout 0.4 and a 1000-way FC; two auxiliary heads on the outputs
of 4a and 4d (5×5/3 VALID average pool, 1×1 conv 128, FC 1024, dropout
0.7, FC) weighted 0.3 into the training loss and dropped at eval; momentum
SGD (0.9), weight decay 2e-4, lr 0.01 ÷10 at epochs 20/40/60.  Compute is
bfloat16 with float32 params unless ``compute_dtype`` says otherwise.  On
the card both LRNs run the hand-written kernels B1/B2.

The aux taps make the trunk a staged pipeline rather than one Sequential,
so the model names its parts in ``layers()`` and composes them itself.
"""

from __future__ import annotations

import torch

from . import layers as L
from .data.imagenet import ImageNet_data
from .model_base import ModelBase


class Inception(L.Layer):
    """Four-branch inception module: 1×1 / 1×1→3×3 / 1×1→5×5 / SAME 3×3/1
    max pool→1×1, concatenated on the channel axis (NHWC's last)."""

    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, pp, cd, name):
        self.name = name
        self.out_ch = c1 + c3 + c5 + pp
        k = dict(w_init="he", compute_dtype=cd)
        self.b1 = L.Sequential([L.Conv(in_ch, c1, 1, name="1x1", **k)])
        self.b2 = L.Sequential([
            L.Conv(in_ch, c3r, 1, name="3x3r", **k),
            L.Conv(c3r, c3, 3, padding="SAME", name="3x3", **k)])
        self.b3 = L.Sequential([
            L.Conv(in_ch, c5r, 1, name="5x5r", **k),
            L.Conv(c5r, c5, 5, padding="SAME", name="5x5", **k)])
        self.b4_pool = L.Pool(3, 1, mode="max", padding="SAME", name="pool")
        self.b4 = L.Sequential([L.Conv(in_ch, pp, 1, name="poolproj", **k)])

    def sublayers(self):
        return {"b1": self.b1, "b2": self.b2, "b3": self.b3, "b4": self.b4}

    def apply(self, params, x, *, train=False, gen=None):
        ys = [self.b1.apply(params["b1"], x), self.b2.apply(params["b2"], x),
              self.b3.apply(params["b3"], x),
              self.b4.apply(params["b4"], self.b4_pool.apply(None, x))]
        return torch.cat(ys, dim=-1)


class GoogLeNet(ModelBase):
    batch_size = 32
    epochs = 70
    n_subb = 1
    learning_rate = 0.01
    momentum = 0.9
    weight_decay = 0.0002
    lr_adjust_epochs = (20, 40, 60)
    n_class = 1000
    aux_weight = 0.3

    def build_model(self) -> None:
        cd = self.config.get("compute_dtype", "bfloat16")
        nc = self.config.get("n_class", self.n_class)
        k = dict(w_init="he", compute_dtype=cd)

        self.stem = L.Sequential([
            L.Conv(3, 64, 7, stride=2, padding=3, name="conv1", **k),
            L.Pool(3, 2, mode="max", padding="SAME", name="pool1"),
            L.LRN(name="lrn1"),
            L.Conv(64, 64, 1, name="conv2r", **k),
            L.Conv(64, 192, 3, padding="SAME", name="conv2", **k),
            L.LRN(name="lrn2"),
            L.Pool(3, 2, mode="max", padding="SAME", name="pool2"),
        ])
        self.stage3 = L.Sequential([
            Inception(192, 64, 96, 128, 16, 32, 32, cd, "3a"),
            Inception(256, 128, 128, 192, 32, 96, 64, cd, "3b"),
            L.Pool(3, 2, mode="max", padding="SAME", name="pool3"),
        ])
        self.stage4a = L.Sequential([
            Inception(480, 192, 96, 208, 16, 48, 64, cd, "4a")])
        self.stage4bcd = L.Sequential([
            Inception(512, 160, 112, 224, 24, 64, 64, cd, "4b"),
            Inception(512, 128, 128, 256, 24, 64, 64, cd, "4c"),
            Inception(512, 112, 144, 288, 32, 64, 64, cd, "4d"),
        ])
        self.stage4e = L.Sequential([
            Inception(528, 256, 160, 320, 32, 128, 128, cd, "4e"),
            L.Pool(3, 2, mode="max", padding="SAME", name="pool4"),
        ])
        self.stage5 = L.Sequential([
            Inception(832, 256, 160, 320, 32, 128, 128, cd, "5a"),
            Inception(832, 384, 192, 384, 48, 128, 128, cd, "5b"),
        ])
        self.head = L.Sequential([
            L.Dropout(0.4, name="drop"),
            L.FC(1024, nc, w_init=("normal", 0.01), activation=None,
                 compute_dtype=cd, name="softmax"),
        ])

        # the aux taps sit after four stride-2 stages (conv1, pool1, pool2,
        # pool3, each rounding up), so their side is crop/16 rounded up,
        # and the aux 5×5/3 VALID average pool shrinks it again: 224 → 14
        # → 4
        crop = int(self.config.get("crop_size", 224))
        s = crop
        for _ in range(4):
            s = (s + 1) // 2
        aux_sp = (s - 5) // 3 + 1
        assert aux_sp >= 1, f"crop {crop} too small for the aux heads"

        def aux_head(in_ch, name):
            return L.Sequential([
                L.Pool(5, 3, mode="avg", name=f"{name}_pool"),
                L.Conv(in_ch, 128, 1, name=f"{name}_conv", **k),
                L.Flatten(name=f"{name}_flat"),
                L.FC(128 * aux_sp * aux_sp, 1024, w_init="he",
                     compute_dtype=cd, name=f"{name}_fc"),
                L.Dropout(0.7, name=f"{name}_drop"),
                L.FC(1024, nc, w_init=("normal", 0.01), activation=None,
                     compute_dtype=cd, name=f"{name}_out"),
            ])

        self.aux1 = aux_head(512, "aux1")   # taps the output of 4a
        self.aux2 = aux_head(528, "aux2")   # taps the output of 4d
        self.data = ImageNet_data(self.config, self.batch_size, crop=224)

    def layers(self):
        return {"stem": self.stem, "stage3": self.stage3,
                "stage4a": self.stage4a, "stage4bcd": self.stage4bcd,
                "stage4e": self.stage4e, "stage5": self.stage5,
                "head": self.head, "aux1": self.aux1, "aux2": self.aux2}

    def _trunk(self, params, x, train, gen):
        """Main logits and the two aux taps (4a's and 4d's outputs)."""
        def run(part, x):
            return getattr(self, part).apply(params[part], x, train=train,
                                             gen=gen)

        x = run("stage4a", run("stage3", run("stem", x)))
        t4a = x
        t4d = x = run("stage4bcd", x)
        x = run("stage5", run("stage4e", x))
        x = torch.mean(x, dim=(1, 2))            # global average pool 7×7
        return run("head", x), t4a, t4d

    def apply_model(self, params, x, *, train, gen, state):
        return self._trunk(params, x, train, gen)[0]

    def loss_and_metrics(self, params, bn_state, batch, gen, train: bool):
        """Softmax cross-entropy of the main head, plus 0.3× each aux
        head's in training; top-1 error of the main head."""
        logits, t4a, t4d = self._trunk(
            params, self.stage_input(batch["x"]), train, gen)
        ls = self._label_smoothing(train)
        y = batch["y"]
        cost = L.softmax_cross_entropy(logits, y, ls)
        if train:
            a1 = self.aux1.apply(params["aux1"], t4a, train=True, gen=gen)
            a2 = self.aux2.apply(params["aux2"], t4d, train=True, gen=gen)
            cost = cost + self.aux_weight * (
                L.softmax_cross_entropy(a1, y, ls)
                + L.softmax_cross_entropy(a2, y, ls))
        return cost, L.errors(logits, y)
