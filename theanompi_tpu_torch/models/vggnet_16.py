"""VGG-16 (and the VGG-11 "shallow" variant).

Counterpart of ``theanompi_tpu/models/vggnet_16.py``, layer for layer at the
same widths and init schemes: ImageNet-1k, batch 32 per rank, 3×224×224 NHWC
input, 3×3 SAME conv stacks (He init) with 2×2/2 max-pooling, the
dropout-regularized 4096-wide FC head, momentum SGD (0.9) with weight decay
5e-4, and the step LR schedule (÷10 at epochs 25/50/65).  Compute is
bfloat16 with float32 params unless ``compute_dtype`` says otherwise.  With
~138M parameters it is the zoo's communication stress test, the model of
the compressed wire (``exch_strategy='onebit'``).
"""

from __future__ import annotations

from . import layers as L
from .data.imagenet import ImageNet_data
from .model_base import ModelBase

# (channels, n_convs) per block — 'D' configuration
_VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# 'A' configuration (the reference's "shallow" VGG-11)
_VGG11_BLOCKS = ((64, 1), (128, 1), (256, 2), (512, 2), (512, 2))


def _vgg_stack(blocks, cd, n_class):
    layers = []
    in_ch = 3
    for bi, (ch, reps) in enumerate(blocks, start=1):
        for ci in range(reps):
            layers.append(L.Conv(in_ch, ch, 3, padding="SAME", w_init="he",
                                 compute_dtype=cd,
                                 name=f"conv{bi}_{ci + 1}"))
            in_ch = ch
        layers.append(L.Pool(2, 2, mode="max", name=f"pool{bi}"))
    layers += [
        L.Flatten(),
        L.FC(512 * 7 * 7, 4096, w_init=("normal", 0.005),
             b_init=("constant", 0.1), compute_dtype=cd, name="fc6"),
        L.Dropout(0.5, name="drop6"),
        L.FC(4096, 4096, w_init=("normal", 0.005),
             b_init=("constant", 0.1), compute_dtype=cd, name="fc7"),
        L.Dropout(0.5, name="drop7"),
        L.FC(4096, n_class, w_init=("normal", 0.01), activation=None,
             compute_dtype=cd, name="softmax"),
    ]
    return L.Sequential(layers)


class VGGNet_16(ModelBase):
    batch_size = 32
    epochs = 70
    n_subb = 1
    learning_rate = 0.01
    momentum = 0.9
    weight_decay = 0.0005
    lr_adjust_epochs = (25, 50, 65)
    n_class = 1000

    blocks = _VGG16_BLOCKS

    def build_model(self) -> None:
        cd = self.config.get("compute_dtype", "bfloat16")
        nc = self.config.get("n_class", self.n_class)
        self.seq = _vgg_stack(self.blocks, cd, nc)
        self.data = ImageNet_data(self.config, self.batch_size, crop=224)


class VGGNet_11_shallow(VGGNet_16):
    blocks = _VGG11_BLOCKS


VGGNet = VGGNet_16
