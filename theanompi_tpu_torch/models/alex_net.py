"""AlexNet — the reference's main benchmark model.

Counterpart of ``theanompi_tpu/models/alex_net.py``, layer for layer at the
same widths and init schemes: ImageNet-1k, batch 128 per rank, 3×227×227
NHWC input, the two-group convolutions, LRN, overlapping 3×3/2 max-pooling,
the dropout-regularized 4096-wide FC head, momentum SGD (0.9) with weight
decay 5e-4, and the step LR schedule (÷10 at epochs 20/40/60).  Compute is
bfloat16 with float32 params unless ``compute_dtype`` says otherwise.  On
the card every LRN runs the hand-written kernels B1/B2.
"""

from __future__ import annotations

from . import layers as L
from .data.imagenet import ImageNet_data
from .model_base import ModelBase


class AlexNet(ModelBase):
    batch_size = 128
    epochs = 70
    n_subb = 1
    learning_rate = 0.01
    momentum = 0.9
    weight_decay = 0.0005
    lr_adjust_epochs = (20, 40, 60)

    n_class = 1000

    def build_model(self) -> None:
        cd = self.config.get("compute_dtype", "bfloat16")
        nc = self.config.get("n_class", self.n_class)
        lrn_impl = self.config.get("lrn_impl", "band")
        self.seq = L.Sequential([
            # conv1: 96 kernels 11×11 stride 4, LRN, pool 3/2  (227→55→27)
            L.Conv(3, 96, 11, stride=4, padding="VALID",
                   w_init=("normal", 0.01), b_init=("constant", 0.0),
                   compute_dtype=cd, name="conv1"),
            L.LRN(impl=lrn_impl, name="lrn1"),
            L.Pool(3, 2, mode="max", name="pool1"),
            # conv2: 256 kernels 5×5 pad 2, 2 groups, LRN, pool  (27→13)
            L.Conv(96, 256, 5, padding=2, groups=2,
                   w_init=("normal", 0.01), b_init=("constant", 0.1),
                   compute_dtype=cd, name="conv2"),
            L.LRN(impl=lrn_impl, name="lrn2"),
            L.Pool(3, 2, mode="max", name="pool2"),
            # conv3/4/5  (13→13, pool→6)
            L.Conv(256, 384, 3, padding=1,
                   w_init=("normal", 0.01), b_init=("constant", 0.0),
                   compute_dtype=cd, name="conv3"),
            L.Conv(384, 384, 3, padding=1, groups=2,
                   w_init=("normal", 0.01), b_init=("constant", 0.1),
                   compute_dtype=cd, name="conv4"),
            L.Conv(384, 256, 3, padding=1, groups=2,
                   w_init=("normal", 0.01), b_init=("constant", 0.1),
                   compute_dtype=cd, name="conv5"),
            L.Pool(3, 2, mode="max", name="pool5"),
            L.Flatten(),
            L.FC(256 * 6 * 6, 4096, w_init=("normal", 0.005),
                 b_init=("constant", 0.1), compute_dtype=cd, name="fc6"),
            L.Dropout(0.5, name="drop6"),
            L.FC(4096, 4096, w_init=("normal", 0.005),
                 b_init=("constant", 0.1), compute_dtype=cd, name="fc7"),
            L.Dropout(0.5, name="drop7"),
            L.FC(4096, nc, w_init=("normal", 0.01),
                 b_init=("constant", 0.0), activation=None,
                 compute_dtype=cd, name="softmax"),
        ])
        self.data = ImageNet_data(self.config, self.batch_size, crop=227)


Alex_net = AlexNet
