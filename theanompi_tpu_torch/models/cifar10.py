"""CIFAR-10 CNN: the README quick-start model.

Counterpart of ``theanompi_tpu/models/cifar10.py``, layer for layer at the
same widths and init schemes: three 5×5/5×5/3×3 SAME convs (He init), each
followed by a 3×3/2 VALID max pool (32 → 15 → 7 → 3), an FC of 256 with
dropout 0.5 and a 10-way softmax; batch 128 per rank, momentum SGD (0.9),
lr 0.05 ÷10 at epochs 20 and 25.  Its data is :class:`Cifar10_data`
(the pickles, or the synthetic set bit-equal to the JAX package's).
"""

from __future__ import annotations

from . import layers as L
from .data.cifar10 import Cifar10_data
from .model_base import ModelBase


class Cifar10_model(ModelBase):
    batch_size = 128
    epochs = 30
    n_subb = 1
    learning_rate = 0.05
    momentum = 0.9
    weight_decay = 0.0001
    lr_adjust_epochs = (20, 25)

    def build_model(self) -> None:
        cd = self.config.get("compute_dtype", "bfloat16")
        self.seq = L.Sequential([
            L.Conv(3, 64, 5, padding="SAME", w_init="he",
                   compute_dtype=cd, name="conv1"),
            L.Pool(3, 2, mode="max", name="pool1"),
            L.Conv(64, 128, 5, padding="SAME", w_init="he",
                   compute_dtype=cd, name="conv2"),
            L.Pool(3, 2, mode="max", name="pool2"),
            L.Conv(128, 128, 3, padding="SAME", w_init="he",
                   compute_dtype=cd, name="conv3"),
            L.Pool(3, 2, mode="max", name="pool3"),
            L.Flatten(),
            L.FC(128 * 3 * 3, 256, w_init="he", compute_dtype=cd, name="fc1"),
            L.Dropout(0.5, name="drop1"),
            L.FC(256, 10, w_init=("normal", 0.01), activation=None,
                 compute_dtype=cd, name="softmax"),
        ])
        self.data = Cifar10_data(self.config, self.batch_size)
