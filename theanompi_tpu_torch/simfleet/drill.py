"""The live half's default island model: a fault drill, not a workload.

``fidelity.crosscheck`` and ``tools.chaos_run`` replay a schedule whose
fault times count from the islands' first step, so the default model only
has to outlast the schedule: :class:`DrillNet` is the AlexNet block at toy
width (Conv 3→16 3×3 SAME → LRN → Pool 3/2 → FC 144→5, float32, B1/B2 on
the card) over 48 seeded synthetic 8×8 images, sleeping ``iter_sleep``
seconds after each step (0: none).  It lives in the package so that an
island process imports it wherever it starts.
"""

from __future__ import annotations

import time

import numpy as np

from ..models import layers as L
from ..models.data import DataBase
from ..models.model_base import ModelBase

N_TRAIN, HW, C_IN, N_CLASS = 48, 8, 3, 5


class DrillData(DataBase):
    """48 NHWC float32 images and their labels from ``RandomState(7)``;
    the first 16 are the validation set."""

    def __init__(self, config=None, batch_size=8):
        super().__init__(config, batch_size)
        r = np.random.RandomState(7)
        self.x_train = r.randn(N_TRAIN, HW, HW, C_IN).astype(np.float32)
        self.y_train = r.randint(0, N_CLASS, N_TRAIN).astype(np.int32)
        self.x_val, self.y_val = self.x_train[:16], self.y_train[:16]
        self._finalize()


class DrillNet(ModelBase):
    batch_size = 8
    epochs = 1
    learning_rate = 0.1
    momentum = 0.9
    weight_decay = 0.0005
    seed = 3

    def build_model(self):
        self.seq = L.Sequential([
            L.Conv(C_IN, 16, 3, padding=1, w_init=("normal", 0.3),
                   b_init=("constant", 0.1), compute_dtype="float32",
                   name="conv"),
            L.LRN(k=1.0, alpha=0.5, name="lrn"),
            L.Pool(3, 2, mode="max", name="pool"),
            L.Flatten(),
            L.FC(3 * 3 * 16, N_CLASS, w_init=("normal", 0.1),
                 activation=None, compute_dtype="float32", name="fc"),
        ])
        self.data = DrillData(self.config, self.batch_size)

    def train_iter(self, count, recorder=None):
        super().train_iter(count, recorder)
        dt = float(self.config.get("iter_sleep", 0.0))
        if dt > 0:
            time.sleep(dt)
