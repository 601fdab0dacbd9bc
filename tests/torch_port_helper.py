"""A tiny Conv → LRN → Pool → FC model for the port's tests, and the
per-rank entry of the multi-process BSP test.

Imports only ``theanompi_tpu_torch`` (no JAX), so it can run as a child
process:

    python tests/torch_port_helper.py <rank> <world> <init_method> \
        <batch_size> <out.npz>

trains one epoch of :class:`TinyLRNNet` under ``BSP`` on gloo and writes
rank 0's final parameters to ``out.npz``.
"""

import sys

import numpy as np

from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.data import DataBase
from theanompi_tpu_torch.models.model_base import ModelBase

N_TRAIN = 48
HW, C_IN, N_CLASS = 8, 3, 5


def tiny_arrays(seed: int = 7):
    """The dataset, from a seed: NHWC float32 images and int32 labels."""
    r = np.random.RandomState(seed)
    x = r.randn(N_TRAIN, HW, HW, C_IN).astype(np.float32)
    y = r.randint(0, N_CLASS, N_TRAIN).astype(np.int32)
    return x, y


class TinyData(DataBase):
    def __init__(self, config=None, batch_size=8):
        super().__init__(config, batch_size)
        self.x_train, self.y_train = tiny_arrays()
        self.x_val, self.y_val = self.x_train[:16], self.y_train[:16]
        self._finalize()


class TinyLRNNet(ModelBase):
    """Conv(3→16, 3×3 SAME) → LRN → Pool(3/2) → FC(3·3·16 → 5), float32,
    no dropout: the AlexNet block at toy width."""

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
        self.data = TinyData(self.config, self.batch_size)


def main(argv):
    rank, world, init_method, bs, out = argv
    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=int(world), modelfile="torch_port_helper",
              modelclass="TinyLRNNet", device="cpu", rank=int(rank),
              init_method=init_method, batch_size=int(bs), scale_lr=False,
              printFreq=1000, verbose=False)
    rule.wait()
    if int(rank) == 0:
        params = rule.model.host_params()
        np.savez(out, **{f"{k}/{n}": v for k, d in params.items()
                         for n, v in d.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
