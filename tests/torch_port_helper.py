"""Tiny models for the port's tests, and the per-rank entries of the
multi-process tests.

* :class:`TinyLRNNet` — Conv → LRN → Pool → FC: the AlexNet block at toy
  width.
* :class:`TinyVGGNet` — Conv 3×3 SAME → Pool 2/2 → Conv → Pool → FC: the
  VGG block at toy width, the model of the onebit tests.

Imports only ``theanompi_tpu_torch`` (no JAX), so it can run as a child
process, one per rank of a gloo group:

    python tests/torch_port_helper.py train <rank> <world> <init_method> \
        <out> <batch_size> [<modelclass> [<exch_strategy>]]

trains one epoch of the model (default ``TinyLRNNet`` under
``allreduce``) under ``BSP`` and writes each rank's final parameters (and
the strategy's state, if it has one: a flat state as ``extra/strat``, a
per-leaf list as ``extra/strat/<i>/<key>``) to ``<out>_r<rank>.npz``;

    python tests/torch_port_helper.py onebit|topk|powersgd <rank> <world> \
        <init_method> <out>

runs one exchange of that strategy (``topk`` with a chunk of 256,
``powersgd`` at rank 1) of a gradient tree of ``TinyVGGNet``'s shapes
drawn from the seed ``100 + rank`` and writes the flat input (the port's
flat order), the decoded mean and the new state to ``<out>_r<rank>.npz``.
"""

import os
import subprocess
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


def tiny_vgg_layers(Lmod, f32):
    """The layer list of :class:`TinyVGGNet`, from a layer module (this
    package's or the JAX package's) and its float32 dtype."""
    return [
        Lmod.Conv(C_IN, 8, 3, padding="SAME", w_init="he",
                  b_init=("constant", 0.1), compute_dtype=f32, name="conv1"),
        Lmod.Pool(2, 2, mode="max", name="pool1"),
        Lmod.Conv(8, 8, 3, padding="SAME", w_init="he",
                  b_init=("constant", 0.1), compute_dtype=f32, name="conv2"),
        Lmod.Pool(2, 2, mode="max", name="pool2"),
        Lmod.Flatten(),
        Lmod.FC(2 * 2 * 8, N_CLASS, w_init=("normal", 0.1), activation=None,
                compute_dtype=f32, name="fc"),
    ]


class TinyVGGNet(ModelBase):
    """Conv(3→8, 3×3 SAME) → Pool 2/2 → Conv(8→8) → Pool 2/2 →
    FC(2·2·8 → 5), float32, no dropout: the VGG block at toy width."""

    batch_size = 8
    epochs = 1
    learning_rate = 0.05
    momentum = 0.9
    weight_decay = 0.0005
    seed = 5

    def build_model(self):
        self.seq = L.Sequential(tiny_vgg_layers(L, "float32"))
        self.data = TinyData(self.config, self.batch_size)


def _save(path, tree, **extra):
    np.savez(path, **{f"{k}/{n}": v for k, d in tree.items()
                      for n, v in d.items()}, **extra)


def train(rank, world, init_method, out, bs, modelclass="TinyLRNNet",
          strategy="allreduce"):
    from theanompi_tpu_torch import BSP
    rule = BSP()
    rule.init(devices=int(world), modelfile="torch_port_helper",
              modelclass=modelclass, exch_strategy=strategy, device="cpu",
              rank=int(rank), init_method=init_method, batch_size=int(bs),
              scale_lr=False, printFreq=1000, verbose=False)
    rule.wait()
    model = rule.model
    _save(f"{out}_r{rank}.npz", model.host_params(),
          **_state_arrays(model.extra.get("strat")))


def _state_arrays(state, prefix="extra/strat"):
    """A strategy state as npz entries: a tensor as ``prefix``, a per-leaf
    list of dicts leaf by leaf as ``prefix/<i>/<key>``."""
    if state is None:
        return {}
    if isinstance(state, list):
        return {f"{prefix}/{i}/{k}": v.numpy() for i, d in enumerate(state)
                for k, v in d.items()}
    return {prefix: state.numpy()}


def exchange(strategy, rank, world, init_method, out):
    """One exchange of ``strategy`` over a gloo group of ``world`` ranks
    (``topk``: chunk 256; ``powersgd``: rank 1)."""
    import torch
    from theanompi_tpu_torch.base import MeshProcess
    from theanompi_tpu_torch.parallel import strategies as S
    from theanompi_tpu_torch.utils.helper_funcs import flatten_tree, tree_map
    proc = MeshProcess({"device": "cpu", "rank": int(rank),
                        "n_workers": int(world), "init_method": init_method,
                        "verbose": False})
    proc.get_internode_comm()
    try:
        shapes = TinyVGGNet({"device": "cpu", "verbose": False}).params
        r = np.random.RandomState(100 + int(rank))
        grads = tree_map(lambda p: torch.from_numpy(
            r.randn(*p.shape).astype(np.float32)), shapes)
        strat = {"onebit": S.OneBit, "topk": lambda: S.TopK(chunk=256),
                 "powersgd": lambda: S.PowerSGD(rank=1)}[strategy]()
        flat = flatten_tree(grads, pad_to_multiple_of=32768)
        mean, state = strat(grads, strat.init_state(grads), size=int(world))
        np.savez(f"{out}_r{rank}.npz", flat=flat.numpy(),
                 mean=flatten_tree(mean).numpy(),
                 **_state_arrays(state, "state"))
    finally:
        proc.close()


def run_ranks(mode, world, tmp_path, tag, *args, timeout=120):
    """Run ``mode`` in ``world`` processes over one gloo group (a file
    store in ``tmp_path``); returns each rank's output as a dict of
    arrays, in rank order."""
    here = os.path.dirname(os.path.abspath(__file__))
    init = "file://" + os.path.join(str(tmp_path), f"store_{tag}")
    out = os.path.join(str(tmp_path), f"out_{tag}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_port_helper.py"), mode,
         str(r), str(world), init, out, *map(str, args)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    res = []
    for r in range(world):
        with np.load(f"{out}_r{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


def main(argv):
    if argv[0] == "train":
        train(*argv[1:])
    else:
        exchange(*argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
