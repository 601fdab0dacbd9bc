"""Models and per-rank entries for the launcher's tests
(``tests/test_torch_launcher.py``, ``tests/test_torch_islands_world.py``).

Imports only ``theanompi_tpu_torch`` and ``torch_port_helper`` (no JAX):
it runs in every rank's process, either as the launcher's modelfile
(``--modelfile torch_launch_helper``) or as each rank's module in place
of the worker (:func:`launch`: the launcher's rank lines and
``run_world``), where it takes the worker's arguments and two keys of
its own, ``helper_mode`` and ``helper_out``:

* ``helper_mode=wires``: joins the launcher's world once and trains each
  of ``WIRE_CASES`` (allreduce, onebit, topk, PowerSGD at rank 1, and the
  narrow ResNet's ``sync_bn`` under allreduce) through the ``BSP`` session
  in it, then writes every case's final state to
  ``<helper_out>_r<rank>.npz`` (``<case>/<key>``, keys as
  ``torch_port_helper.state_arrays`` makes them).
* ``helper_mode=islands``: this rank's island of an async world
  (``AsyncEASGDTrainer``), each island stopping after
  ``helper_exchanges`` exchanges; writes this rank's params at the start
  (``init``) and each exchange's parts (``ex/<j>/...``, in the center's
  layout: the params before and after, the anchor before, ``dev_in``
  after, and on the island's rank 0 what was pulled and pushed), the
  final params and optimizer state, and the center's leaves and its
  updates by island (global rank 0, when it holds the center).
"""

import atexit
import contextlib
import json
import os
import signal
import sys
import time

import numpy as np

from theanompi_tpu_torch import convert
from theanompi_tpu_torch.worker import parse_config

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_port_helper import (TinyLRNNet, TinyLRNNetFrom,  # noqa: E402,F401
                               TinyResNet, TinyVGGNet, _FromNpz,
                               state_arrays)


class TinyVGGNetFrom(_FromNpz, TinyVGGNet):
    """:class:`TinyVGGNet` from ``config['init_npz']``."""


class SleepyNet(TinyLRNNetFrom):
    """:class:`TinyLRNNetFrom` sleeping ``iter_sleep`` seconds after each
    step: an epoch long enough to be killed in."""

    def train_iter(self, count, recorder=None):
        super().train_iter(count, recorder)
        time.sleep(float(self.config.get("iter_sleep", 0.0)))


class CrashNet(TinyLRNNet):
    """Raises at step ``crash_at`` on rank ``crash_rank`` (every rank when
    it is -1)."""

    def train_iter(self, count, recorder=None):
        if count == int(self.config.get("crash_at", 1)) and \
                int(self.config.get("crash_rank", -1)) in (-1, self.rank):
            raise RuntimeError(f"CrashNet: rank {self.rank} fails at step "
                               f"{count}")
        super().train_iter(count, recorder)


class ModulesNet(TinyLRNNet):
    """Writes, as its process exits, which of ``jax`` and the JAX package
    its process imported, to ``<modules_out>_r<rank>.json``."""

    def __init__(self, config=None):
        super().__init__(config)
        atexit.register(self._modules, str(self.config["modules_out"]),
                        self.rank)

    @staticmethod
    def _modules(out, rank):
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "theanompi_tpu"
                     or m.startswith("theanompi_tpu."))
        with open(f"{out}_r{rank}.json", "w") as f:
            json.dump({"bad": bad, "n": len(sys.modules)}, f)


# the wires held at 2 and 4 ranks: (modelclass, config); init_npz is the
# config's (allreduce) or init_vgg_npz (onebit)
WIRE_CASES = {
    "allreduce": ("TinyLRNNetFrom", dict(exch_strategy="allreduce")),
    "onebit": ("TinyVGGNetFrom", dict(exch_strategy="onebit",
                                      init_key="init_vgg_npz")),
    "topk": ("TinyVGGNet", dict(exch_strategy="topk")),
    "powersgd": ("TinyVGGNet", dict(exch_strategy="powersgd1")),
    "sync_bn": ("TinyResNet", dict(exch_strategy="allreduce")),
}


def wires(config, out):
    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess(dict(config, verbose=False))
    proc.get_internode_comm()           # every case's session reuses it
    res = {}
    try:
        for name, (cls, cfg) in WIRE_CASES.items():
            cfg = dict(cfg)
            npz = config.get(cfg.pop("init_key", "init_npz"))
            rule = BSP()
            rule.init(devices=proc.size, modelfile="torch_launch_helper",
                      modelclass=cls, **dict(config, **cfg, init_npz=npz,
                                             verbose=False, printFreq=1000))
            rule.wait()
            res.update({f"{name}/{k}": v
                        for k, v in state_arrays(rule.model).items()})
    finally:
        proc.close()
    np.savez(f"{out}_r{proc.rank}.npz", **res)


def _center_flat(model):
    return np.concatenate([x.reshape(-1) for x in convert.
                           center_leaves_from_params(
                               model.params,
                               frozenset(model.kept_layout_paths()))])


def islands(config, modelclass, out):
    from theanompi_tpu_torch.parallel import async_easgd as TA
    k = int(config.pop("helper_exchanges", 3))
    cls = globals()[modelclass]
    exchanges, init = [], []
    call0, seed0 = TA.CenterLink._call, TA.CenterLink.seed

    def seed(self, mean=False):
        init.append(_center_flat(self.model))
        return seed0(self, mean)

    def call(self, fn, *args):
        got = call0(self, fn, *args)
        ex = exchanges[-1]
        if args:
            ex["pushed"] = np.concatenate([np.array(x).reshape(-1)
                                           for x in args[0]])
        if got[0] is not None:
            ex["pulled"] = np.concatenate([np.array(x).reshape(-1)
                                           for x in got[0]])
        return got

    def exchange(base):
        def run(self):
            exchanges.append({"before": _center_flat(self.model),
                              "anchor": self.dev_in.numpy().copy()})
            parts = base(self)
            exchanges[-1].update(after=_center_flat(self.model),
                                 got=self.dev_in.numpy().copy())
            if len(exchanges) >= k:
                tr.stop_event.set()
            return parts
        return run

    TA.CenterLink._call = call
    TA.CenterLink.seed = seed
    TA.CenterLink.easgd = exchange(TA.CenterLink.easgd)
    TA.CenterLink.asgd = exchange(TA.CenterLink.asgd)
    tr = TA.AsyncEASGDTrainer(cls, dict(config, verbose=False),
                              rule=config["rule"])
    tr.start()
    runner = tr.islands[0]
    runner.join()
    held = isinstance(tr.center, TA.ElasticCenter)
    center = tr.center.pull_leaves() if held else None
    tr.stop_and_join()
    m = runner.model
    res = {}
    for j, ex in enumerate(exchanges):
        res.update({f"ex/{j}/{key}": v for key, v in ex.items()})
    res.update({k: v for k, v in state_arrays(m).items()
                if k.startswith(("params/", "opt/"))})
    if held:
        res.update({f"center/{i}": x for i, x in enumerate(center)})
        res["by_island"] = np.array(json.dumps(
            tr.center.stats_snapshot()["by_island"]))
    if init:
        res["init"] = init[0]
    res["steps"] = np.int64(runner.steps_done)
    res["island"] = np.int64(runner.island_id)
    np.savez(f"{out}_r{config['rank']}.npz", **res)


@contextlib.contextmanager
def deadline(seconds: int):
    """Raise ``TimeoutError`` in the main thread after ``seconds``: a
    launcher run in this process then stops its ranks on the way out."""
    def expire(*_):
        raise TimeoutError(f"still running after {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def launch(rule, modelclass, world, *kv, timeout_s: int = 300) -> int:
    """A world of ``world`` processes of this module, each started with the
    line the launcher composes for that rank of the worker, run by the
    launcher's ``run_world`` for at most ``timeout_s``; returns its exit
    code.  The ranks inherit this process's environment (the tests set
    ``OMP_NUM_THREADS`` and ``PYTHONPATH``)."""
    from theanompi_tpu_torch import launcher as TL
    init = f"tcp://127.0.0.1:{TL.free_port()}"
    cmds = []
    for r in range(world):
        cmd = TL.compose_worker_cmd(rule, "torch_launch_helper", modelclass,
                                    list(kv), r, world, r, init)
        cmd[cmd.index(TL.WORKER_MODULE)] = "torch_launch_helper"
        cmds.append(cmd)
    with deadline(timeout_s):
        return TL.run_world(cmds)


def main(argv):
    rule, _, modelclass = argv[:3]
    config = dict(parse_config(argv[3:]), rule=rule, device="cpu")
    mode, out = config.pop("helper_mode"), config.pop("helper_out")
    if mode == "wires":
        wires(config, out)
    else:
        islands(config, modelclass, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
