"""Ranks and models of the operations planes' tests
(``tests/test_torch_numerics.py``, ``test_torch_watchdog.py``): no JAX.

``python torch_ops_helper.py <mode> <rank> <world> <init> <out>
<args_json>`` runs one rank of ``mode`` over CPU gloo and writes
``<out>_r<rank>.npz``; :func:`spawn` starts the world and :func:`collect`
waits for it.  Every rank runs on one CPU thread
(``torch_port_helper.RANK_ENV``).

* ``beacon`` (2 ranks): BSP ``TinyLRNNet`` with ``numerics=true``, two
  steps (``div_healthy``, the gathered ``digests``), then rank 1's first
  weight perturbed and one more step (``div_perturbed``); then EASGD at
  ``sync_freq`` 2 for three steps (the third has no exchange after it):
  the sample's ``dist_center`` and ``‖p − c‖`` recomputed in float64 from
  the params and the center (``dist_sample``, ``dist_f64``).
* ``tp`` (2 ranks): the LM of ``torch_mp_helper.LM_CFG`` at dp 1 × tp 2
  from ``args['init_npz']``, one sampled step (``tp_grad_norm``,
  ``tp_param_norm``); rank 0 then runs the dense LM alone from the same
  weights (``dense_grad_norm``, ``dense_param_norm``).

:class:`HangOnceNet` is a launcher model: it sleeps ``hang_s`` seconds at
step ``hang_at`` of its first incarnation (the first to find no
``hang_marker`` file), a stall for the watchdog.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_port_helper import RANK_ENV, TinyLRNNet  # noqa: E402


class HangOnceNet(TinyLRNNet):
    """Hangs once: at step ``hang_at`` (default 3) the incarnation that
    creates ``hang_marker`` sleeps ``hang_s`` (default 300) seconds."""

    def train_iter(self, count, recorder=None):
        marker = self.config.get("hang_marker")
        if marker and count == int(self.config.get("hang_at", 3)) and \
                not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write(str(os.getpid()))
            time.sleep(float(self.config.get("hang_s", 300)))
        super().train_iter(count, recorder)


def _report(model):
    from theanompi_tpu_torch.utils import numerics
    return numerics.host_report(numerics.to_host(model.numerics_aux))


def _session(rank, world, init, tag, **cfg):
    from theanompi_tpu_torch.base import MeshProcess
    proc = MeshProcess(dict(cfg, device="cpu", rank=rank, n_workers=world,
                            verbose=False, init_method=f"{init}_{tag}"))
    proc.get_internode_comm()
    return proc


def beacon(rank, world, init, args, res):
    from theanompi_tpu_torch.parallel.exchanger import get_exchanger
    from theanompi_tpu_torch.utils.helper_funcs import tree_leaves
    proc = _session(rank, world, init, "bsp")
    try:
        m = TinyLRNNet(dict(proc.config, numerics=True, scale_lr=False))
        ex = get_exchanger("bsp", m.config)
        m.compile_iter_fns(ex)
        m.data.shuffle_data(0)
        for count in (1, 2):
            m.train_iter(count)
        rep = _report(m)
        res["div_healthy"] = rep["divergence"]
        res["digests"] = np.array(rep["per_rank"]["digest"])
        if rank == 1:
            with torch.no_grad():
                tree_leaves(m.params)[0].view(-1)[0] += 1e-3
        m.train_iter(3)
        res["div_perturbed"] = _report(m)["divergence"]
    finally:
        proc.close()
    proc = _session(rank, world, init, "easgd")
    try:
        m = TinyLRNNet(dict(proc.config, numerics=True, rule="easgd",
                            sync_freq=2, scale_lr=False))
        ex = get_exchanger("easgd", m.config)
        m.compile_iter_fns(ex)
        m.data.shuffle_data(0)
        for count in (1, 2, 3):
            m.train_iter(count)
            ex.exchange(None, count)
        res["dist_sample"] = _report(m)["per_rank"]["dist_center"][rank]
        ps = [p.detach().double() for p in tree_leaves(m.params)]
        cs = [c.double() for c in tree_leaves(m.extra["center"])]
        res["dist_f64"] = float(sum(float(((p - c) ** 2).sum())
                                    for p, c in zip(ps, cs))) ** 0.5
    finally:
        proc.close()


def tp(rank, world, init, args, res):
    from torch_mp_helper import LM_CFG, MPLM
    from theanompi_tpu_torch.base import MeshProcess
    from theanompi_tpu_torch.parallel.exchanger import get_exchanger

    def one_step(proc, prefix):
        m = MPLM(dict(proc.config, numerics=True, init_npz=args["init_npz"]))
        m.compile_iter_fns(get_exchanger("bsp", m.config))
        m.data.shuffle_data(0)
        m.train_iter(0)
        rep = _report(m)
        res[f"{prefix}_grad_norm"] = rep["grad_norm"]
        res[f"{prefix}_param_norm"] = rep["param_norm"]

    proc = MeshProcess(dict(LM_CFG, device="cpu", rank=rank, n_workers=1,
                            tp=2, init_method=f"{init}_tp"))
    proc.get_internode_comm()
    try:
        one_step(proc, "tp")
    finally:
        proc.close()
    if rank == 0:
        proc = MeshProcess(dict(LM_CFG, device="cpu", rank=0, n_workers=1))
        proc.get_internode_comm()
        try:
            one_step(proc, "dense")
        finally:
            proc.close()


def lm_init(tmp_path) -> str:
    """The dense LM's initial params (``torch_mp_helper.MPLM``'s input)."""
    from torch_mp_helper import LM_CFG, save_init
    from theanompi_tpu_torch.models.transformer_lm import TransformerLM
    from theanompi_tpu_torch.utils.helper_funcs import tree_map
    m = TransformerLM(dict(LM_CFG, device="cpu"))
    return save_init(tree_map(lambda p: p.detach(), m.params),
                     os.path.join(str(tmp_path), "lm_init.npz"))


def main(argv):
    torch.set_num_threads(1)
    mode, rank, world, init, out, args = argv
    res = {}
    {"beacon": beacon, "tp": tp}[mode](int(rank), int(world), init,
                                        json.loads(args), res)
    np.savez(f"{out}_r{rank}.npz", **res)
    return 0


def spawn(mode, world, tmp_path, tag, args):
    init = "file://" + os.path.join(str(tmp_path), f"store_{tag}")
    out = os.path.join(str(tmp_path), f"out_{tag}")
    env = dict(os.environ, **RANK_ENV, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_ops_helper.py"), mode,
         str(r), str(world), init, out, json.dumps(args)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs, out


def collect(spawned, timeout=300):
    procs, out = spawned
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = []
    for r in range(len(procs)):
        with np.load(f"{out}_r{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
