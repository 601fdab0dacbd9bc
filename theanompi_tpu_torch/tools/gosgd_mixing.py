"""GoSGD mixing-rate experiment: 'perm' vs 'shift' vs 'iid' peer assignment.

Pure gossip (no training): workers start from diverse random params and
exchange every step through the port's ``GOSGD_Exchanger`` (its
point-to-point sends, on a stub model holding one ``[d]`` leaf); we
track the cross-worker variance of the replicas.  The decay rate is the
mixing rate of the gossip matrix sequence — the evidence behind the
peer-assignment design choice.

The port's counterpart of the JAX package's ``gosgd_mixing``, with its
flags and output.  ``--k-sweep`` sweeps the routing-family size K
(``gosgd_n_perms``) of the two pre-drawn modes instead.  Gossip needs at
least two ranks: on the CPU ``--host-devices N`` runs N gloo ranks
(``--workers`` defaults to N); on the card a GPU a rank.

Routing: the port draws a step's send gate on the device from
``(gosgd_seed, rank, count)`` and its table from ``(gosgd_seed, count)``
on the host, the JAX package from its PRNG key, so their curves agree
only where the route does not depend on the draw: at ``--prob 1`` with a
family of one table (``perm``, ``iid``), or at two workers.
"""

import argparse
import json
import sys

from . import _world


def _Rank(config):
    """This rank's place in the world (a ``MeshProcess`` joined)."""
    from ..base import MeshProcess

    class Rank(MeshProcess):
        def __init__(self, config):
            super().__init__(config)
            self.get_internode_comm()

    return Rank(config)


class _Gossip:
    """One replica of the experiment: the model surface
    ``GOSGD_Exchanger.prepare`` and its exchange read (one ``[d]`` leaf of
    params, the rule's α, the device and the rank), and the exchanger
    over it."""

    def __init__(self, mode, n_perms, seed, world, rank, d, device, prob):
        import numpy as np
        import torch

        from ..parallel.exchanger import GOSGD_Exchanger
        w0 = np.random.RandomState(seed).randn(world, d).astype(np.float32)
        self.params = {"w": torch.from_numpy(w0[rank]).to(device)}
        self.device = device
        self.rank = rank
        self.extra = {"alpha": torch.ones((), dtype=torch.float32,
                                          device=device)}
        self.exch = GOSGD_Exchanger({
            "exch_prob": prob, "gosgd_peers": mode, "gosgd_n_perms": n_perms,
            # different seeds ALSO get different routing families, so the
            # seed average isn't pinned to one K-sized draw
            "gosgd_seed": seed * 7919})
        self.exch.prepare(self, world)
        self.gen = torch.Generator(device)

    def exchange(self, count: int) -> None:
        self.exch.seed_draws(self.gen, count)
        self.exch.exchange_body(count, self.gen)


def _curves(rank, world, init_method, device, jobs, d, iters, prob):
    """Every job ``(mode, n_perms, seed)``'s variance curve and final
    α of every rank, computed by all ranks of one world; rank 0 returns
    them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    proc = _Rank({"n_workers": world, "rank": rank,
                  "init_method": init_method, "device": device,
                  "verbose": False})
    dev = proc.device
    out = []
    try:
        for mode, n_perms, seed in jobs:
            g = _Gossip(mode, n_perms, seed, world, rank, d, dev, prob)
            parts = [torch.empty(d, dtype=torch.float32, device=dev)
                     for _ in range(world)]

            def variance():
                dist.all_gather(parts, g.params["w"])
                w = np.stack([t.cpu().numpy() for t in parts])
                return float(w.var(axis=0).mean())

            curve = []
            for i in range(iters):
                curve.append(variance())
                g.exchange(i)
            curve.append(variance())
            alphas = [torch.empty((), dtype=torch.float32, device=dev)
                      for _ in range(world)]
            dist.all_gather(alphas, g.extra["alpha"])
            out.append({"curve": curve,
                        "alpha": [float(a) for a in alphas]})
    finally:
        proc.close()
    return out


def curves(jobs, workers, d, iters, prob, device="cpu"):
    """The variance curves (and final α's) of ``jobs`` at ``workers``
    ranks: one ``{"curve", "alpha"}`` a job."""
    return _world.run("theanompi_tpu_torch.tools.gosgd_mixing:_curves",
                      workers, device, jobs=[list(j) for j in jobs], d=d,
                      iters=iters, prob=prob)


def stats(curve_list, iters):
    """The JAX script's summary of a mode's seed-averaged curve."""
    import numpy as np
    mean = np.array(curve_list).mean(axis=0)
    norm = mean / mean[0]
    # geometric decay rate over the first 20 exchanges
    horizon = min(20, iters)
    rate = (norm[horizon]) ** (1.0 / horizon)
    half = int(np.argmax(norm < 0.5)) if (norm < 0.5).any() else -1
    return {"decay_per_exchange": round(float(rate), 4),
            "exchanges_to_half_variance": half,
            f"variance_ratio_at_{horizon}": round(float(norm[horizon]), 5)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workers", type=int, default=None,
                   help="gossiping ranks (default: --host-devices on the "
                        "CPU, the visible GPUs on the card)")
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--prob", type=float, default=0.25,
                   help="per-worker send probability (reference default 0.25)")
    p.add_argument("--k-sweep", action="store_true",
                   help="sweep the pre-drawn routing-family size K "
                        "(gosgd_n_perms) instead of comparing modes: the "
                        "check that cycling a small static family does not "
                        "slow mixing")
    _world.add_device_flag(p)
    args = p.parse_args(argv)
    device = _world.device_of(p, args)
    have = _world.devices(device, args.host_devices)
    workers = args.workers or have
    if workers > have:
        p.error(f"--workers {workers} exceeds the {have} rank(s) available")
    if workers < 2:
        p.error("gossip needs at least two ranks: --host-devices N (N >= 2) "
                "on the CPU, or a GPU a rank")

    if args.k_sweep:
        cells = [(f"{mode}-K{k}", mode, k) for mode in ("perm", "iid")
                 for k in (4, 16, 64, 256)]
    else:
        cells = [(mode, mode, 16) for mode in ("perm", "shift", "iid")]
    jobs = [(mode, k, s) for _, mode, k in cells for s in range(args.seeds)]
    got = curves(jobs, workers, args.dim, args.iters, args.prob, device)
    out = {}
    for i, (name, mode, k) in enumerate(cells):
        out[name] = s = stats([g["curve"] for g in
                               got[i * args.seeds:(i + 1) * args.seeds]],
                              args.iters)
        label = f"{mode:>6} K={k:<4}" if args.k_sweep else f"{mode:>6}"
        print(f"{label}: decay/exchange {s['decay_per_exchange']:.4f}, "
              f"half-variance at {s['exchanges_to_half_variance']}",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
