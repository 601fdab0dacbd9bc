"""Scaling-efficiency sweep — the reference paper's table shape.

Theano-MPI's headline results are "time per 5120 images" tables per worker
count × exchange strategy.  This reproduces that table shape: for each
worker count (powers of two up to the visible GPUs, or up to
``--host-devices`` gloo ranks on the CPU) and strategy, train a few
steady-state iterations of the BSP step (on the card the captured one)
on one staged batch and report time-per-5120, images/sec, and scaling
efficiency vs 1 worker.

The port's counterpart of the JAX package's ``scaling_sweep``, with its
flags, rows and columns, and every strategy name the port has.  On the
CPU the numbers only demonstrate the harness, not hardware scaling.

Usage:
  python -m theanompi_tpu_torch.tools.scaling_sweep [--model cifar10]
       [--strategies allreduce ring] [--iters 20] [--batch-size 128]
       [--json] [--measure-comm] [--host-devices N]
"""

import argparse
import json
import sys
import time

from . import _world
from ..models.registry import MODELS


def _strategy(name: str) -> str:
    from ..parallel.strategies import STRATEGIES, is_strategy
    if not is_strategy(name):
        raise argparse.ArgumentTypeError(
            f"unknown strategy {name!r}; have {sorted(STRATEGIES)} and "
            f"powersgd<rank>")
    return name


def _measure(rank, world, init_method, device, modelfile, modelclass, extra,
             strategy, batch_size, iters, warmup, tp=1, pp=1, sp=1):
    """One rank of a world of ``world`` ranks: ``n_workers`` = world /
    (tp·pp·sp) workers; rank 0 returns the row."""
    from ..worker import BSP_Worker
    group = tp * pp * sp
    n_workers = world // group
    worker = BSP_Worker({"n_workers": n_workers, "rank": rank,
                         "init_method": init_method, "device": device,
                         "verbose": False, "seed": 0,
                         "exch_strategy": strategy, "batch_size": batch_size,
                         "tp": tp, "pp": pp, "sp": sp, **extra})
    try:
        model = worker.build_model(modelfile, modelclass)
        model.compile_iter_fns(worker.exchanger)
        model.data.shuffle_data(0)
        batch = model.data.next_train_batch(1)
        # images of the global batch: every worker steps in lockstep
        n_images = int(batch["y"].shape[0]) * n_workers
        inputs = model.train_fn.take(batch)
        lr = model.current_lr
        for i in range(warmup):
            model.train_fn(inputs, lr, i + 1)
        _world.sync(device)
        t0 = time.time()
        for i in range(iters):
            model.train_fn(inputs, lr, warmup + i + 1)
        _world.sync(device)
        dt = time.time() - t0
    finally:
        worker.close()
    ips = n_images * iters / dt
    return {"workers": n_workers, "strategy": strategy,
            "images_per_sec": round(ips, 1),
            "images_per_sec_per_chip": round(ips / world, 1),
            "time_per_5120": round(5120.0 / ips, 3)}


def measure(modelfile, modelclass, extra, n_workers, strategy, batch_size,
            iters, warmup, device="cuda", tp=1, pp=1, sp=1):
    """The row of ``n_workers`` workers (each a group of tp·pp·sp ranks)."""
    return _world.run("theanompi_tpu_torch.tools.scaling_sweep:_measure",
                      n_workers * tp * pp * sp, device, modelfile=modelfile,
                      modelclass=modelclass, extra=extra, strategy=strategy,
                      batch_size=batch_size, iters=iters, warmup=warmup,
                      tp=tp, pp=pp, sp=sp)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="cifar10", choices=sorted(MODELS))
    p.add_argument("--strategies", nargs="*",
                   default=["allreduce", "ring", "nccl16"],
                   type=_strategy)
    p.add_argument("--batch-size", type=int, default=128,
                   help="per-worker batch (reference style)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--json", action="store_true", help="JSONL output")
    p.add_argument("--measure-comm", action="store_true",
                   help="add a comm-share column per strategy (differences "
                        "each step against the 'none' strategy)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree per worker group "
                        "(transformer family; sweeps dp GROUPS)")
    p.add_argument("--pp", type=int, default=1, help="pipeline degree")
    p.add_argument("--sp", type=int, default=1, help="sequence degree")
    _world.add_device_flag(p)
    args = p.parse_args(argv)
    device = _world.device_of(p, args)

    group = args.tp * args.pp * args.sp
    visible = _world.devices(device, args.host_devices)
    n_dev = visible // group
    if n_dev == 0:
        p.error(f"group size tp*pp*sp = {group} exceeds the {visible} "
                f"visible devices — nothing to sweep")
    counts, c = [], 1
    while c <= n_dev:
        counts.append(c)
        c *= 2
    modelfile, modelclass, extra = MODELS[args.model]
    card = _world.card_line(device) if device == "cuda" else None
    if not args.json:
        print(f"# {_world.platform(device, visible)}", flush=True)

    def row(n, strategy):
        return measure(modelfile, modelclass, extra, n, strategy,
                       args.batch_size, args.iters, args.warmup, device,
                       tp=args.tp, pp=args.pp, sp=args.sp)

    # measure_comm (the reference's t_train/t_comm decomposition): the
    # step holds the collective, so comm share is recovered by
    # differencing against the 'none' strategy (same elementwise work, no
    # collective) at each worker count
    base_step = {}
    if args.measure_comm:
        for n in counts:
            if n == 1:
                base_step[n] = None     # no comm at 1 worker by definition
                continue
            base_step[n] = row(n, "none")["time_per_5120"]

    base_ips = {}
    for strategy in args.strategies:
        for n in counts:
            r = row(n, strategy)
            key = strategy
            if n == 1:
                base_ips[key] = r["images_per_sec"]
            eff = r["images_per_sec"] / (base_ips[key] * n) \
                if base_ips.get(key) else float("nan")
            r["scaling_efficiency"] = round(eff, 3)
            if card:
                r["card"] = card
            comm_txt = ""
            if args.measure_comm:
                if base_step.get(n):
                    share = max(0.0, 1.0 - base_step[n] / r["time_per_5120"])
                    r["comm_share"] = round(share, 3)
                    comm_txt = f" | comm {share:5.1%}"
                else:
                    r["comm_share"] = 0.0
                    comm_txt = " | comm   n/a"
            if args.json:
                print(json.dumps(r), flush=True)
            else:
                print(f"{args.model} {strategy:>10} x{n}: "
                      f"{r['images_per_sec']:>9.1f} img/s "
                      f"({r['images_per_sec_per_chip']:>8.1f}/chip) | "
                      f"{r['time_per_5120']:>7.3f} s/5120 | "
                      f"eff {eff:5.1%}{comm_txt}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
