"""Async-island EASGD vs synchronous-cadence EASGD throughput.

Same model (Cifar10, synthetic): N synchronous-cadence EASGD workers in
lockstep (the exchange inside each rank's step) against islands around a
host-side center (``parallel/async_easgd.py``), each exchanging at its own
pace.  Reports aggregate samples/sec for each and the ratio.

The port's counterpart of the JAX package's ``async_vs_sync_easgd``, with
its flags and JSON keys.  The islands are threads of this process, one
device each: on the card they share it (as ``chip_smoke.py``'s island
phases run them), so two islands contend for one GPU and the ratio there
is a harness check, not a scaling result; on the CPU (``--host-devices
N``: the synchronous workers are N gloo ranks, one CPU thread each; the
islands run one thread each) the numbers are relative only.

    python -m theanompi_tpu_torch.tools.async_vs_sync_easgd [--devices N]
        [--islands 2] [--batch 16] [--steps 20] [--seconds 15]
        [--sync-freq 4] [--out FILE] [--host-devices N]
"""

import argparse
import json
import os
import sys
import time

from . import _world

MODEL = ("theanompi_tpu_torch.models.cifar10", "Cifar10_model")


def _sync(rank, world, init_method, device, batch, steps, sync_freq,
          model_cfg):
    """One rank of the synchronous-cadence world; rank 0 returns the
    global samples/sec."""
    from ..worker import EASGD_Worker
    worker = EASGD_Worker({"n_workers": world, "rank": rank,
                           "init_method": init_method, "device": device,
                           "verbose": False, "batch_size": batch,
                           "sync_freq": sync_freq, **model_cfg})
    try:
        m = worker.build_model(*MODEL)
        m.compile_iter_fns(worker.exchanger)
        exch = worker.exchanger
        m.data.shuffle_data(0)
        for i in range(3):                      # warmup + capture
            m.train_iter(i + 1, None)
            exch.exchange(None, i + 1)
        _world.sync(device)
        t0 = time.time()
        for i in range(steps):
            m.train_iter(4 + i, None)
            exch.exchange(None, 4 + i)
            # keep the queue shallow: the async islands block at every
            # exchange, so this keeps the comparison symmetric
            _world.sync(device)
        dt = time.time() - t0
    finally:
        worker.close()
    return steps * batch * world / dt           # global samples/sec


def measure_sync(n, batch, steps, sync_freq, model_cfg, device="cuda"):
    return _world.run("theanompi_tpu_torch.tools.async_vs_sync_easgd:_sync",
                      n, device, batch=batch, steps=steps,
                      sync_freq=sync_freq, model_cfg=model_cfg)


def measure_async(islands, batch, seconds, sync_freq, model_cfg,
                  device="cuda"):
    """``islands`` island threads around an in-memory center, timed over
    ``seconds`` after every island's first exchange (its capture and
    first steps excluded): aggregate samples/sec."""
    import importlib

    from ..parallel.async_easgd import AsyncEASGDTrainer

    cls = getattr(importlib.import_module(MODEL[0]), MODEL[1])
    threads = None
    if device == "cpu":
        import torch
        # one CPU thread an island's ops, as a synchronous rank has
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
    try:
        tr = AsyncEASGDTrainer(cls, {
            "async_islands": islands, "sync_freq": sync_freq,
            "batch_size": batch, "verbose": False,
            "device": device if device == "cpu" else "cuda:0", **model_cfg})
        tr.start()
        deadline = time.time() + 600
        while (min((r.exchanges_done for r in tr.islands), default=0) < 1
               and time.time() < deadline
               and not any(r.error for r in tr.islands)):
            time.sleep(0.05)
        base = [r.steps_done for r in tr.islands]
        t0 = time.time()
        time.sleep(seconds)
        steps = sum(r.steps_done - b for r, b in zip(tr.islands, base))
        dt = time.time() - t0
        tr.stop_and_join(timeout=120)
        errors = [r.error for r in tr.islands if r.error]
        if errors:
            raise RuntimeError(f"an island failed: {errors[0]!r}")
    finally:
        if threads is not None:
            torch.set_num_threads(threads)
    return steps * batch / dt                   # aggregate samples/sec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=None,
                   help="synchronous workers (default: --host-devices on "
                        "the CPU, the visible GPUs on the card)")
    p.add_argument("--islands", type=int, default=2)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--sync-freq", type=int, default=4)
    p.add_argument("--out", default=os.path.join(
        "build", "tools", "async_vs_sync_easgd.json"))
    _world.add_device_flag(p)
    args = p.parse_args(argv)
    device = _world.device_of(p, args)
    have = _world.devices(device, args.host_devices)
    n = args.devices or have
    if n > have:
        p.error(f"--devices {n} exceeds the {have} available")

    model_cfg = {"synthetic_train": 64 * max(n, args.islands),
                 "synthetic_val": 32, "compute_dtype": "float32", "seed": 0}
    sync_sps = measure_sync(n, args.batch, args.steps, args.sync_freq,
                            model_cfg, device)
    async_sps = measure_async(args.islands, args.batch, args.seconds,
                              args.sync_freq, model_cfg, device)
    platform = "cpu" if device == "cpu" else "gpu"
    out = {"platform": platform, "devices": n,
           "islands": args.islands, "batch_per_chip": args.batch,
           "sync_easgd_samples_per_sec": round(sync_sps, 1),
           "async_islands_samples_per_sec": round(async_sps, 1),
           "async_over_sync": round(async_sps / sync_sps, 3),
           "note": ("aggregate samples/sec; CPU numbers are relative-only "
                    "(gloo ranks against island threads)"
                    if platform == "cpu" else
                    f"aggregate samples/sec; the {args.islands} islands "
                    f"share {n} GPU(s) and contend for it: a harness "
                    f"check, not a scaling result")}
    if device == "cuda":
        out["card"] = _world.card_line(device)
    print(json.dumps(out))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
