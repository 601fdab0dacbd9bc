"""Host-side input-pipeline throughput, and the host → card staging rate.

The reference's flagship was its parallel loader feeding real batch files
at AlexNet rates (at 14k img/s that is ~1.1 GB/s of augmented float32).
This measures that capability in isolation: disk → batch file read →
the fused native crop/mirror/mean/cast (``native/loader.cc``) →
(optionally) the ``PrefetchLoader`` producer — images/sec and GB/s out
of the host pipeline, the ceiling it can feed a card at.  On the card it
then stages the same batches through a ``PinnedStager`` (pinned ring,
side stream) and reports that rate too.

    python -m theanompi_tpu_torch.tools.loader_bench [--batches 32]
        [--batch-size 128] [--u8-wire] [--prefetch] [--workers N]
        [--windows K] [--data-dir DIR] [--host-devices 1]

Writes one JSON line: the JAX package's ``loader_bench`` keys, plus
``staging_images_per_sec``, ``staging_gb_per_sec`` and ``card`` on the
card.  ``--data-dir`` names a batch-file set to read (``train_hkl/`` and
the rest of the layout ``models/data/imagenet.py`` reads), which is only
read.  Without it the tool reads its own (``ensure_dataset``: ``.npy``
bc01 uint8 [batch, 3, 256, 256] files, the label files and a CHW mean),
made from a seed once under ``build/tools/``.  It runs on the card;
``--host-devices 1`` measures the host pipeline alone on the CPU.
"""

import argparse
import json
import os
import shutil
import sys
import time

from . import _world

RAW = 256


# written last into a batch-file set this tool made, with its arguments
DONE = ".loader_bench_done"


def smooth_mean_chw():
    """A CHW mean image of the reference's kind: smooth, ~110-135."""
    import numpy as np
    yy, xx = np.meshgrid(np.arange(RAW), np.arange(RAW), indexing="ij")
    plane = 8.0 * np.sin(2 * np.pi * yy / RAW) * np.cos(2 * np.pi * xx / RAW)
    return np.stack([120.0 + 5.0 * c + plane
                     for c in range(3)]).astype(np.float32)


def write_batch_files(root: str, n_train: int, n_val: int, batch_size: int,
                      mean: bool = True) -> str:
    """ImageNet-layout ``.npy`` batch files made from seed 7 into
    ``root``, which is emptied first: bc01 uint8 [batch_size, 3, 256, 256]
    in ``train_hkl/`` and ``val_hkl/``, the label files, and a CHW
    ``img_mean.npy`` unless ``mean`` is off (then the reader's scalar
    mean, 122).  ``.npy``: the card's machine has no h5py for ``.hkl``.
    The marker ``DONE``, written last, holds the arguments."""
    import numpy as np
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(7)
    for sub, n in (("train_hkl", n_train), ("val_hkl", n_val)):
        os.makedirs(os.path.join(root, sub))
        for j in range(n):
            np.save(os.path.join(root, sub, f"{j:04d}.npy"),
                    rng.integers(0, 256, (batch_size, 3, RAW, RAW),
                                 np.uint8))
        np.save(os.path.join(root, sub.split("_")[0] + "_labels.npy"),
                rng.integers(0, 1000, n * batch_size).astype(np.int32))
    if mean:
        np.save(os.path.join(root, "img_mean.npy"), smooth_mean_chw())
    with open(os.path.join(root, DONE), "w") as f:
        json.dump(_spec(n_train, n_val, batch_size, mean), f)
    return root


def _spec(n_train, n_val, batch_size, mean) -> dict:
    return {"n_train": n_train, "n_val": n_val, "batch_size": batch_size,
            "mean": mean}


def ensure_dataset(n_batches: int, batch_size: int, root=None,
                   n_val: int = 1) -> str:
    """The batch-file set of these arguments in ``root`` (by default under
    ``build/tools/``), written by :func:`write_batch_files` unless its
    marker says it is there already.  ``root`` is a directory of the
    caller's own: anything else in it is deleted."""
    root = root or os.path.join("build", "tools",
                                f"loader_bench_{batch_size}x{n_batches}")
    try:
        with open(os.path.join(root, DONE)) as f:
            if json.load(f) == _spec(n_batches, n_val, batch_size, True):
                return root
    except (OSError, ValueError):
        pass
    return write_batch_files(root, n_batches, n_val, batch_size)


def staging_rate(data, device: str, n: int) -> dict:
    """``n`` host batches of ``data`` (four, drawn once and cycled) staged
    to the card through a PinnedStager (the producer's path), ending in a
    synchronize: images/s and GB/s."""
    import torch

    from ..parallel.steps import PinnedStager, claim, put_batch
    dev = torch.device(device)
    stager = PinnedStager(dev, slots=3)
    batches = [data.next_train_batch(i) for i in range(min(n, 4))]
    claim(put_batch(batches[0], dev, stager), dev)      # the pinned buffers
    torch.cuda.synchronize()
    nbytes = sum(a.nbytes for a in batches[0].values())
    t0 = time.time()
    for i in range(n):
        claim(put_batch(batches[i % len(batches)], dev, stager), dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    imgs = n * batches[0]["x"].shape[0]
    return {"staging_images_per_sec": round(imgs / dt, 1),
            "staging_gb_per_sec": round(n * nbytes / dt / 1e9, 3),
            "staging_batches": n}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, default=32,
                   help="training files of the tool's own set (not read "
                        "with --data-dir)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=3,
                   help="timed passes over the file set")
    p.add_argument("--u8-wire", action="store_true",
                   help="measure the aug_wire_u8 path (crop+mirror only)")
    p.add_argument("--prefetch", action="store_true",
                   help="pull through the PrefetchLoader producer thread")
    p.add_argument("--workers", type=int, default=1,
                   help="PrefetchLoader materializer pool size (implies "
                        "--prefetch when > 1)")
    p.add_argument("--windows", type=int, default=0, metavar="K",
                   help="window mode A/B (steps_per_call=K dispatch "
                        "inputs): staged-window DEQUEUE latency through "
                        "the PrefetchLoader window producer vs serial "
                        "consumer-side assembly (K draws + stack + put)")
    p.add_argument("--compute-ms", type=float, default=0.0,
                   help="simulated per-window compute between dequeues "
                        "(0 = use the measured serial assembly time, so "
                        "the producer gets the same overlap budget a real "
                        "training dispatch would give it)")
    p.add_argument("--data-dir", default=None,
                   help="a batch-file set to read (default: the tool's "
                        "own, made once under build/tools/)")
    _world.add_device_flag(p)
    args = p.parse_args(argv)
    device = _world.device_of(p, args)
    if args.host_devices > 1:
        p.error("the loader runs in one process: --host-devices 1")
    if args.data_dir is None:
        d = ensure_dataset(args.batches, args.batch_size)
    elif os.path.isdir(os.path.join(args.data_dir, "train_hkl")):
        d = args.data_dir
    else:
        p.error(f"--data-dir {args.data_dir}: no train_hkl/ there (the "
                f"batch-file layout models/data/imagenet.py reads)")

    from ..models.data.imagenet import ImageNet_data

    cfg = {"size": 1, "data_dir": d}
    if args.u8_wire:
        cfg["aug_wire_u8"] = True
    if args.windows > 1:
        return _bench_windows(args, cfg, device)
    data = ImageNet_data(cfg, batch_size=args.batch_size)
    if args.prefetch or args.workers > 1:
        from ..models.data.prefetch import PrefetchLoader
        data = PrefetchLoader(data, n_workers=args.workers)

    # warm the page cache + any lazy native-library build; epoch 0 then
    # CONTINUES from batch 1 (no re-shuffle — that would restart the
    # producer and regenerate the warmup batch inside the timed window)
    data.shuffle_data(0)
    b = data.next_train_batch(0)
    bytes_per_img = b["x"][0].nbytes
    n_imgs = 0
    t0 = time.time()
    for ep in range(args.epochs):
        if ep > 0:
            data.shuffle_data(ep)
        for i in range(1 if ep == 0 else 0, data.n_batch_train):
            batch = data.next_train_batch(i)
            n_imgs += batch["x"].shape[0]
    dt = time.time() - t0
    ips = n_imgs / dt
    out = {
        "metric": "host_loader_images_per_sec"
                  + (" (u8-wire)" if args.u8_wire else " (fused f32)")
                  + (f" via PrefetchLoader x{args.workers}"
                     if (args.prefetch or args.workers > 1) else ""),
        "value": round(ips, 1),
        "unit": "images/sec",
        "gb_per_sec_out": round(ips * bytes_per_img / 1e9, 3),
        "images": n_imgs,
        "seconds": round(dt, 2),
        "note": "host pipeline only (disk->batch file->augment); the rate "
                "it can feed a card at",
    }
    if hasattr(data, "close"):
        data.close()
    if device == "cuda":
        out.update(staging_rate(ImageNet_data(cfg, batch_size=args.batch_size),
                                device, 2 * args.batches),
                   card=_world.card_line(device))
    print(json.dumps(out))
    return 0


def _bench_windows(args, cfg, device) -> int:
    """--windows K: what does the CONSUMER thread pay per
    ``steps_per_call`` dispatch input?  Serial path: k draws + host stack
    + the copy to the device on the consumer.  Window path: the
    PrefetchLoader producer assembles and stages whole windows in the
    background and the consumer only DEQUEUES — with a compute-sized gap
    between dequeues (as training provides), the dequeue latency is the
    stall the card actually sees."""
    import torch

    from ..models.data.imagenet import ImageNet_data
    from ..models.data.prefetch import PrefetchLoader
    from ..parallel.steps import PinnedStager, claim, put_batch, stack_host

    k = args.windows
    dev = torch.device(device)
    stager = PinnedStager(dev, slots=3) if device == "cuda" else None

    def put(w):
        return put_batch(w, dev, stager)

    def block(w):
        if hasattr(w, "ready"):
            claim(w, dev)
        _world.sync(device)

    serial = ImageNet_data(cfg, batch_size=args.batch_size)
    n_windows = serial.n_batch_train // k
    if n_windows < 2:
        raise SystemExit(f"--windows {k} needs >= {2 * k} batches (have "
                         f"{serial.n_batch_train})")
    serial.shuffle_data(0)
    # warm: page cache, native-library build, first copy
    block(put(stack_host([serial.next_train_batch(j) for j in range(k)])))
    t_serial = []
    for ep in range(args.epochs):
        serial.shuffle_data(ep + 1)
        for wi in range(n_windows):
            t1 = time.time()
            batches = [serial.next_train_batch(wi * k + j) for j in range(k)]
            block(put(stack_host(batches)))
            t_serial.append(time.time() - t1)
    serial_ms = 1e3 * sum(t_serial) / len(t_serial)

    compute_s = (args.compute_ms / 1e3) if args.compute_ms > 0 \
        else serial_ms / 1e3
    data = PrefetchLoader(ImageNet_data(cfg, batch_size=args.batch_size),
                          n_workers=args.workers)
    data.set_window(k, put)
    t_deq = []
    for ep in range(args.epochs):
        data.shuffle_data(ep + 1)
        for wi in range(n_windows):
            t1 = time.time()
            w = data.next_train_window((wi + 1) * k)
            block(w)
            dt = time.time() - t1
            if wi > 0:          # window 0 pays the producer spin-up
                t_deq.append(dt)
            time.sleep(compute_s)     # the producer's overlap budget
    data.close()
    deq_ms = 1e3 * sum(t_deq) / len(t_deq)

    out = {
        "metric": f"staged_window_dequeue_vs_serial_assembly (k={k}, "
                  f"batch {args.batch_size}"
                  + (", u8-wire" if args.u8_wire else "")
                  + f", pool x{args.workers})",
        "value": round(deq_ms, 3),
        "unit": "ms/window dequeue",
        "serial_assembly_ms": round(serial_ms, 3),
        "window_dequeue_ms": round(deq_ms, 3),
        "consumer_stall_saved_ms": round(serial_ms - deq_ms, 3),
        "compute_ms_between_dequeues": round(compute_s * 1e3, 3),
        "windows": len(t_deq),
        "note": "serial = k draws + stack + put ON the consumer thread "
                "(pre-window train_iter); dequeue = what window-mode "
                "train_iter pays (producer staged off-thread)",
    }
    if device == "cuda":
        out["card"] = _world.card_line(device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
