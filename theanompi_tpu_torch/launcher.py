"""Launcher: one worker process per GPU.

Counterpart of ``theanompi_tpu/launcher.py``, with its flags.  The
reference composed an ``mpirun -np N ... python -u -m theanompi.<worker>``
line and forwarded the workers' output; the JAX package ran one process
over all of a host's chips.  The port is back to one process per GPU:

    python -m theanompi_tpu_torch.launcher --rule bsp \\
        --modelfile theanompi_tpu_torch.models.alex_net --modelclass AlexNet \\
        --n-workers 4 batch_size=128

spawns ``--n-workers`` ranks (default: the visible GPUs; 1 with
``device=cpu``), rank ``i`` as ``python -u -m theanompi_tpu_torch.worker
<rule> <modelfile> <modelclass> rank=i n_workers=N local_rank=i
init_method=tcp://127.0.0.1:<free port> [key=value ...]``
(:func:`compose_worker_cmd`).  The ranks write to the launcher's own
output.  When a rank fails, the launcher stops the others (none is left
waiting in a collective) and returns that rank's exit code.  On ``cuda``
it refuses, before spawning anything, more ranks than visible GPUs: NCCL
takes one GPU a rank.

``--num-hosts H`` with ``--coordinator host:port`` composes a world of
``H · n_workers`` ranks: host ``h`` runs ranks ``h·K … h·K+K−1`` over
``init_method=tcp://<coordinator>`` (host 0's first rank serves the
rendezvous there).  ``--emit-only`` prints every host's launcher line and
the rank lines it runs; ``--process-id h`` runs host ``h``'s share.

``--supervise N`` restarts the whole local world, with ``resume=true``, up
to N times when any rank fails (BSP's reaction: the ranks hold one model),
after a backoff (``--backoff``, ``--backoff-max``); ``--min-uptime`` and
the crash-loop breaker (``--crash-limit`` failures in ``--crash-window``
seconds) stop it with a nonzero exit.  Pair it with ``ckpt_dir``.

``--elastic`` (with ``--elastic-steps``, ``--host-devices``,
``--center-proc``) and ``--compile-cache`` are refused: membership,
the center's own process and the compile cache wait for ROADMAP A10.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

WORKER_MODULE = "theanompi_tpu_torch.worker"
# the keys the launcher sets on every rank's line
RANK_KEYS = ("rank", "n_workers", "local_rank", "init_method")


def compose_worker_cmd(rule: str, modelfile: str, modelclass: str,
                       config_kv: List[str], rank: Optional[int] = None,
                       n_workers: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       init_method: Optional[str] = None) -> List[str]:
    """One rank's command (≙ one rank of the reference's mpirun line):
    the worker, the rank's place in the world, then the config."""
    cmd = [sys.executable, "-u", "-m", WORKER_MODULE, rule, modelfile,
           modelclass]
    if rank is not None:
        cmd += [f"rank={rank}", f"n_workers={n_workers}",
                f"local_rank={local_rank}", f"init_method={init_method}"]
    cmd.extend(config_kv)
    return cmd


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def visible_gpus() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _stop(procs, grace_s: float) -> None:
    """SIGTERM every live rank's process group, SIGKILL what outlives
    ``grace_s``, and reap them all."""
    live = [p for p in procs if p.poll() is None]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in live:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while live and time.monotonic() < deadline:
            live = [p for p in live if p.poll() is None]
            time.sleep(0.02)
    for p in procs:
        p.wait()


def run_world(cmds: List[List[str]], poll_s: float = 0.05,
              grace_s: float = 5.0) -> int:
    """Run one process per command until every one exits 0 (returns 0) or
    one fails (returns its code; the rest are stopped)."""
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, start_new_session=True))
        while True:
            rcs = [p.poll() for p in procs]
            for r, rc in enumerate(rcs):
                if rc not in (None, 0):
                    print(f"rank {r} exited rc={rc}; stopping the other "
                          f"ranks", file=sys.stderr, flush=True)
                    return rc
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(poll_s)
    finally:
        _stop(procs, grace_s)


def _config_value(kv: List[str], key: str) -> Optional[str]:
    return next((c.partition("=")[2] for c in reversed(kv)
                 if c.startswith(key + "=")), None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="theanompi_tpu_torch.launcher",
        description="Launch distributed training, one process per GPU "
                    "(≙ Theano-MPI's mpirun composition).")
    p.add_argument("--rule", default="bsp",
                   choices=["bsp", "easgd", "asgd", "gosgd"])
    p.add_argument("--modelfile",
                   default="theanompi_tpu_torch.models.cifar10")
    p.add_argument("--modelclass", default="Cifar10_model")
    p.add_argument("--n-workers", type=int, default=None,
                   help="ranks on this host, one GPU each (default: the "
                        "visible GPUs; 1 with device=cpu)")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--coordinator", default=None,
                   help="host:port of host 0, where rank 0 serves the "
                        "rendezvous (multi-host)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index (multi-host exec mode)")
    p.add_argument("--emit-only", action="store_true",
                   help="print each host's launcher line and its rank "
                        "lines instead of executing")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="restart the whole local world (with resume=true) "
                        "up to N times when a rank fails; pair with "
                        "ckpt_dir; restarts back off exponentially "
                        "(--backoff) and a crash loop (--crash-limit "
                        "failures within --crash-window) exits nonzero")
    p.add_argument("--min-uptime", type=float, default=0.0, metavar="SEC",
                   help="a failure within SEC seconds of the start is "
                        "treated as unrecoverable and not retried; 0 = "
                        "always retry")
    p.add_argument("--backoff", type=float, default=1.0, metavar="SEC",
                   help="restart N waits min(SEC·2^N, --backoff-max) ±25%% "
                        "jitter; 0 = immediate restarts")
    p.add_argument("--backoff-max", type=float, default=30.0, metavar="SEC",
                   help="supervised-restart backoff cap (default 30)")
    p.add_argument("--crash-limit", type=int, default=5, metavar="N",
                   help="N failures within --crash-window seconds exit "
                        "nonzero at once (default 5)")
    p.add_argument("--crash-window", type=float, default=300.0,
                   metavar="SEC", help="crash-loop window (default 300)")
    p.add_argument("--record-dir", default=None, metavar="DIR",
                   help="the record_dir=DIR config key: every rank's "
                        "recorder writes there")
    # the JAX launcher's elastic and cache flags: refused until A10
    p.add_argument("--elastic", type=int, default=0, metavar="N")
    p.add_argument("--elastic-steps", type=int, default=None, metavar="K")
    p.add_argument("--host-devices", type=int, default=0, metavar="K")
    p.add_argument("--center-proc", action="store_true")
    p.add_argument("--compile-cache", default=None, metavar="DIR")
    p.add_argument("config", nargs="*", help="key=value model/worker config")
    args = p.parse_args(argv)

    for flag, value in (("--elastic", args.elastic),
                        ("--elastic-steps", args.elastic_steps),
                        ("--host-devices", args.host_devices),
                        ("--center-proc", args.center_proc),
                        ("--compile-cache", args.compile_cache)):
        if value:
            p.error(f"{flag} is not ported yet: elastic membership, the "
                    f"center's own process and the compile cache wait for "
                    f"ROADMAP A10")
    kv = list(args.config)
    owned = [c for c in kv if c.partition("=")[0] in RANK_KEYS]
    if owned:
        p.error(f"{owned}: the launcher sets {', '.join(RANK_KEYS)} on "
                f"every rank (the world's size with --n-workers and "
                f"--num-hosts)")
    if args.num_hosts < 1:
        p.error("--num-hosts must be at least 1")
    if args.num_hosts > 1 and not args.coordinator:
        p.error("--num-hosts > 1 needs --coordinator host:port (host 0's "
                "address, where rank 0 serves the rendezvous)")
    if args.num_hosts > 1 and args.supervise:
        p.error("--supervise restarts a world on one host; a world across "
                "hosts is not supervised")
    if args.record_dir and _config_value(kv, "record_dir") is None:
        kv.append(f"record_dir={args.record_dir}")
    if _config_value(kv, "record_dir") and \
            _config_value(kv, "run_id") is None:
        # one run id for every host and restart of this launch
        kv.append(f"run_id=run{int(time.time())}")

    device = _config_value(kv, "device") or "cuda"
    emit = args.emit_only or (args.num_hosts > 1 and args.process_id is None)
    k = args.n_workers
    if not device.startswith("cpu") and not emit:
        # this host spawns: one GPU a rank, checked before any spawn
        n_gpu = visible_gpus()
        if n_gpu == 0:
            p.error("CUDA is not available; pass device=cpu to run the "
                    "ranks on the CPU")
        k = n_gpu if k is None else k
        if k > n_gpu:
            p.error(f"{k} ranks on this host need {k} GPUs, one a rank "
                    f"(NCCL refuses two ranks on one GPU), and this host "
                    f"has {n_gpu} visible GPU{'' if n_gpu == 1 else 's'}")
        if ":" in device and k > 1:
            p.error(f"device={device} binds every rank to one GPU; pass "
                    f"device=cuda (rank i binds cuda:local_rank)")
    if k is None:
        if emit and args.num_hosts > 1:
            p.error("--num-hosts > 1 needs --n-workers, the ranks a host")
        k = 1
    if k < 1:
        p.error(f"--n-workers {k}: at least one rank")
    world = k * args.num_hosts
    coordinator = args.coordinator or f"127.0.0.1:{free_port()}"

    def host_cmds(h: int, init: str) -> List[List[str]]:
        return [compose_worker_cmd(args.rule, args.modelfile,
                                   args.modelclass, kv, h * k + i, world, i,
                                   init)
                for i in range(k)]

    if emit:
        print(f"# run on each host ({world} ranks; rank 0 serves the "
              f"rendezvous at {coordinator}):")
        for h in range(args.num_hosts):
            line = [sys.executable, "-m", "theanompi_tpu_torch.launcher",
                    "--rule", args.rule, "--modelfile", args.modelfile,
                    "--modelclass", args.modelclass, "--n-workers", str(k),
                    "--num-hosts", str(args.num_hosts),
                    "--coordinator", coordinator, "--process-id", str(h)]
            print(f"# host {h}:")
            print(shlex.join(line + kv))
            for r, c in enumerate(host_cmds(h, f"tcp://{coordinator}")):
                print(f"#   rank {h * k + r}: {shlex.join(c)}")
        return 0

    if args.num_hosts > 1:
        if not 0 <= args.process_id < args.num_hosts:
            p.error(f"--process-id {args.process_id} outside "
                    f"{args.num_hosts} hosts")
        return run_world(host_cmds(args.process_id,
                                   f"tcp://{args.coordinator}"))

    if not args.supervise:
        return run_world(host_cmds(0, f"tcp://{coordinator}"))

    # Failure recovery: the world restarts from the newest valid per-epoch
    # checkpoint (crash-atomic writes, so a SIGKILL mid-save cannot brick
    # the resume), on a fresh rendezvous port each time
    if _config_value(kv, "ckpt_dir") is None:
        print("warning: --supervise without ckpt_dir= restarts training "
              "from scratch each time", file=sys.stderr)
    from .parallel.membership import Backoff, CrashLoopBreaker
    backoff = Backoff(base=args.backoff, cap=args.backoff_max) \
        if args.backoff > 0 else None
    breaker = CrashLoopBreaker(limit=args.crash_limit,
                               window_s=args.crash_window)
    rc = 1
    for attempt in range(args.supervise + 1):
        cmds = host_cmds(0, f"tcp://127.0.0.1:{free_port()}")
        if attempt:
            cmds = [c + ["resume=true"] for c in cmds]
        t0 = time.monotonic()
        rc = run_world(cmds)
        if rc == 0:
            return 0
        uptime = time.monotonic() - t0
        if args.min_uptime and uptime < args.min_uptime:
            print(f"world exited rc={rc} after only {uptime:.1f}s "
                  f"(< --min-uptime {args.min_uptime}s) — treating as "
                  f"unrecoverable, not retrying", file=sys.stderr)
            return rc
        if breaker.record_failure():
            print(f"crash loop: {args.crash_limit} failures within "
                  f"{args.crash_window:.0f}s — giving up (rc={rc})",
                  file=sys.stderr)
            return rc
        if attempt < args.supervise:
            delay = backoff.delay(attempt) if backoff else 0.0
            print(f"world exited rc={rc}; restarting in {delay:.1f}s "
                  f"({attempt + 1}/{args.supervise})", file=sys.stderr,
                  flush=True)
            if delay:
                time.sleep(delay)
    print(f"supervised restarts exhausted ({args.supervise}) — giving up "
          f"(rc={rc})", file=sys.stderr)
    return rc


if __name__ == "__main__":
    # a TERM or an interrupt stops the ranks on the way out (run_world's
    # finally), as a rank's failure does
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    raise SystemExit(main())
