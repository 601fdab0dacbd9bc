"""What the tools share: where they run, and a function run at N ranks.

A tool runs on the card.  ``--host-devices N`` asks for the CPU instead:
N ranks over gloo, each a process of its own started through the
launcher's :func:`~theanompi_tpu_torch.launcher.run_world` (a failed rank
stops the others), each pinned to one CPU thread so that timings and bits
do not wander with the host's load.  Without the flag a tool that finds
no GPU fails: nothing falls back to the CPU.

:func:`run` runs ``module:function`` at every rank of a world and returns
what rank 0's call returned (JSON).  A world of one runs in this process.
On the card a world of more than one needs a GPU a rank (NCCL).

    python -m theanompi_tpu_torch.tools._world <module:function> <rank>
        <world> <init_method> <out.json> <device> <kwargs as JSON>

is one rank of such a world (what :func:`run` starts).
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, Optional

# one CPU thread a rank (the port's tests pin their gloo ranks the same way)
RANK_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def add_device_flag(ap) -> None:
    ap.add_argument("--host-devices", type=int, default=0, metavar="N",
                    help="run on the CPU as N gloo ranks (default 0: on the "
                         "card, which must be there)")


def device_of(ap, args) -> str:
    """``'cuda'``, or ``'cpu'`` when ``--host-devices`` asks for it; an
    argparse error when the card is wanted and absent."""
    if args.host_devices < 0:
        ap.error("--host-devices must be 0 (the card) or a rank count")
    if args.host_devices:
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        ap.error("no GPU is visible: pass --host-devices N to run on the "
                 "CPU as N gloo ranks")
    return "cuda"


def devices(device: str, host_devices: int) -> int:
    """The ranks a tool may use: ``host_devices`` on the CPU, the visible
    GPUs on the card."""
    if device == "cpu":
        return max(1, int(host_devices))
    import torch
    return torch.cuda.device_count()


def card_line(device: str = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), or ``"cpu"``."""
    if device != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0].strip() if out else "nvidia-smi unavailable"


def platform(device: str, world: int) -> str:
    """What ran a measurement, for the tools' ``platform`` fields."""
    if device == "cpu":
        return f"cpu-gloo-{world}rank"
    return f"gpu {card_line()} x{world}"


def sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def _call(ref: str, **kw) -> Any:
    mod, _, fn = ref.partition(":")
    return getattr(importlib.import_module(mod), fn)(**kw)


def run(ref: str, world: int, device: str, **kwargs) -> Any:
    """``ref`` (``'module:function'``) called at every rank of a world of
    ``world`` ranks with ``rank``, ``world``, ``init_method``, ``device``
    and ``kwargs``; returns rank 0's result.  A world of one is this
    process (``init_method`` None)."""
    if world == 1:
        return _call(ref, rank=0, world=1, init_method=None, device=device,
                     **kwargs)
    from ..launcher import free_port, run_world
    init = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="tmpi_world_") as d:
        out = os.path.join(d, "rank0.json")
        cmds = [[sys.executable, "-m", "theanompi_tpu_torch.tools._world",
                 ref, str(r), str(world), init, out, device,
                 json.dumps(kwargs)] for r in range(world)]
        rc = run_world(cmds, env=dict(os.environ, **RANK_ENV))
        if rc != 0:
            raise RuntimeError(f"{ref} at {world} ranks: a rank exited "
                               f"rc={rc}")
        with open(out) as f:
            return json.load(f)


def main(argv: Optional[list] = None) -> int:
    ref, rank, world, init, out, device, kw = argv or sys.argv[1:]
    import torch
    torch.set_num_threads(1)
    kwargs: Dict[str, Any] = json.loads(kw)
    res = _call(ref, rank=int(rank), world=int(world), init_method=init,
                device=device, **kwargs)
    if int(rank) == 0:
        with open(out + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(out + ".tmp", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
