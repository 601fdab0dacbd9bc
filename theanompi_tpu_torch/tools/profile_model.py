"""Capture a profiler trace of one model's training step and print the
device-time attribution: top op classes, compute vs collective time,
EXPOSED collective time, and the comm/compute overlap ratio.

The port's counterpart of the JAX package's ``profile_model``, with its
flags and its JSON keys.  It builds the model from ``models/registry.py``
as a session builds it (the worker, ``build_model``,
``compile_iter_fns``: on the card the captured step, ``--spc`` steps a
call), stages one batch, and drives a traced window of ``iters``
dispatches, each under ``devprof.TRAIN_DISPATCH_SPAN``, after the
profiler's warm-up over one dispatch; ``utils/devprof.py`` reads the
trace.

Usage:
    python -m theanompi_tpu_torch.tools.profile_model [model] [batch]
        [iters] [--rule bsp] [--spc K] [--json OUT] [--cfg JSON]
        [--schedule] [--host-devices N]

``--json`` writes the machine-readable profile (the full devprof dict +
run metadata; ``-`` for stdout).  ``--cfg`` takes config overrides
(transformer dims, ``pp``/``tp``/``sp``, ``pp_interleave``...); with
``pp``, ``tp`` or ``sp`` the world is their grid of ranks.  It runs on
the card; ``--host-devices N`` runs it on the CPU as N gloo ranks.

Env: PROFILE_DIR (trace capture dir, default
``build/tools/profile_<model>``).
"""

import argparse
import json
import os
import sys
import time

from . import _world
from ..models.registry import MODELS


def _profile(rank, world, init_method, device, model_name, batch, iters,
             rule, spc, overrides, trace_dir, session, schedule):
    """One rank's traced window; rank 0 returns the profile document."""
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    from ..utils import devprof
    from ..worker import WORKERS

    modelfile, modelclass, extra = MODELS[model_name]
    group = 1
    for k in ("tp", "pp", "sp"):
        group *= int(overrides.get(k, 1) or 1)
    config = {"n_workers": world // group, "rank": rank,
              "init_method": init_method, "device": device,
              "verbose": False, "seed": 0, **extra, **overrides}
    if batch:
        config["batch_size"] = batch
    if spc > 1:
        config["steps_per_call"] = spc
    worker = WORKERS[rule](config)
    try:
        model = worker.build_model(modelfile, modelclass)
        model.compile_iter_fns(worker.exchanger)
        spc = int(model.steps_per_call)
        model.data.shuffle_data(0)
        batches = [model.data.next_train_batch(j + 1) for j in range(spc)]
        inputs = model.train_fn.take(batches if spc > 1 else batches[0])
        lr = model.current_lr

        def step(i):
            # 1-based count strided by spc, the worker's convention: a
            # fused exchange cadence fires at its true rate
            count = (i + 1) * spc
            with record_function(devprof.TRAIN_DISPATCH_SPAN):
                model.train_fn(inputs, lr, count)
            worker.exchanger.exchange(None, count)

        for i in range(5):
            step(i)
        _world.sync(device)
        with devprof.capture(trace_dir, warmup=True, name=f"rank{rank}",
                             session=session) as cap:
            step(5)
            _world.sync(device)
            cap.record()
            for i in range(iters):
                step(6 + i)
            _world.sync(device)
        if world > 1:
            dist.barrier()        # every rank's trace is written
        if rank != 0:
            return None
        prof = cap.profile if world == 1 else devprof.profile_dir(trace_dir)
        if prof is None:
            return None
        doc = {"model": model_name, "batch_size": int(model.batch_size),
               "rule": rule, "spc": spc, "iters": iters,
               "platform": "cpu" if device == "cpu" else "gpu",
               "device_kind": torch.cuda.get_device_name(0)
               if device != "cpu" else "cpu",
               "card": _world.card_line(device),
               "trace_dir": trace_dir, **prof}
        if schedule:
            events = devprof.load_dir_events(trace_dir)
            doc["schedule_text"] = devprof.format_schedule(
                devprof.schedule_occupancy(events))
            pp = int(config.get("pp", 1) or 1)
            if pp > 1:
                doc["pipeline_schedule"] = devprof.pipeline_schedule_report(
                    events, pp=pp,
                    v=int(config.get("pp_interleave", 1) or 1),
                    m=int(config.get("pp_microbatches", 1) or 1))
        return doc
    finally:
        worker.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="resnet50",
                    choices=sorted(MODELS))
    ap.add_argument("batch", nargs="?", type=int, default=0)
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("--rule", default="bsp",
                    choices=["bsp", "easgd", "asgd", "gosgd"])
    ap.add_argument("--spc", type=int, default=1,
                    help="steps_per_call of the traced dispatch")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the machine-readable profile here "
                         "('-' for stdout)")
    ap.add_argument("--cfg", default=None, metavar="JSON",
                    help="JSON config overrides (transformer dims, "
                         "pp/tp/sp, pp_interleave...); tp/pp/sp shape the "
                         "grid of ranks")
    ap.add_argument("--schedule", action="store_true",
                    help="print the per-lane schedule occupancy report "
                         "(devprof.schedule_occupancy) from the capture; "
                         "with pp>1 in --cfg, also the hop-event pipeline "
                         "schedule measurement")
    _world.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = _world.device_of(ap, args)
    model_name = args.model
    trace_dir = os.environ.get(
        "PROFILE_DIR", os.path.join("build", "tools", f"profile_{model_name}"))
    overrides = json.loads(args.cfg) if args.cfg else {}
    world = _world.devices(device, args.host_devices)
    group = 1
    for k in ("tp", "pp", "sp"):
        group *= int(overrides.get(k, 1) or 1)
    if world < group or world % group:
        ap.error(f"tp*pp*sp = {group} does not divide the {world} rank(s)")
    doc = _world.run(
        "theanompi_tpu_torch.tools.profile_model:_profile", world, device,
        model_name=model_name, batch=args.batch, iters=args.iters,
        rule=args.rule, spc=args.spc, overrides=overrides,
        trace_dir=trace_dir, session=time.strftime("%Y_%m_%d_%H_%M_%S"),
        schedule=args.schedule)
    if doc is None:
        print(f"no trace capture found under {trace_dir}", file=sys.stderr)
        return 1
    from ..utils import devprof
    spc = doc["spc"]
    print(f"== {model_name} batch {doc['batch_size']} {args.rule.upper()}"
          f"{f' spc={spc}' if spc > 1 else ''}: {args.iters} traced "
          f"dispatch(es) on {doc['platform']} ({doc['card']}) ==")
    print(devprof.format_profile(doc, top=25))
    if args.schedule:
        print()
        print(doc.pop("schedule_text"))
        rep = doc.get("pipeline_schedule")
        if rep:
            print(f"pipeline schedule: ticks/pass={rep['ticks_per_pass']} "
                  f"measured_ticks={rep['measured_ticks']} "
                  f"verified={rep['schedule_verified']} "
                  f"bubble_ticks={rep['bubble_fraction_ticks']} "
                  f"bubble_time={rep['bubble_fraction']}")
    if args.json:
        if args.json == "-":
            print(json.dumps(doc))
        else:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
