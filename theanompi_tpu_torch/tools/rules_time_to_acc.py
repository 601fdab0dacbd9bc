"""Time-to-accuracy comparison across the four rules — the shape of the
reference paper's headline claim (EASGD reaches the target val error in
less wall-clock than BSP at higher worker counts).

Each rule trains the CIFAR-10 model (synthetic data) end to end through
the session API (``BSP()``, ``EASGD()``, ``ASGD()``, ``GOSGD()``:
``init``, then the session's run) at the same worker count and records
wall-clock seconds and epochs to a stated val accuracy.  Writes one JSON
line per rule to ``--out`` and prints a table.

The port's counterpart of the JAX package's ``rules_time_to_acc``: the
same rules, budgets and row keys (plus ``val_cost_by_epoch``).  It runs
on the card at one worker (``--workers``: more with a GPU each);
``--host-devices N`` runs ``--workers`` (default N) gloo ranks on the
CPU.  The ``platform`` field of each row names what ran it.  On the CPU
the ABSOLUTE times mean nothing; the row is the rule-semantics
comparison.  ``--init-from DIR`` starts every rule from the params of a
checkpoint the JAX package wrote (``convert.checkpoint_from_jax``).

    python -m theanompi_tpu_torch.tools.rules_time_to_acc [target_acc]
        [--workers N] [--epochs E] [--rules BSP EASGD ...] [--out FILE]
        [--host-devices N]
"""

import argparse
import json
import os
import sys
import time

from . import _world

RULES = [
    # the JAX script's calibrated budgets.  ASGD's center absorbs the SUM
    # of all workers' accumulated deltas (downpour semantics), so its
    # stable lr scales down by the worker count
    ("BSP", 6, {}),
    ("EASGD", 16, {"sync_freq": 2, "alpha": 0.1}),
    ("ASGD", 20, {"sync_freq": 2, "learning_rate": 0.0025}),
    ("GOSGD", 12, {"exch_prob": 0.25}),
]


def _session(rank, world, init_method, device, rule, kw, init_from=None):
    """One rank's session of ``rule``; rank 0 returns its per-epoch
    validation records and wall seconds."""
    import theanompi_tpu_torch as T

    prepare = None
    if init_from is not None:
        from .. import convert

        def prepare(worker, model):
            # the JAX checkpoint's params into the model; the run's compile
            # starts the optimizer and the rule's state from them, as the
            # JAX session starts from its initial params
            model.compile_iter_fns(worker.exchanger)
            convert.checkpoint_from_jax(init_from, model)

    sess = getattr(T, rule)()
    sess.init(devices=world, rank=rank, init_method=init_method,
              device=device, **kw)
    t0 = time.time()
    rec = sess.wait(prepare)
    _world.sync(device)
    wall = time.time() - t0
    return {"wall": wall,
            "val_error": [float(r["val_error"]) for r in rec.epoch_records],
            "val_cost": [float(r["val_cost"]) for r in rec.epoch_records]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("target", nargs="?", type=float, default=0.90)
    p.add_argument("--workers", type=int, default=None,
                   help="ranks of each session (default: --host-devices "
                        "on the CPU, 1 on the card)")
    p.add_argument("--rules", nargs="*", default=[r[0] for r in RULES],
                   choices=[r[0] for r in RULES])
    p.add_argument("--epochs", type=int, default=None,
                   help="every rule's epoch budget (default: the "
                        "calibrated budgets)")
    p.add_argument("--synthetic-train", type=int, default=2048)
    p.add_argument("--synthetic-val", type=int, default=256)
    p.add_argument("--modelfile", default="theanompi_tpu_torch.models.cifar10")
    p.add_argument("--modelclass", default="Cifar10_model")
    p.add_argument("--cfg", default=None, metavar="JSON",
                   help="JSON overrides of every session's config, over "
                        "the rules' own (ASGD's learning rate, GoSGD's "
                        "exch_prob...)")
    p.add_argument("--init-from", default=None, metavar="DIR",
                   help="a checkpoint the JAX package wrote: every rule "
                        "starts from its params")
    p.add_argument("--out", default=os.path.join(
        "build", "tools", "rules_time_to_acc.json"))
    _world.add_device_flag(p)
    args = p.parse_args(argv)
    device = _world.device_of(p, args)
    have = _world.devices(device, args.host_devices)
    workers = args.workers or (have if device == "cpu" else 1)
    if workers > have:
        p.error(f"--workers {workers} exceeds the {have} available")
    target = args.target
    where = _world.platform(device, workers)
    platform = (f"{where} (semantics comparison; absolute times not "
                f"meaningful)" if device == "cpu" else where)
    overrides = json.loads(args.cfg) if args.cfg else {}
    rows = []
    for name, epochs, extra in RULES:
        if name not in args.rules:
            continue
        epochs = args.epochs or epochs
        kw = dict(modelfile=args.modelfile, modelclass=args.modelclass,
                  epochs=epochs, synthetic_train=args.synthetic_train,
                  synthetic_val=args.synthetic_val,
                  batch_size=16, printFreq=1000,
                  compute_dtype="float32", learning_rate=0.02,
                  scale_lr=False, verbose=False)
        kw.update(extra)            # per-rule overrides win (ASGD's lr)
        kw.update(overrides)        # and --cfg over both
        got = _world.run("theanompi_tpu_torch.tools.rules_time_to_acc:"
                         "_session", workers, device, rule=name, kw=kw,
                         init_from=args.init_from)
        wall = got["wall"]
        accs = [round(1.0 - e, 4) for e in got["val_error"]]
        hit = next((i + 1 for i, a in enumerate(accs) if a >= target), None)
        # seconds to target ~ proportional share of the run (epochs are
        # equal-length)
        t_hit = round(wall * hit / len(accs), 1) if hit else None
        row = {"rule": name, "target_acc": target, "epochs_budget": epochs,
               "epochs_to_target": hit, "secs_to_target_approx": t_hit,
               "wall_secs_total": round(wall, 1), "best_acc": max(accs),
               "acc_by_epoch": accs,
               "val_cost_by_epoch": [round(c, 6) for c in got["val_cost"]],
               "platform": platform}
        rows.append(row)
        print(f"{name:6s}  to {target:.0%}: "
              f"{hit if hit else '—'} epochs  (~{t_hit}s)   "
              f"best {max(accs):.1%}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
