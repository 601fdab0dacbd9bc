"""Worker main loop.

Counterpart of ``theanompi_tpu/worker.py``: the epoch/batch driver that
compiles the model's steps, applies ``scale_lr`` and ``adjust_hyperp``,
calls ``model.train_iter`` each iteration and, at ``steps_per_call = 1``,
the exchanger's ``exchange`` hook after it (the async rules' cadence and
BSP's ``exch_mode='params'``, timed into the recorder's ``comm`` bucket;
at ``steps_per_call > 1`` the step's window runs it), runs the per-epoch
validation loop and prints through the recorder; with ``ckpt_dir`` it
checkpoints at
the end of every epoch (after validation) and, with ``resume=True``,
restores the newest valid checkpoint before training.  Tracing, chaos, the
watchdog and device profiling are not ported yet.

:func:`main` is the per-rank command line the launcher composes
(``theanompi_tpu_torch/launcher.py``):

    python -m theanompi_tpu_torch.worker <rule> <modelfile> <modelclass> \\
        [key=value ...]
"""

from __future__ import annotations

import time
from typing import Optional

from .base import MeshProcess
from .parallel.exchanger import get_exchanger
from .utils.recorder import Recorder


class Worker(MeshProcess):
    """Generic rule-driven worker (≙ reference ``BSP_Worker`` et al.)."""

    rule = "bsp"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        for k in ("trace_dir", "chaos", "stall_timeout",
                  "lease_dir", "metrics_addr", "tracing", "telemetry"):
            if self.config.get(k):
                raise NotImplementedError(f"config {k!r} is not ported yet")
        self.get_internode_comm()
        try:
            self.recorder = Recorder(self.config)
            self.exchanger = get_exchanger(self.config.get("rule", self.rule),
                                           self.config)
        except BaseException:
            # a refused config: leave the group joined above, or the
            # process keeps it and the next session finds it taken
            self.close()
            raise

    def run(self, model) -> Recorder:
        """The reference's ``run(model)`` epoch/batch loop."""
        config = self.config
        self.recorder.start()
        model.compile_iter_fns(self.exchanger)
        self.recorder.end("compile")
        if self.verbose and self.exchanger.bucket_bytes > 0:
            print(f"bucket_bytes={self.exchanger.bucket_bytes}: "
                  f"n_buckets={self.exchanger.n_buckets()} an exchange",
                  flush=True)
        if config.get("scale_lr", True) and self.size > 1:
            model.scale_lr(self.size)

        start_epoch = 0
        ckpt_dir = config.get("ckpt_dir")
        if ckpt_dir and config.get("resume", False):
            restored = model.load(ckpt_dir)
            if restored is not None:
                start_epoch = restored + 1
                if config.get("record_dir"):
                    # both record lists, so the next save() rewrites the
                    # JSONL with the lines from before the resume
                    self.recorder.load(config["record_dir"])
                if self.verbose:
                    print(f"resumed from epoch {restored}", flush=True)

        # steps_per_call > 1: each train_iter call takes spc steps, and an
        # epoch takes (n_batch_train // spc) * spc of them (the leftover
        # batches are dropped), so a resumed run's count, and with it every
        # step's dropout seed, follows the uninterrupted run's
        spc = max(1, int(getattr(model, "steps_per_call", 1)))
        count = start_epoch * ((model.data.n_batch_train // spc) * spc)
        epochs = config.get("epochs", model.epochs)
        t0 = time.time()
        self.recorder.reset_rate()
        for epoch in range(start_epoch, epochs):
            model.adjust_hyperp(epoch)
            model.data.shuffle_data(epoch + model.seed)
            for _ in range(model.data.n_batch_train // spc):
                count += spc
                model.train_iter(count, self.recorder)
                self.exchanger.exchange(self.recorder, count)
                self.recorder.print_train_info(count, spc)
            model.begin_val()
            for _ in range(model.data.n_batch_val):
                model.val_iter(count, self.recorder)
            model.end_val()
            self.recorder.print_val_info(count)
            if ckpt_dir:
                model.save(ckpt_dir, epoch, count)
            if config.get("record_dir"):
                self.recorder.save(config["record_dir"])
        if self.verbose:
            print(f"training finished in {time.time() - t0:.1f}s "
                  f"({epochs - start_epoch} epochs)", flush=True)
        return self.recorder


class BSP_Worker(Worker):
    rule = "bsp"


class EASGD_Worker(Worker):
    rule = "easgd"


class ASGD_Worker(Worker):
    rule = "asgd"


class GOSGD_Worker(Worker):
    rule = "gosgd"


WORKERS = {w.rule: w for w in (BSP_Worker, EASGD_Worker, ASGD_Worker,
                               GOSGD_Worker)}


def parse_config(argv) -> dict:
    """``key=value`` words as a config dict, each value parsed as the JAX
    package's worker parses it: an int, else a float, else ``true`` /
    ``false`` (any case), else the string."""
    config = {}
    for kv in argv:
        k, _, v = kv.partition("=")
        try:
            config[k] = int(v)
        except ValueError:
            try:
                config[k] = float(v)
            except ValueError:
                config[k] = {"true": True, "false": False}.get(v.lower(), v)
    return config


def main(argv=None) -> int:
    """CLI entry: ``python -m theanompi_tpu_torch.worker <rule> <modelfile>
    <modelclass> [key=value ...]``, one rank's process.  EASGD and ASGD
    with ``<rule>_mode=async`` train islands through the session API
    (``sync_rule``); every other run builds the rule's worker and model
    and runs the epoch loop."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print("usage: python -m theanompi_tpu_torch.worker <rule> "
              "<modelfile> <modelclass> [key=value ...]", file=sys.stderr)
        return 1
    rule, modelfile, modelclass = argv[:3]
    if rule not in WORKERS:
        print(f"unknown rule {rule!r}; have {sorted(WORKERS)}",
              file=sys.stderr)
        return 1
    config = {"rule": rule, **parse_config(argv[3:])}
    if config.get(f"{rule}_mode") == "async":
        from . import sync_rule
        session = getattr(sync_rule, rule.upper())(config)
        session.init(config.get("n_workers"), modelfile, modelclass)
        trainer = session.wait()
        if config.get("record_dir"):
            trainer.save(config["record_dir"])
        return 0
    worker = WORKERS[rule](config)
    try:
        worker.run(worker.build_model(modelfile, modelclass))
    finally:
        worker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
