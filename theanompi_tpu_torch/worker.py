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
restores the newest valid checkpoint before training.

The operations planes ride the loop as in the JAX package, each off
unless the config turns it on, each costing one attribute check when off:
telemetry (``record_dir`` streams ``telemetry_rank{r}.jsonl``;
``telemetry=true`` keeps the registry in memory; ``utils/telemetry.py``),
causal tracing (``tracing=true``: ``exchange`` spans, a ``statusz``
endpoint registered under ``record_dir``; ``utils/tracing.py``), the
numerics plane (``numerics=true``, ``numerics_every``: sampled inside the
step, reported at print cadence; ``utils/numerics.py``), the training
sentry (on with telemetry, ``sentry=false`` opts out; ``utils/sentry.py``)
and the stall watchdog (``stall_timeout`` seconds, ``stall_action``
``'trace'`` or ``'exit'``: exit code 42 after the flight dump, for
``launcher.py --supervise``; ``utils/watchdog.py``).  Device profiling
(``trace_dir``), chaos, membership leases (``lease_dir``) and the fleet
monitor (``metrics_addr``) are not ported yet and are refused.

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
from .utils import numerics, telemetry, tracing
from .utils.recorder import Recorder
from .utils.sentry import TrainingSentry
from .utils.watchdog import StallWatchdog

# the JAX worker's keys that wait for later operations planes, with why
_REFUSED = {
    "trace_dir": "device profiling (devprof on torch.profiler)",
    "chaos": "the chaos harness, which drives elastic membership",
    "lease_dir": "membership leases",
    "metrics_addr": "the fleet monitor (fleetmon)",
}


class Worker(MeshProcess):
    """Generic rule-driven worker (≙ reference ``BSP_Worker`` et al.)."""

    rule = "bsp"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        for k, what in _REFUSED.items():
            if self.config.get(k):
                raise NotImplementedError(
                    f"config {k!r}: {what} is not ported yet (ROADMAP A10)")
        stall_action = str(self.config.get("stall_action", "trace"))
        if stall_action not in ("trace", "exit"):
            raise ValueError(f"unknown stall_action {stall_action!r}: use "
                             f"'trace' (diagnostic dump only) or 'exit' "
                             f"(exit for a supervised restart)")
        self.get_internode_comm()
        try:
            # process-wide telemetry and tracing, tagged with the world
            # rank (a grid's ranks share their worker's): every component
            # reads telemetry.active() / tracing.active() lazily
            self.telemetry = telemetry.init(dict(self.config,
                                                 rank=self.world_rank))
            self.tracing = tracing.init(self.config)
            self.recorder = Recorder(self.config)
            self.recorder.telemetry = self.telemetry
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
        telem = self.telemetry
        rank = self.world_rank
        stall_action = str(config.get("stall_action", "trace"))
        # the training sentry: NaN, loss spike, throughput regression and
        # the numerics anomalies, at print cadence; on with telemetry
        sentry = None
        if telem.enabled and config.get("sentry", True):
            sentry = TrainingSentry(config, telem)
        self.sentry = sentry
        # the live ops endpoint, registered in the run dir
        statusz = None
        if telem.enabled and config.get("record_dir") and \
                config.get("statusz", True):
            statusz = tracing.StatuszServer(
                "worker", ident=rank, run_dir=config["record_dir"],
                telemetry_=telem, tracer_=self.tracing)
            statusz.start()
        self.statusz = statusz

        def on_stall(elapsed, label):
            # the monitor thread's: host work only, never CUDA (a hung
            # replay or collective holds the card's queue)
            StallWatchdog._default_handler(watchdog, elapsed, label)
            if telem.enabled:
                telem.event("stall", elapsed=round(elapsed, 1), label=label,
                            action=stall_action)
                telem.dump_flight(reason=f"watchdog stall {elapsed:.0f}s "
                                         f"at {label}")
            if stall_action == "exit":
                import os
                if telem.enabled:
                    telem.close()
                print("WATCHDOG: stall_action=exit — terminating for "
                      "supervisor restart", flush=True)
                os._exit(42)

        watchdog = StallWatchdog(float(config.get("stall_timeout", 0)),
                                 on_stall=on_stall)
        self.watchdog = watchdog
        if telem.enabled:
            telem.event("train_begin", rule=config.get("rule", self.rule),
                        model=type(model).__name__, spc=spc,
                        start_epoch=start_epoch, epochs=epochs,
                        size=self.size)
        try:
            with watchdog:
                for epoch in range(start_epoch, epochs):
                    model.adjust_hyperp(epoch)
                    model.data.shuffle_data(epoch + model.seed)
                    for _ in range(model.data.n_batch_train // spc):
                        count += spc
                        model.train_iter(count, self.recorder)
                        self.exchanger.exchange(self.recorder, count)
                        watchdog.beat(f"epoch {epoch} iter {count}")
                        rec = self.recorder.print_train_info(count, spc)
                        if rec and telem.enabled:
                            telem.system_snapshot(
                                iter=count, epoch=epoch,
                                images_per_sec=rec["images_per_sec"])
                        # the numerics sample, read back at print cadence
                        # (the cost was just read back there too)
                        n_report = None
                        aux = model.numerics_aux if rec and telem.enabled \
                            else None
                        if aux is not None:
                            n_report = numerics.host_report(
                                numerics.to_host(aux))
                            numerics.record(telem, n_report, rank=rank)
                        if rec and sentry is not None:
                            sentry.observe_record(rec)
                            if n_report is not None:
                                sentry.observe_numerics(n_report)
                    model.begin_val()
                    for _ in range(model.data.n_batch_val):
                        model.val_iter(count, self.recorder)
                        watchdog.beat(f"epoch {epoch} val @ iter {count}")
                    model.end_val()
                    self.recorder.print_val_info(count)
                    if ckpt_dir:
                        model.save(ckpt_dir, epoch, count)
                    if config.get("record_dir"):
                        self.recorder.save(config["record_dir"])
                    watchdog.beat(f"epoch {epoch} end (ckpt/records saved)")
                    if sentry is not None:
                        # the next record's images/sec spans validation and
                        # the checkpoint: not a throughput regression
                        sentry.notice_discontinuity()
        except BaseException as e:
            # the flight trail next to the records, then the error;
            # launcher --supervise sweeps the dumps aside before restarting
            if telem.enabled:
                telem.event("crash", error=repr(e)[:300])
                telem.dump_flight(reason=repr(e)[:200])
                telem.close()
            if statusz is not None:
                statusz.stop(deregister=False)   # listed as down
            raise
        if statusz is not None:
            statusz.stop()
        if telem.enabled:
            telem.event("train_end", secs=round(time.time() - t0, 3),
                        epochs=epochs - start_epoch)
            telem.close()       # the stream flushed, the summary sidecar
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
    # a worker process dumps its flight ring on SIGTERM (a supervisor's or
    # a scheduler's kill); the session API leaves signals to its host
    telemetry.install_signal_hooks()
    raise SystemExit(main())
