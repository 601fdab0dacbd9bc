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
restores the newest valid checkpoint before training (one of another
worker count too, where its layout refits: ``ModelBase.load``).  With
``async_ckpt`` the write in flight lands before the loop returns, also
while an exception unwinds it.

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
``launcher.py --supervise``; ``utils/watchdog.py``), the membership
lease (``lease_dir``: a ``WorkerLease`` beaten each iteration, each
validation batch and each epoch's end, released on a clean exit;
``parallel/membership.py``) and the fleet monitor's streamer
(``metrics_addr``, with telemetry on: the rank's metric snapshots every
``metrics_interval_s``; ``utils/fleetmon.py``) and device profiling
(``trace_dir``: a ``torch.profiler`` window of ``trace_iters`` steps, 5,
from the step ``trace_start``, 5, rounded up to whole ``steps_per_call``
windows, each ``train_iter`` call a ``record_function`` span; the
profiler warms up over the call before the window; after it the card is
synchronized, the trace written to
``<trace_dir>/iter<count>/rank<r>.pt.trace.json.gz`` and attributed by
``utils/devprof.py``: the ``device.*`` gauges with telemetry on, the
breakdown printed when verbose).  The JAX worker reads no ``chaos`` key,
and neither does this one.

The start-up record (``Worker.startup``, printed when verbose, a
``startup`` event with telemetry on) gives the seconds from the process's
start to ``torch`` imported, the CUDA context ready, the model built, the
kernel libraries loaded (the last load by the first step's end; None when
the step loads none), the first capture done (the first ``train_iter``
call returned on the host) and the first step done (the card
synchronized).  With a compile cache (``compile_cache=<dir>`` or
``$THEANOMPI_COMPILE_CACHE``: ``utils/compile_cache.py``) the verbose
worker prints the JAX worker's line after it: ``compile cache
[<counters>] kernels: <rung> (<secs>s) | train: not storable (<secs>s)``.

:func:`main` is the per-rank command line the launcher composes
(``theanompi_tpu_torch/launcher.py``):

    python -m theanompi_tpu_torch.worker <rule> <modelfile> <modelclass> \\
        [key=value ...]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import torch
from torch.profiler import record_function

from .base import MeshProcess
from .ops import _kernel_build
from .parallel.exchanger import get_exchanger
from .utils import devprof, numerics, telemetry, tracing
from .utils.recorder import Recorder
from .utils.sentry import TrainingSentry
from .utils.watchdog import StallWatchdog

_T_TORCH = time.time()        # torch is imported (the start-up record)


def process_start() -> float:
    """The wall clock at which this process started (``/proc``; the
    import of this module where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_TORCH


def startup_line(rec: dict) -> str:
    """The verbose start-up line of a :attr:`Worker.startup` record."""
    return "start-up (s from process start): " + ", ".join(
        f"{k} " + ("-" if v is None else f"{v:.2f}") for k, v in rec.items())


class Worker(MeshProcess):
    """Generic rule-driven worker (≙ reference ``BSP_Worker`` et al.)."""

    rule = "bsp"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self._t0 = process_start()
        self.startup = {"torch": _T_TORCH - self._t0}
        stall_action = str(self.config.get("stall_action", "trace"))
        if stall_action not in ("trace", "exit"):
            raise ValueError(f"unknown stall_action {stall_action!r}: use "
                             f"'trace' (diagnostic dump only) or 'exit' "
                             f"(exit for a supervised restart)")
        self.get_internode_comm()
        self.startup["cuda"] = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the context is made
            self.startup["cuda"] = time.time() - self._t0
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
        self.startup["model"] = getattr(self, "t_model_built",
                                        time.time()) - self._t0
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
        cuda = model.device.type == "cuda"
        # device profiling: a torch.profiler window of trace_iters steps
        # from trace_start, rounded up to whole steps_per_call windows
        trace_dir = config.get("trace_dir")
        trace_start = int(config.get("trace_start", 5))
        trace_iters = max(1, int(config.get("trace_iters", 5)))
        trace_pending = bool(trace_dir)
        trace = None
        trace_stop_at = None
        first_call = True
        self.device_profile = None
        stall_action = str(config.get("stall_action", "trace"))
        # the membership lease: beaten wherever the watchdog is (it
        # throttles itself, so a step costs one clock read, not a write)
        lease = None
        if config.get("lease_dir"):
            from .parallel.membership import WorkerLease
            lease = WorkerLease(config["lease_dir"], rank, telemetry_=telem)
            lease.beat(count)
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
        # the fleet monitor's streamer: a daemon thread reading the
        # registry this loop feeds
        streamer = None
        if telem.enabled and config.get("metrics_addr"):
            from .utils.fleetmon import MetricStreamer
            streamer = MetricStreamer(
                str(config["metrics_addr"]), rank=rank, role="worker",
                interval_s=float(config.get("metrics_interval_s", 1.0)),
                telemetry_=telem)
            streamer.start()

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

        def stop_trace():
            # the window's work drained, the trace written, then attributed
            # (device-time breakdown: the host's comm bucket goes blind
            # once a collective overlaps the backward)
            nonlocal trace, trace_stop_at
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.synchronize(model.device)
            t, trace, trace_stop_at = trace, None, None
            sync_secs = time.perf_counter() - t0
            path = t.stop()
            if self.verbose:
                print(f"profiler trace saved to {path}", flush=True)
            t0 = time.perf_counter()
            try:
                prof = devprof.profile_dir(os.path.dirname(path),
                                           name=t.name)
            except Exception as e:
                prof = None
                print(f"devprof: trace attribution failed ({e!r})",
                      flush=True)
            self.device_profile = prof
            if prof is not None:
                # what the window cost the host, by part
                prof["trace_secs"] = {
                    "start": t.start_secs, "sync": sync_secs,
                    "export": t.stop_secs,
                    "parse": time.perf_counter() - t0}
                prof["trace_bytes"] = os.path.getsize(path)
                if telem.enabled:
                    devprof.feed_telemetry(prof, telem)
                if self.verbose:
                    print(devprof.format_profile(prof, top=5), flush=True)
            if sentry is not None:
                # the synchronize and the parse are dead wall time inside
                # the next record's images/sec window
                sentry.notice_discontinuity()

        def first_step_done():
            # the start-up record's last points, and its lines
            self.startup["capture"] = (time.time() - self._t0) \
                if model.train_fn.graphed else None
            if cuda:
                torch.cuda.synchronize(model.device)
            self.startup["step"] = time.time() - self._t0
            done = [i["t_done"] for i in _kernel_build.loads().values()] \
                if cuda else []
            self.startup["kernels"] = max(done) - self._t0 if done else None
            rec = {k: self.startup.get(k) for k in
                   ("torch", "cuda", "model", "kernels", "capture", "step")}
            self.startup = rec
            if telem.enabled:
                telem.event("startup", **rec)
            if self.verbose:
                print(startup_line(rec), flush=True)
                self._log_compile_cache(model)
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
                        if trace_pending and count + spc >= trace_start:
                            # the profiler warms up over the call before
                            # the window, where there is one (devprof.Trace)
                            warm = count < trace_start
                            first = count + spc if warm else count
                            trace = devprof.Trace(
                                trace_dir, name=f"rank{rank}",
                                session=f"iter{first:08d}", cuda=cuda,
                                warmup=warm)
                            trace.start()
                            trace_pending = False
                            trace_stop_at = first + max(
                                1, (trace_iters + spc - 1) // spc) * spc
                        elif trace is not None and trace.warming:
                            if cuda:
                                torch.cuda.synchronize(model.device)
                            trace.record()
                        # devprof's dispatch anchor, on the host around
                        # the call (a replay, or the first call's eager
                        # step and capture)
                        with record_function(devprof.TRAIN_DISPATCH_SPAN):
                            model.train_iter(count, self.recorder)
                        if first_call:
                            first_call = False
                            first_step_done()
                        self.exchanger.exchange(self.recorder, count)
                        if trace_stop_at is not None and \
                                count + spc >= trace_stop_at:
                            stop_trace()
                        watchdog.beat(f"epoch {epoch} iter {count}")
                        if lease is not None:
                            lease.beat(count)
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
                        if telem.enabled and aux is not None:
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
                        if lease is not None:
                            lease.beat(count)
                    model.end_val()
                    self.recorder.print_val_info(count)
                    if ckpt_dir:
                        model.save(ckpt_dir, epoch, count)
                    if config.get("record_dir"):
                        self.recorder.save(config["record_dir"])
                    watchdog.beat(f"epoch {epoch} end (ckpt/records saved)")
                    if lease is not None:
                        lease.beat(count, epoch=epoch)
                    if sentry is not None:
                        # the next record's images/sec spans validation and
                        # the checkpoint: not a throughput regression
                        sentry.notice_discontinuity()
        except BaseException as e:
            if trace is not None:
                # a failed run leaves no profiler running in its process
                try:
                    trace.stop()
                except Exception:
                    pass
                trace = None
            # the flight trail next to the records, then the error;
            # launcher --supervise sweeps the dumps aside before restarting
            if telem.enabled:
                telem.event("crash", error=repr(e)[:300])
                telem.dump_flight(reason=repr(e)[:200])
                telem.close()
            if statusz is not None:
                statusz.stop(deregister=False)   # listed as down
            if streamer is not None:
                # silent: the collector's heartbeat age alerts on it
                streamer.stop(final=False)
            raise
        finally:
            # async_ckpt: an epoch's write in flight lands even while an
            # exception (or Ctrl-C) unwinds the loop; the daemon writer
            # would otherwise die mid-write.  Its own failure surfaces on a
            # clean exit and never hides the unwinding error.
            unwinding = sys.exc_info()[0] is not None
            wait = getattr(model, "wait_pending_ckpt", None)
            try:
                if wait is not None:
                    wait()
            except Exception as ckpt_exc:
                if not unwinding:
                    raise
                print(f"async checkpoint ALSO failed during unwind: "
                      f"{ckpt_exc!r}", file=sys.stderr, flush=True)
        if trace is not None:      # the window outlived training: flush it
            stop_trace()
        if statusz is not None:
            statusz.stop()
        if streamer is not None:
            streamer.stop(final=True)      # retired, not a lost heartbeat
        if lease is not None:
            lease.release()     # a clean departure: 'finished', not a death
        if telem.enabled:
            telem.event("train_end", secs=round(time.time() - t0, 3),
                        epochs=epochs - start_epoch)
            telem.close()       # the stream flushed, the summary sidecar
        if self.verbose:
            print(f"training finished in {time.time() - t0:.1f}s "
                  f"({epochs - start_epoch} epochs)", flush=True)
        return self.recorder

    def _log_compile_cache(self, model) -> None:
        """The JAX worker's start-up line for the compile cache: each
        surface's rung and seconds, and the process counters."""
        cache = getattr(model, "compile_cache", None)
        if cache is None or not cache.enabled:
            return
        parts = [f"{k}: {v['cache']}"
                 + (f" ({v['compile_secs']:.1f}s)"
                    if v.get("compile_secs") is not None else "")
                 + (f" {v['libraries']}" if v.get("libraries") else "")
                 for k, v in model.compile_info.items()]
        print(f"compile cache [{cache.describe()}] " + " | ".join(parts),
              flush=True)


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
