"""Stall watchdog: failure detection for hung steps and collectives.

Counterpart of ``theanompi_tpu/utils/watchdog.py``, a copy (stdlib only).
A hung NCCL collective or a hung graph replay blocks the main thread
inside a torch call, so detection runs OFF the main thread.

:class:`StallWatchdog` is a daemon thread fed by heartbeats from the worker
loop (``stall_timeout`` config, 0 = off).  On a stall it emits one
diagnostic (elapsed time, the last heartbeat label, and a traceback dump
of every live thread through ``faulthandler``, showing where the main
thread is stuck) and invokes an optional callback (the worker's
``stall_action='exit'`` dumps the flight ring and exits with code 42, for
a supervised restart from the newest checkpoint).  The monitor thread
touches no CUDA: a ``torch.cuda`` call there could block behind the very
call that hangs.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import time
from typing import Callable, Optional

from . import telemetry


class StallWatchdog:
    """Daemon heartbeat monitor.

    ``on_stall(elapsed_s, last_label)`` fires once per stall episode (it
    re-arms when heartbeats resume).  The default handler prints the
    diagnostic and all-thread tracebacks to stderr.
    """

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[float, str], None]] = None,
                 poll_s: Optional[float] = None,
                 first_timeout_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        # before the FIRST beat the job is usually compiling (minutes for a
        # big model) — use a much larger threshold so startup isn't a
        # spurious "stall"
        self.first_timeout_s = float(first_timeout_s) \
            if first_timeout_s is not None else 10.0 * self.timeout_s
        self.on_stall = on_stall or self._default_handler
        self.poll_s = poll_s if poll_s is not None else \
            max(0.05, self.timeout_s / 4)
        self._last_beat = time.monotonic()
        self._last_label = "(no heartbeat yet)"
        self._beaten = False
        # single-writer re-arm protocol: the
        # hot loop bumps `_beat_seq` (ONLY beat writes it), the monitor
        # remembers which beat it fired for in ITS local state — no
        # attribute is written from two threads, so there is no window
        # where a beat landing between the monitor's check and set could
        # be lost or double-fire a stall
        self._beat_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    # -- heartbeat (called from the worker hot loop) ------------------------

    def beat(self, label: str = "") -> None:
        self._last_beat = time.monotonic()
        if label:
            self._last_label = label
        self._beaten = True
        self._beat_seq += 1          # re-arms the monitor (sole writer)
        # heartbeats feed the telemetry flight ring (ring-only: the stream
        # would drown in them) — the dump then shows exactly what the rank
        # was doing in the window before a stall/crash
        tm = telemetry.active()
        if tm.enabled:
            tm.event("beat", ring_only=True, label=label)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StallWatchdog":
        if self.timeout_s <= 0:
            return self
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- monitor ------------------------------------------------------------

    def _monitor(self) -> None:
        fired_for = -1               # monitor-local: last beat seq fired on
        while not self._stop.wait(self.poll_s):
            seq = self._beat_seq
            elapsed = time.monotonic() - self._last_beat
            threshold = self.timeout_s if self._beaten else self.first_timeout_s
            if elapsed > threshold and seq != fired_for:
                fired_for = seq      # one fire per stall episode; a new
                self.stall_count += 1     # beat advances seq and re-arms
                try:
                    self.on_stall(elapsed, self._last_label)
                except Exception as e:     # a broken handler must not kill
                    print(f"watchdog handler failed: {e!r}", file=sys.stderr)

    def _default_handler(self, elapsed: float, label: str) -> None:
        print(f"WATCHDOG: no progress for {elapsed:.1f}s "
              f"(timeout {self.timeout_s:.1f}s); last heartbeat: {label}. "
              f"Dumping all thread stacks:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr)
        # the last few flight-recorder events inline: what the rank was
        # doing when it hung, diagnosable from the console log alone
        tail = telemetry.active().tail(8)
        if tail:
            print("WATCHDOG: last telemetry events before the stall:",
                  file=sys.stderr)
            for ev in tail:
                bits = " ".join(f"{k}={v}" for k, v in ev.items()
                                if k not in ("run", "rank"))
                print(f"  {bits}", file=sys.stderr)
            sys.stderr.flush()
