"""Run-wide structured telemetry: metrics registry, event stream, flight
recorder.

Counterpart of ``theanompi_tpu/utils/telemetry.py``, a copy of its
stdlib-only module with the device probe on ``torch.cuda``.  Three
pieces, one process-wide instance (:func:`init` / :func:`active`):

* **Metrics registry**: named counters, gauges and bounded-reservoir
  histograms (p50/p95/p99), fed by the recorder's phase brackets (every
  ``recorder.end(section)`` lands one histogram sample and one ``phase``
  event), the ``para_load`` loader's queue probes, the exchanger's
  per-exchange timings and the wire client.
* **Event stream**: each event is one JSONL line tagged with ``ts`` /
  ``run`` / ``rank``, appended to ``<record_dir>/telemetry_rank{r}.jsonl``;
  :meth:`Telemetry.close` writes the ``telemetry_summary_rank{r}.json``
  sidecar with the final counters, gauges and histogram summaries.
* **Flight recorder**: a bounded in-memory ring of the last N events
  (the watchdog's ring-only heartbeats included), dumped to
  ``<record_dir>/flight_rank{r}.jsonl`` on a crash, a watchdog exit, a
  sentry anomaly or SIGTERM; ``launcher.py --supervise`` sweeps the dumps
  into ``crash_<tag>/`` before it restarts the world.

The event schema is the JAX package's, so its stdlib-only
``scripts/telemetry_report.py`` reads a port run's ``record_dir`` as it
is.  The device gauges keep the JAX names (``hbm_bytes_in_use``,
``hbm_peak_bytes``, ``hbm_bytes_limit``, ``hbm_min_headroom_bytes``): on
the card they are the caching allocator's bytes of this process.

**Cost contract**: telemetry is off unless the config enables it
(``record_dir`` set, or ``telemetry=true`` for an in-memory registry;
``telemetry=false`` forces it off).  Disabled, :func:`active` returns the
inert :data:`DISABLED` singleton whose ``enabled`` is ``False``: every
hot-path call site makes that ONE attribute check and skips the rest.

The module imports no torch at module scope; :meth:`Telemetry.system_snapshot`
imports it inside the call, which only the training thread makes (the
watchdog's monitor thread never touches CUDA).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# THE canonical phase list: ``recorder.SECTIONS``, the
# ``print_train_info`` record keys (``t_<phase>``) and the telemetry
# phase-event names (``phase`` events' ``sec`` field, ``phase.<name>``
# histograms), the JAX package's list
PHASES = ("compile", "train", "comm", "wait", "load", "stage", "val")

SCHEMA_VERSION = 1
FLIGHT_EVENTS = 256          # ring-buffer length (events, not bytes)


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process, or None when unknowable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        try:
            import resource
            # ru_maxrss is KiB on linux (peak, not current — close enough
            # as the fallback)
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            return None


def aggregate_memory_stats(stats: List[Optional[dict]]) -> Dict[str, int]:
    """Fold per-device ``memory_stats()`` dicts into the HBM gauge set.

    Device 0 alone hides single-host multi-chip pressure (one hot chip can
    OOM while device 0 reports headroom), so the aggregation is
    worst-case-oriented: bytes-in-use SUMS across devices (total HBM
    footprint), peak takes the MAX (the chip closest to OOM), the limit
    takes the per-device MIN (the binding budget — limits are uniform on
    real hardware, and when they aren't, the smallest one is the wall),
    and ``hbm_min_headroom_bytes`` is the worst single device's
    ``limit − peak``.  Devices reporting no stats (the CPU) are skipped;
    empty input → empty dict (host gauges still emit)."""
    out: Dict[str, int] = {}
    ms = [m for m in stats if m]
    if not ms:
        return out
    in_use = [int(m["bytes_in_use"]) for m in ms if "bytes_in_use" in m]
    if in_use:
        out["hbm_bytes_in_use"] = sum(in_use)
    peaks = [int(m["peak_bytes_in_use"]) for m in ms
             if "peak_bytes_in_use" in m]
    if peaks:
        out["hbm_peak_bytes"] = max(peaks)
    limits = [int(m["bytes_limit"]) for m in ms if "bytes_limit" in m]
    if limits:
        out["hbm_bytes_limit"] = min(limits)
    headrooms = [int(m["bytes_limit"]) - int(m["peak_bytes_in_use"])
                 for m in ms
                 if "bytes_limit" in m and "peak_bytes_in_use" in m]
    if headrooms:
        out["hbm_min_headroom_bytes"] = min(headrooms)
    return out


def cuda_memory_stats() -> List[dict]:
    """``memory_stats()``-shaped dicts (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``) of the caching allocator on
    every card this process has allocated on; ``[]`` without CUDA, or
    before this process initialized it (the CPU)."""
    try:
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            peak = int(ms.get("allocated_bytes.all.peak", 0))
            if not peak:
                continue              # a card this process never used
            out.append({
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": peak,
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory)})
        return out
    except Exception:
        return []


class Histogram:
    """Bounded-reservoir histogram with exact count/sum/min/max.

    Samples are exact until ``cap``; past it the reservoir is thinned by
    keeping every other sample and doubling the record stride —
    systematic (deterministic) sampling, so tail percentiles stay
    representative while memory stays bounded."""

    __slots__ = ("count", "total", "min", "max", "_samples", "_stride",
                 "_skip", "_cap")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        self._cap = int(cap)
        self._stride = 1
        self._skip = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        self._skip += 1
        if self._skip >= self._stride:
            self._skip = 0
            self._samples.append(v)
            if len(self._samples) >= self._cap:
                self._samples = self._samples[::2]
                self._stride *= 2

    def percentile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    def summary(self) -> dict:
        mean = self.total / self.count if self.count else None
        return {"count": self.count, "sum": round(self.total, 6),
                "min": self.min, "max": self.max,
                "mean": round(mean, 6) if mean is not None else None,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class Telemetry:
    """One process-wide (per-rank) registry + stream + flight ring.

    Thread-safe: the worker hot loop, the PrefetchLoader producer, and
    the watchdog monitor all feed it concurrently."""

    enabled = True

    def __init__(self, rank: int = 0, run_id: Optional[str] = None,
                 stream_dir: Optional[str] = None,
                 flight_events: int = FLIGHT_EVENTS, flush_every: int = 64):
        self.rank = int(rank)
        self.run_id = str(run_id) if run_id else \
            f"run{int(time.time())}p{os.getpid()}"
        self.stream_dir = stream_dir
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self._ring: deque = deque(maxlen=int(flight_events))
        # REENTRANT: the fatal-signal hook runs its dump on whatever thread
        # the signal lands on — if that thread was inside event() holding
        # the lock, a plain Lock would deadlock the dying process
        self._lock = threading.RLock()
        self._fh = None
        self._unflushed = 0
        self._flush_every = int(flush_every)
        if stream_dir:
            os.makedirs(stream_dir, exist_ok=True)
            # append: a supervised restart continues the same per-rank file
            # (events carry their own run id, so runs stay separable)
            self._fh = open(os.path.join(
                stream_dir, f"telemetry_rank{self.rank}.jsonl"), "a")
        self.event("run_start", schema=SCHEMA_VERSION, pid=os.getpid())

    # -- metrics ------------------------------------------------------------

    def counter(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram()
            h.observe(value)

    def phase(self, section: str, dt: float) -> None:
        """One recorder phase bracket: histogram sample + stream event.
        Event names and fields are the JAX package's schema."""
        self.observe("phase." + section, dt)
        self.event("phase", sec=section, dt=round(dt, 6))

    # -- events -------------------------------------------------------------

    def event(self, name: str, /, ring_only: bool = False,
              **fields) -> None:
        # ``name`` is positional-ONLY so a field may also be called
        # "name" (the span events carry one) without colliding
        ev = {"ts": round(time.time(), 3), "run": self.run_id,
              "rank": self.rank, "ev": name}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            if ring_only or self._fh is None:
                return
            try:
                self._fh.write(json.dumps(ev) + "\n")
                self._unflushed += 1
                if self._unflushed >= self._flush_every:
                    self._fh.flush()
                    self._unflushed = 0
            except (OSError, ValueError):
                pass            # telemetry must never fail the run

    def tail(self, n: int = 8) -> List[dict]:
        with self._lock:
            return list(self._ring)[-n:]

    # -- gauge snapshots ----------------------------------------------------

    def system_snapshot(self, **extra) -> dict:
        """Device memory of this process on every card it allocated on
        (:func:`aggregate_memory_stats` over :func:`cuda_memory_stats`:
        summed bytes in use, max peak, min limit, worst-device headroom,
        plus ``device_count``), host RSS, the current prefetch queue depth
        (when the loader exports it), and caller extras (iteration rate,
        count), recorded as gauges AND streamed as one ``gauges`` event.
        Called on the training thread only."""
        vals = dict(extra)
        stats = cuda_memory_stats()
        if stats:
            vals["device_count"] = len(stats)
            vals.update(aggregate_memory_stats(stats))
        rss = host_rss_bytes()
        if rss:
            vals["host_rss_bytes"] = rss
        qd = self.gauges.get("prefetch.queue_depth")
        if qd is not None:
            # sampled into the stream here (the loader only sets the gauge
            # on its hot path): the report's queue-depth counter track
            vals["prefetch.queue_depth"] = qd
        for k, v in vals.items():
            if isinstance(v, (int, float)):
                self.gauge(k, v)
        self.event("gauges", **vals)
        return vals

    # -- summary / flight dump / lifecycle ----------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {"run": self.run_id, "rank": self.rank,
                    "counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "hist": {k: h.summary() for k, h in self.hists.items()}}

    def dump_flight(self, reason: str = "",
                    dump_dir: Optional[str] = None) -> Optional[str]:
        """Write the ring buffer to ``flight_rank{r}.jsonl`` — the what-was-
        this-rank-doing trail for crash/stall post-mortems.  First line is a
        header with the reason; returns the path (None without a dir)."""
        d = dump_dir or self.stream_dir
        if not d:
            return None
        path = os.path.join(d, f"flight_rank{self.rank}.jsonl")
        try:
            os.makedirs(d, exist_ok=True)
            with self._lock:
                events = list(self._ring)
            with open(path, "w") as f:
                f.write(json.dumps(
                    {"ts": round(time.time(), 3), "run": self.run_id,
                     "rank": self.rank, "ev": "flight_dump",
                     "reason": str(reason)[:300],
                     "events": len(events)}) + "\n")
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
        except OSError:
            return None
        return path

    def close(self) -> None:
        """Flush + close the stream and write the summary sidecar; the
        instance goes inert (``enabled=False``) so stale references left in
        other components after a re-:func:`init` become no-ops."""
        with self._lock:
            fh, self._fh = self._fh, None
        self.enabled = False
        if fh is not None:
            try:
                fh.flush()
                fh.close()
            except (OSError, ValueError):
                pass
        if self.stream_dir:
            try:
                with open(os.path.join(
                        self.stream_dir,
                        f"telemetry_summary_rank{self.rank}.json"),
                        "w") as f:
                    json.dump(self.summary(), f, indent=1, sort_keys=True)
            except OSError:
                pass


class _Disabled:
    """The inert registry: one attribute check (``enabled``) is the whole
    hot-path cost; every method is a no-op for call sites that don't
    guard."""

    enabled = False
    rank = 0
    run_id = None
    stream_dir = None
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}

    def counter(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def phase(self, section, dt):
        pass

    def event(self, name, /, ring_only=False, **fields):
        pass

    def tail(self, n=8):
        return []

    def system_snapshot(self, **extra):
        return {}

    def summary(self):
        return {}

    def dump_flight(self, reason="", dump_dir=None):
        return None

    def close(self):
        pass


DISABLED = _Disabled()

_ACTIVE: Any = DISABLED


def active():
    """The process-wide registry — :data:`DISABLED` until :func:`init`
    enables one.  Components (prefetch, exchanger, wire, watchdog)
    read it lazily so no config threading is needed."""
    return _ACTIVE


def init(config: Optional[dict] = None):
    """(Re)initialize process-wide telemetry from a worker/model config.

    Enablement: ``telemetry=false`` force-disables; otherwise a
    ``record_dir`` enables the streaming registry (events land next to the
    recorder's inforec files), and ``telemetry=true`` without a dir
    enables an in-memory registry (metrics + flight ring, no stream).
    A previous instance is closed first, so repeated in-process sessions
    don't leak file handles or cross-write streams."""
    global _ACTIVE
    config = config or {}
    t = config.get("telemetry", None)
    if t is False or (isinstance(t, str) and t.lower() == "false"):
        new: Any = DISABLED
    else:
        stream_dir = config.get("record_dir") or \
            (t if isinstance(t, str) else None)
        if t or stream_dir:
            new = Telemetry(rank=int(config.get("rank", 0)),
                            run_id=config.get("run_id"),
                            stream_dir=stream_dir,
                            flight_events=int(config.get(
                                "telemetry_flight_events", FLIGHT_EVENTS)),
                            # low-rate emitters that die by SIGKILL (the
                            # center process) flush eagerly so their
                            # span/audit tail survives the kill
                            flush_every=int(config.get(
                                "telemetry_flush_every", 64)))
        else:
            new = DISABLED
    old, _ACTIVE = _ACTIVE, new
    if old is not DISABLED and old is not new:
        old.close()
    return new


def install_signal_hooks(signals=None) -> None:
    """Dump the flight recorder on a fatal signal, then re-raise it with
    the default handler so the exit code stays honest.  Installed by the
    worker CLI entry only (never by the in-process session API — tests
    and host applications own their handlers).

    SIGTERM only by default: SIGINT must keep raising KeyboardInterrupt so
    the worker's unwind path runs (the crash event and flight dump in its
    except) — a kill-style handler there would skip it."""
    import signal as _signal
    sigs = signals or (_signal.SIGTERM,)

    def _handler(signum, frame):
        tm = active()
        if tm.enabled:
            tm.event("fatal_signal", signum=int(signum))
            tm.dump_flight(reason=f"signal {signum}")
            tm.close()
        _signal.signal(signum, _signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    for s in sigs:
        try:
            _signal.signal(s, _handler)
        except (ValueError, OSError):
            pass                # not the main thread / unsupported signal


def sweep_flight_dumps(record_dir: str, tag: str) -> Optional[str]:
    """Move per-rank ``flight_rank*.jsonl`` dumps into
    ``<record_dir>/crash_<tag>/`` — called by ``launcher.py`` after a
    supervised worker dies, so the restart's own eventual dumps cannot
    overwrite the trail that explains the death.  Returns the destination
    (None when there was nothing to sweep)."""
    import glob
    import shutil
    dumps = sorted(glob.glob(os.path.join(record_dir, "flight_rank*.jsonl")))
    if not dumps:
        return None
    dest = os.path.join(record_dir, f"crash_{tag}")
    os.makedirs(dest, exist_ok=True)
    for p in dumps:
        try:
            shutil.move(p, os.path.join(dest, os.path.basename(p)))
        except OSError:
            pass
    return dest
