"""Device-time attribution from ``torch.profiler`` trace captures.

Counterpart of ``theanompi_tpu/utils/devprof.py``.  The recorder's
``comm`` bucket times the HOST side of an exchange: what the host waited
for.  Once a collective overlaps the backward that bracket measures a
queue push, and the question that governs scaling, how much collective
time is *exposed* (serialized against compute) against *hidden* (under
it), is answerable only from the device timeline the profiler records.

**The trace.**  ``torch.profiler`` (Kineto) exports a Chrome trace,
``*.pt.trace.json`` (gzipped when the name ends in ``.gz``).  A capture
session is a directory under ``trace_dir`` holding one such file per rank
or host (:func:`capture`, the worker's ``trace_dir`` window); the reader
takes the newest session and tags each file's events ``_src``.  The
categories of a real trace (torch 2.11.0+cu128 on an NVIDIA H100 80GB
HBM3: a graph replay, GEMMs, copies, sets and an NCCL all-reduce, with
``record_function`` spans): ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` for work on the card (``pid`` the device, ``tid`` the
stream, ``args.correlation``); ``gpu_user_annotation``, a
``record_function`` span mirrored onto the card's timeline;
``cuda_runtime`` for the host's API calls (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``, each
with the ``correlation`` of the work it launched); ``cpu_op`` for ATen
ops; ``user_annotation`` for ``record_function`` spans and c10d's
collectives (``nccl:all_reduce``; gloo's ``gloo:all_reduce`` on gloo's
own threads); ``overhead`` (the profiler's own, ``pid`` -1); ``ac2g``
flow arrows; ``Trace``.  Driver-API launches come as ``cuda_driver``,
read as launches too.  A **device op** is a complete (``"ph": "X"``)
event of a device category (:data:`DEVICE_CATEGORIES`); every other
category is skipped, so no host time ever counts as device time.  This
replaces the JAX marker ``args.hlo_op``.

**Lanes.**  In a CUDA trace a device op's ``pid`` is the card and its
``tid`` the stream, and NCCL launches its kernels on a stream of its own.
A lane per stream, the JAX rule's ``(pid, tid)``, would call every NCCL
kernel exposed even while the compute stream's kernels hide it.  So a
lane here is one card, ``(_src, pid)``, with all its streams unioned:

* ``comm_secs``      = Σ lanes measure(comm ∪)
* ``compute_secs``   = Σ lanes measure(compute ∪)
* ``exposed_comm_secs`` = Σ lanes [measure(comm ∪) −
  measure(comm ∪ ∩ compute ∪)]: collective time with no compute running
  on the same card, on any stream
* ``overlap_ratio``  = 1 − exposed_comm / comm (None without comm)
* ``bubble_fraction``: per card, the idle share of its first-compute to
  last-compute span, span-weighted over the cards.

**Comm ops** are NCCL's kernels (:data:`COMM_OP_PREFIXES`: the
``ncclDevKernel_…`` and ``ncclKernel_…`` families, AllReduce, AllGather,
ReduceScatter, Broadcast, SendRecv, ...); :func:`op_class` strips a
name's template and argument tail.  NCCL's SendRecv (the p2p hops of
``parallel/pipeline.py``) is the ``hop`` class of
:func:`schedule_occupancy`, where the JAX module reads
``collective-permute``.  A CUDA trace has no async ``-start``/``-done``
pairs, so the JAX ``_merge_async_pairs`` is not ported: the case it
answers, a collective whose halves sit on another stream than the compute
that hides it, is the per-card lane above.

**Host anchors.**  The worker wraps each ``model.train_iter`` call in a
``record_function`` span named :data:`TRAIN_DISPATCH_SPAN`, the
exchanger its standalone exchange in :data:`EXCHANGE_SPAN`; the parser
counts the host ones (not their ``gpu_user_annotation`` mirrors).  The
JAX ``modules`` map is keyed by ``hlo_module``; here each device op is
keyed by the anchor that launched it: its ``args.correlation`` leads to
the host's launch event (``cudaLaunchKernel``, ``cudaGraphLaunch`` for a
replayed CUDA graph's kernels, ...), and the innermost anchor span on the
same host thread that holds that launch names the op's module; an op no
anchor holds is ``other``.

**device_mfu** takes :data:`PEAK_FLOPS`, the dense bf16 tensor-core peak
of an NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, 989.4
TFLOP/s (NVIDIA's data sheet), when the caller names no other.

Consumers: the worker's ``trace_dir`` window feeds the result into the
telemetry registry as ``device.*`` gauges (:func:`feed_telemetry`) and
prints :func:`format_profile`; ``chip_smoke.py --ops`` holds a traced
AlexNet step against its profile's busy time.

Stdlib at module scope (no torch, no jax, nothing of the JAX package);
:func:`capture` imports torch when it starts, and the two model reports
read the port's modules inside the call.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Dispatch-anchor span names (host-side torch.profiler.record_function):
# worker.py wraps each train_iter call, exchanger.exchange the standalone
# exchange.  Constant strings: the parser matches them exactly.
TRAIN_DISPATCH_SPAN = "theanompi.train_dispatch"
EXCHANGE_SPAN = "theanompi.exchange"

# The device.* gauge vocabulary feed_telemetry emits (the JAX package's)
DEVICE_GAUGES = (
    "device.compute_secs",
    "device.comm_secs",
    "device.exposed_comm_secs",
    "device.overlap_ratio",
    "device.lanes",
)
PROFILE_EVENT = "device_profile"

# The bench-row columns of a traced row (profile_row_fields emits exactly
# these keys): the JAX package's vocabulary.
TRACE_ROW_COLUMNS = (
    "overlap_ratio",
    "exposed_comm_secs",
    "device_compute_secs",
    "device_comm_secs",
    "device_mfu",
    # per-lane idle share between compute intervals inside the dispatch
    # window: span-weighted over compute lanes, 1 − busy/span per lane.
    # Exposed collectives count as bubble deliberately — from the
    # compute pipeline's perspective a stall is a stall.
    "bubble_fraction",
)

# The bucketed wire's columns: the configured bucket size and the
# collectives an exchange issues (parallel/buckets.py).
BUCKET_ROW_COLUMNS = (
    "bucket_bytes",
    "n_buckets",
)

# A pipelined row's columns (:func:`pipeline_schedule_report`): the
# tick-count bubble read off the hop events, the wall-time weighted
# bubble, and whether the hop count verified the schedule.
PIPELINE_ROW_COLUMNS = (
    "pipeline_bubble_ticks",
    "pipeline_bubble_time",
    "pipeline_schedule_verified",
)

# A sharded-update row's columns (:func:`update_state_report`): per-rank
# update-state bytes, the replicated-equivalent bytes, their ratio.
USHARD_ROW_COLUMNS = (
    "update_state_bytes_per_chip",
    "update_state_bytes_replicated",
    "update_state_shrink",
)

# A compression row's columns (:func:`compress_traffic_report`): the
# modelled device-memory bytes one exchange moves through the compression
# pipeline, unfused against fused, and the decode stage's ratio.
COMPRESS_ROW_COLUMNS = (
    "compress_hbm_bytes_legacy",
    "compress_hbm_bytes_fused",
    "compress_hbm_shrink",
    "compress_decode_shrink",
)

# Chrome-trace categories of work that runs on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host API categories whose events carry the correlation id of the device
# work they launched
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

# NCCL kernel-name prefixes: collective/communication device time
COMM_OP_PREFIXES = (
    "ncclDevKernel",
    "ncclKernel",
)
# the hop class: NCCL's point-to-point kernels (send/recv)
HOP_MARKER = "SendRecv"

# the dense bf16 tensor-core peak of an NVIDIA H100 80GB HBM3 (SXM5) at
# its 700 W limit, FLOP/s
PEAK_FLOPS = 989.4e12


def op_class(name: str) -> str:
    """A device op's name → its class: its template arguments and its
    trailing argument list cut (``ncclDevKernel_AllReduce_Sum_f32_RING_LL
    (ncclDevKernelArgsStorage<4096ul>)`` → ``ncclDevKernel_AllReduce_Sum_
    f32_RING_LL``, ``Memcpy HtoD (Pinned -> Device)`` → ``Memcpy HtoD``),
    as the JAX module cuts an HLO name's ``.N``; a ``(anonymous
    namespace)`` inside the name stays."""
    out, depth = [], 0
    for ch in str(name):
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    s = "".join(out).rstrip()
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if not depth:
                s = s[:i]
                break
    return s.strip()


def is_comm_op(name: str) -> bool:
    """Whether one device op name is collective/communication time."""
    return op_class(name).startswith(COMM_OP_PREFIXES)


def is_hop_op(name: str) -> bool:
    """Whether one device op is a point-to-point hop (NCCL SendRecv)."""
    return is_comm_op(name) and HOP_MARKER in op_class(name)


def is_device_op(ev: dict) -> bool:
    """A complete event of a device category (a kernel, a copy, a set)."""
    return ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES


def _interval(ev: dict) -> Optional[Tuple[float, float]]:
    try:
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
    except (TypeError, ValueError):
        return None
    if dur < 0:
        return None
    return ts, ts + dur


def _is_anchor(ev: dict) -> bool:
    """A host dispatch-anchor span (not its mirror on the card's
    timeline)."""
    return ev.get("name") in (TRAIN_DISPATCH_SPAN, EXCHANGE_SPAN) and \
        not str(ev.get("cat", "")).startswith("gpu_") and \
        ev.get("cat") not in DEVICE_CATEGORIES


# -- trace file discovery / loading ----------------------------------------

_TRACE_GLOBS = ("*.pt.trace.json", "*.pt.trace.json.gz")


def _trace_files_in(d: str) -> List[str]:
    return sorted(p for g in _TRACE_GLOBS
                  for p in glob.glob(os.path.join(d, g)))


def find_trace_files(trace_dir: str, name: Optional[str] = None
                     ) -> List[str]:
    """The ``*.pt.trace.json[.gz]`` files of the NEWEST capture session
    under ``trace_dir``: the newest subdirectory that holds any (a
    session, :func:`capture`), or ``trace_dir`` itself when it holds them
    directly (``torch.profiler.tensorboard_trace_handler``'s layout).
    ``name`` keeps only that capture's file (``<name>.pt.trace.json
    [.gz]``: one rank's of a world's session)."""
    sessions = [d for d in glob.glob(os.path.join(trace_dir, "*"))
                if os.path.isdir(d) and _trace_files_in(d)]
    if _trace_files_in(trace_dir):
        sessions.append(trace_dir)
    if not sessions:
        return []
    newest = max(sessions, key=os.path.getmtime)
    files = _trace_files_in(newest)
    if name is not None:
        files = [p for p in files
                 if os.path.basename(p).split(".pt.trace.json")[0] == name]
    return files


def load_trace_events(path: str) -> List[dict]:
    """All trace events from one Chrome-trace file, gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    evs = data.get("traceEvents", []) if isinstance(data, dict) else data
    return [e for e in evs if isinstance(e, dict)] \
        if isinstance(evs, list) else []


# -- interval algebra -------------------------------------------------------


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge possibly-overlapping/nested (start, end) intervals."""
    if not intervals:
        return []
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _measure(union: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in union)


def _intersection_measure(a: List[Tuple[float, float]],
                          b: List[Tuple[float, float]]) -> float:
    """Total overlap between two already-merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


# -- host anchors -----------------------------------------------------------


def _launch_modules(events: List[dict]) -> Dict[Tuple, str]:
    """``(_src, correlation) → anchor name`` for every host launch event
    that an anchor span on the same host thread holds (the innermost)."""
    anchors: Dict[Tuple, List[Tuple[float, float, str]]] = {}
    launches: List[Tuple[Tuple, float, Any]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        thread = (ev.get("_src"), ev.get("pid"), ev.get("tid"))
        if _is_anchor(ev):
            iv = _interval(ev)
            if iv is not None:
                anchors.setdefault(thread, []).append(iv + (ev["name"],))
        elif ev.get("cat") in LAUNCH_CATEGORIES:
            args = ev.get("args")
            corr = args.get("correlation") if isinstance(args, dict) \
                else None
            iv = _interval(ev)
            if corr is not None and iv is not None:
                launches.append((thread, iv[0], corr))
    out: Dict[Tuple, str] = {}
    for thread, ts, corr in launches:
        best = None
        for s, e, name in anchors.get(thread, ()):
            if s <= ts <= e and (best is None or s >= best[0]):
                best = (s, name)
        if best is not None:
            out[(thread[0], corr)] = best[1]
    return out


# -- attribution ------------------------------------------------------------


def _lane(ev: dict) -> Tuple:
    """One card: the capture file and the device's pid, all its streams
    together (see the module docstring)."""
    return (ev.get("_src"), ev.get("pid"))


def attribute(events: Iterable[dict]) -> Dict[str, Any]:
    """Per-dispatch device-time breakdown from raw trace events.

    Returns a plain JSON-able dict: ``compute_secs`` / ``comm_secs`` /
    ``exposed_comm_secs`` / ``overlap_ratio`` / ``lanes`` totals, the
    per-anchor ``modules`` breakdown, the top op classes by device time,
    and the host dispatch-anchor counts (``train_dispatches`` /
    ``exchange_dispatches``)."""
    events = list(events)
    launched_by = _launch_modules(events)
    comm_iv: Dict[Tuple, List[Tuple[float, float]]] = {}
    comp_iv: Dict[Tuple, List[Tuple[float, float]]] = {}
    # module -> ("comm"|"compute") -> lane -> intervals: the per-module
    # breakdown keeps the lane split so card A's compute can't masquerade
    # as overlap for card B's collective
    per_module: Dict[str, Dict[str, Dict[Tuple, List]]] = {}
    op_totals: Dict[str, List[float]] = {}            # class -> [us, count]
    train_dispatches = 0
    exchange_dispatches = 0
    n_op_events = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if _is_anchor(ev):
            if ev["name"] == TRAIN_DISPATCH_SPAN:
                train_dispatches += 1
            else:
                exchange_dispatches += 1
            continue
        if not is_device_op(ev):
            continue                       # host op, frame or API call
        iv = _interval(ev)
        if iv is None:
            continue
        n_op_events += 1
        lane = _lane(ev)
        name = ev.get("name", "")
        cls = op_class(name)
        comm = is_comm_op(name)
        (comm_iv if comm else comp_iv).setdefault(lane, []).append(iv)
        tot = op_totals.setdefault(cls, [0.0, 0])
        tot[0] += iv[1] - iv[0]
        tot[1] += 1
        args = ev.get("args")
        corr = args.get("correlation") if isinstance(args, dict) else None
        mod = launched_by.get((ev.get("_src"), corr), "other")
        m = per_module.setdefault(mod, {"comm": {}, "compute": {}})
        m["comm" if comm else "compute"].setdefault(lane, []).append(iv)

    def _breakdown(comm_by_lane, comp_by_lane):
        comm_us = comp_us = exposed_us = 0.0
        for lane in set(comm_by_lane) | set(comp_by_lane):
            cu = _union(comm_by_lane.get(lane, []))
            pu = _union(comp_by_lane.get(lane, []))
            c = _measure(cu)
            comm_us += c
            comp_us += _measure(pu)
            exposed_us += c - _intersection_measure(cu, pu)
        return comm_us, comp_us, exposed_us

    comm_us, comp_us, exposed_us = _breakdown(comm_iv, comp_iv)
    # bubble fraction: per card, the dispatch window is its first-compute
    # start → last-compute end; everything inside it with NO compute
    # running on the card is bubble.  Span-weighted across cards; None
    # when the trace carries no compute.
    bubble_span_us = bubble_idle_us = 0.0
    for lane, ivs in comp_iv.items():
        u = _union(ivs)
        if not u:
            continue
        span = u[-1][1] - u[0][0]
        if span <= 0:
            continue
        bubble_span_us += span
        bubble_idle_us += span - _measure(u)
    bubble_fraction = round(bubble_idle_us / bubble_span_us, 4) \
        if bubble_span_us > 0 else None
    modules: Dict[str, dict] = {}
    for mod, m in per_module.items():
        mc, mp, mx = _breakdown(m["comm"], m["compute"])
        modules[mod] = {
            "comm_secs": round(mc / 1e6, 6),
            "compute_secs": round(mp / 1e6, 6),
            "exposed_comm_secs": round(mx / 1e6, 6),
        }
    top_ops = sorted(
        ({"op": cls, "secs": round(us / 1e6, 6), "count": n,
          "comm": is_comm_op(cls)}
         for cls, (us, n) in op_totals.items()),
        key=lambda r: -r["secs"])[:15]
    comm_secs = comm_us / 1e6
    exposed = exposed_us / 1e6
    return {
        "compute_secs": round(comp_us / 1e6, 6),
        "comm_secs": round(comm_secs, 6),
        "exposed_comm_secs": round(exposed, 6),
        "overlap_ratio": (round(1.0 - exposed / comm_secs, 4)
                          if comm_secs > 0 else None),
        "bubble_fraction": bubble_fraction,
        "lanes": len(set(comm_iv) | set(comp_iv)),
        # cards that carry compute: the denominator for per-card busy time
        "compute_lanes": len(comp_iv),
        "n_op_events": n_op_events,
        "train_dispatches": train_dispatches,
        "exchange_dispatches": exchange_dispatches,
        "modules": modules,
        "top_ops": top_ops,
    }


def load_dir_events(trace_dir: str, name: Optional[str] = None
                    ) -> List[dict]:
    """Raw trace events of the newest capture session under ``trace_dir``,
    merged across its per-rank files and ``_src``-tagged per file (two
    ranks' cards reuse the same small pids).  Empty when no capture is
    found; a truncated file is skipped."""
    events: List[dict] = []
    for src, p in enumerate(find_trace_files(trace_dir, name)):
        try:
            file_events = load_trace_events(p)
        except (OSError, ValueError, EOFError):
            continue          # a truncated capture file is not fatal
        for ev in file_events:
            ev["_src"] = src
        events.extend(file_events)
    return events


def profile_dir(trace_dir: str, name: Optional[str] = None
                ) -> Optional[Dict[str, Any]]:
    """Parse the newest capture session under ``trace_dir`` (``name``:
    only that capture's file) into one attribution dict.  None when no
    capture is found."""
    paths = find_trace_files(trace_dir, name)
    events = load_dir_events(trace_dir, name)
    if not events:
        return None
    prof = attribute(events)
    prof["trace_files"] = [os.path.basename(p) for p in paths]
    return prof


# -- schedule occupancy ------------------------------------------------------


def schedule_occupancy(events: Iterable[dict], min_gap_us: float = 1.0,
                       strip_width: int = 96) -> Dict[str, Any]:
    """Per-card schedule occupancy: classify each compute lane's dispatch
    window into compute / hop / other-comm / idle time, per schedule slot.

    A lane's merged compute intervals are its schedule slots, and the
    gaps between them are the schedule's bubble.  ``hop`` time is NCCL
    SendRecv device time (the stage-boundary activation shift); other
    collectives classify as ``comm``.  Each lane also gets a ``strip``:
    ``strip_width`` equal time bins over the lane span, each rendered as
    the class owning the most time in the bin (``C`` compute, ``H`` hop,
    ``c`` other comm, ``·`` idle).

    Gaps shorter than ``min_gap_us`` merge into the neighboring busy time
    (sub-microsecond runtime jitter is not schedule structure)."""
    comp_iv: Dict[Tuple, List[Tuple[float, float]]] = {}
    hop_iv: Dict[Tuple, List[Tuple[float, float]]] = {}
    comm_iv: Dict[Tuple, List[Tuple[float, float]]] = {}
    for ev in events:
        if not is_device_op(ev):
            continue
        iv = _interval(ev)
        if iv is None:
            continue
        lane = _lane(ev)
        name = ev.get("name", "")
        if is_hop_op(name):
            hop_iv.setdefault(lane, []).append(iv)
        elif is_comm_op(name):
            comm_iv.setdefault(lane, []).append(iv)
        else:
            comp_iv.setdefault(lane, []).append(iv)

    def _clip(ivs, lo, hi):
        return [(max(s, lo), min(e, hi)) for s, e in ivs
                if min(e, hi) > max(s, lo)]

    def _measure_in(ivs, lo, hi):
        return _measure(_clip(ivs, lo, hi))

    lanes = []
    for lane in sorted(comp_iv, key=str):
        cu = _union(comp_iv[lane])
        # merge sub-min_gap_us jitter between compute slots
        merged: List[Tuple[float, float]] = []
        for s, e in cu:
            if merged and s - merged[-1][1] <= min_gap_us:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        lo, hi = merged[0][0], merged[-1][1]
        span = hi - lo
        if span <= 0:
            continue
        hu = _union(hop_iv.get(lane, []))
        mu = _union(comm_iv.get(lane, []))
        comp_us = _measure(merged)
        # busy precedence compute > hop > comm: overlapped (hidden) hop
        # time is not a stall, so it must not double-count against idle
        hop_us = _measure_in(hu, lo, hi)
        comm_us = _measure_in(mu, lo, hi)
        busy = _union(_clip(merged + hu + mu, lo, hi))
        idle_us = span - _measure(busy)
        strip_chars = []
        for b in range(strip_width):
            blo = lo + span * b / strip_width
            bhi = lo + span * (b + 1) / strip_width
            shares = (("C", _measure_in(merged, blo, bhi)),
                      ("H", _measure_in(hu, blo, bhi)),
                      ("c", _measure_in(mu, blo, bhi)))
            best, best_us = "·", 0.0
            covered = 0.0
            for ch, us in shares:
                covered += us
                if us > best_us:
                    best, best_us = ch, us
            if (bhi - blo) - covered > best_us:
                best = "·"
            strip_chars.append(best)
        lanes.append({
            "lane": f"{lane[0]}:{lane[1]}",
            "span_secs": round(span / 1e6, 6),
            "compute_secs": round(comp_us / 1e6, 6),
            "hop_secs": round(hop_us / 1e6, 6),
            "comm_secs": round(comm_us / 1e6, 6),
            "idle_secs": round(idle_us / 1e6, 6),
            "bubble_fraction": round(idle_us / span, 4),
            "n_slots": len(merged),
            "strip": "".join(strip_chars),
        })
    spans = sum(l["span_secs"] for l in lanes)
    idles = sum(l["idle_secs"] for l in lanes)
    return {
        "lanes": lanes,
        "n_lanes": len(lanes),
        # span-weighted like attribute()'s bubble_fraction, but gap-merged
        # at min_gap_us — the schedule-structure view of the same metric
        "bubble_fraction": round(idles / spans, 4) if spans > 0 else None,
    }


def _schedule_busy_counts(pp: int, v: int, m: int) -> List[int]:
    """Busy-device count per pipeline tick — the ``real`` column sums of
    ``parallel.pipeline.build_schedule`` (device ``r`` is busy at tick ``t``
    iff ``0 <= t - r < v·m``), in pure python so this module stays
    stdlib-only."""
    pp, v, m = int(pp), int(v), int(m)
    total = v * m
    ticks = total + pp - 1
    return [sum(1 for r in range(pp) if 0 <= t - r < total)
            for t in range(ticks)]


def pipeline_schedule_report(events: Iterable[dict], pp: int, v: int,
                             m: int, passes: int = 2) -> Dict[str, Any]:
    """Measured pipeline-bubble report from a trace capture.

    The schedule's tick structure survives in the hop events (NCCL
    SendRecv): every tick each of the ``pp`` stages hops once, so sorted
    hop timestamps group into ticks by COUNT (exactly ``pp`` per tick,
    ``T = v·m+pp−1`` ticks per pass).  A traced train step holds a whole
    number of passes over the schedule (forward and backward); the
    per-tick idle sequence is a PALINDROME (ramp-up ``pp−1``, plateau,
    ramp-down), so every consecutive block of ``T`` groups weights
    identically whichever direction it ran.  Each group's start-to-start
    gap is that tick's measured wall time; the schedule table says how
    many stages idle that tick.  Returns:

    - ``schedule_verified``: the hop-event count divides exactly into
      whole ``T·pp`` passes.
    - ``bubble_fraction``: duration-weighted measured bubble
      ``Σ idle_frac(tick)·dur(tick) / Σ dur(tick)``.
    - ``bubble_fraction_ticks``: the analytic ``1 − v·m/T`` over the
      verified tick structure (``passes`` — expected passes per train
      step, forward + backward — only scales ``steps_detected``).
    """
    pp, v, m = int(pp), int(v), int(m)
    hops: List[Tuple[float, float]] = []
    for ev in events:
        if not is_device_op(ev) or not is_hop_op(ev.get("name", "")):
            continue
        iv = _interval(ev)
        if iv is not None:
            hops.append(iv)
    hops.sort()
    busy = _schedule_busy_counts(pp, v, m)
    ticks_pass = len(busy)
    n_groups = len(hops) // pp
    report: Dict[str, Any] = {
        "pp": pp, "v": v, "m": m, "passes": passes,
        "n_hop_events": len(hops),
        "ticks_per_pass": ticks_pass,
        "measured_ticks": n_groups,
        "schedule_verified": bool(
            hops and len(hops) % (ticks_pass * pp) == 0),
    }
    if not n_groups:
        report.update(bubble_fraction=None, bubble_fraction_ticks=None,
                      passes_detected=0, steps_detected=0)
        return report
    report["passes_detected"] = round(n_groups / ticks_pass, 3)
    report["steps_detected"] = round(n_groups / ticks_pass / passes, 3)
    idle_seq = [1.0 - b / pp for b in busy]
    starts = [hops[g * pp][0] for g in range(n_groups)]
    durs = [starts[g + 1] - starts[g] for g in range(n_groups - 1)]
    med = sorted(durs)[len(durs) // 2] if durs else 0.0
    durs.append(med)      # the capture's last tick has no successor
    wsum = dsum = 0.0
    for g, dur in enumerate(durs):
        # clip inter-pass host/dispatch gaps (a "tick" spanning a step
        # boundary) to the median so one gap can't swamp the weighting
        dur = min(dur, 10 * med) if med > 0 else dur
        wsum += idle_seq[g % ticks_pass] * dur
        dsum += dur
    report["bubble_fraction"] = round(wsum / dsum, 4) if dsum > 0 else None
    report["bubble_fraction_ticks"] = round(
        1.0 - (v * m) / ticks_pass, 4)
    return report


def format_schedule(occ: Dict[str, Any]) -> str:
    """Human-readable per-lane occupancy report."""
    lines = ["per-lane schedule occupancy "
             "(C compute · H hop · c comm · · idle):"]
    for l in occ.get("lanes", []):
        lines.append(
            f"  {l['lane']:<16} slots={l['n_slots']:<4} "
            f"span={l['span_secs'] * 1e3:8.2f}ms "
            f"compute={l['compute_secs'] * 1e3:8.2f}ms "
            f"hop={l['hop_secs'] * 1e3:7.2f}ms "
            f"idle={l['idle_secs'] * 1e3:7.2f}ms "
            f"bubble={l['bubble_fraction']:.4f}")
        lines.append(f"    |{l['strip']}|")
    bf = occ.get("bubble_fraction")
    lines.append(f"  span-weighted bubble_fraction: "
                 f"{bf if bf is not None else 'n/a'}")
    return "\n".join(lines)


# -- programmatic capture ---------------------------------------------------


class Trace:
    """One ``torch.profiler`` window whose trace lands in
    ``<trace_dir>/<session>/<name>.pt.trace.json.gz`` (``session``: the
    start time, as the JAX profiler names its sessions, unless given;
    ranks of one world pass one name, so a session holds a file a rank).
    Records the CPU, and CUDA activity when ``cuda`` (default: whether a
    card is visible).  With ``warmup`` the profiler starts in
    ``torch.profiler``'s warm-up (collecting, nothing kept) and the window
    proper begins at :meth:`record`: on an H100 with torch 2.11 the
    device records of the first work after a start are sometimes lost
    (the first batch copy of a traced AlexNet window, in 2 and 3 runs of
    4), never after a warm-up.  :meth:`stop` exports the trace and
    returns its path; the caller synchronizes the card before
    :meth:`record` and :meth:`stop`.  ``start_secs`` and ``stop_secs``
    (the stop and the export) are the host seconds each took: what the
    window adds."""

    def __init__(self, trace_dir: str, name: str = "host",
                 session: Optional[str] = None,
                 cuda: Optional[bool] = None, warmup: bool = False):
        self.trace_dir = trace_dir
        self.name = name
        self.session = session or time.strftime("%Y_%m_%d_%H_%M_%S")
        self.cuda = cuda
        self.warming = bool(warmup)
        self.path = os.path.join(trace_dir, self.session,
                                 f"{name}.pt.trace.json.gz")
        self._prof = None
        self.start_secs = self.stop_secs = None

    def start(self) -> "Trace":
        import torch
        from torch.profiler import ProfilerAction, ProfilerActivity, profile
        t0 = time.perf_counter()
        cuda = torch.cuda.is_available() if self.cuda is None else self.cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])

        def warm_then_record(step: int):
            return ProfilerAction.WARMUP if step == 0 \
                else ProfilerAction.RECORD

        self._prof = profile(activities=acts, schedule=warm_then_record
                             if self.warming else None)
        self._prof.start()
        self.start_secs = time.perf_counter() - t0
        return self

    def record(self) -> None:
        """End the warm-up: what runs from here on is kept."""
        self._prof.step()
        self.warming = False

    def stop(self) -> str:
        t0 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)
        self.stop_secs = time.perf_counter() - t0
        return self.path


class _Capture:
    """Result holder for :func:`capture` — ``.profile`` is populated when
    the context exits (None if the profiler emitted no usable trace);
    ``.record()`` ends a ``warmup`` capture's warm-up."""

    def __init__(self, trace_dir: str, trace: "Trace"):
        self.trace_dir = trace_dir
        self.profile: Optional[Dict[str, Any]] = None
        self.record = trace.record


class capture:
    """Context manager driving one programmatic profiler window::

        with devprof.capture("/tmp/trace") as cap:
            for i in range(3):
                step(i)
            torch.cuda.synchronize()         # caller drains BEFORE exit
        cap.profile["overlap_ratio"]

    The caller synchronizes before the context exits: the profiler only
    sees device work that has already run.  Attribution never raises into
    the training loop; an anonymous capture's directory is removed.
    ``warmup`` starts the window in the profiler's warm-up (:class:`Trace`)
    until the caller, after a synchronize, calls ``cap.record()``;
    ``name`` and ``session`` place the file as :class:`Trace` does (one
    session, a file a rank)."""

    def __init__(self, trace_dir: Optional[str] = None,
                 cuda: Optional[bool] = None, warmup: bool = False,
                 name: str = "host", session: Optional[str] = None):
        self._own_dir = trace_dir is None
        if trace_dir is None:
            import tempfile
            trace_dir = tempfile.mkdtemp(prefix="devprof_")
        self._trace = Trace(trace_dir, name=name, session=session, cuda=cuda,
                            warmup=warmup)
        self._cap = _Capture(trace_dir, self._trace)

    def __enter__(self) -> _Capture:
        self._trace.start()
        return self._cap

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._trace.stop()
            if exc_type is None:
                try:
                    self._cap.profile = profile_dir(self._cap.trace_dir)
                except Exception:
                    self._cap.profile = None    # attribution must never
                                                # raise into the training
                                                # loop
        finally:
            if self._own_dir:
                # anonymous capture: the caller only wants the
                # attribution, so the trace files must not accumulate
                import shutil
                shutil.rmtree(self._cap.trace_dir, ignore_errors=True)


# -- consumers --------------------------------------------------------------


def feed_telemetry(profile: Dict[str, Any], tm=None) -> None:
    """Record one attribution result into the telemetry registry: the
    :data:`DEVICE_GAUGES` gauges plus one :data:`PROFILE_EVENT` stream
    event (scalars + top 3 op classes — bounded, JSONL-friendly)."""
    if tm is None:
        from . import telemetry
        tm = telemetry.active()
    if not tm.enabled:
        return
    for gname, key in zip(DEVICE_GAUGES,
                          ("compute_secs", "comm_secs", "exposed_comm_secs",
                           "overlap_ratio", "lanes")):
        v = profile.get(key)
        if v is not None:
            tm.gauge(gname, float(v))
    tm.event(PROFILE_EVENT,
             compute_secs=profile.get("compute_secs"),
             comm_secs=profile.get("comm_secs"),
             exposed_comm_secs=profile.get("exposed_comm_secs"),
             overlap_ratio=profile.get("overlap_ratio"),
             lanes=profile.get("lanes"),
             train_dispatches=profile.get("train_dispatches"),
             top_ops=[o["op"] for o in profile.get("top_ops", [])[:3]])


def profile_row_fields(profile: Dict[str, Any],
                       total_flops: Optional[float] = None,
                       peak_flops: Optional[float] = PEAK_FLOPS
                       ) -> Dict[str, Any]:
    """The bench-row columns (:data:`TRACE_ROW_COLUMNS`, all keys always
    present).  ``device_mfu``: ``total_flops`` (per-card flops over the
    WHOLE traced window) against one lane's compute-busy time at
    ``peak_flops`` (default :data:`PEAK_FLOPS`) — None when the flops are
    unknown or the trace saw no compute."""
    lanes = profile.get("compute_lanes") or profile.get("lanes") or 0
    compute = profile.get("compute_secs") or 0.0
    mfu = None
    if total_flops and peak_flops and lanes and compute > 0:
        per_lane_secs = compute / lanes
        mfu = round(float(total_flops) / per_lane_secs / float(peak_flops), 4)
        if not math.isfinite(mfu):
            mfu = None
    return {
        "overlap_ratio": profile.get("overlap_ratio"),
        "exposed_comm_secs": profile.get("exposed_comm_secs"),
        "device_compute_secs": profile.get("compute_secs"),
        "device_comm_secs": profile.get("comm_secs"),
        "device_mfu": mfu,
        "bubble_fraction": profile.get("bubble_fraction"),
    }


def _tree_bytes(tree) -> int:
    from .helper_funcs import tree_leaves
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if hasattr(t, "element_size")))


def update_state_report(model) -> Dict[str, Any]:
    """Per-rank update-state memory (:data:`USHARD_ROW_COLUMNS`): what this
    rank holds for the optimizer state plus the exchanger's extra state,
    against the replicated layout the same session would hold.

    Measured on the live state: ``model.opt_state`` and ``model.extra`` as
    this rank holds them (ZeRO-1's flat chunk, ``update_sharding``'s
    per-leaf chunks, FSDP's chunk).  The replicated figure prices the
    unsharded optimizer (``ema_wrap`` included) initialized on meta
    tensors of the full params, plus the rule's full extra template
    (``Exchanger._extra_full_template``).  Per-rank divergent state
    (error feedback) appears on both sides, so the ratio isolates what
    sharding removes.  Under FSDP the port starts each leaf at a multiple
    of ``fsdp.ALIGN`` elements (256 bytes), so its chunk, and with it the
    per-rank bytes, may exceed the JAX package's unaligned chunk: by less
    than ``ALIGN`` elements a leaf and state tree, over the workers."""
    import torch
    from .helper_funcs import tree_map
    if model.opt_state is None:
        raise ValueError("update_state_report needs a compiled model")
    per_chip = _tree_bytes(model.opt_state) + _tree_bytes(model.extra)
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), model.params)
    exch = model.exchanger
    full_extra = exch._extra_full_template() \
        if hasattr(exch, "_extra_full_template") \
        else exch.extra_state_template()
    replicated = _tree_bytes(model._base_opt.init(meta)) \
        + _tree_bytes(full_extra)
    return {
        "update_state_bytes_per_chip": per_chip,
        "update_state_bytes_replicated": replicated,
        "update_state_shrink": (round(replicated / per_chip, 3)
                                if per_chip else None),
    }


def compress_traffic_model(strategy: str, n_elems: int, n_workers: int, *,
                           rank: int = 2, chunk: int = 8192,
                           k_c: Optional[int] = None,
                           leaf_shapes: Optional[list] = None
                           ) -> Optional[Dict[str, Any]]:
    """Analytic per-exchange device-memory traffic model for the
    compression pipelines (the JAX package's, unchanged) — pure python.

    Accounting contract: op granularity with NO fusion credit — every
    tensor-level op in the strategy's exchange reads its operands and
    writes its result to device memory, fp32 = 4 bytes/elem.  That is an
    upper bound for the unfused graph, and exact for the hand-written
    kernels (each is one pass by construction), so the legacy/fused ratio
    is the shrink guaranteed by construction, not a measured one.  Stage
    lists name every counted op so the estimate is auditable.

    Returns ``None`` for strategies with no compression pipeline.
    """
    w = int(n_workers)

    def _total(stages):
        return float(sum(b for _, b in stages))

    if strategy == "onebit":
        # pad to the pack grid, like flatten_tree(pad_to_multiple_of=...)
        n = n_elems + (-n_elems) % 32768
        fn, pk = 4.0 * n, n / 8.0          # fp32 pass / packed buffer bytes
        legacy_enc = [
            ("add c = flat + state", 3 * fn),
            ("abs(c)", 2 * fn),
            ("mean reduce -> scale", fn),
            ("where(c==0, 1, c)", 2 * fn),
            ("sign", 2 * fn),
            ("scale * sign", 2 * fn),
            ("sub -> new_state", 3 * fn),
            ("pack_signs", fn + pk),
        ]
        legacy_dec = [
            ("unpack+weighted-sum", w * pk + fn),
            ("div /size -> mean", 2 * fn),
        ]
        fused_enc = [
            ("pack_signs_encode kernel", 2 * fn + pk + fn),
            ("mean reduce -> scale", fn),
            ("signed_residual kernel", fn + pk + fn),
        ]
        fused_dec = [
            ("unpack_signs_weighted_mean kernel", w * pk + fn),
        ]
    elif strategy == "topk":
        n = n_elems + (-n_elems) % chunk
        rows = n // chunk
        k = int(k_c or max(1, round(chunk * 0.01)))
        fn = 4.0 * n
        wire = 4.0 * rows * k              # bf16 val + int16 offset per slot
        legacy_enc = [
            ("add c = flat + state", 3 * fn),
            ("abs(c)", 2 * fn),
            ("top_k select", fn + 2 * wire),
            ("take_along_axis vals", fn + wire),
            ("bf16/int16 casts + residual", 3 * wire),
            ("scatter-set residual -> new_state", 3 * fn),
        ]
        legacy_dec = [
            ("zeros dense", fn),
            ("global-index arith", 3 * w * wire),
            ("serialized HBM scatter-add", 2 * fn + w * wire),
            ("div /size -> mean", 2 * fn),
        ]
        fused_enc = [
            ("topk_encode kernel", fn + fn + 2 * wire),
        ]
        fused_dec = [
            ("topk_decode kernel (VMEM expand + /size)", w * wire + fn),
        ]
    elif strategy.startswith("powersgd"):
        r = rank
        shapes = [s for s in (leaf_shapes or [])
                  if len(s) >= 2
                  and min(math.prod(s[:-1]), int(s[-1])) > 4 * r]
        if not shapes:
            return None
        fac = 4.0 * r * sum(math.prod(s[:-1]) + int(s[-1])
                            for s in shapes)   # both factors' fp32 bytes
        mats = 4.0 * sum(math.prod(s) for s in shapes)
        legacy_enc = [
            ("Mp = M + e (per leaf)", 3 * mats),
            ("factor matmuls", 2 * (mats + fac)),
            ("per-leaf staging pack (flatten/pad/concat)", 2 * fac),
            ("per-leaf psum staging copies", 2 * fac),
        ]
        legacy_dec = [
            ("qr + Mhat decode", mats + 2 * fac),
            ("residual e' = Mp - Mhat", 3 * mats),
        ]
        fused_enc = [
            ("Mp = M + e (per leaf)", 3 * mats),
            ("matmul_pack kernels (MXU -> staging)", 2 * (mats + fac)),
            ("stacked psum staging (one buffer)", 2 * fac),
        ]
        fused_dec = legacy_dec
    else:
        return None

    legacy = _total(legacy_enc) + _total(legacy_dec)
    fused = _total(fused_enc) + _total(fused_dec)
    return {
        "strategy": strategy,
        "n_workers": w,
        "stages": {"legacy_encode": legacy_enc, "legacy_decode": legacy_dec,
                   "fused_encode": fused_enc, "fused_decode": fused_dec},
        "compress_hbm_bytes_legacy": legacy,
        "compress_hbm_bytes_fused": fused,
        "compress_hbm_shrink": round(legacy / fused, 3),
        "compress_decode_shrink": round(_total(legacy_dec)
                                        / _total(fused_dec), 3),
    }


def compress_traffic_report(model) -> Optional[Dict[str, Any]]:
    """The :data:`COMPRESS_ROW_COLUMNS` for a live model —
    :func:`compress_traffic_model` fed from the model's strategy (its
    ``chunk`` and ``k_c`` under topk, its ``rank`` under PowerSGD), its
    parameter count and its leaves' shapes in the JAX package's layout
    (PowerSGD's factors follow the layout).  ``None`` when the exchange
    strategy has no compression pipeline."""
    from .helper_funcs import _jax_shape, leaf_paths, tree_leaves
    strat = model.exchanger.strategy
    kept = frozenset(model.kept_layout_paths()) \
        if hasattr(model, "kept_layout_paths") else frozenset()
    leaf_shapes = [_jax_shape(tuple(l.shape), p, kept)
                   for p, l in zip(leaf_paths(model.params),
                                   tree_leaves(model.params))]
    n_elems = sum(math.prod(s) if s else 1 for s in leaf_shapes)
    w = int(model.size)
    kw: Dict[str, Any] = {}
    if strat.name == "topk":
        kw = {"chunk": strat.chunk, "k_c": strat._k_c()}
    elif strat.name.startswith("powersgd"):
        kw = {"rank": strat.rank, "leaf_shapes": leaf_shapes}
    m = compress_traffic_model(strat.name, n_elems, w, **kw)
    if m is None:
        return None
    return {c: m[c] for c in COMPRESS_ROW_COLUMNS}


def format_profile(profile: Dict[str, Any], top: int = 15) -> str:
    """Human-readable breakdown (the worker's verbose line)."""
    lines = [
        f"device time: compute {profile['compute_secs']:.4f}s  "
        f"comm {profile['comm_secs']:.4f}s  "
        f"exposed comm {profile['exposed_comm_secs']:.4f}s  "
        + (f"overlap {profile['overlap_ratio']:.1%}"
           if profile.get("overlap_ratio") is not None else "overlap n/a")
        + f"  ({profile['lanes']} lane(s), "
          f"{profile['n_op_events']} op events, "
          f"{profile['train_dispatches']} train dispatch(es))"]
    if profile.get("top_ops"):
        lines.append("top op classes by device time:")
        total = sum(o["secs"] for o in profile["top_ops"]) or 1.0
        for o in profile["top_ops"][:top]:
            tag = " [comm]" if o["comm"] else ""
            lines.append(f"  {o['secs'] * 1e3:9.2f} ms  "
                         f"{100 * o['secs'] / total:5.1f}%  x{o['count']:<5d} "
                         f"{o['op'][:90]}{tag}")
    return "\n".join(lines)
