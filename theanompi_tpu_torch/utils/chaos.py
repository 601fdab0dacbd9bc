"""Chaos harness: scheduled or seeded SIGKILL, SIGSTOP, delay, corrupt
and wire faults.

Counterpart of ``theanompi_tpu/utils/chaos.py``, a copy of its logic (the
JAX module is stdlib-only).  It rehearses host loss by injecting faults
into running processes mid-run, by explicit schedule
(:func:`parse_schedule`) or reproducible seed (:func:`seeded_schedule`),
so the elastic runtime's reactions (``parallel/membership.py``) are
exercised:

* ``kill`` — SIGKILL, the preemption.  The supervisor sees the death,
  emits ``worker_leave`` and respawns with backoff (``worker_join``).
* ``stop`` — SIGSTOP for ``duration`` seconds, then SIGCONT: a wedge.
  Past the lease timeout it reads as a death although the process never
  exited.
* ``delay`` — a straggler: ``delay_hook(target, duration)`` when given,
  else a STOP/CONT pair of that duration.
* ``corrupt`` — a parameter corruption past the wire's CRC: the monkey
  drops a ``corrupt_w<target>.json`` trigger under ``corrupt_dir``, and
  the target island perturbs its own live parameters at its next
  exchange round (``parallel/async_easgd.py``).  The numerics beacon
  must then raise ``replica_divergence``
  (``fleetmon.FAULT_ALERT_COVERAGE``).  ``duration`` carries the
  perturbation's scale (0: 1e-3), not seconds.
* ``net_*`` — wire faults, applied to whole frames by the
  :class:`ChaosProxy` between the islands and the center.

Window decisions go through the clock (``utils/clock.py``), and every
fault that lands is appended to the run's :data:`REALIZED_SCHEDULE` log,
from which a run can be replayed (:func:`schedule_from_realized`).
"""

from __future__ import annotations

import json
import os
import random
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from .clock import WALL

FAULT_KINDS = ("kill", "stop", "delay", "corrupt")

# wire-level fault kinds: applied by the ChaosProxy to framed
# center traffic instead of to processes.  ``at`` opens a fault WINDOW of
# ``duration`` seconds; ``target`` matches the client id stamped in each
# frame's idempotency token (-1 = every client).
#   net_drop      — frames silently discarded (client times out, retries)
#   net_delay     — each frame stalls NET_DELAY_PER_FRAME_S before forward
#   net_dup       — each frame forwarded TWICE (the dedup-window test)
#   net_corrupt   — one body byte flipped (CRC catches it; client retries)
#   net_partition — connections cut and new ones refused for the window
NET_FAULT_KINDS = ("net_drop", "net_delay", "net_dup", "net_corrupt",
                   "net_partition")
FAULT_KINDS = FAULT_KINDS + NET_FAULT_KINDS

# per-frame stall inside a net_delay window — one knob, not per-fault
# grammar (the window length already comes from the schedule)
NET_DELAY_PER_FRAME_S = 0.25

# the injection-audit event kind (telemetry stream + Perfetto instant
# marker) — the chaos gate matches worker_leave/worker_join transitions
# against these
FAULT_EVENT = "fault_injected"

#: Filename (under a run's record_dir) of the REALIZED fault schedule:
#: one JSON line per fault that actually landed, with wall + relative
#: timestamps and the resolved target.  What a chaos run can be replayed
#: or diffed from (:func:`schedule_from_realized`) — the scheduled list
#: says what was asked for; this file says what happened.
REALIZED_SCHEDULE = "chaos_realized.jsonl"


def fault_window_active(schedule: Sequence["Fault"], kind: str, worker,
                        now: float) -> bool:
    """THE window-membership rule: is a fault window of ``kind`` covering
    ``worker`` open at ``now`` (seconds relative to the schedule's t0)?
    ``target == -1`` covers every client; ``worker=None`` (identity not
    yet known) matches only the -1 windows."""
    for f in schedule:
        if f.kind != kind or not (f.at <= now <= f.at + f.duration):
            continue
        if f.target == -1 or (worker is not None
                              and int(f.target) == int(worker)):
            return True
    return False


def append_realized(path: Optional[str], doc: dict) -> None:
    """Append one realized-fault line (crash-tolerant: a full disk or
    unwritable dir must never kill the harness)."""
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps(doc, sort_keys=True) + "\n")
    except OSError:
        pass


def schedule_from_realized(path: str) -> List["Fault"]:
    """Rebuild a replayable schedule from a realized log: each non-errored
    line becomes a :class:`Fault` at its *relative* landing time — feed it
    back to a ChaosMonkey/ChaosProxy."""
    faults: List[Fault] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if doc.get("error"):
                continue               # never landed — nothing to replay
            faults.append(Fault(str(doc["kind"]), float(doc["rel"]),
                                int(doc["target"]),
                                float(doc.get("duration", 0.0))))
    return sorted(faults, key=lambda f: f.at)


class Fault:
    """One scheduled fault: ``kind`` at ``at`` seconds (from harness start)
    against worker/rank ``target``, with ``duration`` for stop/delay."""

    __slots__ = ("kind", "at", "target", "duration", "applied", "error")

    def __init__(self, kind: str, at: float, target: int,
                 duration: float = 0.0):
        assert kind in FAULT_KINDS, \
            f"unknown fault kind {kind!r}; have {FAULT_KINDS}"
        self.kind = kind
        self.at = float(at)
        self.target = int(target)
        self.duration = float(duration)
        self.applied = False
        self.error: Optional[str] = None

    def __repr__(self):
        dur = f":{self.duration:g}s" if self.duration else ""
        return f"{self.kind}@{self.at:g}:w{self.target}{dur}"


def parse_schedule(spec: str) -> List[Fault]:
    """``"kill@8:1,stop@12:2:3.5,delay@15:0:0.5"`` →
    [Fault(kill, t=8, target=1), Fault(stop, t=12, target=2, 3.5s), ...].
    Grammar per entry: ``<kind>@<seconds>:<target>[:<duration>]``."""
    faults: List[Fault] = []
    for entry in str(spec).split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            kind, _, rest = entry.partition("@")
            parts = rest.split(":")
            at, target = float(parts[0]), int(parts[1])
            duration = float(parts[2]) if len(parts) > 2 else 0.0
        except (ValueError, IndexError):
            raise ValueError(
                f"bad fault entry {entry!r}: want "
                f"<kind>@<seconds>:<target>[:<duration>]") from None
        faults.append(Fault(kind, at, target, duration))
    return sorted(faults, key=lambda f: f.at)


def seeded_schedule(seed: int, targets: Sequence[int], n_faults: int = 2,
                    t_min: float = 5.0, t_max: float = 30.0,
                    kinds: Sequence[str] = ("kill",),
                    duration: float = 2.0) -> List[Fault]:
    """A reproducible random schedule: ``n_faults`` draws of (kind, time ∈
    [t_min, t_max], target ∈ targets) from one seed — the chaos gate's
    'random non-zero ranks mid-epoch' with replayable failures."""
    rng = random.Random(int(seed))
    targets = list(targets)
    assert targets, "seeded_schedule needs at least one target"
    faults = [Fault(rng.choice(list(kinds)),
                    rng.uniform(t_min, t_max),
                    rng.choice(targets),
                    duration)
              for _ in range(int(n_faults))]
    return sorted(faults, key=lambda f: f.at)


class ChaosMonkey(threading.Thread):
    """Apply a fault schedule against live workers from a daemon thread.

    ``pid_of(target) -> pid|None`` resolves the CURRENT pid (elastic
    workers change pids across respawns; None while a target is between
    lives — the fault is retried for ``grace_s`` then dropped with
    ``error='no-pid'``).  ``delay_hook(target, duration)`` services
    ``delay`` faults for in-process targets (an island thread has no pid
    of its own).  Each applied fault emits one :data:`FAULT_EVENT`
    telemetry event — the audit trail the chaos gate matches
    ``worker_leave``/``worker_join`` transitions against."""

    def __init__(self, schedule: Sequence[Fault],
                 pid_of: Optional[Callable[[int], Optional[int]]] = None,
                 delay_hook: Optional[Callable[[int, float], None]] = None,
                 telemetry_=None, poll_s: float = 0.05,
                 grace_s: float = 10.0, t0: Optional[float] = None,
                 clock=None, realized_path: Optional[str] = None,
                 corrupt_dir: Optional[str] = None):
        super().__init__(daemon=True, name="chaos-monkey")
        # net_* faults are the ChaosProxy's job — a pid-targeted monkey
        # given a mixed schedule must not SIGSTOP a process because a
        # PARTITION was asked for
        self.schedule = sorted((f for f in schedule
                                if f.kind not in NET_FAULT_KINDS),
                               key=lambda f: f.at)
        self.pid_of = pid_of
        self.delay_hook = delay_hook
        self.telemetry = telemetry_
        self.poll_s = float(poll_s)
        self.grace_s = float(grace_s)
        self.clock = clock or WALL
        self.t0 = self.clock.now() if t0 is None else float(t0)
        self.realized_path = realized_path
        self.corrupt_dir = corrupt_dir
        self._halt = threading.Event()
        self.applied: List[Fault] = []

    # -- application --------------------------------------------------------

    def _signal(self, pid: int, sig) -> None:
        os.kill(int(pid), sig)

    def _emit(self, fault: Fault, pid: Optional[int]) -> None:
        self.applied.append(fault)
        now = self.clock.now()
        append_realized(self.realized_path, {
            "ts": round(now, 3), "rel": round(now - self.t0, 3),
            "kind": fault.kind, "target": fault.target,
            "duration": fault.duration, "pid": pid,
            "error": fault.error, "source": "monkey"})
        tm = self.telemetry
        if tm is not None and getattr(tm, "enabled", False):
            tm.event(FAULT_EVENT, kind=fault.kind, worker=fault.target,
                     pid=pid, at=round(fault.at, 2),
                     duration=fault.duration)
        print(f"chaos: injected {fault!r} (pid {pid})",
              file=sys.stderr, flush=True)

    def _apply(self, fault: Fault) -> bool:
        """True when the fault landed (or permanently failed)."""
        if fault.kind == "delay" and self.delay_hook is not None:
            self.delay_hook(fault.target, fault.duration)
            fault.applied = True
            self._emit(fault, None)
            return True
        if fault.kind == "corrupt":
            # no pid involved: the trigger file is consumed by the target
            # worker itself at its next exchange round (async_easgd polls
            # its chaos_dir) — corruption from the inside, past every CRC
            if not self.corrupt_dir:
                fault.error = "no-corrupt-dir"
                fault.applied = True
                self._emit(fault, None)
                return True
            scale = fault.duration if fault.duration > 0 else 1e-3
            path = os.path.join(self.corrupt_dir,
                                f"corrupt_w{fault.target}.json")
            try:
                os.makedirs(self.corrupt_dir, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump({"target": fault.target, "scale": scale}, f)
                os.replace(tmp, path)
            except OSError as e:
                fault.error = repr(e)
            fault.applied = True
            self._emit(fault, None)
            return True
        pid = self.pid_of(fault.target) if self.pid_of else None
        if pid is None:
            if self.clock.now() - self.t0 - fault.at > self.grace_s:
                fault.error = "no-pid"
                fault.applied = True      # dropped, but resolved
                now = self.clock.now()    # the realized log records the
                append_realized(self.realized_path, {   # drop too — a
                    "ts": round(now, 3),  # diff must see asked-but-missed
                    "rel": round(now - self.t0, 3), "kind": fault.kind,
                    "target": fault.target, "duration": fault.duration,
                    "pid": None, "error": "no-pid", "source": "monkey"})
                return True
            return False                  # target between lives — retry
        try:
            if fault.kind == "kill":
                self._signal(pid, signal.SIGKILL)
            else:                         # stop / pid-targeted delay
                self._signal(pid, signal.SIGSTOP)

                def _cont(p=pid):
                    try:
                        self._signal(p, signal.SIGCONT)
                    except (ProcessLookupError, OSError):
                        pass              # supervisor killed it meanwhile
                t = threading.Timer(max(fault.duration, 0.01), _cont)
                t.daemon = True
                t.start()
        except (ProcessLookupError, OSError) as e:
            fault.error = repr(e)
        fault.applied = True
        self._emit(fault, pid)
        return True

    # -- thread loop --------------------------------------------------------

    def run(self) -> None:
        pending = list(self.schedule)
        while pending and not self._halt.is_set():
            now = self.clock.now() - self.t0
            still: List[Fault] = []
            for f in pending:
                if f.at <= now:
                    if not self._apply(f):
                        still.append(f)
                else:
                    still.append(f)
            pending = still
            self._halt.wait(self.poll_s)

    def stop(self, join_timeout: float = 5.0) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=join_timeout)


# -- wire-level chaos: the faulting proxy ------------------------------------

def _recvn(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        c = sock.recv(min(n - got, 1 << 20))
        if not c:
            raise ConnectionError(f"closed ({got}/{n})")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def _read_frame(sock):
    """One wire frame (parallel/wire.py framing: ``[4B hlen][4B header
    CRC][header JSON][4B blen][body]``) as ``(prefix_bytes, header_dict,
    body_bytes)`` — the proxy reassembles whole frames so faults hit
    MESSAGES, not arbitrary byte runs (a half-forwarded frame would just
    wedge both ends instead of exercising the retry/dedup machinery)."""
    import json as _json
    import struct as _struct
    hl = _recvn(sock, 4)
    (hlen,) = _struct.unpack("!I", hl)
    hcrc = _recvn(sock, 4)
    hb = _recvn(sock, hlen)
    bl = _recvn(sock, 4)
    (blen,) = _struct.unpack("!I", bl)
    body = _recvn(sock, blen) if blen else b""
    try:
        header = _json.loads(hb)
    except ValueError:
        header = {}
    return hl + hcrc + hb + bl, header, body


class ChaosProxy:
    """A faulting TCP proxy between wire clients and the center server.

    Sits on its own port; every client connection gets a paired upstream
    connection and two pump threads.  Client→server frames are read
    WHOLE and, while a scheduled fault window is active, dropped,
    delayed, duplicated (the extra reply is swallowed on the way back so
    the client's request/reply stream stays aligned — the DUPLICATE
    hits the server's dedup window, which is the point), or corrupted
    (one body byte flipped; the CRC catches it server-side).
    ``net_partition`` cuts matching connections and refuses new ones for
    the window.  Fault targets match the client id in each frame's
    idempotency token (``tok.w``; -1 = all).  Every window that opens
    emits one :data:`FAULT_EVENT` audit event.

    Stdlib-only like the rest of this module; schedules come from
    :func:`parse_schedule` / :func:`seeded_schedule` with the
    :data:`NET_FAULT_KINDS` kinds."""

    def __init__(self, upstream_addr: str, schedule: Sequence[Fault] = (),
                 listen_host: str = "127.0.0.1", listen_port: int = 0,
                 telemetry_=None, t0: Optional[float] = None,
                 poll_s: float = 0.05, clock=None,
                 realized_path: Optional[str] = None):
        import socket as _socket
        host, port = str(upstream_addr).rsplit(":", 1)
        self.upstream = (host, int(port))
        self.schedule = sorted((f for f in schedule
                                if f.kind in NET_FAULT_KINDS),
                               key=lambda f: f.at)
        self.listen_host = listen_host
        self.listen_port = int(listen_port)
        self.telemetry = telemetry_
        self.clock = clock or WALL
        self.t0 = self.clock.now() if t0 is None else float(t0)
        self.realized_path = realized_path
        self.poll_s = float(poll_s)
        self._socket = _socket
        self._halt = threading.Event()
        self._lock = threading.Lock()
        self._conns: list = []          # [{c, u, worker, pattern}]
        self._lsock = None
        self._threads: list = []
        self.applied: List[Fault] = []
        self.frames_faulted: Dict[str, int] = {}

    # -- schedule -----------------------------------------------------------

    def _active(self, kind: str, worker) -> bool:
        return fault_window_active(self.schedule, kind, worker,
                                   self.clock.now() - self.t0)

    def _emit(self, fault: Fault) -> None:
        fault.applied = True
        with self._lock:
            self.applied.append(fault)
        now = self.clock.now()
        append_realized(self.realized_path, {
            "ts": round(now, 3), "rel": round(now - self.t0, 3),
            "kind": fault.kind, "target": fault.target,
            "duration": fault.duration, "pid": None,
            "error": None, "source": "proxy"})
        tm = self.telemetry
        if tm is not None and getattr(tm, "enabled", False):
            tm.event(FAULT_EVENT, kind=fault.kind, worker=fault.target,
                     at=round(fault.at, 2), duration=fault.duration)
        print(f"chaos-proxy: window open {fault!r}",
              file=sys.stderr, flush=True)

    def _count(self, kind: str) -> None:
        with self._lock:
            self.frames_faulted[kind] = self.frames_faulted.get(kind, 0) + 1

    # -- pumps --------------------------------------------------------------

    def _pump_c2s(self, st) -> None:
        try:
            while not self._halt.is_set():
                prefix, header, body = _read_frame(st["c"])
                tok = header.get("tok") or {}
                w = tok.get("w")
                if w is not None:
                    # 'w3' (island clients) or a bare int — match on digits
                    ws = str(w)
                    st["worker"] = int(ws[1:]) if ws[:1] == "w" and \
                        ws[1:].isdigit() else (int(ws) if
                                               ws.lstrip("-").isdigit()
                                               else None)
                if self._active("net_partition", st["worker"]):
                    self._count("net_partition")
                    break                       # cut the connection
                if self._active("net_drop", st["worker"]):
                    self._count("net_drop")
                    continue                    # frame evaporates
                if self._active("net_delay", st["worker"]):
                    self._count("net_delay")
                    time.sleep(NET_DELAY_PER_FRAME_S)
                if self._active("net_corrupt", st["worker"]) and body:
                    self._count("net_corrupt")
                    bb = bytearray(body)
                    bb[len(bb) // 2] ^= 0xFF    # CRC will catch it
                    body = bytes(bb)
                dup = self._active("net_dup", st["worker"])
                with st["wlock"]:
                    st["pattern"].append(0)     # forward this reply
                    st["u"].sendall(prefix + body)
                    if dup:
                        self._count("net_dup")
                        st["pattern"].append(1)  # swallow the dup's reply
                        st["u"].sendall(prefix + body)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._close_pair(st)

    def _pump_s2c(self, st) -> None:
        try:
            while not self._halt.is_set():
                prefix, header, body = _read_frame(st["u"])
                with st["wlock"]:
                    swallow = st["pattern"].popleft() \
                        if st["pattern"] else 0
                if swallow:
                    continue        # the duplicate's reply — client never
                                    # sent that frame twice, so it must
                                    # never see two replies
                if self._active("net_partition", st["worker"]):
                    self._count("net_partition")
                    break
                st["c"].sendall(prefix + body)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._close_pair(st)

    def _close_pair(self, st) -> None:
        for k in ("c", "u"):
            try:
                st[k].close()
            except OSError:
                pass
        with self._lock:
            if st in self._conns:
                self._conns.remove(st)

    # -- accept / monitor loops ---------------------------------------------

    def _accept_loop(self) -> None:
        from collections import deque
        while not self._halt.is_set():
            try:
                c, _ = self._lsock.accept()
            except OSError:
                return
            if self._active("net_partition", None):
                # a global (target −1) partition refuses NEW connections
                # too; a worker-targeted one can't match here — the peer's
                # identity is unknown until its first frame
                self._count("net_partition")
                try:
                    c.close()
                except OSError:
                    pass
                continue
            try:
                u = self._socket.create_connection(self.upstream,
                                                   timeout=5.0)
            except OSError:
                try:
                    c.close()       # center down: the outage passes through
                except OSError:
                    pass
                continue
            st = {"c": c, "u": u, "worker": None, "pattern": deque(),
                  "wlock": threading.Lock()}
            with self._lock:
                self._conns.append(st)
            # pump threads are NOT retained: a chaos run's retry storms
            # open thousands of short-lived pairs, and nothing joins them
            # (stop() severs their sockets via _conns instead)
            for fn in (self._pump_c2s, self._pump_s2c):
                threading.Thread(target=fn, args=(st,), daemon=True).start()

    def _monitor_loop(self) -> None:
        pending = [f for f in self.schedule if not f.applied]
        while pending and not self._halt.is_set():
            now = self.clock.now() - self.t0
            still = []
            for f in pending:
                if f.at <= now:
                    self._emit(f)
                    if f.kind == "net_partition":
                        # cut EXISTING matching connections at window open
                        with self._lock:
                            conns = list(self._conns)
                        for st in conns:
                            if f.target == -1 or \
                                    st["worker"] == f.target:
                                self._close_pair(st)
                else:
                    still.append(f)
            pending = still
            self._halt.wait(self.poll_s)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> str:
        """Bind + serve; returns the ``host:port`` clients should dial."""
        self._lsock = self._socket.socket()
        self._lsock.setsockopt(self._socket.SOL_SOCKET,
                               self._socket.SO_REUSEADDR, 1)
        self._lsock.bind((self.listen_host, self.listen_port))
        self._lsock.listen(64)
        addr = self._lsock.getsockname()
        for fn in (self._accept_loop, self._monitor_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return f"{addr[0]}:{addr[1]}"

    def stop(self) -> None:
        self._halt.set()
        if self._lsock is not None:
            # shutdown BEFORE close: on Linux a bare close() of a
            # listening socket does not reliably wake a thread blocked
            # in accept() — shutdown makes it raise immediately, which
            # the bounded join below depends on
            try:
                self._lsock.shutdown(self._socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for st in conns:
            self._close_pair(st)
        # bounded join of the accept/monitor threads: the closed listen
        # socket unblocks accept() and the halt event ends the monitor
        # within poll_s, but without a join they can outlive stop() into
        # the caller's teardown (audit reads, a same-port proxy restart)
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []


def find_child_pid(parent_pid: int, needle: str,
                   timeout_s: float = 60.0) -> Optional[int]:
    """Scan ``/proc`` for a child of ``parent_pid`` whose command line
    contains ``needle`` — how the chaos harness targets a rank under
    ``launcher --supervise`` without the launcher's cooperation (the
    needle names the port's module, e.g. ``theanompi_tpu_torch.worker``
    or ``theanompi_tpu_torch.parallel.membership``)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().split()[3])
                if ppid != int(parent_pid):
                    continue
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(
                        errors="replace")
                if needle in cmd:
                    return int(entry)
            except (OSError, ValueError, IndexError):
                continue
        time.sleep(0.05)
    return None


def wait_for_file(path: str, timeout_s: float = 60.0,
                  predicate: Optional[Callable[[str], bool]] = None) -> bool:
    """Poll until ``path`` exists (and ``predicate(contents)`` holds, when
    given) — the mid-epoch synchronization chaos tests key faults off
    (e.g. 'first checkpoint committed')."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if os.path.exists(path):
            if predicate is None:
                return True
            try:
                with open(path) as f:
                    if predicate(f.read()):
                        return True
            except OSError:
                pass
        time.sleep(0.05)
    return False
