"""Cross-process causal tracing: span context over the telemetry stream.

Counterpart of ``theanompi_tpu/utils/tracing.py``, a copy (stdlib plus
the port's wire framing, which statusz loads lazily).  The telemetry plane
(``utils/telemetry.py``) streams each process's phases and gauges; this
module adds the causal layer that connects a worker's exchange to the
center handler that served it:

* **Trace/span context**: a ``trace_id`` minted per exchange round, with
  one span per unit of work (``round`` on an island, ``exchange`` for an
  exchange in the step's rule, ``wire.<op>`` per RPC, ``center.<op>`` on
  the server).  The context rides the wire in the v2 request header's
  optional ``trace`` field (``parallel/wire.py``: ``{"t": trace_id, "s":
  span_id}``), so retries carry the SAME ids and the server's spans join
  the client's.
* **Span events**: every finished span is one ``span`` event in the
  per-rank telemetry JSONL (:data:`SPAN_FIELDS`).  The server splits its
  time into ``q`` (the center lock's queue wait) and ``a`` (the apply
  under the lock), returned in the reply header; a deduplicated twin is
  tagged ``dedup``.
* **Assembly**: the JAX package's ``scripts/telemetry_report.py`` joins
  client and server spans across rank files by span id into per-round
  traces with a critical path (compute | stage | wire | queue | apply).
* **statusz**: :class:`StatuszServer`, a tiny live ops endpoint on the
  wire framing: health, uptime, current span and the last events, with a
  discovery file under ``<run_dir>/statusz/``.

**Cost contract**: tracing is off unless the config enables it
(``tracing=true`` AND telemetry active).  Disabled, :func:`active`
returns the inert :data:`DISABLED` tracer whose ``enabled`` is ``False``:
every hot-path call site makes that ONE attribute check.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import telemetry

#: The span event kind in the telemetry stream (consumed by
#: scripts/telemetry_report.py's trace assembly).
SPAN_EVENT = "span"

#: Emitted once when a statusz endpoint comes up (addr + role) — the
#: report renders it as an instant marker; the discovery files
#: (:func:`statusz_dir`) name the live sockets.
STATUSZ_EVENT = "statusz"

#: Fields every span event carries beyond the telemetry envelope
#: (ts/run/rank/ev).  ``side`` ∈ client/server; ``parent`` is None for a
#: root (round) span; ``t0``/``dt`` are start epoch-seconds and duration.
SPAN_FIELDS = ("name", "side", "trace", "span", "parent", "t0", "dt")

#: The critical-path component vocabulary: every
#: second of a round is charged to exactly one of these.
COMPONENTS = ("compute", "stage", "wire", "queue", "apply")

#: Minimum field set a statusz ``health`` reply carries (probed live by
#: the schema-drift checker against a real socket round-trip).
STATUSZ_FIELDS = ("ok", "role", "id", "pid", "uptime_s", "run",
                  "spans", "current_span")

STATUSZ_OPS = ("health", "events", "flight")


def new_id(nbytes: int = 8) -> str:
    """A random hex id (16 hex chars by default) — unique across
    processes without coordination."""
    return os.urandom(int(nbytes)).hex()


def new_span_id() -> str:
    return new_id(8)


def new_trace_id() -> str:
    return new_id(8)


# -- spans --------------------------------------------------------------------

class Span:
    """One unit of traced work.  Created by :meth:`Tracer.begin` (root)
    or :meth:`child`; :meth:`end` emits the ``span`` event.  ``ctx()`` is
    the wire-header form of this span's context — a child created on the
    other side of the wire parents to THIS span."""

    __slots__ = ("_tracer", "trace", "span", "parent", "name", "t0",
                 "_fields")

    def __init__(self, tracer: "Tracer", name: str,
                 trace: Optional[str] = None, parent: Optional[str] = None,
                 **fields):
        self._tracer = tracer
        self.trace = trace or new_trace_id()
        self.span = new_span_id()
        self.parent = parent
        self.name = str(name)
        self.t0 = time.time()
        self._fields = dict(fields)

    def ctx(self) -> Dict[str, str]:
        """The wire-header trace context: ``{"t": trace_id, "s": span_id}``
        — what a request header carries so the server span can parent to
        this one."""
        return {"t": self.trace, "s": self.span}

    def child(self, name: str, **fields) -> "Span":
        return Span(self._tracer, name, trace=self.trace, parent=self.span,
                    **fields)

    def note(self, **fields) -> None:
        """Attach fields to be emitted with :meth:`end`."""
        self._fields.update(fields)

    def end(self, **fields) -> dict:
        """Finish the span: one ``span`` event into the stream."""
        self._fields.update(fields)
        return self._tracer._emit(self, time.time() - self.t0)


class Tracer:
    """Per-process span factory riding the telemetry stream.

    Thread-safe: islands (threads) share one tracer; ``current`` (the
    statusz current-span snapshot) is REPLACED atomically, never mutated
    in place, and the counters update under a lock."""

    enabled = True

    def __init__(self, telemetry_=None):
        self.telemetry = telemetry_
        self._lock = threading.Lock()
        self.spans = 0                 # spans emitted by this process
        self.current: Optional[dict] = None   # last begun, for statusz

    def _tm(self):
        return self.telemetry if self.telemetry is not None \
            else telemetry.active()

    def begin(self, name: str, trace: Optional[str] = None,
              parent: Optional[str] = None, **fields) -> Span:
        sp = Span(self, name, trace=trace, parent=parent, **fields)
        with self._lock:
            self.current = {"name": sp.name, "trace": sp.trace,
                            "span": sp.span, "t0": round(sp.t0, 3)}
        return sp

    def _emit(self, sp: Span, dt: float) -> dict:
        fields = {k: v for k, v in sp._fields.items() if v is not None}
        ev = dict(name=sp.name, side=fields.pop("side", "client"),
                  trace=sp.trace, span=sp.span, parent=sp.parent,
                  t0=round(sp.t0, 6), dt=round(dt, 6), **fields)
        tm = self._tm()
        if tm.enabled:
            tm.event(SPAN_EVENT, **ev)
        with self._lock:
            self.spans += 1
            cur = self.current
            if cur is not None and cur.get("span") == sp.span:
                self.current = None
        return ev


class _DisabledTracer:
    """The inert tracer: one attribute check is the whole hot-path cost."""

    enabled = False
    spans = 0
    current = None

    def begin(self, name, trace=None, parent=None, **fields):
        return None

    def _tm(self):
        return telemetry.DISABLED


DISABLED = _DisabledTracer()

_ACTIVE: Any = DISABLED


def active():
    """The process-wide tracer — :data:`DISABLED` until :func:`init`
    enables one.  Components (islands, exchanger) read it lazily."""
    return _ACTIVE


def init(config: Optional[dict] = None):
    """(Re)initialize process-wide tracing from a worker config.

    Enabled only when ``tracing=true`` (or a truthy string) AND the
    process telemetry is enabled — span events ride the telemetry
    stream, so a tracer without a registry would trace into the void."""
    global _ACTIVE
    config = config or {}
    t = config.get("tracing", False)
    if isinstance(t, str):
        t = t.lower() not in ("false", "0", "")
    if t and telemetry.active().enabled:
        _ACTIVE = Tracer()
    else:
        _ACTIVE = DISABLED
    return _ACTIVE


# -- one-shot emit helpers (the wire layer + center server call these) --------

def emit_wire_span(tm, trace: dict, op: str, span: Optional[str] = None,
                   t0: Optional[float] = None, dt: float = 0.0,
                   q: Optional[float] = None, a: Optional[float] = None,
                   dedup: bool = False, ok: bool = True,
                   err: Optional[str] = None, retries: int = 0) -> None:
    """One client-side ``wire.<op>`` span event — called by
    ``WireClient.request`` when the caller passed trace context.  The
    span id was minted BEFORE the request (it is the ``s`` the server's
    span parents to); all retries of the request share it, so 'retries
    share the trace id' holds by construction."""
    ev = {"name": f"wire.{op}", "side": "client",
          "trace": trace.get("t"), "span": span or new_span_id(),
          "parent": trace.get("s"),
          "t0": round(t0 if t0 is not None else time.time() - dt, 6),
          "dt": round(dt, 6), "ok": bool(ok)}
    if q is not None:
        ev["q"] = q
    if a is not None:
        ev["a"] = a
    if dedup:
        ev["dedup"] = True
    if retries:
        ev["retries"] = int(retries)
    if err:
        ev["err"] = str(err)[:160]
    tm.event(SPAN_EVENT, **ev)


def emit_server_span(tm, trace: dict, op: str, t0: float, dt: float,
                     q: Optional[float] = None, a: Optional[float] = None,
                     island=None, dedup: bool = False,
                     ok: bool = True) -> None:
    """One server-side ``center.<op>`` span event — called by the center
    handler for every request that carried trace context, parented to the
    client's ``wire.<op>`` span.  A deduplicated twin (retry or network
    duplicate of an op that already landed) is tagged ``dedup=True`` so
    the trace assembly joins the client span to the ONE applied span and
    never double-counts the twin on the critical path."""
    ev = {"name": f"center.{op}", "side": "server",
          "trace": trace.get("t"), "span": new_span_id(),
          "parent": trace.get("s"),
          "t0": round(t0, 6), "dt": round(dt, 6), "ok": bool(ok)}
    if q is not None:
        ev["q"] = q
    if a is not None:
        ev["a"] = a
    if island is not None:
        ev["island"] = island
    if dedup:
        ev["dedup"] = True
    tm.event(SPAN_EVENT, **ev)


# -- the wire framing, loaded when statusz first needs it --------------------

def _wire():
    """``parallel/wire.py`` for the statusz framing (numpy, no torch)."""
    from ..parallel import wire
    return wire


# -- statusz: the live ops endpoint -------------------------------------------

def statusz_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "statusz")


class StatuszServer:
    """A tiny live ops socket on the wire framing.

    Ops: ``health`` → the :data:`STATUSZ_FIELDS` snapshot (plus
    caller ``extra()`` fields and the iteration gauge when the process
    exports one); ``events`` → the last N telemetry flight-ring events.
    ``run_dir`` registers a discovery file under ``<run_dir>/statusz/``
    (atomic write) that :func:`read_statusz_docs` lists; it is removed
    on a clean :meth:`stop` so only live-or-crashed processes remain
    listed."""

    def __init__(self, role: str, ident: Any = 0,
                 run_dir: Optional[str] = None, telemetry_=None,
                 tracer_=None, extra: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 idle_timeout_s: float = 30.0):
        self.role = str(role)
        self.ident = ident
        self.run_dir = run_dir
        self.telemetry = telemetry_
        self.tracer = tracer_
        self.extra = extra
        self.host = host
        self.port = int(port)
        self.idle_timeout_s = float(idle_timeout_s)
        self.t0 = time.time()
        self._srv = None
        self._thread: Optional[threading.Thread] = None
        self._doc_path: Optional[str] = None

    def _tm(self):
        return self.telemetry if self.telemetry is not None \
            else telemetry.active()

    def _tr(self):
        return self.tracer if self.tracer is not None else active()

    def status(self) -> dict:
        tm = self._tm()
        tr = self._tr()
        out = {"ok": True, "role": self.role, "id": self.ident,
               "pid": os.getpid(),
               "uptime_s": round(time.time() - self.t0, 1),
               "run": getattr(tm, "run_id", None),
               "spans": getattr(tr, "spans", 0),
               "current_span": getattr(tr, "current", None)}
        it = tm.gauges.get("heartbeat.iter", tm.gauges.get("iter")) \
            if getattr(tm, "gauges", None) else None
        if it is not None:
            out["iter"] = it
        tail = tm.tail(1) if tm.enabled else []
        if tail:
            out["last_event"] = {"ev": tail[-1].get("ev"),
                                 "ts": tail[-1].get("ts")}
        if self.extra is not None:
            try:
                out.update(self.extra() or {})
            except Exception:
                pass               # a status probe must never crash serving
        return out

    def start(self) -> Tuple[str, int]:
        import socketserver
        w = _wire()
        outer = self
        idle = self.idle_timeout_s

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.settimeout(idle)
                try:
                    while True:
                        header, _ = w.recv_msg(self.request)
                        op = header.get("op")
                        if op == "health":
                            w.send_msg(self.request, outer.status())
                        elif op == "events":
                            n = int(header.get("n", 16))
                            w.send_msg(self.request,
                                       {"ok": True,
                                        "events": outer._tm().tail(n)})
                        elif op == "flight":
                            # a flight dump on demand: the
                            # what-was-this-process-doing trail
                            tm = outer._tm()
                            path = None
                            if tm.enabled:
                                path = tm.dump_flight(
                                    reason=str(header.get(
                                        "reason", "statusz flight op")))
                            w.send_msg(self.request,
                                       {"ok": True, "path": path})
                        else:
                            w.send_msg(self.request,
                                       {"ok": False,
                                        "error": f"unknown statusz op "
                                                 f"{op!r} (have "
                                                 f"{STATUSZ_OPS})"})
                except Exception:
                    return         # peer gone / idle / bad frame: drop it

        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._srv = socketserver.ThreadingTCPServer((self.host, self.port),
                                                    Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name=f"statusz-{self.role}")
        self._thread.start()
        host, port = self._srv.server_address[:2]
        if self.run_dir:
            d = statusz_dir(self.run_dir)
            try:
                os.makedirs(d, exist_ok=True)
                self._doc_path = os.path.join(
                    d, f"{self.role}_{self.ident}.json")
                tmp = f"{self._doc_path}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump({"role": self.role, "id": self.ident,
                               "pid": os.getpid(), "host": host,
                               "port": port, "ts": time.time()}, f)
                os.replace(tmp, self._doc_path)
            except OSError:
                self._doc_path = None   # discovery is best-effort
        tm = self._tm()
        if tm.enabled:
            tm.event(STATUSZ_EVENT, role=self.role, id=self.ident,
                     addr=f"{host}:{port}")
        return host, port

    def stop(self, deregister: bool = True) -> None:
        """Shut the socket down; ``deregister=False`` (a crashed/failing
        exit path) LEAVES the discovery doc behind, so the roster lists a
        process that is down — only a clean exit removes its entry (a
        SIGKILLed process never runs stop at all, same verdict)."""
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if self._thread is not None:
            # bounded join: nothing of the
            # endpoint may outlive stop() into a same-port restart
            self._thread.join(timeout=5)
            self._thread = None
        if self._doc_path is not None:
            if deregister:
                try:
                    os.remove(self._doc_path)
                except OSError:
                    pass
            self._doc_path = None


def statusz_query(addr: str, op: str = "health", n: int = 16,
                  timeout_s: float = 2.0) -> dict:
    """One statusz round-trip (``host:port``) — raises on an unreachable
    endpoint."""
    import socket
    w = _wire()
    host, port = str(addr).rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=timeout_s)
    try:
        s.settimeout(timeout_s)
        w.send_msg(s, {"op": op, "n": int(n)})
        header, _ = w.recv_msg(s)
        return header
    finally:
        s.close()


def read_statusz_docs(run_dir: str) -> List[dict]:
    """All discovery docs under ``<run_dir>/statusz/`` (sorted by role
    then id) — the roster of the run's live (or crashed) processes."""
    d = statusz_dir(run_dir)
    docs: List[dict] = []
    if not os.path.isdir(d):
        return docs
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                doc = json.load(f)
            docs.append(doc)
        except (ValueError, OSError):
            continue
    docs.sort(key=lambda x: (str(x.get("role")), str(x.get("id"))))
    return docs
