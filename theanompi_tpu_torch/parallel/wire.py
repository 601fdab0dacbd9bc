"""The center server's RPC wire, byte for byte the JAX package's.

Counterpart of ``theanompi_tpu/parallel/wire.py``: a center served by
either package takes requests from a client of either package, so every
byte on the wire is the same:

* **Framing** — ``[4B header len][4B header CRC32][JSON header][4B body
  len][body]``, big-endian lengths.  The header carries the protocol
  version ``v`` (:data:`WIRE_VERSION`, 2) and, with a body, the body's
  CRC32 (``crc``).  A version mismatch fails loudly with both versions
  in the message; a body CRC mismatch is :class:`CorruptPayload`
  (retryable: the bytes, not the op, are bad); a header CRC mismatch or
  an absurd length is :class:`FramingError` (the stream is desynced:
  drop the connection).
* **Bodies** — a list of float32 arrays as an ``.npz`` keyed ``leaf0``,
  ``leaf1``, … in the JAX package's flatten order (:func:`pack_leaves`);
  no pickle.
* **Close taxonomy** — a close between messages is
  :class:`ConnectionClosed`, a close mid-message :class:`TruncatedMessage`.
* **Idempotency tokens** — every request carries ``tok = {w: <client>,
  seq: <n>}``; the server's :class:`DedupWindow` applies a retried
  ``push`` / ``push_pull`` exactly once.
* **:class:`WireClient`** — a persistent connection with per-op socket
  timeouts, bounded exponential-backoff retries (``membership.Backoff``)
  and transparent reconnect.

Version 2's optional header fields: a request MAY carry ``trace``
(``{"t": trace_id, "s": span_id}``, the causal-tracing context): the
client stamps it when its caller passes a span's context, and the server
parents its ``center.<op>`` span to it; a reply MAY carry ``srv = {"q":
queue_s, "a": apply_s}``, the server's time split, which the port's
server stamps and its client keeps (``WireClient.last_srv``).  With
telemetry on (``utils/telemetry.py``) the client feeds the JAX package's
``wire.retry`` / ``wire.timeout`` / ``wire.corrupt`` / ``wire.reconnect``
/ ``wire.giveup`` counters, the ``wire.rtt``, ``wire.server_queue`` and
``wire.server_apply`` histograms, the ``wire.outage_s`` gauge and the
``wire`` events; :attr:`WireClient.counters` counts the same five names
whether telemetry is on or not.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import telemetry, tracing
from ..utils.clock import WALL

#: Protocol version stamped into every header; both ends refuse a
#: mismatch loudly.
WIRE_VERSION = 2

#: What the client counts (the JAX package's telemetry counter names,
#: without the ``wire.`` prefix).
WIRE_COUNTERS = ("retry", "timeout", "corrupt", "reconnect", "giveup")

#: Histograms: a request's round trip on success, and the server's split
#: of it from the reply's ``srv`` field (queue wait at the center's lock,
#: apply under it).
WIRE_HISTS = ("wire.rtt", "wire.server_queue", "wire.server_apply")
#: Gauges: the seconds the last outage lasted, set when a connection
#: heals (the report draws it as a counter track).
WIRE_GAUGES = ("wire.outage_s",)

#: The wire's telemetry event kind (an outage's end, a give-up).
WIRE_EVENT = "wire"

# sanity bounds: a corrupted length prefix must not allocate the universe
# (the body bound sits below a u32's range, so it can trigger)
_MAX_HEADER = 16 << 20
_MAX_BODY = 2 << 30


# -- errors ------------------------------------------------------------------

class WireError(ConnectionError):
    """Base for transport-level wire failures (all retryable)."""


class ConnectionClosed(WireError):
    """Clean close at a frame boundary: nothing in flight was lost."""


class TruncatedMessage(WireError):
    """The peer vanished mid-message: the frame being read is lost."""


class CorruptPayload(WireError):
    """Body bytes failed their CRC32: the wire, not the op, is bad."""


class VersionMismatch(RuntimeError):
    """Peer speaks another wire protocol version.  Not retryable."""


class WireGiveUp(ConnectionError):
    """Retries or the deadline exhausted; carries what was tried and the
    last underlying error."""


class RemoteOpError(RuntimeError):
    """The server ran the request and replied with an op-level failure
    (leaf-count mismatch, unknown op).  Not retryable."""


class CenterUninitialized(RemoteOpError):
    """The center has no params yet (a respawn with no usable snapshot).
    Recoverable: the caller re-seeds through ``ensure_init_leaves``."""


class FramingError(WireError):
    """A length prefix or the header failed its check: the stream is
    desynced and the connection cannot be reused."""


#: Cached-reply sentinel for a token whose original request is still being
#: applied on another handler thread: the twin gets a retryable busy
#: reply, never an ack.
INFLIGHT = object()


# -- framing -----------------------------------------------------------------

def encode_frame(header: dict, body: bytes = b"") -> bytes:
    """The exact bytes of one frame of ``header`` as given (no version
    stamped), so tests and probes can craft mismatched or raw frames."""
    hb = json.dumps(header).encode()
    return (struct.pack("!I", len(hb))
            + struct.pack("!I", zlib.crc32(hb) & 0xFFFFFFFF) + hb
            + struct.pack("!I", len(body)) + body)


def send_msg(sock: socket.socket, header: dict, body: bytes = b"") -> None:
    """One framed message: the header stamped with the version and, with a
    body, the body's CRC32."""
    h = dict(header)
    h["v"] = WIRE_VERSION
    if body:
        h["crc"] = zlib.crc32(body) & 0xFFFFFFFF
    sock.sendall(encode_frame(h, body))


def recv_exact(sock: socket.socket, n: int, *,
               at_boundary: bool = False) -> bytes:
    """Exactly ``n`` bytes.  A close before the first byte of a message
    (``at_boundary``) raises :class:`ConnectionClosed`, anywhere else
    :class:`TruncatedMessage`."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        c = sock.recv(min(n - got, 1 << 20))
        if not c:
            if at_boundary and got == 0:
                raise ConnectionClosed(
                    "peer closed the connection at a message boundary")
            raise TruncatedMessage(
                f"connection closed mid-message ({got}/{n} bytes read)")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def recv_msg(sock: socket.socket,
             check_version: bool = True) -> Tuple[dict, bytes]:
    """One framed message: the header CRC first (:class:`FramingError`),
    then the version (:class:`VersionMismatch`, both versions named), then
    the body CRC (:class:`CorruptPayload`)."""
    (hlen,) = struct.unpack("!I", recv_exact(sock, 4, at_boundary=True))
    if hlen > _MAX_HEADER:
        raise FramingError(f"header length {hlen} exceeds bound "
                           f"{_MAX_HEADER} — corrupted length prefix, "
                           f"stream desynced: drop the connection")
    (hcrc,) = struct.unpack("!I", recv_exact(sock, 4))
    hb = recv_exact(sock, hlen)
    if (zlib.crc32(hb) & 0xFFFFFFFF) != hcrc:
        raise FramingError(
            f"header CRC mismatch ({hlen} bytes): header or length "
            f"prefix corrupted — stream integrity unknown, drop the "
            f"connection")
    try:
        header = json.loads(hb)
    except ValueError:
        raise FramingError("header passed its CRC but is not JSON — "
                           "peer speaks a different framing; drop the "
                           "connection") from None
    (blen,) = struct.unpack("!I", recv_exact(sock, 4))
    if blen > _MAX_BODY:
        raise FramingError(f"body length {blen} exceeds bound "
                           f"{_MAX_BODY} — corrupted length prefix, "
                           f"stream desynced: drop the connection")
    body = recv_exact(sock, blen) if blen else b""
    if check_version:
        got = header.get("v")
        if got != WIRE_VERSION:
            raise VersionMismatch(
                f"wire protocol version mismatch: peer speaks "
                f"v{got!r}, this end speaks v{WIRE_VERSION} — both ends "
                f"must run the same release")
    crc = header.get("crc")
    if body and crc is not None and (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise CorruptPayload(
            f"payload CRC mismatch ({len(body)} bytes): body corrupted "
            f"in flight")
    return header, body


# -- leaf packing ------------------------------------------------------------

def pack_leaves(leaves) -> bytes:
    """Flat leaf list → npz bytes keyed by flatten order (float32, no
    pickle)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf{i}": np.asarray(x, np.float32)
                     for i, x in enumerate(leaves)})
    return buf.getvalue()


def unpack_leaves(body: bytes) -> List[np.ndarray]:
    if not body:
        return []
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return [z[f"leaf{i}"] for i in range(len(z.files))]


# -- server-side dedup window ------------------------------------------------

class DedupWindow:
    """Exactly-once application for retried mutating ops.

    Remembers the last ``depth`` applied ``(client, op, seq)`` tokens per
    client with the reply that was sent, so a retry of a request that
    already landed is answered from the cache instead of applied again.
    Per-client ``seq`` high-water marks survive eviction and snapshots: a
    replayed token at or below the mark is recognized after a center
    restart too (the server then synthesizes a reply; the op is NOT
    reapplied)."""

    def __init__(self, depth: int = 128, telemetry_=None):
        self.depth = int(depth)
        # the registry its hits count into (default: the process's)
        self.telemetry = telemetry_
        self._lock = threading.Lock()
        # client -> OrderedDict[(op, seq) -> (header, body) | None]
        self._seen: Dict[str, OrderedDict] = {}
        self.seq_hwm: Dict[str, int] = {}
        self.hits = 0

    def check(self, token: Optional[dict], op: str) -> Tuple[bool, Any]:
        """``(is_duplicate, cached_reply)`` for a request's token.  A
        tokenless request is never a duplicate.  For a duplicate,
        ``cached_reply`` is the recorded ``(header, body | None)``, plain
        ``None`` for an applied request outside the cached window, or
        :data:`INFLIGHT` while the original is still being applied.  A
        fresh token is claimed atomically before returning;
        :meth:`release` withdraws the claim when the op fails."""
        if not token:
            return False, None
        w, seq = str(token.get("w")), int(token.get("seq", -1))
        with self._lock:
            window = self._seen.get(w)
            if window is not None and (op, seq) in window:
                self.hits += 1
                entry = window[(op, seq)]
                hit = INFLIGHT if entry is None else entry
            elif seq <= self.seq_hwm.get(w, -1):
                # an old retry (or a post-restart replay) of a request that
                # landed: the mark only advances in record(), so applied
                self.hits += 1
                hit = None
            else:
                if window is None:
                    window = self._seen[w] = OrderedDict()
                window[(op, seq)] = None        # claim
                while len(window) > self.depth:
                    window.popitem(last=False)
                return False, None
        tm = self.telemetry if self.telemetry is not None \
            else telemetry.active()
        if tm.enabled:
            tm.counter("wire.dedup_hit")
        return True, hit

    def record(self, token: Optional[dict], op: str,
               reply_header: dict, reply_body: Optional[bytes] = b"",
               max_cached_body: int = 1 << 20) -> None:
        """Remember an applied request's reply (bounded per client);
        ``reply_body=None`` (a model-sized reply) is not cached, and a
        replay gets a synthesized body."""
        if not token:
            return
        w, seq = str(token.get("w")), int(token.get("seq", -1))
        cached = (dict(reply_header),
                  bytes(reply_body) if reply_body is not None
                  and len(reply_body) <= max_cached_body else None)
        with self._lock:
            window = self._seen.setdefault(w, OrderedDict())
            window[(op, seq)] = cached
            while len(window) > self.depth:
                window.popitem(last=False)
            if seq > self.seq_hwm.get(w, -1):
                self.seq_hwm[w] = seq

    def release(self, token: Optional[dict], op: str) -> None:
        """Withdraw a :meth:`check` claim after the op failed."""
        if not token:
            return
        w, seq = str(token.get("w")), int(token.get("seq", -1))
        with self._lock:
            window = self._seen.get(w)
            if window is not None and (op, seq) in window \
                    and window[(op, seq)] is None:
                del window[(op, seq)]

    def hwm_snapshot(self) -> Dict[str, int]:
        """A locked copy of the per-client high-water marks: the one way
        other threads may read them."""
        with self._lock:
            return dict(self.seq_hwm)

    def snapshot(self) -> dict:
        """Applied tokens and marks only: no reply bodies, and no in-flight
        claims (a crash mid-apply must not dedup the retry of an op that
        never landed)."""
        with self._lock:
            return {"hwm": dict(self.seq_hwm),
                    "tokens": {w: [[op, seq] for (op, seq), v
                                   in window.items() if v is not None]
                               for w, window in self._seen.items()},
                    "hits": self.hits}

    def restore(self, snap: dict) -> None:
        with self._lock:
            self.seq_hwm = {str(w): int(s)
                            for w, s in (snap.get("hwm") or {}).items()}
            self._seen = {}
            for w, toks in (snap.get("tokens") or {}).items():
                window = self._seen[str(w)] = OrderedDict()
                for op, seq in toks:
                    window[(str(op), int(seq))] = \
                        ({"ok": True, "dedup": True}, None)
            self.hits = int(snap.get("hits", 0))


# -- client ------------------------------------------------------------------

class WireClient:
    """Persistent framed connection with per-op timeouts, bounded
    exponential-backoff retries, transparent reconnect and idempotency
    tokens.

    ``client_id`` keys the server's dedup window (the island id);
    ``op_timeout_s`` bounds each send + receive; a failed attempt
    reconnects and retries up to ``max_retries`` times within
    ``deadline_s``, then raises :class:`WireGiveUp`.  Thread-safe: one
    lock serializes this process's callers."""

    def __init__(self, addr: str, client_id: Any = None, *,
                 op_timeout_s: float = 20.0, connect_timeout_s: float = 5.0,
                 max_retries: int = 8, deadline_s: float = 120.0,
                 backoff=None, clock=None, telemetry_=None):
        host, port = str(addr).rsplit(":", 1)
        self.addr = (host, int(port))
        self.clock = clock or WALL
        self.client_id = str(client_id) if client_id is not None else \
            f"c{id(self) & 0xFFFFFF:x}"
        self.op_timeout_s = float(op_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_retries = int(max_retries)
        self.deadline_s = float(deadline_s)
        if backoff is None:
            from .membership import Backoff
            backoff = Backoff(base=0.2, factor=2.0, cap=5.0)
        self.backoff = backoff
        self.telemetry = telemetry_
        self.counters: Dict[str, int] = {k: 0 for k in WIRE_COUNTERS}
        #: the last successful reply's ``srv`` time split (None if absent)
        self.last_srv: Optional[dict] = None
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        # seq starts at wall-clock milliseconds, not 0: a respawned island
        # reuses its client id, and the server's high-water mark survives
        # eviction and center restarts — a fresh incarnation counting from
        # 0 would have every push deduped as an old retry
        self._seq = int(self.clock.now() * 1000)
        self._outage_t0: Optional[float] = None
        self._last_attempts = 1       # attempts of the last request

    def _tm(self):
        return self.telemetry if self.telemetry is not None \
            else telemetry.active()

    def _connect(self) -> socket.socket:
        s = socket.create_connection(self.addr,
                                     timeout=self.connect_timeout_s)
        s.settimeout(self.op_timeout_s)
        return s

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _count(self, name: str) -> None:
        """One of :data:`WIRE_COUNTERS`, here and in the registry."""
        self.counters[name] += 1
        tm = self._tm()
        if tm.enabled:
            tm.counter("wire." + name)

    def _note_ok(self, dt: float, srv: Optional[dict]) -> None:
        tm = self._tm()
        if self._outage_t0 is not None:
            outage = self.clock.now() - self._outage_t0
            self._outage_t0 = None
            if tm.enabled:
                tm.gauge("wire.outage_s", round(outage, 3))
                tm.event("gauges", **{"wire.outage_s": round(outage, 3)})
                tm.event(WIRE_EVENT, kind="outage", w=self.client_id,
                         secs=round(outage, 3))
        if tm.enabled:
            tm.observe("wire.rtt", dt)
            if srv:
                # the reply's time split: the RTT into wire transit, the
                # center's queue and its apply, with tracing off too
                if srv.get("q") is not None:
                    tm.observe("wire.server_queue", float(srv["q"]))
                if srv.get("a") is not None:
                    tm.observe("wire.server_apply", float(srv["a"]))

    def _note_fail(self, counter: Optional[str] = None) -> None:
        if self._outage_t0 is None:
            self._outage_t0 = self.clock.now()
        if counter:
            self._count(counter)

    def request(self, header: dict, body: bytes = b"",
                trace: Optional[dict] = None) -> Tuple[dict, bytes]:
        """One request/response round trip, retried through failures; the
        token stamped here makes a re-sent mutating op apply once.

        ``trace`` (a span's ``ctx()``) mints ONE ``wire.<op>`` span id
        here and stamps ``{"t": trace, "s": span}`` into the header, so
        every retry re-sends the same ids and the server's spans join this
        client span; the span event (with telemetry on) carries the whole
        round trip, the server's ``q``/``a`` split and the retry count, and
        a give-up ends it with ``ok=false``."""
        h = dict(header)
        op = str(header.get("op"))
        with self._lock:
            h["tok"] = {"w": self.client_id, "seq": self._seq}
            self._seq += 1
            sid = None
            if trace is not None:
                sid = tracing.new_span_id()
                h["trace"] = {"t": trace.get("t"), "s": sid}
            t_req = time.time()
            try:
                resp, rbody = self._request_locked(h, body)
            except BaseException as e:
                tm = self._tm()
                if trace is not None and tm.enabled:
                    tracing.emit_wire_span(
                        tm, trace, op, span=sid, t0=t_req,
                        dt=time.time() - t_req, ok=False,
                        err=repr(e)[:120],
                        retries=self._last_attempts - 1)
                raise
            if trace is not None:
                tm = self._tm()
                if tm.enabled:
                    srv = resp.get("srv") or {}
                    tracing.emit_wire_span(
                        tm, trace, op, span=sid, t0=t_req,
                        dt=time.time() - t_req, q=srv.get("q"),
                        a=srv.get("a"), dedup=bool(resp.get("dedup")),
                        ok=True, retries=self._last_attempts - 1)
            return resp, rbody

    def _request_locked(self, header: dict, body: bytes
                        ) -> Tuple[dict, bytes]:
        t_start = self.clock.now()
        last_err: Optional[BaseException] = None
        attempts = 0
        for attempt in range(self.max_retries + 1):
            attempts = attempt + 1
            self._last_attempts = attempts
            if attempt:
                self._note_fail("retry")
                delay = self.backoff.delay(attempt - 1)
                if self.clock.now() + delay - t_start > self.deadline_s:
                    break
                self.clock.sleep(delay)
            try:
                if self._sock is None:
                    self._sock = self._connect()
                    if attempt:
                        self._count("reconnect")
                t0 = time.time()
                send_msg(self._sock, header, body)
                resp, rbody = recv_msg(self._sock)
                if not resp.get("ok"):
                    if resp.get("retry"):
                        # retryable server verdict (a corrupt request, or
                        # a twin of a request still in flight): the same
                        # token again
                        last_err = WireError(str(resp.get("error")))
                        if not resp.get("busy"):
                            self._note_fail("corrupt")
                        continue
                    if resp.get("uninit"):
                        raise CenterUninitialized(
                            f"center server error: {resp.get('error')}")
                    raise RemoteOpError(
                        f"center server error: {resp.get('error')}")
                self.last_srv = resp.get("srv")
                self._note_ok(time.time() - t0, self.last_srv)
                return resp, rbody
            except socket.timeout as e:
                # the reply may still be in flight: the stream is no
                # longer frame-aligned, so the connection is dropped
                last_err = e
                self._note_fail("timeout")
                self._drop()
            except CorruptPayload as e:
                # the reply's body was corrupted; framing stayed aligned
                last_err = e
                self._note_fail("corrupt")
            except VersionMismatch:
                self._drop()
                raise
            except (WireError, OSError) as e:
                last_err = e
                self._note_fail()
                self._drop()
            if self.clock.now() - t_start > self.deadline_s:
                break
        self._drop()
        self._count("giveup")
        tm = self._tm()
        if tm.enabled:
            tm.event(WIRE_EVENT, kind="giveup", w=self.client_id,
                     op=str(header.get("op")), err=repr(last_err)[:200])
        raise WireGiveUp(
            f"center {self.addr[0]}:{self.addr[1]} unreachable: gave up "
            f"on op {header.get('op')!r} after {attempts} attempts / "
            f"{self.clock.now() - t_start:.1f}s "
            f"(deadline {self.deadline_s:.0f}s)"
            f" — last error: {last_err!r}")

    def close(self) -> None:
        with self._lock:
            self._drop()
