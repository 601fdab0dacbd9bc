"""The elastic center across processes: the reference's EASGD/ASGD server
over a socket, on the JAX package's wire.

Counterpart of ``theanompi_tpu/parallel/center_server.py``.  The reference
ran a server rank holding the center; workers exchanged with it over MPI
at their own pace.  ``async_easgd.ElasticCenter`` holds that center in one
process; this module serves it to others:

* :class:`CenterServer` — a TCP server around an ``ElasticCenter``, one
  thread per client connection, the center's lock serializing updates as
  the reference server served one worker at a time; the wire's framing,
  an idle timeout per connection, a :class:`~.wire.DedupWindow` (a
  retried push that landed is applied once), and periodic crash-atomic
  snapshots (params, membership, counters, dedup marks) it restores from.
* :class:`RemoteCenter` — a client with ``ElasticCenter``'s leaf-list
  surface (``ensure_init_leaves``, ``pull_leaves``, ``push_delta_leaves``,
  ``push_pull_leaves``), so an island works the same against a center in
  memory or behind a socket.
* :func:`center_main` — the center as a process of its own:
  ``python -m theanompi_tpu_torch.parallel.center_server --port P``.

The wire (``parallel/wire.py``) is the JAX package's, byte for byte, and
the center's leaves are float32 in the JAX package's flatten order and
layouts (conv HWIO, FC ``[in, out]``): a center served by either package
takes pushes and pulls from an island of either package.  Ops: ``init``
(idempotent seed), ``pull``, ``push`` (EASGD: center += α·delta),
``push_pull`` (ASGD: center += delta, the new center returned in the same
op), ``demote`` / ``readmit`` (a demoted island's pushes are dropped),
``stats``.  Replies carry the server's time split ``srv = {"q": lock
wait, "a": apply}`` in seconds; ``stats`` adds the totals of both
(``queue_s``, ``apply_s``, over ``n_ops`` ops).  A request that carries
the v2 ``trace`` context gets a ``center.<op>`` server span in the
telemetry stream, parented to the client's ``wire.<op>`` span
(``utils/tracing.py``).  ``center_main --record-dir`` streams the
center's telemetry (rank -1) and serves a ``statusz`` endpoint
registered there.  The membership leases and the fleet monitor
(``--lease-dir``, ``--metrics-addr``) wait for ROADMAP A10 and are
refused.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import telemetry, tracing
from . import wire
from .async_easgd import ElasticCenter
from .wire import (ConnectionClosed, CorruptPayload, DedupWindow,
                   TruncatedMessage, VersionMismatch, WireClient,
                   pack_leaves, unpack_leaves)


def snapshot_path(snapshot_dir: str) -> str:
    return os.path.join(snapshot_dir, "center_state.npz")


def load_snapshot(path: str):
    """``(leaves, meta)`` from one center snapshot file, the one parser of
    the format (either package's snapshots).  Raises on a missing or torn
    file."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        n = len([k for k in z.files if k.startswith("leaf")])
        leaves = [z[f"leaf{i}"] for i in range(n)]
    return leaves, meta


# -- server -----------------------------------------------------------------

class CenterServer:
    """Serve an :class:`ElasticCenter` over TCP.  ``start()`` binds and
    returns ``(host, port)``; serving happens on daemon threads, one per
    connection.

    ``snapshot_dir`` enables crash recovery: the whole center state is
    written every ``snapshot_every_s`` seconds (when it changed) as one
    npz, through a temporary file, fsync and ``os.replace``, so a kill
    mid-save leaves the previous snapshot; :meth:`restore` reloads it."""

    def __init__(self, alpha: float = 0.5, center=None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_s: float = 2.0,
                 idle_timeout_s: float = 120.0,
                 dedup_depth: int = 128):
        # an existing center is served as it is: in-process islands and
        # remote clients share its one store
        self.center = center if center is not None \
            else ElasticCenter(alpha=alpha)
        self.dedup = DedupWindow(depth=dedup_depth)
        self.snapshot_dir = snapshot_dir
        self.snapshot_every_s = float(snapshot_every_s)
        self.idle_timeout_s = float(idle_timeout_s)
        # totals of the time split the replies carry (under _time_lock)
        self.queue_s = 0.0
        self.apply_s = 0.0
        self.n_ops = 0
        self._time_lock = threading.Lock()
        self._srv: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._snap_thread: Optional[threading.Thread] = None
        self._snap_halt = threading.Event()
        self._snap_mark: Optional[tuple] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    # -- crash-recovery snapshots -------------------------------------------

    def _state_mark(self) -> tuple:
        """Cheap change detector: snapshot only when the state moved."""
        st = self.center.stats_snapshot()
        return (st["n_updates"], tuple(st["demoted"]),
                sum(st["dropped_by_island"].values()),
                sum(self.dedup.hwm_snapshot().values()))

    def snapshot(self) -> Optional[str]:
        """One crash-atomic snapshot file (leaves + a JSON meta blob), or
        None when the center is uninitialized or there is no directory."""
        if not self.snapshot_dir:
            return None
        c = self.center
        with c._lock:
            if c._leaves is None:
                return None
            leaves = [np.array(x) for x in c._leaves]
            meta = {"alpha": c.alpha, "n_updates": c.n_updates,
                    "updates_by_island":
                        {str(k): v for k, v in c.updates_by_island.items()},
                    "demoted": sorted(c.demoted),
                    "dropped_by_island":
                        {str(k): v for k, v in c.dropped_by_island.items()},
                    "dedup": self.dedup.snapshot(),
                    "ts": time.time()}
        from ..utils.checkpoint import _fsync_write
        os.makedirs(self.snapshot_dir, exist_ok=True)
        path = snapshot_path(self.snapshot_dir)
        blob = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        _fsync_write(path, lambda f: np.savez(
            f, _meta=blob, **{f"leaf{i}": x for i, x in enumerate(leaves)}))
        return path

    def restore(self, snapshot_dir: Optional[str] = None) -> bool:
        """Reload the snapshot, if any: params, counters, membership and
        the dedup marks (a retried push that landed before the crash is
        answered from the window, not reapplied)."""
        d = snapshot_dir or self.snapshot_dir
        if not d:
            return False
        path = snapshot_path(d)
        if not os.path.exists(path):
            return False
        try:
            leaves, meta = load_snapshot(path)
        except Exception as e:
            import sys
            print(f"center: snapshot {path} unreadable ({e!r}) — "
                  f"starting fresh", file=sys.stderr, flush=True)
            return False
        c = self.center
        with c._lock:
            c._leaves = [np.array(x, np.float32) for x in leaves]
            c.alpha = float(meta.get("alpha", c.alpha))
            c.n_updates = int(meta.get("n_updates", 0))
            c.updates_by_island = {int(k): int(v) for k, v in
                                   meta.get("updates_by_island", {}).items()}
            c.demoted = set(int(x) for x in meta.get("demoted", ()))
            c.dropped_by_island = {int(k): int(v) for k, v in
                                   meta.get("dropped_by_island", {}).items()}
        self.dedup.restore(meta.get("dedup") or {})
        return True

    def _snapshot_loop(self) -> None:
        while not self._snap_halt.wait(self.snapshot_every_s):
            try:
                mark = self._state_mark()
                if mark != self._snap_mark:
                    self.snapshot()
                    self._snap_mark = mark
            except Exception:
                pass               # a snapshot must never kill serving

    def stats(self) -> dict:
        """The ``stats`` op's reply body fields."""
        with self._time_lock:
            times = {"queue_s": self.queue_s, "apply_s": self.apply_s,
                     "n_ops": self.n_ops}
        return {**self.center.stats_snapshot(), "dedup_hits": self.dedup.hits,
                "seq_hwm": self.dedup.hwm_snapshot(), **times}

    # -- serving ------------------------------------------------------------

    def _timed(self, fn):
        """``fn()`` under the center's lock, with the server's time split:
        ``q`` the lock wait (the center serializes every client, so that
        is its queue), ``a`` the apply under the lock."""
        t_q = time.time()
        with self.center._lock:
            q = time.time() - t_q
            t_a = time.time()
            out = fn()
            a = time.time() - t_a
        with self._time_lock:
            self.queue_s += q
            self.apply_s += a
            self.n_ops += 1
        return out, {"q": round(q, 6), "a": round(a, 6)}

    def _dispatch(self, sock, header: dict, body: bytes) -> None:
        """Answer one request; one that carries the ``trace`` context gets
        a ``center.<op>`` span, parented to the client's span (a dedup
        twin's tagged ``dedup``)."""
        center, dedup = self.center, self.dedup
        op = header.get("op")
        tok = header.get("tok")
        trc = header.get("trace")
        t_acc = time.time()

        def reply(hdr, rbody=b"", srv=None, dedup_reply=False):
            h = dict(hdr)
            if srv is not None:
                h["srv"] = srv
            wire.send_msg(sock, h, rbody)
            tm = telemetry.active()
            if trc and tm.enabled:
                tracing.emit_server_span(
                    tm, trc, str(op), t0=t_acc, dt=time.time() - t_acc,
                    q=(srv or {}).get("q"), a=(srv or {}).get("a"),
                    island=header.get("island"), dedup=dedup_reply,
                    ok=bool(h.get("ok")))

        if op in ("push", "push_pull"):
            dup, cached = dedup.check(tok, op)
            if dup:
                if cached is wire.INFLIGHT:
                    # the original is still being applied and may fail:
                    # the twin must retry the same token, not be acked
                    reply({"ok": False, "retry": True, "busy": True,
                           "error": "request in flight — retry"},
                          dedup_reply=True)
                    return
                # a retry of a request that landed: reply, don't reapply
                hdr = dict(cached[0]) if cached is not None else {"ok": True}
                hdr["dedup"] = True
                if cached is not None and cached[1] is not None:
                    reply(hdr, cached[1], dedup_reply=True)
                elif op == "push":
                    reply(hdr, dedup_reply=True)
                else:
                    # a push_pull replay: the current center, a valid
                    # (fresher) anchor for the downpour algebra
                    reply(hdr, pack_leaves(center.pull_leaves()),
                          dedup_reply=True)
                return
        if op in ("pull", "push", "push_pull") and center._leaves is None:
            # a respawned center with no usable snapshot: say so
            # structurally, so the clients re-seed and carry on
            if op in ("push", "push_pull"):
                dedup.release(tok, op)
            reply({"ok": False, "uninit": True,
                   "error": "center not initialized (no snapshot "
                            "survived?) — re-seed with ensure_init"})
            return
        try:
            if op == "init":
                leaves_in = unpack_leaves(body)
                _, srv = self._timed(
                    lambda: center.ensure_init_leaves(leaves_in))
                reply({"ok": True}, srv=srv)
            elif op == "pull":
                leaves, srv = self._timed(center.pull_leaves)
                reply({"ok": True}, pack_leaves(leaves), srv=srv)
            elif op == "push":
                leaves_in = unpack_leaves(body)
                _, srv = self._timed(lambda: center.push_delta_leaves(
                    leaves_in, int(header["island"])))
                dedup.record(tok, op, {"ok": True, "srv": srv})
                reply({"ok": True}, srv=srv)
            elif op == "push_pull":
                leaves_in = unpack_leaves(body)
                leaves, srv = self._timed(lambda: center.push_pull_leaves(
                    leaves_in, int(header["island"])))
                # the token is recorded, the model-sized body is not: a
                # replay gets the current center
                dedup.record(tok, op, {"ok": True, "srv": srv},
                             reply_body=None)
                reply({"ok": True}, pack_leaves(leaves), srv=srv)
            elif op == "demote":
                center.demote_island(int(header["island"]))
                reply({"ok": True})
            elif op == "readmit":
                center.readmit_island(int(header["island"]))
                reply({"ok": True})
            elif op == "stats":
                reply({"ok": True, **self.stats()})
            else:
                reply({"ok": False, "error": f"unknown op {op!r}"})
        except Exception:
            if op in ("push", "push_pull"):
                dedup.release(tok, op)       # failed: claim withdrawn
            raise

    def _serve_connection(self, sock) -> None:
        """One connection's request loop, until the client goes away or
        idles past the timeout."""
        sock.settimeout(self.idle_timeout_s)
        with self._conns_lock:
            self._conns.add(sock)
        try:
            while True:
                try:
                    header, body = wire.recv_msg(sock)
                except VersionMismatch as e:
                    # loud, both versions named; nothing else this peer
                    # sends can be trusted
                    wire.send_msg(sock, {"ok": False, "error": str(e)})
                    return
                except CorruptPayload as e:
                    # framing stayed aligned: retry the same token here
                    wire.send_msg(sock, {"ok": False, "error": str(e),
                                         "retry": True})
                    continue
                try:
                    self._dispatch(sock, header, body)
                except (ConnectionError, OSError):
                    raise
                except Exception as e:
                    # an op-level failure (a leaf-count mismatch) replies
                    # with its cause
                    wire.send_msg(sock, {"ok": False, "error": repr(e)})
        except (socket.timeout, TimeoutError, ConnectionClosed,
                TruncatedMessage, ConnectionError, OSError):
            return
        finally:
            with self._conns_lock:
                self._conns.discard(sock)

    def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._serve_connection(self.request)

        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        if self.snapshot_dir:
            self._snap_thread = threading.Thread(target=self._snapshot_loop,
                                                 daemon=True)
            self._snap_thread.start()
        return self._srv.server_address[:2]

    def stop(self, final_snapshot: bool = True) -> None:
        self._snap_halt.set()
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=10)
            self._snap_thread = None
        if final_snapshot and self.snapshot_dir:
            try:
                self.snapshot()
            except Exception:
                pass
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
            # a stopped center severs its connections, as a dead one would
            with self._conns_lock:
                conns = list(self._conns)
                self._conns.clear()
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


# -- client -----------------------------------------------------------------

class RemoteCenter:
    """``ElasticCenter``'s leaf-list surface on the wire: every call is
    one tokened round trip, retried with bounded backoff and reconnect
    through timeouts, drops, corruption and center restarts, and ending
    in :class:`~.wire.WireGiveUp` when the center stays unreachable past
    the deadline.  ``last_srv`` is the last reply's server time split.
    ``pull_leaves``, ``push_delta_leaves`` and ``push_pull_leaves`` take
    the caller's span context (``trace``), which rides the request."""

    def __init__(self, addr: str, alpha: float = 0.5,
                 client_id=None, connect_timeout: float = 5.0,
                 op_timeout_s: float = 20.0, max_retries: int = 8,
                 deadline_s: float = 120.0, backoff=None):
        self.alpha = float(alpha)
        self._wire = WireClient(addr, client_id=client_id,
                                op_timeout_s=op_timeout_s,
                                connect_timeout_s=connect_timeout,
                                max_retries=max_retries,
                                deadline_s=deadline_s, backoff=backoff)

    @property
    def last_srv(self) -> Optional[dict]:
        return self._wire.last_srv

    def ensure_init_leaves(self, leaves: List[np.ndarray]) -> None:
        self._wire.request({"op": "init"}, pack_leaves(leaves))

    def pull_leaves(self, trace: Optional[dict] = None) -> List[np.ndarray]:
        _, body = self._wire.request({"op": "pull"}, trace=trace)
        return unpack_leaves(body)

    def push_delta_leaves(self, deltas: List[np.ndarray], island: int,
                          trace: Optional[dict] = None) -> None:
        self._wire.request({"op": "push", "island": int(island)},
                           pack_leaves(deltas), trace=trace)

    def push_pull_leaves(self, deltas: List[np.ndarray], island: int,
                         trace: Optional[dict] = None) -> List[np.ndarray]:
        _, body = self._wire.request({"op": "push_pull",
                                      "island": int(island)},
                                     pack_leaves(deltas), trace=trace)
        return unpack_leaves(body)

    def demote_island(self, island: int) -> None:
        self._wire.request({"op": "demote", "island": int(island)})

    def readmit_island(self, island: int) -> None:
        self._wire.request({"op": "readmit", "island": int(island)})

    def stats(self) -> dict:
        resp, _ = self._wire.request({"op": "stats"})
        return resp

    @property
    def n_updates(self) -> int:
        return int(self.stats()["n_updates"])

    @property
    def updates_by_island(self) -> Dict[int, int]:
        return {int(k): v for k, v in self.stats()["by_island"].items()}

    def close(self) -> None:
        self._wire.close()


# -- center process CLI ------------------------------------------------------

def center_main(argv: Optional[List[str]] = None) -> int:
    """Run the center as a process of its own:
    ``python -m theanompi_tpu_torch.parallel.center_server --port P``.
    Restores from ``--snapshot-dir`` when a snapshot is there, snapshots
    periodically and serves until SIGTERM (or ``--max-seconds``)."""
    import argparse
    import signal
    import sys

    ap = argparse.ArgumentParser(description=center_main.__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True,
                    help="fixed port: clients reconnect here across "
                         "center restarts (0: any free port)")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=float, default=2.0)
    ap.add_argument("--idle-timeout", type=float, default=120.0)
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="self-terminate after this long (0 = forever)")
    ap.add_argument("--record-dir", default=None,
                    help="stream the center's telemetry (rank -1) and its "
                         "server spans there; serve statusz")
    ap.add_argument("--run-id", default=None)
    ap.add_argument("--lease-id", type=int, default=0,
                    help="the center's id in the statusz roster")
    # the JAX package's membership lease and fleet monitor: refused below
    for flag in ("--lease-dir", "--metrics-addr"):
        ap.add_argument(flag, default=None)
    args = ap.parse_args(argv)
    for flag in ("lease_dir", "metrics_addr"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: membership leases and the "
                f"fleet monitor are not ported yet (ROADMAP A10)")

    # flush every 2 events: the center emits few, valuable events (server
    # spans) and may die by SIGKILL, which a 64-event buffer would lose
    tm = telemetry.init({"record_dir": args.record_dir, "rank": -1,
                         "run_id": args.run_id,
                         "telemetry_flush_every": 2}) \
        if args.record_dir else telemetry.active()
    srv = CenterServer(alpha=args.alpha, snapshot_dir=args.snapshot_dir,
                       snapshot_every_s=args.snapshot_every,
                       idle_timeout_s=args.idle_timeout)
    restored = srv.restore()
    host, port = srv.start(args.host, args.port)
    print(f"center: serving on {host}:{port} "
          f"({'restored from snapshot' if restored else 'fresh'})",
          file=sys.stderr, flush=True)
    statusz = None
    if args.record_dir:
        statusz = tracing.StatuszServer(
            "center", ident=args.lease_id, run_dir=args.record_dir,
            telemetry_=tm,
            extra=lambda: {"n_updates": srv.center.n_updates,
                           "dedup_hits": srv.dedup.hits,
                           "addr": f"{host}:{port}"})
        statusz.start()
    halt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: halt.set())
    try:
        signal.signal(signal.SIGINT, lambda *_: halt.set())
    except (ValueError, OSError):
        pass
    t0 = time.time()
    while not halt.wait(0.2):
        if args.max_seconds and time.time() - t0 > args.max_seconds:
            break
    srv.stop(final_snapshot=True)
    if statusz is not None:
        statusz.stop()
    if tm.enabled:
        tm.event("train_end", center=True, n_updates=srv.center.n_updates,
                 dedup_hits=srv.dedup.hits)
        tm.close()
    print(f"center: stopped after {srv.center.n_updates} updates "
          f"({srv.dedup.hits} dedup hits)", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(center_main())
