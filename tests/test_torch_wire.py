"""The port's center wire (``theanompi_tpu_torch/parallel/wire.py`` and
``center_server.py``) against the JAX package's.

* The scenarios of ``tests/test_wire.py`` (framing and CRC verdicts, the
  close taxonomy, version mismatches, the client's retries, reconnects
  and give-ups, the dedup window, exactly-once pushes, the structured
  uninitialized verdict, the idle timeout, snapshots and a center
  restart) run as cases of one parametrized test each, over both
  packages' modules (``jax`` and ``torch``); the JAX package's telemetry
  assertions stay in ``test_wire.py``.
* The bytes: the port's frames (``encode_frame``, ``send_msg``) and leaf
  bodies (``pack_leaves``) equal the JAX package's for the same header,
  body and leaves.
* A body CRC error is retryable: the client retries through a corrupted
  reply and succeeds.
* Cross-talk: a port ``RemoteCenter`` against a JAX ``CenterServer``, and
  a JAX ``RemoteCenter`` against a port ``CenterServer``, give the same
  ``pull``, ``push`` and ``push_pull`` results as the in-memory center; a
  snapshot either package writes restores in the other's server.
"""

import json
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from theanompi_tpu.parallel import async_easgd as JA
from theanompi_tpu.parallel import center_server as JCS
from theanompi_tpu.parallel import membership as JM
from theanompi_tpu.parallel import wire as JW
from theanompi_tpu_torch.parallel import async_easgd as TA
from theanompi_tpu_torch.parallel import center_server as TCS
from theanompi_tpu_torch.parallel import membership as TM
from theanompi_tpu_torch.parallel import wire as TW

PKGS = {"jax": (JW, JCS, JM, JA), "torch": (TW, TCS, TM, TA)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """``(name, wire, center_server, membership, async_easgd)`` of one
    package."""
    return (request.param,) + PKGS[request.param]


def _ops(name, rc):
    """(ensure_init, pull_leaves, push, push_pull) of a ``RemoteCenter``
    on leaf lists: the JAX client's tree interface takes a list as a tree
    of leaves."""
    if name == "jax":
        return rc.ensure_init, rc.pull_leaves, rc.push_delta, rc.push_pull
    return (rc.ensure_init_leaves, rc.pull_leaves, rc.push_delta_leaves,
            rc.push_pull_leaves)


def _fast_client(wire, membership, addr, **kw):
    kw.setdefault("op_timeout_s", 2.0)
    kw.setdefault("connect_timeout_s", 1.0)
    kw.setdefault("max_retries", 6)
    kw.setdefault("deadline_s", 20.0)
    kw.setdefault("backoff", membership.Backoff(base=0.05, cap=0.3))
    return wire.WireClient(addr, **kw)


def _raw_push(wire, sock, island, seq, leaves, w="w1", op="push"):
    wire.send_msg(sock, {"op": op, "island": island,
                         "tok": {"w": w, "seq": seq}},
                  wire.pack_leaves(leaves))


def _read_frame(wire, sock):
    """One frame's raw parts: (hlen, hcrc, header bytes, blen, body)."""
    hl = wire.recv_exact(sock, 4, at_boundary=True)
    hcrc = wire.recv_exact(sock, 4)
    hb = wire.recv_exact(sock, struct.unpack("!I", hl)[0])
    bl = wire.recv_exact(sock, 4)
    body = wire.recv_exact(sock, struct.unpack("!I", bl)[0])
    return hl, hcrc, hb, bl, body


# -- the shared scenarios ----------------------------------------------------

def test_framing_roundtrip_and_crc_detection(pkg):
    _, wire, *_ = pkg
    a, b = socket.socketpair()
    try:
        body = b"x" * 1000
        wire.send_msg(a, {"op": "probe", "n": 3}, body)
        header, got = wire.recv_msg(b)
        assert header["op"] == "probe" and header["n"] == 3
        assert got == body and header["v"] == wire.WIRE_VERSION
        # one body byte flipped: the body CRC catches it (retryable)
        wire.send_msg(a, {"op": "probe"}, body)
        hl, hcrc, hb, bl, raw = _read_frame(wire, b)
        raw = bytearray(raw)
        raw[500] ^= 0xFF
        c, d = socket.socketpair()
        try:
            c.sendall(hl + hcrc + hb + bl + bytes(raw))
            with pytest.raises(wire.CorruptPayload, match="CRC"):
                wire.recv_msg(d)
        finally:
            c.close()
            d.close()
        # one header byte flipped: FramingError (drop the connection)
        wire.send_msg(a, {"op": "probe"}, b"")
        hl, hcrc, hb, bl, _ = _read_frame(wire, b)
        hb = bytearray(hb)
        hb[2] ^= 0xFF
        c, d = socket.socketpair()
        try:
            c.sendall(hl + hcrc + bytes(hb) + bl)
            with pytest.raises(wire.FramingError, match="header CRC"):
                wire.recv_msg(d)
        finally:
            c.close()
            d.close()
    finally:
        a.close()
        b.close()


def test_clean_close_vs_mid_message_truncation(pkg):
    _, wire, *_ = pkg
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(wire.ConnectionClosed):
        wire.recv_msg(b)
    b.close()
    a, b = socket.socketpair()
    hb = json.dumps({"op": "x", "v": wire.WIRE_VERSION}).encode()
    a.sendall(struct.pack("!I", len(hb)) + hb[: len(hb) // 2])
    a.close()
    with pytest.raises(wire.TruncatedMessage, match="mid-message"):
        wire.recv_msg(b)
    b.close()
    assert issubclass(wire.ConnectionClosed, ConnectionError)
    assert issubclass(wire.TruncatedMessage, ConnectionError)


def test_version_mismatch_fails_loudly_with_both_versions(pkg):
    _, wire, *_ = pkg
    a, b = socket.socketpair()
    try:
        a.sendall(wire.encode_frame({"op": "x", "v": 999999}))
        with pytest.raises(wire.VersionMismatch) as ei:
            wire.recv_msg(b)
        msg = str(ei.value)
        assert "v999999" in msg and f"v{wire.WIRE_VERSION}" in msg
    finally:
        a.close()
        b.close()


def test_server_replies_version_mismatch_with_both_versions(pkg):
    _, wire, cs, *_ = pkg
    srv = cs.CenterServer(alpha=0.5)
    host, port = srv.start()
    try:
        s = socket.create_connection((host, port), timeout=5)
        s.sendall(wire.encode_frame({"op": "stats", "v": 0}))
        header, _ = wire.recv_msg(s)
        assert header["ok"] is False
        assert "v0" in header["error"] and \
            f"v{wire.WIRE_VERSION}" in header["error"]
        s.close()
    finally:
        srv.stop()


class _FlakyServer(threading.Thread):
    """Drops the first ``drop_conns`` connections after reading one frame
    (no reply; with ``stall_first`` after a sleep past the client's op
    timeout), or, with ``corrupt_first``, answers the first request with
    a body whose CRC is wrong; then serves every request with a reply
    carrying ``echo`` and one leaf."""

    def __init__(self, wire, drop_conns=0, stall_first=False,
                 corrupt_first=False):
        super().__init__(daemon=True)
        self.wire = wire
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.drop_conns = drop_conns
        self.stall_first = stall_first
        self.corrupt_first = corrupt_first
        self.requests = 0
        self._halt = threading.Event()

    def run(self):
        wire, conns = self.wire, 0
        while not self._halt.is_set():
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            conns += 1
            try:
                while True:
                    header, _ = wire.recv_msg(c)
                    self.requests += 1
                    if conns <= self.drop_conns:
                        if self.stall_first:
                            time.sleep(5.0)
                        c.close()
                        break
                    body = wire.pack_leaves([np.arange(4, dtype=np.float32)])
                    reply = {"ok": True, "echo": header.get("op"),
                             "v": wire.WIRE_VERSION,
                             "crc": zlib.crc32(body) & 0xFFFFFFFF}
                    if self.corrupt_first and self.requests == 1:
                        reply["crc"] ^= 1
                    c.sendall(wire.encode_frame(reply, body))
            except (ConnectionError, OSError):
                pass

    def stop(self):
        self._halt.set()
        try:
            self.sock.close()
        except OSError:
            pass


def test_client_reconnects_and_retries_through_dropped_connection(pkg):
    _, wire, _, membership, _ = pkg
    srv = _FlakyServer(wire, drop_conns=1)
    srv.start()
    try:
        client = _fast_client(wire, membership, srv.addr, client_id="w9")
        resp, _ = client.request({"op": "stats"})
        assert resp["ok"] and resp["echo"] == "stats"
        assert srv.requests == 2
        client.close()
    finally:
        srv.stop()


def test_client_times_out_and_gives_up_with_clear_error(pkg):
    _, wire, _, membership, _ = pkg
    srv = _FlakyServer(wire, drop_conns=99, stall_first=True)
    srv.start()
    try:
        client = _fast_client(wire, membership, srv.addr, client_id="w9",
                              op_timeout_s=0.3, max_retries=1,
                              deadline_s=2.0)
        with pytest.raises(wire.WireGiveUp) as ei:
            client.request({"op": "pull"})
        msg = str(ei.value)
        assert "gave up" in msg and "'pull'" in msg and "attempts" in msg
        client.close()
    finally:
        srv.stop()


def test_client_gives_up_fast_on_dead_address(pkg):
    _, wire, _, membership, _ = pkg
    client = wire.WireClient("127.0.0.1:9", client_id="w1",
                             connect_timeout_s=0.2, op_timeout_s=0.2,
                             max_retries=2, deadline_s=1.5,
                             backoff=membership.Backoff(base=0.02, cap=0.05))
    t0 = time.time()
    with pytest.raises(wire.WireGiveUp, match="unreachable"):
        client.request({"op": "pull"})
    assert time.time() - t0 < 10.0


def test_corrupt_reply_is_retried(pkg):
    """A body CRC error is retryable: the client sends the same request
    again on the same connection and takes the good reply."""
    _, wire, _, membership, _ = pkg
    srv = _FlakyServer(wire, corrupt_first=True)
    srv.start()
    try:
        client = _fast_client(wire, membership, srv.addr, client_id="w3")
        resp, body = client.request({"op": "pull"})
        assert resp["ok"] and srv.requests == 2
        np.testing.assert_array_equal(wire.unpack_leaves(body)[0],
                                      np.arange(4, dtype=np.float32))
        if hasattr(client, "counters"):
            assert client.counters["corrupt"] == 1
        client.close()
    finally:
        srv.stop()


def test_dedup_window_claim_record_release_and_hwm(pkg):
    _, wire, *_ = pkg
    win = wire.DedupWindow(depth=4)
    tok = {"w": "w1", "seq": 0}
    fresh, _ = win.check(tok, "push")
    assert fresh is False
    dup, cached = win.check(tok, "push")      # the in-flight twin
    assert dup and cached is wire.INFLIGHT
    win.record(tok, "push", {"ok": True}, b"r")
    dup, cached = win.check(tok, "push")
    assert dup and cached == ({"ok": True}, b"r")
    tok2 = {"w": "w1", "seq": 1}
    win.check(tok2, "push")
    win.release(tok2, "push")
    fresh2, _ = win.check(tok2, "push")
    assert fresh2 is False
    win.record(tok2, "push", {"ok": True})
    for seq in range(2, 10):
        t = {"w": "w1", "seq": seq}
        win.check(t, "push")
        win.record(t, "push", {"ok": True})
    dup_old, cached_old = win.check({"w": "w1", "seq": 0}, "push")
    assert dup_old and cached_old is None
    win.check({"w": "w1", "seq": 99}, "push")      # a claim, not recorded
    snap = win.snapshot()
    assert ["push", 99] not in snap["tokens"]["w1"]
    win2 = wire.DedupWindow()
    win2.restore(snap)
    dup_r, cached_r = win2.check({"w": "w1", "seq": 9}, "push")
    assert dup_r and cached_r is not None and cached_r[1] is None
    fresh_r, _ = win2.check({"w": "w1", "seq": 99}, "push")
    assert fresh_r is False
    assert win2.hwm_snapshot() == {"w1": 9}


def test_duplicated_push_applied_exactly_once_by_server(pkg):
    name, wire, cs, *_ = pkg
    srv = cs.CenterServer(alpha=0.5)
    host, port = srv.start()
    try:
        boot = cs.RemoteCenter(f"{host}:{port}", alpha=0.5, client_id="boot")
        init, pull, _, _ = _ops(name, boot)
        init([np.ones(3, np.float32)])
        s = socket.create_connection((host, port), timeout=5)
        delta = [np.full(3, 2.0, np.float32)]
        _raw_push(wire, s, island=1, seq=0, leaves=delta)
        h1, _ = wire.recv_msg(s)
        _raw_push(wire, s, island=1, seq=0, leaves=delta)   # the duplicate
        h2, _ = wire.recv_msg(s)
        assert h1["ok"] and h2["ok"] and h2.get("dedup") is True
        np.testing.assert_allclose(pull()[0], 2.0)           # 1 + 0.5·2, once
        st = boot.stats()
        assert st["n_updates"] == 1 and st["dedup_hits"] == 1
        _raw_push(wire, s, island=1, seq=1, leaves=delta, op="push_pull")
        wire.recv_msg(s)
        _raw_push(wire, s, island=1, seq=1, leaves=delta, op="push_pull")
        hd, body = wire.recv_msg(s)
        assert hd["ok"]
        np.testing.assert_allclose(wire.unpack_leaves(body)[0], 4.0)
        assert boot.stats()["n_updates"] == 2
        s.close()
    finally:
        srv.stop()


def test_framing_error_on_corrupted_length_prefix(pkg):
    _, wire, *_ = pkg
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", 0xFFFFFFFF))
        with pytest.raises(wire.FramingError, match="desynced"):
            wire.recv_msg(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        hb = json.dumps({"op": "x", "v": wire.WIRE_VERSION}).encode()
        a.sendall(struct.pack("!I", len(hb))
                  + struct.pack("!I", zlib.crc32(hb) & 0xFFFFFFFF) + hb
                  + struct.pack("!I", 0xFFFFFFF0))
        with pytest.raises(wire.FramingError, match="desynced"):
            wire.recv_msg(b)
        assert 0xFFFFFFF0 > wire._MAX_BODY
    finally:
        a.close()
        b.close()


def test_uninitialized_center_is_structured_and_recoverable(pkg):
    name, wire, cs, *_ = pkg
    srv = cs.CenterServer(alpha=0.5)
    host, port = srv.start()
    try:
        c = cs.RemoteCenter(f"{host}:{port}", alpha=0.5, client_id="w1")
        init, pull, push, _ = _ops(name, c)
        with pytest.raises(wire.CenterUninitialized, match="re-seed"):
            pull()
        with pytest.raises(wire.CenterUninitialized):
            push([np.ones(3, np.float32)], 1)
        init([np.ones(3, np.float32)])
        push([np.full(3, 2.0, np.float32)], 1)
        assert c.stats()["n_updates"] == 1
        c.close()
    finally:
        srv.stop()


def test_server_idle_timeout_frees_wedged_handler(pkg):
    name, wire, cs, *_ = pkg
    srv = cs.CenterServer(alpha=0.5, idle_timeout_s=0.4)
    host, port = srv.start()
    try:
        wedged = socket.create_connection((host, port), timeout=5)
        wedged.settimeout(3.0)
        assert wedged.recv(1) == b""
        wedged.close()
        healthy = cs.RemoteCenter(f"{host}:{port}", alpha=0.5, client_id="h")
        _ops(name, healthy)[0]([np.zeros(2, np.float32)])
        assert healthy.stats()["n_updates"] == 0
        healthy.close()
    finally:
        srv.stop()


def test_server_corrupt_request_gets_retryable_error_reply(pkg):
    _, wire, cs, *_ = pkg
    srv = cs.CenterServer(alpha=0.5)
    host, port = srv.start()
    try:
        s = socket.create_connection((host, port), timeout=5)
        body = wire.pack_leaves([np.ones(3, np.float32)])
        s.sendall(wire.encode_frame(
            {"op": "init", "v": wire.WIRE_VERSION, "crc": 12345}, body))
        header, _ = wire.recv_msg(s)
        assert header["ok"] is False and header.get("retry") is True
        wire.send_msg(s, {"op": "stats"})
        header, _ = wire.recv_msg(s)
        assert header["ok"] is True
        s.close()
    finally:
        srv.stop()


def test_center_snapshot_restore_roundtrip_with_dedup(pkg, tmp_path):
    name, wire, cs, *_ = pkg
    d = str(tmp_path)
    srv = cs.CenterServer(alpha=0.5, snapshot_dir=d)
    host, port = srv.start()
    client = cs.RemoteCenter(f"{host}:{port}", alpha=0.5, client_id="boot")
    _ops(name, client)[0]([np.ones(3, np.float32)])
    s = socket.create_connection((host, port), timeout=5)
    push_seq = 1000
    _raw_push(wire, s, island=1, seq=push_seq,
              leaves=[np.full(3, 2.0, np.float32)])
    h, _ = wire.recv_msg(s)
    assert h["ok"]
    s.close()
    client.demote_island(7)
    srv.stop(final_snapshot=True)

    srv2 = cs.CenterServer(alpha=0.5, snapshot_dir=d)
    assert srv2.restore() is True
    host2, port2 = srv2.start()
    try:
        c2 = cs.RemoteCenter(f"{host2}:{port2}", alpha=0.5, client_id="w2")
        st = c2.stats()
        assert st["n_updates"] == 1 and st["demoted"] == [7]
        np.testing.assert_allclose(c2.pull_leaves()[0], 2.0)
        s = socket.create_connection((host2, port2), timeout=5)
        _raw_push(wire, s, island=1, seq=push_seq,
                  leaves=[np.full(3, 2.0, np.float32)])
        h, _ = wire.recv_msg(s)
        assert h["ok"]
        assert c2.stats()["n_updates"] == 1          # not reapplied
        assert c2.stats()["dedup_hits"] >= 1
        # a new incarnation of client w1 (clock-seeded seq) is not deduped
        c1b = cs.RemoteCenter(f"{host2}:{port2}", alpha=0.5, client_id="w1")
        _ops(name, c1b)[2]([np.full(3, 2.0, np.float32)], 1)
        assert c2.stats()["n_updates"] == 2
        c1b.close()
        s.close()
        c2.close()
    finally:
        srv2.stop()


def test_remote_center_rides_out_center_restart(pkg, tmp_path):
    name, wire, cs, membership, _ = pkg
    d = str(tmp_path)
    srv = cs.CenterServer(alpha=0.5, snapshot_dir=d)
    host, port = srv.start()
    client = cs.RemoteCenter(f"{host}:{port}", alpha=0.5, client_id="w1",
                             op_timeout_s=1.0, max_retries=10,
                             deadline_s=30.0)
    init, pull, push, _ = _ops(name, client)
    init([np.ones(3, np.float32)])
    push([np.full(3, 2.0, np.float32)], 1)
    srv.stop(final_snapshot=True)
    revived = []

    def _revive():
        time.sleep(1.0)
        srv2 = cs.CenterServer(alpha=0.5, snapshot_dir=d)
        assert srv2.restore()
        srv2.start(host, port)
        revived.append(srv2)

    t = threading.Thread(target=_revive, daemon=True)
    t.start()
    push([np.full(3, 2.0, np.float32)], 1)
    t.join()
    try:
        assert client.stats()["n_updates"] == 2
        np.testing.assert_allclose(pull()[0], 3.0)
        client.close()
    finally:
        revived[0].stop()


def test_center_server_stop_joins_serve_thread(pkg):
    _, _, cs, *_ = pkg
    srv = cs.CenterServer(alpha=0.5)
    srv.start("127.0.0.1", 0)
    t = srv._thread
    assert t is not None and t.is_alive()
    srv.stop()
    assert not t.is_alive()
    assert srv._thread is None


# -- the bytes -----------------------------------------------------------------

FRAMES = [({"op": "pull", "tok": {"w": "w0", "seq": 17}}, b""),
          ({"op": "push", "island": 3, "v": 2, "crc": 7}, b"\x00\x01" * 9),
          ({"ok": True, "srv": {"q": 1e-05, "a": 0.25}, "é": [1, None]},
           bytes(range(256)))]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_are_the_jax_packages_bytes(i):
    header, body = FRAMES[i]
    assert TW.encode_frame(header, body) == JW.encode_frame(header, body)
    got = []
    for wire in (JW, TW):
        a, b = socket.socketpair()
        try:
            wire.send_msg(a, header, body)
            a.close()
            raw = b""
            while True:
                chunk = b.recv(1 << 16)
                if not chunk:
                    break
                raw += chunk
            got.append(raw)
        finally:
            b.close()
    assert got[0] == got[1]
    h, bd = TW.recv_msg(socket_of(got[1]))
    assert bd == body and h["v"] == JW.WIRE_VERSION == TW.WIRE_VERSION


def socket_of(raw: bytes):
    """A socket that reads ``raw`` and then the peer's close."""
    a, b = socket.socketpair()
    a.sendall(raw)
    a.close()
    return b


def test_leaf_bodies_are_the_jax_packages_bytes():
    """``pack_leaves`` writes the same npz bytes (zip entries carry the
    second they were written at: compared when both JAX calls around the
    port's fall in one second), and each package unpacks the other's."""
    r = np.random.RandomState(0)
    leaves = [r.randn(3, 3, 2, 4).astype(np.float32),
              np.arange(5, dtype=np.float64), np.float32(2.5),
              np.zeros((0, 3), np.float32)]
    for _ in range(5):
        a = JW.pack_leaves(leaves)
        b = TW.pack_leaves(leaves)
        c = JW.pack_leaves(leaves)
        if a == c:
            break
    assert a == c, "the clock's second turned in every attempt"
    assert b == a
    for x, y, z in zip(TW.unpack_leaves(a), JW.unpack_leaves(b), leaves):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, np.asarray(z, np.float32))
        np.testing.assert_array_equal(y, x)
    assert TW.unpack_leaves(b"") == []


# -- cross-talk between the packages -----------------------------------------

def _leaves(seed):
    r = np.random.RandomState(seed)
    return [r.randn(3, 3, 2, 4).astype(np.float32),
            r.randn(4).astype(np.float32), r.randn(6, 5).astype(np.float32)]


@pytest.mark.parametrize("server,client", [("jax", "torch"),
                                           ("torch", "jax")])
def test_cross_package_center_traffic(server, client):
    """One package's client against the other's server: ``init``, ``pull``,
    ``push`` and ``push_pull`` give the in-memory center's results bit for
    bit, and the server's bookkeeping counts them."""
    srv = PKGS[server][1].CenterServer(alpha=0.5)
    host, port = srv.start()
    try:
        rc = PKGS[client][1].RemoteCenter(f"{host}:{port}", alpha=0.5,
                                          client_id="x1")
        init, pull, push, push_pull = _ops(client, rc)
        local = TA.ElasticCenter(alpha=0.5)
        p0, d1, d2 = _leaves(1), _leaves(2), _leaves(3)
        init(p0)
        local.ensure_init_leaves(p0)
        push(d1, 4)
        local.push_delta_leaves(d1, 4)
        for a, b in zip(pull(), local.pull_leaves()):
            np.testing.assert_array_equal(a, b)
        got = push_pull(d2, 5)
        for a, b in zip(got, local.push_pull_leaves(d2, 5)):
            np.testing.assert_array_equal(a, b)
        st = rc.stats()
        assert st["n_updates"] == 2 and st["by_island"] == {"4": 1, "5": 1}
        rc.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_center_snapshots_restore_across_packages(writer, reader, tmp_path):
    d = str(tmp_path)
    srv = PKGS[writer][1].CenterServer(alpha=0.25, snapshot_dir=d)
    srv.center.ensure_init_leaves(_leaves(1))
    srv.center.push_delta_leaves(_leaves(2), 3)
    srv.snapshot()
    back = PKGS[reader][1].CenterServer(snapshot_dir=d)
    assert back.restore() is True
    assert back.center.alpha == 0.25 and back.center.n_updates == 1
    for a, b in zip(back.center.pull_leaves(), srv.center.pull_leaves()):
        np.testing.assert_array_equal(a, b)
    leaves, meta = TCS.load_snapshot(JCS.snapshot_path(d))
    assert meta["updates_by_island"] == {"3": 1} and len(leaves) == 3


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_center_main_beats_a_lease_and_streams_metrics(reader, tmp_path):
    """``center_main --lease-dir --lease-id --metrics-addr``: the center's
    lease, read by ``reader``'s ``read_leases``, beats while it serves and
    says ``left`` after a SIGTERM; its metric snapshots (rank -1, role
    center, its update count as steps) reach a fleet monitor, whose
    collector retires it on the clean exit."""
    import os
    import signal
    import subprocess
    import sys
    from theanompi_tpu_torch.utils import fleetmon
    from theanompi_tpu_torch.utils import telemetry as TT
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lease_dir = str(tmp_path / "lease")
    fm = fleetmon.FleetMonServer(telemetry_=TT.DISABLED)
    fh, fp = fm.start()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    p = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.parallel.center_server",
         "--port", str(port), "--lease-dir", lease_dir, "--lease-id", "0",
         "--metrics-addr", f"{fh}:{fp}", "--record-dir", str(tmp_path),
         "--max-seconds", "120"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    read = PKGS[reader][2].read_leases
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not (
                read(lease_dir) and fm.collector.samples_ingested >= 2):
            assert p.poll() is None, p.communicate()[0]
            time.sleep(0.1)
        doc = read(lease_dir)[0]
        assert doc["status"] == "live" and doc["pid"] == p.pid and \
            doc["step"] == 0
        assert fm.collector.roles == {-1: "center"}
        assert fm.collector.series[-1]["steps"].latest()[1] == 0.0
        rc = TCS.RemoteCenter(f"127.0.0.1:{port}", client_id="w3")
        rc.ensure_init_leaves(_leaves(1))
        rc.push_delta_leaves(_leaves(2), 3)
        rc.close()
        while time.time() < deadline and \
                fm.collector.series[-1]["steps"].latest()[1] < 1:
            time.sleep(0.1)
        assert fm.collector.series[-1]["steps"].latest()[1] == 1.0
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == 0, p.communicate()[0]
        assert read(lease_dir)[0]["status"] == "left"
        assert fm.collector.retired == {-1}
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        fm.stop()
