"""The port's control plane against the JAX package's: the wire codec
(``serverless_learn_tpu_torch/control/wire.py``) byte for byte against
the generated ``native/gen/slt_pb2.py``, and the port's clients and
daemons (``control/client.py``, ``control/daemons.py``) talking to the JAX
package's Python daemons and socket clients (``prefer_native=False``)
both ways: coordinator RPCs, leases, exclusive names, shard-server RPCs,
shared roots and state files.

Every daemon binds port 0 and is stopped by a finalizer; every socket,
join and child wait has a timeout; waits poll a condition under a
deadline.
"""

import json
import os
import random
import selectors
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from serverless_learn_tpu.control import client as jc
from serverless_learn_tpu.control import py_daemons as jd
from serverless_learn_tpu_torch.control import client as pc
from serverless_learn_tpu_torch.control import daemons as pd
from serverless_learn_tpu_torch.control import wire

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "native" / "gen"))
import slt_pb2  # noqa: E402

WAIT_S = 10.0   # the longest any condition below is waited for
RPC_S = 5.0     # each RPC's deadline


def wait_for(pred, timeout=WAIT_S, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"waited {timeout}s for {what}")


# -- the codec ---------------------------------------------------------------

def _value(rng: random.Random, kind: str):
    if kind == wire.STRING:
        return rng.choice(["", "w", "worker-é-7", "x" * 200,
                           "".join(chr(rng.randrange(32, 0x2FF))
                                   for _ in range(rng.randrange(1, 30)))])
    if kind == wire.BYTES:
        return rng.choice([b"", bytes(rng.randrange(256)
                                      for _ in range(rng.randrange(1, 300)))])
    if kind == wire.BOOL:
        return rng.random() < 0.5
    if kind == wire.UINT32:
        return rng.choice([0, 1, 127, 128, 2**31, 2**32 - 1,
                           rng.randrange(2**32)])
    if kind == wire.UINT64:
        return rng.choice([0, 300, 2**35, 2**63, 2**64 - 1,
                           rng.randrange(2**64)])
    if kind == wire.DOUBLE:
        return rng.choice([0.0, -0.0, -1.5, 1e-300, -3.4e38, 2.5,
                           rng.uniform(-1e6, 1e6)])
    raise AssertionError(kind)


def _random_pair(cls, rng: random.Random, depth: int = 0):
    """The same seeded field values as a port message and an slt_pb2 one."""
    ours, theirs = cls(), getattr(slt_pb2, cls.__name__)()
    for f in cls.FIELDS:
        if f.kind == wire.MESSAGE:
            n = rng.randrange(4) if f.repeated else rng.randrange(2)
            subs = [_random_pair(f.message, rng, depth + 1)
                    for _ in range(n if depth < 2 else 0)]
            if f.repeated:
                setattr(ours, f.name, [o for o, _ in subs])
                for _, t in subs:
                    getattr(theirs, f.name).add().CopyFrom(t)
            elif subs:
                setattr(ours, f.name, subs[0][0])
                getattr(theirs, f.name).CopyFrom(subs[0][1])
            continue
        v = _value(rng, f.kind)
        setattr(ours, f.name, v)
        setattr(theirs, f.name, v)
    return ours, theirs


@pytest.mark.parametrize("cls", wire.MESSAGES, ids=lambda c: c.__name__)
def test_codec_bytes_equal_slt_pb2(cls):
    """For seeded values (negatives, -0.0, extreme varints, empty and
    repeated fields, nested messages), the port writes slt_pb2's bytes
    and reads them back to the same fields; a set-but-empty nested
    message is written (tag and zero length) as protobuf writes it."""
    rng = random.Random(hash(cls.__name__) & 0xFFFF)
    for _ in range(40):
        ours, theirs = _random_pair(cls, rng)
        want = theirs.SerializeToString()
        assert ours.encode() == want
        back = cls.decode(want)
        assert back.encode() == want and back == ours
    assert cls().encode() == getattr(slt_pb2, cls.__name__)() \
        .SerializeToString() == b""
    if any(f.name == "trace" for f in cls.FIELDS):
        theirs = getattr(slt_pb2, cls.__name__)()
        theirs.trace.SetInParent()
        assert cls(trace=wire.TraceContext()).encode() == \
            theirs.SerializeToString() == b"\x7a\x00"


def test_codec_skips_unknown_fields_and_packs_repeated_scalars():
    """Unknown fields of every wire type are skipped; a repeated scalar is
    written packed and read packed or not; negative int32/int64 take ten
    varint bytes (slt.proto has no such field: checked against protobuf's
    documented encoding)."""
    theirs = slt_pb2.HeartbeatRequest(worker_id=7, step=9, metric=-2.0)
    unknown = (wire.encode_varint(99 << 3 | 0) + wire.encode_varint(2**63)
               + wire.encode_varint(100 << 3 | 1) + b"\x01" * 8
               + wire.encode_varint(101 << 3 | 2) + b"\x03abc"
               + wire.encode_varint(102 << 3 | 5) + b"\x02" * 4)
    got = wire.HeartbeatRequest.decode(unknown + theirs.SerializeToString()
                                       + unknown)
    assert got == wire.HeartbeatRequest(worker_id=7, step=9, metric=-2.0)
    back = slt_pb2.HeartbeatRequest.FromString(unknown + got.encode())
    back.DiscardUnknownFields()
    assert back == theirs

    class Packed(wire.Message):
        FIELDS = (wire.Field(1, "xs", wire.UINT32, repeated=True),
                  wire.Field(2, "n", wire.INT32), wire.Field(3, "m",
                                                             wire.INT64))

    m = Packed(xs=[1, 300, 0], n=-1, m=-2)
    assert m.encode() == (b"\x0a\x04\x01\xac\x02\x00"
                          + b"\x10" + b"\xff" * 9 + b"\x01"
                          + b"\x18\xfe" + b"\xff" * 8 + b"\x01")
    assert Packed.decode(m.encode()) == m
    unpacked = b"\x08\x01\x08\xac\x02"
    assert Packed.decode(unpacked).xs == [1, 300]


def test_frames_equal_the_native_framing():
    """A frame is [u32 big-endian length][u8 type][payload]; a chunk frame
    sent without copying its data equals slt_pb2's ChunkMsg framed."""
    a, b = socket.socketpair()
    a.settimeout(RPC_S)
    b.settimeout(RPC_S)
    try:
        data = (bytes(range(256)) * 4099)[:wire.CHUNK]
        sender = threading.Thread(target=wire.send_chunk, args=(
            a, memoryview(data)), kwargs=dict(
                offset=5, last=True, crc32=zlib.crc32(data),
                crc_present=True))
        sender.start()
        want = slt_pb2.ChunkMsg(data=data, offset=5, last=True,
                                crc32=zlib.crc32(data),
                                crc_present=True).SerializeToString()
        mtype, payload = wire.FrameReader(b).read()
        sender.join(timeout=RPC_S)
        assert mtype == wire.MSG_CHUNK and bytes(payload) == want
        wire.send_frame(a, wire.MSG_ACK, wire.Ack(ok=True).encode())
        hdr = b.recv(5)
        assert struct.unpack(">IB", hdr) == (2, wire.MSG_ACK)
    finally:
        a.close()
        b.close()


# -- daemons and clients, both packages --------------------------------------

def _port_coordinator(request, **kw):
    srv = pd.Coordinator(**kw).start()
    request.addfinalizer(srv.stop)
    return srv


def _jax_coordinator(request, **kw):
    srv = jd.PyCoordinator(**kw)
    srv.start()
    request.addfinalizer(srv.stop)
    return srv


def _port_shard_server(request, root):
    srv = pd.ShardServer(root=str(root)).start()
    request.addfinalizer(srv.stop)
    return srv


def _jax_shard_server(request, root):
    srv = jd.PyShardServer(root=str(root))
    srv.start()
    request.addfinalizer(srv.stop)
    return srv


COORDINATORS = {"port": _port_coordinator, "jax": _jax_coordinator}
SHARD_SERVERS = {"port": _port_shard_server, "jax": _jax_shard_server}
# (daemon, client): every pairing that involves the port.
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _coord_client(kind, addr, request):
    c = (pc.CoordinatorClient(addr, rpc_timeout_s=RPC_S) if kind == "port"
         else jc.CoordinatorClient(addr, prefer_native=False,
                                   rpc_timeout_s=RPC_S))
    request.addfinalizer(c.close)
    return c


def _shard_client(kind, addr, request):
    c = (pc.ShardClient(addr, rpc_timeout_s=RPC_S) if kind == "port"
         else jc.ShardClient(addr, prefer_native=False))
    request.addfinalizer(c.close)
    return c


@pytest.mark.parametrize("daemon,client", PAIRS)
def test_coordinator_rpcs(request, daemon, client):
    srv = COORDINATORS[daemon](request, lease_ttl_ms=400, sweep_ms=50)
    c = _coord_client(client, srv.addr, request)
    r1 = c.register("a:1", "w1", 1, True)
    assert r1.ok and r1.worker_id == 1 and r1.epoch == 1
    assert r1.lease_ttl_ms == 400
    clash = c.register("a:2", "w1", 1, True)
    assert not clash.ok and "already held by live worker 1" in clash.error
    r2 = c.register("a:3", "w2", 2, False)
    assert r2.ok and r2.epoch == 2
    hb = c.heartbeat(r1.worker_id, step=5, metric=-1.25, flow=3)
    assert hb.ok and hb.epoch == 2
    assert [(p.worker_id, p.addr, p.name, p.n_chips) for p in hb.peers] == \
        [(1, "a:1", "w1", 1), (2, "a:3", "w2", 2)]
    flows = {f.worker_id: (f.flow, f.step, f.metric)
             for f in c.stats().flows}
    assert flows[1] == (3, 5, -1.25)
    assert c.deregister(r2.worker_id).ok
    gone = c.deregister(r2.worker_id)
    assert not gone.ok and gone.error == "unknown worker"
    assert c.membership().epoch == 3
    # No more heartbeats: the sweep evicts the lease, one epoch bump.
    wait_for(lambda: not c.membership().peers, what="lease eviction")
    assert c.membership().epoch == 4
    assert not c.heartbeat(r1.worker_id).ok
    names = {wire.MSG_TYPE_NAMES.get(s.msg_type) for s in c.stats().rpc}
    assert {"register", "heartbeat", "deregister", "membership"} <= names


@pytest.mark.parametrize("daemon,client", PAIRS)
def test_shard_server_rpcs(request, tmp_path, daemon, client):
    srv = SHARD_SERVERS[daemon](request, tmp_path)
    c = _shard_client(client, srv.addr, request)
    blob = np.random.default_rng(3).integers(
        0, 256, (5 << 20) // 2 + 77, np.uint8).tobytes()  # > 2 chunks
    c.put("ds/a.bin", blob)
    c.put("ds/sub/b.bin", b"tiny")
    assert c.fetch("ds/a.bin") == blob
    lo, n = (1 << 20) - 3, (1 << 20) + 7
    assert c.fetch("ds/a.bin", offset=lo, length=n) == blob[lo:lo + n]
    assert c.fetch("ds/a.bin", offset=len(blob) - 5, length=100) == blob[-5:]
    man = {b.key: (b.size, b.crc32) for b in c.manifest("ds")}
    assert man == {"ds/a.bin": (len(blob), zlib.crc32(blob)),
                   "ds/sub/b.bin": (4, zlib.crc32(b"tiny"))}
    st = c.stats()
    assert st.bytes_stored == len(blob) + 4 and st.crc_failures == 0
    assert st.bytes_served >= len(blob) + n
    c.delete("ds/a.bin")
    assert [b.key for b in c.manifest("ds")] == ["ds/sub/b.bin"]
    with pytest.raises(IOError, match="no such key"):
        c.fetch("ds/a.bin", length=10)
    with pytest.raises(IOError):
        c.delete("ds/a.bin")
    with pytest.raises(IOError, match="bad key"):
        c.put("../escape", b"x")
    syn = c.fetch("synthetic:4099")
    assert len(syn) == 4099 and syn == pd.ShardServer._synthetic(
        "synthetic:4099") == jd.PyShardServer._synthetic("synthetic:4099")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_root_is_served_by_either_daemon(request, tmp_path, writer):
    """What one package's shard server stored (blobs, CRC sidecars), the
    other serves; a blob corrupted on disk fails a full fetch from
    both."""
    reader = "jax" if writer == "port" else "port"
    w = SHARD_SERVERS[writer](request, tmp_path)
    blob = os.urandom(3 << 20)
    c = _shard_client("port", w.addr, request)
    c.put("ds/x.bin", blob)
    w.stop()
    r = SHARD_SERVERS[reader](request, tmp_path)
    c2 = _shard_client("jax", r.addr, request)
    assert c2.fetch("ds/x.bin") == blob
    assert [(b.key, b.crc32) for b in c2.manifest("ds")] == \
        [("ds/x.bin", zlib.crc32(blob))]
    path = tmp_path / "ds" / "x.bin"
    raw = bytearray(path.read_bytes())
    raw[12345] ^= 0xFF
    with open(path, "r+b") as f:  # in place: the sidecar's inode holds
        f.write(raw)
    for kind in ("port", "jax"):
        srv = r if kind == reader else SHARD_SERVERS[kind](request, tmp_path)
        cl = _shard_client("port", srv.addr, request)
        with pytest.raises(IOError, match="stored blob corrupt"):
            cl.fetch("ds/x.bin")
        assert cl.stats().crc_failures == 1


@pytest.mark.parametrize("first", ["port", "jax"])
def test_state_file_resumes_in_either_coordinator(request, tmp_path, first):
    state = str(tmp_path / "coord.state")
    a = COORDINATORS[first](request, lease_ttl_ms=5000, sweep_ms=50,
                            state_file=state)
    c = _coord_client("port", a.addr, request)
    ids = [c.register(f"h:{i}", f"w{i}", 1, True).worker_id for i in range(3)]
    c.deregister(ids[1])
    a.stop()
    second = "jax" if first == "port" else "port"
    b = COORDINATORS[second](request, lease_ttl_ms=5000, sweep_ms=50,
                             state_file=state)
    c2 = _coord_client("jax", b.addr, request)
    m = c2.membership()
    assert m.epoch == 4 and [p.worker_id for p in m.peers] == [1, 3]
    assert c2.register("h:9", "w9", 1, False).worker_id == 4


@pytest.mark.parametrize("agent_pkg", ["port", "jax"])
def test_worker_agents_see_epochs(request, agent_pkg):
    """A worker agent of either package on the other's (or the port's)
    coordinator: a join fires the epoch callback with both peers, a
    deregistering stop fires it with one."""
    daemon = "jax" if agent_pkg == "port" else "port"
    srv = COORDINATORS[daemon](request, lease_ttl_ms=2000, sweep_ms=50)
    seen = []
    if agent_pkg == "port":
        mk = lambda name, cb=None: pc.WorkerAgent(  # noqa: E731
            srv.addr, f"{name}:1", name=name, heartbeat_interval_ms=50,
            on_epoch_change=cb, exclusive_name=True)
    else:
        mk = lambda name, cb=None: jc.WorkerAgent(  # noqa: E731
            srv.addr, f"{name}:1", name=name, heartbeat_interval_ms=50,
            on_epoch_change=cb, prefer_native=False, exclusive_name=True)
    a = mk("a", lambda e, peers: seen.append((e, len(peers)))).start()
    request.addfinalizer(lambda: a.stop(deregister=False))
    assert seen == [(1, 1)]
    b = mk("b").start()
    wait_for(lambda: (2, 2) in seen, what="join epoch")
    b.stop()
    wait_for(lambda: (3, 1) in seen, what="leave epoch")
    with pytest.raises(RuntimeError, match="already held"):
        mk("a").start()


def test_breaker_and_backoff_match_the_reference():
    for rng_seed in range(3):
        a, b = random.Random(rng_seed), random.Random(rng_seed)
        assert [pc.full_jitter_backoff(i, a) for i in range(8)] == \
            [jc.full_jitter_backoff(i, b) for i in range(8)]
    ours = pc.CircuitBreaker("peer-x:1", fail_threshold=3, open_s=60.0)
    theirs = jc.CircuitBreaker("peer-x:1", fail_threshold=3, open_s=60.0)
    for op in ["f", "f", "s", "f", "f", "f", "f", "s"]:
        for br in (ours, theirs):
            br.record_failure() if op == "f" else br.record_success()
        assert (ours.state, ours.allow()) == (theirs.state, theirs.allow())


def test_a_silent_peer_times_out_and_poisons_the_connection():
    """An RPC to a peer that accepts and never answers raises at its
    deadline and closes the connection; a peer that refuses trips the
    breaker into failing fast."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    addr = "127.0.0.1:%d" % lsock.getsockname()[1]
    try:
        t = pc.Transport(addr, rpc_timeout_s=0.2, max_attempts=1,
                         breaker=pc.CircuitBreaker(addr))
        t0 = time.monotonic()
        with pytest.raises(socket.timeout):
            t.call(wire.MSG_MEMBERSHIP_REQ, b"")
        assert time.monotonic() - t0 < 2.0 and t._sock is None
        t.close()
    finally:
        lsock.close()
    br = pc.CircuitBreaker(addr, fail_threshold=2, open_s=60.0)
    for _ in range(2):
        with pytest.raises(ConnectionError):
            pc.Transport(addr, rpc_timeout_s=0.5, breaker=br)
    assert br.state == br.OPEN and not br.allow()


def _read_line(proc, timeout=30.0) -> dict:
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        assert sel.select(timeout), "no line from the child"
        return json.loads(proc.stdout.readline())
    finally:
        sel.close()


@pytest.mark.parametrize("cmd", ["coordinator", "shard-server"])
def test_daemon_commands_bind_port_0_and_exit_0(request, tmp_path, cmd):
    argv = [sys.executable, "-m", "serverless_learn_tpu_torch", cmd,
            "--port", "0", "--host", "127.0.0.1"]
    if cmd == "shard-server":
        argv += ["--root", str(tmp_path)]
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    request.addfinalizer(lambda: pd.stop_process(proc))
    up = _read_line(proc)
    addr = up["addr"]
    assert up["event"] in ("py_coordinator_up", "py_shard_server_up")
    if cmd == "coordinator":
        assert _coord_client("jax", addr, request).register("h:1").ok
    else:
        _shard_client("jax", addr, request).put("k", b"v")
        assert (tmp_path / "k").read_bytes() == b"v"
    # The same port again is refused: a daemon that cannot bind exits.
    busy = subprocess.run(argv[:4] + ["--port", addr.rsplit(":", 1)[1],
                                      "--host", "127.0.0.1"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=60)
    assert busy.returncode != 0 and "Address already in use" in busy.stderr
    assert pd.stop_process(proc) == 0


def test_start_helpers_and_series(request, tmp_path):
    """The start helpers spawn the daemons on port 0 and report where;
    the clients publish the reference's series."""
    from serverless_learn_tpu_torch.telemetry.registry import get_registry

    co = pd.start_coordinator(lease_ttl_ms=1000, sweep_ms=50)
    request.addfinalizer(lambda: pd.stop_process(co))
    ss = pd.start_shard_server(root=str(tmp_path))
    request.addfinalizer(lambda: pd.stop_process(ss))
    agent = pc.WorkerAgent(co.addr, "w:1", name="w",
                           heartbeat_interval_ms=20).start()
    wait_for(lambda: agent._m_hb_rtt.count >= 2, what="heartbeats")
    agent.stop()
    pc.ShardClient(ss.addr).put("x", b"y")
    names = set(get_registry().snapshot())
    assert {"slt_rpc_retries_total", "slt_rpc_timeouts_total",
            "slt_rpc_breaker_state", "slt_rpc_breaker_opens_total",
            "slt_heartbeat_rtt_seconds", "slt_lease_expiries_total",
            "slt_heartbeat_failures_total"} <= names
    assert pd.stop_process(co) == 0 and pd.stop_process(ss) == 0


def test_a_fetch_from_a_stopped_server_raises(request, tmp_path):
    """A shard server stopped between two fetches: the next fetch raises
    (the data plane never reads a lost server as an empty blob)."""
    srv = pd.ShardServer(root=str(tmp_path)).start()
    c = _shard_client("port", srv.addr, request)
    c.put("k", b"abc")
    srv.stop()
    errs = []

    def fetch():
        try:
            c.fetch("k", length=3)
        except (IOError, ConnectionError) as e:
            errs.append(e)

    th = threading.Thread(target=fetch)
    th.start()
    th.join(timeout=WAIT_S)
    assert not th.is_alive() and errs
