"""The coordinator and the shard server, the port of
``serverless_learn_tpu/control/py_daemons.py`` and of the start helpers of
``serverless_learn_tpu/control/daemons.py``, on the port's wire codec
(``control/wire.py``).

The same wire, semantics and durability as the reference's daemons:

* :class:`Coordinator`: lease-based register / heartbeat / deregister,
  exclusive names, a sweep that evicts lapsed leases, one membership
  epoch bump per change, an atomic (tmp + rename) ``--state_file`` that a
  restarted daemon resumes from (each restored worker gets one lease of
  grace), and per-worker flows in its stats;
* :class:`ShardServer`: manifest / ranged fetch / put / delete / stats over
  a blob root, keys as paths under it, puts written to a temporary file
  and renamed into place, a CRC-32 sidecar (``<key>.slt-crc``, with the
  blob's inode) per put, verified on every full-blob fetch, a CRC
  terminator on every fetch stream, ``synthetic:<bytes>`` keys, refusal
  of path traversal, error chunks instead of dropped connections, and
  flow-aware pacing of well-fed streams while a starved one is in flight.

So a root written by either package's shard server is served by the
other. One difference in the port's favour: a put is written to its
temporary file chunk by chunk and a fetch reads its range chunk by chunk,
so a multi-GB checkpoint never sits in the daemon's memory; a full-blob
fetch checks the sidecar against the CRC of the bytes it streamed and
ends with an error chunk on a mismatch.

Both daemons append a span record per traced RPC (a request carrying
``trace``) to ``--events_log``, in the shape ``telemetry/tracing.py``
emits. The native daemons and the coordinator's SWIM gossip seed
(``--gossip``) wait (ROADMAP.md queue 1).

    python -m serverless_learn_tpu_torch.control.daemons coordinator \\
        --port 0 --lease_ttl_ms 2000 --sweep_ms 100
    python -m serverless_learn_tpu_torch.control.daemons shard-server \\
        --port 0 --root DIR

Each prints one JSON line with its bound address, then serves until
SIGTERM or SIGINT (exit 0). A port that cannot be bound is an error.
"""

from __future__ import annotations

import json
import os
import queue
import selectors
import socket
import subprocess
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional

from serverless_learn_tpu_torch.control import wire

_READ = 1 << 20  # bytes a fetch reads from disk at a time
_SINK_WAIT_S = 300.0  # the longest a put waits on its writer thread


def _now_ms() -> int:
    return int(time.monotonic() * 1000)


class _RpcStats:
    """Per message type: count, total and max microseconds (the overflow
    slot ``wire.K_MAX_MSG_TYPE`` takes the larger tags)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[int, list] = {}

    def record(self, msg_type: int, us: float):
        tag = min(msg_type, wire.K_MAX_MSG_TYPE)
        with self._lock:
            s = self._stats.setdefault(tag, [0, 0, 0])
            s[0] += 1
            s[1] += int(us)
            s[2] = max(s[2], int(us))

    def fill(self, rep: wire.StatsReply):
        with self._lock:
            for tag in sorted(self._stats):
                count, total, mx = self._stats[tag]
                rep.rpc.append(wire.RpcStat(msg_type=tag, count=count,
                                            total_us=total, max_us=mx))


class _SpanLog:
    """JSONL server-side span sink (the record shape of tracing.py)."""

    def __init__(self, path: Optional[str], role: str):
        self.path = path
        self.node = f"{role}-{os.getpid()}"
        self._lock = threading.Lock()
        self._seq = 0

    def emit(self, msg_type: int, trace_id: str, parent_id: str,
             t0_unix: float, duration_s: float):
        if not self.path or not trace_id or not parent_id:
            return
        name = wire.MSG_TYPE_NAMES.get(msg_type, "other")
        with self._lock:
            self._seq += 1
            seq = self._seq
        rec = {"event": "span", "span": f"rpc/{name}", "node": self.node,
               "trace_id": trace_id[:128],
               "span_id": f"srv-{os.getpid():x}-{seq}",
               "parent_id": parent_id[:128],
               "t0_unix_s": round(t0_unix, 6),
               "duration_s": round(duration_s, 6)}
        try:
            with self._lock, open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass


def _trace_of(req) -> tuple:
    """(trace_id, parent span_id) of a request's optional trace field."""
    t = getattr(req, "trace", None)
    return (t.trace_id, t.span_id) if t is not None else ("", "")


class _FramedServer:
    """Accept loop and one thread per connection over the 5-byte frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))  # a port in use raises: no fallback
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self.addr = f"{host}:{self.port}"
        self._stop = threading.Event()
        self._accept: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self.rpc_stats = _RpcStats()

    def start(self):
        self._accept = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="slt-accept")
        self._accept.start()
        return self

    def serve_forever(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn_safe, args=(conn,),
                             daemon=True, name="slt-conn").start()

    def _serve_conn_safe(self, conn):
        reader = wire.FrameReader(conn)
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        mtype, payload = reader.read()
                    except (ConnectionError, OSError):
                        return
                    t0 = time.perf_counter()
                    try:
                        self.handle(conn, reader, mtype, payload)
                    finally:
                        self.rpc_stats.record(
                            mtype, (time.perf_counter() - t0) * 1e6)
        except Exception:
            pass  # one bad connection must never kill the daemon
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def handle(self, conn, reader, mtype: int, payload: memoryview):
        raise NotImplementedError

    def _unknown(self, conn):
        wire.send_frame(conn, wire.MSG_ACK, wire.Ack(
            ok=False, error="unknown message type").encode())

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._accept is not None:
            self._accept.join(timeout=5)


class Coordinator(_FramedServer):
    """The membership daemon (module docstring)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 lease_ttl_ms: int = 5000, sweep_ms: int = 500,
                 state_file: Optional[str] = None,
                 events_log: Optional[str] = None):
        super().__init__(host, port)
        self.lease_ttl_ms = lease_ttl_ms
        self.sweep_ms = sweep_ms
        self.state_file = state_file
        self.span_log = _SpanLog(events_log, "coordinator")
        self._mu = threading.Lock()
        self._workers: Dict[int, dict] = {}
        self._next_id = 1
        self._epoch = 0
        self._load_state()
        self._sweeper = threading.Thread(target=self._sweep_loop, daemon=True,
                                         name="slt-sweep")
        self._sweeper.start()

    # -- durability --
    def _save_state_locked(self):
        if not self.state_file:
            return
        st = wire.CoordinatorState(next_id=self._next_id, epoch=self._epoch)
        self._fill_peers(st.peers)
        tmp = self.state_file + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(st.encode())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_file)
        except OSError:
            pass

    def _load_state(self):
        if not self.state_file or not os.path.exists(self.state_file):
            return
        try:
            with open(self.state_file, "rb") as f:
                st = wire.CoordinatorState.decode(f.read())
        except (OSError, ValueError):
            return
        self._next_id = st.next_id or 1
        self._epoch = st.epoch
        seen = _now_ms()  # one lease of grace, as the native daemon grants
        for p in st.peers:
            self._workers[p.worker_id] = {
                "addr": p.addr, "name": p.name, "n_chips": p.n_chips,
                "last_seen": seen, "step": 0, "metric": 0.0, "flow": 0}

    # -- membership --
    def _fill_peers(self, peers: list):
        for wid, rec in sorted(self._workers.items()):
            peers.append(wire.PeerInfo(worker_id=wid, addr=rec["addr"],
                                       name=rec["name"],
                                       n_chips=rec["n_chips"]))

    def _sweep_loop(self):
        while not self._stop.wait(self.sweep_ms / 1000.0):
            cutoff = _now_ms() - self.lease_ttl_ms
            with self._mu:
                dead = [wid for wid, rec in self._workers.items()
                        if rec["last_seen"] < cutoff]
                for wid in dead:
                    del self._workers[wid]
                if dead:
                    self._epoch += 1
                    self._save_state_locked()

    def stop(self):
        super().stop()
        self._sweeper.join(timeout=5)

    # -- RPC dispatch --
    def handle(self, conn, reader, mtype: int, payload: memoryview):
        span_t0 = time.time()
        trace = ("", "")
        if mtype == wire.MSG_REGISTER_REQ:
            req = wire.RegisterRequest.decode(payload)
            trace = _trace_of(req)
            rep = self._register(req)
            wire.send_frame(conn, wire.MSG_REGISTER_REP, rep.encode())
        elif mtype == wire.MSG_HEARTBEAT_REQ:
            req = wire.HeartbeatRequest.decode(payload)
            trace = _trace_of(req)
            rep = wire.HeartbeatReply()
            with self._mu:
                rec = self._workers.get(req.worker_id)
                rep.epoch = self._epoch
                if rec is not None:
                    rec.update(last_seen=_now_ms(), step=req.step,
                               metric=req.metric, flow=req.flow)
                    rep.ok = True
                    self._fill_peers(rep.peers)
                # else: lease expired, ok=False tells it to re-register
            wire.send_frame(conn, wire.MSG_HEARTBEAT_REP, rep.encode())
        elif mtype == wire.MSG_DEREGISTER_REQ:
            req = wire.DeregisterRequest.decode(payload)
            trace = _trace_of(req)
            ack = wire.Ack()
            with self._mu:
                if req.worker_id in self._workers:
                    del self._workers[req.worker_id]
                    self._epoch += 1
                    self._save_state_locked()
                    ack.ok = True
                else:
                    ack.error = "unknown worker"
            wire.send_frame(conn, wire.MSG_ACK, ack.encode())
        elif mtype == wire.MSG_MEMBERSHIP_REQ:
            rep = wire.MembershipReply()
            with self._mu:
                rep.epoch = self._epoch
                self._fill_peers(rep.peers)
            wire.send_frame(conn, wire.MSG_MEMBERSHIP_REP, rep.encode())
        elif mtype == wire.MSG_STATS_REQ:
            rep = wire.StatsReply()
            self.rpc_stats.fill(rep)
            with self._mu:
                for wid, rec in sorted(self._workers.items()):
                    rep.flows.append(wire.WorkerFlow(
                        worker_id=wid, flow=rec["flow"], step=rec["step"],
                        metric=rec["metric"]))
            wire.send_frame(conn, wire.MSG_STATS_REP, rep.encode())
        else:
            self._unknown(conn)
        if trace[0]:
            self.span_log.emit(mtype, trace[0], trace[1], span_t0,
                               time.time() - span_t0)

    def _register(self, req: wire.RegisterRequest) -> wire.RegisterReply:
        rep = wire.RegisterReply()
        with self._mu:
            holder = next((wid for wid, rec in self._workers.items()
                           if req.exclusive_name
                           and rec["name"] == req.name), None)
            rep.epoch = self._epoch
            if holder is not None:
                rep.error = (
                    f"name '{req.name}' already held by live worker "
                    f"{holder}; pick a unique name (it is the checkpoint "
                    f"namespace), or wait out the holder's lease")
                return rep
            wid = self._next_id
            self._next_id += 1
            self._workers[wid] = {
                "addr": req.addr, "name": req.name, "n_chips": req.n_chips,
                "last_seen": _now_ms(), "step": 0, "metric": 0.0, "flow": 0}
            self._epoch += 1
            self._save_state_locked()
            rep.ok = True
            rep.worker_id = wid
            rep.epoch = self._epoch
            rep.lease_ttl_ms = self.lease_ttl_ms
        return rep


class _ChunkSink:
    """The CRC-32 and file writes of one put's chunks, on a thread of its
    own, so they overlap the receipt of the next chunk: ``depth`` chunk
    buffers circulate between the receiving thread (:meth:`buffer`,
    :meth:`submit`) and the writer."""

    def __init__(self, out, depth: int = 3):
        self.out = out
        self.crc = self.received = 0
        self.error = ""
        self._free: queue.Queue = queue.Queue()
        for _ in range(depth):
            self._free.put(bytearray(wire.CHUNK + 64))
        self._work: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slt-put-sink")
        self._thread.start()

    def buffer(self) -> bytearray:
        return self._free.get(timeout=_SINK_WAIT_S)

    def submit(self, buf: bytearray, data: memoryview):
        self._work.put((buf, data))

    def _run(self):
        while True:
            item = self._work.get()
            if item is None:
                return
            buf, data = item
            if len(data):
                self.crc = zlib.crc32(data, self.crc)
                self.received += len(data)
                if self.out is not None and not self.error:
                    try:
                        self.out.write(data)
                    except OSError as e:
                        self.error = f"write failed: {e}"
            self._free.put(buf)

    def finish(self):
        """Waits for the chunks submitted; (crc, bytes, write error)."""
        if self._thread.is_alive():
            self._work.put(None)
            self._thread.join(timeout=_SINK_WAIT_S)
        return self.crc, self.received, self.error


class _ChunkSource:
    """A fetch's range read from its file (or a synthetic blob) and its
    CRC-32 summed on a thread of its own, ahead of the sends: iterating
    yields (buffer, offset, bytes) in order; :meth:`release` hands a
    buffer back for the next read. ``crc`` is final once the iteration
    ends."""

    def __init__(self, f, syn: Optional[bytes], start: int, end: int,
                 depth: int = 3):
        self.crc = 0
        self._f, self._syn, self._start, self._end = f, syn, start, end
        self._free: queue.Queue = queue.Queue()
        if f is not None:
            f.seek(start)
            for _ in range(depth):
                self._free.put(bytearray(min(_READ, max(end - start, 1))))
        self._ready: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slt-fetch-source")
        self._thread.start()

    def _buffer(self) -> Optional[bytearray]:
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _run(self):
        try:
            off = self._start
            while off < self._end:
                n = min(_READ, self._end - off)
                if self._syn is not None:
                    buf, part = None, memoryview(self._syn)[off:off + n]
                else:
                    buf = self._buffer()
                    if buf is None:
                        return  # the fetch was abandoned
                    part = memoryview(buf)[:n]
                    if self._f.readinto(part) != n:
                        raise OSError("short read")
                self.crc = zlib.crc32(part, self.crc)
                self._ready.put((buf, off, part))
                off += n
            self._ready.put(None)
        except OSError as e:
            self._ready.put(e)

    def __iter__(self):
        while True:
            item = self._ready.get(timeout=_SINK_WAIT_S)
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def release(self, buf: Optional[bytearray]):
        if buf is not None:
            self._free.put(buf)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=_SINK_WAIT_S)


class ShardServer(_FramedServer):
    """The data-plane daemon (module docstring)."""

    SIDECAR = ".slt-crc"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 root: Optional[str] = None,
                 events_log: Optional[str] = None):
        super().__init__(host, port)
        self.root = root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "slt-shards")
        os.makedirs(self.root, exist_ok=True)
        self.span_log = _SpanLog(events_log, "shard-server")
        self._mu = threading.Lock()
        self.bytes_served = 0
        self.bytes_stored = 0
        self.active_streams = 0
        self.crc_failures = 0
        self.throttled_chunks = 0
        self.starved_streams_served = 0
        self._starved_in_flight = 0
        self._put_locks: Dict[str, threading.Lock] = {}

    # -- keys --
    def _key_ok(self, key: str) -> bool:
        if not key or key.startswith("/") or ".." in key.split("/"):
            return False
        return not key.endswith(self.SIDECAR)  # reserved namespace

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def _sidecar(self, key: str) -> str:
        return self._path(key) + self.SIDECAR

    @staticmethod
    def _synthetic(key: str) -> Optional[bytes]:
        """``synthetic:<bytes>``: a deterministic pseudo-random blob made
        on demand (the native daemon's contract)."""
        if not key.startswith("synthetic:"):
            return None
        try:
            n = int(key.split(":", 1)[1])
        except ValueError:
            return None
        out = bytearray()
        x = zlib.crc32(key.encode()) or 1
        while len(out) < n:
            x = (x * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
            out += x.to_bytes(8, "little")
        return bytes(out[:n])

    # -- RPC dispatch --
    def handle(self, conn, reader, mtype: int, payload: memoryview):
        span_t0 = time.time()
        trace = ("", "")
        if mtype == wire.MSG_MANIFEST_REQ:
            req = wire.ManifestRequest.decode(payload)
            trace = _trace_of(req)
            self._handle_manifest(conn, req)
        elif mtype == wire.MSG_FETCH_REQ:
            req = wire.FetchRequest.decode(payload)
            trace = _trace_of(req)
            self._handle_fetch(conn, req)
        elif mtype == wire.MSG_PUT_REQ:
            req = wire.PutRequest.decode(payload)
            trace = _trace_of(req)
            self._handle_put(conn, reader, req)
        elif mtype == wire.MSG_DELETE_REQ:
            req = wire.DeleteRequest.decode(payload)
            trace = _trace_of(req)
            ack = wire.Ack()
            if not self._key_ok(req.key):
                ack.error = "bad key"
            else:
                try:
                    os.unlink(self._path(req.key))
                    try:
                        os.unlink(self._sidecar(req.key))
                    except OSError:
                        pass
                    ack.ok = True
                except OSError:
                    ack.error = f"no such key: {req.key}"
            wire.send_frame(conn, wire.MSG_ACK, ack.encode())
        elif mtype == wire.MSG_STATS_REQ:
            rep = wire.StatsReply()
            with self._mu:
                rep.bytes_served = self.bytes_served
                rep.bytes_stored = self.bytes_stored
                rep.active_streams = self.active_streams
                rep.crc_failures = self.crc_failures
                rep.throttled_chunks = self.throttled_chunks
                rep.starved_streams_served = self.starved_streams_served
            self.rpc_stats.fill(rep)
            wire.send_frame(conn, wire.MSG_STATS_REP, rep.encode())
        else:
            self._unknown(conn)
        if trace[0]:
            self.span_log.emit(mtype, trace[0], trace[1], span_t0,
                               time.time() - span_t0)

    def _stored_crc(self, key: str) -> Optional[int]:
        try:
            with open(self._sidecar(key)) as f:
                blob = json.load(f)
            st = os.stat(self._path(key))
            if blob.get("inode") not in (None, st.st_ino):
                return None  # a sidecar paired with another blob
            return int(blob["crc32"]) & 0xFFFFFFFF
        except (OSError, ValueError, KeyError):
            return None

    def _handle_manifest(self, conn, req):
        rep = wire.ManifestReply()
        syn = self._synthetic(req.dataset)
        if syn is not None:
            rep.ok = True
            rep.blobs.append(wire.BlobInfo(key=req.dataset, size=len(syn),
                                           crc32=zlib.crc32(syn)))
        elif not self._key_ok(req.dataset or "x"):
            rep.error = "bad dataset"
        else:
            base = (os.path.join(self.root, req.dataset) if req.dataset
                    else self.root)
            rep.ok = True
            if os.path.isdir(base):
                for dirpath, _, files in sorted(os.walk(base)):
                    for fn in sorted(files):
                        if fn.endswith(self.SIDECAR) or fn.endswith(".tmp"):
                            continue
                        full = os.path.join(dirpath, fn)
                        key = os.path.relpath(full, self.root)
                        rep.blobs.append(wire.BlobInfo(
                            key=key, size=os.path.getsize(full),
                            crc32=self._stored_crc(key) or 0))
        wire.send_frame(conn, wire.MSG_MANIFEST_REP, rep.encode())

    def _error_chunk(self, conn, msg: str, offset: int = 0):
        wire.send_chunk(conn, error=msg, offset=offset, last=True)

    def _handle_fetch(self, conn, req):
        if not self._key_ok(req.key) and not req.key.startswith("synthetic:"):
            self._error_chunk(conn, "bad key")
            return
        syn = self._synthetic(req.key)
        f = None
        if syn is not None:
            size = len(syn)
        else:
            try:
                f = open(self._path(req.key), "rb")
            except OSError:
                self._error_chunk(conn, f"no such key: {req.key}")
                return
            size = os.fstat(f.fileno()).st_size
        start = min(req.offset, size)
        end = size if req.length == 0 else min(start + req.length, size)
        # A full-blob fetch is held to the put-time sidecar: silent disk
        # corruption becomes an error chunk.
        want = (self._stored_crc(req.key)
                if f is not None and start == 0 and end == size else None)
        starved = bool(req.flow_present) and req.flow == 0
        with self._mu:
            self.active_streams += 1
            if starved:
                self.starved_streams_served += 1
                self._starved_in_flight += 1
        source = _ChunkSource(f, syn, start, end)
        try:
            for buf, off, part in source:
                wire.send_chunk(conn, part, offset=off)
                source.release(buf)
                if not starved and off + len(part) < end:
                    self._pace(req)
            crc, off = source.crc, end
            if want is not None and crc != want:
                with self._mu:
                    self.crc_failures += 1
                self._error_chunk(conn, f"stored blob corrupt: {req.key}",
                                  off)
                return
            wire.send_chunk(conn, offset=off, last=True, crc32=crc,
                            crc_present=True)
            with self._mu:
                self.bytes_served += end - start
        finally:
            source.close()
            if f is not None:
                f.close()
            with self._mu:
                self.active_streams -= 1
                if starved:
                    self._starved_in_flight -= 1

    def _pace(self, req):
        """A well-fed stream (deeper prefetch queue, longer pause) yields
        bandwidth between chunks while a starved stream is in flight."""
        with self._mu:
            starving_now = self._starved_in_flight > 0
            if starving_now:
                self.throttled_chunks += 1
        if starving_now:
            depth = req.flow if req.flow_present else 1
            time.sleep(min(0.002 * max(1, depth), 0.02))

    def _handle_put(self, conn, reader, req):
        key_ok = self._key_ok(req.key)
        path = self._path(req.key)
        tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
        out = None
        error = "" if key_ok else "bad key"
        if key_ok:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                out = open(tmp, "wb")
            except OSError as e:
                error = f"write failed: {e}"
        sink = _ChunkSink(out)
        try:
            while True:  # drain the stream even for a doomed put
                buf = sink.buffer()
                mtype, payload = reader.read(buf)
                if mtype != wire.MSG_CHUNK:
                    sink.finish()
                    wire.send_frame(conn, wire.MSG_ACK, wire.Ack(
                        error="expected chunk").encode())
                    return
                chunk = wire.ChunkMsg.decode(payload, zero_copy=True)
                sink.submit(buf, chunk.data)
                if chunk.last:
                    break
            crc, received, write_error = sink.finish()
            error = error or write_error
            if not error and req.crc_present and crc != req.crc32:
                with self._mu:
                    self.crc_failures += 1
                error = "crc mismatch"
            if not error:
                error = self._commit(req.key, out, tmp, path, crc)
                out = None
                if not error:
                    with self._mu:
                        self.bytes_stored += received
        finally:
            sink.finish()
            if out is not None:
                out.close()
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        wire.send_frame(conn, wire.MSG_ACK,
                        wire.Ack(ok=not error, error=error).encode())

    def _commit(self, key: str, out, tmp: str, path: str, crc: int) -> str:
        """fsync and rename the temporary file into place, then its
        sidecar; returns an error or ""."""
        with self._mu:
            lk = self._put_locks.setdefault(key, threading.Lock())
        try:
            out.flush()
            os.fsync(out.fileno())
            out.close()
            with lk:
                os.replace(tmp, path)
                st = os.stat(path)
                side = self._sidecar(key)
                with open(side + ".tmp", "w") as f:
                    json.dump({"crc32": crc, "inode": st.st_ino}, f)
                os.replace(side + ".tmp", side)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return f"write failed: {e}"
        return ""


def _run_until_sigterm(srv) -> int:
    """Serve until SIGTERM or SIGINT; exit 0 (durable state was saved at
    every change)."""
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    srv.start()
    try:
        while not stop.wait(0.1):
            pass
    finally:
        srv.stop()
    return 0


def main_coordinator(argv) -> int:
    """The coordinator's entry, with the native daemon's flags."""
    import argparse

    p = argparse.ArgumentParser(prog="coordinator")
    p.add_argument("--port", type=int, default=50052)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--lease_ttl_ms", type=int, default=5000)
    p.add_argument("--sweep_ms", type=int, default=500)
    p.add_argument("--state_file", default=None)
    p.add_argument("--events_log", default=None)
    args = p.parse_args(argv)
    srv = Coordinator(host=args.host, port=args.port,
                      lease_ttl_ms=args.lease_ttl_ms, sweep_ms=args.sweep_ms,
                      state_file=args.state_file, events_log=args.events_log)
    print(json.dumps({"event": "py_coordinator_up", "addr": srv.addr}),
          flush=True)
    return _run_until_sigterm(srv)


def main_shard_server(argv) -> int:
    """The shard server's entry, with the native daemon's flags."""
    import argparse

    p = argparse.ArgumentParser(prog="shard-server")
    p.add_argument("--port", type=int, default=50053)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--root", default=None)
    p.add_argument("--events_log", default=None)
    args = p.parse_args(argv)
    srv = ShardServer(host=args.host, port=args.port, root=args.root,
                      events_log=args.events_log)
    print(json.dumps({"event": "py_shard_server_up", "addr": srv.addr,
                      "root": srv.root}), flush=True)
    return _run_until_sigterm(srv)


# -- start helpers (``serverless_learn_tpu/control/daemons.py``) -------------

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


_UP_WAIT_S = 30.0  # the longest a start helper waits for the address line


def _spawn(role: str, args: List[str]) -> subprocess.Popen:
    """A daemon child; waits (at most ``_UP_WAIT_S``) for its address line
    and returns the Popen with ``.addr`` set to ``127.0.0.1:<port>``. A
    child that exits or stays silent is killed and raises."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "serverless_learn_tpu_torch.control.daemons",
         role, "--host", "127.0.0.1"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        line = b""
        if sel.select(_UP_WAIT_S):
            line = proc.stdout.readline()
    finally:
        sel.close()
    try:
        up = json.loads(line)
        proc.addr = "127.0.0.1:%s" % up["addr"].rsplit(":", 1)[1]
    except (ValueError, KeyError):
        proc.kill()
        proc.wait(timeout=10)
        raise TimeoutError(f"{role} did not come up in {_UP_WAIT_S:g}s "
                           f"(rc={proc.returncode}, said {line[:200]!r})")
    return proc


def start_coordinator(port: int = 0, lease_ttl_ms: int = 5000,
                      sweep_ms: int = 200, state_file: Optional[str] = None,
                      events_log: Optional[str] = None) -> subprocess.Popen:
    """A coordinator child process (port 0 picks a free port); its address
    is ``proc.addr``."""
    args = ["--port", str(port), "--lease_ttl_ms", str(lease_ttl_ms),
            "--sweep_ms", str(sweep_ms)]
    if state_file:
        args += ["--state_file", state_file]
    if events_log:
        args += ["--events_log", events_log]
    return _spawn("coordinator", args)


def start_shard_server(port: int = 0, root: Optional[str] = None,
                       events_log: Optional[str] = None) -> subprocess.Popen:
    """A shard-server child process over ``root``; its address is
    ``proc.addr``."""
    args = ["--port", str(port)]
    if root:
        args += ["--root", root]
    if events_log:
        args += ["--events_log", events_log]
    return _spawn("shard-server", args)


def stop_process(proc: subprocess.Popen, timeout: float = 10.0) -> int:
    """SIGTERM, then SIGKILL after ``timeout`` s; returns the exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout)
    if proc.stdout is not None:
        proc.stdout.close()
    return proc.returncode


if __name__ == "__main__":
    role = sys.argv[1] if len(sys.argv) > 1 else ""
    if role == "coordinator":
        sys.exit(main_coordinator(sys.argv[2:]))
    if role == "shard-server":
        sys.exit(main_shard_server(sys.argv[2:]))
    print("usage: python -m serverless_learn_tpu_torch.control.daemons "
          "{coordinator|shard-server} [flags]", file=sys.stderr)
    sys.exit(2)
