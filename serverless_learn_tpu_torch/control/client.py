"""Clients of the control and data planes, the port of
``serverless_learn_tpu/control/client.py``: :class:`Transport` (one
persistent socket per peer), :class:`CoordinatorClient`,
:class:`ShardClient`, :class:`WorkerAgent`, :class:`CircuitBreaker` and
:func:`full_jitter_backoff`, over the port's own codec
(``control/wire.py``).

The transport is always the socket one. The reference's ctypes path
through ``native/bin/libslt.so`` waits (ROADMAP.md queue 1); the port
tries no native library.

The same defences as the reference's between an RPC and a sick network:

* every socket operation has a deadline (``rpc_timeout_s``); a deadline
  hit mid-exchange closes the connection on the spot, so the next call
  re-dials instead of reading a stale frame of the previous exchange;
* idempotent calls retry with capped exponential backoff and full jitter;
* a per-peer circuit breaker: after ``fail_threshold`` consecutive
  transport failures the peer is OPEN for ``open_s`` (calls fail fast),
  then HALF-OPEN admits one probe. One breaker per peer address, process
  wide.

Series, under the reference's names: ``slt_rpc_retries_total``,
``slt_rpc_timeouts_total``, ``slt_rpc_breaker_state{peer}``,
``slt_rpc_breaker_opens_total{peer}``, and the worker agent's
``slt_heartbeat_rtt_seconds``, ``slt_lease_expiries_total`` and
``slt_heartbeat_failures_total``.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from serverless_learn_tpu_torch.control import wire
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.registry import get_registry


class KeyNotFound(FileNotFoundError):
    """The store answered and said no such key or dataset: distinct from a
    transport failure (ConnectionError, timeout), after which the key's
    existence is unknown. Callers probing existence map only this to
    False: a partitioned store must not look empty."""


def full_jitter_backoff(attempt: int, rng: random.Random,
                        base_s: float = 0.05, cap_s: float = 2.0) -> float:
    """Sleep before retry ``attempt`` (0-based): U(0, min(cap, base*2^n))."""
    return rng.uniform(0.0, min(cap_s, base_s * (2.0 ** attempt)))


class CircuitBreaker:
    """Per-peer failure gate. States: 0 closed, 1 half-open, 2 open."""

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(self, peer: str, fail_threshold: int = 5,
                 open_s: float = 2.0):
        self.peer = peer
        self.fail_threshold = fail_threshold
        self.open_s = open_s
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._open_until = 0.0
        reg = get_registry()
        self._g_state = reg.gauge(
            "slt_rpc_breaker_state",
            "per-peer circuit breaker: 0 closed, 1 half-open, 2 open",
            peer=peer)
        self._m_opens = reg.counter(
            "slt_rpc_breaker_opens_total",
            "times a peer's breaker tripped open", peer=peer)
        self._g_state.set(self.CLOSED)

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if (self._state == self.OPEN
                    and time.monotonic() >= self._open_until):
                self._state = self.HALF_OPEN
                self._g_state.set(self._state)
                return True  # exactly one probe; others keep failing fast
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self._g_state.set(self._state)

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.fail_threshold):
                if self._state != self.OPEN:
                    self._m_opens.inc()
                self._state = self.OPEN
                self._open_until = time.monotonic() + self.open_s
                self._g_state.set(self._state)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(peer: str, fail_threshold: int = 5,
                open_s: float = 2.0) -> CircuitBreaker:
    with _breakers_lock:
        b = _breakers.get(peer)
        if b is None:
            b = _breakers[peer] = CircuitBreaker(peer, fail_threshold,
                                                 open_s)
        return b


class Transport:
    """One persistent connection to ``addr`` (``host:port``), framed as
    ``native/framing.h``; one exchange at a time under its lock."""

    def __init__(self, addr: str, rpc_timeout_s: float = 30.0,
                 max_attempts: int = 3, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 breaker: Optional[CircuitBreaker] = None):
        self.addr = addr
        self.rpc_timeout_s = rpc_timeout_s
        self.max_attempts = max(1, max_attempts)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.breaker = breaker if breaker is not None else breaker_for(addr)
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[wire.FrameReader] = None
        self._flow: Optional[int] = None
        reg = get_registry()
        self._m_retries = reg.counter(
            "slt_rpc_retries_total",
            "idempotent RPC resends after a transport failure")
        self._m_timeouts = reg.counter(
            "slt_rpc_timeouts_total",
            "RPCs that hit their deadline (connection poisoned + redialed)")
        try:
            self._dial()
        except OSError:
            self.breaker.record_failure()
            raise ConnectionError(f"cannot connect to {addr}")

    def set_flow(self, flow: Optional[int]):
        """Sticky input backpressure for this connection's future fetches:
        the consumer's prefetch-queue depth (0 = starving; the shard server
        paces well-fed streams while starved ones are in flight). None
        clears the report."""
        with self._lock:
            self._flow = flow

    def _dial(self):
        host, port = self.addr.rsplit(":", 1)
        self._sock = socket.create_connection(
            (host, int(port)), timeout=min(30.0, self.rpc_timeout_s))
        self._sock.settimeout(self.rpc_timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = wire.FrameReader(self._sock)

    def _ensure_sock(self):
        if self._sock is None:
            self._dial()

    def _poison_locked(self):
        """Drop a connection whose stream state is undefined (a deadline
        hit mid-exchange): unread reply bytes would be parsed as the next
        call's reply. The next use re-dials."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = self._reader = None

    def call(self, req_type: int, payload: bytes, idempotent: bool = True):
        """A unary call; returns (reply type, reply payload bytes). Only
        ``idempotent`` requests are resent after a broken connection:
        resending an applied Register would make a ghost worker."""
        if not self.breaker.allow():
            raise ConnectionError(
                f"circuit open to {self.addr} (failing fast)")
        attempts = self.max_attempts if idempotent else 1
        for attempt in range(attempts):
            try:
                # One framed exchange per lock hold; the backoff sleep
                # below is outside it.
                with self._lock:
                    self._ensure_sock()
                    wire.send_frame(self._sock, req_type, payload)
                    mtype, view = self._reader.read()
                    out = (mtype, bytes(view))
                self.breaker.record_success()
                return out
            except socket.timeout:
                self._m_timeouts.inc()
                with self._lock:
                    self._poison_locked()
                self.breaker.record_failure()
                if attempt == attempts - 1:
                    raise
            except (ConnectionError, OSError):
                with self._lock:
                    self._poison_locked()
                self.breaker.record_failure()
                if attempt == attempts - 1:
                    raise
            self._m_retries.inc()
            time.sleep(full_jitter_backoff(
                attempt, self._rng, self.backoff_base_s, self.backoff_cap_s))

    def fetch_into(self, key: str, dst, offset: int = 0,
                   length: int = 0) -> int:
        """Fetch bytes ``[offset, offset + length)`` of ``key`` (length 0:
        to the end) into ``dst`` (a writable buffer); returns the count.
        A deadline hit mid-stream poisons the connection and raises
        IOError."""
        dst = memoryview(dst).cast("B")
        if not self.breaker.allow():
            raise ConnectionError(
                f"circuit open to {self.addr} (failing fast)")
        with self._lock:
            try:
                out = self._fetch_into_locked(key, dst, offset, length)
            except socket.timeout:
                self._m_timeouts.inc()
                self._poison_locked()
                self.breaker.record_failure()
                raise IOError(
                    f"fetch {key!r}: deadline ({self.rpc_timeout_s:g}s) hit "
                    f"mid-stream; connection reset for the next call")
            except (ConnectionError, OSError):
                self._poison_locked()
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
            return out

    def _fetch_into_locked(self, key: str, dst: memoryview, offset: int,
                           length: int) -> int:
        self._ensure_sock()
        req = wire.FetchRequest(key=key, offset=offset, length=length)
        if self._flow is not None:
            req.flow = int(self._flow)
            req.flow_present = True
        ttrace.attach_context(req)
        wire.send_frame(self._sock, wire.MSG_FETCH_REQ, req.encode())
        written = crc = 0
        while True:
            mtype, view = self._reader.read()
            if mtype != wire.MSG_CHUNK:
                raise IOError(f"unexpected frame {mtype}")
            chunk = wire.ChunkMsg.decode(view, zero_copy=True)
            if chunk.error:
                raise IOError(f"fetch {key!r}: {chunk.error}")
            data = chunk.data
            if len(data):
                # CRC over the bytes as served (before truncation), as the
                # server sums the range.
                crc = zlib.crc32(data, crc)
                rel = chunk.offset - offset
                n = min(len(data), len(dst) - rel)
                if n > 0:
                    dst[rel:rel + n] = data[:n]
                    written = max(written, rel + n)
            if chunk.last:
                if chunk.crc_present and chunk.crc32 != crc:
                    raise IOError(f"fetch {key!r}: crc mismatch "
                                  f"(corrupted in transit)")
                return written

    def put(self, key: str, data, crc32: Optional[int] = None) -> None:
        """Store ``data`` (any buffer) under ``key``, streamed as chunks of
        ``wire.CHUNK`` bytes straight from the buffer; ``crc32`` is its
        CRC-32 where the caller has it (else summed here)."""
        if not self.breaker.allow():
            raise ConnectionError(
                f"circuit open to {self.addr} (failing fast)")
        with self._lock:
            try:
                self._put_locked(key, data, crc32)
            except socket.timeout:
                self._m_timeouts.inc()
                self._poison_locked()
                self.breaker.record_failure()
                raise IOError(
                    f"put {key!r}: deadline ({self.rpc_timeout_s:g}s) hit "
                    f"mid-stream; connection reset for the next call")
            except (ConnectionError, OSError):
                self._poison_locked()
                self.breaker.record_failure()
                raise
            self.breaker.record_success()

    def _put_locked(self, key: str, data, crc32: Optional[int]) -> None:
        mv = memoryview(data).cast("B")
        self._ensure_sock()
        req = wire.PutRequest(key=key, total_size=len(mv),
                              crc32=_crc32(mv) if crc32 is None else crc32,
                              crc_present=True)
        ttrace.attach_context(req)
        wire.send_frame(self._sock, wire.MSG_PUT_REQ, req.encode())
        off = 0
        while True:
            n = min(wire.CHUNK, len(mv) - off)
            wire.send_chunk(self._sock, mv[off:off + n], offset=off,
                            last=off + n >= len(mv))
            off += n
            if off >= len(mv):
                break
        _, view = self._reader.read()
        ack = wire.Ack.decode(view)
        if not ack.ok:
            raise IOError(f"put {key!r}: {ack.error}")

    def close(self):
        with self._lock:
            self._poison_locked()


def _crc32(mv: memoryview) -> int:
    """CRC-32 of a buffer, summed in parts so no part is copied."""
    crc, step = 0, 64 << 20
    for i in range(0, len(mv), step):
        crc = zlib.crc32(mv[i:i + step], crc)
    return crc & 0xFFFFFFFF


class CoordinatorClient:
    """Control-plane RPCs. Each request opens a client span and stamps the
    ambient trace context onto the request's ``trace`` field, so the
    daemon's server-side span (``--events-log``) chains under it."""

    def __init__(self, addr: str, rpc_timeout_s: float = 30.0):
        self.t = Transport(addr, rpc_timeout_s=rpc_timeout_s)

    def register(self, addr: str, name: str = "", n_chips: int = 1,
                 exclusive_name: bool = False) -> wire.RegisterReply:
        with ttrace.client_span("rpc/register", peer=self.t.addr):
            req = wire.RegisterRequest(addr=addr, name=name, n_chips=n_chips,
                                       exclusive_name=exclusive_name)
            ttrace.attach_context(req)
            _, raw = self.t.call(wire.MSG_REGISTER_REQ, req.encode(),
                                 idempotent=False)
        return wire.RegisterReply.decode(raw)

    def heartbeat(self, worker_id: int, step: int = 0, metric: float = 0.0,
                  flow: int = 0) -> wire.HeartbeatReply:
        with ttrace.client_span("rpc/heartbeat", peer=self.t.addr):
            req = wire.HeartbeatRequest(worker_id=worker_id, step=step,
                                        metric=metric, flow=flow)
            ttrace.attach_context(req)
            _, raw = self.t.call(wire.MSG_HEARTBEAT_REQ, req.encode())
        return wire.HeartbeatReply.decode(raw)

    def deregister(self, worker_id: int) -> wire.Ack:
        with ttrace.client_span("rpc/deregister", peer=self.t.addr):
            req = wire.DeregisterRequest(worker_id=worker_id)
            ttrace.attach_context(req)
            _, raw = self.t.call(wire.MSG_DEREGISTER_REQ, req.encode())
        return wire.Ack.decode(raw)

    def membership(self) -> wire.MembershipReply:
        _, raw = self.t.call(wire.MSG_MEMBERSHIP_REQ, b"")
        return wire.MembershipReply.decode(raw)

    def stats(self) -> wire.StatsReply:
        """Per-RPC latency accounting and worker flows of the daemon."""
        _, raw = self.t.call(wire.MSG_STATS_REQ, b"")
        return wire.StatsReply.decode(raw)

    def close(self):
        self.t.close()


class ShardClient:
    """Data-plane RPCs: manifest, ranged fetch, put, delete, stats."""

    def __init__(self, addr: str, rpc_timeout_s: float = 30.0):
        self.t = Transport(addr, rpc_timeout_s=rpc_timeout_s)

    def manifest(self, dataset: str = "") -> List[wire.BlobInfo]:
        with ttrace.client_span("rpc/manifest", peer=self.t.addr):
            req = wire.ManifestRequest(dataset=dataset)
            ttrace.attach_context(req)
            _, raw = self.t.call(wire.MSG_MANIFEST_REQ, req.encode())
        rep = wire.ManifestReply.decode(raw)
        if not rep.ok:
            # The server answered with a refusal: an absence verdict, not
            # a transport failure.
            raise KeyNotFound(f"manifest {dataset!r}: {rep.error}")
        return rep.blobs

    def delete(self, key: str) -> None:
        with ttrace.client_span("rpc/delete", peer=self.t.addr):
            req = wire.DeleteRequest(key=key)
            ttrace.attach_context(req)
            _, raw = self.t.call(wire.MSG_DELETE_REQ, req.encode())
        ack = wire.Ack.decode(raw)
        if not ack.ok:
            raise IOError(f"delete {key!r}: {ack.error}")

    def size_of(self, key: str) -> int:
        # One manifest of the key's parent directory (or of the synthetic
        # key itself), never a scan of the whole root.
        dataset = key if key.startswith("synthetic:") else (
            key.rsplit("/", 1)[0] if "/" in key else "")
        for b in self.manifest(dataset):
            if b.key == key:
                return b.size
        raise KeyNotFound(f"unknown key {key!r}")

    def fetch(self, key: str, offset: int = 0, length: int = 0) -> bytes:
        if length == 0:
            length = max(0, self.size_of(key) - offset)
        if length == 0:
            return b""
        buf = np.empty(length, np.uint8)
        n = self.fetch_into(key, buf, offset, length)
        return buf[:n].tobytes()

    def fetch_into(self, key: str, dst, offset: int = 0,
                   length: int = 0) -> int:
        with ttrace.client_span("rpc/fetch", peer=self.t.addr, key=key):
            return self.t.fetch_into(key, dst, offset, length)

    def set_flow(self, flow: Optional[int]):
        """Report this consumer's prefetch depth (0 = starving) on future
        fetches."""
        self.t.set_flow(flow)

    def put(self, key: str, data, crc32: Optional[int] = None) -> None:
        with ttrace.client_span("rpc/put", peer=self.t.addr, key=key,
                                size=len(memoryview(data).cast("B"))):
            self.t.put(key, data, crc32)

    def stats(self) -> wire.StatsReply:
        _, raw = self.t.call(wire.MSG_STATS_REQ, b"")
        return wire.StatsReply.decode(raw)

    def close(self):
        self.t.close()


class WorkerAgent:
    """Background membership agent of one worker process: registers at
    birth, renews its lease on a timer, tracks the membership epoch and
    peer list from heartbeat replies, re-registers if the lease lapsed,
    and calls ``on_epoch_change(epoch, peers)``, the hook the elastic
    controller re-forms on. ``fatal`` is set when the agent may no longer
    take part (its exclusive name went to a live successor while its lease
    was lapsed): the owner must stop."""

    def __init__(self, coordinator_addr: str, advertise_addr: str,
                 name: str = "", n_chips: int = 1,
                 heartbeat_interval_ms: int = 1000,
                 on_epoch_change: Optional[Callable[[int, list], None]] = None,
                 exclusive_name: bool = False):
        # Heartbeats carry a deadline scaled to their cadence: a control
        # RPC hanging for a blob-transfer timeout would blind the failure
        # detector for many missed beats.
        self.client = CoordinatorClient(
            coordinator_addr,
            rpc_timeout_s=max(1.0, 3.0 * heartbeat_interval_ms / 1000.0))
        self.advertise_addr = advertise_addr
        self.name = name
        self.n_chips = n_chips
        self.exclusive_name = exclusive_name
        self.fatal: Optional[str] = None
        self.interval = heartbeat_interval_ms / 1000.0
        self.on_epoch_change = on_epoch_change
        self.worker_id: Optional[int] = None
        self.epoch = -1
        self.peers: List = []
        self.step = 0
        self.metric = 0.0
        self.flow = 0  # prefetch-queue depth; 0 mid-run = input-starved
        self.lease_ttl_ms = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._m_hb_rtt = reg.histogram(
            "slt_heartbeat_rtt_seconds", "coordinator heartbeat round trip")
        self._m_lease_exp = reg.counter(
            "slt_lease_expiries_total",
            "heartbeats refused for a lapsed lease (re-registered)")
        self._m_hb_fail = reg.counter(
            "slt_heartbeat_failures_total", "transport errors, kept trying")

    def start(self) -> "WorkerAgent":
        rep = self.client.register(self.advertise_addr, self.name,
                                   self.n_chips, self.exclusive_name)
        if not rep.ok:
            raise RuntimeError(
                f"registration rejected: {rep.error or 'unknown reason'}")
        self.worker_id = rep.worker_id
        self.lease_ttl_ms = rep.lease_ttl_ms
        self._note_epoch(*self._fresh_membership(rep.epoch))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slt-worker-agent")
        self._thread.start()
        return self

    def _fresh_membership(self, min_epoch: int):
        """A peer list at least as new as ``min_epoch``: a registration
        reply carries an epoch but no peers."""
        m = self.client.membership()
        return max(m.epoch, min_epoch), m.peers

    def _note_epoch(self, epoch: int, peers):
        with self._lock:
            changed = epoch != self.epoch
            self.epoch = epoch
            if peers is not None:
                self.peers = list(peers)
            peers_copy = list(self.peers)
        if changed and self.on_epoch_change is not None:
            self.on_epoch_change(epoch, peers_copy)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                t0 = time.perf_counter()
                rep = self.client.heartbeat(self.worker_id, self.step,
                                            self.metric, self.flow)
                self._m_hb_rtt.observe(time.perf_counter() - t0)
                if not rep.ok:
                    # Lease expired: re-join. The flight recorder dumps
                    # first (when armed): the last records before the
                    # lapse are the post-mortem a lease expiry needs.
                    from serverless_learn_tpu_torch.telemetry import flight

                    flight.maybe_dump("lease-expiry")
                    self._m_lease_exp.inc()
                    reg = self.client.register(self.advertise_addr, self.name,
                                               self.n_chips,
                                               self.exclusive_name)
                    if not reg.ok:
                        # A successor owns the name now: stop, rather than
                        # clobber its checkpoints.
                        self.fatal = reg.error or "re-registration rejected"
                        return
                    self.worker_id = reg.worker_id
                    self.lease_ttl_ms = reg.lease_ttl_ms
                    self._note_epoch(*self._fresh_membership(reg.epoch))
                else:
                    self._note_epoch(rep.epoch, rep.peers)
            except (ConnectionError, OSError):
                self._m_hb_fail.inc()
                continue  # coordinator unreachable for now: keep trying

    def report(self, step: int, metric: float, flow: Optional[int] = None):
        self.step, self.metric = step, metric
        if flow is not None:
            self.flow = flow

    def snapshot(self):
        """(epoch, peers) read together."""
        with self._lock:
            return self.epoch, list(self.peers)

    def stop(self, deregister: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if deregister and self.worker_id is not None:
            try:
                self.client.deregister(self.worker_id)
            except (ConnectionError, OSError):
                pass
        self.client.close()
