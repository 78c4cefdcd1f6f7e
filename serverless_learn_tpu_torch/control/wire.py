"""The wire of the control and data planes: the port's own codec of
``native/proto/slt.proto`` (proto3) and the length-prefixed framing of
``native/framing.h``, with no protobuf runtime.

A message class lists its fields as ``(number, name, kind)``;
:meth:`Message.encode` writes the bytes protobuf's own serializer writes
for the same values: fields in field-number order, proto3 defaults left
out (0, ``False``, ``""``, ``b""``, a ``double`` whose bits are all zero;
-0.0 is written), ``double`` as fixed64, unsigned and signed varints (a
negative ``int32``/``int64`` takes ten bytes), repeated scalars packed, and
a nested message only when it is set (``None`` is absent). Decoding skips
fields it does not know, so a peer with a newer schema stays readable.

A frame is ``[u32 big-endian payload length][u8 message type][payload]``,
at most :data:`MAX_FRAME` bytes of payload. Bulk data rides ``ChunkMsg``
frames of at most :data:`CHUNK` bytes: :func:`send_chunk` writes one
without copying its data into the frame, and :class:`FrameReader` reads
frames into one reused buffer, so a multi-GB transfer moves through
bounded memory.
"""

from __future__ import annotations

import operator
import struct
from typing import Dict, NamedTuple, Optional, Tuple

# Message type tags: ``native/framing.h`` MsgType.
MSG_REGISTER_REQ = 1
MSG_REGISTER_REP = 2
MSG_HEARTBEAT_REQ = 3
MSG_HEARTBEAT_REP = 4
MSG_DEREGISTER_REQ = 5
MSG_MEMBERSHIP_REQ = 6
MSG_MEMBERSHIP_REP = 7
MSG_ACK = 8
MSG_MANIFEST_REQ = 20
MSG_MANIFEST_REP = 21
MSG_FETCH_REQ = 22
MSG_CHUNK = 23
MSG_PUT_REQ = 24
MSG_STATS_REQ = 25
MSG_STATS_REP = 26
MSG_DELETE_REQ = 27

# RpcStat slots of the daemons' stats (``native/rpc_stats.h``): tags above
# K_MAX_MSG_TYPE share the overflow slot.
K_MAX_MSG_TYPE = 32
MSG_TYPE_NAMES = {
    MSG_REGISTER_REQ: "register", MSG_HEARTBEAT_REQ: "heartbeat",
    MSG_DEREGISTER_REQ: "deregister", MSG_MEMBERSHIP_REQ: "membership",
    MSG_MANIFEST_REQ: "manifest", MSG_FETCH_REQ: "fetch",
    MSG_PUT_REQ: "put", MSG_STATS_REQ: "stats", MSG_DELETE_REQ: "delete",
    K_MAX_MSG_TYPE: "other",
}

MAX_FRAME = 64 << 20  # payload cap of one frame
CHUNK = 1 << 20       # data bytes of one ChunkMsg

STRING, BYTES, BOOL, UINT32, UINT64, INT32, INT64, DOUBLE, MESSAGE = (
    "string", "bytes", "bool", "uint32", "uint64", "int32", "int64",
    "double", "message")
_VARINT = (BOOL, UINT32, UINT64, INT32, INT64)
_DEFAULTS = {STRING: "", BYTES: b"", BOOL: False, UINT32: 0, UINT64: 0,
             INT32: 0, INT64: 0, DOUBLE: 0.0}
_WIRE_TYPE = {BOOL: 0, UINT32: 0, UINT64: 0, INT32: 0, INT64: 0,
              DOUBLE: 1, STRING: 2, BYTES: 2, MESSAGE: 2}
_LIMIT = {UINT32: 1 << 32, UINT64: 1 << 64, INT32: 1 << 31, INT64: 1 << 63}
_MASK64 = (1 << 64) - 1
_DBL = struct.Struct("<d")


class Field(NamedTuple):
    number: int
    name: str
    kind: str
    repeated: bool = False
    message: Optional[type] = None


# -- varints -----------------------------------------------------------------

def encode_varint(value: int) -> bytes:
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_varint(buf, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at ``pos``."""
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def _check_int(f: Field, v) -> int:
    if isinstance(v, bool):
        raise TypeError(f"{f.name}: {v!r} is not an integer")
    try:
        v = operator.index(v)  # numpy integers too
    except TypeError:
        raise TypeError(f"{f.name}: {v!r} is not an integer") from None
    lim = _LIMIT[f.kind]
    lo = 0 if f.kind in (UINT32, UINT64) else -lim
    hi = lim if f.kind in (UINT32, UINT64) else lim
    if not lo <= v < hi:
        raise ValueError(f"{f.name}: {v} out of range for {f.kind}")
    return v


def _scalar_payload(f: Field, v) -> bytes:
    """The bytes of one scalar value after its key."""
    if f.kind == DOUBLE:
        return _DBL.pack(float(v))
    if f.kind == BOOL:
        return b"\x01" if v else b"\x00"
    if f.kind in _VARINT:
        return encode_varint(_check_int(f, v))
    data = v.encode("utf-8") if f.kind == STRING else bytes(v)
    return encode_varint(len(data)) + data


def _is_default(f: Field, v) -> bool:
    if f.kind == DOUBLE:
        return _DBL.pack(float(v)) == b"\0" * 8
    return not v


def _from_varint(kind: str, v: int):
    if kind == BOOL:
        return v != 0
    if kind == UINT32:
        return v & 0xFFFFFFFF
    if kind == INT32:
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >> 31 else v
    if kind == INT64:
        return v - (1 << 64) if v >> 63 else v
    return v


# -- messages ----------------------------------------------------------------

class Message:
    """A proto3 message: one attribute per field (repeated fields are
    lists, a nested message is ``None`` until set)."""

    FIELDS: Tuple[Field, ...] = ()
    _BY_NUMBER: Dict[int, Field] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.FIELDS = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}

    def __init__(self, **values):
        for f in self.FIELDS:
            if f.repeated:
                setattr(self, f.name, list(values.pop(f.name, ())))
            elif f.kind == MESSAGE:
                setattr(self, f.name, values.pop(f.name, None))
            else:
                setattr(self, f.name, values.pop(f.name, _DEFAULTS[f.kind]))
        if values:
            raise TypeError(f"{type(self).__name__} has no field(s) "
                            f"{sorted(values)}")

    # -- encode --
    def encode(self) -> bytes:
        out = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            key = encode_varint(f.number << 3 | _WIRE_TYPE[f.kind])
            if f.kind == MESSAGE:
                for m in (v if f.repeated else ([] if v is None else [v])):
                    body = m.encode()
                    out += [key, encode_varint(len(body)), body]
            elif f.repeated:
                if not v:
                    continue
                if f.kind in (STRING, BYTES):
                    for x in v:
                        out += [key, _scalar_payload(f, x)]
                else:  # packed
                    body = b"".join(_scalar_payload(f, x) for x in v)
                    out += [encode_varint(f.number << 3 | 2),
                            encode_varint(len(body)), body]
            elif not _is_default(f, v):
                out += [key, _scalar_payload(f, v)]
        return b"".join(out)

    SerializeToString = encode

    # -- decode --
    @classmethod
    def decode(cls, buf, zero_copy: bool = False):
        """A message from its bytes; unknown fields are skipped. With
        ``zero_copy`` (``buf`` a memoryview) ``bytes`` fields are views of
        ``buf`` rather than copies."""
        mv = memoryview(buf).cast("B") if not isinstance(buf, memoryview) \
            else buf
        msg = cls()
        pos, end = 0, len(mv)
        while pos < end:
            key, pos = decode_varint(mv, pos)
            num, wt = key >> 3, key & 7
            if wt == 0:
                raw, pos = decode_varint(mv, pos)
            elif wt == 1:
                raw, pos = mv[pos:pos + 8], pos + 8
            elif wt == 2:
                n, pos = decode_varint(mv, pos)
                raw, pos = mv[pos:pos + n], pos + n
            elif wt == 5:
                raw, pos = mv[pos:pos + 4], pos + 4
            else:
                raise ValueError(f"unsupported wire type {wt} (field {num})")
            if pos > end:
                raise ValueError(f"field {num} runs past the message")
            f = cls._BY_NUMBER.get(num)
            if f is None:
                continue  # an unknown field: skipped
            msg._take(f, wt, raw, zero_copy)
        return msg

    FromString = decode

    def _take(self, f: Field, wt: int, raw, zero_copy: bool):
        if f.kind == MESSAGE:
            if wt != 2:
                return
            sub = f.message.decode(raw, zero_copy)
            if f.repeated:
                getattr(self, f.name).append(sub)
            else:
                setattr(self, f.name, sub)
            return
        if f.repeated and wt == 2 and f.kind not in (STRING, BYTES):
            vals, pos = [], 0
            while pos < len(raw):  # packed
                if f.kind == DOUBLE:
                    vals.append(_DBL.unpack(raw[pos:pos + 8])[0])
                    pos += 8
                else:
                    v, pos = decode_varint(raw, pos)
                    vals.append(_from_varint(f.kind, v))
            getattr(self, f.name).extend(vals)
            return
        if wt != _WIRE_TYPE[f.kind]:
            return  # a type this schema does not hold: skipped
        if f.kind == DOUBLE:
            v = _DBL.unpack(raw)[0]
        elif f.kind in _VARINT:
            v = _from_varint(f.kind, raw)
        elif f.kind == STRING:
            v = bytes(raw).decode("utf-8")
        else:
            v = raw if zero_copy else bytes(raw)
        if f.repeated:
            getattr(self, f.name).append(v)
        else:
            setattr(self, f.name, v)

    # -- helpers --
    def to_dict(self) -> dict:
        def val(f, v):
            if f.kind == MESSAGE:
                return v.to_dict() if v is not None else None
            return bytes(v) if f.kind == BYTES else v

        return {f.name: ([val(f, x) for x in getattr(self, f.name)]
                         if f.repeated else val(f, getattr(self, f.name)))
                for f in self.FIELDS}

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"


F = Field


class TraceContext(Message):
    FIELDS = (F(1, "trace_id", STRING), F(2, "span_id", STRING),
              F(3, "flags", UINT32))


_TRACE = F(15, "trace", MESSAGE, message=TraceContext)


class RegisterRequest(Message):
    FIELDS = (F(1, "addr", STRING), F(2, "name", STRING),
              F(3, "n_chips", UINT32), F(4, "coord_addr", STRING),
              F(5, "exclusive_name", BOOL), _TRACE)


class RegisterReply(Message):
    FIELDS = (F(1, "ok", BOOL), F(2, "worker_id", UINT64),
              F(3, "epoch", UINT64), F(4, "lease_ttl_ms", UINT32),
              F(5, "error", STRING))


class HeartbeatRequest(Message):
    FIELDS = (F(1, "worker_id", UINT64), F(2, "step", UINT64),
              F(3, "metric", DOUBLE), F(4, "flow", UINT32), _TRACE)


class PeerInfo(Message):
    FIELDS = (F(1, "worker_id", UINT64), F(2, "addr", STRING),
              F(3, "name", STRING), F(4, "n_chips", UINT32))


class HeartbeatReply(Message):
    FIELDS = (F(1, "ok", BOOL), F(2, "epoch", UINT64),
              F(3, "peers", MESSAGE, True, PeerInfo))


class DeregisterRequest(Message):
    FIELDS = (F(1, "worker_id", UINT64), _TRACE)


class MembershipRequest(Message):
    FIELDS = ()


class MembershipReply(Message):
    FIELDS = (F(1, "epoch", UINT64), F(2, "peers", MESSAGE, True, PeerInfo))


class Ack(Message):
    FIELDS = (F(1, "ok", BOOL), F(2, "error", STRING))


class ManifestRequest(Message):
    FIELDS = (F(1, "dataset", STRING), _TRACE)


class BlobInfo(Message):
    FIELDS = (F(1, "key", STRING), F(2, "size", UINT64),
              F(3, "crc32", UINT32))


class ManifestReply(Message):
    FIELDS = (F(1, "ok", BOOL), F(2, "error", STRING),
              F(3, "blobs", MESSAGE, True, BlobInfo))


class FetchRequest(Message):
    FIELDS = (F(1, "key", STRING), F(2, "offset", UINT64),
              F(3, "length", UINT64), F(4, "flow", UINT32),
              F(5, "flow_present", BOOL), _TRACE)


class ChunkMsg(Message):
    FIELDS = (F(1, "data", BYTES), F(2, "offset", UINT64),
              F(3, "last", BOOL), F(4, "error", STRING),
              F(5, "crc32", UINT32), F(6, "crc_present", BOOL))


class PutRequest(Message):
    FIELDS = (F(1, "key", STRING), F(2, "total_size", UINT64),
              F(3, "crc32", UINT32), F(4, "crc_present", BOOL), _TRACE)


class DeleteRequest(Message):
    FIELDS = (F(1, "key", STRING), _TRACE)


class StatsRequest(Message):
    FIELDS = ()


class RpcStat(Message):
    FIELDS = (F(1, "msg_type", UINT32), F(2, "count", UINT64),
              F(3, "total_us", UINT64), F(4, "max_us", UINT64))


class WorkerFlow(Message):
    FIELDS = (F(1, "worker_id", UINT64), F(2, "flow", UINT32),
              F(3, "step", UINT64), F(4, "metric", DOUBLE))


class StatsReply(Message):
    FIELDS = (F(1, "bytes_served", UINT64), F(2, "bytes_stored", UINT64),
              F(3, "active_streams", UINT32),
              F(4, "rpc", MESSAGE, True, RpcStat),
              F(5, "flows", MESSAGE, True, WorkerFlow),
              F(6, "crc_failures", UINT64),
              F(7, "throttled_chunks", UINT64),
              F(8, "starved_streams_served", UINT64))


class CoordinatorState(Message):
    FIELDS = (F(1, "next_id", UINT64), F(2, "epoch", UINT64),
              F(3, "peers", MESSAGE, True, PeerInfo))


MESSAGES = (TraceContext, RegisterRequest, RegisterReply, HeartbeatRequest,
            PeerInfo, HeartbeatReply, DeregisterRequest, MembershipRequest,
            MembershipReply, Ack, ManifestRequest, BlobInfo, ManifestReply,
            FetchRequest, ChunkMsg, PutRequest, DeleteRequest, StatsRequest,
            RpcStat, WorkerFlow, StatsReply, CoordinatorState)


# -- framing -----------------------------------------------------------------

_HDR = struct.Struct(">IB")


def send_frame(sock, mtype: int, payload: bytes = b""):
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame of {len(payload)} B exceeds {MAX_FRAME} B")
    sock.sendall(_HDR.pack(len(payload), mtype) + payload)


def send_chunk(sock, data=b"", **fields):
    """One ``ChunkMsg`` frame: ``data`` (at most :data:`CHUNK` bytes, any
    buffer) is sent as it lies, between the frame's head and the encoded
    remaining fields, which follow it in field-number order."""
    data = memoryview(data).cast("B")
    if len(data) > CHUNK:
        raise ValueError(f"chunk of {len(data)} B exceeds {CHUNK} B")
    tail = ChunkMsg(**fields).encode()
    head = b"\x0a" + encode_varint(len(data)) if len(data) else b""
    size = len(head) + len(data) + len(tail)
    sock.sendall(_HDR.pack(size, MSG_CHUNK) + head)
    if len(data):
        sock.sendall(data)
    if tail:
        sock.sendall(tail)


def recv_exact_into(sock, view: memoryview):
    got, n = 0, len(view)
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k


class FrameReader:
    """Reads frames from one socket into one reused buffer: the payload
    returned by :meth:`read` is a view valid until the next read."""

    def __init__(self, sock, max_frame: int = MAX_FRAME):
        self.sock = sock
        self.max_frame = max_frame
        self._buf = bytearray(CHUNK + 64)
        self._hdr = bytearray(5)

    def read(self, buf: Optional[bytearray] = None
             ) -> Tuple[int, memoryview]:
        """The next frame's (type, payload); into ``buf`` when given (a
        caller that keeps several payloads alive at once), else into the
        reader's own buffer."""
        recv_exact_into(self.sock, memoryview(self._hdr))
        n, mtype = _HDR.unpack(self._hdr)
        if n > self.max_frame:
            raise ConnectionError(f"frame of {n} B exceeds {self.max_frame}")
        if buf is None:
            if n > len(self._buf):
                self._buf = bytearray(n)
            buf = self._buf
        elif n > len(buf):
            raise ConnectionError(f"frame of {n} B exceeds its buffer")
        view = memoryview(buf)[:n]
        if n:
            recv_exact_into(self.sock, view)
        return mtype, view
