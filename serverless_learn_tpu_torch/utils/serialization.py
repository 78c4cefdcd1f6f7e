"""flax's msgpack form of a state dict, the port's own codec: the subset of
``flax.serialization`` that ``to_bytes`` and ``msgpack_restore`` use, so the
port reads and writes the JAX package's checkpoints without flax or the
``msgpack`` package.

The form is plain msgpack: maps with string keys, arrays, strings, ints,
floats (written as doubles), bools, nil and bin, plus three extension
types:

* ext 1, an array: the msgpack of ``(shape, dtype name, C-order bytes)``;
  ``bfloat16`` is read and written through a 16-bit view of a
  ``torch.bfloat16`` tensor;
* ext 3, a numpy scalar: the same payload, decoded to a numpy scalar;
* ext 2, a complex number, which the port does not take (it raises).

An array of more than :data:`MAX_CHUNK_SIZE` bytes is written as flax
writes it, a map ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": ...}}`` of flat chunks of at most that many bytes, and
read back into one tensor.

Every choice of encoding is msgpack-python's (the smallest int encoding,
``str8`` for strings of 32-255 bytes, the ext header by payload size), so
bytes flax wrote decode and re-encode to the same bytes. :func:`encode`
sizes the whole blob first and copies each leaf's bytes into it once,
straight from the tensor's device; :func:`decode` slices arrays out of
the blob through a ``memoryview``, without copying them.
"""

from __future__ import annotations

import mmap
import struct
import warnings
from typing import Any, List, Tuple, Union

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 byte limit for one
# object, with a margin. A module constant, so tests can lower it.
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_BY_NAME = {name: dt for dt, name in _TORCH_NAMES.items()}

Array = Union[torch.Tensor, np.ndarray]


# Bytes of a mapping populated at a time by ``host_buffer``.
_POPULATE_STEP = 256 << 20
_PAGE = mmap.PAGESIZE


def host_buffer(nbytes: int) -> memoryview:
    """A writable host buffer for a blob: above 1 MB an anonymous mapping
    whose pages are all faulted in up front, so the copies into it do not
    fault page by page. On an H100 host (``chip_smoke.py`` phase 10) an
    18 GB save's copies from the card took 5.1 s into a populated mapping
    and 14.8 s into pages faulted on first write. The pages are touched
    ``_POPULATE_STEP`` bytes at a time rather than by one ``MAP_POPULATE``,
    which on that host holds every other thread's allocations for as long
    as it runs (seconds for a checkpoint's buffer): an elastic worker's
    heartbeat thread stalled past its lease (``chip_smoke.py`` phase 13,
    which checks the stall of this function)."""
    if nbytes < 1 << 20:
        return memoryview(bytearray(nbytes))
    m = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    pages = np.frombuffer(m, np.uint8)
    for i in range(0, nbytes, _POPULATE_STEP):
        pages[i:i + _POPULATE_STEP:_PAGE] = 0
    del pages
    return memoryview(m)


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name flax writes for a tensor of ``dtype``."""
    try:
        return _TORCH_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no msgpack form for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unsupported array dtype {name!r}") from None


# -- tree nodes -------------------------------------------------------------

class Struct(dict):
    """A node that was a NamedTuple or a dataclass in the JAX package's
    pytree (``TrainState``, optax's ``ScaleByAdamState``): a map of its
    fields in field order, whose paths read ``.field``."""


class Seq(dict):
    """A node that was a tuple (an optax chain's states): a map ``{"0":
    ..., "1": ...}``, whose paths read ``[i]``."""

    def __init__(self, *items):
        super().__init__((str(i), v) for i, v in enumerate(items))


def leaves_with_paths(tree: Any, path: str = ""):
    """(path, leaf) in ``jax.tree_util.tree_flatten_with_path``'s order,
    each path as ``jax.tree_util.keystr`` writes it: plain dicts in sorted
    key order (``['key']``), :class:`Struct` in field order (``.field``),
    :class:`Seq` in index order (``[i]``). Empty nodes have no leaves."""
    if isinstance(tree, Seq):
        for i in range(len(tree)):
            yield from leaves_with_paths(tree[str(i)], f"{path}[{i}]")
    elif isinstance(tree, Struct):
        for k, v in tree.items():
            yield from leaves_with_paths(v, f"{path}.{k}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


# -- encoding ---------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Tuple[int, int], codes) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form
    (``fix`` = (first byte, limit)) where it fits, else the first of
    ``codes`` = ((code, struct format, limit), ...) that holds n."""
    if fix and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} items do not fit msgpack's 32 bits")


_W8, _W16, _W32 = (">B", 0xff), (">H", 0xffff), (">I", 0xffffffff)


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), (0xa0, 32), ((0xd9, *_W8), (0xda, *_W16),
                                         (0xdb, *_W32))) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, (), ((0xc4, *_W8), (0xc5, *_W16), (0xc6, *_W32)))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), ((0xdc, *_W16), (0xdd, *_W32)))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), ((0xde, *_W16), (0xdf, *_W32)))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _sized(n, (), ((0xc7, *_W8), (0xc8, *_W16),
                          (0xc9, *_W32))) + bytes([code])


def _leaf_parts(code: int, shape, name: str, nbytes: int) -> bytes:
    """Everything of an ext-1/3 leaf before its data bytes."""
    inner = (_array_header(3) + _array_header(len(shape))
             + b"".join(_int(int(d)) for d in shape) + _str(name)
             + _bin_header(nbytes))
    return _ext_header(code, len(inner) + nbytes) + inner


def _as_tensor(x: Array) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    x = np.asarray(x, order="C")  # (ascontiguousarray makes 0-d 1-d)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands out
        return _from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return _from_numpy(x)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    with warnings.catch_warnings():
        # a read-only array gives a read-only tensor; the codec only reads
        # it, and a restore copies it into the live state
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _chunked(t: torch.Tensor) -> dict:
    """flax's ``_chunk``: flat chunks of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / t.element_size()))
    flat = t.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(t.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.numel(), size))}}


def _plan(obj: Any, parts: List):
    """Append ``obj``'s encoding to ``parts``: header bytes, and for each
    array leaf the tensor whose bytes follow."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        t = _as_tensor(obj)
        if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
            return _plan(_chunked(t), parts)
        nbytes = t.numel() * t.element_size()
        parts.append(_leaf_parts(EXT_NDARRAY, t.shape, dtype_name(t.dtype),
                                 nbytes))
        parts.append(t)
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        parts.append(_leaf_parts(EXT_NPSCALAR, (), arr.dtype.name,
                                 arr.nbytes) + arr.tobytes())
    elif isinstance(obj, dict):
        parts.append(_map_header(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {k!r}")
            parts.append(_str(k))
            _plan(v, parts)
    elif isinstance(obj, list):
        parts.append(_array_header(len(obj)))
        for v in obj:
            _plan(v, parts)
    elif obj is None:
        parts.append(b"\xc0")
    elif isinstance(obj, bool):
        parts.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        parts.append(_int(obj))
    elif isinstance(obj, float):
        parts.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        parts.append(_str(obj))
    elif isinstance(obj, (bytes, bytearray)):
        parts.append(_bin_header(len(obj)) + bytes(obj))
    else:
        # flax writes tuples through to_state_dict as maps; a complex
        # number would be ext 2, which the port does not take.
        raise TypeError(f"no msgpack form for {type(obj).__name__}")


def encode(tree: Any) -> memoryview:
    """``flax.serialization.msgpack_serialize`` of a state dict whose
    leaves are tensors (any device) or numpy arrays, as a writable buffer
    (:func:`host_buffer`). The blob is sized first, then each leaf is
    copied into it once."""
    parts: List = []
    _plan(tree, parts)
    total = sum(len(p) if isinstance(p, bytes) else p.numel() * p.element_size()
                for p in parts)
    out = host_buffer(total)
    pos = 0
    for p in parts:
        if isinstance(p, bytes):
            out[pos:pos + len(p)] = p
            pos += len(p)
            continue
        n = p.numel() * p.element_size()
        if n:
            dst = torch.frombuffer(out, dtype=torch.uint8, count=n,
                                   offset=pos).view(p.dtype)
            dst.copy_(p.reshape(-1))
        pos += n
    assert pos == total
    return out


# -- decoding ---------------------------------------------------------------

class _Reader:
    """A cursor over a msgpack blob. Arrays come out as tensors over the
    blob's own memory (a writable blob gives writable tensors)."""

    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError(f"blob truncated: {n} bytes wanted at "
                             f"{self.pos} of {len(self.mv)}")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _len(self, b: int, first: int):
        """The length that follows byte ``b`` if it is one of the three
        codes from ``first`` (8, 16, 32-bit lengths), else None."""
        if first <= b < first + 3:
            return self._unpack((">B", ">H", ">I")[b - first])
        return None

    def read(self) -> Any:
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b < 0x90:
            return self._map(b & 0x0f)
        if 0x90 <= b < 0xa0:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b < 0xc0:
            return str(self._take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        n = self._len(b, 0xc4)  # bin 8/16/32
        if n is not None:
            return bytes(self._take(n))
        n = self._len(b, 0xc7)  # ext 8/16/32
        if n is not None:
            return self._ext(self._take(1)[0], n)
        ints = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if 0xd4 <= b <= 0xd8:  # fixext 1, 2, 4, 8, 16
            return self._ext(self._take(1)[0], 1 << (b - 0xd4))
        n = self._len(b, 0xd9)  # str 8/16/32
        if n is not None:
            return str(self._take(n), "utf-8")
        if b in (0xdc, 0xdd):
            return [self.read() for _ in range(
                self._unpack(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"invalid msgpack byte {b:#04x} at {self.pos - 1}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, code: int, n: int):
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            if code == EXT_COMPLEX:
                raise ValueError("complex leaves (msgpack ext 2) are not "
                                 "taken by the port")
            raise ValueError(f"unknown msgpack ext type {code}")
        if self._take(1)[0] != 0x93:
            raise ValueError("array payload is not (shape, dtype, bytes)")
        shape = self.read()
        name = self.read()
        if isinstance(name, bytes):
            name = name.decode()
        b = self._take(1)[0]
        nbytes = self._len(b, 0xc4)
        if nbytes is None:
            raise ValueError("array payload has no bin")
        data = self._take(nbytes)
        if self.pos != end:
            raise ValueError("array payload length disagrees with its ext")
        t = _tensor(data, name, shape)
        if code == EXT_NPSCALAR:
            if t.dtype == torch.bfloat16:
                raise ValueError("bfloat16 numpy scalars are not taken")
            return t.numpy()[()]
        return t


def _tensor(data: memoryview, name: str, shape) -> torch.Tensor:
    dt = torch_dtype(name)
    np_dt = np.uint16 if dt == torch.bfloat16 else np.dtype(name)
    t = _from_numpy(np.frombuffer(data, dtype=np_dt).reshape(shape))
    return t.view(torch.bfloat16) if dt == torch.bfloat16 else t


def _unchunk(d: dict) -> torch.Tensor:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def decode(buf) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict of a blob
    (``bytes``, ``bytearray`` or ``memoryview``), arrays as CPU tensors."""
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"trailing bytes after the msgpack object: "
                         f"{len(r.mv) - r.pos}")
    return out
