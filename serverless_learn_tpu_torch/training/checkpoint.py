"""Checkpoints in the JAX package's format, the port of
``serverless_learn_tpu/training/checkpoint.py``: the same keys, the same
blob, manifest and sharded layouts, the same verification, quarantine and
fallback, so a checkpoint written by either package restores in the other.

A state is a tree in the form flax's ``to_state_dict`` gives
(``training/train_state.py:state_tree`` for a ``TrainState``): nested maps
whose leaves are tensors on any device. Two layouts under
``<name>/step-<N>``:

* **blob** (:meth:`Checkpointer.save`): the tree as one flax-msgpack value
  (``utils/serialization.py``), then ``step-N.manifest`` (size and CRC-32),
  then ``LATEST``, in that order. The blob is built by copying each leaf
  from the card into it once; the upload (write, CRC, manifest, ``LATEST``,
  GC) runs on a thread, at most one in flight, drained at exit.
* **sharded** (:meth:`Checkpointer.save_sharded`): ``META`` (each leaf's
  ``jax.tree_util.keystr`` path, shape and dtype, in the JAX package's
  flatten order), ``proc-K.dat`` (the leaves' bytes) and ``proc-K.idx``
  (one chunk per leaf and process with its box, offset and CRC), then
  ``COMMIT`` last. The port writes one process; it reads any number, and
  copies each chunk into its box of the destination, so a checkpoint saved
  on a JAX mesh of several devices restores onto one card.

A restore verifies sizes and CRCs before any byte reaches the state and
raises :class:`CheckpointCorrupt`. Restoring the newest step quarantines a
corrupt one (a ``step-N.CORRUPT`` marker) and falls back to the newest
that verifies; restoring an explicit step raises. :meth:`Checkpointer.
restore` writes into the template's own tensors, leaf by leaf, so the card
never holds a second copy of the state. There is no fallback to fresh
weights anywhere: a store without a checkpoint raises.

**Emergency save** (:meth:`Checkpointer.arm_emergency`): a death hook of
the flight recorder (``telemetry/flight.py``) commits, on SIGTERM or an
unhandled exception, a blob of the newest host shadow. The port updates
the state in place, so a signal handler, which runs between bytecodes,
could see a half-applied optimizer update: the hook never reads the live
tensors. :meth:`Checkpointer.note_state`, called by the training thread
at a step boundary after the step's sync, copies the state into the
shadow, at most once per ``min_interval_s`` and charged to the goodput
ledger's ``checkpoint`` phase. The shadow is one pre-populated host
buffer allocated on the first refresh and overwritten in place after.
The emergency commit is the blob layout, which the JAX package restores.

Telemetry: the reference's seven ``slt_ckpt_*`` series, and the goodput
ledger's ``checkpoint`` phase around the synchronous parts of a save and
a restore (the copy into the blob, the wait on the previous upload; the
upload itself overlaps training and is not charged).

Two stores: :class:`LocalStore` (``--checkpoint-dir``) and
:class:`ShardServerStore` (``--checkpoint-store ADDR``, the shard server of
``control/daemons.py`` or the JAX package's), each moving data in bounded
calls. Either can sit behind ``training/replicate.ReplicatedStore``, a
worker-local cache and peer replicas: a restore then reads each step from
its ``restore_sources()`` in order (cache, primary, peers), and a copy that
fails verification is healed by the next intact one; ``ckpt_corrupt``
names the source, ``timings["restore_source"]`` the one that served, and
a restore served by anything but the primary counts in
``slt_ckpt_peer_restores_total``. Not ported yet, raising where it would
be reached: the ZeRO layouts (ROADMAP.md queue 1 item 3d).
"""

from __future__ import annotations

import atexit
import concurrent.futures
import json
import os
import re
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from serverless_learn_tpu_torch.telemetry import flight, goodput
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.registry import get_registry
from serverless_learn_tpu_torch.utils.serialization import (
    Seq, Struct, decode, dtype_name, encode, host_buffer, leaves_with_paths,
    torch_dtype)


class CheckpointCorrupt(IOError):
    """A checkpoint failed verification (size or CRC mismatch, undecodable
    payload, missing chunks). Raised before any byte reaches the state."""

    def __init__(self, step: int, detail: str):
        super().__init__(f"checkpoint step {step} is corrupt: {detail}")
        self.step = step
        self.detail = detail


# -- CRC-32 -----------------------------------------------------------------

_POLY = 0xedb88320  # CRC-32's polynomial, reflected (zlib's)


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the CRC polynomial, reflected (zlib's ``multmodp``)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if (a & (m - 1)) == 0:
                return p
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1


_X2N = [1 << 30]  # x^(2^k) modulo the polynomial, for k = 0..31
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of A + B from those of A and B and B's length (zlib's
    ``crc32_combine``, which Python's ``zlib`` does not expose)."""
    p, n, k = 1 << 31, len2, 3  # x^(8 * len2): k starts at 2^3 bits
    while n:
        if n & 1:
            p = _multmodp(_X2N[k & 31], p)
        n >>= 1
        k += 1
    return _multmodp(p, crc1) ^ crc2


_CRC_PART = 256 << 20  # bytes a thread sums at a time


def _crc(data) -> int:
    """``zlib.crc32`` of ``data``; above 256 MB in parts summed on threads
    (zlib releases the GIL) and combined, the same value."""
    mv = memoryview(data).cast("B")
    if len(mv) <= _CRC_PART:
        return zlib.crc32(mv) & 0xFFFFFFFF
    parts = [mv[i:i + _CRC_PART] for i in range(0, len(mv), _CRC_PART)]
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as ex:
        crcs = list(ex.map(zlib.crc32, parts))
    out = crcs[0]
    for c, part in zip(crcs[1:], parts[1:]):
        out = crc32_combine(out, c, len(part))
    return out & 0xFFFFFFFF


# -- the local store --------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists (owned by someone else): leave it be
    return True


# Bytes per write() or readinto() of the local store. One call over an
# 18 GB blob held the host's memory map for seconds on an H100 host, so
# other threads' mmaps (host allocations, thread stacks) waited, and a
# training step beside an upload took 5-7 s instead of 0.3 s
# (``chip_smoke.py`` phase 10); with 64 MB calls it took 0.4 s.
_IO_CHUNK = 64 << 20
_STORE_RPC_S = 300.0  # a shard-server store's deadline per socket operation


class LocalStore:
    """Keys as files under ``root``; ``put`` is atomic (tmp + rename).
    ``get`` returns a writable buffer (``utils.serialization.host_buffer``),
    so arrays decoded from it are writable views of it. Both move data in
    ``_IO_CHUNK`` calls."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._sweep_orphan_tmp()

    def _sweep_orphan_tmp(self):
        """Remove ``*.tmp.<pid>`` left by writers that died mid-put; a live
        writer's (another process, or a thread of this one) stays."""
        try:
            for dirpath, _, files in os.walk(self.root):
                for fn in files:
                    m = re.search(r"\.tmp\.(\d+)$", fn)
                    if m is None:
                        continue
                    pid = int(m.group(1))
                    if pid != os.getpid() and not _pid_alive(pid):
                        try:
                            os.remove(os.path.join(dirpath, fn))
                        except OSError:
                            pass
        except OSError:
            pass  # an unreadable root fails loudly on first use

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def put(self, key: str, data):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        mv = memoryview(data).cast("B")
        with open(tmp, "wb") as f:
            for i in range(0, len(mv), _IO_CHUNK):
                f.write(mv[i:i + _IO_CHUNK])
        os.replace(tmp, path)

    def get(self, key: str) -> memoryview:
        return self.get_range(key, 0, None)

    def get_range(self, key: str, offset: int, length: Optional[int],
                  out: Optional[memoryview] = None) -> memoryview:
        """Bytes ``[offset, offset + length)`` of ``key`` (to its end when
        ``length`` is None), read into ``out`` when given (a buffer the
        caller reuses), else into a new host buffer."""
        with open(self._path(key), "rb") as f:
            size = os.fstat(f.fileno()).st_size
            n = max(0, size - offset) if length is None else max(
                0, min(length, size - offset))
            out = host_buffer(n) if out is None else out[:n]
            f.seek(offset)
            got = 0
            while got < n:
                k = f.readinto(out[got:got + _IO_CHUNK])
                if not k:
                    break
                got += k
        return out[:got]

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list(self, prefix: str) -> List[str]:
        base = self._path(prefix)
        if not os.path.isdir(base):
            return []
        out = []
        for dirpath, _, files in os.walk(base):
            for fn in files:
                if ".tmp." in fn:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                out.append(rel.replace(os.sep, "/"))
        return out

    def delete(self, key: str):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class ShardServerStore:
    """Keys as blobs of a shard server (``--checkpoint-store``), the
    reference's store over the port's client: ``put`` streams the buffer
    in ``wire.CHUNK`` frames, ``get`` and ``get_range`` fetch into a host
    buffer in ``_IO_CHUNK`` ranges, so no call holds more than a chunk
    beyond the destination. ``exists`` is False only on the server's own
    no-such-key answer, and ``list`` of a missing prefix is empty: a
    transport failure raises, so an unreachable store never reads as an
    empty one. Each socket operation may take ``_STORE_RPC_S``, the fsync
    the server does before acknowledging a put included."""

    def __init__(self, addr: str):
        from serverless_learn_tpu_torch.control.client import ShardClient

        self.addr = addr
        self.client = ShardClient(addr, rpc_timeout_s=_STORE_RPC_S)

    def put(self, key: str, data):
        # The put's CRC-32 heads the stream: summed on threads (``_crc``).
        self.client.put(key, data, crc32=_crc(data))

    def get(self, key: str) -> memoryview:
        return self.get_range(key, 0, None)

    def get_range(self, key: str, offset: int, length: Optional[int],
                  out: Optional[memoryview] = None) -> memoryview:
        """As ``LocalStore.get_range``."""
        if length is None:
            length = max(0, self.client.size_of(key) - offset)
        out = host_buffer(length) if out is None else out[:length]
        got = 0
        while got < length:
            n = self.client.fetch_into(key, out[got:got + _IO_CHUNK],
                                       offset + got,
                                       min(_IO_CHUNK, length - got))
            if not n:
                break
            got += n
        return out[:got]

    def exists(self, key: str) -> bool:
        from serverless_learn_tpu_torch.control.client import KeyNotFound

        try:
            return self.client.size_of(key) >= 0
        except KeyNotFound:
            return False

    def list(self, prefix: str) -> List[str]:
        from serverless_learn_tpu_torch.control.client import KeyNotFound

        try:
            return [b.key for b in self.client.manifest(prefix)]
        except KeyNotFound:
            return []

    def delete(self, key: str):
        self.client.delete(key)

    def close(self):
        self.client.close()


# -- trees ------------------------------------------------------------------

def _rebuild(template: Any, fn: Callable[[str, Any], Any], path: str = ""):
    """``template`` with each leaf replaced by ``fn(path, leaf)``, the
    node types (and so the paths) kept."""
    if isinstance(template, Seq):
        return Seq(*(_rebuild(template[str(i)], fn, f"{path}[{i}]")
                     for i in range(len(template))))
    if isinstance(template, dict):
        node = Struct() if isinstance(template, Struct) else {}
        for k, v in template.items():
            sub = f"{path}.{k}" if isinstance(template, Struct) \
                else f"{path}['{k}']"
            node[k] = _rebuild(v, fn, sub)
        return node
    return fn(path, template)


def _leaf_of(tree: Any, path: str):
    """The leaf at a keystr ``path`` of a decoded (plain-dict) tree."""
    node = tree
    for m in re.finditer(r"\[(\d+)\]|\['([^']*)'\]|\.(\w+)", path):
        key = next(g for g in m.groups() if g is not None)
        if not isinstance(node, dict) or key not in node:
            raise KeyError(path)
        node = node[key]
    return node


def _structure_problems(template: Any, got: Any, path: str = "") -> List[str]:
    """Where a decoded tree's maps differ from the template's keys."""
    if not isinstance(template, dict):
        return [] if not isinstance(got, dict) else [f"{path}: a map, not "
                                                     "an array"]
    if not isinstance(got, dict):
        return [f"{path}: an array, not a map"]
    out = [f"{path}: missing key {k!r}" for k in template if k not in got]
    out += [f"{path}: unexpected key {k!r}" for k in got if k not in template]
    for k in template:
        if k in got:
            out += _structure_problems(template[k], got[k], f"{path}/{k}")
    return out


def _misfit(step: int, problems: List[str]) -> str:
    return (f"checkpoint step {step} does not fit the state (is the model "
            "or the optimizer configured as when it was saved?): "
            + "; ".join(problems[:5])
            + (f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""))


def _host_shadow(tree: Any, shadow: Any = None):
    """Copy ``tree``'s leaves into ``shadow`` (a tree of CPU tensors of
    the same structure) in place and return it; without a ``shadow``, or
    when the structure changed, first allocate one: views into a single
    pre-populated host buffer (``host_buffer``), so the copies from the
    card do not fault page by page."""
    leaves = list(leaves_with_paths(tree))
    if shadow is not None:
        have = list(leaves_with_paths(shadow))
        if [(p, tuple(t.shape), t.dtype) for p, t in have] != \
                [(p, tuple(t.shape), t.dtype) for p, t in leaves]:
            shadow = None
    if shadow is None:
        sizes = {p: t.numel() * t.element_size() for p, t in leaves}
        buf = host_buffer(max(1, sum(sizes.values())))
        pos = [0]

        def alloc(path, leaf):
            n = sizes[path]
            out = (torch.frombuffer(buf, dtype=torch.uint8, count=n,
                                    offset=pos[0]).view(leaf.dtype)
                   if n else torch.empty(0, dtype=leaf.dtype))
            pos[0] += n
            return out.view(leaf.shape)

        shadow = _rebuild(tree, alloc)
    for (_, src), (_, dst) in zip(leaves, leaves_with_paths(shadow)):
        dst.copy_(src.detach())
    return shadow


def _check_leaf(path: str, dst: torch.Tensor, shape, dtype: torch.dtype):
    if tuple(dst.shape) != tuple(shape) or dst.dtype != dtype:
        raise ValueError(f"checkpoint leaf {path} is {tuple(shape)} "
                         f"{dtype}, the state's is {tuple(dst.shape)} "
                         f"{dst.dtype}")


class Checkpointer:
    """Save and restore state trees under ``<name>/step-<N>`` keys of a
    store, in the JAX package's blob or sharded layout (module docstring).
    :meth:`restore` of no step walks the committed steps newest first,
    quarantining corrupt ones; of step N it raises if N is corrupt.

    ``timings`` holds the last save's and restore's seconds and bytes:
    ``save_sync_s`` (the copy into the blob on the caller's thread),
    ``upload_s`` and ``crc_s`` (on the upload thread), ``save_bytes``,
    ``restore_s``, ``restore_crc_s`` and ``restore_bytes``."""

    def __init__(self, store, name: str = "ckpt", keep: int = 3,
                 async_save: bool = True, sharded: bool = False,
                 verify: bool = True):
        self.store = store
        self.name = name
        self.keep = keep
        self.async_save = async_save
        self.sharded = sharded
        self.verify = verify
        self.timings: Dict[str, float] = {}
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        # The sharded save's host buffer, kept for the next save of the
        # same size (an elastic worker saves at every transition).
        self._save_buf: Optional[memoryview] = None
        # The newest step that restored and verified: _gc never collects
        # it, since after a quarantine it is the state to fall back to.
        self._last_verified: Optional[int] = None
        self._atexit_armed = False
        # Emergency save (arm_emergency / note_state): a host shadow of
        # the state, refreshed at step boundaries by the training thread.
        self._emg_min_s = 0.0
        self._emg_last_t: Optional[float] = None
        self._emg_armed = False
        self._emg_shadow: Any = None
        self._emg_shadow_step: Optional[int] = None
        self._emg_shadow_t: Optional[float] = None
        # The tree a refresh is copying from, while it copies: a signal
        # landing mid-copy finds the shadow half overwritten, and the
        # live tree (at a step boundary) whole.
        self._emg_refreshing: Any = None
        self.shadow_refreshes = 0
        reg = get_registry()
        self._m_saves = reg.counter("slt_ckpt_saves_total",
                                    "checkpoint commits (incl. emergency)")
        self._m_last_step = reg.gauge("slt_ckpt_last_step",
                                      "newest committed checkpoint step")
        self._m_verified = reg.counter(
            "slt_ckpt_verified_restores_total",
            "restores that passed size+CRC verification")
        self._m_corrupt = reg.counter(
            "slt_ckpt_corrupt_total",
            "checkpoint copies that failed verification")
        self._m_fallbacks = reg.counter(
            "slt_ckpt_fallbacks_total",
            "restores that fell back past a quarantined step")
        self._m_emergency = reg.counter(
            "slt_ckpt_emergency_saves_total",
            "best-effort saves on the flight recorder's death path")
        self._m_peer_restores = reg.counter(
            "slt_ckpt_peer_restores_total",
            "step loads served by a local cache or peer replica "
            "instead of the central store")

    # -- save --------------------------------------------------------------

    def save(self, tree, step: Optional[int] = None) -> int:
        """Copy ``tree`` into a blob now (the state may change as soon as
        this returns), then commit it on the upload thread."""
        if self.sharded:
            return self.save_sharded(tree, step)
        with goodput.phase("checkpoint"):
            step = int(tree["step"]) if step is None else int(step)
            t0 = time.perf_counter()
            blob = encode(tree)
            self.timings.update(save_sync_s=time.perf_counter() - t0,
                                save_bytes=len(blob))
            self.wait()  # at most one upload in flight

        def upload():
            self._put_blob(step, blob)
            self._gc(step)

        if self.async_save:
            def run():
                try:
                    upload()
                except Exception as e:  # re-raised by wait()
                    self._pending_error = e

            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()
            self._arm_atexit()
        else:
            upload()
        return step

    def _put_blob(self, step: int, blob, reason: str = ""):
        """Blob, manifest, ``LATEST``, in that order: a crash between two
        leaves a complete older or a complete newer commit, never a
        pointer at torn bytes. ``reason`` marks an emergency commit's
        manifest, as the reference's."""
        key = self._key(step)
        t0 = time.perf_counter()
        self.store.put(key, blob)
        t1 = time.perf_counter()
        crc = _crc(blob)
        t2 = time.perf_counter()
        manifest = {"step": step, "layout": "blob", "nbytes": len(blob),
                    "crc32": crc}
        if reason:
            manifest["emergency"] = reason
        self.store.put(key + ".manifest", json.dumps(manifest).encode())
        self.store.put(f"{self.name}/LATEST",
                       json.dumps({"step": step}).encode())
        self.timings.update(upload_s=time.perf_counter() - t0 - (t2 - t1),
                            crc_s=t2 - t1)
        self._m_saves.inc()
        self._m_last_step.set(step)

    def save_sharded(self, tree, step: Optional[int] = None) -> int:
        """The sharded layout from one process, synchronously: one chunk
        per leaf in ``proc-00000.dat``, CRC-stamped in its ``.idx``."""
        with goodput.phase("checkpoint"):
            return self._save_sharded(tree, step)

    def _save_sharded(self, tree, step: Optional[int]) -> int:
        step = int(tree["step"]) if step is None else int(step)
        t0 = time.perf_counter()
        leaves = list(leaves_with_paths(tree))
        metas, chunks, offset = [], [], 0
        for i, (path, leaf) in enumerate(leaves):
            shape = list(leaf.shape)
            nbytes = leaf.numel() * leaf.element_size()
            metas.append({"path": path, "shape": shape,
                          "dtype": dtype_name(leaf.dtype)})
            chunks.append({"leaf": i, "start": [0] * len(shape),
                           "stop": shape, "offset": offset,
                           "nbytes": nbytes})
            offset += nbytes
        # A peer push of the last save may still read the buffer
        # (``ReplicatedStore.holds``): then this save takes a new one.
        holds = getattr(self.store, "holds", None)
        if (self._save_buf is None or len(self._save_buf) != offset
                or (holds is not None and holds(self._save_buf))):
            self._save_buf = None
            self._save_buf = host_buffer(offset)
        data = self._save_buf
        for c, (_, leaf) in zip(chunks, leaves):
            if c["nbytes"]:
                dst = torch.frombuffer(data, dtype=torch.uint8,
                                       count=c["nbytes"], offset=c["offset"])
                dst.view(leaf.dtype).copy_(leaf.detach().reshape(-1))
            c["crc"] = _crc(data[c["offset"]:c["offset"] + c["nbytes"]])
        self.timings.update(save_sync_s=time.perf_counter() - t0,
                            save_bytes=len(data))
        self.wait()
        prefix = self._key(step)
        self.store.put(f"{prefix}/proc-00000.dat", data)
        self.store.put(f"{prefix}/proc-00000.idx", json.dumps(
            {"chunks": chunks, "dat_nbytes": len(data)}).encode())
        self.store.put(f"{prefix}/META", json.dumps(
            {"step": step, "n_procs": 1, "leaves": metas}).encode())
        self.store.put(f"{prefix}/COMMIT", json.dumps(
            {"step": step, "n_procs": 1}).encode())
        self.store.put(f"{self.name}/LATEST",
                       json.dumps({"step": step}).encode())
        self._m_saves.inc()
        self._m_last_step.set(step)
        self._gc(step)
        return step

    def wait(self):
        """Block until the upload in flight has committed; re-raise its
        error. The wait holds the caller for the checkpoint: charged to
        the ``checkpoint`` phase."""
        if self._pending is not None:
            with goodput.phase("checkpoint"):
                self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err

    # -- lifecycle ---------------------------------------------------------

    def _arm_atexit(self):
        """A clean exit must not strand a half-committed upload: drain it
        at interpreter exit."""
        if not self._atexit_armed:
            atexit.register(self._drain_at_exit)
            self._atexit_armed = True

    def _drain_at_exit(self):
        try:
            self.wait()
        except Exception:
            pass  # exit paths never raise

    def close(self):
        """Drain the upload in flight, disarm the emergency save and the
        atexit drain. Idempotent."""
        try:
            self.wait()
        finally:
            self.disarm_emergency()
            if self._atexit_armed:
                atexit.unregister(self._drain_at_exit)
                self._atexit_armed = False

    # -- emergency save ----------------------------------------------------

    def arm_emergency(self, min_interval_s: float = 30.0):
        """A synchronous blob save on the flight recorder's death path
        (SIGTERM, an unhandled exception): a dying trainer commits its
        newest shadowed state (:meth:`note_state`'s host shadow), so it
        loses at most ``min_interval_s`` of steps. At most one save per
        ``min_interval_s``."""
        self._emg_min_s = float(min_interval_s)
        self._emg_armed = True
        flight.add_death_hook(f"ckpt:{self.name}", self._emergency_save)

    def note_state(self, tree) -> Optional[float]:
        """Refresh the emergency shadow from ``tree`` (a state tree over
        the live tensors, ``Trainer.state_tree``, or a function that makes
        one, called only when the refresh runs). Call from the training
        thread at a step boundary, after the step's sync, where no update
        is half applied. At most once per ``min_interval_s``; charged to
        the ``checkpoint`` phase. Returns the seconds the refresh held the
        loop, or None when it did not run."""
        if not self._emg_armed:
            return None
        now = time.monotonic()
        if (self._emg_shadow_t is not None
                and now - self._emg_shadow_t < self._emg_min_s):
            return None
        t0 = time.perf_counter()
        if callable(tree):
            tree = tree()
        with goodput.phase("checkpoint"):
            self._emg_refreshing = tree
            try:
                self._emg_shadow = _host_shadow(tree, self._emg_shadow)
                self._emg_shadow_step = int(tree["step"])
            finally:
                self._emg_refreshing = None
        held = time.perf_counter() - t0
        self._emg_shadow_t = now
        self.shadow_refreshes += 1
        self.timings["shadow_s"] = held
        ttrace.emit_event({"event": "ckpt_shadow", "name": self.name,
                           "step": self._emg_shadow_step,
                           "seconds": round(held, 6)})
        return held

    def host_shadow(self):
        """(host tree, step) of the newest shadow, or (None, None)."""
        return self._emg_shadow, self._emg_shadow_step

    def disarm_emergency(self):
        self._emg_armed = False
        self._emg_shadow = None
        self._emg_shadow_step = None
        self._emg_shadow_t = None
        flight.remove_death_hook(f"ckpt:{self.name}")

    def _death_state(self):
        """(host tree, step, source) for the death hook: during a shadow
        refresh (the signal interrupted the copy) the tree being copied,
        copied whole; else the shadow. The live tensors are never read
        outside a refresh, where an update may be half applied."""
        tree = self._emg_refreshing
        if tree is not None:
            return (_host_shadow(tree, self._emg_shadow), int(tree["step"]),
                    "refresh")
        return self._emg_shadow, self._emg_shadow_step, "shadow"

    def _emergency_save(self, reason: str):
        """The death hook. Never raises; returns a summary for the flight
        dump."""
        try:
            now = time.monotonic()
            if (self._emg_last_t is not None
                    and now - self._emg_last_t < self._emg_min_s):
                return {"skipped": "rate-limited"}
            host, step, source = self._death_state()
            if host is None:
                return {"skipped": "no-state"}
            self._emg_last_t = now
            try:
                self.wait()
            except Exception:
                pass
            blob = encode(host)
            self._put_blob(step, blob, reason=f"emergency:{reason}")
            self._m_emergency.inc()
            rec = {"event": "ckpt_emergency_save", "name": self.name,
                   "step": step, "reason": reason, "nbytes": len(blob),
                   "source": source}
            flight.record(rec)
            ttrace.emit_event(rec)
            return {"step": step, "nbytes": len(blob), "source": source}
        except Exception as e:  # a crash handler must never crash
            return {"error": f"{type(e).__name__}: {e}"}

    # -- restore -----------------------------------------------------------

    def candidate_steps(self) -> List[int]:
        """Restorable steps, newest first: committed (a blob key or a
        sharded ``COMMIT``) and not quarantined."""
        keys = self.store.list(self.name)
        quarantined = {int(m.group(1)) for m in
                       (re.search(r"step-(\d+)\.CORRUPT$", k) for k in keys)
                       if m}
        return sorted((s for s in self._steps_from(keys)
                       if s not in quarantined), reverse=True)

    def latest_step(self) -> Optional[int]:
        """The newest restorable step, from the listing. ``LATEST`` is
        written for the JAX package's readers and never read here: a
        missing, stale or quarantined pointer cannot hide a step."""
        cands = self.candidate_steps()
        return cands[0] if cands else None

    def restore(self, template, step: Optional[int] = None):
        """Restore into ``template``'s own tensors, in place (a state tree
        whose leaves are the live tensors, on any device), and return it.
        Every key, shape and dtype must match."""
        with goodput.phase("checkpoint"):
            return self._restore_any(template, step, in_place=True)

    def restore_host(self, template, step: Optional[int] = None):
        """A new tree of CPU tensors with ``template``'s structure; the
        template's tensors are not touched."""
        return self._restore_any(template, step, in_place=False)

    def restore_params_host(self, step: Optional[int] = None) -> dict:
        """The checkpoint's ``params`` subtree as CPU tensors, without a
        template: a blob decodes without one, and a sharded checkpoint's
        ``META`` names every leaf's path."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.name!r}")
        t0 = time.perf_counter()
        if not self._is_sharded(self.store, step):
            tree = self._decode_blob(self.store, step)
            self.timings["restore_s"] = time.perf_counter() - t0
            return tree["params"]
        reader = _ShardedReader(self.store, self._key(step), self.verify)
        out: dict = {}
        for i, info in enumerate(reader.meta["leaves"]):
            path = info["path"]
            if not path.startswith(".params"):
                continue
            keys = re.findall(r"\['([^']+)'\]", path[len(".params"):])
            if not keys:
                continue
            leaf = torch.empty(info["shape"],
                               dtype=torch_dtype(info["dtype"]))
            reader.fill(i, leaf)
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf
        if not out:
            raise OSError(f"checkpoint {self._key(step)} has no .params "
                          "leaves")
        self.timings["restore_s"] = time.perf_counter() - t0
        return out

    def _restore_any(self, template, step: Optional[int], in_place: bool):
        t0 = time.perf_counter()
        if step is not None:
            out = self._restore_step(template, step, in_place)
            self._last_verified = step
            self._m_verified.inc()
        else:
            cands = self.candidate_steps()
            if not cands:
                raise FileNotFoundError(f"no checkpoint under {self.name!r}")
            last: Optional[Exception] = None
            corrupt_seen = False
            for s in cands:
                try:
                    out = self._restore_step(template, s, in_place)
                except CheckpointCorrupt as e:
                    self._quarantine(s, e)
                    corrupt_seen = True
                    last = e
                    continue
                except FileNotFoundError as e:
                    last = e  # a racing GC or a torn listing: next older
                    continue
                self._last_verified = s
                self._m_verified.inc()
                if corrupt_seen:
                    self._m_fallbacks.inc()
                    rec = {"event": "ckpt_fallback", "name": self.name,
                           "restored_step": s}
                    flight.record(rec)
                    ttrace.emit_event(rec)
                break
            else:
                assert last is not None
                raise last
        self.timings["restore_s"] = time.perf_counter() - t0
        return out

    def _sources(self):
        """(label, store) in the order a step is read: a replicated
        store's cache, primary and peers; else the store alone."""
        if hasattr(self.store, "restore_sources"):
            return list(self.store.restore_sources())
        return [("store", self.store)]

    def _restore_step(self, template, step: int, in_place: bool):
        """Load and verify ``step`` from the first source that holds an
        intact copy. A copy failing verification is reported and the
        next source tried; an absent or unreachable source is skipped.
        Raises :class:`CheckpointCorrupt` only when every copy found
        failed; else the first absence or transport error (with one
        source: its own error, so a partition never reads as a missing
        or corrupt checkpoint)."""
        last: Optional[Exception] = None
        corrupt: Optional[CheckpointCorrupt] = None
        for label, src in self._sources():
            try:
                out = self._restore_verified(src, template, step, in_place)
            except CheckpointCorrupt as e:
                self._m_corrupt.inc()
                rec = {"event": "ckpt_corrupt", "name": self.name,
                       "step": step, "source": label, "detail": e.detail}
                flight.record(rec)
                ttrace.emit_event(rec)
                corrupt = e
                continue
            except OSError as e:  # absent here, or unreachable
                last = last or e
                continue
            if label not in ("store", "primary"):
                self._m_peer_restores.inc()
            self.timings["restore_source"] = label
            return out
        if corrupt is not None:
            raise corrupt
        raise last or FileNotFoundError(
            f"checkpoint step {step} absent under {self.name!r}")

    def _restore_verified(self, src, template, step: int, in_place: bool):
        if self._is_sharded(src, step):
            return self._load_sharded(src, template, step, in_place)
        if not src.exists(self._key(step)):
            raise FileNotFoundError(
                f"checkpoint step {step} absent under {self.name!r}")
        tree = self._decode_blob(src, step)
        problems = _structure_problems(template, tree)
        if problems:
            raise ValueError(_misfit(step, problems))
        pairs = []

        def check(path, dst):
            src = _leaf_of(tree, path)
            _check_leaf(path, dst, src.shape, src.dtype)
            pairs.append((dst, src))
            return src

        out = _rebuild(template, check)  # every leaf checked, then copied
        if not in_place:
            return out
        for dst, src in pairs:
            dst.copy_(src)
        return template

    def _decode_blob(self, src, step: int):
        blob = src.get(self._key(step))
        self.timings["restore_bytes"] = len(blob)
        self._check_blob(src, step, blob)
        try:
            return decode(blob)
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            # An unverified blob can still be torn: decode failure is
            # corruption, not a crash.
            raise CheckpointCorrupt(step, f"undecodable msgpack: {e}")

    def _read_manifest(self, src, step: int) -> Optional[dict]:
        try:
            raw = src.get(self._key(step) + ".manifest")
        except FileNotFoundError:
            return None  # a checkpoint from before manifests
        try:
            man = json.loads(bytes(raw))
            if not isinstance(man, dict):
                raise ValueError("manifest is not an object")
            return man
        except (ValueError, UnicodeDecodeError) as e:
            raise CheckpointCorrupt(step, f"unreadable manifest: {e}")

    def _check_blob(self, src, step: int, blob):
        if not self.verify:
            return
        man = self._read_manifest(src, step)
        if man is None:
            return
        if "nbytes" in man and int(man["nbytes"]) != len(blob):
            raise CheckpointCorrupt(
                step, f"size mismatch: manifest says {man['nbytes']} B, "
                      f"store has {len(blob)} B (truncated?)")
        if "crc32" in man:
            t0 = time.perf_counter()
            crc = _crc(blob)
            self.timings["restore_crc_s"] = time.perf_counter() - t0
            if int(man["crc32"]) != crc:
                raise CheckpointCorrupt(
                    step, f"crc mismatch: manifest {int(man['crc32']):#010x}"
                          f", payload {crc:#010x}")

    def _load_sharded(self, src, template, step: int, in_place: bool):
        reader = _ShardedReader(src, self._key(step), self.verify)
        by_path = {info["path"]: i
                   for i, info in enumerate(reader.meta["leaves"])}
        want = [p for p, _ in leaves_with_paths(template)]
        missing = [p for p in want if p not in by_path]
        extra = sorted(set(by_path) - set(want))
        if missing or extra:
            raise ValueError(_misfit(step, [f"missing {p}" for p in missing]
                                     + [f"unexpected {p}" for p in extra]))

        for path, dst in leaves_with_paths(template):
            info = reader.meta["leaves"][by_path[path]]
            _check_leaf(path, dst, info["shape"], torch_dtype(info["dtype"]))

        def put(path, dst):
            out = dst if in_place else torch.empty(dst.shape,
                                                   dtype=dst.dtype)
            reader.fill(by_path[path], out)
            return out

        # A chunk that fails its CRC raises with the leaves before it
        # already written: a failed in-place restore leaves the state
        # partly overwritten, never silently used.
        out = _rebuild(template, put)
        self.timings["restore_bytes"] = reader.nbytes
        return template if in_place else out

    # -- quarantine --------------------------------------------------------

    def _quarantine(self, step: int, err: CheckpointCorrupt):
        """Mark a step corrupt so no later restore retries it; its data
        stays for forensics until GC."""
        rec = {"event": "ckpt_quarantined", "name": self.name,
               "step": step, "detail": err.detail}
        flight.record(rec)
        ttrace.emit_event(rec)
        try:
            self.store.put(self._key(step) + ".CORRUPT", json.dumps(
                {"step": step, "detail": err.detail,
                 "at_unix_s": round(time.time(), 3)}).encode())
        except OSError:
            pass

    # -- internals ---------------------------------------------------------

    def _key(self, step: int) -> str:
        return f"{self.name}/step-{step:010d}"

    def _is_sharded(self, src, step: int) -> bool:
        return src.exists(f"{self._key(step)}/COMMIT")

    @staticmethod
    def _steps_from(keys) -> List[int]:
        out = set()
        for key in keys:
            m = re.search(r"step-(\d+)($|/COMMIT$)", key)
            if m:
                out.add(int(m.group(1)))
        return sorted(out)

    def _gc(self, current: int):
        """Keep the newest ``keep`` committed steps; sweep uncommitted or
        quarantined debris older than ``current``; never the last verified
        step."""
        keys = self.store.list(self.name)
        steps = self._steps_from(keys)
        seen = {int(m.group(1)) for m in
                (re.search(r"step-(\d+)[/.]", k) for k in keys) if m}
        protected = {current, self._last_verified}
        dead = [s for s in seen - set(steps)
                if s < current and s not in protected]
        old = [s for s in (steps[:-self.keep] if self.keep > 0 else [])
               if s not in protected]
        for victim in old + dead:
            prefix = self._key(victim)
            victims = [k for k in keys
                       if k == prefix or k.startswith(prefix + "/")
                       or k.startswith(prefix + ".")]
            # Commit markers first: a reader racing the GC sees the step
            # vanish whole, never a committed step with holes.
            victims.sort(key=lambda k: not (k.endswith("/COMMIT")
                                            or k.endswith(".manifest")))
            for key in victims:
                try:
                    self.store.delete(key)
                except OSError:
                    pass


class _ShardedReader:
    """``META`` and every process's chunk index of one sharded checkpoint,
    read eagerly (they are small); chunk data is read by range on demand,
    its CRC checked against the index before it lands anywhere."""

    def __init__(self, store, prefix: str, verify: bool = True):
        self.store = store
        self.prefix = prefix
        self.verify = verify
        self.nbytes = 0
        self._scratch: Optional[memoryview] = None
        m = re.search(r"step-(\d+)", prefix)
        self.step = int(m.group(1)) if m else -1
        self.meta = self._json(f"{prefix}/META")
        self.by_leaf: Dict[int, List[dict]] = {}
        for p in range(self.meta["n_procs"]):
            idx = self._json(f"{prefix}/proc-{p:05d}.idx")
            nb = None
            if isinstance(idx, dict):  # the layout with a stamped size
                nb = idx.get("dat_nbytes")
                idx = idx["chunks"]
            for c in idx:
                c["proc"] = p
                if nb is not None and c["offset"] + c["nbytes"] > nb:
                    raise CheckpointCorrupt(
                        self.step, f"proc-{p} chunk at {c['offset']} runs "
                                   f"past the stamped .dat size {nb} "
                                   "(truncated?)")
                self.by_leaf.setdefault(c["leaf"], []).append(c)

    def _json(self, key: str):
        raw = self.store.get(key)
        try:
            return json.loads(bytes(raw))
        except (ValueError, UnicodeDecodeError) as e:
            raise CheckpointCorrupt(self.step, f"unreadable {key}: {e}")

    def _chunk(self, c: dict, dtype: torch.dtype) -> torch.Tensor:
        """Chunk ``c`` as a tensor over the reader's one scratch buffer
        (the largest chunk's size, mapped once a restore): valid until
        the next chunk is read."""
        if self._scratch is None:
            self._scratch = host_buffer(max(1, max(
                x["nbytes"] for cs in self.by_leaf.values() for x in cs)))
        raw = self.store.get_range(f"{self.prefix}/proc-{c['proc']:05d}.dat",
                                   c["offset"], c["nbytes"],
                                   out=self._scratch)
        if len(raw) != c["nbytes"]:
            raise CheckpointCorrupt(
                self.step, f"chunk at proc-{c['proc']}+{c['offset']}: got "
                           f"{len(raw)} of {c['nbytes']} B (truncated)")
        if self.verify and "crc" in c and _crc(raw) != c["crc"]:
            raise CheckpointCorrupt(
                self.step, f"chunk at proc-{c['proc']}+{c['offset']}: crc "
                           f"mismatch (idx {c['crc']:#010x}, data "
                           f"{_crc(raw):#010x})")
        self.nbytes += len(raw)
        shape = [b - a for a, b in zip(c["start"], c["stop"])]
        if dtype == torch.bfloat16:
            arr = np.frombuffer(raw, dtype=np.uint16)
            return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
        return torch.from_numpy(np.frombuffer(
            raw, dtype=np.dtype(dtype_name(dtype)))).reshape(shape)

    def fill(self, leaf: int, out: torch.Tensor):
        """Copy every saved chunk of ``leaf`` into its box of ``out`` (the
        whole leaf); the boxes must cover it."""
        chunks = self.by_leaf.get(leaf, [])
        if out.dim() == 0:
            if not chunks:
                raise CheckpointCorrupt(
                    self.step, f"leaf {leaf} missing from {self.prefix}")
            out.copy_(self._chunk(chunks[0], out.dtype).reshape(()))
            return
        got = 0
        for c in chunks:
            box = tuple(slice(a, b) for a, b in zip(c["start"], c["stop"]))
            out[box].copy_(self._chunk(c, out.dtype))
            got += int(np.prod([b - a for a, b in
                                zip(c["start"], c["stop"])]))
        if got != out.numel():
            raise CheckpointCorrupt(
                self.step, f"leaf {leaf}: chunks cover {got}/{out.numel()} "
                           "elements")
