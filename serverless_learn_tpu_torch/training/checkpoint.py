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

Not ported yet, each raising where it would be reached: the shard-server
store and replicated restore sources (ROADMAP.md queue 1 item 5), the
emergency save on the flight recorder's death path (queue 1 item 3e, with
the flight recorder) and the ZeRO layouts (queue 1 item 3d). The metrics
registry's counters wait for the telemetry items (1b, 3e).
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

from serverless_learn_tpu_torch.config import not_ported
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


class LocalStore:
    """Keys as files under ``root``; ``put`` is atomic (tmp + rename).
    ``get`` returns a writable buffer (``utils.serialization.host_buffer``),
    so arrays decoded from it are writable views of it."""

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
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, key: str) -> memoryview:
        return self.get_range(key, 0, None)

    def get_range(self, key: str, offset: int,
                  length: Optional[int]) -> memoryview:
        with open(self._path(key), "rb") as f:
            size = os.fstat(f.fileno()).st_size
            n = max(0, size - offset) if length is None else max(
                0, min(length, size - offset))
            out = host_buffer(n)
            f.seek(offset)
            got = f.readinto(out)
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
    """The shard-server store of the reference (``--checkpoint-store``)."""

    def __init__(self, addr: str):
        raise not_ported(f"the shard-server checkpoint store ({addr})",
                         "ROADMAP.md queue 1 item 5")


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
        # The newest step that restored and verified: _gc never collects
        # it, since after a quarantine it is the state to fall back to.
        self._last_verified: Optional[int] = None
        self._atexit_armed = False

    # -- save --------------------------------------------------------------

    def save(self, tree, step: Optional[int] = None) -> int:
        """Copy ``tree`` into a blob now (the state may change as soon as
        this returns), then commit it on the upload thread."""
        if self.sharded:
            return self.save_sharded(tree, step)
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

    def _put_blob(self, step: int, blob):
        """Blob, manifest, ``LATEST``, in that order: a crash between two
        leaves a complete older or a complete newer commit, never a
        pointer at torn bytes."""
        key = self._key(step)
        t0 = time.perf_counter()
        self.store.put(key, blob)
        t1 = time.perf_counter()
        crc = _crc(blob)
        t2 = time.perf_counter()
        manifest = {"step": step, "layout": "blob", "nbytes": len(blob),
                    "crc32": crc}
        self.store.put(key + ".manifest", json.dumps(manifest).encode())
        self.store.put(f"{self.name}/LATEST",
                       json.dumps({"step": step}).encode())
        self.timings.update(upload_s=time.perf_counter() - t0 - (t2 - t1),
                            crc_s=t2 - t1)

    def save_sharded(self, tree, step: Optional[int] = None) -> int:
        """The sharded layout from one process, synchronously: one chunk
        per leaf in ``proc-00000.dat``, CRC-stamped in its ``.idx``."""
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
        data = host_buffer(offset)
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
        self._gc(step)
        return step

    def wait(self):
        """Block until the upload in flight has committed; re-raise its
        error."""
        if self._pending is not None:
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
        """Drain the upload in flight and disarm the atexit drain.
        Idempotent."""
        try:
            self.wait()
        finally:
            if self._atexit_armed:
                atexit.unregister(self._drain_at_exit)
                self._atexit_armed = False

    def arm_emergency(self, *args, **kwargs):
        raise not_ported("the emergency save on the flight recorder's "
                         "death path", "ROADMAP.md queue 1 item 3e")

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
        else:
            cands = self.candidate_steps()
            if not cands:
                raise FileNotFoundError(f"no checkpoint under {self.name!r}")
            last: Optional[Exception] = None
            for s in cands:
                try:
                    out = self._restore_step(template, s, in_place)
                except CheckpointCorrupt as e:
                    self._quarantine(s, e)
                    last = e
                    continue
                except FileNotFoundError as e:
                    last = e  # a racing GC or a torn listing: next older
                    continue
                self._last_verified = s
                break
            else:
                assert last is not None
                raise last
        self.timings["restore_s"] = time.perf_counter() - t0
        return out

    def _restore_step(self, template, step: int, in_place: bool):
        if self._is_sharded(self.store, step):
            return self._load_sharded(template, step, in_place)
        if not self.store.exists(self._key(step)):
            raise FileNotFoundError(
                f"checkpoint step {step} absent under {self.name!r}")
        tree = self._decode_blob(self.store, step)
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

    def _load_sharded(self, template, step: int, in_place: bool):
        reader = _ShardedReader(self.store, self._key(step), self.verify)
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
        raw = self.store.get_range(f"{self.prefix}/proc-{c['proc']:05d}.dat",
                                   c["offset"], c["nbytes"])
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
