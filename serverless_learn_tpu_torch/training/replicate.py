"""Checkpoint replicas for a fast rejoin, the port of
``serverless_learn_tpu/training/replicate.py``.

An elastic transition saves the state and restores it a moment later; a
restarted worker restores the newest state. Through the central store
(the shard server) both reads cross the network. :class:`ReplicatedStore`
keeps that store authoritative and adds two cheaper copies of every
checkpoint file:

* a **worker-local cache** (a :class:`~serverless_learn_tpu_torch.training.
  checkpoint.LocalStore` directory): every ``put`` lands there first, so a
  transition's restore is a local read. The cache is a directory, so a
  restarted worker rejoins from it too;
* **peer replicas**: each commit is pushed, in commit order, to the first
  ``fanout`` peers, caches that other workers serve over the shard-server
  protocol (:func:`serve_cache`). A worker whose cache is gone restores
  from a peer's copy when the central store is slow or unreachable.

The :class:`~serverless_learn_tpu_torch.training.checkpoint.Checkpointer`
reads the replicas through :meth:`ReplicatedStore.restore_sources` (cache,
then primary, then peers) and checks the sizes and CRCs of whichever copy
it loads, so a copy corrupted anywhere is healed by any intact copy of the
same step.

Pushes never hold the training thread: one daemon thread drains a bounded
queue of ``_QUEUE_DEPTH`` entries in order (a peer never sees a manifest
before its blob); a full queue drops its oldest entry. Failures and drops
count in ``slt_ckpt_replica_push_failures_total``, pushes in
``slt_ckpt_replica_pushes_total``, and each pushed file's bytes under the
DCN consumer ``replica_push`` (``telemetry/dcn.py``).

    python -m serverless_learn_tpu_torch.training.replicate --root DIR

serves ``DIR`` as a peer cache (:func:`serve_cache`) until SIGTERM,
printing its address as one JSON line.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from serverless_learn_tpu_torch.telemetry import dcn
from serverless_learn_tpu_torch.telemetry.registry import get_registry
from serverless_learn_tpu_torch.training.checkpoint import (LocalStore,
                                                            ShardServerStore)


def _peer_store(addr: str):
    return ShardServerStore(addr)


class ReplicatedStore:
    """A local cache, the authoritative ``primary`` and best-effort peer
    replicas behind the store surface (``put``, ``get``, ``get_range``,
    ``exists``, ``list``, ``delete``).

    ``peers`` are stores (tests) or ``host:port`` addresses dialled on
    first use through ``peer_factory`` (default: a
    :class:`ShardServerStore`, for a peer's :func:`serve_cache`). The
    first ``fanout`` peers receive pushes; every peer is a restore
    source."""

    _QUEUE_DEPTH = 256

    def __init__(self, primary, cache: Optional[LocalStore] = None,
                 peers: Sequence = (), fanout: int = 2,
                 peer_factory: Optional[Callable] = None):
        self.primary = primary
        self.cache = cache
        self._peer_specs = list(peers)
        self._peer_factory = peer_factory or _peer_store
        self._peer_stores: List = [
            None if isinstance(p, str) else p for p in self._peer_specs]
        self.fanout = max(0, int(fanout))
        self._q: "queue.Queue" = queue.Queue(maxsize=self._QUEUE_DEPTH)
        self._push_thread: Optional[threading.Thread] = None
        # id(data) -> pushes queued or in flight that read it (``holds``).
        self._held: Dict[int, int] = {}
        self._held_lock = threading.Lock()
        reg = get_registry()
        self._m_pushes = reg.counter(
            "slt_ckpt_replica_pushes_total",
            "checkpoint files pushed to peer replicas")
        self._m_push_failures = reg.counter(
            "slt_ckpt_replica_push_failures_total",
            "peer pushes that failed or were dropped (best-effort)")

    # -- peers --------------------------------------------------------------

    def _peer(self, i: int):
        p = self._peer_stores[i]
        if p is None:
            try:
                p = self._peer_factory(self._peer_specs[i])
            except OSError:
                return None  # down: dialled again at the next use
            self._peer_stores[i] = p
        return p

    def restore_sources(self) -> List[Tuple[str, object]]:
        """(label, store) of each replica, nearest first: the order in
        which the Checkpointer reads a step."""
        out: List[Tuple[str, object]] = []
        if self.cache is not None:
            out.append(("cache", self.cache))
        out.append(("primary", self.primary))
        for i, spec in enumerate(self._peer_specs):
            p = self._peer(i)
            if p is not None:
                label = spec if isinstance(spec, str) else f"peer-{i}"
                out.append((f"peer:{label}", p))
        return out

    def _replicas(self, skip_cache: bool = False):
        for label, src in self.restore_sources():
            if label == "primary" or (skip_cache and label == "cache"):
                continue
            yield label, src

    # -- the push thread ----------------------------------------------------

    def holds(self, data) -> bool:
        """Whether a queued or running push still reads ``data``: a caller
        that reuses its buffers (the sharded save) must not overwrite it
        yet."""
        with self._held_lock:
            return id(data) in self._held

    def _hold(self, data, n: int):
        if data is None:
            return
        with self._held_lock:
            k = self._held.get(id(data), 0) + n
            if k > 0:
                self._held[id(data)] = k
            else:
                self._held.pop(id(data), None)

    def _enqueue(self, op: str, key: str, data):
        if self.fanout <= 0 or not self._peer_specs:
            return
        if self._push_thread is None:
            self._push_thread = threading.Thread(
                target=self._push_loop, daemon=True,
                name=f"ckpt-replica-push-{id(self):x}")
            self._push_thread.start()
        self._hold(data, 1)
        try:
            self._q.put_nowait((op, key, data))
        except queue.Full:
            # Never hold the training thread on a slow peer: drop the
            # oldest entry (a newer step supersedes it) and count it.
            self._m_push_failures.inc()
            try:
                dropped = self._q.get_nowait()
                self._q.task_done()
                self._hold(dropped and dropped[2], -1)
            except queue.Empty:
                pass
            try:
                self._q.put_nowait((op, key, data))
            except queue.Full:
                self._hold(data, -1)

    def _push_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                op, key, data = item
                for i in range(min(self.fanout, len(self._peer_specs))):
                    p = self._peer(i)
                    if p is None:
                        self._m_push_failures.inc()
                        continue
                    t0 = time.monotonic()
                    try:
                        if op == "put":
                            p.put(key, data)
                            dcn.record_transfer(
                                "replica_push", "tx",
                                len(memoryview(data).cast("B")),
                                time.monotonic() - t0)
                        else:
                            p.delete(key)
                        self._m_pushes.inc()
                    except OSError:
                        self._m_push_failures.inc()
                self._hold(data, -1)
            finally:
                self._q.task_done()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until every queued push has been tried; True unless
        ``timeout_s`` ran out first."""
        deadline = time.monotonic() + timeout_s
        while self._q.unfinished_tasks:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def close(self):
        """Stop the push thread once the queued pushes are tried. The
        primary, the cache and the peers stay open: they are the
        caller's."""
        if self._push_thread is not None:
            self._q.put(None)
            self._push_thread.join(timeout=5.0)
            self._push_thread = None

    # -- the store surface --------------------------------------------------

    def put(self, key: str, data):
        # The cache first (cheap, survives a crash), the peers next (on the
        # push thread), the primary last: a partitioned primary still
        # leaves the newest state in the replicas, and the caller still
        # sees the primary's failure.
        if self.cache is not None:
            self.cache.put(key, data)
        self._enqueue("put", key, data)
        self.primary.put(key, data)

    def get(self, key: str):
        if key.endswith("/LATEST"):
            # The one mutable key: the primary's is the truth. Only when
            # it is unreachable do the replicas vote, the newest step
            # winning (a lagging peer must not roll the run back).
            try:
                return self.primary.get(key)
            except FileNotFoundError:
                raise
            except OSError as e:
                best = None
                for _, src in self._replicas():
                    try:
                        data = src.get(key)
                        step = int(json.loads(bytes(data))["step"])
                    except Exception:
                        continue
                    if best is None or step > best[0]:
                        best = (step, data)
                if best is None:
                    raise e
                return best[1]
        if self.cache is not None:
            try:
                return self.cache.get(key)
            except OSError:
                pass
        try:
            data = self.primary.get(key)
        except FileNotFoundError:
            raise
        except OSError as e:
            for _, src in self._replicas(skip_cache=True):
                try:
                    return src.get(key)
                except Exception:
                    continue
            raise e
        if self.cache is not None:
            try:
                self.cache.put(key, data)
            except OSError:
                pass
        return data

    def get_range(self, key: str, offset: int, length, out=None):
        if self.cache is not None and self.cache.exists(key):
            return self.cache.get_range(key, offset, length, out=out)
        try:
            return self.primary.get_range(key, offset, length, out=out)
        except FileNotFoundError:
            raise
        except OSError as e:
            for _, src in self._replicas(skip_cache=True):
                try:
                    return src.get_range(key, offset, length, out=out)
                except Exception:
                    continue
            raise e

    def exists(self, key: str) -> bool:
        if self.cache is not None and self.cache.exists(key):
            return True
        try:
            return self.primary.exists(key)
        except OSError:
            for _, src in self._replicas(skip_cache=True):
                try:
                    if src.exists(key):
                        return True
                except Exception:
                    continue
            raise

    def list(self, prefix: str) -> List[str]:
        try:
            return self.primary.list(prefix)
        except FileNotFoundError:
            raise
        except OSError:
            # The primary is unreachable: the union of the replicas'
            # listings is the best set of candidates for a rejoin.
            seen = set()
            for _, src in self._replicas():
                try:
                    seen.update(src.list(prefix))
                except Exception:
                    continue
            return sorted(seen)

    def delete(self, key: str):
        if self.cache is not None:
            try:
                self.cache.delete(key)
            except OSError:
                pass
        self._enqueue("delete", key, None)
        self.primary.delete(key)


def serve_cache(root: str, host: str = "127.0.0.1", port: int = 0):
    """Serve a worker's checkpoint cache to its peers over the
    shard-server protocol (the port's ``control/daemons.ShardServer`` on
    ``root``). Returns the running server; its ``addr`` is what peers
    configure, and ``stop()`` ends it."""
    from serverless_learn_tpu_torch.control.daemons import ShardServer

    return ShardServer(host=host, port=port, root=root).start()


def maybe_replicated(store, cfg):
    """``store`` wrapped as ``config.CheckpointConfig`` says; ``store``
    itself when no cache and no peer is configured, so callers wrap
    unconditionally."""
    if cfg is None:
        return store
    peers = [p.strip() for p in (cfg.peers or "").split(",") if p.strip()]
    if not cfg.cache_dir and not peers:
        return store
    cache = LocalStore(cfg.cache_dir) if cfg.cache_dir else None
    return ReplicatedStore(store, cache=cache, peers=peers,
                           fanout=cfg.replica_fanout)


def main(argv=None) -> int:
    import argparse

    from serverless_learn_tpu_torch.control.daemons import (
        ShardServer, _run_until_sigterm)

    p = argparse.ArgumentParser(
        prog="python -m serverless_learn_tpu_torch.training.replicate",
        description="serve a checkpoint cache directory to peers")
    p.add_argument("--root", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    srv = ShardServer(host=args.host, port=args.port, root=args.root)
    print(json.dumps({"event": "ckpt_cache_up", "addr": srv.addr,
                      "root": srv.root}), flush=True)
    return _run_until_sigterm(srv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
