"""Byte accounting of the data-center network, the part of
``serverless_learn_tpu/telemetry/dcn.py`` the elastic trainer uses:
:func:`instrument_store` wraps a checkpoint store so each data-bearing
call (``put``, ``get``, ``get_range``) records a transfer under a
consumer (the elastic trainer's is ``remesh``), into the reference's
series:

* ``slt_dcn_bytes_total{consumer, direction=tx|rx}``;
* ``slt_dcn_transfers_total{consumer}`` and
  ``slt_dcn_transfer_seconds{consumer}`` (one observation a transfer);
* ``slt_dcn_transfer_time_seconds_total{consumer}``;
* ``slt_dcn_effective_bandwidth_bytes_per_s{consumer}``, cumulative bytes
  over cumulative transfer seconds.

Metadata calls (``exists``, ``list``, ``delete``) pass through uncounted.
The rest of the reference's module (logical bytes and the compression
ratio of quantized exchanges, the snapshot rollup) waits (ROADMAP.md
queue 1 item 1t.b).
"""

from __future__ import annotations

import threading
import time
import weakref

from serverless_learn_tpu_torch.telemetry.registry import (LATENCY_BUCKETS,
                                                           get_registry)

_meters_lock = threading.Lock()
# registry -> {consumer: _Meter}; weak keys, so a freed test registry's
# recycled id never hands its meters to another.
_meters: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _Meter:
    """The series of one (registry, consumer) and the cumulative bytes
    and seconds behind the bandwidth gauge."""

    def __init__(self, reg, consumer: str):
        self.tx = reg.counter(
            "slt_dcn_bytes_total",
            "bytes moved over DCN, by consumer and direction",
            consumer=consumer, direction="tx")
        self.rx = reg.counter(
            "slt_dcn_bytes_total",
            "bytes moved over DCN, by consumer and direction",
            consumer=consumer, direction="rx")
        self.transfers = reg.counter(
            "slt_dcn_transfers_total",
            "DCN transfers, by consumer", consumer=consumer)
        self.seconds = reg.counter(
            "slt_dcn_transfer_time_seconds_total",
            "cumulative DCN transfer wall-clock, by consumer",
            consumer=consumer)
        self.hist = reg.histogram(
            "slt_dcn_transfer_seconds",
            "per-transfer duration, by consumer",
            buckets=LATENCY_BUCKETS, consumer=consumer)
        self.bw = reg.gauge(
            "slt_dcn_effective_bandwidth_bytes_per_s",
            "cumulative bytes / cumulative transfer seconds, by consumer",
            consumer=consumer)
        self._lock = threading.Lock()
        self._bytes = 0.0
        self._seconds = 0.0

    def record(self, direction: str, nbytes: int, seconds: float):
        nbytes = max(0, int(nbytes))
        seconds = max(0.0, float(seconds))
        (self.tx if direction == "tx" else self.rx).inc(nbytes)
        self.transfers.inc()
        self.seconds.inc(seconds)
        self.hist.observe(seconds)
        with self._lock:
            self._bytes += nbytes
            self._seconds += seconds
            bw = self._bytes / self._seconds if self._seconds > 0 else None
        if bw is not None:
            self.bw.set(bw)


def meter(consumer: str, registry=None) -> _Meter:
    reg = registry or get_registry()
    with _meters_lock:
        per_reg = _meters.get(reg)
        if per_reg is None:
            per_reg = _meters[reg] = {}
        m = per_reg.get(consumer)
        if m is None:
            m = per_reg[consumer] = _Meter(reg, consumer)
        return m


def record_transfer(consumer: str, direction: str, nbytes: int,
                    seconds: float, registry=None):
    """One transfer: ``tx`` (this process sent) or ``rx`` (received)."""
    if direction not in ("tx", "rx"):
        raise ValueError(f"direction must be tx or rx, got {direction!r}")
    meter(consumer, registry).record(direction, nbytes, seconds)


def _nbytes(data) -> int:
    return len(memoryview(data).cast("B")) if data is not None else 0


class InstrumentedStore:
    """A store whose data-bearing calls record transfers under
    ``consumer``; other attributes are the inner store's."""

    def __init__(self, inner, consumer: str, registry=None):
        self._inner = inner
        self._consumer = consumer
        self._registry = registry

    def _record(self, direction: str, nbytes: int, seconds: float):
        try:
            record_transfer(self._consumer, direction, nbytes, seconds,
                            registry=self._registry)
        except Exception:
            pass  # accounting never hurts the transfer it measures

    def put(self, key: str, data):
        t0 = time.monotonic()
        out = self._inner.put(key, data)
        self._record("tx", _nbytes(data), time.monotonic() - t0)
        return out

    def get(self, key: str):
        t0 = time.monotonic()
        data = self._inner.get(key)
        self._record("rx", _nbytes(data), time.monotonic() - t0)
        return data

    def get_range(self, key: str, offset: int, length, out=None):
        t0 = time.monotonic()
        data = self._inner.get_range(key, offset, length, out=out)
        self._record("rx", _nbytes(data), time.monotonic() - t0)
        return data

    def exists(self, key: str) -> bool:
        return self._inner.exists(key)

    def list(self, prefix: str):
        return self._inner.list(prefix)

    def delete(self, key: str):
        return self._inner.delete(key)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def instrument_store(store, consumer: str, registry=None,
                     enabled: bool = True):
    """``store`` wrapped for byte accounting; itself when disabled, None,
    or already wrapped for the same consumer."""
    if not enabled or store is None:
        return store
    if isinstance(store, InstrumentedStore) and store._consumer == consumer:
        return store
    return InstrumentedStore(store, consumer, registry=registry)
