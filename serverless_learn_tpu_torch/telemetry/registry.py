"""The process's metrics registry: counters, gauges, fixed-bucket
histograms, request spans and the JSONL event sink. A copy of
``serverless_learn_tpu/telemetry/registry.py`` with the same metric
names, label sets, bucket sets and rendering, so the reference's readers
(``slt top``, ``slt doctor``, Prometheus dashboards) read either package.

Metric naming (Prometheus conventions): every metric starts with
``slt_``; counters end in ``_total``; durations are ``_seconds``;
labels are low-cardinality (``engine="continuous"|"static"``), never per
request.

A :class:`Span` is a set of named marks on one monotonic clock (submit,
admit, first_token, done); the serving engines derive their queue-wait,
TTFT and latency observations from span marks, so the histograms and the
per-request records cannot drift apart.
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# Fixed latency buckets (seconds): sub-millisecond queue waits up to
# minute-scale full-request latencies. Shared so every latency histogram
# in the process is cross-comparable.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# Batch/slot-count style quantities.
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# Rates (tokens/s, samples/s) observed per request/step.
RATE_BUCKETS = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                10000, 25000, 50000)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(items: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    # Integers render without a trailing .0 — what prometheus clients emit.
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Counter:
    """Monotonic accumulator. ``inc`` only; thread-safe."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar; thread-safe."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative-bucket semantics).

    ``observe`` is O(log buckets); ``percentile`` interpolates linearly
    inside the winning bucket (the same estimate PromQL's
    ``histogram_quantile`` computes), so `slt top` and the bench-row
    emitter can report p50/p95/p99 from one scrape.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be sorted and non-empty: {buckets}")
        self._lock = threading.Lock()
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float):
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, cumulative = 0, []
        for c in counts:
            cum += c
            cumulative.append(cum)
        return {"buckets": list(self.buckets), "cumulative": cumulative,
                "sum": s, "count": total}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]); None when empty."""
        snap = self.snapshot()
        return percentile_from_buckets(
            snap["buckets"], snap["cumulative"], q)


def percentile_from_buckets(buckets: List[float], cumulative: List[int],
                            q: float) -> Optional[float]:
    """histogram_quantile over cumulative bucket counts; shared by live
    Histograms and `slt top`'s parse of a scraped endpoint."""
    total = cumulative[-1] if cumulative else 0
    if total <= 0:
        return None
    rank = q * total
    for i, cum in enumerate(cumulative):
        if cum >= rank:
            if i >= len(buckets):  # +Inf bucket: no upper bound to lerp to
                return buckets[-1] if buckets else None
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            prev = cumulative[i - 1] if i > 0 else 0
            inside = cum - prev
            frac = (rank - prev) / inside if inside else 1.0
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return buckets[-1] if buckets else None


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: a type, help text, and children keyed by labels."""

    def __init__(self, name: str, mtype: str, help_: str):
        self.name = name
        self.type = mtype
        self.help = help_
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


class MetricsRegistry:
    """Thread-safe metric family table; the process-wide one is
    :func:`get_registry`, but subsystems accept an explicit registry so
    tests (and multi-tenant processes) can isolate their counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get(self, name: str, mtype: str, help_: str, labels: Dict[str, str],
             factory):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, mtype, help_)
                self._families[name] = fam
            elif fam.type != mtype:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.type}, "
                    f"requested {mtype}")
            child = fam.children.get(key)
            if child is None:
                child = factory()
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  **labels) -> Histogram:
        h = self._get(name, "histogram", help, labels,
                      lambda: Histogram(buckets))
        if h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}")
        return h

    # -- rendering ---------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        with self._lock:
            families = [(f.name, f.type, f.help,
                         sorted(f.children.items()))
                        for f in self._families.values()]
        for name, mtype, help_, children in sorted(families):
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {mtype}")
            for labels, child in children:
                if mtype == "histogram":
                    snap = child.snapshot()
                    for le, cum in zip(
                            list(snap["buckets"]) + ["+Inf"],
                            snap["cumulative"]):
                        le_s = "+Inf" if le == "+Inf" else _fmt_value(le)
                        lbl = _fmt_labels(labels, 'le="%s"' % le_s)
                        out.append(f"{name}_bucket{lbl} {cum}")
                    out.append(f"{name}_sum{_fmt_labels(labels)}"
                               f" {_fmt_value(snap['sum'])}")
                    out.append(f"{name}_count{_fmt_labels(labels)}"
                               f" {snap['count']}")
                else:
                    out.append(f"{name}{_fmt_labels(labels)}"
                               f" {_fmt_value(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able nested snapshot (the /metrics.json shape)."""
        out: dict = {}
        with self._lock:
            families = [(f.name, f.type, sorted(f.children.items()))
                        for f in self._families.values()]
        for name, mtype, children in families:
            fam_out = {"type": mtype, "series": []}
            for labels, child in children:
                row: dict = {"labels": dict(labels)}
                if mtype == "histogram":
                    row.update(child.snapshot())
                else:
                    row["value"] = child.value
                fam_out["series"].append(row)
            out[name] = fam_out
        return out


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem defaults to."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


# -- request spans -----------------------------------------------------------


def _rand_hex(n_bytes: int) -> str:
    return os.urandom(n_bytes).hex()


class Span:
    """One request's trace context: named marks on a monotonic clock.

    Cheap by design (a dict of floats, no locks: each span is owned by the
    request flowing through the pipeline; writers hand off with the
    request). ``between`` returns durations for histogram observation;
    ``to_event`` is the JSONL event-log record shape.

    A span also carries distributed-trace identity — a W3C-style
    128-bit ``trace_id``, its own 64-bit ``span_id``, an optional
    ``parent_id`` (the caller's span, possibly in ANOTHER process), and the
    wall-clock start ``t0_unix`` — so per-node JSONL logs can be merged
    into one causal cross-node timeline (the reference's ``slt trace``).
    Marks stay on the monotonic clock; only the anchor is wall time.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0",
                 "t0_unix", "marks", "meta")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 span_id: Optional[str] = None):
        self.name = name
        self.trace_id = trace_id or _rand_hex(16)
        self.span_id = span_id or _rand_hex(8)
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t0_unix = time.time()
        self.marks: Dict[str, float] = {}
        self.meta: Dict[str, object] = {}

    def mark(self, event: str) -> float:
        t = time.perf_counter() - self.t0
        # First mark wins: a retried/harvest-raced mark must not rewrite
        # the earlier (true) time.
        self.marks.setdefault(event, t)
        return t

    def between(self, a: Optional[str], b: str) -> Optional[float]:
        """Seconds from mark ``a`` (None = span start) to mark ``b``."""
        if b not in self.marks:
            return None
        start = 0.0 if a is None else self.marks.get(a)
        if start is None:
            return None
        return self.marks[b] - start

    @property
    def duration_s(self) -> float:
        """Span start to its latest mark (0.0 while unmarked)."""
        return max(self.marks.values()) if self.marks else 0.0

    def finish(self) -> float:
        """Mark the canonical end ("done"); returns the duration."""
        self.mark("done")
        return self.duration_s

    def to_event(self) -> dict:
        rec = {"event": "span", "span": self.name,
               "trace_id": self.trace_id,
               "span_id": self.span_id,
               "t0_unix_s": round(self.t0_unix, 6),
               "duration_s": round(self.duration_s, 6),
               "marks_s": {k: round(v, 6)
                           for k, v in sorted(self.marks.items())},
               **{k: v for k, v in self.meta.items()}}
        if self.parent_id:
            rec["parent_id"] = self.parent_id
        return rec


DEFAULT_EVENT_LOG_MAX_BYTES = 128 * 1024 * 1024


class JsonlEventLog:
    """Append-only JSONL event sink (benchlog-style one-object-per-line),
    for request spans and lifecycle events. Thread-safe; never raises into
    the serving path (a full disk must not kill a request).

    The handle is persistent (one ``open`` per request span would add up
    on a busy server) and the file rotates at ``max_bytes``: the current log
    moves to ``<path>.1`` (one generation, overwriting the previous) and
    a fresh file continues. `slt trace`'s directory expansion picks up
    ``*.jsonl.1`` beside ``*.jsonl``, so a rotated node still merges into
    one timeline."""

    def __init__(self, path: str,
                 max_bytes: int = DEFAULT_EVENT_LOG_MAX_BYTES):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self._lock = threading.Lock()
        self._f = None
        self._size = 0

    def _ensure_open_locked(self):
        if self._f is None:
            self._f = open(self.path, "a")
            self._size = os.fstat(self._f.fileno()).st_size

    def _drop_handle_locked(self):
        try:
            if self._f is not None:
                self._f.close()
        except (IOError, OSError, ValueError):
            pass
        self._f = None

    def emit(self, record: dict):
        line = json.dumps(dict(record,
                               ts=time.strftime("%Y-%m-%dT%H:%M:%S"))) + "\n"
        try:
            with self._lock:
                self._ensure_open_locked()
                if self._size and self._size + len(line) > self.max_bytes:
                    # Rotate: close, shift to .1 (previous .1 is replaced),
                    # reopen fresh. Readers tailing the old inode keep it.
                    self._drop_handle_locked()
                    os.replace(self.path, self.path + ".1")
                    self._ensure_open_locked()
                self._f.write(line)
                self._f.flush()
                self._size += len(line)
        except (IOError, OSError, ValueError):
            # Drop the handle so the next emit retries a clean open (the
            # file may have been deleted or the disk filled and recovered).
            with self._lock:
                self._drop_handle_locked()

    def close(self):
        with self._lock:
            self._drop_handle_locked()
