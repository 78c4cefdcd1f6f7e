"""Trace context propagation and span emission, a copy of
``serverless_learn_tpu/telemetry/tracing.py``.

* :class:`TraceContext`: (trace_id, span_id, flags), rendered as a W3C
  ``traceparent`` value ``00-<32 hex>-<16 hex>-<2 hex>``; the serving
  wire accepts it as a ``"traceparent"`` member of a request.
* The ambient context is a :mod:`contextvars` slot. ``span(name)`` opens
  a child span, makes it current for the block and emits it on exit.
* ``init_tracing(node=..., events_log=...)`` names the process (the
  ``node`` field of every record), opens an optional JSONL sink and arms
  the flight recorder. Every emitted span and event also lands in the
  flight recorder's ring (``telemetry/flight.py``).

The host-span tracer of ``serverless_learn_tpu/utils/tracing.py``
(:class:`Tracer`, :func:`get_tracer`, :func:`step_annotation`) lives here
too: its device annotations are ``torch.profiler.record_function``
ranges, which cost next to nothing while no profiler runs.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

from serverless_learn_tpu_torch.telemetry.registry import JsonlEventLog, Span

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


@dataclass(frozen=True)
class TraceContext:
    """Immutable (trace, span) identity a caller hands to a callee."""

    trace_id: str   # 32 lowercase hex chars (128-bit)
    span_id: str    # 16 lowercase hex chars (64-bit): the CALLER's span
    flags: int = 1  # bit 0: sampled

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags & 0xFF:02x}"


def parse_traceparent(value) -> Optional[TraceContext]:
    """``00-<trace_id>-<span_id>-<flags>`` -> TraceContext; None when the
    value is absent or malformed (propagation is best-effort by design: a
    bad header must never fail the request it rode in on)."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # forbidden values per the W3C spec
    return TraceContext(trace_id, span_id, int(flags, 16))


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("slt_trace_context", default=None)


def current_context() -> Optional[TraceContext]:
    return _current.get()


def set_context(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the ambient context; returns a reset token."""
    return _current.set(ctx)


def reset_context(token):
    _current.reset(token)


# -- process identity + sinks ------------------------------------------------

_state_lock = threading.Lock()
_node: Optional[str] = None
_event_log: Optional[JsonlEventLog] = None


def node_name() -> str:
    """This process's identity in every span record. ``SLT_NODE`` wins;
    default ``<hostname>-<pid>`` is unique per process on a host."""
    global _node
    with _state_lock:
        if _node is None:
            _node = (os.environ.get("SLT_NODE")
                     or f"{socket.gethostname()}-{os.getpid()}")
        return _node


def init_tracing(node: Optional[str] = None,
                 events_log: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 install_flight: bool = True) -> str:
    """Configure this process's tracing: its node name, an optional JSONL
    span sink, and (default) the flight recorder's crash handlers. Returns
    the node name. Idempotent; later calls may add a sink."""
    global _node, _event_log
    with _state_lock:
        if node:
            _node = node
        if events_log:
            _event_log = JsonlEventLog(events_log)
    if install_flight:
        from serverless_learn_tpu_torch.telemetry import flight

        flight.install(flight_dir=flight_dir)
    return node_name()


def reset_tracing():
    """Close the JSONL sink and forget the node name (tests that run
    several commands in one process)."""
    global _node, _event_log
    with _state_lock:
        log, _event_log, _node = _event_log, None, None
    if log is not None:
        log.close()


def tracing_enabled() -> bool:
    """True once a JSONL sink exists — the signal RPC clients use to start
    new root traces for otherwise-unparented calls (heartbeats)."""
    with _state_lock:
        return _event_log is not None


def emit_event(record: dict):
    """Record a non-span structured event (alert, DiLoCo round, lifecycle
    marker): node-stamped, appended to the JSONL sink when one is
    configured, and always pushed into the flight ring. Never raises —
    the health engine and training loops call this from hot paths."""
    try:
        rec = dict(record)
        rec.setdefault("node", node_name())
        with _state_lock:
            log = _event_log
        if log is not None:
            log.emit(rec)
        from serverless_learn_tpu_torch.telemetry import flight

        flight.record(rec)
    except Exception:
        pass


def emit_span(span: Span):
    """Record a finished span: JSONL sink (when configured) + the flight
    ring (always; bounded and cheap). Never raises into the caller."""
    try:
        rec = span.to_event()
        rec.setdefault("node", node_name())
        with _state_lock:
            log = _event_log
        if log is not None:
            log.emit(rec)
        from serverless_learn_tpu_torch.telemetry import flight

        flight.record(rec)
    except Exception:
        pass


# -- span scopes -------------------------------------------------------------

@contextlib.contextmanager
def span(name: str, parent: Optional[TraceContext] = None,
         root: bool = False, emit: bool = True, **meta) -> Iterator[Span]:
    """Open a child span of ``parent`` (default: the ambient context; a new
    root trace when none), make it the ambient context for the block, mark
    ``done`` and emit it on exit. ``root=True`` forces a fresh trace."""
    if parent is None and not root:
        parent = current_context()
    if parent is None:
        s = Span(name)
    else:
        s = Span(name, trace_id=parent.trace_id, parent_id=parent.span_id)
    s.meta.update(meta)
    token = set_context(TraceContext(s.trace_id, s.span_id))
    try:
        yield s
    except BaseException as e:
        s.meta["error"] = type(e).__name__
        raise
    finally:
        reset_context(token)
        s.finish()
        if emit:
            emit_span(s)


@contextlib.contextmanager
def client_span(name: str, **meta) -> Iterator[Optional[Span]]:
    """RPC-client scope: a child span when a trace is ambient, a fresh root
    when tracing is initialized (so heartbeat chains exist without callers
    opening scopes), and a no-op otherwise: bare library use (tests
    constructing a ShardClient) allocates and emits nothing per call."""
    parent = current_context()
    if parent is None and not tracing_enabled():
        yield None
        return
    with span(name, parent=parent, **meta) as s:
        yield s


def attach_context(msg) -> Optional[TraceContext]:
    """Stamp the ambient context onto an outgoing request message's
    optional ``trace`` field (slt.proto field 15, ``control/wire.py``);
    returns it, or None when no trace is ambient."""
    ctx = current_context()
    if ctx is None:
        return None
    from serverless_learn_tpu_torch.control import wire

    msg.trace = wire.TraceContext(trace_id=ctx.trace_id,
                                  span_id=ctx.span_id, flags=ctx.flags)
    return ctx


# -- host-span tracer (``serverless_learn_tpu/utils/tracing.py``) -----------


@dataclass
class SpanStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class Tracer:
    """Accumulates named host-side span timings (count, total, max);
    thread-safe. ``summary()`` is the ``spans`` member of the ``train``
    command's ``done`` line."""

    stats: Dict[str, SpanStat] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def span(self, name: str, annotate_device: bool = True):
        """Time a section; optionally mirror it into the profiler's
        trace as a ``record_function`` range."""
        ctx = annotate(name) if annotate_device else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.record(name, time.perf_counter() - t0)

    def record(self, name: str, dt: float):
        with self._lock:
            self.stats.setdefault(name, SpanStat()).add(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {"count": s.count, "total_s": s.total_s,
                       "mean_s": s.mean_s, "max_s": s.max_s}
                for name, s in sorted(self.stats.items())
            }


_global_tracer: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _global_tracer
    with _state_lock:
        if _global_tracer is None:
            _global_tracer = Tracer()
        return _global_tracer


def annotate(name: str):
    """A named range in a ``torch.profiler`` trace (``record_function``;
    next to free while no profiler runs)."""
    import torch

    return torch.profiler.record_function(name)


def step_annotation(step: int):
    """The step marker of a profiler trace: a ``train_step_<N>`` range."""
    return annotate(f"train_step_{step}")
