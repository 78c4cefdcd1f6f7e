"""Goodput and badput: the run ledger, a copy of
``serverless_learn_tpu/telemetry/goodput.py``.

* :class:`PhaseLedger`: thread-safe, contextvar-scoped, nestable phase
  timers with an injectable clock. ``with ledger.phase("step"):``
  attributes wall-clock to the innermost open phase of the context; a
  child pauses its parent, so the per-phase totals partition the
  attributed time exactly.
* The phase names are the reference's: training ``compile``, ``step``,
  ``data_wait``, ``checkpoint``, ``remesh``, ``eval``,
  ``diloco_round_wait``; serving ``decode``, ``prefill``, ``admit``,
  ``admit_wait``, ``idle``. ``step`` and ``decode`` are productive;
  everything else is badput with a name.
* :meth:`PhaseLedger.report` gives per-phase seconds, counts and
  fractions, ``goodput`` (the productive share of the run) and, given an
  MFU, the MFU-weighted goodput. Open phases count their elapsed time so
  far; the rest is ``unattributed``, so the breakdown sums to the total.
* Phase exits longer than ``emit_min_s`` are emitted as ``{"event":
  "phase"}`` records when tracing has a JSONL sink.

Served at ``/goodput`` by :class:`~.exporter.MetricsExporter`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

# The canonical taxonomy. Ledgers accept any name (forward compatibility
# beats a registry), but these are the ones the framework itself emits.
TRAIN_PHASES = ("compile", "step", "data_wait", "checkpoint", "remesh",
                "eval", "diloco_round_wait")
SERVE_PHASES = ("compile", "decode", "prefill", "admit", "admit_wait",
                "idle")

# Phases that count as goodput. Everything else — including
# "unattributed" — is badput with a name.
PRODUCTIVE_PHASES = frozenset({"step", "decode"})

# Default floor below which a phase exit is not emitted as a JSONL event
# (the ledger totals still include it). Keeps tight decode loops from
# writing an event per chunk while steps/remeshes/checkpoints all emit.
DEFAULT_EMIT_MIN_S = 0.05

_stack_var: contextvars.ContextVar = contextvars.ContextVar(
    "slt_phase_stack", default=None)


class _Frame:
    """One open phase: name, entry clocks, child coverage (seconds of
    nested-phase time to subtract from this phase's exclusive total)."""

    __slots__ = ("name", "t0", "t0_unix", "child_s", "ledger")

    def __init__(self, name: str, t0: float, t0_unix: float, ledger):
        self.name = name
        self.t0 = t0
        self.t0_unix = t0_unix
        self.child_s = 0.0
        self.ledger = ledger


class PhaseLedger:
    """Exclusive per-phase wall-clock accounting for one run.

    ``clock`` is injectable (tests drive fabricated timelines and assert
    the math is exact); production uses ``time.monotonic``. One ledger
    per process is the normal shape (:func:`get_ledger`); subsystems
    accept an explicit ledger the way they accept a registry.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 emit_min_s: float = DEFAULT_EMIT_MIN_S,
                 emit: Optional[bool] = None):
        self._clock = clock
        self.emit_min_s = emit_min_s
        # None = emit phase events iff tracing has a JSONL sink (the same
        # gate client_span uses); True/False force it.
        self._emit = emit
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._open: List[_Frame] = []  # live frames, all contexts
        self._t_start: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def ensure_started(self, now: Optional[float] = None):
        """Pin the run's t0 (total-time denominator). Idempotent; the
        first phase entry does this implicitly."""
        with self._lock:
            if self._t_start is None:
                self._t_start = self._clock() if now is None else now

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Attribute the block's wall-clock to ``name``, exclusively:
        nested phases subtract from this one. Contextvar-scoped, so each
        thread/task keeps its own stack."""
        t0 = self._clock()
        frame = _Frame(name, t0, time.time(), self)
        stack = _stack_var.get()
        # Guard against a frame captured from a DIFFERENT ledger leaking
        # through a context copy (a thread spawned mid-phase): only treat
        # the parent as ours if it belongs to this ledger.
        parent = stack[-1] if stack and stack[-1].ledger is self else None
        token = _stack_var.set((stack or ()) + (frame,))
        with self._lock:
            if self._t_start is None:
                self._t_start = t0
            self._open.append(frame)
        try:
            yield
        finally:
            _stack_var.reset(token)
            dt = self._clock() - t0
            self_s = max(0.0, dt - frame.child_s)
            with self._lock:
                try:
                    self._open.remove(frame)
                except ValueError:
                    pass
                self._totals[name] = self._totals.get(name, 0.0) + self_s
                self._counts[name] = self._counts.get(name, 0) + 1
            if parent is not None:
                parent.child_s += dt
            self._maybe_emit(name, frame.t0_unix, dt, self_s)

    def add(self, name: str, seconds: float, count: int = 1):
        """Directly credit ``seconds`` of exclusive time to a phase —
        for callers that measured a wait themselves and can't hold a
        scope open (e.g. offline replay)."""
        if seconds < 0:
            return
        with self._lock:
            if self._t_start is None:
                self._t_start = self._clock()
            self._totals[name] = self._totals.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + count

    def _maybe_emit(self, name: str, t0_unix: float, dt: float,
                    self_s: float):
        if dt < self.emit_min_s:
            return
        emit = self._emit
        if emit is None:
            from serverless_learn_tpu_torch.telemetry import tracing

            emit = tracing.tracing_enabled()
        if not emit:
            return
        from serverless_learn_tpu_torch.telemetry import tracing

        tracing.emit_event({"event": "phase", "phase": name,
                            "t0_unix_s": round(t0_unix, 6),
                            "duration_s": round(dt, 6),
                            "self_s": round(self_s, 6)})

    # -- reading -----------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> dict:
        """{"phases": {name: {"seconds", "count"}}, "total_s": ...} with
        open phases credited their elapsed-so-far (a live scrape during a
        10-minute step must not report the step as unattributed)."""
        now = self._clock() if now is None else now
        with self._lock:
            totals = dict(self._totals)
            counts = dict(self._counts)
            t0 = self._t_start
            open_frames = [(f.name, f.t0, f.child_s) for f in self._open]
        for name, f_t0, child_s in open_frames:
            live = max(0.0, (now - f_t0) - child_s)
            totals[name] = totals.get(name, 0.0) + live
            counts.setdefault(name, 0)
        total = max(0.0, now - t0) if t0 is not None else 0.0
        return {"phases": {n: {"seconds": totals[n],
                               "count": counts.get(n, 0)}
                           for n in totals},
                "total_s": total}

    def report(self, mfu: Optional[float] = None,
               now: Optional[float] = None) -> dict:
        """The `/goodput` payload (and ``slt goodput`` print shape)."""
        snap = self.snapshot(now=now)
        return build_report(snap["phases"], snap["total_s"], mfu=mfu)


def build_report(phases: Dict[str, dict], total_s: float,
                 mfu: Optional[float] = None) -> dict:
    """Phase totals + a total-time denominator -> the goodput report,
    the reference's shape: the per-phase seconds (``unattributed``
    included) sum to ``total_s``."""
    attributed = sum(float(p["seconds"]) for p in phases.values())
    total = max(float(total_s), attributed)
    out_phases = {}
    for name in sorted(phases, key=lambda n: -float(phases[n]["seconds"])):
        sec = float(phases[name]["seconds"])
        out_phases[name] = {
            "seconds": round(sec, 6),
            "count": int(phases[name].get("count", 0)),
            "fraction": round(sec / total, 6) if total > 0 else 0.0}
    unattributed = max(0.0, total - attributed)
    if total > 0:
        out_phases["unattributed"] = {
            "seconds": round(unattributed, 6), "count": 0,
            "fraction": round(unattributed / total, 6)}
    productive = sum(float(phases[n]["seconds"])
                     for n in phases if n in PRODUCTIVE_PHASES)
    goodput = productive / total if total > 0 else 0.0
    badput = {n: v["fraction"] for n, v in out_phases.items()
              if n not in PRODUCTIVE_PHASES and v["seconds"] > 0}
    rep = {"total_s": round(total, 6),
           "productive_s": round(productive, 6),
           "goodput": round(goodput, 6),
           "badput_breakdown": badput,
           "phases": out_phases}
    if mfu is not None and mfu > 0:
        # Fraction of the whole run's wall-clock spent at the measured
        # FLOP rate: productive time at `mfu` utilization, badput at 0.
        rep["mfu"] = round(float(mfu), 6)
        rep["mfu_weighted_goodput"] = round(goodput * float(mfu), 6)
    return rep


# -- process-wide default ----------------------------------------------------

_default_lock = threading.Lock()
_default_ledger: Optional[PhaseLedger] = None


def get_ledger() -> PhaseLedger:
    """The process-wide ledger every subsystem defaults to (mirrors
    ``registry.get_registry``)."""
    global _default_ledger
    with _default_lock:
        if _default_ledger is None:
            _default_ledger = PhaseLedger()
        return _default_ledger


def set_ledger(ledger: Optional[PhaseLedger]) -> Optional[PhaseLedger]:
    """Swap the process ledger (tests, multi-tenant embedding); returns
    the previous one so callers can restore it."""
    global _default_ledger
    with _default_lock:
        prev = _default_ledger
        _default_ledger = ledger
        return prev


def phase(name: str):
    """``with goodput.phase("step"):`` against the process ledger."""
    return get_ledger().phase(name)
