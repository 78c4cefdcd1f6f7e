"""Per-request serving attribution, the recording half of
``serverless_learn_tpu/telemetry/waterfall.py``: the same schema, so the
reference's ``slt waterfall`` reads the port's event logs.

:class:`RequestWaterfall` is a per-request ledger owned by the request
(no locks, like :class:`~.registry.Span`). It records the phase timeline
(queue wait, admission, compile charged separately, per-chunk prefill
with prefix-hit tokens) and a per-token decode trace: each inter-token
gap above an EWMA baseline is attributed to named causes by intersecting
the gap with the engine's boundary events, which land in a shared,
locked :class:`BoundaryEvents` ring. The finished ledger rides the
request span's ``meta["waterfall"]`` into the event log.

Attribution: interval causes (compile, prefill_steal, compaction,
harvest_drain) claim their measured overlap with the gap, scaled down if
they over-explain it; marker causes (preempt, kv_exhausted) split what
is left; a residual with no marker is ``other``. ``overhead_s`` counts the
ledger's own host time. The analysis half (``report``, ``render``) waits
for the port of the ``waterfall`` command.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

# Stall causes (ITL gap attribution): interval causes carry a measured
# [t0, t1) (compile, prefill_steal, compaction, harvest_drain,
# weight_swap); marker causes are instants whose cost shows up only as the
# gap's unexplained excess; "other" is a residual with no boundary event.
MARKER_CAUSES = frozenset({"preempt", "kv_exhausted"})
OTHER_CAUSE = "other"

_EPS = 1e-9


class BoundaryEvents:
    """Bounded ring of the engine's own boundary events, as absolute
    ``time.perf_counter()`` intervals ``(t0, t1, cause)``.

    Shared across all in-flight requests of one engine, hence locked
    (admission, prefill, decode and harvest all note into it). Readers
    (:meth:`overlap`) snapshot under the lock and intersect outside it.
    Marker causes are noted with ``t1 == t0``.
    """

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(16, int(window)))

    def note(self, cause: str, t0: float, t1: Optional[float] = None):
        t0 = float(t0)
        t1 = t0 if t1 is None else float(t1)
        with self._lock:
            self._events.append((t0, max(t0, t1), str(cause)))

    def overlap(self, g0: float, g1: float) -> Dict[str, float]:
        """Per-cause overlap seconds with the window ``[g0, g1]``.
        Marker causes present in the window appear with value 0.0 (a
        presence flag — they claim residual excess, not overlap)."""
        with self._lock:
            events = list(self._events)
        out: Dict[str, float] = {}
        for t0, t1, cause in events:
            if t1 < g0 or t0 > g1:
                continue
            if cause in MARKER_CAUSES or t1 - t0 <= _EPS:
                out.setdefault(cause, 0.0)
            else:
                out[cause] = out.get(cause, 0.0) \
                    + max(0.0, min(t1, g1) - max(t0, g0))
        return out


class RequestWaterfall:
    """One request's lifecycle ledger. Owned by the request (no locks;
    same ownership discipline as ``Span``). All timestamps passed in are
    absolute ``time.perf_counter()`` values; :meth:`finalize` rebases to
    span-relative seconds for the record.

    ``overhead_s`` self-accounts the ledger's own decode-path host time
    (the <2%-of-decode-wall-clock budget is asserted in tests from this
    number, not hand-waved).
    """

    __slots__ = ("engine", "ewma_alpha", "stall_mult", "min_stall_s",
                 "max_stall_events", "max_gap_samples",
                 "prefill_chunks", "events", "gap_s", "gap_tokens",
                 "stalls", "stall_totals", "compile_s", "admit_s",
                 "itl_ewma", "last_t", "itl_count", "itl_sum", "itl_max",
                 "overhead_s")

    def __init__(self, engine: str = "continuous",
                 ewma_alpha: float = 0.3,
                 stall_mult: float = 2.0,
                 min_stall_s: float = 0.002,
                 max_stall_events: int = 64,
                 max_gap_samples: int = 256):
        self.engine = engine
        self.ewma_alpha = float(ewma_alpha)
        self.stall_mult = float(stall_mult)
        self.min_stall_s = float(min_stall_s)
        self.max_stall_events = int(max_stall_events)
        self.max_gap_samples = int(max_gap_samples)
        self.prefill_chunks: List[dict] = []
        self.events: List[Tuple[float, float, str]] = []
        self.gap_s: List[float] = []
        self.gap_tokens: List[int] = []
        self.stalls: List[dict] = []
        self.stall_totals: Dict[str, float] = {}
        self.compile_s = 0.0
        self.admit_s = 0.0
        self.itl_ewma: Optional[float] = None
        self.last_t: Optional[float] = None
        self.itl_count = 0
        self.itl_sum = 0.0
        self.itl_max = 0.0
        self.overhead_s = 0.0

    # -- recording (engine side) ------------------------------------------

    def note_admit(self, t0: float, t1: float):
        """Host-side admission work (slot/KV alloc, staging)."""
        self.admit_s += max(0.0, t1 - t0)

    def note_compile(self, t0: float, t1: float):
        """A new-bucket jit this request sat behind on its way to first
        token — charged separately so TTFT decomposition can name it."""
        self.compile_s += max(0.0, t1 - t0)

    def note_prefill_chunk(self, t0: float, t1: float, tokens: int,
                           prefix_hit_tokens: int = 0,
                           compiled: bool = False,
                           stall_s: Optional[float] = None):
        """One prefill chunk: tokens fed, tokens served by the prefix
        cache, and the budget-stall gap since the previous chunk
        (computed here when not supplied — the wait this chunk spent
        parked behind the per-boundary prefill budget)."""
        if stall_s is None:
            stall_s = (max(0.0, float(t0) - self.prefill_chunks[-1]["t1"])
                       if self.prefill_chunks else 0.0)
        if len(self.prefill_chunks) < 128:
            self.prefill_chunks.append({
                "t0": float(t0), "t1": float(t1),
                "tokens": int(tokens),
                "prefix_hit_tokens": int(prefix_hit_tokens),
                "compiled": bool(compiled),
                "stall_s": round(max(0.0, stall_s), 6)})

    def note_event(self, cause: str, t0: float, t1: Optional[float] = None):
        """A per-request boundary event (e.g. this request's own preempt
        -> re-admission window) — merged with the engine-global ring at
        attribution time."""
        t0 = float(t0)
        if len(self.events) < 128:
            self.events.append((t0, t0 if t1 is None else float(t1),
                                str(cause)))

    def first_token(self, t: float):
        """Anchor the decode trace at first-token arrival."""
        if self.last_t is None:
            self.last_t = float(t)

    def note_decode(self, t: float, n_tokens: int,
                    boundary: Optional[BoundaryEvents] = None,
                    ) -> Optional[Tuple[float, Optional[Dict[str, float]]]]:
        """One harvest delivering ``n_tokens`` for this request at
        absolute time ``t``. Returns ``(itl_s, causes)`` — the per-token
        latency of this gap, plus the per-cause stall attribution
        (seconds summing to the above-baseline excess) when the gap
        stalled, else None. The engine feeds ``itl_s`` into
        ``slt_decode_itl_seconds`` and the dict straight into
        ``slt_decode_stall_seconds_total{cause}``. Returns None for the
        anchoring first call."""
        t_in = time.perf_counter()
        try:
            if self.last_t is None:
                self.last_t = float(t)
                return None
            gap = max(0.0, float(t) - self.last_t)
            self.last_t = float(t)
            n = max(1, int(n_tokens))
            itl = gap / n
            self.itl_count += n
            self.itl_sum += gap
            self.itl_max = max(self.itl_max, itl)
            if len(self.gap_s) < self.max_gap_samples:
                self.gap_s.append(gap)
                self.gap_tokens.append(n)
            base = self.itl_ewma
            if base is None:
                self.itl_ewma = itl
                return (itl, None)
            expected = base * n
            excess = gap - expected
            if excess <= max(self.min_stall_s,
                             expected * (self.stall_mult - 1.0)):
                # Baseline tracks only unstalled gaps, so one compile
                # can't inflate it into masking the next stall.
                self.itl_ewma = base + self.ewma_alpha * (itl - base)
                return (itl, None)
            causes = self._attribute(float(t) - gap, float(t), excess,
                                     boundary)
            for c, v in causes.items():
                self.stall_totals[c] = self.stall_totals.get(c, 0.0) + v
            if len(self.stalls) < self.max_stall_events:
                self.stalls.append({
                    "t": float(t), "gap_s": round(gap, 6),
                    "tokens": n,
                    "base_s": round(gap - excess, 6),
                    "causes": {c: round(v, 6)
                               for c, v in sorted(causes.items())}})
            return (itl, causes)
        finally:
            self.overhead_s += time.perf_counter() - t_in

    def _attribute(self, g0: float, g1: float, excess: float,
                   boundary: Optional[BoundaryEvents],
                   ) -> Dict[str, float]:
        """Split ``excess`` seconds across causes whose events intersect
        [g0, g1]. Interval causes claim measured overlap (scaled down if
        they over-explain); markers split the remainder; a bare residual
        is ``other``. Sum over the result == excess (the per-gap
        breakdown invariant)."""
        ov: Dict[str, float] = {}
        if boundary is not None:
            ov.update(boundary.overlap(g0, g1))
        for t0, t1, cause in self.events:
            if t1 < g0 or t0 > g1:
                continue
            if cause in MARKER_CAUSES or t1 - t0 <= _EPS:
                ov.setdefault(cause, 0.0)
            else:
                ov[cause] = ov.get(cause, 0.0) \
                    + max(0.0, min(t1, g1) - max(t0, g0))
        causes: Dict[str, float] = {}
        interval_total = sum(v for v in ov.values() if v > _EPS)
        if interval_total > _EPS:
            scale = min(1.0, excess / interval_total)
            for c, v in ov.items():
                if v > _EPS:
                    causes[c] = v * scale
        leftover = excess - sum(causes.values())
        if leftover > _EPS:
            markers = sorted(c for c, v in ov.items() if v <= _EPS)
            if markers:
                for c in markers:
                    causes[c] = causes.get(c, 0.0) + leftover / len(markers)
            else:
                causes[OTHER_CAUSE] = causes.get(OTHER_CAUSE, 0.0) + leftover
        return causes

    # -- finalize ---------------------------------------------------------

    def finalize(self, span) -> dict:
        """The JSONL-ready ledger, rebased to span-relative seconds.
        Stored by the engines in ``span.meta["waterfall"]`` so it rides
        the existing request-span record."""
        t_in = time.perf_counter()
        t0 = span.t0
        marks = span.marks
        admit_t = marks.get("admit", 0.0)
        ft = marks.get("first_token")
        done = marks.get("done", span.duration_s)
        phases: List[dict] = [
            {"phase": "queue", "t0_s": 0.0, "t1_s": round(admit_t, 6),
             "s": round(admit_t, 6)}]
        decomp: Dict[str, float] = {}
        if ft is not None:
            # Exact-by-construction decomposition: compile and admission
            # are measured and clamped into the admit->first_token
            # window; prefill is the remainder. queue+admit+compile+
            # prefill == TTFT with no float luck.
            window = max(0.0, ft - admit_t)
            compile_s = min(self.compile_s, window)
            admit_s = min(self.admit_s, window - compile_s)
            prefill_s = window - compile_s - admit_s
            decomp = {"queue": round(admit_t, 6),
                      "admit": round(admit_s, 6),
                      "compile": round(compile_s, 6),
                      "prefill": round(prefill_s, 6)}
            phases.append({"phase": "admit", "s": round(admit_s, 6)})
            phases.append({"phase": "compile", "s": round(compile_s, 6)})
            work = {"phase": "generate" if self.engine == "static"
                    else "prefill",
                    "t1_s": round(ft, 6), "s": round(prefill_s, 6)}
            if self.prefill_chunks:
                work["chunks"] = [
                    {"t0_s": round(c["t0"] - t0, 6),
                     "t1_s": round(c["t1"] - t0, 6),
                     "tokens": c["tokens"],
                     "prefix_hit_tokens": c["prefix_hit_tokens"],
                     "compiled": c["compiled"],
                     "stall_s": c["stall_s"]}
                    for c in self.prefill_chunks]
            phases.append(work)
            if self.engine != "static" and done > ft + _EPS:
                phases.append({"phase": "decode", "t0_s": round(ft, 6),
                               "t1_s": round(done, 6),
                               "s": round(done - ft, 6)})
        wf: dict = {"v": SCHEMA_VERSION, "engine": self.engine,
                    "phases": phases}
        if decomp:
            wf["ttft_s"] = round(ft, 6)
            wf["ttft_decomp_s"] = decomp
        if self.itl_count:
            wf["itl"] = {"count": self.itl_count,
                         "mean_s": round(self.itl_sum / self.itl_count, 6),
                         "max_s": round(self.itl_max, 6),
                         "baseline_s": round(self.itl_ewma or 0.0, 6)}
            wf["gaps"] = [[round(g, 6), n] for g, n
                          in zip(self.gap_s, self.gap_tokens)]
        if self.stalls:
            rebased = []
            for s in self.stalls:
                s = dict(s)
                s["t_s"] = round(s.pop("t") - t0, 6)
                rebased.append(s)
            wf["stalls"] = rebased
        if self.stall_totals:
            wf["stall_s"] = {c: round(v, 6) for c, v
                             in sorted(self.stall_totals.items())}
        self.overhead_s += time.perf_counter() - t_in
        wf["overhead_s"] = round(self.overhead_s, 6)
        return wf
