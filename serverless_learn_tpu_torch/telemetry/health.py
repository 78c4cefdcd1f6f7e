"""Health engine: anomaly, SLO burn-rate and structural detectors over
the live :class:`~.registry.MetricsRegistry`, a copy of
``serverless_learn_tpu/telemetry/health.py``.

A background thread samples the registry and keeps bounded rings per
series; :meth:`HealthEngine.sample_once` is the synchronous tick with an
injectable clock. Three detector families:

1. **Anomaly** (:class:`EwmaMad`): an EWMA level and a MAD-based modified
   z over a bounded ring, on step time, tokens/s, heartbeat RTT, queue
   wait and remesh time.
2. **SLO burn rate** (:class:`BurnRate`): ``health.slos`` objectives with
   the two-window rule: both a short and a long window must burn the
   error budget faster than ``fast_burn`` (critical) or ``slow_burn``
   (warning).
3. **Structural** (:class:`StalenessWatch`, :func:`score_stragglers`):
   watchdogs on counters that must advance (steps, DiLoCo rounds, decode
   chunks), counters whose every increment is an incident, the anchor-lag
   gauge, and per-worker straggler scores from DiLoCo round records.

Alerts go to the event log and the flight ring
(``tracing.emit_event``), are served at ``/alerts``, turn ``/healthz``
to 503 while a critical one fires, and trigger a rate-limited flight
dump. The training-quality detectors (``telemetry.numerics.LossHealth``:
loss spike, plateau, gradient explosion, a non-finite step) run over the
numerics auditor's step records, tuned by the ``health.numerics_*``
fields; every increment of ``slt_numerics_nonfinite_total`` is also a
critical ``event.numerics_nonfinite``.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

SEVERITY_RANK = {"info": 0, "warning": 1, "critical": 2}


def _median(vals) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


# -- detector family 1: EWMA + MAD anomaly -----------------------------------


class EwmaMad:
    """Online anomaly score: modified z of a new sample against an EWMA
    level with a MAD spread over a bounded ring.

    ``update(x)`` returns the z-score of ``x`` against the *prior*
    baseline (so a spike does not mute its own detection), then absorbs
    ``x`` — a sustained level shift re-baselines within ~``window``
    samples instead of alarming forever. The spread floor
    ``max(MAD, rel_floor·|median|)`` keeps near-constant series (MAD 0)
    from flagging measurement noise."""

    def __init__(self, alpha: float = 0.3, window: int = 240,
                 min_samples: int = 12, rel_floor: float = 0.05):
        self.alpha = alpha
        self.min_samples = max(2, int(min_samples))
        self.rel_floor = rel_floor
        self.ring: deque = deque(maxlen=max(self.min_samples, int(window)))
        self.ewma: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> Optional[float]:
        z = None
        if self.n >= self.min_samples and self.ewma is not None:
            med = _median(self.ring)
            mad = _median([abs(v - med) for v in self.ring])
            floor = max(mad, self.rel_floor * abs(med), 1e-9)
            z = 0.6745 * (x - self.ewma) / floor
        self.ring.append(float(x))
        self.n += 1
        self.ewma = (x if self.ewma is None
                     else self.alpha * x + (1 - self.alpha) * self.ewma)
        return z


# -- detector family 2: SLO burn rate ----------------------------------------


class BurnRate:
    """Multi-window burn-rate evaluation over cumulative (bad, total)
    counts. ``burn = (bad fraction in window) / error budget``; a burn of
    1.0 consumes exactly the budget over the compliance period. The
    standard two-window AND keeps a transient blip (short window only)
    and a long-ago incident (long window only) from paging."""

    def __init__(self, budget: float, short_s: float = 60.0,
                 long_s: float = 720.0, fast_burn: float = 14.4,
                 slow_burn: float = 6.0):
        if not (0 < budget < 1):
            raise ValueError(f"SLO budget must be in (0, 1), got {budget}")
        self.budget = budget
        self.short_s, self.long_s = short_s, long_s
        self.fast_burn, self.slow_burn = fast_burn, slow_burn
        self.samples: deque = deque()  # (t, bad_cum, total_cum), oldest first

    def _window_burn(self, now: float, window_s: float,
                     bad: float, total: float) -> Optional[float]:
        """Burn over [now - window_s, now]; None with no prior sample."""
        t0 = now - window_s
        base = None
        for t, b, tt in self.samples:
            if t <= t0:
                base = (t, b, tt)
            else:
                if base is None:
                    base = (t, b, tt)  # history shorter than the window
                break
        if base is None or base[0] >= now:
            return None
        d_total = total - base[2]
        if d_total <= 0:
            return 0.0
        d_bad = max(0.0, bad - base[1])
        return (d_bad / d_total) / self.budget

    def update(self, now: float, bad_cum: float, total_cum: float) -> dict:
        short = self._window_burn(now, self.short_s, bad_cum, total_cum)
        long_ = self._window_burn(now, self.long_s, bad_cum, total_cum)
        self.samples.append((now, float(bad_cum), float(total_cum)))
        # Evict samples no window can reach (keep one pre-boundary sample
        # so the long window always spans its full width).
        cutoff = now - self.long_s
        while len(self.samples) > 2 and self.samples[1][0] <= cutoff:
            self.samples.popleft()
        severity = None
        if short is not None and long_ is not None:
            # Boundary-inclusive under float: 144 bad in 1000 at budget
            # 0.01 IS a 14.4x burn even when the division lands at
            # 14.399999999999999.
            eps = 1e-9
            if (short >= self.fast_burn - eps
                    and long_ >= self.fast_burn - eps):
                severity = "critical"
            elif (short >= self.slow_burn - eps
                    and long_ >= self.slow_burn - eps):
                severity = "warning"
        return {"short_burn": short, "long_burn": long_,
                "severity": severity}


def hist_good_total(hist: dict, threshold: float) -> Tuple[float, float]:
    """(good, total) cumulative counts from a histogram snapshot: good =
    observations ≤ the largest bucket edge ≤ ``threshold`` (conservative
    when the threshold falls between edges)."""
    buckets, cum = hist["buckets"], hist["cumulative"]
    total = float(cum[-1]) if cum else 0.0
    i = bisect_right(buckets, threshold) - 1
    good = float(cum[i]) if i >= 0 else 0.0
    return good, total


# -- detector family 3: structural -------------------------------------------


class StalenessWatch:
    """Liveness watchdog over a monotonically increasing counter: learns
    the EWMA inter-increment interval, then flags when the counter has
    been flat for ``factor ×`` that interval. Counter restarts (value
    decreasing) re-arm instead of alarming. ``held_s``, a cumulative
    count of seconds the watched loop was held on purpose (a checkpoint,
    an eval), is taken off both the age and the learned interval."""

    def __init__(self, factor: float = 5.0, min_interval_s: float = 1.0,
                 alpha: float = 0.3):
        self.factor = factor
        self.min_interval_s = min_interval_s
        self.alpha = alpha
        self.last_value: Optional[float] = None
        self.last_change: Optional[float] = None
        self.ewma_interval: Optional[float] = None
        self.held_at_change = 0.0

    def touch(self, now: float):
        """Re-arm without counting an increment (a legitimately idle
        component — e.g. a decode engine with no occupied slots — must
        not accumulate staleness)."""
        if self.last_change is not None:
            self.last_change = now

    def update(self, now: float, value: Optional[float],
               held_s: float = 0.0) -> Optional[Tuple[float, float]]:
        """Returns (age_s, threshold_s) when stale, else None."""
        if value is None:
            return None
        if held_s < self.held_at_change:  # the hold source was replaced
            self.held_at_change = held_s
        held = held_s - self.held_at_change
        if self.last_value is None or value < self.last_value:
            self.last_value = value
            self.last_change = None  # arm on the first observed increment
            return None
        if value > self.last_value:
            self.held_at_change = held_s
            if self.last_change is not None:
                iv = max(0.0, now - self.last_change - held)
                self.ewma_interval = (
                    iv if self.ewma_interval is None
                    else self.alpha * iv + (1 - self.alpha) *
                    self.ewma_interval)
            self.last_value = value
            self.last_change = now
            return None
        if self.last_change is None:
            return None  # never seen it move; nothing to be stale against
        base = max(self.ewma_interval or self.min_interval_s,
                   self.min_interval_s)
        threshold = self.factor * base
        age = now - self.last_change - held
        if age > threshold:
            return age, threshold
        return None

    def age(self, now: float) -> Optional[float]:
        return None if self.last_change is None else now - self.last_change


def score_stragglers(rounds: List[dict], factor: float = 4.0,
                     min_rounds: int = 2, late_fraction: float = 0.5
                     ) -> Dict[str, dict]:
    """Per-worker straggler scores from DiLoCo round records.

    Each record: ``{"round": r, "live": [ids], "arrivals_s": {id: s}}`` —
    the leader's first-seen offset of every delta. A worker is *late* in a
    round when its arrival exceeds ``median + factor × MAD`` (spread floor
    5% of the median), and *missing* when live but never posted. Flagged
    when late-or-missing in ≥ ``late_fraction`` of ≥ ``min_rounds``
    rounds seen — one slow round is noise, a pattern is a straggler."""
    stats: Dict[str, dict] = {}
    for rec in rounds:
        # Tolerant of degenerate records: zero recorded
        # arrivals (a quorum/timeout round that closed empty), workers
        # that never report (live but absent from arrivals_s for every
        # round — the "missing" path must not KeyError), and non-numeric
        # arrival values from a torn JSONL line.
        arrivals = {}
        for k, v in (rec.get("arrivals_s") or {}).items():
            try:
                arrivals[str(k)] = float(v)
            except (TypeError, ValueError):
                continue
        live = [str(w) for w in (rec.get("live") or arrivals.keys())]
        if not live:
            continue
        vals = list(arrivals.values())
        med = _median(vals) if vals else 0.0
        mad = _median([abs(v - med) for v in vals]) if vals else 0.0
        cut = med + factor * max(mad, 0.05 * abs(med), 1e-3)
        for wid in live:
            st = stats.setdefault(wid, {"rounds_seen": 0, "late": 0,
                                        "missing": 0, "lag_s": []})
            st["rounds_seen"] += 1
            a = arrivals.get(wid)
            if a is None:
                st["missing"] += 1
            elif a > cut:
                st["late"] += 1
                st["lag_s"].append(a - med)
    out: Dict[str, dict] = {}
    for wid, st in stats.items():
        bad = st["late"] + st["missing"]
        score = bad / max(st["rounds_seen"], 1)
        out[wid] = {
            "rounds_seen": st["rounds_seen"], "late": st["late"],
            "missing": st["missing"], "score": round(score, 4),
            "mean_lag_s": (round(sum(st["lag_s"]) / len(st["lag_s"]), 4)
                           if st["lag_s"] else 0.0),
            "flagged": (st["rounds_seen"] >= min_rounds
                        and score >= late_fraction),
        }
    return out


# Module-level ring of DiLoCo round records: islands publish here (and to
# the JSONL sink via tracing.emit_event); any engine in the process scores
# from it without plumbing a handle through the training stack.
_rounds_lock = threading.Lock()
_rounds: deque = deque(maxlen=64)


def note_round(record: dict):
    with _rounds_lock:
        _rounds.append(dict(record))


def recent_rounds(n: int = 20) -> List[dict]:
    with _rounds_lock:
        return list(_rounds)[-n:]


def clear_rounds():
    with _rounds_lock:
        _rounds.clear()


# -- alerts ------------------------------------------------------------------


@dataclass
class Alert:
    """One typed alert. Keyed by (name, labels); re-fires update the same
    record; resolution keeps it (state="resolved") for the recent list."""

    name: str
    severity: str
    detector: str  # "anomaly" | "slo" | "structural"
    message: str
    value: float = 0.0
    threshold: float = 0.0
    node: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    state: str = "firing"
    first_fired_unix_s: float = 0.0
    last_fired_unix_s: float = 0.0
    resolved_unix_s: Optional[float] = None
    count: int = 0
    clean_ticks: int = 0

    def to_event(self) -> dict:
        rec = {"event": "alert", "alert": self.name,
               "severity": self.severity, "detector": self.detector,
               "state": self.state, "message": self.message,
               "value": round(float(self.value), 6),
               "threshold": round(float(self.threshold), 6),
               "count": self.count,
               "first_fired_unix_s": round(self.first_fired_unix_s, 3),
               "last_fired_unix_s": round(self.last_fired_unix_s, 3)}
        if self.node:
            rec["node"] = self.node
        if self.labels:
            rec["labels"] = dict(self.labels)
        if self.resolved_unix_s is not None:
            rec["resolved_unix_s"] = round(self.resolved_unix_s, 3)
        return rec


def flatten_snapshot(snap: dict) -> dict:
    """A registry ``snapshot()`` → ``{"values": {name: summed},
    "hists": {name: {buckets, cumulative, sum, count}}}``, series summed
    across label sets per family — the same rollup `slt top` renders, so
    detectors see one scalar per metric name."""
    values: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for name, fam in snap.items():
        if fam.get("type") == "histogram":
            agg = None
            for s in fam.get("series", []):
                if agg is None:
                    agg = {"buckets": list(s["buckets"]),
                           "cumulative": list(s["cumulative"]),
                           "sum": float(s["sum"]),
                           "count": int(s["count"])}
                else:
                    agg["cumulative"] = [a + b for a, b in
                                         zip(agg["cumulative"],
                                             s["cumulative"])]
                    agg["sum"] += float(s["sum"])
                    agg["count"] += int(s["count"])
            if agg is not None:
                hists[name] = agg
        else:
            values[name] = sum(float(s.get("value", 0.0))
                               for s in fam.get("series", []))
    return {"values": values, "hists": hists}


# -- SLO parsing -------------------------------------------------------------


def parse_slos(specs) -> List[dict]:
    """Validate ``health.slos`` config entries. Two kinds:

    * ``{"name", "kind": "latency", "metric": <histogram family>,
       "threshold_s": <latency target>, "objective": 0.95}`` — "95% of
      observations land at or under threshold_s".
    * ``{"name", "kind": "ratio", "bad": <counter>, "total": <counter>,
       "objective": 0.999}`` — "99.9% of events are good".

    Raises ``ValueError`` on malformed specs — `slt doctor --self-check`
    and engine startup surface config typos loudly instead of silently
    never alerting."""
    out = []
    for i, spec in enumerate(specs or ()):
        if not isinstance(spec, dict):
            raise ValueError(f"health.slos[{i}] must be an object: {spec!r}")
        name = spec.get("name")
        kind = spec.get("kind", "latency")
        obj = spec.get("objective")
        if not name or not isinstance(name, str):
            raise ValueError(f"health.slos[{i}] needs a string 'name'")
        if not isinstance(obj, (int, float)) or not (0 < obj < 1):
            raise ValueError(
                f"health.slos[{i}] ({name}): 'objective' must be a "
                f"fraction in (0, 1), got {obj!r}")
        if kind == "latency":
            if not spec.get("metric"):
                raise ValueError(
                    f"health.slos[{i}] ({name}): latency SLOs need "
                    f"'metric' (a histogram family name)")
            thr = spec.get("threshold_s")
            if not isinstance(thr, (int, float)) or thr <= 0:
                raise ValueError(
                    f"health.slos[{i}] ({name}): 'threshold_s' must be a "
                    f"positive number, got {thr!r}")
        elif kind == "ratio":
            if not spec.get("bad") or not spec.get("total"):
                raise ValueError(
                    f"health.slos[{i}] ({name}): ratio SLOs need 'bad' "
                    f"and 'total' counter family names")
        else:
            raise ValueError(
                f"health.slos[{i}] ({name}): unknown kind {kind!r} "
                f"(expected 'latency' or 'ratio')")
        out.append(dict(spec, kind=kind))
    return out


# -- the engine --------------------------------------------------------------

# (series key, extraction, metric family, direction, severity). Direction:
# which tail is *bad* — a faster step is never an incident.
_ANOMALY_RULES = (
    ("step_time", "hist_mean", "slt_train_step_seconds", "high", "warning"),
    ("tokens_per_sec", "rate", "slt_decode_tokens_total", "low", "warning"),
    ("heartbeat_rtt", "hist_mean", "slt_heartbeat_rtt_seconds", "high",
     "warning"),
    ("queue_wait", "hist_mean", "slt_request_queue_wait_seconds", "high",
     "warning"),
    ("remesh_seconds", "hist_mean", "slt_remesh_seconds", "high", "warning"),
)

# (watch key, counter family, severity, gate gauge or None). The gate
# gauge must be > 0 for staleness to accrue (an idle engine isn't stale).
_STALE_RULES = (
    ("train_step", "slt_train_steps_total", "critical", None),
    ("diloco_round", "slt_diloco_rounds_total", "critical", None),
    ("decode_chunk", "slt_decode_chunks_total", "critical",
     "slt_slots_in_use"),
)

# Goodput phases in which a watched loop is held on purpose, by watch key:
# a training loop stops stepping while it saves a checkpoint, refreshes
# the emergency shadow or evaluates, and that is not a stall.
_STALE_HOLD_PHASES = {"train_step": ("checkpoint", "eval")}

# Counters whose every increment is itself an incident signal.
_EVENT_RULES = (
    ("lease_expiry", "slt_lease_expiries_total", "warning"),
    ("diloco_liveness_escape", "slt_diloco_liveness_escapes_total",
     "warning"),
    # Gossip failure-detector suspicions (a peer stopped
    # acking probes — link or process trouble even when the master is
    # reachable) and circuit-breaker trips (a peer failed enough RPCs
    # in a row that the client is now failing fast).
    ("gossip_suspicion", "slt_gossip_suspicions_total", "warning"),
    ("rpc_breaker_open", "slt_rpc_breaker_opens_total", "warning"),
    # The serving fleet's incident counters — a replica
    # ejected for consecutive errors (latency/transport outlier) and a
    # replica declared dead after failed liveness probes. The router
    # also emits labeled fleet.replica_dead alert events directly; these
    # rules make the same incidents visible to a health engine running
    # over the router's registry (/alerts, slt top, scale decisions).
    ("fleet_replica_ejected", "slt_router_ejections_total", "warning"),
    ("fleet_replica_death", "slt_router_replica_deaths_total", "warning"),
    # Crash-safe training state. A checkpoint copy failing
    # verification is critical — the run is one more corruption away
    # from losing a checkpoint interval; emergency saves and completed
    # recoveries are incidents worth an alert trail even though the
    # system handled them.
    ("ckpt_corrupt", "slt_ckpt_corrupt_total", "critical"),
    ("ckpt_emergency_save", "slt_ckpt_emergency_saves_total", "warning"),
    ("recovery", "slt_recovery_incidents_total", "warning"),
    # The DiLoCo leader's delta sanity gate. The island also
    # emits a labeled per-worker diloco.delta_quarantined alert event
    # directly (like the router's fleet.replica_dead); this rule makes
    # the same incidents visible to a health engine sampling the
    # island's registry (/alerts, slt top).
    ("diloco_delta_quarantined", "slt_diloco_quarantined_total",
     "warning"),
    # The numerics auditor's non-finite incidents (training/audit.py):
    # each is a step whose weights or gradients hold a NaN or an inf.
    ("numerics_nonfinite", "slt_numerics_nonfinite_total", "critical"),
)


class HealthEngine:
    """Samples a registry on a background thread and maintains alert
    state. All detector state lives here; ``sample_once(now)`` is the
    synchronous, clock-injectable tick the tests drive directly."""

    def __init__(self, registry=None, config=None,
                 interval_s: Optional[float] = None,
                 emit: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.time,
                 flight_dir: Optional[str] = None,
                 dump_on_critical: bool = True, ledger=None):
        from serverless_learn_tpu_torch.config import HealthConfig
        from serverless_learn_tpu_torch.telemetry.registry import get_registry

        if config is None:
            config = HealthConfig()
        elif isinstance(config, dict):
            config = HealthConfig(**config)
        self.config = config
        self.registry = registry or get_registry()
        self.interval_s = (interval_s if interval_s is not None
                           else config.sample_interval_s)
        self.clock = clock
        self.flight_dir = flight_dir
        self.dump_on_critical = dump_on_critical
        # The goodput ledger whose hold phases excuse a flat counter
        # (None: the process's ledger, looked up at each tick).
        self.ledger = ledger
        self._emit = emit
        self.slos = parse_slos(config.slos)  # raises on config typos
        self._burn: Dict[str, BurnRate] = {
            s["name"]: BurnRate(1.0 - float(s["objective"]),
                                short_s=config.slo_short_window_s,
                                long_s=config.slo_long_window_s,
                                fast_burn=config.slo_fast_burn,
                                slow_burn=config.slo_slow_burn)
            for s in self.slos}
        self._anomaly: Dict[str, EwmaMad] = {
            key: EwmaMad(window=config.anomaly_window,
                         min_samples=config.anomaly_min_samples)
            for key, *_ in _ANOMALY_RULES}
        self._stale: Dict[str, StalenessWatch] = {
            key: StalenessWatch(factor=config.stale_factor,
                                min_interval_s=config.stale_min_interval_s)
            for key, *_ in _STALE_RULES}
        self._event_last: Dict[str, Optional[float]] = {
            key: None for key, *_ in _EVENT_RULES}
        self._anchor_lag_prev: Optional[float] = None
        # Training-quality detectors: a LossHealth fed from the numerics
        # step ring (telemetry/numerics.note_step), made on the first tick
        # that finds the numerics module loaded.
        self._loss_health = None
        self._numerics_seen: Optional[int] = None
        self._alerts: Dict[tuple, Alert] = {}
        self._prev: Optional[dict] = None  # last flattened sample
        self._prev_t: Optional[float] = None
        self._last_sample: Optional[dict] = None
        self._rates: Dict[str, float] = {}
        self.ticks = 0
        self._last_dump_t: Optional[float] = None
        self.last_dump_path: Optional[str] = None
        # Alert hooks: fn(Alert) called on every NEW or escalated fire
        # (after the event emission). The profiler service registers its
        # rate-limited capture-on-critical here (telemetry/profiler.py).
        self._alert_hooks: List[Callable] = []
        # I/O staged by the locked tick (event emission, flight dumps,
        # alert hooks) and flushed by sample_once AFTER the lock drops:
        # /alerts and /healthz scrapes share this lock, and a slow disk
        # inside a tick must not stall them (SLT001). Outside a tick
        # (tests driving _fire/_calm directly) the staging flushes
        # immediately, preserving the synchronous unit contract.
        self._pending_actions: List[tuple] = []
        self._in_tick = False
        # RLock: defensive — an alert hook or flight context provider
        # that re-enters alerts() on the engine thread must not deadlock.
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HealthEngine":
        # Every flight dump from now on — SIGTERM, crash, lease expiry,
        # not just alert-triggered ones — carries the firing alert set,
        # so a dead node's dump says WHAT was wrong, not just what it
        # was doing.
        from serverless_learn_tpu_torch.telemetry import flight

        flight.add_context_provider(
            "alerts", lambda: self.alerts(firing_only=True) or None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slt-health")
        self._thread.start()
        return self

    def stop(self):
        from serverless_learn_tpu_torch.telemetry import flight

        flight.remove_context_provider("alerts")
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                pass  # the watchdog must never kill the watched process

    # -- emission ----------------------------------------------------------

    def _emit_event(self, rec: dict):
        if self._emit is not None:
            try:
                self._emit(rec)
            except Exception:
                pass
            return
        from serverless_learn_tpu_torch.telemetry import tracing

        tracing.emit_event(rec)

    def _node(self) -> str:
        from serverless_learn_tpu_torch.telemetry.tracing import node_name

        try:
            return node_name()
        except Exception:
            return ""

    # -- alert state machine -----------------------------------------------

    def _key(self, name: str, labels: Optional[dict]) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _fire(self, now: float, name: str, severity: str, detector: str,
              message: str, value: float, threshold: float,
              labels: Optional[dict] = None):
        key = self._key(name, labels)
        a = self._alerts.get(key)
        new = a is None or a.state == "resolved"
        if a is None:
            a = Alert(name=name, severity=severity, detector=detector,
                      message=message, node=self._node(),
                      labels=dict(labels or {}),
                      first_fired_unix_s=now)
            self._alerts[key] = a
        escalated = (SEVERITY_RANK.get(severity, 0)
                     > SEVERITY_RANK.get(a.severity, 0))
        if a.state == "resolved":
            a.first_fired_unix_s = now
            a.count = 0
        a.state = "firing"
        a.severity = severity if (new or escalated) else a.severity
        a.message = message
        a.value, a.threshold = float(value), float(threshold)
        a.last_fired_unix_s = now
        a.count += 1
        a.clean_ticks = 0
        a.resolved_unix_s = None
        if new or escalated:
            # Stage the I/O; sample_once flushes after the lock drops.
            self._pending_actions.append(("event", a.to_event()))
            if a.severity == "critical" and self.dump_on_critical:
                self._pending_actions.append(("dump", a))
            self._pending_actions.append(("hooks", a))
        self._flush_if_outside_tick(now)

    def _calm(self, now: float, name: str, labels: Optional[dict] = None):
        """Condition is clean this tick; resolve after ``clear_after``
        consecutive clean ticks (hysteresis against flapping)."""
        a = self._alerts.get(self._key(name, labels))
        if a is None or a.state != "firing":
            return
        a.clean_ticks += 1
        if a.clean_ticks >= self.config.clear_after_ticks:
            a.state = "resolved"
            a.resolved_unix_s = now
            self._pending_actions.append(("event", a.to_event()))
        self._flush_if_outside_tick(now)

    def add_alert_hook(self, fn: Callable):
        """``fn(alert)`` on every new/escalated fire. Hooks run inside
        the tick (keep them quick or hand off to a thread) and their
        exceptions are swallowed."""
        self._alert_hooks.append(fn)
        return fn

    def remove_alert_hook(self, fn: Callable):
        try:
            self._alert_hooks.remove(fn)
        except ValueError:
            pass

    def _maybe_dump(self, now: float, alert: Alert):
        """Critical alert → flight-recorder dump, rate-limited so a
        flapping detector can't fill a disk with dumps."""
        if (self._last_dump_t is not None
                and now - self._last_dump_t < self.config.dump_cooldown_s):
            return
        from serverless_learn_tpu_torch.telemetry import flight

        try:
            if self.flight_dir:
                path = flight.dump(f"alert:{alert.name}",
                                   dir=self.flight_dir)
            else:
                path = flight.maybe_dump(f"alert:{alert.name}")
        except Exception:
            path = None
        if path:
            self._last_dump_t = now
            self.last_dump_path = path

    # -- one tick ----------------------------------------------------------

    def _held_seconds(self) -> Dict[str, float]:
        """{watch key: seconds its hold phases have taken so far}, open
        phases included, from the goodput ledger."""
        from serverless_learn_tpu_torch.telemetry import goodput

        led = self.ledger if self.ledger is not None else goodput.get_ledger()
        phases = led.snapshot()["phases"]
        return {key: sum(phases.get(p, {}).get("seconds", 0.0)
                         for p in names)
                for key, names in _STALE_HOLD_PHASES.items()}

    def sample_once(self, now: Optional[float] = None):
        now = self.clock() if now is None else now
        sample = flatten_snapshot(self.registry.snapshot())
        sample["held_s"] = self._held_seconds()
        with self._lock:
            self._in_tick = True
            try:
                self._tick_locked(now, sample)
            finally:
                self._in_tick = False
                actions, self._pending_actions = self._pending_actions, []
        self._flush_actions(now, actions)

    def _flush_if_outside_tick(self, now: float):
        """Direct _fire/_calm callers (tests, future manual injectors) get
        synchronous emission; inside a tick the flush waits for the lock
        to drop."""
        # The check-and-swap of _pending_actions must be one atomic step
        # under _lock: racing sample_once() also swaps it, and an
        # unlocked swap could drop (or double-emit) staged actions.
        with self._lock:
            if self._in_tick or not self._pending_actions:
                return
            actions, self._pending_actions = self._pending_actions, []
        self._flush_actions(now, actions)

    def _flush_actions(self, now: float, actions: List[tuple]):
        """Run the tick's staged I/O (JSONL emission, flight dumps, alert
        hooks) with NO lock held: scrapes and the engine's own context
        provider stay responsive however slow the disk is."""
        for kind, payload in actions:
            if kind == "event":
                self._emit_event(payload)
            elif kind == "dump":
                self._maybe_dump(now, payload)
            elif kind == "hooks":
                for hook in list(self._alert_hooks):
                    try:
                        hook(payload)
                    except Exception:
                        pass  # forensics hooks must never break a tick

    def _tick_locked(self, now: float, sample: dict):
        values, hists = sample["values"], sample["hists"]
        prev, prev_t = self._prev, self._prev_t
        dt = (now - prev_t) if prev_t is not None else None

        # ---- anomaly family ----
        for key, kind, metric, direction, severity in _ANOMALY_RULES:
            x = self._extract(kind, metric, sample, prev, dt, key)
            if x is None:
                self._calm(now, f"anomaly.{key}")
                continue
            z = self._anomaly[key].update(x)
            bad = (z is not None
                   and ((direction == "high" and z > self.config.anomaly_z)
                        or (direction == "low"
                            and z < -self.config.anomaly_z)))
            if bad:
                self._fire(now, f"anomaly.{key}", severity, "anomaly",
                           f"{metric} {kind} {x:.6g} is anomalous "
                           f"(z={z:.1f}, ewma={self._anomaly[key].ewma:.6g})",
                           value=x, threshold=self.config.anomaly_z)
            else:
                self._calm(now, f"anomaly.{key}")

        # ---- SLO family ----
        for spec in self.slos:
            name = spec["name"]
            if spec["kind"] == "latency":
                h = hists.get(spec["metric"])
                if h is None:
                    continue
                good, total = hist_good_total(h, float(spec["threshold_s"]))
                bad_cum = total - good
            else:
                bad_cum = values.get(spec["bad"], 0.0)
                total = values.get(spec["total"], 0.0)
                if spec["total"] not in values:
                    continue
            r = self._burn[name].update(now, bad_cum, total)
            if r["severity"] is not None:
                self._fire(
                    now, f"slo.{name}", r["severity"], "slo",
                    f"SLO '{name}' burning error budget at "
                    f"{r['short_burn']:.1f}x (short) / "
                    f"{r['long_burn']:.1f}x (long) the sustainable rate",
                    value=r["short_burn"],
                    threshold=(self.config.slo_fast_burn
                               if r["severity"] == "critical"
                               else self.config.slo_slow_burn))
            else:
                self._calm(now, f"slo.{name}")

        # ---- structural: staleness watchdogs ----
        for key, metric, severity, gate in _STALE_RULES:
            watch = self._stale[key]
            if gate is not None and values.get(gate, 0.0) <= 0:
                watch.touch(now)
                self._calm(now, f"stale.{key}")
                continue
            stale = watch.update(now, values.get(metric),
                                 sample.get("held_s", {}).get(key, 0.0))
            if stale is not None:
                age, threshold = stale
                self._fire(now, f"stale.{key}", severity, "structural",
                           f"{metric} has not advanced in {age:.1f}s "
                           f"(threshold {threshold:.1f}s = "
                           f"{self.config.stale_factor:g}x the typical "
                           f"interval)", value=age, threshold=threshold)
            else:
                self._calm(now, f"stale.{key}")

        # ---- structural: incident-event counters ----
        for key, metric, severity in _EVENT_RULES:
            cur = values.get(metric)
            last = self._event_last[key]
            self._event_last[key] = cur
            if cur is None:
                continue
            if last is not None and cur > last:
                self._fire(now, f"event.{key}", severity, "structural",
                           f"{metric} advanced by {cur - last:g} "
                           f"(now {cur:g})", value=cur, threshold=last)
            else:
                self._calm(now, f"event.{key}")

        # ---- structural: anchor-lag growth ----
        lag = values.get("slt_diloco_anchor_lag_rounds")
        if lag is not None:
            prev_lag = self._anchor_lag_prev
            self._anchor_lag_prev = lag
            if (lag >= self.config.anchor_lag_rounds
                    and (prev_lag is None or lag >= prev_lag)):
                self._fire(now, "diloco.anchor_lag", "warning", "structural",
                           f"island is {lag:g} outer rounds behind LATEST "
                           f"and not catching up", value=lag,
                           threshold=self.config.anchor_lag_rounds)
            else:
                self._calm(now, "diloco.anchor_lag")

        # ---- numerics: training-quality detectors ----
        self._numerics_tick_locked(now)

        # ---- structural: DiLoCo stragglers ----
        scores = score_stragglers(
            recent_rounds(self.config.straggler_window_rounds),
            factor=self.config.straggler_factor,
            min_rounds=self.config.straggler_min_rounds)
        for wid, s in scores.items():
            labels = {"worker_id": wid}
            if s["flagged"]:
                self._fire(now, "straggler.diloco_worker", "warning",
                           "structural",
                           f"worker {wid} late/missing in "
                           f"{s['late'] + s['missing']} of "
                           f"{s['rounds_seen']} recent rounds "
                           f"(mean lag {s['mean_lag_s']:.2f}s)",
                           value=s["score"], threshold=0.5, labels=labels)
            else:
                self._calm(now, "straggler.diloco_worker", labels)

        self._prev, self._prev_t = sample, now
        self._last_sample = sample
        self.ticks += 1

    def _numerics_tick_locked(self, now: float):
        """Caller holds ``_lock``. Feed the new numerics step records (the
        auditor publishes them through ``numerics.note_step``) through the
        loss-health detectors and turn the findings into alerts. Records
        are read once, in step order; a tick with no new record leaves the
        alerts as they are (idle is not calm)."""
        import sys

        # Only a process whose auditor imported the numerics module has
        # records; the engine itself stays free of torch.
        mod = "serverless_learn_tpu_torch.telemetry.numerics"
        if mod not in sys.modules:
            return
        _numerics = sys.modules[mod]
        if self._loss_health is None:
            self._loss_health = _numerics.LossHealth(
                spike_z=self.config.numerics_spike_z,
                plateau_window=self.config.numerics_plateau_window,
                plateau_min_rel=self.config.numerics_plateau_min_rel,
                explode_z=self.config.numerics_explode_z)
        recs = [r for r in _numerics.recent_steps(128)
                if isinstance(r.get("step"), int)
                and (self._numerics_seen is None
                     or r["step"] > self._numerics_seen)]
        if not recs:
            return
        latest: Dict[str, Optional[dict]] = {}
        for rec in sorted(recs, key=lambda r: r["step"]):
            self._numerics_seen = rec["step"]
            verdicts = self._loss_health.update(
                rec["step"], rec.get("loss"), rec.get("grad_norm"))
            if rec.get("nonfinite"):
                first = rec.get("first")
                verdicts["nonfinite"] = {
                    "severity": "critical",
                    "value": float(rec["nonfinite"]), "threshold": 0.0,
                    "message": f"non-finite values at step {rec['step']}"
                               + (f" — first bad layer: {first}"
                                  if first else "")}
            latest.update(verdicts)
        for det, finding in latest.items():
            name = f"numerics.{det}"
            if finding is None:
                self._calm(now, name)
            else:
                self._fire(now, name, finding["severity"], "numerics",
                           finding["message"], value=finding["value"],
                           threshold=finding["threshold"])

    def _extract(self, kind: str, metric: str, sample: dict,
                 prev: Optional[dict], dt: Optional[float],
                 key: str) -> Optional[float]:
        """One scalar per tick per anomaly series; None = no new signal
        (never feeds the detector, so idle periods don't skew baselines)."""
        if kind == "hist_mean":
            h = sample["hists"].get(metric)
            if h is None or prev is None:
                return None
            hp = prev["hists"].get(metric)
            dc = h["count"] - (hp["count"] if hp else 0)
            ds = h["sum"] - (hp["sum"] if hp else 0.0)
            if dc <= 0:
                return None
            return ds / dc
        if kind == "rate":
            v = sample["values"].get(metric)
            if v is None or prev is None or not dt or dt <= 0:
                return None
            vp = prev["values"].get(metric, 0.0)
            rate = max(0.0, (v - vp) / dt)
            prev_rate = self._rates.get(key, 0.0)
            self._rates[key] = rate
            # Feed zero only on the transition into idle: a long-idle
            # server must not build a baseline of zeros that turns the
            # next real request into an "anomaly".
            if rate == 0.0 and prev_rate == 0.0:
                return None
            return rate
        return sample["values"].get(metric)

    # -- read side ---------------------------------------------------------

    @property
    def warm(self) -> bool:
        return self.ticks >= 2

    def alerts(self, firing_only: bool = False) -> List[dict]:
        with self._lock:
            alerts = [a for a in self._alerts.values()
                      if a.state == "firing" or not firing_only]
        alerts.sort(key=lambda a: (-SEVERITY_RANK.get(a.severity, 0),
                                   a.state != "firing",
                                   -a.last_fired_unix_s))
        return [a.to_event() for a in alerts]

    def alerts_payload(self) -> dict:
        """The `/alerts` endpoint body."""
        all_alerts = self.alerts()
        firing = [a for a in all_alerts if a["state"] == "firing"]
        resolved = [a for a in all_alerts if a["state"] == "resolved"]
        return {"node": self._node(),
                "now_unix_s": round(self.clock(), 3),
                "engine": {"warm": self.warm, "samples": self.ticks,
                           "interval_s": self.interval_s,
                           "slos": [s["name"] for s in self.slos]},
                "firing": firing,
                "resolved": resolved[:10]}

    def health(self) -> dict:
        """The `/healthz` body: ok iff no critical alert is firing."""
        now = self.clock()
        firing = self.alerts(firing_only=True)
        critical = [a["alert"] for a in firing
                    if a["severity"] == "critical"]
        with self._lock:
            sample = self._last_sample or {"values": {}, "hists": {}}
            step_age = self._stale["train_step"].age(now)
        values = sample["values"]
        components = {
            "engine": {"warm": self.warm, "samples": self.ticks,
                       "interval_s": self.interval_s},
            "last_step_age_s": (round(step_age, 3)
                                if step_age is not None else None),
            "mesh_size": values.get("slt_membership_size")
            or values.get("slt_train_n_chips"),
            "firing": len(firing),
        }
        return {"ok": not critical, "node": self._node(),
                "firing_critical": critical, "components": components}
