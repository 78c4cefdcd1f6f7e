"""Numerics auditor: the host side of the train step's statistics, the port
of ``serverless_learn_tpu/training/audit.py``.

The step leaves its statistics on the card (``metrics["numerics"]``, a
``telemetry.numerics.NumericsSummary``); this module:

* **fetches at the cadence**: ``on_step`` gets the step's summary every
  step but moves it to the host (one transfer of one stacked tensor) only
  every ``numerics.cadence`` steps, on the final step, and at the first
  step whose already-fetched loss or grad norm is non-finite; each fetch is
  charged to the ``numerics`` goodput phase and counted in
  ``slt_numerics_fetches_total``;
* **emits**: the ``slt_numerics_*`` gauges, a ``numerics_stats`` record
  (with its fingerprint section) on the event log and the optional
  ``numerics.fingerprint_log``, the numerics step ring (the health engine's
  detectors and ``/numerics``) and the flight ring;
* **root-causes a non-finite step**: the provenance sweep (first the params,
  then a forward with a hook on every module) over the checkpointer's host
  shadow where there is one, else the live state; a ``numerics_nonfinite``
  record naming the first bad layer, ``slt_numerics_nonfinite_total`` (the
  health engine's critical ``numerics.nonfinite``) and one flight dump.

The port's step updates the state in place, so the auditor keeps no tensor
across ``on_step`` calls: everything it keeps is host floats, and the live
state is read only inside ``on_step``, between two steps.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch

from serverless_learn_tpu_torch.config import ExperimentConfig
from serverless_learn_tpu_torch.telemetry import flight, goodput
from serverless_learn_tpu_torch.telemetry import numerics
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.registry import get_registry


def _live_params(state):
    """The live state's parameters as a flax tree (views, no copy)."""
    from serverless_learn_tpu_torch.bridge import to_flax

    model = state.model
    return to_flax({n: p.detach() for n, p in model.named_parameters()},
                   model.cfg)


class NumericsAuditor:
    """The host-side numerics pipeline of one training run. ``bundle`` (the
    trainer's model bundle) turns the provenance sweep on; ``shadow_fn() ->
    (host state tree, step) | (None, None)`` is its preferred source (the
    checkpointer's ``host_shadow``); ``ledger`` is the goodput ledger the
    fetches are charged to (the process's by default)."""

    def __init__(self, config: ExperimentConfig, registry=None, bundle=None,
                 shadow_fn: Optional[Callable] = None,
                 emit: Optional[Callable[[dict], None]] = None, ledger=None):
        ncfg = config.numerics
        self.config = config
        self.cadence = max(1, int(ncfg.cadence))
        self.depth = max(1, int(ncfg.depth))
        self.provenance_mode = ncfg.provenance
        self.bundle = bundle
        self.shadow_fn = shadow_fn
        self.ledger = ledger
        self._emit = emit
        reg = registry or get_registry()
        self._m_fetches = reg.counter(
            "slt_numerics_fetches_total",
            "cadence-gated device->host numerics fetches")
        self._m_nonfinite = reg.counter(
            "slt_numerics_nonfinite_total",
            "steps whose in-graph non-finite flag tripped")
        self._m_last_step = reg.gauge(
            "slt_numerics_last_step", "newest step with fetched stats")
        self._m_grad = reg.gauge("slt_numerics_grad_norm")
        self._m_param = reg.gauge("slt_numerics_param_norm")
        self._m_ratio = reg.gauge(
            "slt_numerics_update_ratio",
            "global update L2 / param L2 per fetched step")
        self._reg = reg
        self._fp_log = None
        if ncfg.fingerprint_log:
            from serverless_learn_tpu_torch.telemetry.registry import (
                JsonlEventLog)

            self._fp_log = JsonlEventLog(ncfg.fingerprint_log)
        self.fetches = 0
        self.nonfinite_steps: list = []
        self.last_provenance: Optional[dict] = None
        self._dumped = False

    def _phase(self):
        return (self.ledger.phase("numerics") if self.ledger is not None
                else goodput.phase("numerics"))

    # -- per-step hook -----------------------------------------------------

    def on_step(self, step: int, num_tree, metrics: Dict[str, float],
                state=None, batch=None, final: bool = False):
        """After every optimizer step, with the step's summary on the card
        (a ``telemetry.numerics.NumericsSummary``). Fetches it at the
        cadence (always on ``final``, and at the first step whose fetched
        loss or grad norm is non-finite, so the incident names its step);
        otherwise drops it."""
        if num_tree is None:
            return
        # Only the first incident forces an off-cadence fetch: after it
        # every step is non-finite, and one incident must not become a
        # record a step.
        forced = not self.nonfinite_steps and any(
            isinstance(v, float) and not math.isfinite(v)
            for v in (metrics.get("loss"), metrics.get("grad_norm")))
        if not final and not forced and step % self.cadence:
            return
        with self._phase():
            host = num_tree.fetch()
        self.fetches += 1
        self._m_fetches.inc()
        self._m_last_step.set(step)
        self._m_grad.set(host.get("grad_norm", 0.0))
        self._m_param.set(host.get("param_norm", 0.0))
        self._m_ratio.set(host.get("update_ratio", 0.0))
        for key, val in host.items():
            if key.startswith("grad/") and key.endswith("/l2"):
                self._reg.gauge("slt_numerics_subtree_grad_l2",
                                subtree=key.split("/")[1]).set(val)
            elif key.startswith("ratio/"):
                self._reg.gauge("slt_numerics_subtree_update_ratio",
                                subtree=key.split("/")[1]).set(val)
        record = self._record(step, host, metrics)
        self._emit_record(record)
        if self._fp_log is not None and "fp" in record:
            self._fp_log.emit({"event": "numerics_fingerprint",
                               "step": step, "fp": record["fp"]})
        numerics.note_step({"step": step,
                            "loss": metrics.get("loss"),
                            "grad_norm": host.get("grad_norm"),
                            "update_ratio": host.get("update_ratio"),
                            "nonfinite": int(host.get("nonfinite_total",
                                                      0.0))})
        numerics.set_last_report(
            {"step": step, "fetched_unix_s": round(time.time(), 3),
             **{k: v for k, v in host.items() if "/" not in k},
             "subtrees": record.get("subtrees", {})})
        flight.record({"event": "numerics_stats", "step": step,
                       "grad_norm": host.get("grad_norm"),
                       "update_ratio": host.get("update_ratio"),
                       "nonfinite": int(host.get("nonfinite_total", 0.0))})
        if host.get("nonfinite_total", 0.0) > 0:
            self._on_nonfinite(step, host, state, batch)

    # -- record shaping ----------------------------------------------------

    def _record(self, step: int, host: Dict[str, float],
                metrics: Dict[str, float]) -> dict:
        subs: Dict[str, dict] = {}
        fp: Dict[str, dict] = {}
        for key, val in host.items():
            parts = key.split("/")
            if len(parts) == 3 and parts[0] == "fp":
                fp.setdefault(parts[1], {})[parts[2]] = round(val, 9)
            elif len(parts) == 3:
                subs.setdefault(parts[1], {})[
                    f"{parts[0]}_{parts[2]}"] = round(val, 9)
            elif len(parts) == 2 and parts[0] == "ratio":
                subs.setdefault(parts[1], {})["update_ratio"] = round(val, 9)
        rec = {"event": "numerics_stats", "step": step,
               "loss": metrics.get("loss"),
               "grad_norm": round(host.get("grad_norm", 0.0), 9),
               "param_norm": round(host.get("param_norm", 0.0), 9),
               "update_norm": round(host.get("update_norm", 0.0), 9),
               "update_ratio": round(host.get("update_ratio", 0.0), 9),
               "nonfinite": int(host.get("nonfinite_total", 0.0)),
               "subtrees": subs}
        if fp:
            rec["fp"] = fp
        return rec

    def _emit_record(self, rec: dict):
        if self._emit is not None:
            try:
                self._emit(rec)
            except Exception:
                pass
            return
        ttrace.emit_event(rec)

    # -- non-finite incident path ------------------------------------------

    def _bad_subtrees(self, host: Dict[str, float]) -> list:
        bad = []
        for key, val in host.items():
            parts = key.split("/")
            if len(parts) == 3 and parts[2] == "nonfinite" and val > 0:
                bad.append(f"{parts[0]}:{parts[1]}")
        return sorted(set(bad))

    def _on_nonfinite(self, step: int, host: Dict[str, float], state,
                      batch):
        """Root-cause the incident now, between two steps, while the live
        state is this step's."""
        first_incident = not self.nonfinite_steps
        self._m_nonfinite.inc()
        self.nonfinite_steps.append(step)
        prov: Optional[dict] = None
        source = None
        if (first_incident and self.provenance_mode != "off"
                and self.bundle is not None):
            params = None
            if self.shadow_fn is not None:
                try:
                    shadow, _ = self.shadow_fn()
                except Exception:
                    shadow = None
                if shadow is not None:
                    params = shadow.get("params")
                    source = "host_shadow"
            if params is None and state is not None:
                params = _live_params(state)
                source = "live_state"
            if params is not None:
                prov = numerics.nonfinite_provenance(
                    getattr(state, "model", None), params, batch,
                    depth=self.depth)
                prov["source"] = source
        first = (prov or {}).get("first")
        rec = {"event": "numerics_nonfinite", "step": step,
               "first": first,
               "bad_subtrees": self._bad_subtrees(host),
               "nonfinite": int(host.get("nonfinite_total", 0.0))}
        if prov is not None:
            rec["provenance"] = {
                k: prov.get(k) for k in
                ("first", "kind", "param", "intermediates", "source")
                if prov.get(k) is not None}
        self.last_provenance = prov
        self._emit_record(rec)
        flight.record(rec)
        numerics.note_step({"step": step, "loss": float("nan"),
                            "nonfinite": int(host.get("nonfinite_total",
                                                      0.0)),
                            "first": first})
        if not self._dumped:
            # One dump a run; the health engine's critical alert adds its
            # own (rate-limited) one.
            self._dumped = True
            flight.maybe_dump(f"numerics:nonfinite:{first or 'unknown'}")

    def close(self):
        if self._fp_log is not None:
            self._fp_log.close()


def inject_nan(grads: Dict[str, torch.Tensor], step: int, inject_step: int,
               subtree: str = "", depth: int = 1) -> Dict[str, torch.Tensor]:
    """The chaos knob: at exactly ``inject_step``, scale the gradients of
    ``subtree`` (every gradient when empty) by NaN, in place. ``grads`` maps
    state-dict names (flax paths) to gradients."""
    if step != inject_step:
        return grads
    for name, g in grads.items():
        if g is None:
            continue
        if not subtree or numerics._subtree_name(
                tuple(name.split(".")), depth) == subtree:
            g.mul_(float("nan"))
    return grads
