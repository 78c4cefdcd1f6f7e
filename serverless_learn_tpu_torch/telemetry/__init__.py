"""Telemetry of the port: its own copy of ``serverless_learn_tpu/
telemetry/`` for the paths it runs, with the same metric names, label
sets, span names, goodput phases and JSON shapes, so the reference's
readers (``slt top``, ``slt doctor``, dashboards) read either package.

* ``registry.py``: the process-wide :class:`MetricsRegistry` (counters,
  gauges, fixed-bucket histograms), request :class:`Span`\\ s and the
  :class:`JsonlEventLog` sink.
* ``tracing.py``: W3C trace context, ``span``, ``init_tracing``,
  ``emit_event`` and the host-span :class:`~.tracing.Tracer`.
* ``flight.py``: the flight recorder and its death hooks.
* ``goodput.py``: the :class:`PhaseLedger` run ledger.
* ``profiler.py``: the one ``torch.profiler`` owner of the process.
* ``health.py``: the :class:`HealthEngine`.
* ``exporter.py``: ``/metrics``, ``/metrics.json``, ``/healthz``,
  ``/alerts``, ``/goodput``, ``/debug/profile``.
* ``waterfall.py``: per-request :class:`RequestWaterfall` ledgers and
  the engine's :class:`BoundaryEvents`.
* ``numerics.py``: training-quality statistics, fingerprints, NaN/Inf
  provenance and the loss-health detectors (imports torch, so it is not
  imported here; its auditor is ``training/audit.py``).

``dcn.py`` holds the store byte accounting the elastic trainer uses. The
reference's ``publish_rpc_stats`` (the ``stats`` command's mirror of a
daemon's RPC latencies into the registry) is left out. So are the reader
commands (``top``, ``doctor``, ``trace``, ``goodput``, ``waterfall``,
``profile``, ``xray``); ``ROADMAP.md`` lists them.
"""

from serverless_learn_tpu_torch.telemetry.exporter import (MetricsExporter,
                                                           fetch_text)
from serverless_learn_tpu_torch.telemetry.goodput import (PhaseLedger,
                                                          get_ledger, phase)
from serverless_learn_tpu_torch.telemetry.health import (Alert, HealthEngine,
                                                         score_stragglers)
from serverless_learn_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS, RATE_BUCKETS, SIZE_BUCKETS, Counter, Gauge, Histogram,
    JsonlEventLog, MetricsRegistry, Span, get_registry)
from serverless_learn_tpu_torch.telemetry.tracing import (TraceContext,
                                                          current_context,
                                                          init_tracing,
                                                          parse_traceparent)
from serverless_learn_tpu_torch.telemetry.waterfall import (BoundaryEvents,
                                                            RequestWaterfall)

__all__ = [
    "LATENCY_BUCKETS", "RATE_BUCKETS", "SIZE_BUCKETS",
    "Alert", "BoundaryEvents", "Counter", "Gauge", "HealthEngine",
    "Histogram", "JsonlEventLog", "MetricsRegistry", "MetricsExporter",
    "PhaseLedger", "RequestWaterfall", "Span", "TraceContext",
    "current_context", "fetch_text", "get_ledger", "get_registry",
    "init_tracing", "parse_traceparent", "phase", "score_stragglers",
]
