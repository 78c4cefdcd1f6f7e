"""HTTP endpoint of the registry, a copy of
``serverless_learn_tpu/telemetry/exporter.py``:

    GET /metrics                   Prometheus text exposition (0.0.4)
    GET /metrics.json              nested JSON snapshot (same data, typed)
    GET /healthz                   component readiness (503 while a
                                   critical health alert fires)
    GET /alerts                    the health engine's firing and resolved
                                   alerts ({"enabled": false} without one)
    GET /goodput                   the run ledger's goodput/badput report,
                                   MFU-weighted when ``slt_train_mfu`` is set
    GET /numerics                  training-quality stats: the numerics
                                   auditor's newest fetched summary and its
                                   recent step records
    GET /debug/profile?seconds=N   a ``torch.profiler`` capture
                                   (armed by ``--profile-dir``)

Unknown paths get a JSON 404 naming these endpoints, a handler that
raises a JSON 500. The reference's ``/stalls``, ``/fleetscope`` and
``/canary`` wait for the port of their readers and producers.

One ``ThreadingHTTPServer`` on a daemon thread: scrapes read the
registry under its lock and never touch the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from serverless_learn_tpu_torch.telemetry.profiler import MAX_PROFILE_SECONDS
from serverless_learn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                           get_registry)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# Every path do_GET serves, in docstring order — the 404 body names them
# so a typo'd scrape is self-correcting.
ENDPOINTS = ("/metrics", "/metrics.json", "/healthz", "/alerts",
             "/goodput", "/numerics", "/debug/profile")


class MetricsExporter:
    """Serve one registry over HTTP from a background thread."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 profile_dir: Optional[str] = None):
        self.registry = registry or get_registry()
        self.profile_dir = profile_dir
        # Optional cluster-health engine (telemetry/health.py): when
        # attached, /healthz reports real component readiness (503 while
        # a critical alert fires — orchestrator-probeable) and /alerts
        # serves its firing/resolved alert state.
        self.health = None
        self._owns_health = False
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no per-scrape stderr spam
                pass

            def _reply(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj: dict):
                self._reply(code, "application/json",
                            json.dumps(obj).encode())

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                try:
                    if path == "/metrics":
                        body = exporter.registry.render_prometheus()
                        self._reply(200, PROM_CONTENT_TYPE, body.encode())
                    elif path == "/metrics.json":
                        body = json.dumps(exporter.registry.snapshot())
                        self._reply(200, "application/json", body.encode())
                    elif path == "/healthz":
                        code, obj = exporter._healthz()
                        self._reply_json(code, obj)
                    elif path == "/alerts":
                        self._reply_json(200, exporter._alerts())
                    elif path == "/goodput":
                        self._reply_json(200, exporter._goodput())
                    elif path == "/numerics":
                        self._reply_json(200, exporter._numerics())
                    elif path == "/debug/profile":
                        code, obj = exporter._profile(
                            parse_qs(url.query),
                            self.headers.get("X-SLT-Trace"))
                        self._reply_json(code, obj)
                    else:
                        self._reply_json(
                            404, {"ok": False,
                                  "error": f"unknown path {path!r}",
                                  "endpoints": list(ENDPOINTS)})
                except (BrokenPipeError, ConnectionResetError):
                    pass  # scraper hung up mid-reply; nothing to salvage
                except Exception as e:
                    try:
                        self._reply_json(
                            500, {"ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread: Optional[threading.Thread] = None

    # -- health ------------------------------------------------------------

    def attach_health(self, engine, own: bool = False):
        """Wire a HealthEngine behind /healthz and /alerts. ``own=True``
        makes stop() stop the engine too (the CLI's single-owner path)."""
        self.health = engine
        self._owns_health = own
        return self

    def _healthz(self):
        """(code, body): 503 while a critical alert fires, else 200 with
        component readiness. Without an engine, the legacy liveness probe
        (the process answers, that is all it claims)."""
        if self.health is None:
            return 200, {"ok": True, "engine": None}
        try:
            rep = self.health.health()
        except Exception as e:
            return 500, {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return (200 if rep.get("ok") else 503), rep

    def _alerts(self) -> dict:
        if self.health is None:
            return {"enabled": False, "firing": [], "resolved": []}
        try:
            return dict(self.health.alerts_payload(), enabled=True)
        except Exception as e:
            return {"enabled": True, "firing": [], "resolved": [],
                    "error": f"{type(e).__name__}: {e}"}

    # -- goodput -----------------------------------------------------------

    def _goodput(self) -> dict:
        """The /goodput body: the process ledger's report, MFU-weighted
        when the trainer has published ``slt_train_mfu``."""
        from serverless_learn_tpu_torch.telemetry import goodput

        try:
            mfu = None
            fam = self.registry.snapshot().get("slt_train_mfu")
            if fam:
                vals = [s.get("value") for s in fam.get("series", [])
                        if isinstance(s.get("value"), (int, float))]
                if vals:
                    mfu = max(vals)
            return dict(goodput.get_ledger().report(mfu=mfu), enabled=True)
        except Exception as e:
            return {"enabled": True,
                    "error": f"{type(e).__name__}: {e}"}

    # -- numerics ----------------------------------------------------------

    def _numerics(self) -> dict:
        """The /numerics body: the auditor's newest host-fetched summary
        and the recent step records (floats only)."""
        import sys

        # Only a process that imported the numerics module has records.
        mod = sys.modules.get("serverless_learn_tpu_torch.telemetry.numerics")
        if mod is None:
            return {"enabled": False, "last": None, "recent_steps": []}
        try:
            return mod.endpoint_payload()
        except Exception as e:
            return {"enabled": False,
                    "error": f"{type(e).__name__}: {e}"}

    # -- on-demand device profiling ---------------------------------------

    def _profile(self, query: dict, trace_header: Optional[str]):
        """Handle /debug/profile: returns (http_code, reply_json). The
        capture itself is the shared profiler service's — this exporter's
        ``profile_dir`` (when set) overrides the process-armed one."""
        from serverless_learn_tpu_torch.telemetry import profiler

        base = self.profile_dir or profiler.profile_dir()
        if not base:
            return 404, {"ok": False,
                         "error": "profiling disabled; start this process "
                                  "with --profile-dir DIR to enable"}
        try:
            seconds = float(query.get("seconds", ["3"])[0])
        except ValueError:
            return 400, {"ok": False, "error": "seconds must be a number"}
        if not (0 < seconds <= MAX_PROFILE_SECONDS):
            return 400, {"ok": False,
                         "error": f"seconds must be in (0, "
                                  f"{MAX_PROFILE_SECONDS:g}]"}
        try:
            from serverless_learn_tpu_torch.telemetry import tracing as ttrace

            parent = ttrace.parse_traceparent(trace_header)
            out_dir = os.path.join(base, f"profile-{int(time.time())}")
            with ttrace.span("debug/profile", parent=parent,
                             emit=parent is not None, dir=out_dir,
                             seconds=seconds):
                rep = profiler.capture(seconds, out_dir=out_dir)
            return 200, rep
        except profiler.ProfilerBusy as e:
            return 409, {"ok": False, "error": str(e)}
        except Exception as e:
            return 500, {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._owns_health and self.health is not None:
            self.health.stop()


def fetch_text(addr: str, path: str = "/metrics",
               timeout: float = 5.0, headers: Optional[dict] = None) -> str:
    """One scrape of ``host:port`` (no scheme) — the client `slt top` and
    the endpoint tests share. ``headers`` rides extras (X-SLT-Trace)."""
    from urllib.request import Request, urlopen

    req = Request(f"http://{addr}{path}", headers=headers or {})
    with urlopen(req, timeout=timeout) as r:
        return r.read().decode()
