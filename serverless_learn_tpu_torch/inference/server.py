"""Generation server: JSON lines over TCP, port of
``serverless_learn_tpu/inference/server.py`` with the same wire protocol,
so the fleet router can front a replica of either package.

    request:  {"prompt": [5, 9, 11], "max_new_tokens": 32,
               "temperature": 0.8, "top_k": 40, "eos_id": 2, "seed": 1}
    reply:    {"tokens": [...], "new_tokens": [...], "batch_size": 1,
               "latency_ms": 12.3}
    errors:   {"error": "..."}
    admin:    {"op": "ping"} -> {"ok": true, "draining": false,
                                 "requests_served": N, "kv": {...}}
              {"op": "drain"} -> {"ok": true, "draining": true}

Each connection gets its own thread; generation goes through one engine:
by default the continuous one (``inference/continuous.py``: slots admitted
and retired at chunk boundaries over the paged KV pool, whose pressure the
ping reports under "kv"), or with ``engine="static"`` the group coalescer
(``inference/batching.py``), which runs concurrent compatible requests as
one batched prefill + decode. ``kv`` (``KVCacheConfig``, default paged)
configures either engine's cache. A request line longer than ``MAX_LINE``
bytes gets an error reply and the connection is dropped. A ``traceparent``
field, when well formed, parents the engine's request span and has its
trace id echoed in the reply.

Telemetry, the reference's: ``registry`` (default the process's) takes
the engine's series and the server's ``slt_server_requests_total``,
``slt_server_errors_total`` and ``slt_server_request_seconds``;
``metrics_port`` starts the ``/metrics`` exporter (0 picks a port, in
``metrics_addr``); ``event_log_path`` is the JSONL sink of the request
spans; ``profile_dir`` arms the shared profiler (``/debug/profile``);
``waterfall`` configures the per-request ledgers.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Optional

from serverless_learn_tpu_torch.config import KVCacheConfig, WaterfallConfig
from serverless_learn_tpu_torch.models.transformer import Transformer
from serverless_learn_tpu_torch.telemetry import (JsonlEventLog,
                                                  get_registry,
                                                  parse_traceparent)

# Longest accepted request line. A 128k-token prompt of 7-digit ids is
# ~1 MB; 4 MB leaves headroom while bounding per-connection memory.
MAX_LINE = 4 * 1024 * 1024

class GenerationServer:
    """Owns a model and serves generation requests."""

    def __init__(self, model: Transformer, host: str = "127.0.0.1",
                 port: int = 0, conn_timeout_s: float = 60.0,
                 max_batch: int = 8, batch_wait_ms: float = 3.0,
                 engine: str = "continuous", chunk_size: int = 32,
                 kv: Optional[KVCacheConfig] = None, registry=None,
                 metrics_port: Optional[int] = None,
                 event_log_path: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 waterfall: Optional[WaterfallConfig] = None):
        # The paged KV cache is the serving default, as in the reference;
        # KVCacheConfig(paged=False) keeps the monolithic rows.
        if kv is None:
            kv = KVCacheConfig()
        self.registry = registry or get_registry()
        self.event_log = (JsonlEventLog(event_log_path)
                          if event_log_path else None)
        if engine == "continuous":
            from serverless_learn_tpu_torch.inference.continuous import (
                ContinuousBatchingEngine)

            self.engine = ContinuousBatchingEngine(
                model, max_slots=max_batch, chunk_size=chunk_size, kv=kv,
                registry=self.registry, event_log=self.event_log,
                waterfall=waterfall)
        elif engine == "static":
            from serverless_learn_tpu_torch.inference.batching import (
                BatchingEngine)

            self.engine = BatchingEngine(
                model, max_batch=max_batch, batch_wait_ms=batch_wait_ms,
                kv=kv, registry=self.registry, event_log=self.event_log,
                waterfall=waterfall)
        else:
            raise ValueError(f"unknown engine {engine!r}: expected "
                             "'continuous' or 'static'")
        self._exporter = None
        self.metrics_addr: Optional[str] = None
        if profile_dir:
            from serverless_learn_tpu_torch.telemetry import profiler

            profiler.arm(profile_dir)
        if metrics_port is not None:
            from serverless_learn_tpu_torch.telemetry import MetricsExporter

            self._exporter = MetricsExporter(self.registry, host=host,
                                             port=metrics_port,
                                             profile_dir=profile_dir).start()
            self.metrics_addr = self._exporter.addr
        self._m_requests = self.registry.counter(
            "slt_server_requests_total", "requests answered over the wire")
        self._m_errors = self.registry.counter(
            "slt_server_errors_total", "error replies (validation + engine)")
        self._m_latency = self.registry.histogram(
            "slt_server_request_seconds", "handle() wall time")
        self.model = model
        self.conn_timeout_s = conn_timeout_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr = f"{host}:{self._sock.getsockname()[1]}"
        self.draining = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns = {}  # live connection thread -> socket, for stop()
        self._conns_lock = threading.Lock()
        self.max_connections = 64  # bounds threads and total line buffers
        self.requests_served = 0
        self._stats_lock = threading.Lock()

    # -- request handling --------------------------------------------------

    def _admin(self, req: dict) -> dict:
        """"ping" reports liveness and drain state without touching the
        card; "drain" starts graceful retirement."""
        op = req.get("op")
        if op == "ping":
            rep = {"ok": True, "draining": self.draining,
                   "requests_served": self.requests_served}
            # A paged engine reports its pool's pressure and prefix hits.
            kv_stats = getattr(self.engine, "kv_stats", None)
            kv = kv_stats() if callable(kv_stats) else None
            if kv:
                rep["kv"] = kv
            return rep
        if op == "drain":
            threading.Thread(target=self.drain, daemon=True).start()
            return {"ok": True, "draining": True}
        return {"error": f"unknown op {op!r}"}

    def handle(self, req: dict) -> dict:
        try:
            rep = self._handle(req)
        except Exception:
            # The caller turns this into an error reply; count it as one.
            self._m_requests.inc()
            self._m_errors.inc()
            raise
        self._m_requests.inc()
        if "error" in rep:
            self._m_errors.inc()
        elif "latency_ms" in rep:
            self._m_latency.observe(rep["latency_ms"] / 1e3)
        return rep

    def _handle(self, req: dict) -> dict:
        t0 = time.perf_counter()
        trace = parse_traceparent(req.get("traceparent"))
        cfg = self.model.cfg
        prompt = req.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return {"error": "prompt must be a non-empty list of token ids"}
        vocab = cfg.vocab_size
        if any(t < 0 or t >= vocab for t in prompt):
            return {"error": f"prompt token out of range [0, {vocab})"}
        max_new = int(req.get("max_new_tokens", 32))
        if max_new < 0 or len(prompt) + max_new > cfg.max_seq_len:
            return {"error": f"prompt+max_new_tokens exceeds max_seq_len "
                             f"{cfg.max_seq_len}"}
        eos = req.get("eos_id")
        rep = self.engine.submit(
            prompt, max_new, temperature=float(req.get("temperature", 0.0)),
            top_k=int(req.get("top_k", 0)),
            eos_id=None if eos is None else int(eos),
            seed=int(req.get("seed", 0)), trace=trace)
        if "error" in rep:
            return rep
        with self._stats_lock:
            self.requests_served += 1
        out = {"tokens": prompt + rep["new_tokens"],
               "new_tokens": rep["new_tokens"],
               "batch_size": rep.get("batch_size", 1),
               "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)}
        if trace is not None:
            out["trace_id"] = trace.trace_id
        return out

    # -- socket loop -------------------------------------------------------

    def _serve_conn(self, conn: socket.socket):
        # The read timeout bounds each connection thread's lifetime.
        conn.settimeout(self.conn_timeout_s)
        with conn, conn.makefile("rwb") as f:
            while True:
                try:
                    line = f.readline(MAX_LINE + 2)
                except socket.timeout:
                    return
                if not line:
                    return
                if len(line.rstrip(b"\r\n")) > MAX_LINE:
                    # Oversized or newline-free stream: reply once, hang up.
                    f.write(json.dumps(
                        {"error": f"request line exceeds {MAX_LINE} bytes"}
                    ).encode() + b"\n")
                    f.flush()
                    return
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise ValueError("request must be a JSON object")
                    rep = (self._admin(req) if "op" in req
                           else self.handle(req))
                except Exception as e:  # any bad request -> error reply,
                    rep = {"error": f"{type(e).__name__}: {e}"}  # server lives
                f.write(json.dumps(rep).encode() + b"\n")
                f.flush()

    def serve_forever(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = None
            with self._conns_lock:
                if len(self._conns) < self.max_connections:
                    t = threading.Thread(
                        target=self._serve_conn_safe, args=(conn,),
                        daemon=True)
                    self._conns[t] = conn
            if t is None:
                # At the cap: refuse, with no lock held while writing.
                try:
                    conn.sendall(json.dumps(
                        {"error": "server at connection capacity"}
                    ).encode() + b"\n")
                    conn.close()
                except OSError:
                    pass
                continue
            t.start()

    def _serve_conn_safe(self, conn: socket.socket):
        try:
            self._serve_conn(conn)
        except OSError:
            pass  # client vanished or stalled: drop it, keep serving
        finally:
            with self._conns_lock:
                self._conns.pop(threading.current_thread(), None)

    def drain(self, grace_s: float = 10.0):
        """Stop accepting new connections and wait (up to ``grace_s``) for
        in-flight requests to finish; the engine runs until stop()."""
        self.draining = True
        try:
            self._sock.close()
        except OSError:
            pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            with self._conns_lock:
                if not self._conns:
                    return
            time.sleep(0.02)

    def start(self):
        """Serve on a background thread (tests, embedding)."""
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Unblock idle readers, then wait for in-flight requests before the
        # engine goes away.
        with self._conns_lock:
            live = list(self._conns.items())
        for _, c in live:
            try:
                c.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        for t, _ in live:
            t.join(timeout=30.0)
        self.engine.stop()
        if self._exporter is not None:
            self._exporter.stop()
        if self.event_log is not None:
            self.event_log.close()


def request(addr: str, req: dict, timeout: float = 120.0) -> dict:
    """One-shot client helper."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        with s.makefile("rwb") as f:
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            line = f.readline()
    if not line:
        raise ConnectionError("server closed connection without replying")
    return json.loads(line)
