"""Batched serving: an admission queue that coalesces concurrent requests,
port of the static engine in ``serverless_learn_tpu/inference/batching.py``.

* Connection threads ``submit()`` requests and block on a per-request event.
* One dispatcher thread, the only user of the card, drains the queue,
  coalesces compatible requests (same sampling parameters and padded
  shapes), right-pads their prompts to a shared bucketed shape and runs ONE
  batched prefill + decode for the group.
* Unequal prompts are exact: each row decodes from its own length
  (``generate(prompt_lengths=...)``), so a greedy reply equals a solo call.

Shapes round up to powers of two as in the reference: prompt length (floor
8), ``max_new_tokens`` (extra tokens are generated, then dropped) and batch
size (pad rows repeat row 0). With a paged ``kv`` (``KVCacheConfig``), each
group runs over a fresh paged cache whose dense row-major table
(``kvcache.sequential_table``) gives every row ``max_seq_len`` of pages of
its own: the pool abstraction without sharing, token-identical to the
monolithic cache. Sampled requests also key their group on the
seed, so a client's seed is never replaced by a batch-mate's; the draws
still come from one generator for the padded batch, so a sampled reply may
vary with its batch-mates. Greedy requests are batch-invariant.

Telemetry, as the reference's: the ``engine="static"`` series of the
registry, a ``request`` span per request (submit, admit, first_token,
done; TTFT equals latency, since a group runs to completion) with a
reduced waterfall (queue, admit, compile, generate), flight records, and
the goodput phases ``idle``, ``admit_wait``, ``compile`` (a group shape
seen for the first time) and ``decode``. A group runs inside
``profiler.device_work()``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from serverless_learn_tpu_torch.config import KVCacheConfig, WaterfallConfig
from serverless_learn_tpu_torch.inference.generate import generate, init_cache
from serverless_learn_tpu_torch.models.transformer import Transformer
from serverless_learn_tpu_torch.telemetry import flight, goodput, profiler
from serverless_learn_tpu_torch.telemetry.registry import (RATE_BUCKETS,
                                                           SIZE_BUCKETS, Span,
                                                           get_registry)
from serverless_learn_tpu_torch.telemetry.tracing import node_name
from serverless_learn_tpu_torch.telemetry.waterfall import RequestWaterfall


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


# Prompt-length histogram buckets (slt_request_prompt_tokens): prompts
# span tokens to books, unlike the batch-size-shaped SIZE_BUCKETS.
PROMPT_BUCKETS = (1, 4, 16, 64, 256, 1024, 4096, 16384)


@dataclass
class _Pending:
    prompt: np.ndarray  # int32, built once at submit()
    max_new: int
    temperature: float
    top_k: int
    eos_id: Optional[int]
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    group_key: tuple = ()
    span: Optional[Span] = None  # request trace: submit/admit/done
    wf: Optional[RequestWaterfall] = None  # the reduced ledger


def _shape_buckets(prompt_len: int, max_new: int, max_seq_len: int) -> tuple:
    """(prompt_bucket, new_bucket) with prompt_bucket >= prompt_len,
    new_bucket >= max_new and their sum <= max_seq_len: padding never pushes
    a request past the window a solo call would have fitted."""
    nb = _bucket(max_new, floor=1)
    pb = _bucket(prompt_len)
    if pb + nb > max_seq_len:
        pb = max_seq_len - nb
        if pb < prompt_len:
            pb = prompt_len
            nb = min(nb, max_seq_len - pb)
    return pb, nb


def _group_key(prompt_len: int, max_new: int, temperature: float, top_k: int,
               eos_id: Optional[int], seed: int, max_seq_len: int) -> tuple:
    return (temperature, top_k, eos_id, seed if temperature > 0 else None,
            _shape_buckets(prompt_len, max_new, max_seq_len))


class BatchingEngine:
    """Owns the model; coalesces submitted requests into batched decodes."""

    def __init__(self, model: Transformer, max_batch: int = 8,
                 batch_wait_ms: float = 3.0,
                 kv: Optional[KVCacheConfig] = None, registry=None,
                 event_log=None,
                 waterfall: Optional[WaterfallConfig] = None):
        self.model = model
        self.kv = kv
        self._paged = bool(kv is not None and kv.paged)
        self.max_batch = max_batch
        self.batch_wait_s = batch_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_batched = 0
        self.event_log = event_log
        self.waterfall = waterfall if waterfall is not None \
            else WaterfallConfig()
        reg = registry or get_registry()
        self.registry = reg
        lbl = {"engine": "static"}
        self._m_requests = reg.counter(
            "slt_requests_total", "requests accepted by the engine", **lbl)
        self._m_finished = reg.counter("slt_requests_finished_total", **lbl)
        self._m_tokens = reg.counter(
            "slt_decode_tokens_total", "tokens returned to callers", **lbl)
        self._m_qwait = reg.histogram(
            "slt_request_queue_wait_seconds",
            "submit -> batched dispatch", **lbl)
        # A group runs to completion: first and last token reach the host
        # together, so TTFT equals latency here.
        self._m_ttft = reg.histogram(
            "slt_request_ttft_seconds", "submit -> first token on host",
            **lbl)
        self._m_latency = reg.histogram(
            "slt_request_latency_seconds", "submit -> final token", **lbl)
        self._m_admit_sz = reg.histogram(
            "slt_admit_batch_size", "requests per coalesced group",
            buckets=SIZE_BUCKETS, **lbl)
        self._m_tps = reg.histogram(
            "slt_request_tokens_per_sec", buckets=RATE_BUCKETS, **lbl)
        self._m_prompt_tokens = reg.histogram(
            "slt_request_prompt_tokens",
            "prompt length per accepted request", buckets=PROMPT_BUCKETS,
            **lbl)
        self._m_activity = reg.gauge(
            "slt_engine_last_activity_unix_s",
            "wall time of the dispatcher's last group dispatch", **lbl)
        # Group shapes seen before: a fresh one is charged to "compile"
        # (on the card the first group also builds the kernels).
        self._compiled_groups: set = set()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int, temperature: float,
               top_k: int, eos_id: Optional[int], seed: int,
               timeout_s: float = 600.0, trace=None) -> dict:
        """Blocks until the dispatcher serves this request; returns either
        {"new_tokens": [...], "batch_size": n} or {"error": ...}.
        ``trace``: the caller's :class:`~..telemetry.TraceContext`, which
        the request span chains under."""
        max_seq = self.model.cfg.max_seq_len
        if len(prompt) == 0:
            return {"error": "prompt must contain at least one token"}
        if len(prompt) + max_new > max_seq:
            return {"error": f"prompt ({len(prompt)}) + max_new_tokens "
                             f"({max_new}) exceeds max_seq_len {max_seq}"}
        p = _Pending(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                     temperature=temperature, top_k=top_k, eos_id=eos_id,
                     seed=seed)
        p.group_key = _group_key(len(prompt), max_new, temperature, top_k,
                                 eos_id, seed, max_seq)
        self._m_prompt_tokens.observe(len(prompt))
        p.span = (Span("request", trace_id=trace.trace_id,
                       parent_id=trace.span_id)
                  if trace is not None else Span("request"))
        if self.waterfall.enabled:
            p.wf = RequestWaterfall(engine="static")
        self._m_requests.inc()
        self._q.put(p)
        if not p.done.wait(timeout_s):
            return {"error": "generation timed out in the admission queue"}
        return p.result

    # -- dispatcher --------------------------------------------------------

    def _emit_span(self, span) -> None:
        """Span record -> the JSONL event log + the flight ring."""
        rec = span.to_event()
        rec.setdefault("node", node_name())
        if self.event_log is not None:
            self.event_log.emit(rec)
        flight.record(rec)

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                with goodput.phase("idle"):
                    first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            extras: List[_Pending] = []
            deadline = time.perf_counter() + self.batch_wait_s
            # Admission window: wait up to batch_wait_ms for co-batchable
            # requests ("admit_wait" badput); mismatched keys go back for
            # the next round.
            with goodput.phase("admit_wait"):
                while len(group) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt.group_key == first.group_key:
                        group.append(nxt)
                    else:
                        extras.append(nxt)
            for e in extras:
                self._q.put(e)
            try:
                self._m_activity.set(time.time())
                with profiler.device_work():
                    self._run_group(group)
            except Exception as ex:  # reply to every member, keep serving
                for p in group:
                    p.result = {"error": f"{type(ex).__name__}: {ex}"}
                    p.done.set()

    def _run_group(self, group: List[_Pending]):
        first = group[0]
        prompt_bucket, new_bucket = first.group_key[-1]
        n = len(group)
        batch_bucket = 1
        while batch_bucket < n:
            batch_bucket *= 2
        batch_bucket = min(batch_bucket, self.max_batch)

        prompts = np.zeros((batch_bucket, prompt_bucket), np.int32)
        lengths = np.ones((batch_bucket,), np.int32)
        self._m_admit_sz.observe(n)
        for i, p in enumerate(group):
            prompts[i, :len(p.prompt)] = p.prompt
            lengths[i] = len(p.prompt)
            if p.span is not None:
                p.span.mark("admit")
                wait = p.span.between(None, "admit")
                if wait is not None:
                    self._m_qwait.observe(wait)
        # Pad rows replicate row 0 so they can't inject out-of-range ids.
        for i in range(n, batch_bucket):
            prompts[i] = prompts[0]
            lengths[i] = lengths[0]

        shape_key = (batch_bucket, prompt_bucket, new_bucket,
                     first.temperature > 0, first.top_k > 0,
                     first.eos_id is not None)
        new_shape = shape_key not in self._compiled_groups
        self._compiled_groups.add(shape_key)
        dev = self.model.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(first.seed)
        t_g0 = time.perf_counter()
        with goodput.phase("compile" if new_shape else "decode"):
            cache = (init_cache(self.model, batch_bucket,
                                block_size=self.kv.block_size)
                     if self._paged else None)
            tokens = generate(self.model, torch.from_numpy(prompts),
                              new_bucket, temperature=first.temperature,
                              top_k=first.top_k, eos_id=first.eos_id,
                              generator=gen,
                              prompt_lengths=torch.from_numpy(lengths),
                              cache=cache)
            new = tokens[:, prompt_bucket:].cpu().numpy()
        t_g1 = time.perf_counter()
        self.batches_run += 1
        self.requests_batched += n
        for i, p in enumerate(group):
            p.result = {"new_tokens": [int(t) for t in new[i, :p.max_new]],
                        "batch_size": n}
            self._m_finished.inc()
            self._m_tokens.inc(p.max_new)
            if p.span is not None:
                p.span.mark("first_token")
                p.span.mark("done")
                lat = p.span.between(None, "done")
                if lat is not None:
                    self._m_ttft.observe(lat)
                    self._m_latency.observe(lat)
                    if lat > 0:
                        self._m_tps.observe(p.max_new / lat)
                if p.wf is not None:
                    # A cold group charges its whole generate wall to
                    # "compile"; warm groups show it as "generate".
                    if new_shape:
                        p.wf.note_compile(t_g0, t_g1)
                    p.span.meta["waterfall"] = p.wf.finalize(p.span)
                p.span.meta["max_new"] = p.max_new
                p.span.meta["batch_size"] = n
                self._emit_span(p.span)
            p.done.set()

    def warm(self, prompt_len: int, max_new: int, temperature: float = 0.0,
             top_k: int = 0, eos_id: Optional[int] = None, batch_sizes=(1,)):
        """Run synthetic groups of the given batch sizes straight through
        ``_run_group`` (bypassing the queue: call only while no live
        submissions are in flight), so a timed window starts with the
        kernels built and the allocator warm."""
        max_seq = self.model.cfg.max_seq_len
        for n in batch_sizes:
            group = []
            for _ in range(n):
                p = _Pending(prompt=np.full((prompt_len,), 1, np.int32),
                             max_new=max_new, temperature=temperature,
                             top_k=top_k, eos_id=eos_id, seed=0)
                p.group_key = _group_key(prompt_len, max_new, temperature,
                                         top_k, eos_id, 0, max_seq)
                group.append(p)
            with profiler.device_work():
                self._run_group(group)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30.0)
        # Fail any stragglers rather than leaving submitters blocked.
        try:
            while True:
                p = self._q.get_nowait()
                p.result = {"error": "server shutting down"}
                p.done.set()
        except queue.Empty:
            pass
