"""Continuous batching: a slot-level decode scheduler over a paged KV pool,
port of ``serverless_learn_tpu/inference/continuous.py`` with its
telemetry and without ``set_params`` (ROADMAP.md queue 1 item 1c).

Instead of running a coalesced group to completion (``inference/
batching.py``), the engine keeps ``max_slots`` decode slots and admits and
retires requests at chunk boundaries:

* **Paged KV pool** (``inference/kvcache.py``, ``KVCacheConfig``): each
  layer owns ``pages_k/v [num_blocks + 1, block_size, K, D]``; a host-side
  free-list allocator hands pages to slots through per-slot block tables,
  so a slot holds pages only for the tokens it has produced and retirement
  returns them at once. Decode runs over a COMPACTED live batch with a
  table window ``W`` bucketed to the live pages, so retired slots cost no
  compute and short sequences do not attend over ``max_seq_len``.
* **Shared-prefix reuse** (``prefix_cache``): a prompt's full blocks are
  published to a token-keyed trie after prefill; a later identical prefix
  adopts the refcounted read-only pages and skips recomputing them, with
  copy-on-write at the first divergent block.
* **Chunked prefill** (``prefill_chunk``): long prompts prefill in chunks
  interleaved between decode boundaries, at most ``prefill_budget`` prompt
  tokens a boundary (FIFO). Pool exhaustion at admission is typed
  backpressure (the request stays queued); at decode, cached prefixes are
  evicted first, then the youngest slot is preempted (its restart is
  token-identical: a sampled token depends only on the request's seed and
  position).

``KVCacheConfig(paged=False)`` keeps the monolithic ``[max_slots,
max_seq_len, K, D]`` rows, the equivalence baseline: batched prefill at
admission, then every chunk decodes all ``max_slots`` rows.

**Decode chunks.** A chunk is ``chunk_size`` single-token steps, and the
host returns once a chunk. On the card each paged (live batch, window)
bucket is one CUDA graph of ONE decode step, captured the first time the
bucket is seen (the counterpart of the reference's jit memoized per key,
one compile a key) and replayed ``chunk_size`` times a chunk; all graphs
share one memory pool and are replayed one after another on one stream.
The step reads and writes static buffers (tokens, positions, index, table
window and the sampling vectors) that the engine fills from its per-slot
state before the replays and copies back after them. On the CPU the same
step runs eagerly. Prefill chunks run eagerly: their buckets (batch,
chunk, window) are many and short-lived. A capture that fails raises;
nothing falls back to eager on the card.

**Pipelining.** All of the engine's device work goes to ONE CUDA stream:
a chunk is dispatched, an event recorded behind the copy of its tokens to
the host, and the tokens of the oldest chunk are harvested once more than
``pipeline_depth`` chunks are in flight. The page-recycling argument of
the reference rests on in-order execution and holds because every launch
goes to that one stream: each in-flight chunk that can still write a
retired slot's pages was enqueued before the harvest that freed them, so
it runs before any later prefill that reuses them.

**Sampling.** Per-slot temperature, top-k, EOS id and seed live in device
vectors, so one batch mixes greedy and sampled rows. Greedy rows take the
argmax of the raw logits, as ``generate`` does, so greedy replies equal a
solo ``generate``. Sampled rows use Gumbel-max over ``logits / temp``
(after the row's top-k threshold, gathered from one static
``topk(max_top_k)``) with noise from a counter-based integer hash of the
request's seed, its position and the vocabulary index. So a sampled reply
is reproducible, independent of its batch-mates and token-identical after
preemption, as the reference's ``fold_in(PRNGKey(seed), position)``
streams are; the bits differ from ``jax.random``'s. ``top_k`` above
``max_top_k`` is refused at submit.

**Telemetry**, the reference's: the ``engine="continuous"`` series of the
registry (requests, tokens, chunks, queue wait, TTFT, latency, ITL, slots,
KV pages, prefix hits, prefill chunks, preemptions), a ``request`` span
per request with its :class:`~..telemetry.waterfall.RequestWaterfall`
(the engine's boundary events: compile, prefill steal, compaction,
harvest drain, preemption, pool exhaustion), flight records, the
``kv.blocks_exhausted`` alert events, and the goodput phases ``idle``,
``admit``, ``prefill``, ``decode`` and ``compile``. A new decode bucket's
graph capture and a first-seen prefill or admission shape are charged to
``compile``, like the reference's jit of a new bucket (on the card they
also pay the kernels' first launches). All of it runs on the host, in the
dispatcher's thread, outside any captured region. ``telemetry_host_s``
sums the host time of the harvest's per-row telemetry over
``decode_harvests`` decode-chunk harvests. Each boundary runs inside
``profiler.device_work()``: a profiler session started from another
thread (``/debug/profile``) starts and stops between boundaries, never
during a graph replay.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from serverless_learn_tpu_torch.config import KVCacheConfig, WaterfallConfig
from serverless_learn_tpu_torch.inference import kvcache
from serverless_learn_tpu_torch.inference.batching import (PROMPT_BUCKETS,
                                                           _bucket)
from serverless_learn_tpu_torch.inference.generate import init_cache
from serverless_learn_tpu_torch.inference.kvcache import (BlockPool,
                                                          PrefixTrie,
                                                          pages_for)
from serverless_learn_tpu_torch.models.transformer import Transformer
from serverless_learn_tpu_torch.telemetry import flight, goodput, profiler
from serverless_learn_tpu_torch.telemetry.registry import (RATE_BUCKETS,
                                                           SIZE_BUCKETS, Span,
                                                           get_registry)
from serverless_learn_tpu_torch.telemetry.tracing import (TraceContext,
                                                          node_name)
from serverless_learn_tpu_torch.telemetry.waterfall import (BoundaryEvents,
                                                            RequestWaterfall)


def _wbucket(n: int) -> int:
    """Power-of-FOUR bucket for table-window widths, as the reference's:
    the window changes only the attention span, so coarse buckets trade at
    most 4x masked-out span for fewer buckets (here: fewer CUDA graphs)."""
    b = 1
    while b < n:
        b *= 4
    return b


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a constant m < 2^32,
    exact in int64: the product is formed from 16-bit halves of x, so no
    intermediate reaches 2^63."""
    lo = (x & 0xFFFF) * m
    hi = ((x >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (Wellons' lowbias32) of int64 x in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(seeds: torch.Tensor, positions: torch.Tensor, vocab: int
             ) -> torch.Tensor:
    """[B, V] f32 in (0, 1), a function of (seed, position, vocab index)
    alone: each row's key is hashed from its seed and position, then
    hashed with each vocabulary index."""
    key = _mix32(_mix32(seeds.to(torch.int64) & _M32)
                 ^ (positions.to(torch.int64) & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    bits = _mix32((key[:, None] + _mul32(v + 1, 0x9E3779B9)) & _M32)
    # 23 bits + 0.5 are exact in f32, so u never reaches 0 or 1.
    return ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def sample_slots(logits: torch.Tensor, temp: torch.Tensor,
                 topk: torch.Tensor, seeds: torch.Tensor,
                 positions: torch.Tensor, max_top_k: int) -> torch.Tensor:
    """Per-row sampling, logits [B, V] -> token ids [B] int32.

    Greedy rows (temp == 0) take the argmax of the RAW logits, the op solo
    ``generate`` applies. Sampled rows divide by their own temperature,
    keep only their own top_k (the k-th value gathered from one static
    ``topk(max_top_k)``) and take the Gumbel-max of their own noise."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    l32 = logits.to(torch.float32) / temp.clamp(min=1e-6)[:, None]
    if max_top_k > 0:
        vals = torch.topk(l32, min(max_top_k, l32.shape[-1]), dim=-1).values
        k_idx = (topk.to(torch.int64) - 1).clamp(0, vals.shape[-1] - 1)
        kth = vals.gather(1, k_idx[:, None])
        l32 = torch.where((topk > 0)[:, None] & (l32 < kth),
                          torch.finfo(torch.float32).min, l32)
    gumbel = -torch.log(-torch.log(_uniform(seeds, positions,
                                            l32.shape[-1])))
    sampled = torch.argmax(l32 + gumbel, dim=-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


@dataclass
class _Rows:
    """Per-row decode state on the device: the next token to feed, tokens
    generated so far (the sampling position), done, the sampling vectors
    and the cache index."""

    tok: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    temp: torch.Tensor
    topk: torch.Tensor
    eos: torch.Tensor
    seed: torch.Tensor
    ci: torch.Tensor

    NAMES = ("tok", "pos", "done", "temp", "topk", "eos", "seed", "ci")

    @classmethod
    def empty(cls, n: int, device) -> "_Rows":
        """``n`` free rows: done, no EOS id, greedy."""
        z = lambda dt: torch.zeros(n, dtype=dt, device=device)  # noqa: E731
        return cls(tok=z(torch.int32), pos=z(torch.int32),
                   done=torch.ones(n, dtype=torch.bool, device=device),
                   temp=z(torch.float32), topk=z(torch.int32),
                   eos=torch.full((n,), -1, dtype=torch.int32, device=device),
                   seed=z(torch.int64), ci=z(torch.int32))

    def head(self, n: int) -> "_Rows":
        """The first ``n`` rows, as views."""
        return _Rows(**{k: getattr(self, k)[:n] for k in self.NAMES})


def _decode_step(model: Transformer, cache, s, max_top_k: int
                 ) -> torch.Tensor:
    """One decode step of the rows of ``s`` (a :class:`_Rows` or views of
    one) over ``cache``, in place: feed ``s.tok``, sample the next tokens
    at ``s.pos``. A finished row keeps emitting its EOS id (0 without
    one), as ``generate`` fills."""
    logits = model(s.tok[:, None], cache=cache, decode=True)[:, 0]
    nxt = sample_slots(logits, s.temp, s.topk, s.seed, s.pos, max_top_k)
    nxt = torch.where(s.done, s.eos.clamp(min=0), nxt)
    s.done |= (s.eos >= 0) & (nxt == s.eos)
    s.tok.copy_(nxt)
    s.pos += 1
    return nxt


class _DecodeChunk:
    """The paged decode chunk of one (nb, W) bucket: static buffers, the
    one-step function over them, and on the card its CUDA graph."""

    def __init__(self, engine: "ContinuousBatchingEngine", nb: int, W: int):
        dev = engine.device
        self.engine = engine
        self.rows = _Rows.empty(nb, dev)
        self.table = torch.full((nb, W), engine._pool.sentinel,
                                dtype=torch.int32, device=dev)
        self.out = torch.zeros((nb, engine.chunk_size), dtype=torch.int32,
                               device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0

    def step_fn(self):
        eng, s = self.engine, self.rows
        cache = eng._pages.with_tables(self.table, s.ci)
        nxt = _decode_step(eng.model, cache, s, eng.max_top_k)
        s.ci.copy_(cache.index)
        self.out.index_copy_(1, self.step, nxt[:, None])
        self.step += 1

    def run(self, graph: bool):
        """``chunk_size`` steps: replays of the captured step, or eager."""
        self.step.zero_()
        for _ in range(self.engine.chunk_size):
            if graph:
                self.graph.replay()
                self.replays += 1
                self.engine.graph_replays += 1
            else:
                self.step_fn()


@dataclass
class _Request:
    prompt: np.ndarray  # compact int32 array, built ONCE at submit()
    max_new: int
    temperature: float
    top_k: int
    eos_id: Optional[int]
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    admitted: bool = False  # False: still queued; True: owns a slot
    peak_batch: int = 1  # live slots alongside this request (stats)
    # Set by submit() on timeout: the caller is gone, so the scheduler
    # retires the slot (or drops the queue entry) at the next boundary.
    cancelled: bool = False
    # ---- paged-mode scheduling state ----
    prefilling: bool = False   # mid chunked prefill (not yet decodable)
    prefill_pos: int = 0       # prompt tokens written (incl. shared prefix)
    chunks_dispatched: int = 0  # decode chunks launched for this residency
    admit_seq: int = 0         # admission order (preemption picks youngest)
    gen: int = 0               # residency epoch; preemption voids in-flight
    #                            chunks of the old epoch
    span: Optional[Span] = None  # request trace: submit/admit/first/done
    wf: Optional[RequestWaterfall] = None  # per-request waterfall ledger
    preempt_t: float = 0.0     # perf_counter of the last preemption


class ContinuousBatchingEngine:
    """Owns the model; persistent chunked decode over a slot pool."""

    def __init__(self, model: Transformer, max_slots: int = 8,
                 chunk_size: int = 32, pipeline_depth: int = 2,
                 max_top_k: int = 64, kv: Optional[KVCacheConfig] = None,
                 registry=None, event_log=None,
                 waterfall: Optional[WaterfallConfig] = None):
        self.model = model
        self.device = model.device
        self._cuda = self.device.type == "cuda"
        self.max_slots = max_slots
        self.chunk_size = chunk_size
        self.pipeline_depth = max(1, pipeline_depth)
        self.max_top_k = max_top_k
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # Device work happens under this lock: the dispatcher holds it for
        # each boundary, warm_shapes() for its captures.
        self._lock = threading.RLock()
        # Host-side slot table: index -> live _Request (None = free).
        self._slots: List[Optional[_Request]] = [None] * max_slots
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            # Graphs are captured on a stream of their own, on which no
            # other work runs (see _capture).
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()

        # ---- paged KV pool ----
        self.kv = kv
        self._paged = bool(kv is not None and kv.paged)
        max_seq = model.cfg.max_seq_len
        if self._paged:
            ps = kv.block_size
            self._ps = ps
            self._max_pages = pages_for(max_seq, ps)
            num_blocks = kv.num_blocks or (
                max_slots * self._max_pages
                + (self._max_pages if kv.prefix_cache else 0))
            if num_blocks < self._max_pages:
                raise ValueError(
                    f"kv.num_blocks ({num_blocks}) cannot hold one "
                    f"max-length sequence ({self._max_pages} blocks of "
                    f"{ps}); the engine could deadlock")
            self._pool = BlockPool(num_blocks, ps)
            self._trie = (PrefixTrie(
                self._pool,
                max_blocks=kv.prefix_cache_blocks or num_blocks // 4,
                hit_window=kv.prefix_hit_window)
                if kv.prefix_cache else None)
            self.prefill_chunk = kv.prefill_chunk or max_seq
            self.prefill_budget = max(kv.prefill_budget, self.prefill_chunk)
            # Host-owned block tables: [max_slots, max_pages] page ids,
            # sentinel (== num_blocks) marking unallocated entries.
            self._tbl = np.full((max_slots, self._max_pages),
                                self._pool.sentinel, np.int32)
            self._slot_pages: List[List[int]] = [[] for _ in
                                                 range(max_slots)]
            self._pending_cow: Dict[int, tuple] = {}
            self._chunks: Dict[tuple, _DecodeChunk] = {}
        self._init_state()
        self.chunks_run = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.prefill_chunks_run = 0
        # Decode row accounting: rows that still owed tokens at dispatch,
        # and rows of compute paid (paged: the compacted nb bucket;
        # monolithic: all max_slots rows every chunk).
        self.decoded_rows_total = 0
        self.dispatched_rows_total = 0
        self.preemptions = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self._admit_counter = 0
        # warm() raises this so a known batch size admits as ONE bucket;
        # 1 in normal service.
        self._min_admit = 1
        self._init_telemetry(registry, event_log, waterfall)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    def _init_telemetry(self, registry, event_log, waterfall):
        self.event_log = event_log
        self.waterfall = waterfall if waterfall is not None \
            else WaterfallConfig()
        self._wf_events = BoundaryEvents(window=self.waterfall.events_window)
        self._wf_stall_m: Dict[str, object] = {}  # cause -> counter child
        self._wf_decode_total = 0.0  # decode wall across finished requests
        self._wf_steal_total = 0.0   # prefill_steal stall across the same
        self._last_decode_rows: tuple = ()  # compaction detection
        self._kv_alert_firing = False
        self._last_kv_alert = 0.0
        # Shapes run before: a first-seen one is charged to "compile".
        self._admit_shapes: set = set()
        self._prefill_shapes: set = set()
        self.telemetry_host_s = 0.0
        self.decode_harvests = 0
        reg = registry or get_registry()
        self.registry = reg
        lbl = {"engine": "continuous"}
        self._m_requests = reg.counter(
            "slt_requests_total", "requests accepted by the engine", **lbl)
        self._m_finished = reg.counter("slt_requests_finished_total", **lbl)
        self._m_cancelled = reg.counter(
            "slt_requests_cancelled_total",
            "submit() timeouts whose slot/queue entry was retired", **lbl)
        self._m_tokens = reg.counter(
            "slt_decode_tokens_total", "tokens returned to callers", **lbl)
        self._m_chunks = reg.counter("slt_decode_chunks_total", **lbl)
        self._m_qwait = reg.histogram(
            "slt_request_queue_wait_seconds", "submit -> slot admission",
            **lbl)
        self._m_ttft = reg.histogram(
            "slt_request_ttft_seconds", "submit -> first token on host",
            **lbl)
        self._m_latency = reg.histogram(
            "slt_request_latency_seconds", "submit -> final token", **lbl)
        self._m_per_tok = reg.histogram(
            "slt_decode_seconds_per_token",
            "per-token decode time after the first token", **lbl)
        self._m_admit_sz = reg.histogram(
            "slt_admit_batch_size", "requests per admit boundary",
            buckets=SIZE_BUCKETS, **lbl)
        self._m_tps = reg.histogram(
            "slt_request_tokens_per_sec", buckets=RATE_BUCKETS, **lbl)
        self._m_slots = reg.gauge(
            "slt_slots_in_use", "occupied decode slots", **lbl)
        self._m_prompt_tokens = reg.histogram(
            "slt_request_prompt_tokens",
            "prompt length per accepted request (the prefix-hit-rate "
            "denominator)", buckets=PROMPT_BUCKETS, **lbl)
        self._m_kv_total = reg.gauge(
            "slt_kv_blocks_total", "KV pool size in blocks", **lbl)
        self._m_kv_in_use = reg.gauge(
            "slt_kv_blocks_in_use", "allocated KV pool blocks", **lbl)
        self._m_kv_hits = reg.counter(
            "slt_kv_prefix_hits_total",
            "admissions that reused shared prefix blocks", **lbl)
        self._m_kv_hit_tokens = reg.counter(
            "slt_kv_prefix_tokens_total",
            "prompt tokens skipped via shared prefix blocks", **lbl)
        self._m_prefill_chunks = reg.counter(
            "slt_prefill_chunks_total",
            "prefill chunks interleaved between decode boundaries", **lbl)
        self._m_kv_blocked = reg.counter(
            "slt_kv_admit_blocked_total",
            "admission/prefill boundaries deferred on pool exhaustion",
            **lbl)
        self._m_preempt = reg.counter(
            "slt_kv_preemptions_total",
            "slots preempted to free KV blocks (deterministic restart)",
            **lbl)
        if self._paged:
            self._m_kv_total.set(self._pool.num_blocks)
            self._m_kv_in_use.set(0)
        self._m_itl = reg.histogram(
            "slt_decode_itl_seconds",
            "inter-token latency from the per-request decode trace", **lbl)
        self._m_prefill_interf = reg.gauge(
            "slt_prefill_interference_frac",
            "fraction of decode wall-clock stalled by interleaved prefill "
            "(waterfall prefill_steal attribution)", **lbl)
        # The dispatcher's liveness stamp for the health engine.
        self._m_activity = reg.gauge(
            "slt_engine_last_activity_unix_s",
            "wall time of the dispatcher's last admit/chunk", **lbl)

    # -- device state ------------------------------------------------------

    def _init_state(self):
        """Per-slot rows (plus a scratch row at index max_slots, which pad
        rows read and write) and the KV pool or the monolithic rows."""
        cfg, M = self.model.cfg, self.max_slots
        with self._on_stream():
            self._rows = _Rows.empty(M + 1, self.device)
            if self._paged:
                self._pages = kvcache.paged_cache(
                    cfg.n_layers, self._pool.num_blocks, self._ps,
                    cfg.kv_heads, cfg.head_dim, cfg.dtype, self.device,
                    np.full((1, 1), self._pool.sentinel, np.int32))
                self._chunks = {}
            else:
                self._mono = init_cache(self.model, M)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._cuda
                else contextlib.nullcontext())

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._cuda:
            # From pinned memory, so the copy is queued behind the
            # stream's work instead of waiting for it.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_host(self, t: torch.Tensor):
        """(host tensor, event): a copy of ``t`` queued on the engine's
        stream, ready once the event has completed (None: ready now)."""
        if not self._cuda:
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _set_rows(self, ids: torch.Tensor, **values):
        for name, val in values.items():
            getattr(self._rows, name)[ids] = val

    # -- paged decode chunks -------------------------------------------------

    def _chunk(self, nb: int, W: int) -> _DecodeChunk:
        """The (nb, W) bucket's decode chunk; captured on first use on the
        card."""
        key = (nb, W)
        chunk = self._chunks.get(key)
        if chunk is None:
            chunk = _DecodeChunk(self, nb, W)
            if self._cuda:
                self._capture(chunk)
            self._chunks[key] = chunk
        return chunk

    def _capture(self, chunk: _DecodeChunk):
        """Capture one decode step of ``chunk`` into a CUDA graph.

        Its static table is all sentinel until the engine fills it, so the
        warm-up step before the capture writes only the scratch page.

        The int8 matmul (``ops/quant_matmul.py``) keeps one split
        workspace per (device, stream), and a captured launch binds the
        workspace of the stream it was captured on: here the engine's
        capture stream, for every graph. Nothing else runs on that stream
        but these warm-ups and captures, which wait for all the work on
        the engine's stream first and which the engine's stream waits for
        after; every replay runs on the engine's stream, in order. So no
        eager call writes that workspace while a replay runs, and two
        replays never overlap. The engine's eager calls (prefill) use the
        engine stream's own workspace."""
        main = torch.cuda.current_stream(self.device)
        cap = self._capture_stream
        cap.wait_stream(main)
        with torch.cuda.stream(cap):
            chunk.step.zero_()
            chunk.step_fn()  # warm-up: cuBLAS and the workspace set up
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                chunk.step_fn()
            except BaseException:
                try:  # end the broken capture; the step's error is raised
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        main.wait_stream(cap)
        chunk.graph = graph
        self.graph_captures += 1

    # -- client side -------------------------------------------------------

    def submit(self, prompt, max_new: int, temperature: float, top_k: int,
               eos_id: Optional[int], seed: int,
               timeout_s: float = 600.0,
               trace: Optional[TraceContext] = None) -> dict:
        """Blocks until the dispatcher finishes this request; returns
        {"new_tokens": [...], "batch_size": n} or {"error": ...}, the
        static engine's contract. ``trace``: the caller's trace context,
        which the request span chains under."""
        max_seq = self.model.cfg.max_seq_len
        if len(prompt) == 0:
            return {"error": "prompt must contain at least one token"}
        if max_new <= 0:
            return {"new_tokens": [], "batch_size": 0}
        if len(prompt) + max_new > max_seq:
            return {"error": f"prompt ({len(prompt)}) + max_new_tokens "
                             f"({max_new}) exceeds max_seq_len {max_seq}"}
        if top_k > self.max_top_k:
            return {"error": f"top_k ({top_k}) exceeds this engine's "
                             f"max_top_k ({self.max_top_k})"}
        r = _Request(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                     temperature=float(temperature), top_k=int(top_k),
                     eos_id=eos_id, seed=int(seed))
        r.span = (Span("request", trace_id=trace.trace_id,
                       parent_id=trace.span_id)
                  if trace is not None else Span("request"))
        r.wf = self._new_waterfall()
        self._m_requests.inc()
        self._m_prompt_tokens.observe(len(prompt))
        self._q.put(r)
        if not r.done.wait(timeout_s):
            # The caller is gone: the dispatcher retires the slot (or the
            # queue entry) at the next boundary.
            r.cancelled = True
            where = ("mid-decode" if r.admitted
                     else "in the admission queue")
            return {"error": f"generation timed out {where}"}
        return r.result

    # -- dispatcher --------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _emit_span(self, span) -> None:
        """Span record -> the JSONL event log (node-stamped) and the
        flight ring."""
        rec = span.to_event()
        rec.setdefault("node", node_name())
        if self.event_log is not None:
            self.event_log.emit(rec)
        flight.record(rec)

    def _emit_event(self, rec: dict) -> None:
        rec.setdefault("node", node_name())
        if self.event_log is not None:
            self.event_log.emit(rec)
        flight.record(rec)

    def _new_waterfall(self) -> Optional[RequestWaterfall]:
        if not self.waterfall.enabled:
            return None
        w = self.waterfall
        return RequestWaterfall(
            engine="continuous", ewma_alpha=w.ewma_alpha,
            stall_mult=w.stall_mult, min_stall_s=w.min_stall_s,
            max_stall_events=w.max_stall_events,
            max_gap_samples=w.max_gap_samples)

    def _stall_counter(self, cause: str):
        c = self._wf_stall_m.get(cause)
        if c is None:
            c = self.registry.counter(
                "slt_decode_stall_seconds_total",
                "decode stall seconds by attributed boundary-event cause",
                cause=cause, engine="continuous")
            self._wf_stall_m[cause] = c
        return c

    def _cancel(self, r: _Request):
        """Retire an abandoned request: its submitter already returned."""
        r.finished = True
        r.result = {"error": "cancelled after submit timeout"}
        self.requests_cancelled += 1
        self._m_cancelled.inc()
        if r.span is not None:
            r.span.mark("cancelled")
            self._emit_span(r.span)

    def _drop_cancelled(self, staged: List[_Request]) -> None:
        keep = []
        for r in staged:
            if r.cancelled and not r.finished:
                self._cancel(r)
            elif not r.finished:
                keep.append(r)
        staged[:] = keep

    def _note_admitted(self, r: _Request, sid: int):
        r.admitted = True
        r.admit_seq = self._admit_counter
        self._admit_counter += 1
        self._slots[sid] = r
        if r.wf is not None and r.preempt_t > 0.0:
            # Close this request's preempt -> re-admission window: its next
            # decode gap attributes to "preempt" through it.
            r.wf.note_event("preempt", r.preempt_t, time.perf_counter())
            r.preempt_t = 0.0
        if r.span is not None:
            r.span.mark("admit")
            wait = r.span.between(None, "admit")
            if wait is not None:
                self._m_qwait.observe(wait)

    def _post_admit_stats(self, n: int):
        self.requests_admitted += n
        self._m_admit_sz.observe(n)
        live = self.max_slots - len(self._free_slots())
        self._m_slots.set(live)
        for r in self._slots:
            if r is not None:
                r.peak_batch = max(r.peak_batch, live)

    @staticmethod
    def _sampling(batch: List[_Request], nb: int):
        temp = np.zeros((nb,), np.float32)
        topk = np.zeros((nb,), np.int32)
        eos = np.full((nb,), -1, np.int32)
        seed = np.zeros((nb,), np.int64)
        for i, r in enumerate(batch):
            temp[i] = r.temperature
            topk[i] = r.top_k
            eos[i] = -1 if r.eos_id is None else r.eos_id
            seed[i] = r.seed & 0xFFFFFFFF
        return temp, topk, eos, seed

    # ---- monolithic admission (the equivalence baseline) ----

    def _admit(self, staged: List[_Request]) -> Optional[tuple]:
        """Batched prefill of new prompts in a compacted [nb, pb] shape on
        a fresh cache, each row's FIRST token sampled from its own last
        real position, then the cache rows and slot state copied in."""
        self._drop_cancelled(staged)
        free = self._free_slots()
        n = min(len(free), len(staged))
        if n < max(1, min(self._min_admit, self.max_slots)):
            return None
        batch = [staged.pop(0) for _ in range(n)]
        ids = free[:n]
        nb = _bucket(n, floor=1)
        pb = min(_bucket(max(len(r.prompt) for r in batch)),
                 self.model.cfg.max_seq_len)
        prompts = np.zeros((nb, pb), np.int32)
        lengths = np.ones((nb,), np.int32)
        for i, r in enumerate(batch):
            prompts[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
            self._note_admitted(r, ids[i])
        self._post_admit_stats(n)
        new_shape = (nb, pb) not in self._admit_shapes
        self._admit_shapes.add((nb, pb))
        t_j0 = time.perf_counter()
        with goodput.phase("compile" if new_shape else "admit"):
            temp, topk, eos, seed = (self._to_dev(a)
                                     for a in self._sampling(batch, nb))
            lens = self._to_dev(lengths)
            small = init_cache(self.model, nb)
            logits = self.model(self._to_dev(prompts), cache=small,
                                prefill=True, seq_lengths=lens)
            last = logits[torch.arange(nb, device=self.device),
                          lens.long() - 1]
            tok0 = sample_slots(last, temp, topk, seed,
                                torch.zeros_like(lens), self.max_top_k)
            sid = self._to_dev(np.asarray(ids, np.int64))
            for big, new in zip(self._mono.k + self._mono.v,
                                small.k + small.v):
                big[sid] = new[:n]
            self._mono.index[sid] = small.index[:n]
            self._set_rows(sid, tok=tok0[:n], pos=1,
                           done=((eos >= 0) & (tok0 == eos))[:n],
                           temp=temp[:n], topk=topk[:n], eos=eos[:n],
                           seed=seed[:n])
        if new_shape:
            t_j1 = time.perf_counter()
            self._wf_events.note("compile", t_j0, t_j1)
            for r in batch:
                if r.wf is not None:
                    r.wf.note_compile(t_j0, t_j1)
        host, ev = self._to_host(tok0)
        # The admit's first tokens harvest like a 1-token chunk, in order.
        return ("admit", host, ev, [(ids[i], batch[i]) for i in range(n)])

    def _mono_chunk(self) -> torch.Tensor:
        """``chunk_size`` decode steps of all ``max_slots`` rows, eagerly;
        -> [max_slots, chunk_size] tokens."""
        rows = self._rows.head(self.max_slots)
        out = [_decode_step(self.model, self._mono, rows, self.max_top_k)
               for _ in range(self.chunk_size)]
        return torch.stack(out, dim=1)

    # ---- paged allocation helpers ----

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate, evicting cached prefixes under pressure; None when
        the pool genuinely cannot satisfy it (typed backpressure)."""
        try:
            return self._pool.alloc(n)
        except kvcache.KVBlocksExhausted:
            if self._trie is not None and self._trie.blocks_held:
                self._trie.release(n)
                try:
                    return self._pool.alloc(n)
                except kvcache.KVBlocksExhausted:
                    return None
            return None

    def _ensure_pages(self, sid: int, n_tokens: int) -> bool:
        need = pages_for(n_tokens, self._ps) - len(self._slot_pages[sid])
        if need <= 0:
            return True
        got = self._try_alloc(need)
        if got is None:
            return False
        base = len(self._slot_pages[sid])
        for j, b in enumerate(got):
            self._tbl[sid, base + j] = b
        self._slot_pages[sid].extend(got)
        return True

    def _retire_slot(self, sid: int):
        pages = self._slot_pages[sid]
        if pages:
            self._pool.decref(pages)
        self._slot_pages[sid] = []
        self._tbl[sid, :] = self._pool.sentinel
        self._pending_cow.pop(sid, None)
        self._slots[sid] = None

    def _note_kv_blocked(self):
        """Pool exhaustion is admission backpressure: counted, and emitted
        as a rate-limited alert event of the health engine's shape."""
        self._m_kv_blocked.inc()
        self._wf_events.note("kv_exhausted", time.perf_counter())
        now = time.time()
        if self._kv_alert_firing and now - self._last_kv_alert < 5.0:
            return
        self._kv_alert_firing = True
        self._last_kv_alert = now
        free, total = self._pool.free_blocks, self._pool.num_blocks
        self._emit_event({
            "event": "alert", "alert": "kv.blocks_exhausted",
            "severity": "warning", "detector": "kvcache",
            "state": "firing",
            "message": f"KV block pool exhausted ({free}/{total} free): "
                       f"admissions deferred (backpressure)",
            "labels": {"engine": "continuous"},
            "value": free / max(total, 1), "threshold": 0.0, "count": 1,
            "first_fired_unix_s": round(now, 3),
            "last_fired_unix_s": round(now, 3)})

    def _maybe_resolve_kv_alert(self):
        if not self._kv_alert_firing:
            return
        free, total = self._pool.free_blocks, self._pool.num_blocks
        if free / max(total, 1) < 0.25:
            return
        self._kv_alert_firing = False
        now = time.time()
        self._emit_event({
            "event": "alert", "alert": "kv.blocks_exhausted",
            "severity": "warning", "detector": "kvcache",
            "state": "resolved",
            "message": f"KV pool pressure cleared ({free}/{total} free)",
            "labels": {"engine": "continuous"},
            "value": free / max(total, 1), "threshold": 0.0, "count": 1,
            "first_fired_unix_s": round(self._last_kv_alert, 3),
            "last_fired_unix_s": round(now, 3)})

    def _preempt_candidate(self, exclude: int) -> Optional[int]:
        """Youngest occupied slot (never the oldest: someone must finish),
        excluding ``exclude``."""
        occupied = [(r.admit_seq, i) for i, r in enumerate(self._slots)
                    if r is not None and not r.finished and i != exclude]
        if len(occupied) < 1:
            return None
        occupied.sort()
        all_occ = [(r.admit_seq, i) for i, r in enumerate(self._slots)
                   if r is not None and not r.finished]
        oldest = min(all_occ)[1] if all_occ else None
        seq, sid = occupied[-1]
        if sid == oldest:
            return None
        return sid

    def _preempt(self, sid: int, staged: List[_Request]):
        """Free a slot's pages and requeue its request at the FRONT. The
        restart is token-identical: a token depends only on the request's
        own seed and position."""
        r = self._slots[sid]
        self._retire_slot(sid)
        r.admitted = False
        r.prefilling = False
        r.prefill_pos = 0
        r.chunks_dispatched = 0
        r.tokens = []
        r.gen += 1  # in-flight chunks of the old residency are void
        r.preempt_t = time.perf_counter()
        # A marker for every in-flight decode trace: a preemption pauses
        # the whole boundary, not just the victim.
        self._wf_events.note("preempt", r.preempt_t)
        if r.span is not None:
            r.span.mark("preempt")
        staged.insert(0, r)
        self.preemptions += 1
        self._m_preempt.inc()

    # ---- paged admission + prefill + decode ----

    def _admit_paged(self, staged: List[_Request]) -> bool:
        self._drop_cancelled(staged)
        free = self._free_slots()
        n = min(len(free), len(staged))
        if n < max(1, min(self._min_admit, self.max_slots)):
            return False
        ps = self._ps
        admitted = 0
        for _ in range(n):
            r = staged[0]
            sid = free[admitted]
            t_a0 = time.perf_counter()
            L = len(r.prompt)
            pos0, shared, donor = 0, [], None
            if self._trie is not None:
                hit = self._trie.lookup(r.prompt)
                extra = hit.cow_tokens if hit.cow_src is not None else 0
                # Never skip the LAST prompt token: its logits seed the
                # first sampled token, so it is recomputed (its K/V rewrite
                # lands in an owned or COW page with identical values).
                skip = min(hit.tokens_matched + extra, L - 1)
                n_shared = skip // ps
                r0 = skip - n_shared * ps
                shared = hit.blocks[:n_shared]
                if r0 > 0:
                    donor = (hit.blocks[n_shared]
                             if n_shared < len(hit.blocks)
                             else hit.cow_src)
                pos0 = skip
            tk = min(L - pos0, self.prefill_chunk)
            fresh = pages_for(pos0 + tk, ps) - len(shared)
            got = self._try_alloc(fresh)
            if got is None:
                # FIFO backpressure: nothing behind this request admits
                # either; it stays queued and retries next boundary.
                self._note_kv_blocked()
                break
            self._pool.incref(shared)
            pages = list(shared) + got
            self._slot_pages[sid] = pages
            self._tbl[sid, :] = self._pool.sentinel
            self._tbl[sid, :len(pages)] = pages
            if donor is not None:
                # COW: the first fresh page (block index n_shared) gets a
                # device-side copy of the donor before the prefill
                # overwrites it from the divergent offset.
                self._pending_cow[sid] = (donor, got[0])
            staged.pop(0)
            r.prefilling = True
            r.prefill_pos = pos0
            if r.wf is not None:
                # Host-side admission work: trie lookup and page alloc.
                r.wf.note_admit(t_a0, time.perf_counter())
            self._note_admitted(r, sid)
            if pos0 > 0:
                self._m_kv_hits.inc()
                self._m_kv_hit_tokens.inc(pos0)
            admitted += 1
        if admitted:
            self._post_admit_stats(admitted)
        return admitted > 0

    def _prefill_step(self, staged: List[_Request]) -> Optional[tuple]:
        """Advance mid-prefill slots by up to ``prefill_chunk`` tokens
        each, at most ``prefill_budget`` a boundary (FIFO): a long prompt
        does not stall the decode batch."""
        rows = []
        for sid, r in enumerate(self._slots):
            if r is None or not r.prefilling or r.finished:
                continue
            if r.cancelled:
                self._cancel(r)
                self._retire_slot(sid)
                continue
            rows.append((sid, r))
        if not rows:
            return None
        rows.sort(key=lambda sr: sr[1].admit_seq)  # FIFO budget
        budget = self.prefill_budget
        batch = []
        for sid, r in rows:
            rem = len(r.prompt) - r.prefill_pos
            tk = min(rem, self.prefill_chunk)
            if batch and tk > budget:
                break
            if not self._ensure_pages(sid, r.prefill_pos + tk):
                self._note_kv_blocked()
                continue
            budget -= tk
            batch.append((sid, r, tk))
        if not batch:
            return None
        M = self.max_slots
        nb = _bucket(len(batch), floor=1)
        T = min(_bucket(max(tk for _, _, tk in batch), floor=8),
                _bucket(self.prefill_chunk, floor=1))
        W = min(_wbucket(max(len(self._slot_pages[sid])
                             for sid, _, _ in batch)), self._max_pages)
        toks = np.zeros((nb, T), np.int32)
        lens = np.zeros((nb,), np.int32)
        ci0 = np.zeros((nb,), np.int32)
        slot_ids = np.full((nb,), M, np.int64)  # pad rows: the scratch row
        fin = np.zeros((nb,), bool)
        cows = []
        tbl_rows = np.full((nb, W), self._pool.sentinel, np.int32)
        for i, (sid, r, tk) in enumerate(batch):
            toks[i, :tk] = r.prompt[r.prefill_pos:r.prefill_pos + tk]
            lens[i] = tk
            ci0[i] = r.prefill_pos
            slot_ids[i] = sid
            fin[i] = (r.prefill_pos + tk == len(r.prompt))
            cow = self._pending_cow.pop(sid, None)
            if cow is not None:
                cows.append(cow)
            tbl_rows[i] = self._tbl[sid, :W]
        new_shape = (nb, T, W) not in self._prefill_shapes
        self._prefill_shapes.add((nb, T, W))
        t_j0 = time.perf_counter()
        with goodput.phase("compile" if new_shape else "prefill"):
            temp, topk, eos, seed = (self._to_dev(a) for a in self._sampling(
                [r for _, r, _ in batch], nb))
            pages = self._pages
            if cows:
                # COW: copy each donor page before the extend overwrites
                # its copy from the divergent offset.
                src, dst = (self._to_dev(np.asarray(c, np.int64))
                            for c in zip(*cows))
                for p in pages.pages_k + pages.pages_v:
                    p[dst] = p[src]
            lens_t = self._to_dev(lens)
            cache = pages.with_tables(self._to_dev(tbl_rows),
                                      self._to_dev(ci0))
            logits = self.model(self._to_dev(toks), cache=cache, extend=True,
                                seq_lengths=lens_t)
            last = logits[torch.arange(nb, device=self.device),
                          (lens_t.long() - 1).clamp(min=0)]
            tok0 = sample_slots(last, temp, topk, seed,
                                torch.zeros_like(lens_t), self.max_top_k)
            # Only rows that FINISHED their prompt become decodable; the
            # rest write the scratch row.
            sid_t = self._to_dev(slot_ids)
            fin_ids = torch.where(self._to_dev(fin), sid_t, M)
            self._set_rows(fin_ids, tok=tok0, pos=1,
                           done=(eos >= 0) & (tok0 == eos), temp=temp,
                           topk=topk, eos=eos, seed=seed)
            self._set_rows(sid_t, ci=cache.index)
        t_j1 = time.perf_counter()
        # In-flight decode traces see this window as a prefill steal, or a
        # first-seen shape's compile (an interval: it holds the
        # dispatcher). A warm chunk is a 0-width marker: the calls above
        # only queue the work, which lands inside the victims' gap.
        if new_shape:
            self._wf_events.note("compile", t_j0, t_j1)
        else:
            self._wf_events.note("prefill_steal", t_j0)
        snapshot = []
        for i, (sid, r, tk) in enumerate(batch):
            if r.wf is not None:
                # The first chunk starts at the prefix-cache hit position.
                hit = r.prefill_pos if not r.wf.prefill_chunks else 0
                r.wf.note_prefill_chunk(t_j0, t_j1, int(tk),
                                        prefix_hit_tokens=hit,
                                        compiled=new_shape)
                if new_shape:
                    r.wf.note_compile(t_j0, t_j1)
            r.prefill_pos += tk
            if fin[i]:
                r.prefilling = False
                if self._trie is not None and len(r.prompt) >= self._ps:
                    # Publish the prompt's FULL blocks (their K/V are now
                    # written); the boundary partial block stays private,
                    # so prefix pages are never rewritten.
                    n_full = len(r.prompt) // self._ps
                    self._trie.register(r.prompt,
                                        self._slot_pages[sid][:n_full])
            snapshot.append((sid, r, bool(fin[i]), r.gen))
        self.prefill_chunks_run += len(batch)
        self._m_prefill_chunks.inc(len(batch))
        host, ev = self._to_host(tok0)
        return ("prefill", host, ev, snapshot)

    def _decode_step_paged(self, staged: List[_Request]) -> Optional[tuple]:
        live = [sid for sid, r in enumerate(self._slots)
                if r is not None and not r.finished and not r.prefilling]
        if not live:
            return None
        C = self.chunk_size
        rows = []
        for sid in live:
            r = self._slots[sid]
            if r is None or r.finished or r.prefilling:
                continue  # a preemption below may have evicted this row
            # Pages for the next C tokens, capped at the request budget:
            # overshoot past the allocation goes to the scratch page (a
            # finished row's EOS filler must not clobber pages).
            dispatched = len(r.prompt) + r.chunks_dispatched * C
            needed = min(dispatched + C, len(r.prompt) + r.max_new)
            while not self._ensure_pages(sid, needed):
                victim = self._preempt_candidate(exclude=sid)
                if victim is None:
                    break
                self._preempt(victim, staged)
            if self._ensure_pages(sid, needed):
                rows.append(sid)
            else:
                self._note_kv_blocked()
        # Preemption may have evicted rows already collected.
        rows = [sid for sid in rows if self._slots[sid] is not None
                and not self._slots[sid].prefilling]
        if not rows:
            return None
        M = self.max_slots
        nb = _bucket(len(rows), floor=1)
        W = min(_wbucket(max(len(self._slot_pages[sid]) for sid in rows)),
                self._max_pages)
        live_arr = np.full((nb,), M, np.int64)  # pad rows: the scratch row
        live_arr[:len(rows)] = rows
        tbl_rows = np.full((nb, W), self._pool.sentinel, np.int32)
        for j, sid in enumerate(rows):
            tbl_rows[j] = self._tbl[sid, :W]
        new_bucket = (nb, W) not in self._chunks
        rows_now = tuple(rows)
        if self._last_decode_rows and rows_now != self._last_decode_rows \
                and not new_bucket:
            # The live batch re-packed (retire, preempt or admit changed
            # the rows): "compaction" on in-flight decode traces. A new
            # bucket is charged as compile instead.
            self._wf_events.note("compaction", time.perf_counter())
        self._last_decode_rows = rows_now
        t_j0 = time.perf_counter()
        with goodput.phase("compile" if new_bucket else "decode"):
            chunk = self._chunk(nb, W)  # a new bucket's graph is captured
            ids = self._to_dev(live_arr)
            for name in _Rows.NAMES:
                getattr(chunk.rows, name).copy_(
                    getattr(self._rows, name)[ids])
            chunk.table.copy_(self._to_dev(tbl_rows))
            chunk.run(graph=self._cuda)
            self._set_rows(ids, **{name: getattr(chunk.rows, name)
                                   for name in ("tok", "pos", "done",
                                                "ci")})
        if new_bucket:
            self._wf_events.note("compile", t_j0, time.perf_counter())
        self.chunks_run += 1
        self._m_chunks.inc()
        self.decoded_rows_total += len(rows)
        self.dispatched_rows_total += nb
        snapshot = []
        for sid in rows:
            r = self._slots[sid]
            r.chunks_dispatched += 1
            snapshot.append((sid, r, r.gen))
        host, ev = self._to_host(chunk.out)
        return ("pchunk", host, ev, snapshot)

    # -- harvest -----------------------------------------------------------

    def _harvest(self, fut) -> None:
        kind, host, ev, snapshot = fut
        t_h0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        t_now = time.perf_counter()
        if t_now - t_h0 > 1e-4:
            # The dispatcher sat blocked here: tokens of later in-flight
            # chunks stall behind it (harvest drain).
            self._wf_events.note("harvest_drain", t_h0, t_now)
        if kind in ("pchunk", "chunk"):
            self.decode_harvests += 1
        tel_s = 0.0
        arr = host.numpy()
        if kind == "admit":
            arr = arr[:, None]  # [nb] -> [nb, 1], rows indexed by snapshot
            pairs = [(sid, r, arr[i]) for i, (sid, r)
                     in enumerate(snapshot)]
        elif kind == "prefill":
            # Only rows whose prompt COMPLETED carry a first token; rows
            # mid-prefill (or preempted since dispatch) yield nothing.
            arr = arr[:, None]
            pairs = [(sid, r, arr[i]) for i, (sid, r, fin, gen)
                     in enumerate(snapshot) if fin and r.gen == gen]
        elif kind == "pchunk":
            pairs = [(sid, r, arr[j]) for j, (sid, r, gen)
                     in enumerate(snapshot) if r.gen == gen]
        else:  # "chunk": monolithic full-width rows, indexed by slot id
            pairs = [(sid, r, arr[sid]) for sid, r in snapshot]
        for sid, r, row in pairs:
            if r.finished:
                continue  # tokens from a chunk dispatched before retirement
            if r.cancelled:
                self._cancel(r)
                if self._slots[sid] is r:
                    if self._paged:
                        self._retire_slot(sid)
                    else:
                        self._slots[sid] = None
                continue
            t_t0 = time.perf_counter()
            first = r.span is not None \
                and "first_token" not in r.span.marks
            if first:
                r.span.mark("first_token")
                ttft = r.span.between(None, "first_token")
                if ttft is not None:
                    self._m_ttft.observe(ttft)
            tel_s += time.perf_counter() - t_t0
            n_before = len(r.tokens)
            for t in row:
                r.tokens.append(int(t))
                if len(r.tokens) >= r.max_new:
                    break
            t_t0 = time.perf_counter()
            if r.wf is not None:
                if first:
                    # Tokens delivered with the first share its arrival;
                    # the decode trace starts here.
                    r.wf.first_token(t_now)
                else:
                    out = r.wf.note_decode(t_now, len(r.tokens) - n_before,
                                           self._wf_events)
                    if out is not None:
                        itl_s, causes = out
                        for _ in range(len(r.tokens) - n_before):
                            self._m_itl.observe(itl_s)
                        if causes:
                            for cause, v in causes.items():
                                self._stall_counter(cause).inc(v)
            tel_s += time.perf_counter() - t_t0
            # Retire on EOS exactly as generate fills: the EOS token is
            # kept, the rest of the budget fills with EOS.
            if r.eos_id is not None and r.eos_id in r.tokens:
                first = r.tokens.index(r.eos_id)
                r.tokens = r.tokens[:first + 1]
                r.tokens += [r.eos_id] * (r.max_new - len(r.tokens))
            if len(r.tokens) >= r.max_new:
                r.finished = True
                r.result = {"new_tokens": r.tokens[:r.max_new],
                            "batch_size": r.peak_batch}
                self.requests_finished += 1
                t_t0 = time.perf_counter()
                self._finish_telemetry(r)
                tel_s += time.perf_counter() - t_t0
                if self._slots[sid] is r:
                    if self._paged:
                        self._retire_slot(sid)
                    else:
                        self._slots[sid] = None
                r.done.set()
        self._m_slots.set(self.max_slots - len(self._free_slots()))
        self.telemetry_host_s += tel_s

    def _finish_telemetry(self, r: _Request):
        """A finished request's counters, latency histograms, span and
        waterfall."""
        self._m_finished.inc()
        self._m_tokens.inc(r.max_new)
        if r.span is None:
            return
        r.span.mark("done")
        lat = r.span.between(None, "done")
        if lat is not None:
            self._m_latency.observe(lat)
            if lat > 0:
                self._m_tps.observe(r.max_new / lat)
        decode = r.span.between("first_token", "done")
        if decode is not None and r.max_new > 1:
            self._m_per_tok.observe(decode / (r.max_new - 1))
        r.span.meta["max_new"] = r.max_new
        r.span.meta["batch_size"] = r.peak_batch
        if r.wf is not None:
            r.span.meta["waterfall"] = r.wf.finalize(r.span)
            if decode is not None and decode > 0:
                self._wf_decode_total += decode
                self._wf_steal_total += r.wf.stall_totals.get(
                    "prefill_steal", 0.0)
                self._m_prefill_interf.set(self._wf_steal_total
                                           / self._wf_decode_total)
        self._emit_span(r.span)

    def _dispatch_loop(self):
        with torch.no_grad(), self._on_stream():
            self._serve()

    def _serve(self):
        futures: deque = deque()
        staged: List[_Request] = []
        while not self._stop.is_set():
            # Drain the queue; block briefly only when fully idle.
            idle = (not futures and not staged
                    and all(r is None for r in self._slots))
            try:
                if idle:
                    with goodput.phase("idle"):
                        staged.append(self._q.get(timeout=0.05))
                else:
                    staged.append(self._q.get(timeout=0.0))
                while True:
                    staged.append(self._q.get_nowait())
            except queue.Empty:
                pass
            try:
                with self._lock, profiler.device_work():
                    self._boundary(staged, futures)
            except Exception as ex:
                self._fail_all(ex, staged, futures)

    def _boundary(self, staged: List[_Request], futures: deque):
        """One scheduler boundary: admit, prefill, decode, harvest."""
        if self._paged:
            if staged:
                # Paged admission only allocates pages and a slot; the
                # compute happens in the prefill step.
                with goodput.phase("admit"):
                    if self._admit_paged(staged):
                        self._m_activity.set(time.time())
            for step in (self._prefill_step, self._decode_step_paged):
                fut = step(staged)
                if fut is not None:
                    futures.append(fut)
                    self._m_activity.set(time.time())
            self._m_kv_in_use.set(self._pool.used_blocks)
            self._maybe_resolve_kv_alert()
        else:
            if staged:
                fut = self._admit(staged)
                if fut is not None:
                    futures.append(fut)
                    self._m_activity.set(time.time())
            if any(r is not None and not r.finished for r in self._slots):
                with goodput.phase("compile" if self.chunks_run == 0
                                   else "decode"):
                    toks = self._mono_chunk()
                self.chunks_run += 1
                self._m_chunks.inc()
                self._m_activity.set(time.time())
                self.decoded_rows_total += sum(
                    1 for r in self._slots
                    if r is not None and not r.finished)
                self.dispatched_rows_total += self.max_slots
                host, ev = self._to_host(toks)
                futures.append(("chunk", host, ev,
                                [(i, r) for i, r in enumerate(self._slots)
                                 if r is not None]))
        # Keep <= pipeline_depth dispatches in flight; drain fully when
        # nothing is active (nobody else will harvest).
        while futures and (len(futures) > self.pipeline_depth
                           or not any(r is not None for r in self._slots)):
            # The harvest is where queued decode work drains: "decode".
            with goodput.phase("decode"):
                self._harvest(futures.popleft())

    def _fail_all(self, ex: Exception, staged: List[_Request],
                  futures: deque):
        """Fail every in-flight and staged request and rebuild the device
        state: a poisoned state must not wedge the dispatcher silently."""
        err = {"error": f"{type(ex).__name__}: {ex}"}
        for _, _, _, snapshot in futures:
            for entry in snapshot:
                r = entry[1]
                if not r.finished:
                    r.finished, r.result = True, dict(err)
                    r.done.set()
        futures.clear()
        for r in staged:
            r.finished, r.result = True, dict(err)
            r.done.set()
        staged.clear()
        for i, r in enumerate(self._slots):
            if r is not None and not r.finished:
                r.finished, r.result = True, dict(err)
                r.done.set()
            self._slots[i] = None
        if self._paged:
            # Rebuild the allocator with the device state: a poisoned
            # pool's tables point at freed pages.
            self._pool = BlockPool(self._pool.num_blocks, self._ps)
            if self._trie is not None:
                self._trie = PrefixTrie(
                    self._pool, max_blocks=self._trie.max_blocks,
                    hit_window=self.kv.prefix_hit_window)
            self._tbl[:] = self._pool.sentinel
            self._slot_pages = [[] for _ in range(self.max_slots)]
            self._pending_cow.clear()
        self._init_state()

    # -- stats / warm / stop ----------------------------------------------

    def kv_stats(self) -> Optional[dict]:
        """Paged-pool pressure for the serving wire's admin ping (the
        reference's fields but ``prefix_digest``, which the fleet router
        reads). ``prefix_hit_rate`` is windowed over the last
        ``kv.prefix_hit_window`` lookups; the lifetime rate rides along."""
        if not self._paged:
            return None
        total = self._pool.num_blocks
        lookups = self._trie.lookups if self._trie is not None else 0
        hits = self._trie.hits if self._trie is not None else 0
        return {"paged": True, "block_size": self._ps,
                "blocks_total": total,
                "blocks_free": self._pool.free_blocks,
                "prefix_hit_rate": (round(self._trie.window_hit_rate(), 4)
                                    if self._trie is not None else 0.0),
                "prefix_hit_rate_lifetime": (round(hits / lookups, 4)
                                             if lookups else 0.0),
                "prefix_blocks_cached": (self._trie.blocks_held
                                         if self._trie is not None else 0),
                "preemptions": self.preemptions}

    def warm_shapes(self, workloads, batch_sizes=None) -> int:
        """Capture, without traffic, the decode graph of every paged
        (nb, W) bucket the given workloads can reach, so a measured window
        captures none. ``workloads``: (prompt_len, max_new) pairs;
        ``batch_sizes`` defaults to every size up to ``max_slots``. Prefill
        runs eagerly and needs no warming; the monolithic engine has no
        graphs. Call only while no request is in flight. Returns the number
        of buckets made (captured on the card)."""
        if not self._paged:
            return 0
        if batch_sizes is None:
            batch_sizes = range(1, self.max_slots + 1)
        ps = self._ps
        nbs = sorted({_bucket(min(n, self.max_slots), floor=1)
                      for n in batch_sizes})
        dec_w = set()
        for L, new in workloads:
            # Decode rows grow from the first post-prefill allocation to
            # the request's full budget.
            L, new = int(L), int(new)
            lo = pages_for(min(L + self.chunk_size, L + new), ps)
            for p in range(lo, pages_for(L + new, ps) + 1):
                dec_w.add(min(_wbucket(p), self._max_pages))
        made = 0
        with self._lock, profiler.device_work(), torch.no_grad(), \
                self._on_stream():
            for nb in nbs:
                for W in sorted(dec_w):
                    if (nb, W) not in self._chunks:
                        self._chunk(nb, W)
                        made += 1
        return made

    def warm(self, prompt_len: int, max_new: int, batch_sizes=(1,),
             temperature: float = 0.0, top_k: int = 0):
        """Push synthetic requests of each batch size through the real
        dispatcher, each size admitted as ONE batch (``_min_admit`` holds
        admission until all ``n`` are staged)."""
        del max_new  # the chunk's shape does not depend on it
        for n in batch_sizes:
            results = [None] * n

            def _one(i):
                results[i] = self.submit(
                    [1] * prompt_len, min(2, self.chunk_size),
                    temperature, top_k, None, 0)

            self._min_admit = min(n, self.max_slots)
            try:
                threads = [threading.Thread(target=_one, args=(i,),
                                            daemon=True)
                           for i in range(n)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
            finally:
                self._min_admit = 1
            bad = [r for r in results if not r or "error" in r]
            if bad:
                raise RuntimeError(f"warm workload rejected: {bad[0]}")

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30.0)
        try:
            while True:
                r = self._q.get_nowait()
                r.result = {"error": "server shutting down"}
                r.done.set()
        except queue.Empty:
            pass
        for r in self._slots:
            if r is not None and not r.finished:
                r.result = {"error": "server shutting down"}
                r.done.set()
