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
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from serverless_learn_tpu_torch.config import KVCacheConfig
from serverless_learn_tpu_torch.inference.generate import generate, init_cache
from serverless_learn_tpu_torch.models.transformer import Transformer


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


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
                 kv: Optional[KVCacheConfig] = None):
        self.model = model
        self.kv = kv
        self._paged = bool(kv is not None and kv.paged)
        self.max_batch = max_batch
        self.batch_wait_s = batch_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_batched = 0
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int, temperature: float,
               top_k: int, eos_id: Optional[int], seed: int,
               timeout_s: float = 600.0) -> dict:
        """Blocks until the dispatcher serves this request; returns either
        {"new_tokens": [...], "batch_size": n} or {"error": ...}."""
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
        self._q.put(p)
        if not p.done.wait(timeout_s):
            return {"error": "generation timed out in the admission queue"}
        return p.result

    # -- dispatcher --------------------------------------------------------

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            extras: List[_Pending] = []
            deadline = time.perf_counter() + self.batch_wait_s
            # Admission window: wait up to batch_wait_ms for co-batchable
            # requests; mismatched keys go back for the next round.
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
        for i, p in enumerate(group):
            prompts[i, :len(p.prompt)] = p.prompt
            lengths[i] = len(p.prompt)
        # Pad rows replicate row 0 so they can't inject out-of-range ids.
        for i in range(n, batch_bucket):
            prompts[i] = prompts[0]
            lengths[i] = lengths[0]

        dev = self.model.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(first.seed)
        cache = (init_cache(self.model, batch_bucket,
                            block_size=self.kv.block_size)
                 if self._paged else None)
        tokens = generate(self.model, torch.from_numpy(prompts), new_bucket,
                          temperature=first.temperature, top_k=first.top_k,
                          eos_id=first.eos_id, generator=gen,
                          prompt_lengths=torch.from_numpy(lengths),
                          cache=cache)
        new = tokens[:, prompt_bucket:].cpu().numpy()
        self.batches_run += 1
        self.requests_batched += n
        for i, p in enumerate(group):
            p.result = {"new_tokens": [int(t) for t in new[i, :p.max_new]],
                        "batch_size": n}
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
