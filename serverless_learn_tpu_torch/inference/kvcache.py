"""Paged KV cache, port of ``serverless_learn_tpu/inference/kvcache.py``:
the block pool, the prefix trie and the block tables on the host, and the
paged cache the model reads and writes on the device.

* :class:`BlockPool`: a free-list allocator over ``num_blocks`` page ids
  with per-block refcounts. The SAME id addresses every layer's pool, so
  one host-side table drives all layers. Exhaustion raises the typed
  :class:`KVBlocksExhausted`: admission backpressure, never a crash.
* :class:`PrefixTrie`: block-granular shared-prefix reuse. A registered
  node holds its own pool reference, so prompt-prefix blocks outlive their
  first owner and later identical prefixes map to the same refcounted
  read-only pages; divergence mid-block is served by copy-on-write (the
  lookup reports the child block whose leading tokens match); LRU eviction
  under ``max_blocks`` and on demand (:meth:`PrefixTrie.release`).
* :class:`PagedKVCache`: per layer ``pages_k/v [num_blocks + 1,
  block_size, K, D]`` in the compute dtype, one shared ``[B, W]`` int32
  table window and a ``[B]`` int32 index. It replaces the reference's
  ``with_tables`` / ``split_cache`` / ``paged_module`` pytree helpers: the
  model (``models/transformer.py``) takes the cache object and reads its
  type. The extra page is the counterpart of the reference's
  ``mode="drop"`` scatter: the sentinel id ``num_blocks`` names it, a pad
  write or a write past the window lands there, and nothing reads it
  unmasked. So every write is one fixed-shape ``index_put_``, which a CUDA
  graph can hold (a boolean-filtered write has a data-dependent shape).

The host side is a copy of the reference's, kept identical in behaviour
(``tests/test_torch_kvcache.py`` runs both through one script), without
the resident-prefix digest and its per-node provenance, which only the
fleet router reads. Sharing is
sound because K/V depend only on token values and absolute positions
(RoPE): identical prefixes at identical positions give identical K/V, and
prefix pages are never written after registration.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class KVCacheError(RuntimeError):
    """Base for paged-KV allocator errors."""


class KVBlocksExhausted(KVCacheError):
    """The pool cannot satisfy an allocation — typed admission
    backpressure: the scheduler keeps the request queued (or preempts)
    instead of crashing the dispatcher."""

    def __init__(self, need: int, free: int, total: int):
        super().__init__(
            f"KV block pool exhausted: need {need}, {free} free of {total}")
        self.need = need
        self.free = free
        self.total = total


def pages_for(n_tokens: int, block_size: int) -> int:
    """Pages needed to hold ``n_tokens`` tokens."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


# The fleet's prefix-digest scheme (the router is not ported; the hashes
# are kept so the two packages name a prefix alike). A chunk's hash is
# chained through its whole ancestry (h_i = blake2b(h_{i-1} || chunk_i tokens), 64-bit),
# so one hash names one exact token PREFIX — two replicas report the
# same hash iff they hold KV for the same leading tokens, and the router
# can intersect prompt hashes with ping digests without shipping tokens
# over the wire. 64 bits keeps ping payloads small; with n resident
# chunks fleet-wide the collision probability is ~n^2/2^65 (n=10^6 =>
# ~3e-8), and a collision only ever OVER-counts redundancy by one chunk.
_DIGEST_SEED = b"slt-prefix-digest-v1"


def chunk_hashes(tokens: Sequence[int], block_size: int) -> List[str]:
    """Chained 64-bit hashes (16 hex chars) of each FULL leading
    ``block_size``-token chunk of ``tokens``. Position i's hash commits
    to chunks [0, i] — the prefix, not just the chunk."""
    out: List[str] = []
    prev = _DIGEST_SEED
    bs = block_size
    for i in range(0, len(tokens) - len(tokens) % bs, bs):
        chunk = b",".join(str(int(t)).encode() for t in tokens[i:i + bs])
        hx = hashlib.blake2b(prev + b"|" + chunk, digest_size=8).hexdigest()
        out.append(hx)
        prev = bytes.fromhex(hx)
    return out


class BlockPool:
    """Host-side free-list allocator with refcounts over page ids.

    Single-owner by design: the engine's dispatcher thread is the only
    caller (like the slot table it replaces), so there is no lock. The
    sentinel id (== ``num_blocks``) marks unallocated table entries; on the
    device it names the pool's scratch page (:class:`PagedKVCache`).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: deterministic allocation order (tests pin it).
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks

    @property
    def sentinel(self) -> int:
        return self.num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh blocks at refcount 1, or KVBlocksExhausted (the
        pool is untouched on failure — all-or-nothing)."""
        if n <= 0:
            return []
        if n > len(self._free):
            raise KVBlocksExhausted(n, len(self._free), self.num_blocks)
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if self._ref[b] <= 0:
                raise KVCacheError(f"incref of free block {b}")
            self._ref[b] += 1

    def decref(self, blocks: Sequence[int]) -> int:
        """Drop one reference per id; ids reaching zero return to the
        free list. Returns how many were actually freed."""
        freed = 0
        for b in blocks:
            if self._ref[b] <= 0:
                raise KVCacheError(f"decref of free block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed += 1
        return freed


@dataclasses.dataclass
class PrefixHit:
    """Result of a trie lookup over one prompt.

    ``blocks``: page ids of the matched FULL leading blocks (read-only,
    not yet increfed — the caller increfs what it adopts).
    ``tokens_matched``: ``len(blocks) * block_size``.
    ``cow_src``/``cow_tokens``: a child block whose first ``cow_tokens``
    tokens match the prompt's next (partial) chunk — the copy-on-write
    donor for mid-block divergence. None/0 when there is none.
    """

    blocks: List[int]
    tokens_matched: int
    cow_src: Optional[int] = None
    cow_tokens: int = 0


class _Node:
    __slots__ = ("key", "block", "children", "stamp")

    def __init__(self, key: Tuple[int, ...], block: int, stamp: int):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = stamp


class PrefixTrie:
    """Block-granular prompt-prefix cache over a :class:`BlockPool`.

    Each node owns one pool reference for its block; eviction (LRU,
    leaves first — an interior node's block is the prefix of its
    children's prompts and must outlive them) drops that reference, so a
    block a live slot still uses survives eviction and only leaves the
    device when its last user retires.
    """

    def __init__(self, pool: BlockPool, max_blocks: int = 0,
                 hit_window: int = 256):
        self.pool = pool
        self.block_size = pool.block_size
        self.max_blocks = max_blocks  # 0 = unbounded (pool pressure evicts)
        self._root = _Node((), -1, 0)
        self._clock = 0
        self._count = 0
        self.hits = 0
        self.lookups = 0
        # Last-N lookup outcomes: the router picks on this WINDOWED rate
        # (lifetime hits/lookups goes inert as uptime grows — a traffic
        # shift at hour 10 barely moves a 10-hour average).
        self._window: collections.deque = collections.deque(
            maxlen=max(1, hit_window))

    @property
    def blocks_held(self) -> int:
        return self._count

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens: Sequence[int]):
        bs = self.block_size
        for i in range(0, len(tokens) - len(tokens) % bs, bs):
            yield tuple(int(t) for t in tokens[i:i + bs])

    def lookup(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest matched full-block prefix plus the best COW donor for
        the next (partial) chunk. Pure apart from the LRU touch."""
        self.lookups += 1
        now = self._tick()
        node = self._root
        blocks: List[int] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.stamp = now
            blocks.append(child.block)
            node = child
        matched = len(blocks) * self.block_size
        # COW donor: any child whose leading tokens equal the remainder.
        rem = [int(t) for t in tokens[matched:matched + self.block_size]]
        cow_src, cow_tokens = None, 0
        if rem and len(rem) < self.block_size:
            for key, child in node.children.items():
                n = 0
                while n < len(rem) and key[n] == rem[n]:
                    n += 1
                if n > cow_tokens:
                    cow_src, cow_tokens = child.block, n
        hit = bool(blocks or cow_tokens)
        if hit:
            self.hits += 1
        self._window.append(1 if hit else 0)
        return PrefixHit(blocks=blocks, tokens_matched=matched,
                         cow_src=cow_src, cow_tokens=cow_tokens)

    def register(self, tokens: Sequence[int],
                 blocks: Sequence[int]) -> int:
        """Publish a prompt's FULL leading blocks (their K/V must already
        be written). ``blocks[i]`` backs tokens ``[i*bs, (i+1)*bs)``.
        Existing nodes win (first writer publishes; a racing identical
        prompt keeps its private copies until retirement). Returns how
        many new nodes were created."""
        now = self._tick()
        node = self._root
        created = 0
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(blocks):
                break
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(blocks[i]), now)
                node.children[chunk] = child
                self.pool.incref([child.block])
                self._count += 1
                created += 1
            child.stamp = now
            node = child
        if self.max_blocks > 0 and self._count > self.max_blocks:
            self.release(self._count - self.max_blocks)
        return created

    def window_hit_rate(self) -> float:
        """Hit rate over the last ``hit_window`` lookups (0.0 when no
        lookup has happened yet)."""
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    def _leaves(self) -> List[Tuple[_Node, _Node, Tuple[int, ...]]]:
        out = []

        def walk(node):
            for key, child in node.children.items():
                if child.children:
                    walk(child)
                else:
                    out.append((node, child, key))

        walk(self._root)
        return out

    def release(self, n: int) -> int:
        """Evict up to ``n`` LRU leaf nodes, preferring those whose block
        would actually free (refcount 1 = trie-only). Returns the number
        of pool blocks freed."""
        freed = 0
        evicted = 0
        while evicted < n:
            leaves = self._leaves()
            if not leaves:
                break
            # Trie-only leaves first (they free real memory), then LRU.
            leaves.sort(key=lambda pcn: (
                self.pool.refcount(pcn[1].block) > 1, pcn[1].stamp))
            parent, child, key = leaves[0]
            del parent.children[key]
            freed += self.pool.decref([child.block])
            self._count -= 1
            evicted += 1
        return freed

    def clear(self) -> int:
        return self.release(self._count)


def sequential_table(batch: int, max_pages: int, num_blocks: int
                     ) -> np.ndarray:
    """Row-major dense block table for engines that don't share pages
    (the static engine's per-group cache): row b owns pages
    [b*max_pages, (b+1)*max_pages). Requires num_blocks >= B*max_pages."""
    if batch * max_pages > num_blocks:
        raise KVBlocksExhausted(batch * max_pages, num_blocks, num_blocks)
    return np.arange(batch * max_pages, dtype=np.int32).reshape(
        batch, max_pages)


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer block pools ``pages_k/v [num_blocks + 1, block_size, K,
    D]`` (the last page is the scratch page that the sentinel id
    ``num_blocks`` names), the ``[B, W]`` int32 table window the model
    attends through (W pages, so an attention span of ``W * block_size``)
    and the ``[B]`` int32 position of each row's next token."""

    pages_k: List[torch.Tensor]
    pages_v: List[torch.Tensor]
    table: torch.Tensor
    index: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.pages_k[0].shape[1]

    @property
    def sentinel(self) -> int:
        return self.pages_k[0].shape[0] - 1

    def with_tables(self, table: torch.Tensor, index: torch.Tensor
                    ) -> "PagedKVCache":
        """The same pools seen through another table window and index."""
        return PagedKVCache(self.pages_k, self.pages_v, table, index)


def paged_cache(n_layers: int, num_blocks: int, block_size: int,
                kv_heads: int, head_dim: int, dtype: torch.dtype, device,
                table) -> PagedKVCache:
    """Zeroed pools of ``num_blocks`` pages (plus the scratch page) for
    every layer, seen through ``table`` [B, W] (numpy or tensor, page ids,
    ``num_blocks`` = unallocated), every row's index at 0."""
    shape = (num_blocks + 1, block_size, kv_heads, head_dim)
    table = torch.as_tensor(table, dtype=torch.int32).to(device)
    pools = [[torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(n_layers)] for _ in "kv"]
    return PagedKVCache(*pools, table, torch.zeros(
        table.shape[0], dtype=torch.int32, device=device))
