"""Host-side batch sources, the port of ``serverless_learn_tpu/data/
datasets.py``: ``SyntheticSource`` draws batches from the model bundle's
``make_batch`` with ``np.random.default_rng(seed)``, so the same seed gives
bit-identical batches in both packages, and ``prefetch`` queues the next
batches' copies to the device before the current step is launched. The
streamed source is ``data/shard_client.py``'s ``ShardStreamSource``.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch


class SyntheticSource:
    def __init__(self, make_batch: Callable, data_config, batch_size: int,
                 seed: int = 0):
        self.make_batch = make_batch
        self.data_config = data_config
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator:
        while True:
            yield self.make_batch(self.rng, self.data_config, self.batch_size)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``. For the card the arrays are
    pinned and copied with ``non_blocking=True``, so the copy overlaps the
    running step (the caching host allocator keeps the pinned buffer alive
    until the copy is done)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


_END = object()


class prefetch:
    """``place_fn`` (host -> device) over ``source``, ``depth`` batches
    ahead of the one handed out: their copies (pinned, ``non_blocking``)
    are queued before the step that consumes the current batch, and the
    host never waits for one. ``depth`` 0 places each batch as it is
    taken. With a goodput ``ledger`` the wait for each batch of the source
    is its ``data_wait`` phase. A source's error raises out of the
    iterator, as the reference's ``Prefetcher`` re-raises it: a lost shard
    server never reads as the end of the data. :meth:`depth` is the
    number of placed batches ready (the flow a worker's heartbeat
    reports); :meth:`close` drops them, and with them their pinned host
    copies."""

    def __init__(self, source: Iterable, place_fn: Callable, depth: int,
                 ledger=None):
        self._it = iter(source)
        self._place = place_fn
        self._want = depth
        self._ledger = ledger
        self._ahead: collections.deque = collections.deque()
        self._started = self._done = False

    def _pull(self) -> bool:
        if self._ledger is None:
            batch = next(self._it, _END)
        else:
            with self._ledger.phase("data_wait"):
                batch = next(self._it, _END)
        if batch is _END:
            self._done = True
            return False
        self._ahead.append(self._place(batch))
        return True

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self._started = True
            while len(self._ahead) < self._want and self._pull():
                pass
        if not self._done:
            self._pull()
        if not self._ahead:
            raise StopIteration
        return self._ahead.popleft()

    def depth(self) -> int:
        return len(self._ahead)

    def close(self):
        self._ahead.clear()
        self._done = True
