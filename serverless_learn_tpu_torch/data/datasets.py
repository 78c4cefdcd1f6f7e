"""Host-side batch sources, the port of ``serverless_learn_tpu/data/
datasets.py``: ``SyntheticSource`` draws batches from the model bundle's
``make_batch`` with ``np.random.default_rng(seed)``, so the same seed gives
bit-identical batches in both packages, and ``prefetch`` queues the next
batches' copies to the device before the current step is launched.
"""

from __future__ import annotations

import collections
import itertools
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


def prefetch(source: Iterable, place_fn: Callable, depth: int) -> Iterator:
    """``place_fn`` (host -> device) over ``source``, ``depth`` batches
    ahead of the one handed out: their copies (pinned, ``non_blocking``)
    are queued before the step that consumes the current batch, and the
    host never waits for one. ``depth`` 0 places each batch as it is
    taken."""
    it = iter(source)
    ahead = collections.deque(place_fn(b) for b in itertools.islice(it, depth))
    for batch in it:
        ahead.append(place_fn(batch))
        yield ahead.popleft()
    yield from ahead
