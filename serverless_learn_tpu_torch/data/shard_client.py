"""Datasets on the shard server, the port of ``serverless_learn_tpu/data/
shard_client.py``: the same layout, so either package reads what the other
published, and the same batches from the same seed.

A dataset is ``<dataset>/meta.json`` (each field's numpy dtype and
per-record shape, records per shard, record count) and
``<dataset>/shard-%05d.bin`` (struct of arrays: each field's records
``[lo, hi)`` in schema order, concatenated). ``meta.json`` is written
last: its presence marks the dataset complete.

:class:`ShardStreamSource` streams host batches: the shards of this
consumer's stripe (``dp_rank`` of ``dp_size``, optionally subdivided by
``sub_rank`` of ``sub_count``) in a per-epoch seeded order, records
shuffled within each shard with leftovers carried across shard
boundaries, a fetch thread keeping ``prefetch_shards`` decoded shards
ahead, and any fetch error raised to the consumer (never a clean end).
``publish_imagefolder`` waits with the image models (ROADMAP.md queue 1).
"""

from __future__ import annotations

import json
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from serverless_learn_tpu_torch.control.client import ShardClient

META_SUFFIX = "meta.json"


def meta_key(dataset: str) -> str:
    return f"{dataset}/{META_SUFFIX}"


def shard_key(dataset: str, idx: int) -> str:
    return f"{dataset}/shard-{idx:05d}.bin"


@dataclass(frozen=True)
class FieldSpec:
    name: str
    dtype: str  # numpy dtype string, e.g. "int32"
    shape: Tuple[int, ...]  # per-record shape

    @property
    def record_nbytes(self) -> int:
        n = np.dtype(self.dtype).itemsize
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class DatasetMeta:
    fields: Tuple[FieldSpec, ...]
    num_records: int
    records_per_shard: int

    @property
    def num_shards(self) -> int:
        return -(-self.num_records // self.records_per_shard)

    def shard_range(self, idx: int) -> Tuple[int, int]:
        lo = idx * self.records_per_shard
        return lo, min(lo + self.records_per_shard, self.num_records)

    def to_json(self) -> str:
        return json.dumps({
            "fields": [{"name": f.name, "dtype": f.dtype,
                        "shape": list(f.shape)} for f in self.fields],
            "num_records": self.num_records,
            "records_per_shard": self.records_per_shard,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DatasetMeta":
        raw = json.loads(text)
        return cls(
            fields=tuple(FieldSpec(f["name"], f["dtype"], tuple(f["shape"]))
                         for f in raw["fields"]),
            num_records=int(raw["num_records"]),
            records_per_shard=int(raw["records_per_shard"]),
        )


def encode_shard(meta: DatasetMeta, arrays: Dict[str, np.ndarray],
                 lo: int, hi: int) -> bytes:
    parts = []
    for f in meta.fields:
        a = np.ascontiguousarray(arrays[f.name][lo:hi])
        if str(a.dtype) != f.dtype or tuple(a.shape[1:]) != f.shape:
            raise ValueError(
                f"field {f.name!r}: got {a.dtype}{a.shape[1:]}, "
                f"meta says {f.dtype}{f.shape}")
        parts.append(a.tobytes())
    return b"".join(parts)


def decode_shard(meta: DatasetMeta, raw: bytes,
                 n_records: int) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    off = 0
    for f in meta.fields:
        nbytes = f.record_nbytes * n_records
        out[f.name] = np.frombuffer(
            raw, dtype=f.dtype, count=nbytes // np.dtype(f.dtype).itemsize,
            offset=off).reshape((n_records, *f.shape))
        off += nbytes
    if off != len(raw):
        raise ValueError(f"shard size {len(raw)} != schema size {off}")
    return out


def publish_dataset(addr: str, dataset: str, arrays: Dict[str, np.ndarray],
                    records_per_shard: int = 1024) -> DatasetMeta:
    """Write ``arrays`` (a dict of [N, ...] arrays) as dataset shards,
    then its meta."""
    names = sorted(arrays)
    num = len(arrays[names[0]])
    for k in names:
        if len(arrays[k]) != num:
            raise ValueError(f"field {k!r} has {len(arrays[k])} records, "
                             f"field {names[0]!r} has {num}")
    meta = DatasetMeta(
        fields=tuple(FieldSpec(k, str(arrays[k].dtype),
                               tuple(arrays[k].shape[1:])) for k in names),
        num_records=num,
        records_per_shard=min(records_per_shard, num),
    )
    client = ShardClient(addr)
    try:
        for i in range(meta.num_shards):
            lo, hi = meta.shard_range(i)
            client.put(shard_key(dataset, i),
                       encode_shard(meta, arrays, lo, hi))
        client.put(meta_key(dataset), meta.to_json().encode())
    finally:
        client.close()
    return meta


def publish_from_bundle(addr: str, dataset: str, make_batch, data_config,
                        num_records: int, seed: int = 0,
                        records_per_shard: int = 1024) -> DatasetMeta:
    """``num_records`` records of a model bundle's synthetic ``make_batch``
    (``np.random.default_rng(seed)``), published."""
    rng = np.random.default_rng(seed)
    arrays = make_batch(rng, data_config, num_records)
    return publish_dataset(addr, dataset, arrays, records_per_shard)


def load_meta(addr: str, dataset: str) -> DatasetMeta:
    client = ShardClient(addr)
    try:
        return DatasetMeta.from_json(client.fetch(meta_key(dataset)).decode())
    finally:
        client.close()


class ShardStreamSource:
    """Iterator of host batches streamed from the shard server (module
    docstring). :meth:`close` stops and joins the fetch thread."""

    def __init__(self, addr: str, dataset: str, batch_size: int,
                 seed: int = 0, dp_rank: int = 0, dp_size: int = 1,
                 loop: bool = True, prefetch_shards: int = 2,
                 sub_rank: int = 0, sub_count: int = 1):
        if not (0 <= dp_rank < dp_size):
            raise ValueError(f"dp_rank {dp_rank} not in [0, {dp_size})")
        if not (0 <= sub_rank < sub_count):
            raise ValueError(f"sub_rank {sub_rank} not in [0, {sub_count})")
        self.addr = addr
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.loop = loop
        self.meta = load_meta(addr, dataset)
        mine = [i for i in range(self.meta.num_shards)
                if i % dp_size == dp_rank]
        # sub_rank/sub_count divide this rank's own stripe: their union is
        # the rank's share whatever sub_count is.
        self._my_shards = [s for j, s in enumerate(mine)
                          if j % sub_count == sub_rank]
        if mine and not self._my_shards:
            raise ValueError(
                f"sub_rank {sub_rank}/{sub_count} of dp rank {dp_rank} has "
                f"no shards ({len(mine)} in the rank's stripe); use at most "
                f"{len(mine)} ingest workers for {dataset!r}")
        if not self._my_shards:
            if sub_count > 1:
                raise ValueError(
                    f"dp rank {dp_rank}/{dp_size} owns no shards of "
                    f"{dataset!r} ({self.meta.num_shards} total); parallel "
                    "ingest workers would all wrap onto one shard — use a "
                    "single source or publish more shards")
            # More dp ranks than shards: wrap (ranks may then share
            # records; publish more shards to avoid it).
            self._my_shards = [dp_rank % self.meta.num_shards]
        per_epoch = sum(self.meta.shard_range(i)[1] - self.meta.shard_range(i)[0]
                        for i in self._my_shards)
        if per_epoch < batch_size:
            raise ValueError(
                f"rank {dp_rank}/{dp_size} sees only {per_epoch} records of "
                f"{dataset!r} per epoch, fewer than batch_size {batch_size}")
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch_shards, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fetch_loop, daemon=True,
                                        name="slt-shard-fetch")
        self._thread.start()

    @property
    def shards(self) -> List[int]:
        """The shard indices this consumer reads."""
        return list(self._my_shards)

    def _epoch_order(self, epoch: int) -> List[int]:
        rng = np.random.default_rng((self.seed, epoch))
        return list(rng.permutation(self._my_shards))

    def _fetch_loop(self):
        client = None
        try:
            # Inside the try: a connect failure must reach the consumer as
            # an error, not read as the end of the data.
            client = ShardClient(self.addr)
            epoch = 0
            while not self._stop.is_set():
                for idx in self._epoch_order(epoch):
                    if self._stop.is_set():
                        return
                    lo, hi = self.meta.shard_range(idx)
                    # The exact size is the schema's: no manifest RPC.
                    nbytes = sum(f.record_nbytes for f in self.meta.fields
                                 ) * (hi - lo)
                    # Queue depth 0: the consumer starves, and the server
                    # puts this stream before well-fed ones.
                    client.set_flow(self._q.qsize())
                    raw = client.fetch(shard_key(self.dataset, idx),
                                       length=nbytes)
                    shard = decode_shard(self.meta, raw, hi - lo)
                    self._put((epoch, idx, shard))
                if not self.loop:
                    self._put(None)  # end of data
                    return
                epoch += 1
        except Exception as e:  # the consumer raises it
            self._put(e)
        finally:
            if client is not None:
                client.close()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        carry: Optional[Dict[str, np.ndarray]] = None
        epoch_rng = None
        last_epoch = -1
        while True:
            item = self._take()
            if item is None:
                return  # single-pass end; a partial batch is dropped
            if isinstance(item, Exception):
                raise item
            epoch, _idx, shard = item
            if epoch != last_epoch:
                epoch_rng = np.random.default_rng(
                    (self.seed, epoch, self.dp_rank))
                last_epoch = epoch
                carry = None  # epoch boundary: drop the partial batch
            n = len(next(iter(shard.values())))
            perm = epoch_rng.permutation(n)
            shard = {k: v[perm] for k, v in shard.items()}
            if carry is not None:
                shard = {k: np.concatenate([carry[k], shard[k]])
                         for k in shard}
            n = len(next(iter(shard.values())))
            nb = n // self.batch_size
            for b in range(nb):
                lo = b * self.batch_size
                yield {k: v[lo:lo + self.batch_size] for k, v in shard.items()}
            rem = n - nb * self.batch_size
            carry = ({k: v[n - rem:] for k, v in shard.items()}
                     if rem else None)

    def _take(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    return None  # fetch thread gone, queue drained: end

    def close(self, timeout: float = 60.0):
        self._stop.set()
        # Drain so a put blocked on a full queue sees the stop.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
