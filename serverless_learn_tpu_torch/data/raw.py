"""Token corpora from files, the port of the token part of
``serverless_learn_tpu/data/raw.py``: the byte-level vocabulary (ids 0..3
are specials, byte ``b`` is ``b + 4``), :func:`tokenize_bytes`,
:func:`detokenize_bytes` and :func:`load_token_corpus`, whose records
``publish`` (``data/shard_client.py``) turns into a shard-server dataset.

The MNIST, CIFAR-10 and imagefolder loaders wait with the models that
read them (ROADMAP.md queue 1).
"""

from __future__ import annotations

import gzip
from typing import Dict, Optional

import numpy as np

PAD_ID, MASK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
BYTE_OFFSET = 4
BYTE_VOCAB = 256 + BYTE_OFFSET


def open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def tokenize_bytes(text: bytes) -> np.ndarray:
    return np.frombuffer(text, np.uint8).astype(np.int32) + BYTE_OFFSET


def detokenize_bytes(ids: np.ndarray) -> bytes:
    ids = np.asarray(ids)
    return (ids[ids >= BYTE_OFFSET] - BYTE_OFFSET).astype(np.uint8).tobytes()


def load_token_corpus(path: str, seq_len: int,
                      dtype: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A corpus file as fixed-length records ``{"input_ids": [N, T]}``.

    ``.bin`` / ``.tokens`` (optionally ``.gz``) hold already-tokenized ids
    (uint16 unless ``dtype`` says otherwise); any other file is raw text,
    tokenized byte by byte (vocab 260). The stream is cut into rows of
    ``seq_len - 1`` ids, each headed by BOS; the tail that fills no row is
    dropped."""
    stem = path[:-3] if path.endswith(".gz") else path
    with open_maybe_gz(path) as f:
        raw = f.read()
    if stem.endswith((".bin", ".tokens")):
        ids = np.frombuffer(raw, dtype or np.uint16).astype(np.int32)
    else:
        ids = tokenize_bytes(raw)
    body = seq_len - 1  # room for BOS
    n = len(ids) // body
    if n == 0:
        raise ValueError(
            f"{path}: corpus has {len(ids)} tokens, fewer than one "
            f"{seq_len}-token record")
    rows = ids[:n * body].reshape(n, body)
    bos = np.full((n, 1), BOS_ID, np.int32)
    return {"input_ids": np.concatenate([bos, rows], axis=1)}
