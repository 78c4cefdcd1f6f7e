"""Dataset files, the port of ``serverless_learn_tpu/data/raw.py``: MNIST's
IDX files (:func:`load_idx`, :func:`load_mnist`), the CIFAR-10 binary
batches (:func:`load_cifar10_file`, :func:`load_cifar10`) and token
corpora (the byte-level vocabulary: ids 0..3 are specials, byte ``b`` is
``b + 4``; :func:`tokenize_bytes`, :func:`detokenize_bytes`,
:func:`load_token_corpus`). Each gives ``{field: [N, ...] array}``, which
``publish`` (``data/shard_client.py``) turns into a shard-server dataset.
Images stay uint8, HWC; the host transforms (``data/transforms.py``)
convert and augment them.

The formats, as published:

* IDX (MNIST): ``0x00 0x00 <dtype byte> <ndim>``, big-endian uint32
  dims, then the row-major payload;
* CIFAR-10 binary: a record is 1 label byte and 3,072 bytes of a 32x32
  RGB image in CHW plane order.

The imagefolder loader (``LOADERS["imagefolder"]``) needs PIL to decode,
which the card's machine lacks: it waits (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional

import numpy as np

# IDX type byte -> numpy dtype (big-endian where multi-byte).
_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}
CIFAR_RECORD = 1 + 3 * 32 * 32

PAD_ID, MASK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
BYTE_OFFSET = 4
BYTE_VOCAB = 256 + BYTE_OFFSET


def open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_idx(path: str) -> np.ndarray:
    """One IDX file (gzipped when its name ends in ``.gz``) as a numpy
    array in native byte order."""
    with open_maybe_gz(path) as f:
        raw = f.read()
    if len(raw) < 4 or raw[0] != 0 or raw[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic {raw[:4]!r})")
    dtype = _IDX_DTYPES.get(raw[2])
    if dtype is None:
        raise ValueError(f"{path}: unknown IDX dtype byte 0x{raw[2]:02x}")
    ndim = raw[3]
    header = 4 + 4 * ndim
    dims = tuple(int(n) for n in np.frombuffer(raw, ">u4", ndim, offset=4))
    count = int(np.prod(dims)) if dims else 0
    expect = header + count * dtype.itemsize
    if len(raw) != expect:
        raise ValueError(
            f"{path}: payload is {len(raw) - header} bytes, dims {dims} "
            f"require {expect - header}")
    arr = np.frombuffer(raw, dtype, count, offset=header).reshape(dims)
    return arr.astype(dtype.newbyteorder("="), copy=False)


def _find_file(root: str, candidates) -> str:
    for name in candidates:
        for suffix in ("", ".gz"):
            p = os.path.join(root, name + suffix)
            if os.path.isfile(p):
                return p
    raise FileNotFoundError(
        f"none of {list(candidates)} (or .gz) under {root!r}")


def load_mnist(root: str, split: str = "train") -> Dict[str, np.ndarray]:
    """An MNIST directory (the four-file distribution, each file optionally
    gzipped) -> {"image": [N, 28, 28, 1] uint8, "label": [N] int32}."""
    prefix = {"train": "train", "test": "t10k"}[split]
    images = load_idx(_find_file(root, (f"{prefix}-images-idx3-ubyte",
                                        f"{prefix}-images.idx3-ubyte")))
    labels = load_idx(_find_file(root, (f"{prefix}-labels-idx1-ubyte",
                                        f"{prefix}-labels.idx1-ubyte")))
    if images.ndim != 3:
        raise ValueError(f"expected rank-3 image tensor, got {images.shape}")
    if len(images) != len(labels):
        raise ValueError(f"{len(images)} images vs {len(labels)} labels")
    return {"image": images[..., None], "label": labels.astype(np.int32)}


def load_cifar10_file(path: str) -> Dict[str, np.ndarray]:
    """One CIFAR-10 binary batch file -> HWC uint8 images and int32
    labels."""
    with open_maybe_gz(path) as f:
        raw = f.read()
    if len(raw) % CIFAR_RECORD:
        raise ValueError(
            f"{path}: {len(raw)} bytes is not a multiple of the "
            f"{CIFAR_RECORD}-byte CIFAR record")
    rec = np.frombuffer(raw, np.uint8).reshape(-1, CIFAR_RECORD)
    labels = rec[:, 0].astype(np.int32)
    images = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return {"image": np.ascontiguousarray(images), "label": labels}


def load_cifar10(root: str, split: str = "train") -> Dict[str, np.ndarray]:
    """The CIFAR-10 binary distribution (``data_batch_1..5.bin`` or
    ``test_batch.bin``, each optionally gzipped) under ``root`` or its
    ``cifar-10-batches-bin/``."""
    for base in (root, os.path.join(root, "cifar-10-batches-bin")):
        if not os.path.isdir(base):
            continue
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if split == "train" else ["test_batch.bin"])
        parts = []
        for n in names:
            for suffix in ("", ".gz"):
                p = os.path.join(base, n + suffix)
                if os.path.isfile(p):
                    parts.append(load_cifar10_file(p))
                    break
        if parts:
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
    raise FileNotFoundError(f"no CIFAR-10 binary batches under {root!r}")


def load_imagefolder(root: str, split: str = "train"):
    from serverless_learn_tpu_torch.config import not_ported

    raise not_ported("the imagefolder loader (decoding needs PIL, which the "
                     "card's machine lacks)", "ROADMAP.md queue 1 item 5")


LOADERS = {"mnist": load_mnist, "cifar10": load_cifar10,
           "imagefolder": load_imagefolder}


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
