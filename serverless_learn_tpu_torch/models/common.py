"""Helpers every model family shares: the dtype names the configs use, and
the per-tensor generator that fixes a model's random weights by its seed."""

from __future__ import annotations

import zlib

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(value) -> torch.dtype:
    if isinstance(value, torch.dtype):
        return value
    if value in _DTYPES:
        return _DTYPES[value]
    raise ValueError(f"unsupported dtype {value!r}; expected one of "
                     f"{sorted(_DTYPES)}")


def leaf_generator(seed: int, name: str, device) -> torch.Generator:
    """A generator for one named tensor: ``seed`` and the crc32 of the name,
    so every tensor's values are fixed by the seed alone, in any order."""
    g = torch.Generator(device=device)
    g.manual_seed((seed << 32) | zlib.crc32(name.encode()))
    return g
