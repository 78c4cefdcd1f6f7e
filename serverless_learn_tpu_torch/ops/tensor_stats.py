"""Tensor statistics for the numerics layer: the wrappers of
``csrc/tensor_stats.cu`` and their plain PyTorch versions.

The kernels replace no TPU kernel: the reference's per-subtree norms, maxima,
non-finite counts and fingerprint sums (``serverless_learn_tpu/telemetry/
numerics.py`` ``_sub_stats``, ``fingerprint``) are jnp reductions that XLA
fuses into the jitted step. Eagerly they would read each tensor once per
statistic and allocate full-size masks; these read it once.

* :func:`tensor_stats` writes ``grid_for(n)`` rows of :data:`KCOLS` f64
  values for one tensor ``x`` (``v = scale * x`` in f32), and
  :func:`tensor_stats_many` those of a list of tensors in one launch
  (a step's gradients, its parameters): the sum of v^2
  over finite v (:data:`SUMSQ`), over every v (:data:`SUMSQ_ALL`, where a
  NaN or an inf carries), the max |v| over finite v (:data:`ABSMAX`), the
  NaN and inf counts (:data:`NAN`, :data:`INF`), the sum of finite v
  (:data:`SUM`) and, with ``chunks``, the finite sums of the positional
  chunks ``(base + i) // chunk`` from :data:`CHUNK0` on;
* :func:`stats_reduce` folds groups of consecutive rows into one row each
  (sums; the max for :data:`ABSMAX`), in row order.

Both are deterministic: the same tensor gives the same bits wherever it
lies. On a CUDA tensor each launches its kernel or raises; on a CPU tensor
each runs its plain version (:func:`tensor_stats_reference`,
:func:`stats_reduce_reference`), which puts the tensor's whole result in its
first row.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from serverless_learn_tpu_torch.ops import build

SUMSQ, SUMSQ_ALL, ABSMAX, NAN, INF, SUM, CHUNK0 = range(7)
MAX_CHUNKS = 16
KCOLS = CHUNK0 + MAX_CHUNKS
THREADS, UNROLL, MAX_GRID = 256, 8, 1056  # as csrc/tensor_stats.cu; 8 a SM
MAX_MANY = 256  # tensors in one many-tensor launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}


def grid_for(n: int) -> int:
    """Rows (blocks) :func:`tensor_stats` writes for ``n`` elements: one
    block per 2,048 elements, at most 1,056 (eight resident a streaming
    multiprocessor of an H100, enough loads in flight for its HBM rate)."""
    return max(1, min(-(-n // (THREADS * UNROLL)), MAX_GRID))


# ------------------------------------------------------- plain versions --


def tensor_stats_reference(x: torch.Tensor, rows: torch.Tensor, base: int = 0,
                           chunk: int = 0, chunks: int = 0,
                           scale: float = 1.0) -> torch.Tensor:
    """The kernel's plain version: the same values in ``rows[0]`` (squares
    and the scaling in f32, sums in f64), zeros in the other rows."""
    v = x.detach().reshape(-1).float()
    if scale != 1.0:
        v = v * scale
    finite = torch.isfinite(v)
    vf = torch.where(finite, v, torch.zeros((), dtype=v.dtype))
    rows.zero_()
    row = rows[0]
    row[SUMSQ] = (vf * vf).double().sum()
    row[SUMSQ_ALL] = (v * v).double().sum()
    row[ABSMAX] = vf.abs().max().double() if v.numel() else 0.0
    row[NAN] = torch.isnan(v).sum()
    row[INF] = torch.isinf(v).sum()
    row[SUM] = vf.double().sum()
    if chunks:
        idx = (torch.arange(v.numel(), device=v.device) + base) // chunk
        row[CHUNK0:CHUNK0 + chunks] = torch.zeros(
            chunks, dtype=torch.float64, device=v.device).index_add_(
                0, idx, vf.double())
    return rows


def stats_reduce_reference(rows: torch.Tensor, bounds: List[int],
                           out: torch.Tensor) -> torch.Tensor:
    """The reduction's plain version: ``out[g]`` folds ``rows[bounds[g]:
    bounds[g + 1]]`` (sums; the max for ABSMAX)."""
    for g in range(len(bounds) - 1):
        part = rows[bounds[g]:bounds[g + 1]]
        out[g] = part.sum(0)
        out[g, ABSMAX] = part[:, ABSMAX].max() if len(part) else 0.0
    return out


def kernel_tolerance(ref: torch.Tensor, n: int) -> torch.Tensor:
    """The limit on |kernel - plain| of each column of ``ref``, a reduced
    row of the plain version over ``n`` elements. Both square in f32; the
    kernel then adds each thread's 8 values in f32 (at most 7 roundings of
    2^-24 of 8 x absmax a fold, n / 8 folds) before its f64 sums, the plain
    version sums in f64 alone: 7 n 2^-24 absmax for the sums, absmax^2 for
    the sums of squares. The counts and the max are exact (0)."""
    amax = float(ref[ABSMAX])
    lim = torch.zeros_like(ref, dtype=torch.float64)
    lim[SUMSQ] = lim[SUMSQ_ALL] = 7 * n * 2.0 ** -24 * amax * amax
    lim[SUM] = 7 * n * 2.0 ** -24 * amax
    lim[CHUNK0:] = lim[SUM]
    return lim


# ------------------------------------------------------------- kernels --

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("tensor_stats")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.slt_tensor_stats.argtypes = [p, i, ll, i, ctypes.c_float, ll, ll,
                                         i, p, p]
        lib.slt_tensor_stats_many.argtypes = [p, i, i, ctypes.c_float, p, p]
        lib.slt_stats_reduce.argtypes = [p, p, i, p, p]
        for fn in (lib.slt_tensor_stats, lib.slt_tensor_stats_many,
                   lib.slt_stats_reduce):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_rows(rows: torch.Tensor, need: int):
    shape = rows.shape
    if (rows.dtype is not torch.float64 or len(shape) != 2
            or shape[1] != KCOLS or shape[0] < need
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be contiguous float64 [>= {need}, "
                         f"{KCOLS}], got {rows.dtype} {list(shape)}")


def tensor_stats(x: torch.Tensor, rows: torch.Tensor, *, row0: int = 0,
                 base: int = 0, chunk: int = 0, chunks: int = 0,
                 scale: float = 1.0,
                 stream: Optional[int] = None) -> torch.Tensor:
    """Write ``x``'s statistics into ``rows[row0:row0 + grid_for(n)]``
    (``rows`` f64 ``[R, KCOLS]``, contiguous, on x's device): ``base`` is
    x's first element's index in its subtree and ``chunk`` the elements of
    each of the subtree's ``chunks`` positional chunks (0: none).
    ``stream``: the CUDA stream handle to launch on (the current stream by
    default)."""
    # The step calls this once a parameter: the checks are attribute reads.
    n = x.numel()
    grid = grid_for(n)
    if chunks and not (chunks <= MAX_CHUNKS and chunk >= 1):
        raise ValueError(f"chunks {chunks} (at most {MAX_CHUNKS}) of "
                         f"{chunk} elements")
    _check_rows(rows, row0 + grid)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"tensor_stats runs on cpu or cuda, got "
                             f"{x.device}")
        tensor_stats_reference(x, rows[row0:row0 + grid], base, chunk,
                               chunks, scale)
        return rows
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or not x.is_contiguous() or not rows.is_cuda or (
            rows.get_device() != x.get_device()):
        raise ValueError(f"tensor_stats takes a contiguous f32, bf16, f16 or "
                         f"int8 tensor and rows on its card, got {x.dtype} on "
                         f"{x.device}, rows on {rows.device}")
    if stream is None:
        stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().slt_tensor_stats(
        x.data_ptr(), code, n, grid, scale, base, chunk, chunks,
        rows.data_ptr() + row0 * KCOLS * 8, stream)
    if rc != 0:
        raise RuntimeError(f"tensor_stats kernel launch failed: CUDA error "
                           f"{rc} at n = {n}, grid {grid}")
    tensor_stats.launches += 1
    return rows


def _describe(xs: Sequence[torch.Tensor], row0s: Sequence[int],
             bases: Sequence[int], chunk_sizes: Sequence[int]) -> List[int]:
    """The many-tensor kernel's descriptors of ``xs``, six int64s each
    (pointer, n, base, chunk, first row, dtype), checked: contiguous tensors
    of the kernel's dtypes on one card, each tensor's rows right after the
    one before."""
    out, expect = [], row0s[0] if row0s else 0
    dev = xs[0].device if xs else None
    for x, r0, b, c in zip(xs, row0s, bases, chunk_sizes):
        code = _DTYPE_CODE.get(x.dtype)
        if (code is None or not x.is_contiguous() or x.device != dev
                or r0 != expect):
            raise ValueError(f"tensor_stats_many takes contiguous f32, bf16, "
                             f"f16 or int8 tensors on one card whose rows "
                             f"follow each other, got {x.dtype} on "
                             f"{x.device} at row {r0} (expected {expect})")
        out += [x.data_ptr(), x.numel(), b, c, r0, code]
        expect = r0 + grid_for(x.numel())
    return out


def tensor_stats_many(xs: Sequence[torch.Tensor], rows: torch.Tensor,
                      row0s: Sequence[int], bases: Sequence[int],
                      chunk_sizes: Sequence[int], *, chunks: int = 0,
                      scale: float = 1.0) -> torch.Tensor:
    """:func:`tensor_stats` of every tensor of ``xs`` in one launch (one per
    256 tensors): tensor j's rows start at ``row0s[j]`` (each right after
    the one before), its first element is ``bases[j]`` in its subtree, its
    subtree's chunks hold ``chunk_sizes[j]`` elements. The descriptors go
    to the card as the launch's parameters: nothing is copied first."""
    if not xs:
        return rows
    if not 0 <= chunks <= MAX_CHUNKS or (chunks and min(chunk_sizes) < 1):
        raise ValueError(f"chunks {chunks} (at most {MAX_CHUNKS})")
    _check_rows(rows, row0s[-1] + grid_for(xs[-1].numel()))
    if not xs[0].is_cuda:
        for x, r0, b, c in zip(xs, row0s, bases, chunk_sizes):
            tensor_stats(x, rows, row0=r0, base=b, chunk=c if chunks else 0,
                         chunks=chunks, scale=scale)
        return rows
    if not rows.is_cuda or rows.get_device() != xs[0].get_device():
        raise ValueError("tensor_stats_many: rows and tensors on two devices")
    desc = _describe(xs, row0s, bases, chunk_sizes)
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    for k in range(0, len(xs), MAX_MANY):
        part = desc[6 * k:6 * (k + MAX_MANY)]
        count = len(part) // 6
        rc = _lib().slt_tensor_stats_many(
            (ctypes.c_longlong * len(part))(*part), count, chunks, scale,
            rows.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"tensor_stats_many kernel launch failed: CUDA"
                               f" error {rc} at {count} tensors from "
                               f"{k}")
        tensor_stats_many.launches += 1
    return rows


def stats_reduce(rows: torch.Tensor, bounds: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """Fold groups of ``rows`` into ``out`` (f64 ``[G, KCOLS]``): group g
    is ``rows[bounds[g]:bounds[g + 1]]``, ``bounds`` int64 ``[G + 1]`` on
    the rows' device."""
    groups = len(bounds) - 1
    if tuple(out.shape) != (groups, KCOLS) or out.dtype != torch.float64:
        raise ValueError(f"out must be float64 [{groups}, {KCOLS}]")
    if rows.device.type == "cpu":
        return stats_reduce_reference(rows, bounds.tolist(), out)
    if (rows.device.type != "cuda" or out.device != rows.device
            or bounds.device != rows.device):
        raise ValueError("stats_reduce: rows, bounds and out on one card")
    if (rows.dtype != torch.float64 or bounds.dtype != torch.int64
            or not rows.is_contiguous() or not bounds.is_contiguous()
            or not out.is_contiguous() or groups < 1):
        raise ValueError("stats_reduce takes contiguous f64 rows and int64 "
                         "bounds of at least one group")
    rc = _lib().slt_stats_reduce(
        rows.data_ptr(), bounds.data_ptr(), groups, out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stats_reduce kernel launch failed: CUDA error "
                           f"{rc} at {groups} groups")
    stats_reduce.launches += 1
    return out


# Kernel launches since the last reset; chip_smoke.py zeroes them before the
# main path and reads them after, to show the path went through the kernels.
tensor_stats.launches = 0
tensor_stats_many.launches = 0
stats_reduce.launches = 0
