"""Weight-only int8 matmul: ``x [..., I] @ wq [I, O] * scale [O]``.

The port of the TPU kernel in ``serverless_learn_tpu/ops/pallas/
quant_matmul.py``. On a CUDA tensor :func:`quant_matmul` always launches the
hand-written Hopper kernel (``csrc/quant_matmul.cu``); a build or launch
failure raises. On a CPU tensor it runs :func:`quant_matmul_reference`, the
plain PyTorch version with the same casts, which the tests and
``chip_smoke.py`` hold the kernel against. :class:`QuantMatmul` gives it
a gradient for the activations (QLoRA trains adapters through the frozen
int8 base); it is the models' entry point, in training and serving.

:func:`plan` is the one place that picks the kernel's tiling (decode with
one n8 tile of x's rows up to 8 rows, two up to 16; above, the ``prefill``
tiling on wgmma fed by TMA wherever TMA can describe the operands, else
``prefill_mma``) and how the contraction is split across blocks; the
wrapper passes both to the kernel. The split partials go to an f32
workspace of a fixed size that the wrapper allocates once for each stream
and keeps, so a call allocates nothing but its output (and, under the
``prefill`` tiling, a bf16 copy of an f32 x): a decode forward makes 225
calls of a few microseconds of device time each, and the host's time for a
call is what an eager forward waits on.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from serverless_learn_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# csrc/quant_matmul.cu's tile geometry, which plan() counts blocks with
# (checked against the built kernel's on loading).
DECODE_MAX_ROWS = 16  # R <= 16: the split-K decode kernel; above: prefill
TILE_COLS = 128       # output columns a block owns: decode, prefill_mma
PREFILL_TILE_ROWS = 128  # x rows a block owns, both prefill tilings
PREFILL_TILE_COLS = 256  # output columns a block owns: prefill (wgmma)
STEP_ROWS = 64        # contraction rows a stage, every tiling
# Blocks to aim for (H100 SXM: 132 SMs): decode blocks are small (4 warps,
# 38-43 KB of shared memory) and stream bytes, so about four an SM; a
# prefill block (three warpgroups, 193 KB) fills an SM, so one full wave;
# prefill_mma blocks fit two an SM.
TARGET_BLOCKS = {"decode": 4 * 132, "prefill": 132, "prefill_mma": 2 * 132}
# The kernel's tilings, by the code its entry point takes.
TILINGS = {"decode_n8": 0, "decode_n16": 1, "prefill": 2, "prefill_mma": 3}
# (rows, columns) of a tiling's output tile.
_TILE = {"decode": (DECODE_MAX_ROWS, TILE_COLS),
         "prefill": (PREFILL_TILE_ROWS, PREFILL_TILE_COLS),
         "prefill_mma": (PREFILL_TILE_ROWS, TILE_COLS)}
# The most f32 partials a split plan writes: with more than one split,
# splits * tiles <= TARGET_BLOCKS, and a tile covers at most its tiling's
# rows and columns, so splits * R * O stays under this (17.3 MB).
WORKSPACE_FLOATS = max(TARGET_BLOCKS[k] * r * c for k, (r, c) in _TILE.items())


# What slt_quant_matmul_geometry reports, in its order.
GEOMETRY = (TILE_COLS, STEP_ROWS, PREFILL_TILE_ROWS, DECODE_MAX_ROWS,
            PREFILL_TILE_COLS)


class Plan(NamedTuple):
    tiling: str   # a key of TILINGS
    k_split: int  # contraction rows a split, a multiple of STEP_ROWS
    splits: int   # ceil(I / k_split); above 1 the partials go through f32

    @property
    def path(self) -> str:
        return "decode" if self.tiling.startswith("decode") else "prefill"


def tma_shapes(I: int, O: int) -> bool:
    """Whether TMA can describe x [R, I] bf16 and wq [I, O] int8: each row
    a multiple of 16 bytes."""
    return I % 8 == 0 and O % 16 == 0


@functools.lru_cache(maxsize=256)
def plan(R: int, I: int, O: int) -> Plan:
    """The kernel's tiling for R rows and the operands' shapes, and the
    split of I across blocks that brings the blocks of an [R, I] x [I, O]
    product up to, not past, TARGET_BLOCKS (past it, a partial second wave
    of blocks costs more than the split saves)."""
    if R > DECODE_MAX_ROWS:
        tiling = "prefill" if tma_shapes(I, O) else "prefill_mma"
    else:
        tiling = "decode_n8" if R <= 8 else "decode_n16"
    kind = "decode" if tiling.startswith("decode") else tiling
    rows, cols = _TILE[kind]
    tiles = math.ceil(O / cols)
    if kind != "decode":
        tiles *= math.ceil(R / rows)
    steps = math.ceil(I / STEP_ROWS)
    want = min(steps, max(1, TARGET_BLOCKS[kind] // tiles))
    k_split = math.ceil(steps / want) * STEP_ROWS
    pl = Plan(tiling, k_split, math.ceil(I / k_split))
    if pl.splits > 1 and pl.splits * R * O > WORKSPACE_FLOATS:
        raise AssertionError(f"{pl} at R={R} I={I} O={O} outgrows the "
                             f"workspace of {WORKSPACE_FLOATS} floats")
    return pl


def quant_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """x rounded to bf16 and int8 weights widened to bf16, products summed
    in f32, the f32 scale applied to the sum, then cast to ``out_dtype``.
    bf16 x int8 products are exact in f32, so this differs from the kernel
    only in the order of the f32 sums."""
    out_dtype = out_dtype or x.dtype
    xf = x.to(torch.bfloat16).to(torch.float32)
    y = xf @ wq.to(torch.bfloat16).to(torch.float32)
    return (y * scale.to(torch.float32)).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("quant_matmul")
    geometry = (ctypes.c_int * 5)()
    lib.slt_quant_matmul_geometry(geometry)
    if tuple(geometry) != GEOMETRY:
        raise RuntimeError(f"csrc/quant_matmul.cu's tiles {tuple(geometry)} "
                           f"are not the {GEOMETRY} that plan() counts with")
    fn = lib.slt_quant_matmul
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, ll, ll, ll, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


# The current stream's handle without building a torch.cuda.Stream (a
# private call that PyTorch's own generated code uses), where it exists.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# (device, stream) -> (workspace, its address): one a stream, so calls on
# one stream, graph replays included, use theirs in launch order.
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
# A split call is two launches, the split kernel then the reduce, and the
# foreign call releases the GIL: the lock keeps another thread's call on
# the same stream from landing between them and overwriting the partials.
_launch_lock = threading.Lock()


def _workspace(device: int, stream: int) -> int:
    found = _workspaces.get((device, stream))
    if found is None:
        ws = torch.empty(WORKSPACE_FLOATS, dtype=torch.float32,
                         device=torch.device("cuda", device))
        found = _workspaces[(device, stream)] = (ws, ws.data_ptr())
    return found[1]


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., I]`` (bf16 or f32) times int8 ``wq [I, O]`` times f32
    ``scale [O]`` -> ``[..., O]`` in x's dtype; ``out_dtype``, where given,
    must be that dtype."""
    if out_dtype is not None and out_dtype != x.dtype:
        raise TypeError(f"quant_matmul returns x's dtype {x.dtype}, not "
                        f"{out_dtype}")
    if x.is_cpu:
        return quant_matmul_reference(x, wq, scale, x.dtype)
    if not x.is_cuda:
        raise ValueError(f"quant_matmul runs on cpu or cuda, got {x.device}")
    I, O = wq.shape
    if x.shape[-1] != I or scale.shape != (O,):
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"scale {tuple(scale.shape)} do not match")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"wq must be int8 and scale float32, got {wq.dtype}, "
                        f"{scale.dtype}")
    dev = x.get_device()
    if wq.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, wq and scale must lie on one device")
    if not (wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("wq and scale must be contiguous")
    if not x.is_contiguous():
        x = x.contiguous()
    R = x.numel() // I if I else 0
    out = x.new_empty(x.shape[:-1] + (O,))
    pl = plan(R, I, O)
    xk = x
    if pl.tiling == "prefill":
        # The wgmma tiling reads a bf16 x through TMA: an f32 x is rounded
        # first, the reference's own first step, and TMA wants a 16-byte
        # aligned base.
        if xk.dtype != torch.bfloat16:
            xk = xk.to(torch.bfloat16)
        if xk.data_ptr() % 16:
            xk = xk.clone()
    stream = (_raw_stream(dev) if _raw_stream is not None
              else torch.cuda.current_stream(dev).cuda_stream)
    kernel = _kernel()
    with _launch_lock:
        rc = kernel(
            xk.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _workspace(dev, stream) if pl.splits > 1 else None, code,
            TILINGS[pl.tiling], R, I, O, pl.k_split, dev, stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}"
                           f" at R={R} I={I} O={O} ({pl})")
    quant_matmul.launches += 1
    quant_matmul.tilings[pl.tiling] += 1
    return out


# Kernel launches since the last reset, in all and by tiling; chip_smoke.py
# zeroes them before the main path and reads them after, to show the path
# went through the kernel and which of its tilings.
quant_matmul.launches = 0
quant_matmul.tilings = dict.fromkeys(TILINGS, 0)


class QuantMatmul(torch.autograd.Function):
    """:func:`quant_matmul` with a gradient for ``x``, as the JAX package
    differentiates its QLoRA forward ``tensordot(x, wq.astype(x.dtype)) *
    scale.astype(x.dtype)``: ``g = dy * scale`` and ``dx = g @ wq^T``,
    both in x's dtype, the weight converted for the product (the reference
    computes it outside any Pallas kernel too). ``wq`` and ``scale`` get no
    gradient. Only the two weights are saved, no activation, so a
    recomputed block (remat) keeps nothing of its own. The forward is
    :func:`quant_matmul`: the kernel on a CUDA tensor, the plain version on
    a CPU one. Under ``no_grad`` or ``inference_mode`` (serving) it records
    no graph."""

    @staticmethod
    def forward(ctx, x, wq, scale):
        ctx.save_for_backward(wq, scale)
        return quant_matmul(x, wq, scale)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        wq, scale = ctx.saved_tensors  # under remat: the block's recompute
        # The profiler range chip_smoke.py reads dx's time from.
        with torch.profiler.record_function("quant_matmul_dx"):
            g = dy * scale.to(dy.dtype)
            return g @ wq.to(dy.dtype).t(), None, None

