"""Fused softmax cross-entropy with integer labels: the port of the TPU
kernels in ``serverless_learn_tpu/ops/pallas/cross_entropy.py`` (K4 forward
``_ce_fwd``, K5 backward ``_ce_bwd_call``).

:func:`fused_cross_entropy_with_integer_labels` has the reference's
signature and meaning: logits ``[..., V]`` of any float dtype and integer
labels ``[...]`` give the per-example loss ``[...]`` in f32, ``lse - x[label]``
with the lse over the whole vocab; a label outside ``[0, V)`` picks nothing,
so its loss is the lse. It is differentiable: a ``torch.autograd.Function``
whose forward launches K4 and saves the f32 lse, and whose backward launches
K5, ``dx = (exp(x - lse) - onehot(label)) * g`` in f32, cast once to the
logits' dtype. :func:`next_token_cross_entropy` is the causal loss's form:
it reads ``logits[:, :-1]`` in place and writes dx straight into one
``[B, T, V]`` buffer whose last position it zeroes, so the step pays one dx
write (the generic function given that view would leave autograd's slice
backward to zero-fill a second ``[B, T, V]`` and copy dx into it).

On a CUDA tensor the wrappers (:func:`cross_entropy_fwd`,
:func:`cross_entropy_bwd`) launch the hand-written Hopper kernels
(``csrc/cross_entropy.cu``) or raise; the kernels take any V and any row
count, read rows through a batch stride and a row stride, and mask the
ragged vocab tail themselves, so there is no padding and no fallback. On a
CPU tensor each runs its plain PyTorch version
(:func:`cross_entropy_fwd_reference`, :func:`cross_entropy_bwd_reference`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from serverless_learn_tpu_torch.ops import build

NEG = -1e30  # the running max's start (the reference's ``_NEG``)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------- plain versions --


def _picked(xf: torch.Tensor, labels: torch.Tensor):
    """(the label's column clamped into [0, V), whether the label is in
    [0, V)), both shaped ``xf.shape[:-1] + (1,)``."""
    V = xf.shape[-1]
    lab = labels.long()[..., None]
    return lab.clamp(0, V - 1), (lab >= 0) & (lab < V)


def cross_entropy_fwd_reference(x: torch.Tensor, labels: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: (loss, lse), both f32 ``x.shape[:-1]``. x is
    upcast to f32; the max starts at -1e30 and lse = m + log(max(l, 1e-30)),
    as in the kernel; the label's logit is taken from the upcast x."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True).clamp_min(NEG)
    lse = m + torch.log(torch.exp(xf - m).sum(-1, keepdim=True)
                        .clamp_min(1e-30))
    col, ok = _picked(xf, labels)
    picked = torch.where(ok, xf.gather(-1, col), 0.0)
    return (lse - picked)[..., 0], lse[..., 0]


def cross_entropy_bwd_reference(x: torch.Tensor, labels: torch.Tensor,
                                lse: torch.Tensor, g: torch.Tensor
                                ) -> torch.Tensor:
    """K5's plain version: ``(exp(x - lse) - onehot(label)) * g`` in f32,
    cast once to x's dtype; a label outside [0, V) has no onehot."""
    p = torch.exp(x.float() - lse[..., None])
    col, ok = _picked(p, labels)
    p.scatter_add_(-1, col, -ok.float())
    return (p * g.float()[..., None]).to(x.dtype)


def fwd_tolerance(ref_lse: torch.Tensor) -> torch.Tensor:
    """The limit on |kernel - plain| of K4's loss and lse, per row: both
    are f32 sums of exps over the same V values in another order (and the
    kernel's exp is the hardware's ``ex2.approx``), so 2e-5 of (|lse| + 1);
    the label's logit is exact on both sides."""
    return 2e-5 * (ref_lse.abs() + 1)


def bwd_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The elementwise limit on |kernel - plain| of K5's dx, ``ref`` the
    plain dx. Both sides round one f32 value to the output type, and the f32
    values differ by the exps' error: bf16 2^-7 |ref| (one ulp), f32 2e-5
    |ref| (``ex2.approx`` of an argument scaled by log2(e), ~7e-6 at
    |x - lse| = 80). The floor is 2^-10 of the row's median |ref|, far
    below every value a wrong column would leave, plus 2^-126 for results
    below the smallest normal float, which either side may flush to 0. The
    limit is per element, not per row: dx is ~g/V everywhere but at the
    label (~-g), so a row-scaled limit would pass a dx that is zero off the
    label."""
    a = ref.float().abs()
    rel = 2 ** -7 if ref.dtype == torch.bfloat16 else 2e-5
    med = a.median(dim=-1, keepdim=True).values
    return rel * a + 2 ** -10 * med + 2 ** -126


# ------------------------------------------------------------- kernels --


def _lib() -> ctypes.CDLL:
    lib = build.load("cross_entropy")
    if lib.slt_ce_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.slt_ce_fwd.argtypes = [p] * 4 + [i] + [ll] * 5 + [p]
        lib.slt_ce_bwd.argtypes = [p] * 5 + [i] + [ll] * 7 + [p]
        lib.slt_ce_fwd.restype = lib.slt_ce_bwd.restype = ctypes.c_int
    return lib


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t [..., V]`` as a 3-D view ``[A, T, V]`` with unit vocab stride
    (a copy only where no such view exists); its strides ``(sa, st, 1)``
    address each row in place."""
    if t.dim() == 1:
        t = t[None, None]
    elif t.dim() == 2:
        t = t[None]
    elif t.dim() > 3:
        t = t.flatten(0, -3)
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(x: torch.Tensor, labels: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: logits must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"{what}: logits {tuple(x.shape)} have no vocab")
    if labels.shape != x.shape[:-1] or labels.is_floating_point():
        raise ValueError(f"{what}: labels {tuple(labels.shape)} "
                         f"{labels.dtype} must be integers of shape "
                         f"{tuple(x.shape[:-1])}")
    if labels.device != x.device:
        raise ValueError(f"{what}: logits and labels lie on two devices")


def _raise_on(rc: int, what: str, x3: torch.Tensor):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} at "
                           f"[A, T, V] = {list(x3.shape)}, strides "
                           f"{list(x3.stride())}")


def cross_entropy_fwd(x: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (loss, lse), f32 ``x.shape[:-1]``, from logits ``x [..., V]``
    (read in place through its strides) and integer ``labels [...]``."""
    if x.device.type == "cpu":
        return cross_entropy_fwd_reference(x, labels)
    _check(x, labels, "cross_entropy_fwd")
    lead = x.shape[:-1]
    loss = torch.empty(lead, dtype=torch.float32, device=x.device)
    lse = torch.empty(lead, dtype=torch.float32, device=x.device)
    if loss.numel() == 0:
        return loss, lse
    x3 = _as_rows(x)
    lab = labels.to(torch.int32).contiguous()
    A, T, V = x3.shape
    rc = _lib().slt_ce_fwd(
        x3.data_ptr(), lab.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[x.dtype], A, T, V, x3.stride(0), x3.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "cross-entropy forward", x3)
    cross_entropy_fwd.launches += 1
    return loss, lse


def cross_entropy_bwd(x: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: dx in x's dtype and shape from logits ``x [..., V]``, labels, the
    forward's f32 ``lse [...]`` and the loss cotangent ``g [...]`` (any
    strides, an expanded one included). ``out``, where given, is written in
    place through its own strides (a slice of a larger buffer) and
    returned."""
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        dx = cross_entropy_bwd_reference(x, labels, lse, g)
        return dx if out is None else out.copy_(dx)
    _check(x, labels, "cross_entropy_bwd")
    lead = x.shape[:-1]
    if lse.shape != lead or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(lead)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format) \
        if out is None else out
    if dx.numel() == 0:
        return dx
    x3, d3 = _as_rows(x), _as_rows(dx)
    if d3.data_ptr() != dx.data_ptr() or d3.shape != x3.shape:
        raise ValueError("out must have a unit vocab stride and a 3-D view")
    lab = labels.to(torch.int32).contiguous()
    lse = lse.contiguous()
    # g from .mean()'s backward is expanded with stride 0: make it [N].
    gc = g.to(torch.float32).expand(lead).contiguous()
    A, T, V = x3.shape
    rc = _lib().slt_ce_bwd(
        x3.data_ptr(), lab.data_ptr(), lse.data_ptr(), gc.data_ptr(),
        d3.data_ptr(), _DTYPE_CODE[x.dtype], A, T, V, x3.stride(0),
        x3.stride(1), d3.stride(0), d3.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "cross-entropy backward", x3)
    cross_entropy_bwd.launches += 1
    return dx


# Kernel launches since the last reset; chip_smoke.py zeroes them before the
# main path and reads them after, to show the path went through the kernels.
cross_entropy_fwd.launches = 0
cross_entropy_bwd.launches = 0


# ------------------------------------------------------------- autograd --


class _CrossEntropy(torch.autograd.Function):
    """Loss of ``logits[:, :used]`` (``logits [A, T, V]``) against
    ``labels [A, used]``; dx is written into one ``[A, T, V]`` buffer whose
    positions ``>= used`` are zero."""

    @staticmethod
    def forward(ctx, logits, labels, used):
        loss, lse = cross_entropy_fwd(logits[:, :used], labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.used = used
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        used = ctx.used
        dx = torch.empty_like(logits, memory_format=torch.contiguous_format)
        dx[:, used:].zero_()
        cross_entropy_bwd(logits[:, :used], labels, lse, g,
                          out=dx[:, :used])
        return dx, None, None


def fused_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                            labels: torch.Tensor
                                            ) -> torch.Tensor:
    """Per-example loss ``[...]`` (f32) of logits ``[..., V]`` against
    integer labels ``[...]``: the reference's drop-in for
    ``optax.softmax_cross_entropy_with_integer_labels``, streaming the vocab
    through K4 (forward) and K5 (backward) instead of materialising f32
    probabilities. Any V and any number of rows; no padding."""
    lead = logits.shape[:-1]
    x3 = _as_rows(logits)
    loss = _CrossEntropy.apply(x3, labels.reshape(x3.shape[:-1]),
                               x3.shape[1])
    return loss.reshape(lead)


def next_token_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor
                             ) -> torch.Tensor:
    """The causal loss's per-position cross-entropy ``[B, T - 1]``:
    ``logits[:, :-1]`` (``[B, T, V]``, read in place) against
    ``tokens[:, 1:]``. The same as
    ``fused_cross_entropy_with_integer_labels(logits[:, :-1], tokens[:,
    1:])``, but dx goes straight into a ``[B, T, V]`` buffer (the last
    position zeroed), one write of the logits' size."""
    if logits.dim() != 3 or tokens.shape != logits.shape[:2]:
        raise ValueError(f"logits {tuple(logits.shape)} and tokens "
                         f"{tuple(tokens.shape)}: expected [B, T, V], [B, T]")
    if logits.stride(-1) != 1:
        logits = logits.contiguous()
    return _CrossEntropy.apply(logits, tokens[:, 1:], logits.shape[1] - 1)
