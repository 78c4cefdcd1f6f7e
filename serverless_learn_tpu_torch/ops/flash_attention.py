"""Flash attention, forward and backward: the port of the TPU kernels in
``serverless_learn_tpu/ops/pallas/flash_attention.py`` (K1 forward, K2 dq,
K3 dk/dv).

:func:`flash_attention` takes the reference's layout, q ``[B, T, H, D]`` and
k/v ``[B, S, K, D]`` with ``H % K == 0``, and is differentiable: a
``torch.autograd.Function`` whose forward launches K1 and saves q, k, v, out
and the f32 lse (as ``_flash_core_fwd`` does), and whose backward computes
``delta = rowsum(dO * out)`` in f32 and launches K2 and K3.

On a CUDA tensor every wrapper here (:func:`flash_fwd`, :func:`flash_dq`,
:func:`flash_dkv`) launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises; there is no fallback, and ragged
T and S are masked inside the kernels. On a CPU tensor each runs its plain
PyTorch version (:func:`flash_fwd_reference`, :func:`flash_dq_reference`,
:func:`flash_dkv_reference`),
which repeats the kernels' arithmetic: scores in f32 scaled by ``D**-0.5``,
masked scores at -1e30 with zero probability, p rounded to the input dtype
before ``p @ v`` and ds before ``ds @ k``, every sum in f32.

Masks: ``kv_lengths`` [B] ("len": suffix padding; keys AND queries at
positions >= the length are padding) or a ``[B, S]`` / ``[B, 1, 1, S]``
integer or bool key mask ("rows", nonzero = attend). A padding query of
"len" mode gets out = 0 and no gradient here, whatever tile it falls in;
the reference zeroes the padding queries of fully padded blocks and
computes the rest, and no caller reads either (the loss masks them).
Ring attention's "klen" mode and ``flash_with_lse_bhsd`` are not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from serverless_learn_tpu_torch.ops import build

NEG = -1e30  # the mask floor of the reference (``_NEG``)
HEAD_DIMS = (32, 64, 128)  # head dims the kernels are built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MODE_CODE = {"none": 0, "len": 1, "rows": 2}


# ----------------------------------------------------------------- masks --


def as_kv_mask(mask: Optional[torch.Tensor], B: int, S: int
               ) -> Optional[torch.Tensor]:
    """A ``[B, S]`` or ``[B, 1, 1, S]`` integer or bool key mask as int32
    ``[B, S]``; None for any other form (a float mask may be additive, the
    opposite contract), as the reference's ``as_kv_mask``."""
    if mask is None or mask.is_floating_point():
        return None
    if mask.shape == (B, S):
        return mask.to(torch.int32).contiguous()
    if mask.shape == (B, 1, 1, S):
        return mask[:, 0, 0, :].to(torch.int32).contiguous()
    return None


def _valid(B: int, T: int, S: int, causal: bool, mode: str,
           arg: Optional[torch.Tensor], device) -> torch.Tensor:
    """[B or 1, 1, T, S] bool: whether query t may attend to key s."""
    t = torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :]
    ok = torch.ones(1, 1, T, S, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (s <= t)
    if mode == "len":
        n = arg.to(device).long()[:, None, None, None]
        ok = ok & (s < n) & (t < n)
    elif mode == "rows":
        ok = ok & (arg.to(device) != 0)[:, None, None, :]
    return ok


def _scores(q, k, scale, valid):
    """f32 scores [B, H, T, S] of q [B,T,H,D] against k [B,S,K,D], each q
    head reading K/V head h // (H // K); masked entries at NEG."""
    H, K = q.shape[2], k.shape[2]
    kf = k.float().repeat_interleave(H // K, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * scale
    return s.masked_fill(~valid, NEG)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


# ------------------------------------------------------- plain versions --


def flash_fwd_reference(q, k, v, *, causal: bool, mode: str = "none",
                        arg: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version: (out [B, T, H, D] in q's dtype, lse [B, H, T]
    f32). The kernel rounds p relative to each tile's running max, this
    version relative to the row's final max: in bf16 the two round p at
    different points, in f32 they differ only in the order of the sums."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    valid = _valid(B, T, S, causal, mode, arg, q.device)
    s = _scores(q, k, D ** -0.5, valid)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vf = v.float().repeat_interleave(H // K, dim=2)
    out = torch.einsum("bhts,bshd->bthd", _round(p, v.dtype), vf)
    out = out / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _bwd_p_ds(q, k, v, dout, lse, delta, causal, mode, arg):
    """p = exp(s - lse) (0 where masked) and ds = p (dp - delta) scale
    rounded to q's dtype, both f32 [B, H, T, S]: what K2 and K3 each
    recompute from the saved lse."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = D ** -0.5
    valid = _valid(B, T, S, causal, mode, arg, q.device)
    s = _scores(q, k, scale, valid)
    p = torch.where(s <= NEG * 0.5, 0.0, torch.exp(s - lse[..., None]))
    vf = v.float().repeat_interleave(H // K, dim=2)
    dp = torch.einsum("bthd,bshd->bhts", dout.float(), vf)
    return p, _round(p * (dp - delta[..., None]) * scale, q.dtype)


def flash_dq_reference(q, k, v, dout, lse, delta, *, causal: bool,
                       mode: str = "none",
                       arg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's plain version: dq = ds @ k in f32, from q, k, v, dO, the
    forward's lse [B, H, T] and delta = rowsum(dO * out) [B, H, T]."""
    H, K = q.shape[2], k.shape[2]
    _, ds = _bwd_p_ds(q, k, v, dout, lse, delta, causal, mode, arg)
    kf = k.float().repeat_interleave(H // K, dim=2)
    return torch.einsum("bhts,bshd->bthd", ds, kf).to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, *, causal: bool,
                        mode: str = "none",
                        arg: Optional[torch.Tensor] = None):
    """K3's plain version: dk = ds^T q and dv = p^T dO (p rounded to dO's
    dtype) per q head in f32, summed over each K/V head's group."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    p, ds = _bwd_p_ds(q, k, v, dout, lse, delta, causal, mode, arg)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dv = torch.einsum("bhts,bthd->bshd", _round(p, dout.dtype), dout.float())
    dk = dk.reshape(B, S, K, H // K, D).sum(3)
    dv = dv.reshape(B, S, K, H // K, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def kernel_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The elementwise limit on |kernel - plain| for ``ref``, an output of a
    plain version (out, dq ``[B, T, H, D]``; dk, dv ``[B, S, K, D]``). Its
    absolute term follows each row's own largest value over D, not the
    tensor's, so a wrong tile in a row of small values still fails.

    float32: only the order of the f32 sums differs, 1e-5 of the value
    plus 1e-5 of its row's largest. bfloat16: both sides round the result
    to bf16 (one ulp, at most 2^-7 of the value), and K1 rounds each p to
    bf16 against its tile's running max where the plain version uses the
    row's final max, so every p of a row moves by up to 2^-8 of itself on
    either side: 2^-7 of the value plus 2^-6 of its row's largest (about
    three times the worst such drift of a 4096-key row,
    ``tests/test_torch_flash_attention.py``). Both add 2^-16 of the
    tensor's largest value for rows that cancel to about zero: dq of the
    first causal query is ``p (dp - delta)`` with dp and delta the same
    f32 products summed in other orders."""
    a = ref.float().abs()
    row = a.amax(dim=-1, keepdim=True)
    floor = 2 ** -16 * a.max()
    if ref.dtype == torch.float32:
        return 1e-5 * (a + row) + floor
    return 2 ** -7 * a + 2 ** -6 * row + floor


# ------------------------------------------------------------- kernels --


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.slt_flash_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # tensors..., dtype B T S H KH D causal mask_mode, scale, stream
        tail = [i] * 9 + [f, p]
        lib.slt_flash_fwd.argtypes = [p] * 6 + tail
        lib.slt_flash_dq.argtypes = [p] * 8 + tail
        lib.slt_flash_dkv.argtypes = [p] * 9 + tail
        for fn in (lib.slt_flash_fwd, lib.slt_flash_dq, lib.slt_flash_dkv):
            fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, arg, mode):
    """Raise on what the kernels do not take; returns the shape tuple."""
    B, T, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [B,T,H,D], [B,S,K,D]")
    S, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv heads")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernels are built for "
                         f"{HEAD_DIMS}")
    if T == 0 or S == 0:
        raise ValueError("flash attention needs T >= 1 and S >= 1")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned (16-byte loads)")
    want = {"len": (B,), "rows": (B, S)}.get(mode)
    if want is not None and (arg is None or tuple(arg.shape) != want
                             or arg.dtype != torch.int32):
        raise ValueError(f"mask mode {mode!r} takes int32 {want}")
    return B, T, S, H, K, D


def _check_bwd(q, dout, lse, delta):
    B, T, H, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dO {tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if dout.data_ptr() % 16:
        raise ValueError("dO must be 16-byte aligned (16-byte loads)")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(B, H, T)}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _ptrs(*ts):
    for t in ts:
        if t is None:
            continue
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("flash kernels take contiguous CUDA tensors")
    return [None if t is None else t.data_ptr() for t in ts]


def _raise_on(rc: int, what: str, shape):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} at "
                           f"B, T, S, H, K, D = {shape}")


def flash_fwd(q, k, v, *, causal: bool, mode: str = "none",
              arg: Optional[torch.Tensor] = None):
    """K1: (out [B, T, H, D], lse [B, H, T] f32)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, mode=mode, arg=arg)
    shape = _check(q, k, v, arg, mode)
    B, T, S, H, K, D = shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _lib().slt_flash_fwd(
        *_ptrs(q, k, v, out, lse, arg), _DTYPE_CODE[q.dtype], B, T, S, H, K,
        D, int(causal), _MODE_CODE[mode], D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash forward", shape)
    flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal: bool, mode: str = "none",
             arg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: dq [B, T, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, delta, causal=causal,
                                  mode=mode, arg=arg)
    shape = _check(q, k, v, arg, mode)
    _check_bwd(q, dout, lse, delta)
    B, T, S, H, K, D = shape
    dq = torch.empty_like(q)
    rc = _lib().slt_flash_dq(
        *_ptrs(q, k, v, dout, lse, delta, dq, arg), _DTYPE_CODE[q.dtype], B,
        T, S, H, K, D, int(causal), _MODE_CODE[mode], D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash dq", shape)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal: bool, mode: str = "none",
              arg: Optional[torch.Tensor] = None):
    """K3: (dk, dv) [B, S, K, D] in k's dtype, summed over each K/V head's
    group of q heads inside the kernel."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, delta, causal=causal,
                                   mode=mode, arg=arg)
    shape = _check(q, k, v, arg, mode)
    _check_bwd(q, dout, lse, delta)
    B, T, S, H, K, D = shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _lib().slt_flash_dkv(
        *_ptrs(q, k, v, dout, lse, delta, dk, dv, arg), _DTYPE_CODE[q.dtype],
        B, T, S, H, K, D, int(causal), _MODE_CODE[mode], D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash dkv", shape)
    flash_dkv.launches += 1
    return dk, dv


# Kernel launches since the last reset; chip_smoke.py zeroes them before the
# main path and reads them after, to show the path went through the kernels.
flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# ------------------------------------------------------------- autograd --


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, arg, causal, mode):
        out, lse = flash_fwd(q, k, v, causal=causal, mode=mode, arg=arg)
        ctx.save_for_backward(q, k, v, out, lse, arg)
        ctx.causal, ctx.mode = causal, mode
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, arg = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
        delta = delta.contiguous()
        kw = dict(causal=ctx.causal, mode=ctx.mode, arg=arg)
        dq = flash_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    kv_lengths: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Flash attention in the reference's ``[B, T, H, D]`` layout; GQA K/V
    heads are read in place, never expanded. ``kv_lengths`` [B] is suffix
    padding (keys and queries past it are padding); ``mask`` a ``[B, S]`` or
    ``[B, 1, 1, S]`` integer/bool key mask. Any other mask form raises:
    there is no dense fallback (``ops.attention.dot_product_attention``
    with ``impl="xla"`` takes general masks)."""
    B, S = k.shape[0], k.shape[1]
    if kv_lengths is not None:
        mode, arg = "len", kv_lengths.to(torch.int32).contiguous()
    elif mask is not None:
        mode, arg = "rows", as_kv_mask(mask, B, S)
        if arg is None:
            raise ValueError(f"flash_attention takes a [B, S] or [B, 1, 1, S] "
                             f"integer/bool key mask, got {tuple(mask.shape)} "
                             f"{mask.dtype}")
    else:
        mode, arg = "none", None
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), arg, causal, mode)
