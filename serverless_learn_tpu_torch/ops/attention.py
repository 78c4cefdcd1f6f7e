"""Attention ops, the port of ``serverless_learn_tpu/ops/attention.py``.

:func:`dot_product_attention` dispatches between the dense
:func:`xla_attention` and the flash kernels (``ops/flash_attention.py``)
with the reference's ``impl="auto"`` policy. Serving runs prefill and decode
on the dense form only, as the reference does; training's causal
self-attention takes flash at long sequences.
"""

from __future__ import annotations

from typing import Optional

import torch

from serverless_learn_tpu_torch.ops.flash_attention import flash_attention

# The reference's thresholds for impl="auto", kept as they are. They were
# measured on a TPU v5e, not on an H100; the card's own crossover is not
# measured yet (PERF.md).
AUTO_FLASH_MIN_SEQ = 4096
AUTO_FLASH_MIN_SEQ_LENGTHS = 512
RING_NOT_PORTED = ("ring attention (sequence parallelism over an sp mesh "
                   "axis) is not yet ported to PyTorch (ROADMAP.md queue 1 "
                   "item 5)")


def _causal_mask(q_len: int, kv_len: int, device) -> torch.Tensor:
    # q positions are the last q_len of kv_len.
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """q [B, T, H, D], k/v [B, S, K, D] with H % K == 0 (grouped-query heads
    read their K/V head without expanding it); mask broadcastable to
    [B, 1, T, S], nonzero = keep. Returns [B, T, H, D] in q's dtype.

    As in the reference: QK^T is rounded to the input dtype and scaled there,
    the softmax runs in f32 with masked scores at the f32 minimum (not -inf,
    so a fully masked row stays finite), and the probabilities are cast back
    to the input dtype before PV."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = D ** -0.5
    group = H // K
    qg = q.reshape(B, T, K, group, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
    scores = scores.reshape(B, H, T, S).to(torch.float32)
    neg = torch.finfo(torch.float32).min
    if causal:
        cm = _causal_mask(T, S, q.device)
        scores = scores.masked_fill(~cm[None, None], neg)
    if mask is not None:
        scores = scores.masked_fill(~mask.to(torch.bool), neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.reshape(B, K, group, T, S), v)
    return out.reshape(B, T, H, D)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          kv_lengths: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """q [B, T, H, D], k/v [B, S, K, D]. ``impl``: "auto" takes flash at
    T >= 4096, or at T >= 512 when ``kv_lengths`` (suffix padding) is given,
    and the dense form below that; "xla" (dense), "flash" (the kernels) or
    "ring" (not ported: raises). ``kv_lengths`` alone also masks the dense
    form, as in the reference."""
    if impl == "auto":
        T = q.shape[1]
        if kv_lengths is not None:
            impl = "flash" if T >= AUTO_FLASH_MIN_SEQ_LENGTHS else "xla"
        else:
            impl = "flash" if T >= AUTO_FLASH_MIN_SEQ else "xla"
    if impl == "xla":
        if kv_lengths is not None and mask is None:
            S = k.shape[1]
            mask = (torch.arange(S, device=q.device)[None, :]
                    < kv_lengths.to(q.device)[:, None])[:, None, None, :]
        return xla_attention(q, k, v, causal=causal, mask=mask)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, mask=mask,
                               kv_lengths=kv_lengths)
    if impl == "ring":
        raise NotImplementedError(RING_NOT_PORTED)
    raise ValueError(f"unknown attention impl {impl!r}")
