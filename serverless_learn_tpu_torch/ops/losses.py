"""Loss functions, the port of ``serverless_learn_tpu/ops/losses.py``:
classification, masked-LM and causal-LM losses. Each computes in f32
whatever the logits' dtype."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from serverless_learn_tpu_torch.ops.cross_entropy import (
    next_token_cross_entropy)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Classification loss: logits [B, C], labels [B]. Returns (mean loss,
    {"accuracy": the share of rows whose argmax is the label})."""
    logits = logits.float()
    loss = F.cross_entropy(logits, labels.long())
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"accuracy": acc}


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor):
    """MLM loss: logits [B, T, V], labels [B, T], mask [B, T] (1 where
    masked). The loss and the ``accuracy`` metric are sums over the masked
    positions divided by ``max(mask.sum(), 1)``, so a batch with nothing
    masked gives 0, not NaN."""
    logits = logits.float()
    V = logits.shape[-1]
    raw = F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1).long(),
                          reduction="none").reshape(labels.shape)
    mask = mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (raw * mask).sum() / denom
    acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / denom
    return loss, {"accuracy": acc}


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   fused: bool = False):
    """Next-token loss: logits [B, T, V] predict tokens[:, 1:]. Returns
    (mean loss, {"perplexity": exp(loss)}). ``fused=True`` streams the
    vocab through the cross-entropy kernels (``ops/cross_entropy.py``, K4
    and K5) instead of materialising f32 logits and probabilities."""
    if fused:
        loss = next_token_cross_entropy(logits, tokens).mean()
    else:
        V = logits.shape[-1]
        targets = tokens[:, 1:].reshape(-1).long()
        loss = F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                               targets)
    return loss, {"perplexity": torch.exp(loss)}
