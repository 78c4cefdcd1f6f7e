"""Loss functions, the port of ``serverless_learn_tpu/ops/losses.py`` for
the causal-LM path. Losses compute in f32 whatever the logits' dtype."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from serverless_learn_tpu_torch.ops.cross_entropy import (
    next_token_cross_entropy)


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
