"""Loss functions, the port of ``serverless_learn_tpu/ops/losses.py`` for
the causal-LM path. Losses compute in f32 whatever the logits' dtype."""

from __future__ import annotations

import torch
from torch.nn import functional as F

FUSED_CE_NOT_PORTED = ("fused cross-entropy (the Pallas kernels K4/K5 of "
                       "ops/pallas/cross_entropy.py) is not yet ported to "
                       "PyTorch (ROADMAP.md queue 2); drop "
                       "model_overrides.fused_ce")


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   fused: bool = False):
    """Next-token loss: logits [B, T, V] predict tokens[:, 1:]. Returns
    (mean loss, {"perplexity": exp(loss)})."""
    if fused:
        raise NotImplementedError(FUSED_CE_NOT_PORTED)
    V = logits.shape[-1]
    targets = tokens[:, 1:].reshape(-1).long()
    loss = F.cross_entropy(logits[:, :-1].float().reshape(-1, V), targets)
    return loss, {"perplexity": torch.exp(loss)}
