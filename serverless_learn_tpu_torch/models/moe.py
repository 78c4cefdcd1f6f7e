"""Mixture-of-experts causal-LM family, the port of ``serverless_learn_tpu/
models/moe.py``: ``moe_tiny`` (tests) and ``moe_mixtral_8x7b``
(Mixtral-8x7B-shaped: 32 layers of 8 SwiGLU experts, top-2, d_model 4096,
d_ff 14336, 32 heads / 8 KV heads, vocab 32,000, rope_theta 1e6; 46.6 B
weights). Its bundle is the causal-LM one (``models/llama.lm_bundle``):
cross-entropy plus the routers' load-balance losses, and the metric
``moe_aux_loss``.
"""

from __future__ import annotations

from serverless_learn_tpu_torch.models.llama import lm_bundle
from serverless_learn_tpu_torch.models.registry import register_model
from serverless_learn_tpu_torch.models.transformer import TransformerConfig


def _moe_cfg(size: str, **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=256, max_seq_len=512, n_experts=4,
                     moe_top_k=2),
        "mixtral_8x7b": dict(vocab_size=32000, d_model=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, d_ff=14336,
                             max_seq_len=8192, n_experts=8, moe_top_k=2,
                             rope_theta=1000000.0),
    }
    kw = dict(presets[size])
    kw.update(overrides)
    return TransformerConfig(**kw)


@register_model("moe_tiny")
def make_moe_tiny(fused_ce=False, **overrides):
    return lm_bundle(_moe_cfg("tiny", **overrides), fused_ce=fused_ce)


@register_model("moe_mixtral_8x7b")
def make_moe_mixtral(fused_ce=False, **overrides):
    return lm_bundle(_moe_cfg("mixtral_8x7b", **overrides), fused_ce=fused_ce)
