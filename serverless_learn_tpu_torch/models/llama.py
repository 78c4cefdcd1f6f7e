"""Llama-style causal-LM family: ``llama_tiny`` (tests), ``llama_1b`` and
``llama_8b`` (Llama-3-8B-shaped: 32 layers, 32 heads / 8 KV heads,
d_model 4096, d_ff 14336, vocab 128256, rope_theta 5e5). The presets and the
training bundle are those of ``serverless_learn_tpu/models/llama.py``:
``lora_rank > 0`` adds frozen-base LoRA adapters on the q and v projections,
and the bundle's ``trainable_mask`` confines training to them;
``n_experts > 0`` makes every MLP a mixture of experts (``ops/moe.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from serverless_learn_tpu_torch.models.registry import (
    ModelBundle, Spec, register_model, transformer_build)
from serverless_learn_tpu_torch.models.transformer import TransformerConfig
from serverless_learn_tpu_torch.ops.losses import causal_lm_loss


def _llama_cfg(size: str, **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=512, max_seq_len=512),
        "1b": dict(vocab_size=128256, d_model=2048, n_layers=16, n_heads=32,
                   n_kv_heads=8, d_ff=8192, max_seq_len=8192),
        "8b": dict(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=8192,
                   rope_theta=500000.0),
    }
    kw = dict(presets[size])
    kw.update(overrides)
    return TransformerConfig(**kw)


def lm_bundle(cfg: TransformerConfig, fused_ce: bool = False) -> ModelBundle:
    """The causal-LM training bundle: next-token loss on synthetic uniform
    tokens, plus the MoE layers' load-balance losses (the model's
    ``return_aux``, so an ``n_experts`` override keeps them; the metric
    ``moe_aux_loss`` with ``n_experts > 0``); ``fused_ce`` takes the
    cross-entropy through its kernels (K4/K5). With ``lora_rank > 0`` only the adapters train."""

    def loss_fn(model, batch, rng=None):
        logits, aux = model(batch["tokens"], return_aux=True)
        loss, metrics = causal_lm_loss(logits, batch["tokens"],
                                       fused=fused_ce)
        if cfg.n_experts > 0:
            metrics = dict(metrics, moe_aux_loss=aux)
        return loss + aux, {"metrics": metrics}

    def make_batch(rng: np.random.Generator, data_config, batch_size):
        return {"tokens": rng.integers(
            0, cfg.vocab_size, (batch_size, data_config.seq_len)).astype(
                np.int32)}

    def input_spec(data_config, batch_size):
        return {"tokens": Spec((batch_size, data_config.seq_len),
                               np.dtype(np.int32))}

    return ModelBundle(cfg=cfg, build=transformer_build(cfg),
                       loss_fn=loss_fn, make_batch=make_batch,
                       input_spec=input_spec, task="lm",
                       trainable_mask=(lora_trainable_mask
                                       if cfg.lora_rank > 0 else None))


def lora_trainable_mask(names: Iterable[str]) -> Dict[str, bool]:
    """{state-dict name: trainable}: True only on LoRA adapter tensors, the
    reference's rule (a path component that starts with ``lora_`` or ends
    with ``_lora``); the base is frozen."""
    return {n: any(k.startswith("lora_") or k.endswith("_lora")
                   for k in n.split(".")) for n in names}


@register_model("llama_tiny")
def make_llama_tiny(fused_ce=False, **overrides):
    return lm_bundle(_llama_cfg("tiny", **overrides), fused_ce=fused_ce)


@register_model("llama_1b")
def make_llama_1b(fused_ce=False, **overrides):
    return lm_bundle(_llama_cfg("1b", **overrides), fused_ce=fused_ce)


@register_model("llama_8b")
def make_llama_8b(fused_ce=False, **overrides):
    return lm_bundle(_llama_cfg("8b", **overrides), fused_ce=fused_ce)
