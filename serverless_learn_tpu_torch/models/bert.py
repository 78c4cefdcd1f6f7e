"""The BERT-style masked-LM family, the port of ``serverless_learn_tpu/
models/bert.py``: ``bert_tiny`` (tests) and ``bert_base`` (12 layers, 12
heads, d_model 768, d_ff 3072, vocab 30,522, 512 positions). The model is
the transformer's BERT form (``causal=False``, learned positions,
LayerNorm, GeLU, an untied ``lm_head``) with ``suffix_padding_mask``: the
batch's ``attn_mask`` is suffix padding, so from T = 512 attention runs the
flash kernels K1-K3 in "len" mode.
"""

from __future__ import annotations

import numpy as np

from serverless_learn_tpu_torch.models.registry import (
    ModelBundle, Spec, register_model, transformer_build)
from serverless_learn_tpu_torch.models.transformer import TransformerConfig
from serverless_learn_tpu_torch.ops.losses import masked_lm_loss

MASK_TOKEN = 1  # the synthetic vocabulary's: 0 = pad, 1 = [MASK]
INPUTS = ("tokens", "labels", "mlm_mask", "attn_mask")


def _bert_cfg(size: str, **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(d_model=128, n_layers=2, n_heads=2, d_ff=512),
        "base": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072),
    }
    kw = dict(vocab_size=30522, max_seq_len=512, causal=False,
              use_rope=False, norm="layer", activation="gelu",
              tie_embeddings=False, suffix_padding_mask=True)
    kw.update(presets[size])
    kw.update(overrides)
    return TransformerConfig(**kw)


def _bundle(cfg: TransformerConfig, mask_rate: float = 0.15) -> ModelBundle:
    def loss_fn(model, batch, rng=None):
        """The masked-LM loss plus, under an ``n_experts`` override, the
        routers' load-balance losses (metric ``moe_aux_loss``).
        ``loss_weight`` is the masked-token count the loss divided by:
        gradient accumulation weights each microbatch by it, which gives the
        whole batch's gradient exactly (the aux term rides the same weights,
        so under accumulation its gradient is approximate, as in the
        reference)."""
        logits, aux = model(batch["tokens"],
                            mask=batch["attn_mask"][:, None, None, :],
                            return_aux=True)
        loss, metrics = masked_lm_loss(logits, batch["labels"],
                                       batch["mlm_mask"])
        if cfg.n_experts > 0:
            metrics = dict(metrics, moe_aux_loss=aux)
        weight = batch["mlm_mask"].float().sum().clamp_min(1.0)
        return loss + aux, {"metrics": metrics, "loss_weight": weight}

    def input_spec(data_config, batch_size):
        return {name: Spec((batch_size, data_config.seq_len),
                           np.dtype(np.int32)) for name in INPUTS}

    def make_batch(rng: np.random.Generator, data_config, batch_size):
        """The reference's synthetic batch, bit for bit: every position
        valid, ``mask_rate`` of them masked to [MASK]."""
        T = data_config.seq_len
        labels = rng.integers(2, cfg.vocab_size, (batch_size, T)).astype(
            np.int32)
        mlm_mask = (rng.random((batch_size, T)) < mask_rate).astype(np.int32)
        tokens = np.where(mlm_mask == 1, MASK_TOKEN, labels).astype(np.int32)
        return {"tokens": tokens, "labels": labels, "mlm_mask": mlm_mask,
                "attn_mask": np.ones((batch_size, T), np.int32)}

    return ModelBundle(cfg=cfg, build=transformer_build(cfg),
                       loss_fn=loss_fn, make_batch=make_batch,
                       input_spec=input_spec, task="mlm")


@register_model("bert_tiny")
def make_bert_tiny(**overrides):
    return _bundle(_bert_cfg("tiny", **overrides))


@register_model("bert_base")
def make_bert_base(**overrides):
    return _bundle(_bert_cfg("base", **overrides))
