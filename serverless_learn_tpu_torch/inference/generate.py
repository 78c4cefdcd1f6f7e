"""Autoregressive generation over a KV cache, port of
``serverless_learn_tpu/inference/generate.py``: the monolithic cache by
default, or a paged one (``inference/kvcache.py``) passed as ``cache``.

One batched prefill over the (right-padded) prompts fills the cache, then
``max_new_tokens - 1`` single-token decode steps each sample a token and
feed it back, and the last token is sampled from the last logits with no
forward after it. Sampling: greedy (``temperature=0``, the first maximum),
temperature, top-k. Draws come from a ``torch.Generator``; they do not
reproduce ``jax.random``'s bits.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from serverless_learn_tpu_torch.inference.kvcache import (PagedKVCache,
                                                          paged_cache,
                                                          pages_for,
                                                          sequential_table)
from serverless_learn_tpu_torch.models.transformer import KVCache, Transformer


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def init_cache(model: Transformer, batch_size: int, block_size: int = 0,
               num_blocks: int = 0) -> Union[KVCache, PagedKVCache]:
    """Zeroed ``[B, max_seq_len, K, D]`` keys and values for every layer, in
    the model's compute dtype, on the model's device. With ``block_size``
    > 0, a paged cache instead: pools of ``num_blocks`` pages (default
    exactly ``B`` full-length rows) seen through the dense row-major table
    of ``sequential_table``, the static engine's layout."""
    cfg = model.cfg
    if block_size > 0:
        max_pages = pages_for(cfg.max_seq_len, block_size)
        num_blocks = num_blocks or batch_size * max_pages
        return paged_cache(cfg.n_layers, num_blocks, block_size,
                           cfg.kv_heads, cfg.head_dim, cfg.dtype,
                           model.device, sequential_table(
                               batch_size, max_pages, num_blocks))
    shape = (batch_size, cfg.max_seq_len, cfg.kv_heads, cfg.head_dim)
    dev = model.device
    zeros = lambda: torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return KVCache(k=[zeros() for _ in range(cfg.n_layers)],
                   v=[zeros() for _ in range(cfg.n_layers)],
                   index=torch.zeros(batch_size, dtype=torch.int32, device=dev))


@torch.inference_mode()
def generate(model: Transformer, prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0,
             eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             prompt_lengths: Optional[torch.Tensor] = None,
             cache: Optional[Union[KVCache, PagedKVCache]] = None
             ) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, P].

    Returns [B, P + max_new_tokens] int32 on the model's device, prompt
    included. With ``eos_id``, a row that emitted it keeps emitting it.
    ``prompt_lengths`` [B]: prompts are right-padded to P and each row
    samples its first token from the logits at its own last real position
    and decodes from its own length. ``cache``: a cache to run over (a
    paged one with its tables set, for example); default a fresh monolithic
    one."""
    cfg = model.cfg
    dev = model.device
    prompt = prompt.to(device=dev, dtype=torch.int32)
    if max_new_tokens <= 0:
        return prompt
    B, P = prompt.shape
    if P + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"prompt ({P}) + max_new_tokens ({max_new_tokens}) "
                         f"exceeds max_seq_len {cfg.max_seq_len}")
    if cache is None:
        cache = init_cache(model, B)
    if prompt_lengths is not None:
        prompt_lengths = prompt_lengths.to(device=dev, dtype=torch.int32)
    logits = model(prompt, cache=cache, prefill=True, seq_lengths=prompt_lengths)
    if prompt_lengths is None:
        logits = logits[:, -1]
    else:
        logits = logits[torch.arange(B, device=dev), prompt_lengths.long() - 1]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    new = []
    for step in range(max_new_tokens):
        tok = _sample(logits, generator, temperature, top_k)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        new.append(tok)
        if step + 1 < max_new_tokens:
            logits = model(tok[:, None], cache=cache, decode=True)[:, 0]
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)
