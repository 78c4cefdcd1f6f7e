"""Speculative decoding, the port of ``serverless_learn_tpu/inference/
speculative.py``: a draft model proposes K tokens, and the target scores
them all in one ``extend`` forward over ``[B, K+1]``.

Greedy verification keeps the output equal to the target's own greedy
decode: each emitted token is the argmax of the target's logits on the
same prefix. A round, for every row at once:

* the draft decodes K+1 steps from ``last`` (the newest emitted token,
  which neither cache holds yet), so its cache also holds its K-th
  proposal when all of them are accepted;
* the target takes ``[last, d1..dK]`` in one extend forward; ``a`` is the
  length of the prefix of the drafts that equal the target's argmax, and
  the row emits ``d1..da`` and the target's own next token (the bonus);
* both caches roll back to the accepted history by resetting the row's
  cache index to ``base + 1 + a``: entries past the index are masked out
  and overwritten by the next append.

The reference runs the rounds in one ``lax.while_loop`` with no host
round trip. Here the rounds are a host loop that reads ``count.min()``
once a round (the one sync; ``chip_smoke.py`` phase 10 times it): the
loop's other work is queued on the device without waiting. Acceptance
depends on how far draft and target agree, a property of the weights:
random weights agree by chance, a prefix of a trained model's layers much
more. Greedy only: sampling would need rejection sampling to keep the
target's distribution. Each call publishes the reference's
``slt_spec_accept_rate`` gauge and ``slt_spec_draft_tokens_total`` /
``slt_spec_verified_tokens_total`` counters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from serverless_learn_tpu_torch.inference.generate import init_cache
from serverless_learn_tpu_torch.models.transformer import Transformer
from serverless_learn_tpu_torch.telemetry.registry import get_registry


def prefix_draft(model: Transformer, n_layers: int) -> Transformer:
    """The target's own first ``n_layers`` blocks with its embedding, final
    norm and head: a draft that holds no weights of its own (its modules
    are the target's)."""
    if not 1 <= n_layers < model.cfg.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, {model.cfg.n_layers - 1}] "
            f"(target has {model.cfg.n_layers} layers), got {n_layers}")
    draft = Transformer(dataclasses.replace(model.cfg, n_layers=n_layers),
                        device="meta")
    draft.embedder, draft.norm_f = model.embedder, model.norm_f
    draft.lm_head = model.lm_head
    for i in range(n_layers):
        draft.add_module(f"layer_{i}", model.layers[i])
        draft.layers[i] = model.layers[i]
    return draft.train(model.training)


@torch.inference_mode()
def speculative_generate(target: Transformer, draft: Transformer,
                         prompt: torch.Tensor, max_new_tokens: int,
                         K: int = 4, eos_id: Optional[int] = None,
                         prompt_lengths: Optional[torch.Tensor] = None):
    """Greedy continuation of ``prompt`` [B, P] under ``target``, drafted by
    ``draft``: the tokens of ``generate(target, ...)`` at temperature 0.

    Returns ``(tokens [B, P + max_new_tokens] int32, stats)``; ``stats``
    holds ``acceptance`` (accepted drafts over drafted ones, per row while
    the row is live, averaged over rows) and ``rounds``. With ``eos_id``, a
    row that emitted it keeps emitting it, as ``generate``'s."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if target.cfg.vocab_size != draft.cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    dev = target.device
    prompt = prompt.to(device=dev, dtype=torch.int32)
    B, P = prompt.shape
    if max_new_tokens <= 0:
        return prompt, {"acceptance": 0.0, "rounds": 0}
    for m, who in ((target, "target"), (draft, "draft")):
        if P + max_new_tokens + K > m.cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new + K ({P}+{max_new_tokens}+{K}) exceeds "
                f"{who} max_seq_len {m.cfg.max_seq_len} (the verify span "
                "transiently runs K past the final token)")
    L = max_new_tokens + K + 1  # junk writes past max_new land in the margin
    if prompt_lengths is not None:
        prompt_lengths = prompt_lengths.to(device=dev, dtype=torch.int32)
    t_cache, d_cache = init_cache(target, B), init_cache(draft, B)
    logits = target(prompt, cache=t_cache, prefill=True,
                    seq_lengths=prompt_lengths)
    draft(prompt, cache=d_cache, prefill=True, seq_lengths=prompt_lengths)
    if prompt_lengths is None:
        logits = logits[:, -1]
    else:
        logits = logits[torch.arange(B, device=dev),
                        prompt_lengths.long() - 1]
    # From here both caches hold every token but ``last``.
    last = torch.argmax(logits, dim=-1).to(torch.int32)
    out = torch.zeros(B, L, dtype=torch.int32, device=dev)
    out[:, 0] = last
    count = torch.ones(B, dtype=torch.int32, device=dev)
    accepted = torch.zeros(B, dtype=torch.int32, device=dev)
    drafted = torch.zeros(B, dtype=torch.int32, device=dev)
    span = torch.arange(K + 1, device=dev)
    pad = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    rounds = 0
    while int(count.min()) < max_new_tokens:  # the round's one host sync
        base = t_cache.index
        tok, proposed = last, []
        for _ in range(K + 1):
            d_logits = draft(tok[:, None], cache=d_cache, decode=True)
            tok = torch.argmax(d_logits[:, 0], dim=-1).to(torch.int32)
            proposed.append(tok)
        d_toks = torch.stack(proposed[:K], dim=1)  # [B, K]
        t_logits = target(torch.cat([last[:, None], d_toks], dim=1),
                          cache=t_cache, extend=True)
        t_pred = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [B, K+1]
        a = torch.cumprod((d_toks == t_pred[:, :K]).to(torch.int32),
                          dim=1).sum(dim=1, dtype=torch.int32)
        # Only live rows count: a finished row keeps decoding (the batch
        # is static) and its agreements would flatter the rate.
        live = count < max_new_tokens
        bonus = t_pred.gather(1, a[:, None].long())[:, 0]
        emit = torch.where(span[None, :] < a[:, None],
                           torch.cat([d_toks, pad], dim=1),
                           torch.where(span[None, :] == a[:, None],
                                       bonus[:, None], pad))
        # dynamic_update_slice's start: moved back inside the row.
        start = count.clamp(max=L - (K + 1)).long()
        out.scatter_(1, start[:, None] + span[None, :], emit)
        count = count + a + 1
        t_cache.index = base + 1 + a
        d_cache.index = t_cache.index.clone()
        accepted += torch.where(live, a, 0)
        drafted += torch.where(live, K, 0)
        last = bonus
        rounds += 1
    new = out[:, :max_new_tokens]
    if eos_id is not None:
        hit = (new == eos_id).to(torch.int32).cumsum(dim=1) > 0
        new = torch.where(hit, torch.full_like(new, eos_id), new)
    acc = (accepted.double() / drafted.clamp(min=1).double()).mean().item()
    # The draft's economics, as the reference publishes them: the accept
    # rate, and the token counters that give it over any window.
    reg = get_registry()
    reg.gauge("slt_spec_accept_rate",
              "mean accepted-draft fraction of the last speculative "
              "generate call").set(acc)
    reg.counter("slt_spec_draft_tokens_total",
                "tokens proposed by the draft model").inc(
                    float(drafted.sum()))
    reg.counter("slt_spec_verified_tokens_total",
                "draft tokens accepted by the target verify pass").inc(
                    float(accepted.sum()))
    return (torch.cat([prompt, new], dim=1),
            {"acceptance": acc, "rounds": rounds})
