"""The port's speculative decoding against the JAX package's: the cases of
``tests/test_speculative.py`` on the port (self-draft exact and fully
accepted, a draft of other weights exact, unequal prompts, sticky EOS,
validation), each held to the port's own greedy ``generate``, and the
port's tokens and stats held to the reference's ``speculative_generate`` on
the same weights (carried over by ``bridge.from_jax_params``), in f32 on
the CPU. Greedy tokens are compared exactly: both sides pick the first
maximum of f32 logits that agree to round-off, and these random weights
leave no near-tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.inference.speculative import (
    speculative_generate as jax_speculative_generate)
from serverless_learn_tpu.models.registry import get_model as jax_get_model
from serverless_learn_tpu_torch.bridge import from_jax_params
from serverless_learn_tpu_torch.inference.generate import generate
from serverless_learn_tpu_torch.inference.speculative import (
    prefix_draft, speculative_generate)
from serverless_learn_tpu_torch.models.registry import get_model_config
from serverless_learn_tpu_torch.models.transformer import Transformer


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)  # tiny ops lose to thread hand-offs
    module = jax_get_model("llama_tiny", dtype=jnp.float32,
                           param_dtype=jnp.float32, max_seq_len=64).module
    jparams = [module.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 8), jnp.int32))["params"]
               for seed in (0, 7)]
    cfg = get_model_config("llama_tiny", dtype="float32", max_seq_len=64)
    ported = []
    for p in jparams:
        m = Transformer(cfg, device="cpu").eval()
        m.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 p)))
        ported.append(m)
    return module, jparams, ported


def _prompt(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, shape, dtype=np.int32))


def _golden(model, prompt, n, eos_id=None):
    return generate(model, prompt, n, eos_id=eos_id)


def test_self_draft_is_exact_and_fully_accepted(models):
    _, _, (target, _) = models
    prompt = _prompt(1, (2, 5))
    got, stats = speculative_generate(target, target, prompt, 12, K=4)
    torch.testing.assert_close(got, _golden(target, prompt, 12), rtol=0,
                               atol=0)
    assert stats["acceptance"] > 0.99, stats
    assert stats["rounds"] <= 3, stats  # ceil(12 / (K + 1))


def test_prefix_draft_shares_the_target_weights(models):
    _, _, (target, _) = models
    draft = prefix_draft(target, 1)
    assert draft.cfg.n_layers == 1 and draft.layer_0 is target.layer_0
    assert draft.lm_head is target.lm_head
    assert draft.embedder.embedding.data_ptr() == \
        target.embedder.embedding.data_ptr()
    prompt = _prompt(3, (2, 4))
    got, stats = speculative_generate(target, draft, prompt, 9, K=2)
    torch.testing.assert_close(got, _golden(target, prompt, 9), rtol=0,
                               atol=0)
    assert 0.0 <= stats["acceptance"] <= 1.0
    for bad in (0, target.cfg.n_layers):
        with pytest.raises(ValueError, match="draft_layers"):
            prefix_draft(target, bad)


def test_cross_draft_is_exact(models):
    _, _, (target, draft) = models
    prompt = _prompt(2, (3, 6))
    want = _golden(target, prompt, 10)
    for k in (1, 3, 5):
        got, stats = speculative_generate(target, draft, prompt, 10, K=k)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=f"K={k}")
        assert stats["rounds"] >= 2  # chance acceptance: many rounds


def test_unequal_prompts_exact(models):
    _, _, (target, draft) = models
    prompts = [[5, 9, 11], [7, 3, 2, 8, 1, 30, 12], [4]]
    P = max(len(p) for p in prompts)
    padded = torch.zeros(3, P, dtype=torch.int32)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.tensor(p)
    got, _ = speculative_generate(target, draft, padded, 8, K=3,
                                  prompt_lengths=lens)
    for i, p in enumerate(prompts):
        want = _golden(target, torch.tensor([p]), 8)[0, len(p):]
        torch.testing.assert_close(got[i, P:], want, rtol=0, atol=0,
                                   msg=f"row {i}")


def test_eos_sticky_matches_generate(models):
    _, _, (target, draft) = models
    prompt = torch.tensor([[5, 9, 11]], dtype=torch.int32)
    first = int(_golden(target, prompt, 1)[0, -1])
    want = _golden(target, prompt, 8, eos_id=first)
    got, _ = speculative_generate(target, draft, prompt, 8, K=3,
                                  eos_id=first)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got[0, 3:] == first).all())


def test_validation(models):
    _, _, (target, draft) = models
    with pytest.raises(ValueError, match="max_seq_len"):
        speculative_generate(target, draft, torch.ones(1, 50,
                                                       dtype=torch.int32),
                             12, K=4)
    with pytest.raises(ValueError, match="K must be"):
        speculative_generate(target, draft,
                             torch.ones(1, 4, dtype=torch.int32), 4, K=0)
    small = Transformer(get_model_config("llama_tiny", dtype="float32",
                                         max_seq_len=64, vocab_size=256),
                        device="meta")
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate(target, small,
                             torch.ones(1, 4, dtype=torch.int32), 4)


def test_tokens_and_stats_equal_the_reference(models):
    module, (tparams, dparams), (target, draft) = models
    prompt = _prompt(4, (2, 5))
    want, want_stats = jax_speculative_generate(
        module, tparams, module, dparams, jnp.asarray(prompt.numpy()), 10,
        K=3)
    got, stats = speculative_generate(target, draft, prompt, 10, K=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == want_stats
