"""The port's BERT masked-LM family against the JAX package's, on the CPU:
``bert_tiny`` at T = 512 with suffix-padded rows of lengths 512, 37, 1
and 0, where ``impl="auto"`` takes flash attention in "len" mode from the
mask's row sums (the reference's kernels in interpret mode, the port's
plain versions of K1-K3); the MLM loss, its accuracy and ``loss_weight``
and every gradient; gradient accumulation over microbatches with
different masked counts against the whole batch, in both packages;
``bert_base``'s config and tree; the losses' edge cases; the decode modes'
refusal; the non-causal FLOP count.

Both run in f32 from the same numpy weights (``bridge.from_jax_params``)
and batch, with ``bert_tiny``'s vocabulary cut to 1,024 (``VOCAB``): the
30,522-way head over 2,048 positions is most of the work on the CPU and
none of what is tested. XLA and ATen sum in other orders and the flash
kernels' online softmax rescales where the plain version does not, so
values agree to f32 round-off grown through two layers and the softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.config import DataConfig as JDataConfig
from serverless_learn_tpu.models import bert as jbert
from serverless_learn_tpu.models.registry import get_model as jax_get_model
from serverless_learn_tpu.ops import losses as jlosses
from serverless_learn_tpu_torch.bridge import (from_jax_params, nest,
                                               to_jax_params)
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.models import bert as pbert
from serverless_learn_tpu_torch.models.registry import get_model
from serverless_learn_tpu_torch.ops import attention as pattention
from serverless_learn_tpu_torch.ops import losses as plosses
from serverless_learn_tpu_torch.training.loop import step_flops
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils.metrics import lm_train_flops

LENGTHS = (512, 37, 1, 0)
VOCAB = 1024
TINY = dict(dtype="float32", vocab_size=VOCAB)
# Loss: a few f32 ulps of its size. Gradients: 1e-4 of each leaf's largest
# entry plus 1e-6 of the largest anywhere (a LayerNorm's bias gradient is a
# sum over B*T rows that can cancel below the round-off of its terms).
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# XLA's lowest optimisation level, without its CPU fusion emitters: the
# same results, compiled in a third of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_cpu_use_fusion_emitters": False}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)


def _params(bundle, seed=0):
    """Random numpy params in ``bundle``'s flax tree: kernels and tables
    normal with variance 1/fan_in, LayerNorm scales near 1, biases near 0."""
    model = bundle.build("meta")
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        if name.endswith("scale"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-1] if name.endswith("embedding") else shape[0]
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return nest({n: fill(n, bundle.flax_shape(n, p.shape))
                 for n, p in model.named_parameters()})


def _batch(lengths, T, seed=1, mask_rate=0.3, vocab=VOCAB):
    """A suffix-padded MLM batch: row b holds lengths[b] tokens, then pad
    (id 0); ``mask_rate`` of the valid positions are masked."""
    rng = np.random.default_rng(seed)
    attn = (np.arange(T)[None] < np.array(lengths)[:, None]).astype(np.int32)
    labels = np.where(attn == 1, rng.integers(2, vocab, attn.shape), 0)
    mlm = ((rng.random(attn.shape) < mask_rate) & (attn == 1)).astype(
        np.int32)
    tokens = np.where(mlm == 1, jbert.MASK_TOKEN, labels)
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32), "mlm_mask": mlm,
            "attn_mask": attn}


def _assert_tree_close(got, want):
    flat_w = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    top = max(float(np.abs(w).max()) for w in flat_w.values())
    for k, w in flat_w.items():
        err = float(np.abs(flat_g[k] - w).max())
        bound = GRAD_REL * float(np.abs(w).max()) + GRAD_FLOOR * top
        assert np.isfinite(flat_g[k]).all() and err <= bound, (k, err, bound)


def _port_grads(model):
    return to_jax_params({n: p.grad for n, p in model.named_parameters()},
                         model.cfg)


def _jax_loss_and_grads(jb, params, batch):
    fn = jax.value_and_grad(lambda p, b: jb.loss_fn(p, b), has_aux=True)
    return _compile(fn, params, batch)(params, batch)


def test_bert_tiny_matches_jax_at_512_with_suffix_padding(monkeypatch):
    jb = jax_get_model("bert_tiny", **dict(TINY, dtype=jnp.float32))
    pb = get_model("bert_tiny", **TINY)
    params = _params(pb)
    batch = _batch(LENGTHS, 512)
    (jl, jaux), jg = _jax_loss_and_grads(jb, params, batch)

    seen = []
    real = pattention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((kw.get("causal"), kw.get("kv_lengths")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(pattention, "flash_attention", spy)
    model = pb.build("cpu", trainable=True)
    with torch.no_grad():
        model.load_state_dict(from_jax_params(params))
    loss, aux = pb.loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    # Both layers took the flash kernels' "len" path, non-causal, with the
    # mask's row sums as lengths.
    assert len(seen) == 2
    for causal, lengths in seen:
        assert causal is False and lengths.tolist() == list(LENGTHS)
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    assert float(aux["metrics"]["accuracy"]) == pytest.approx(
        float(jaux["metrics"]["accuracy"]), abs=1e-7)
    assert float(aux["loss_weight"]) == float(jaux["loss_weight"]) == float(
        batch["mlm_mask"].sum())
    _assert_tree_close(_port_grads(model), jg)


def test_grad_accumulation_equals_the_whole_batch_in_both_packages():
    """Two microbatches holding different numbers of masked tokens: each
    gradient weighted by its ``loss_weight`` gives the whole batch's
    gradient. The reference's weighting is done by hand over its loss
    (microbatch m is the batch with every other row's ``mlm_mask`` zero:
    the same masked sum over the same tokens, one compile for all); the
    port's trainer accumulates (one sgd step at lr 1, so the parameters
    move by the gradient). One layer at T = 32 (dense attention): the
    weighting, not the model, is under test."""
    T = 32
    batch = _batch((32, 9, 20, 0), T, seed=2, mask_rate=0.4)
    counts = batch["mlm_mask"].reshape(2, 2, T).sum((1, 2))
    assert counts[0] != counts[1] and counts.min() > 0
    one = dict(TINY, n_layers=1)
    jb = jax_get_model("bert_tiny", **dict(one, dtype=jnp.float32))
    pb = get_model("bert_tiny", **one)
    params = _params(pb, seed=3)
    fn = jax.value_and_grad(lambda p, b: jb.loss_fn(p, b), has_aux=True)
    step = _compile(fn, params, batch)
    (whole_loss, _), whole = step(params, batch)

    def micro(m):
        keep = (np.arange(4) // 2 == m)[:, None]
        return dict(batch, mlm_mask=batch["mlm_mask"] * keep)

    parts = [step(params, micro(m)) for m in range(2)]
    w = [float(a["loss_weight"]) for (_, a), _ in parts]
    assert w == [float(c) for c in counts]
    acc = jax.tree_util.tree_map(
        lambda a, b: (w[0] * a + w[1] * b) / (w[0] + w[1]), parts[0][1],
        parts[1][1])
    _assert_tree_close(acc, whole)

    moved = {}
    for accum in (1, 2):
        cfg = ExperimentConfig(
            model="bert_tiny", model_overrides=one,
            optimizer=OptimizerConfig(name="sgd", learning_rate=1.0,
                                      momentum=0.0),
            train=TrainConfig(batch_size=4, grad_accum=accum,
                              dtype="float32"),
            data=DataConfig(seq_len=T))
        tr = build_trainer(cfg, device="cpu")
        state = tr.init(params=from_jax_params(params))
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        state, metrics = tr.step(state, tr.place(batch))
        moved[accum] = {n: before[n] - p.detach()
                        for n, p in state.model.named_parameters()}
        # The weighted mean of the microbatches' losses is the whole
        # batch's.
        np.testing.assert_allclose(float(metrics["loss"]), float(whole_loss),
                                   **LOSS_TOL)
    _assert_tree_close(to_jax_params(moved[2], pb.cfg), whole)
    _assert_tree_close(to_jax_params(moved[1], pb.cfg), whole)


def test_bert_base_config_and_tree_match_jax():
    jcfg = jbert._bert_cfg("base")
    pcfg = pbert._bert_cfg("base")
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
              "max_seq_len", "causal", "use_rope", "norm", "activation",
              "tie_embeddings", "suffix_padding_mask", "attention_impl"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
    assert pbert.MASK_TOKEN == jbert.MASK_TOKEN
    jb = jax_get_model("bert_base")
    want = jax.eval_shape(lambda: jb.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    flat = {jax.tree_util.keystr(p).replace("']['", ".").strip("[']"):
            tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    pb = get_model("bert_base")
    got = {n: pb.flax_shape(n, p.shape)
           for n, p in pb.build("meta").named_parameters()}
    assert got == flat
    # The synthetic batch is the reference's, bit for bit.
    dc = JDataConfig(seq_len=16)
    a = jb.make_batch(np.random.default_rng(4), dc, 3)
    b = pb.make_batch(np.random.default_rng(4), DataConfig(seq_len=16), 3)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def test_losses_match_optax_and_an_empty_mask_is_zero():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.5).astype(np.int32)
    mlm = _compile(jlosses.masked_lm_loss, logits, labels, mask)
    for m in (mask, np.zeros_like(mask)):
        jl, jm = mlm(logits, labels, m)
        pl, pm = plosses.masked_lm_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(m))
        assert np.isfinite(float(pl))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6,
                                   atol=1e-7)
        assert float(pm["accuracy"]) == pytest.approx(
            float(jm["accuracy"]))
    jl, jm = _compile(jlosses.softmax_cross_entropy, logits[0], labels[0])(
        logits[0], labels[0])
    pl, pm = plosses.softmax_cross_entropy(torch.from_numpy(logits[0]),
                                           torch.from_numpy(labels[0]))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    assert float(pm["accuracy"]) == pytest.approx(float(jm["accuracy"]))


def test_decode_modes_raise_and_bf16_forward_is_finite():
    pb = get_model("bert_tiny", n_layers=1)
    model = pb.init(pb.build("cpu"), 0)
    tokens = torch.ones((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="causal"):
        model(tokens, prefill=True)
    b = {k: torch.from_numpy(v) for k, v in _batch((8, 3), 8).items()}
    loss, aux = pb.loss_fn(model, b)
    assert np.isfinite(float(loss)) and float(aux["loss_weight"]) >= 1


def test_non_causal_attention_counts_twice_the_causal():
    cfg = ExperimentConfig(model="bert_tiny",
                           train=TrainConfig(batch_size=4),
                           data=DataConfig(seq_len=512))
    tr = build_trainer(cfg, device="cpu")
    state = tr.init()
    n = sum(p.numel() for p in state.model.parameters()) - 512 * 128
    want = lm_train_flops(n, 30522, 128, 2, 4, 512, causal=False)
    assert step_flops(cfg, tr, state) == want
    assert want - lm_train_flops(n, 30522, 128, 2, 4, 512) == (
        6.0 * 2 * 4 * 512 * 512 * 128)
