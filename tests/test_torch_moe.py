"""The port's mixture of experts (``serverless_learn_tpu_torch/ops/moe.py``,
the MoE branch of ``models/transformer.py``, ``models/moe.py``, the int8
expert leaves of ``inference/quantize.py``, ``bridge.py``) against the
JAX package's, on the CPU at ``moe_tiny`` and smaller, the same numpy
inputs through both:

* ``top_k_routing``: dispatch, combine and aux, with capacity drops and
  per-group slots;
* ``MoELayer`` in f32: forward, aux and the gradients of the input, the
  router and the experts;
* the int8 layer and the bf16 layer;
* the bundle's loss with ``moe_aux_loss``, and an ``n_experts`` override on
  llama_tiny keeping its aux;
* ``quantize_params_int8``'s expert leaves bit for bit, and the refusal of
  stacked expert leaves;
* a cached decode equals the per-token full forward; greedy ``generate``,
  the continuous engine, the static engine and speculative decoding give
  the same tokens;
* the decode (dense) form equals the gathered form;
* a checkpoint round trip through ``bridge.py`` in both directions.

Tolerances: f32 against f32, XLA and ATen summing in other orders, 1e-5
(the gradients relative to their tensor's largest element); bf16 and int8
against the reference to bf16 rounding (reasons at each test).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.inference.generate import generate as jax_generate
from serverless_learn_tpu.inference.quantize import (
    quantize_params_int8 as jax_quantize)
from serverless_learn_tpu.models.registry import get_model as jax_get_model
from serverless_learn_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig)
from serverless_learn_tpu.ops.moe import MoELayer as JMoELayer
from serverless_learn_tpu.ops.moe import top_k_routing as jax_routing
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu_torch.bridge import (from_flax, from_jax_params,
                                               to_flax, to_jax_params)
from serverless_learn_tpu_torch.config import KVCacheConfig
from serverless_learn_tpu_torch.inference.batching import BatchingEngine
from serverless_learn_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine)
from serverless_learn_tpu_torch.inference.generate import generate
from serverless_learn_tpu_torch.inference.quantize import quantize_params_int8
from serverless_learn_tpu_torch.inference.speculative import (
    prefix_draft, speculative_generate)
from serverless_learn_tpu_torch.models.registry import (get_model,
                                                        get_model_config)
from serverless_learn_tpu_torch.models.transformer import (Transformer,
                                                           TransformerConfig,
                                                           init_params)
from serverless_learn_tpu_torch.ops.moe import (DENSE_MAX_ROWS, MoELayer,
                                                top_k_routing)
from serverless_learn_tpu_torch.training import checkpoint as pck

F32 = dict(rtol=1e-5, atol=1e-5)
MOE_KW = dict(moe_capacity_factor=1.0, max_seq_len=64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def moe():
    """moe_tiny in f32 at capacity 1.0 (tight: grouped training routing
    drops tokens), its flax params and the port's model from them."""
    bundle = jax_get_model("moe_tiny", dtype=jnp.float32, **MOE_KW)
    cfg = get_model_config("moe_tiny", dtype="float32", **MOE_KW)
    model = init_params(Transformer(cfg, device="cpu"), 0).eval()
    # The flax tree from the port's weights (a flax init costs a compile).
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        model.state_dict(), cfg))
    assert from_jax_params(_np(params)).keys() == model.state_dict().keys()
    return bundle, params, model


# -- routing and the layer ----------------------------------------------------

def test_top_k_routing_matches_reference():
    """Dispatch and combine equal the reference's at a capacity that drops
    (3 slots an expert for 16 tokens, 2 choices, 4 experts), each group
    filling its own slots; the aux to f32 round-off."""
    G, S, E, K, C = 3, 16, 4, 2, 3
    logits = np.random.default_rng(0).normal(size=(G, S, E)).astype(
        np.float32)
    jd, jc, ja = jax_routing(jnp.asarray(logits), E, K, C)
    d, c, a = top_k_routing(torch.from_numpy(logits), E, K, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    slots = d.numpy().sum(axis=1)  # [G, E, C]: tokens a slot holds
    assert slots.max() == 1, "one token a slot"
    kept = d.numpy().sum(axis=(2, 3))  # [G, S]: experts a token got
    assert (kept < K).any(), "capacity must drop some choices here"


def _layer_cfgs(dtype, quant=None, cap=1.0, group=8):
    kw = dict(d_model=16, d_ff=32, n_heads=4, n_experts=4, moe_top_k=2,
              moe_capacity_factor=cap, moe_group_size=group, quant=quant)
    jcfg = JTransformerConfig(dtype=getattr(jnp, dtype),
                              param_dtype=jnp.float32, **kw)
    return jcfg, TransformerConfig(dtype=dtype, param_dtype="float32", **kw)


def _layers(dtype, quant=None):
    """The JAX layer, numpy params (int8 ones quantized by the
    reference's recipe) and the port's layer with the same params. The
    scales put the router's logits and the experts' activations near one,
    where routing is not near a tie."""
    jcfg, cfg = _layer_cfgs(dtype)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    E, D, Fd = 4, 16, 32
    params = {k: jnp.asarray(rng.normal(0.0, std, shape).astype(np.float32))
              for k, std, shape in (("router", 0.3, (D, E)),
                                    ("expert_gate", 0.25, (E, D, Fd)),
                                    ("expert_up", 0.25, (E, D, Fd)),
                                    ("expert_down", 0.18, (E, Fd, D)))}
    if quant:
        params = jax_quantize({"moe": params})["moe"]
        jcfg, cfg = _layer_cfgs(dtype, quant)
    layer = MoELayer(cfg)
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           _np(params).items()})
    return JMoELayer(jcfg), params, layer, x


def _jax_apply(jlayer, params, x):
    y, col = jlayer.apply({"params": params}, x, mutable=["losses"])
    aux = sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(col["losses"]))
    return y, aux


def test_moe_layer_forward_and_grads_match_reference_f32():
    """f32: output, weighted aux, and the gradients of sum(y * c) + aux
    with respect to x, the router and each expert stack."""
    jlayer, params, layer, x = _layers("float32")
    cot = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = _jax_apply(jlayer, p, xx)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = layer(xt)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    grads = {"x": (xt.grad, jgx)}
    grads.update({k: (getattr(layer, k).grad, jgp[k]) for k in jgp})
    for name, (g, want) in grads.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_moe_layer_bf16_and_int8_match_reference(quant):
    """bf16 compute (f32 params), float and int8 experts. Both packages
    round x, the hidden SwiGLU activations and each expert's output to
    bf16, in orders of their own, and the reference's int8 experts are
    dequantized to bf16 weights (q * scale rounded) where K6's plain
    version keeps int8 * bf16 products exact in f32 and scales the f32
    sum: each output within 3 % of the output's largest magnitude (a few
    bf16 ulps through three products), the mean error within 0.5 %. The
    routing is in f32 in both, so the same tokens reach the same
    experts."""
    jlayer, params, layer, x = _layers("bfloat16", quant)
    jy, jaux = _jax_apply(jlayer, params, jnp.asarray(x))
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
    want = np.asarray(jy.astype(jnp.float32))
    got = y.float().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want) / scale
    assert err.max() < 0.03 and err.mean() < 0.005, (err.max(), err.mean())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_bundle_loss_carries_the_aux_loss(moe):
    """moe_tiny's loss is CE + aux with the metric moe_aux_loss, as the
    reference's; an n_experts override on llama_tiny keeps its aux
    (reference tests/test_moe.py::test_n_experts_override_keeps_aux_loss)."""
    bundle, params, model = moe
    tokens = np.random.default_rng(3).integers(0, 512, (2, 16)).astype(
        np.int32)
    jloss, jaux = jax.jit(bundle.loss_fn)(params,
                                          {"tokens": jnp.asarray(tokens)})
    pb = get_model("moe_tiny", dtype="float32", **MOE_KW)
    loss, aux = pb.loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    np.testing.assert_allclose(float(aux["metrics"]["moe_aux_loss"]),
                               float(jaux["metrics"]["moe_aux_loss"]),
                               rtol=1e-5)

    over = get_model("llama_tiny", n_experts=4, dtype="float32")
    assert over.cfg.n_experts == 4
    m = init_params(Transformer(over.cfg, device="cpu"), 0)
    t = torch.from_numpy(tokens)
    loss, out = over.loss_fn(m, {"tokens": t})
    logits = m(t)
    from serverless_learn_tpu_torch.ops.losses import causal_lm_loss
    lm_only, _ = causal_lm_loss(logits, t)
    a = float(out["metrics"]["moe_aux_loss"])
    assert a > 0
    np.testing.assert_allclose(float(loss), float(lm_only) + a, rtol=1e-6)


def test_quantize_expert_leaves_bit_exact(moe):
    """The int8 expert leaves and their scales equal the reference's bit
    for bit; the router and the rest stay float; stacked [L, E, ...]
    expert leaves are refused by both."""
    _, params, model = moe
    # Layer 0 (attention and experts) and the head: eager on the JAX side,
    # whose jit would turn the division by 127 into a product.
    sub = {"layer_0": {"moe": params["layer_0"]["moe"],
                       "attn": {"k_proj": params["layer_0"]["attn"][
                           "k_proj"]}},
           "lm_head": params["lm_head"]}
    want = from_jax_params(_np(jax_quantize(sub)))
    got = quantize_params_int8({k: v for k, v in model.state_dict().items()
                                if k.startswith(("layer_0.moe.",
                                                 "layer_0.attn.k_proj.",
                                                 "lm_head."))})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    qmodel = Transformer(get_model_config("moe_tiny", quant="int8",
                                          **MOE_KW), device="cpu")
    layout = {k: v.shape for k, v in qmodel.state_dict().items()
              if k.startswith(("layer_0.moe.", "layer_0.attn.k_proj.",
                               "lm_head."))}
    assert {k: v.shape for k, v in got.items()} == layout
    stacked = np.zeros((2, 4, 8, 16), np.float32)
    with pytest.raises(NotImplementedError):
        jax_quantize({"moe": {"expert_gate": stacked, "expert_up": stacked,
                              "expert_down": stacked}})
    with pytest.raises(NotImplementedError):
        quantize_params_int8({"layer_0.moe.expert_gate":
                              torch.from_numpy(stacked)})


# -- serving ------------------------------------------------------------------

def test_cached_decode_equals_full_forward(moe):
    """Incremental decode over the KV cache equals the reference's full
    forward with per-token routing (its group-size-1 twin), position for
    position (reference tests/test_moe_generate.py:48, its tolerance)."""
    bundle, params, model = moe
    twin = type(bundle.module)(dataclasses.replace(bundle.module.cfg,
                                                   moe_group_size=1))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 10)).astype(
        np.int32)
    full = np.asarray(jax.jit(twin.apply)({"params": params},
                                          jnp.asarray(tokens)))
    from serverless_learn_tpu_torch.inference.generate import init_cache
    cache = init_cache(model, 2)
    steps = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            steps.append(model(torch.from_numpy(tokens[:, t:t + 1]),
                               cache=cache, decode=True)[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full,
                               rtol=2e-4, atol=2e-4)


PROMPTS = [[5, 9, 11], [7, 3, 2, 8], [4, 4]]
N_NEW = 5


def test_engines_greedy_equal_generate(moe):
    """Greedy tokens: the port's generate of each prompt alone equals the
    reference's of the right-padded batch; the continuous engine (paged
    pool, concurrent requests), the static engine and speculative
    decoding (a 1-layer draft) equal the port's generate."""
    bundle, params, model = moe
    P = max(len(p) for p in PROMPTS)
    padded = np.zeros((len(PROMPTS), P), np.int32)
    for i, p in enumerate(PROMPTS):
        padded[i, :len(p)] = p
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    want = np.asarray(jax_generate(bundle.module, params,
                                   jnp.asarray(padded), N_NEW,
                                   prompt_lengths=jnp.asarray(lens)))[:, P:]
    solo = {}
    for i, p in enumerate(PROMPTS):
        got = generate(model, torch.tensor([p], dtype=torch.int32), N_NEW)
        solo[tuple(p)] = got[0, len(p):].tolist()
        assert solo[tuple(p)] == want[i].tolist()
        spec, _ = speculative_generate(model, prefix_draft(model, 1),
                                       torch.tensor([p], dtype=torch.int32),
                                       N_NEW, K=2)
        assert spec[0, len(p):].tolist() == solo[tuple(p)]
    eng = ContinuousBatchingEngine(
        model, kv=KVCacheConfig(block_size=4, prefill_chunk=4,
                                prefill_budget=8), max_slots=4, chunk_size=4)
    out = [None] * len(PROMPTS)
    try:
        def client(i):
            out[i] = eng.submit(PROMPTS[i], N_NEW, 0.0, 0, None, 0,
                                timeout_s=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        eng.stop()
    for p, r in zip(PROMPTS, out):
        assert "error" not in r, r
        assert r["new_tokens"] == solo[tuple(p)]
    static = BatchingEngine(model, max_batch=4, batch_wait_ms=1)
    try:
        r = static.submit(PROMPTS[1], N_NEW, 0.0, 0, None, 0)
    finally:
        static.stop()
    assert r["new_tokens"] == solo[tuple(PROMPTS[1])]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_form_equals_gathered_form(quant):
    """Per-token routing, DENSE_MAX_ROWS + 8 rows: every expert over every
    row with zero combine weights (the graph-safe decode form) equals each
    expert over its own rows (the gathered prefill form), to f32
    round-off: the same products, each row's experts added in expert order
    in both."""
    cfg = get_model_config("moe_tiny", dtype="float32", quant=quant)
    layer = MoELayer(cfg)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, t in layer.state_dict().items():
            if t.dtype == torch.int8:
                t.random_(-127, 128, generator=g)
            elif name.endswith("_scale"):
                t.fill_(2.5 * 0.02 / 127)
            else:
                t.normal_(0.0, 0.2, generator=g)
    x = torch.randn(DENSE_MAX_ROWS + 8, cfg.d_model, generator=g)
    with torch.no_grad():
        w, idx = layer._route(x)
        out = {"dense": layer._dense(x, idx, w),
               "gathered": layer._gathered(x, idx, w)}
        # The layer takes the gathered form past DENSE_MAX_ROWS rows, the
        # dense one up to it.
        y, aux = layer(x[None], per_token=True)
        few = x[:DENSE_MAX_ROWS]
        y_few, _ = layer(few[None], per_token=True)
    assert aux is None
    assert torch.equal(y[0], out["gathered"].to(y.dtype))
    assert torch.equal(y_few[0], layer._dense(few, idx[:DENSE_MAX_ROWS],
                                              w[:DENSE_MAX_ROWS]).to(y.dtype))
    scale = out["dense"].abs().max()
    torch.testing.assert_close(out["gathered"] / scale,
                               out["dense"] / scale, rtol=0, atol=1e-6)


def test_checkpoint_round_trip_through_bridge(tmp_path, moe):
    """A moe_tiny checkpoint restores in both packages: the reference's
    params saved by the JAX Checkpointer restore into the port's model bit
    for bit, and the port's saved by the port's restore in the JAX
    package bit for bit."""
    bundle, params, model = moe
    jstore = jck.LocalStore(str(tmp_path / "j"))
    jck.Checkpointer(jstore, name="m", async_save=False).save(
        {"step": np.asarray(3, np.int64), "params": _np(params)}, step=3)
    host = pck.Checkpointer(pck.LocalStore(str(tmp_path / "j")),
                            name="m").restore_params_host()
    named = from_flax(host)
    fresh = Transformer(model.cfg, device="cpu")
    fresh.load_state_dict(named)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    pck.Checkpointer(pck.LocalStore(str(tmp_path / "p")), name="m",
                     async_save=False).save(
        {"step": torch.tensor(4, dtype=torch.int64),
         "params": to_flax(model.state_dict(), model.cfg)}, step=4)
    template = {"step": np.asarray(0, np.int64),
                "params": jax.tree_util.tree_map(np.zeros_like,
                                                 _np(params))}
    got = jck.Checkpointer(jck.LocalStore(str(tmp_path / "p")),
                           name="m").restore_host(template)
    assert int(got["step"]) == 4
    want = to_jax_params(model.state_dict(), model.cfg)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got["params"])[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(pa))


@pytest.mark.parametrize("field,value", [
    ("manual_ep_axis", "ep"), ("moe_global_experts", 8),
    ("manual_tp_axis", "tp")])
def test_manual_parallel_fields_raise_not_ported(field, value):
    """The reference's expert and tensor parallelism inside a pipeline
    stage is multi-device: refused, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        get_model_config("moe_tiny", **{field: value})


def test_remat_keeps_the_aux_gradient():
    """Under remat (each block recomputed in the backward) the loss, the
    aux and every gradient equal the plain backward's: the aux leaves the
    checkpointed block as an output, so its router gradient survives."""
    out = {}
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, (2, 16)).astype(np.int32))
    for remat in (False, True):
        bundle = get_model("moe_tiny", dtype="float32", remat=remat,
                           moe_group_size=8)
        model = init_params(Transformer(bundle.cfg, device="cpu",
                                        trainable=True), 0)
        loss, aux = bundle.loss_fn(model, {"tokens": tokens})
        loss.backward()
        out[remat] = (float(loss.detach()),
                      float(aux["metrics"]["moe_aux_loss"].detach()),
                      {n: p.grad.clone() for n, p in model.named_parameters()})
    assert out[True][:2] == out[False][:2]
    assert out[True][1] > 0
    for n, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][n], g, rtol=0, atol=0,
                                   msg=n)
    assert out[False][2]["layer_0.moe.router"].abs().max() > 0
