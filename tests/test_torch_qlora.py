"""QLoRA in the port (LoRA adapters trained over an int8 frozen base)
against the JAX package, after ``tests/test_qlora.py``'s cases: llama_tiny
with rank-4 adapters on q/v, seq 32, bf16 compute, the reference's weights
(``quantize_params_int8`` of one float init) carried across with
``bridge.from_jax_params``. The reference's int8 projections run in their
XLA form (``SLT_QUANT_PALLAS`` unset), as its QLoRA does.

* ``QuantMatmul``'s input gradient against ``jax.vjp`` of the reference's
  ``quant_matmul``, with leading dims and ragged rows, under remat too; no
  gradient for the int8 weights or their scales;
* the port's loss and LoRA gradients equal the JAX trainer's on the same
  weights; the frozen base is bit-identical after a step; the optimizer
  state is adapter-sized; the gradients through the int8 base track the
  float base's (``tests/test_qlora.py``'s bar); three adamw steps with bf16
  params match JAX's;
* the int8 base in the params tree: init as flax's (zeros and ones), the
  FLOPs count, checkpoints both ways bit for bit, and the CLI's ``train
  --checkpoint-dir`` then ``eval`` from it.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from serverless_learn_tpu.config import (DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         MeshConfig as JMeshConfig,
                                         OptimizerConfig as JOptimizerConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.data.datasets import SyntheticSource as JSource
from serverless_learn_tpu.inference.quantize import (
    quantize_params_int8 as jax_quantize)
from serverless_learn_tpu.ops.pallas.quant_matmul import (
    quant_matmul as jax_quant_matmul)
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu.training import partition as jpartition
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.bridge import from_jax_params, to_jax_params
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.data.datasets import SyntheticSource
from serverless_learn_tpu_torch.inference.quantize import (
    random_quantized_params)
from serverless_learn_tpu_torch.models.llama import lora_trainable_mask
from serverless_learn_tpu_torch.ops import quant_matmul as qm
from serverless_learn_tpu_torch.training import partition
from serverless_learn_tpu_torch.training.checkpoint import (Checkpointer,
                                                            LocalStore)
from serverless_learn_tpu_torch.training.loop import step_flops
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils import serialization as ser

RANK, BATCH, SEQ = 4, 4, 32
OPT = dict(name="adamw", learning_rate=1e-2)
# bf16 compute on both sides in two differently fused graphs of the same
# math: the bar tests/test_qlora.py sets for the reference's own two
# graphs (rtol 5e-2, atol 1e-3 on gradients of this scale).
GRAD_TOL = dict(rtol=5e-2, atol=1e-3)
# The loss: f32 means of 124 token losses from bf16 logits that differ by
# an ulp (2^-8 relative) here and there: 1e-3 relative.
LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # tiny ops lose to thread hand-offs


def _configs(quant=True, param_dtype="float32", opt=OPT, remat=False):
    over = {"lora_rank": RANK, "remat": remat}
    if quant:
        over["quant"] = "int8"
    jcfg = JExperimentConfig(
        model="llama_tiny", model_overrides=dict(over),
        mesh=JMeshConfig(dp=1), optimizer=JOptimizerConfig(**opt),
        train=JTrainConfig(batch_size=BATCH, seed=0, donate_state=False,
                           param_dtype=param_dtype),
        data=JDataConfig(seq_len=SEQ))
    tcfg = ExperimentConfig(
        model="llama_tiny", model_overrides=dict(over),
        optimizer=OptimizerConfig(**opt),
        train=TrainConfig(batch_size=BATCH, seed=0, param_dtype=param_dtype),
        data=DataConfig(seq_len=SEQ))
    return jcfg, tcfg


def _jax_trainer(jcfg):
    # One of the 8 virtual CPU devices (tests/conftest.py): no sharding.
    return jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                  devices=jax.devices()[:1]))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _weights():
    """(float params, their int8 quantization): the reference's float init
    with every ``lora_b`` drawn normal(0.02) (at its zero init no gradient
    reaches ``lora_a``, and a wrong one would pass)."""
    jtr = _jax_trainer(_configs(quant=False)[0])
    rng = np.random.default_rng(1)

    def one(path, leaf):
        if "lora_b" in [getattr(p, "key", "") for p in path]:
            return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(one, _numpy(jtr.init().params))
    return params, _numpy(jax_quantize(params))


def _host_batch(seed=0):
    jcfg, _ = _configs()
    jtr = _jax_trainer(jcfg)
    return next(iter(JSource(jtr.bundle.make_batch, jcfg.data, BATCH,
                             seed=seed)))


@functools.lru_cache(maxsize=None)
def _jax_grads(quant):
    """The reference's loss and LoRA gradients (``jax.grad`` over the
    pruned subtree) on one batch, from :func:`_weights`."""
    jtr = _jax_trainer(_configs(quant=quant)[0])
    params = _weights()[1 if quant else 0]
    batch = jtr.shard_batch(_host_batch())
    sub = jpartition.prune(params, jtr.bundle.trainable_mask(params))

    def loss_of(sub_params):
        loss, _ = jtr.bundle.loss_fn(jpartition.overlay(params, sub_params),
                                     batch, rngs=jax.random.PRNGKey(0),
                                     model_state={})
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(sub)
    return float(loss), from_jax_params(_numpy(grads))


def _port_grads(quant, remat=False):
    _, tcfg = _configs(quant=quant, remat=remat)
    tr = build_trainer(tcfg, device="cpu")
    state = tr.init(params=from_jax_params(_weights()[1 if quant else 0]))
    loss, _ = tr.bundle.loss_fn(state.model, tr.place(_host_batch()))
    loss.backward()
    grads = {k: p.grad for k, p in state.model.named_parameters()
             if p.requires_grad}
    assert all(p.grad is None for p in state.model.parameters()
               if not p.requires_grad)
    return float(loss.detach()), grads


# -- the int8 matmul's gradient ---------------------------------------------

def _qm_inputs(lead, I, O, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, I)).astype(np.float32)
    wq = rng.integers(-127, 128, (I, O)).astype(np.int8)
    scale = ((rng.random(O) + 0.5) * 4e-3).astype(np.float32)
    dy = rng.standard_normal((*lead, O)).astype(np.float32)
    return x, wq, scale, dy


def _jax_dx(x, wq, scale, dy):
    xb = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda v: jax_quant_matmul(v, jnp.asarray(wq),
                                                jnp.asarray(scale)), xb)
    (dx,) = vjp(jnp.asarray(dy, jnp.bfloat16))
    return torch.from_numpy(np.array(dx.astype(jnp.float32)))


def _assert_dx_close(got, want):
    # Both round g = dy * scale to bf16 and sum g @ wq^T in f32: they
    # differ only in the order of the f32 sums, so a bf16 output may round
    # to a neighbouring value (one ulp <= 2^-7 relative) and a sum move by
    # ~1e-3 of the largest output (the K6 kernel tests' rule).
    err = (got.float() - want).abs()
    limit = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
    assert bool((err <= limit).all()), (err - limit).max().item()


@pytest.mark.parametrize("lead, I, O", [((5,), 64, 48), ((2, 3), 128, 96),
                                        ((2, 17), 96, 200)],
                         ids=["ragged_rows", "lead_dims", "odd_rows"])
def test_input_gradient_matches_jax_vjp(lead, I, O):
    x, wq, scale, dy = _qm_inputs(lead, I, O)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    w, s = torch.from_numpy(wq), torch.from_numpy(scale).requires_grad_()
    out = qm.QuantMatmul.apply(xt, w, s)
    assert out.shape == (*lead, O) and out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(dy).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == xt.shape
    _assert_dx_close(xt.grad, _jax_dx(x, wq, scale, dy))
    assert s.grad is None  # the scales get no gradient, nor the int8 weights


def test_input_gradient_under_remat_is_the_same():
    """Through non-reentrant ``torch.utils.checkpoint`` the forward runs
    again in the backward and gives the same gradient, bit for bit."""
    x, wq, scale, dy = _qm_inputs((3, 7), 64, 48, seed=2)
    w, s = torch.from_numpy(wq), torch.from_numpy(scale)
    g = torch.from_numpy(dy).to(torch.bfloat16)
    grads = []
    for remat in (False, True):
        xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
        fn = lambda v: qm.QuantMatmul.apply(v * 2, w, s)  # noqa: E731
        out = checkpoint(fn, xt, use_reentrant=False) if remat else fn(xt)
        out.backward(g)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_forward_for_serving_records_no_graph(monkeypatch, mode):
    """Serving runs the Function under no_grad or inference_mode: one
    wrapper call a projection, its output unchanged, no graph kept."""
    calls = []
    real = qm.quant_matmul
    monkeypatch.setattr(qm, "quant_matmul",
                        lambda *a: calls.append(1) or real(*a))
    x, wq, scale, _ = _qm_inputs((4,), 64, 48)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    w, s = torch.from_numpy(wq), torch.from_numpy(scale)
    with getattr(torch, mode)():
        out = qm.QuantMatmul.apply(xt, w, s)
    assert out.grad_fn is None and not out.requires_grad
    assert len(calls) == 1 and torch.equal(out, real(xt.detach(), w, s))


# -- the QLoRA trainer against the reference's -------------------------------

def test_loss_and_lora_grads_match_jax():
    jloss, want = _jax_grads(True)
    loss, grads = _port_grads(True)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(want)
    assert len(grads) == 2 * 2 * 2  # 2 layers x q/v x a/b
    for k, g in grads.items():
        assert float(g.abs().max()) > 0, k
        np.testing.assert_allclose(g.float().numpy(), want[k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_grads_through_int8_base_track_float_base():
    """tests/test_qlora.py's gradient-quality bar in the port: per adapter,
    the int8 base's gradient within 10 % (relative norm) of the float
    base's from the same float weights."""
    _, g_fp = _port_grads(False)
    _, g_q = _port_grads(True)
    for k, a in g_fp.items():
        a, b = a.float(), g_q[k].float()
        rel = float((a - b).norm() / a.norm())
        assert rel < 0.10, (k, rel)


def test_remat_gives_the_same_grads_and_runs_each_projection_twice(
        monkeypatch):
    """With remat every block's seven int8 projections run again in the
    backward, lm_head once: 2 * 7 * layers + 1 forwards a step (449 for
    llama_8b), and the gradients equal the ones without remat."""
    calls = [0]
    real = qm.QuantMatmul.forward

    def counting(ctx, *a):
        calls[0] += 1
        return real(ctx, *a)

    monkeypatch.setattr(qm.QuantMatmul, "forward", staticmethod(counting))
    _, plain = _port_grads(True)
    assert calls[0] == 7 * 2 + 1
    calls[0] = 0
    _, remat = _port_grads(True, remat=True)
    assert calls[0] == 2 * 7 * 2 + 1
    for k, g in plain.items():
        assert torch.equal(remat[k], g), k


def test_frozen_base_bit_identical_and_opt_state_adapter_sized():
    _, tcfg = _configs()
    tr = build_trainer(tcfg, device="cpu")
    state = tr.init(params=from_jax_params(_weights()[1]))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    host = _host_batch()
    for _ in range(2):
        state, m = tr.step(state, tr.place(host))
        assert np.isfinite(float(m["loss"]))
    after = state.model.state_dict()
    mask = lora_trainable_mask(after)
    int8 = [k for k, v in after.items() if v.dtype == torch.int8]
    assert len(int8) == 2 * 7 + 1 and not any(mask[k] for k in int8)
    for k, v in after.items():
        if mask[k]:
            assert not torch.equal(v, before[k]), f"{k} did not train"
        else:
            assert torch.equal(v, before[k]), k
    lora = [p for k, p in state.model.named_parameters() if mask[k]]
    n_lora = sum(p.numel() for p in lora)
    for moment in ("mu", "nu"):
        assert len(state.opt_state[moment]) == len(lora) == 8
        assert sum(t.numel() for t in state.opt_state[moment]) == n_lora
    assert 2 * n_lora < sum(p.numel()
                            for p in state.model.parameters()) / 10


def test_three_bf16_adamw_steps_match_jax():
    """The ladder's form at tiny size: bf16 params (adapters, norms and
    embedding; the int8 base's scales stay f32), adamw with its moments in
    bf16 as optax keeps them, three steps on the JAX trainer and the port
    from the same weights and batches. Losses within LOSS_RTOL every step.
    After the first step each adapter element within an ulp of the larger
    of the weight and the update (2^-7 (|p| + lr)) but for at most 2 % of
    them: adam's first update is ~sign(g) lr, and where a gradient element
    sits in the bf16 noise of the two graphs its sign, and so a whole 2 lr,
    may flip (tests/test_qlora.py's own caveat). Later steps start from
    those flips, so only their losses are held."""
    jcfg, tcfg = _configs(param_dtype="bfloat16")
    jtr = _jax_trainer(jcfg)
    abstract = jtr.abstract_state().params
    params = jax.tree_util.tree_map(lambda x, a: np.asarray(x).astype(
        a.dtype), _weights()[1], abstract)
    jstate = jtr.init().replace(params=jax.device_put(params))
    ttr = build_trainer(tcfg, device="cpu")
    tstate = ttr.init(params=from_jax_params(params))
    assert tstate.model.embedder.embedding.dtype == torch.bfloat16
    assert tstate.model.get_parameter(
        "layer_0.attn.q_proj.scale").dtype == torch.float32
    mask = jtr.bundle.trainable_mask(params)
    jit = iter(JSource(jtr.bundle.make_batch, jcfg.data, BATCH, seed=7))
    tit = iter(SyntheticSource(ttr.bundle.make_batch, tcfg.data, BATCH,
                               seed=7))
    for step in range(3):
        jstate, jm = jtr.step(jstate, jtr.shard_batch(next(jit)))
        tstate, tm = ttr.step(tstate, ttr.place(next(tit)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        if step:
            continue
        want = from_jax_params(_numpy(jpartition.prune(jstate.params, mask)))
        got = tstate.model.state_dict()
        for k, ref in want.items():
            assert got[k].dtype == torch.bfloat16, k
            a, b = got[k].float(), ref.float()
            off = (a - b).abs() > 2 ** -7 * (b.abs() + OPT["learning_rate"])
            assert int(off.sum()) <= 0.02 * b.numel(), (k, int(off.sum()))
    assert all(t.dtype == torch.bfloat16 for t in tstate.opt_state["mu"]
               + tstate.opt_state["nu"])


@pytest.mark.parametrize("opt", [
    dict(name="adamw", learning_rate=2e-4),
    dict(name="adamw", learning_rate=2e-4, weight_decay=0.1,
         grad_clip_norm=1.0),
    dict(name="lion", learning_rate=2e-4, weight_decay=0.1),
    dict(name="rmsprop", learning_rate=2e-4, momentum=0.9)],
    ids=["adamw", "adamw_decay_clip", "lion", "rmsprop"])
def test_bf16_update_matches_optax(opt):
    """The optimizer alone on bf16 adapters, from the same bf16 gradients,
    at the ladder's lr (2e-4): after each of three updates the params and
    every moment equal optax's bit for bit (its Python constants rounded
    to bf16, one rounding after each product and sum:
    ``training.optimizer._consts``)."""
    from flax import serialization as flax_serialization

    from serverless_learn_tpu.training.optimizer import (
        make_optimizer as jax_make_optimizer)
    from serverless_learn_tpu_torch.training.optimizer import make_optimizer

    rng = np.random.default_rng(0)
    shapes = {"a": (128, RANK), "b": (RANK, 128), "n": (128,)}
    bf16 = lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x).view(np.uint16).copy()).view(torch.bfloat16)
    p0 = {k: jnp.asarray(0.02 * rng.standard_normal(s), jnp.bfloat16)
          for k, s in shapes.items()}
    tx = jax_make_optimizer(JOptimizerConfig(**opt))
    jp, jstate = dict(p0), tx.init(p0)
    port = make_optimizer(OptimizerConfig(**opt))
    names = sorted(shapes)
    tp = [bf16(p0[k]) for k in names]
    tstate = port.init(tp)
    for _ in range(3):
        g = {k: jnp.asarray(0.1 * rng.standard_normal(s), jnp.bfloat16)
             for k, s in shapes.items()}
        upd, jstate = tx.update(g, jstate, jp)
        jp = {k: (jp[k] + upd[k]).astype(jnp.bfloat16) for k in jp}
        port.update(tp, [bf16(g[k]) for k in names], tstate)
        for t, k in zip(tp, names):
            assert torch.equal(t, bf16(jp[k])), k
        tree = port.state_tree(tstate, lambda ts, as_params=True: dict(
            zip(names, ts)))
        got = list(ser.leaves_with_paths(tree))
        want = jax.tree_util.tree_flatten_with_path(
            flax_serialization.to_state_dict(jstate))[0]
        assert len(got) == len(want)
        for (path, a), (_, b) in zip(got, want):
            assert torch.equal(a, ser._as_tensor(np.asarray(b))), path


def test_quant_without_lora_raises_and_int8_never_trains():
    _, tcfg = _configs()
    over = {"quant": "int8"}
    tr = build_trainer(ExperimentConfig(
        model="llama_tiny", model_overrides=over,
        train=TrainConfig(batch_size=BATCH)), device="cpu")
    with pytest.raises(ValueError, match="quant"):
        tr.init()
    model = build_trainer(tcfg, device="cpu").init().model
    with pytest.raises(ValueError, match="int8"):
        partition.set_trainable(model, {n: True for n, _ in
                                        model.named_parameters()})


# -- the int8 base as parameters ---------------------------------------------

def test_init_and_params_tree_hold_the_base_as_the_reference():
    """From scratch the base is flax's init (kernel_q zeros, scale ones);
    the params tree has the reference's paths, shapes and dtypes, and the
    bridge carries a tree with both int8 and LoRA leaves both ways."""
    jcfg, tcfg = _configs()
    jparams = _numpy(_jax_trainer(jcfg).init().params)
    tr = build_trainer(tcfg, device="cpu")
    state = tr.init()
    tree = tr.state_tree(state)["params"]
    got = [(p, t.shape, t.dtype) for p, t in ser.leaves_with_paths(tree)]
    want = [(jax.tree_util.keystr(p), tuple(x.shape), ser._as_tensor(x).dtype)
            for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert got == want
    for p, t in ser.leaves_with_paths(tree):
        if p.endswith("['kernel_q']"):
            assert t.dtype == torch.int8 and not bool(t.any()), p
        elif "_proj']['scale']" in p or "lm_head']['scale']" in p:
            assert bool((t == 1).all()), p
    qparams = _weights()[1]
    back = to_jax_params(from_jax_params(qparams), tr.bundle.cfg)
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(back)[0]] == [p for p, _ in flat(qparams)[0]]
    for (p, a), (_, b) in zip(flat(back)[0], flat(qparams)[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    model = build_trainer(tcfg, device="cpu").init(
        fill=random_quantized_params).model
    q = model.get_parameter("layer_0.attn.q_proj.kernel_q")
    assert q.dtype == torch.int8 and bool(q.any())
    assert not bool(model.get_parameter(
        "layer_0.attn.q_lora.lora_b.kernel").any())


def test_step_flops_count_the_int8_base():
    """Each int8 weight is a frozen parameter (4 FLOPs a token), its
    scales count as the norm scales do: the QLoRA model's count exceeds
    the float-base LoRA model's by 4 * tokens * (the scales) alone."""
    counts = {}
    for quant in (False, True):
        _, tcfg = _configs(quant=quant)
        tr = build_trainer(tcfg, device="cpu")
        state = tr.init()
        counts[quant] = (step_flops(tcfg, tr, state), state)
    scales = sum(p.numel() for k, p in counts[True][1].model.named_parameters()
                 if k.endswith("_proj.scale") or k == "lm_head.scale")
    int8 = sum(p.numel() for p in counts[True][1].model.parameters()
               if p.dtype == torch.int8)
    cfg = counts[True][1].model.cfg
    assert int8 == cfg.n_layers * (
        2 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * cfg.kv_heads
        * cfg.head_dim + 3 * cfg.d_model * cfg.d_ff) + cfg.d_model * \
        cfg.vocab_size
    assert counts[True][0] - counts[False][0] == 4 * BATCH * SEQ * scales


# -- checkpoints ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_state():
    """The reference's QLoRA trainer and a state of random leaves (int8
    leaves 5, counts and step 5)."""
    jtr = _jax_trainer(_configs()[0])
    rng = np.random.default_rng(0)

    def fill(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            v = jnp.full(x.shape, 5, x.dtype)
        else:
            v = jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        return jax.device_put(v, x.sharding)

    return jtr, jax.tree_util.tree_map(fill, jtr.init())


def _assert_same_leaves(port_tree, jax_tree):
    got = list(ser.leaves_with_paths(port_tree))
    want = [(jax.tree_util.keystr(p), ser._as_tensor(np.asarray(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(jax_tree)[0]]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g.detach().cpu(), w), path


def test_jax_qlora_checkpoint_restores_into_port_bit_exact(tmp_path):
    jtr, jstate = _jax_state()
    jck.Checkpointer(jck.LocalStore(str(tmp_path)), name="run",
                     async_save=False).save(jstate)
    tr = build_trainer(_configs()[1], device="cpu")
    state = tr.init(seed=3)
    tree = tr.state_tree(state)
    assert Checkpointer(LocalStore(str(tmp_path)), name="run").restore(
        tree) is tree  # in place
    tr.load_tree(state, tree)
    assert state.step == 5
    _assert_same_leaves(tr.state_tree(state), jstate)
    q = state.model.get_parameter("layer_1.mlp.down_proj.kernel_q")
    assert q.dtype == torch.int8 and bool((q == 5).all())
    assert len(state.opt_state["mu"]) == 8  # the adapters alone


def test_port_qlora_checkpoint_restores_in_reference_bit_exact(tmp_path):
    jtr, _ = _jax_state()
    tr = build_trainer(_configs()[1], device="cpu")
    state = tr.init(fill=random_quantized_params)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for _, leaf in ser.leaves_with_paths(tr.state_tree(state)):
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=g))
    state.step, state.opt_state["count"] = 7, 7
    saver = Checkpointer(LocalStore(str(tmp_path)), name="run")
    assert saver.save(tr.state_tree(state)) == 7
    saver.close()
    back = jck.Checkpointer(jck.LocalStore(str(tmp_path)), name="run").restore(
        jtr.abstract_state(), shardings=jtr.state_shardings)
    _assert_same_leaves(tr.state_tree(state), back)


def test_cli_trains_qlora_saves_and_eval_restores(tmp_path, capsys):
    """``train`` with the QLoRA overrides (from scratch: over flax's zero
    base, as the reference's) saves a state with the int8 base; ``eval``
    restores the whole state from it."""
    root = str(tmp_path / "ck")
    base = ["--model", "llama_tiny", "--device", "cpu", "--batch-size", "2",
            "--seq-len", "32", "--set", "model_overrides.quant=int8",
            "--set", "model_overrides.lora_rank=4", "--set",
            "train.remat=true", "--set", "model_overrides.param_dtype="
            "bfloat16"]
    assert cli.main(["train", *base, "--steps", "2", "--checkpoint-dir",
                     root]) == 0
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["final_step"] == 2 and all(np.isfinite(done["losses"]))
    assert "step-0000000002" in os.listdir(os.path.join(root, "ckpt"))
    assert cli.main(["eval", *base, "--checkpoint-dir", root,
                     "--eval-steps", "1"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["checkpoint_step"] == 2
    # A zero base gives zero logits: the loss is ln V, and no gradient
    # reaches the adapters, as in the reference.
    assert got["eval_loss"] == pytest.approx(np.log(512), rel=1e-6)
