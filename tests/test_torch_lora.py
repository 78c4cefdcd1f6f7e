"""The port's LoRA fine-tuning (adapters on q/v, the trainable partition,
the partitioned trainer) against the JAX package, after
``tests/test_qlora.py``'s cases: llama_tiny in f32 with rank 4, the
reference's initial params carried across with ``bridge.from_jax_params``.

Also the optimizer over the LoRA subtree at the values of
``configs/llama8b_lora_elastic.json`` against optax, and the repaired FLOPs
count (frozen parameters at 4 FLOPs a token, trained ones at 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.config import (DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         MeshConfig as JMeshConfig,
                                         OptimizerConfig as JOptimizerConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.data.datasets import SyntheticSource as JSource
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.training import partition as jpartition
from serverless_learn_tpu.training.optimizer import (
    make_optimizer as jax_make_optimizer)
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch.bridge import from_jax_params, to_jax_params
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.data.datasets import SyntheticSource
from serverless_learn_tpu_torch.models.llama import lora_trainable_mask
from serverless_learn_tpu_torch.training import partition
from serverless_learn_tpu_torch.training.loop import step_flops
from serverless_learn_tpu_torch.training.optimizer import (lr_at,
                                                           make_optimizer)
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils.metrics import lm_train_flops

RANK, BATCH, SEQ, STEPS = 4, 4, 32, 3
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.1,
           grad_clip_norm=1.0)
# f32 on both sides, sums in other orders: losses to f32 round-off grown
# through 2 layers; adam moves every weight by up to lr (1e-3) a step
# whatever its gradient's size, so round-off in a small gradient shows at
# that scale: atol 5e-6 is half a percent of one update (as in
# tests/test_torch_train.py). Gradients to 1e-5 of the largest of their
# tensor.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-6)
GRAD_RTOL = 1e-5


def _configs(fused=False, accum=1, remat=False, opt=OPT):
    over = {"lora_rank": RANK, "fused_ce": fused, "remat": remat}
    jcfg = JExperimentConfig(
        model="llama_tiny", model_overrides=dict(over),
        mesh=JMeshConfig(dp=1), optimizer=JOptimizerConfig(**opt),
        train=JTrainConfig(batch_size=BATCH, num_steps=STEPS, seed=0,
                           dtype="float32", grad_accum=accum),
        data=JDataConfig(seq_len=SEQ))
    tcfg = ExperimentConfig(
        model="llama_tiny", model_overrides=dict(over),
        optimizer=OptimizerConfig(**opt),
        train=TrainConfig(batch_size=BATCH, num_steps=STEPS, seed=0,
                          dtype="float32", grad_accum=accum),
        data=DataConfig(seq_len=SEQ))
    return jcfg, tcfg


def _jax_trainer(jcfg):
    # One of the 8 virtual CPU devices (tests/conftest.py): no sharding.
    return jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                  devices=jax.devices()[:1]))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_random_lora_b(params, seed=1):
    """The tree with every ``lora_b`` kernel drawn normal(0.02): at zero
    (the init) no gradient reaches ``lora_a``, and a wrong one would pass."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        if "lora_b" in keys:
            return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(one, params)


def _torch_grads(tcfg, params, host_batch):
    tr = build_trainer(tcfg, device="cpu")
    state = tr.init(params=params)
    loss, _ = tr.bundle.loss_fn(state.model, tr.place(host_batch))
    loss.backward()
    loss = float(loss.detach())
    grads = {k: p.grad for k, p in state.model.named_parameters()
             if p.requires_grad}
    frozen = [k for k, p in state.model.named_parameters()
              if not p.requires_grad]
    assert all(state.model.get_parameter(k).grad is None for k in frozen)
    return loss, grads


def test_prune_overlay_roundtrip():
    """The reference's cases on the port's flat state dicts, and the same
    selection as the reference's tree functions."""
    tree = {"a.x": 1, "a.y": 2, "b.z": 3}
    mask = {"a.x": True, "a.y": False, "b.z": False}
    assert partition.prune(tree, mask) == {"a.x": 1}
    assert partition.overlay(tree, {"a.x": 10}) == {"a.x": 10, "a.y": 2,
                                                    "b.z": 3}
    with pytest.raises(ValueError, match="selects no parameters"):
        partition.prune(tree, {k: False for k in tree})
    nested = {"a": {"x": 1, "y": 2}, "b": {"z": 3}}
    nmask = {"a": {"x": True, "y": False}, "b": {"z": False}}
    assert jpartition.prune(nested, nmask) == {"a": {"x": 1}}
    # The LoRA rule names the same leaves as the reference's.
    jtr = _jax_trainer(_configs()[0])
    jparams = jtr.abstract_state().params
    jmask = jtr.bundle.trainable_mask(jparams)
    want = {".".join(str(getattr(p, "key", "")) for p in path): m
            for path, m in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    assert lora_trainable_mask(want) == want
    assert sum(want.values()) == 2 * 2 * 2  # 2 layers x q/v x a/b


def test_frozen_base_bit_identical_and_opt_state_adapter_sized():
    _, tcfg = _configs()
    tr = build_trainer(tcfg, device="cpu")
    state = tr.init()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    host = next(iter(SyntheticSource(tr.bundle.make_batch, tcfg.data, BATCH,
                                     seed=0)))
    for _ in range(2):  # lora_a's gradient is 0 until lora_b has moved
        state, m = tr.step(state, tr.place(host))
        assert np.isfinite(float(m["loss"]))
    after = state.model.state_dict()
    mask = lora_trainable_mask(after)
    for k, v in after.items():
        if mask[k]:
            assert not torch.equal(v, before[k]), f"{k} did not train"
        else:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    lora = [p for k, p in state.model.named_parameters() if mask[k]]
    assert all(p.requires_grad for p in lora)
    n_lora = sum(p.numel() for p in lora)
    for moment in ("mu", "nu"):
        assert len(state.opt_state[moment]) == len(lora) == 8
        assert sum(t.numel() for t in state.opt_state[moment]) == n_lora
    n_model = sum(p.numel() for p in state.model.parameters())
    assert 2 * n_lora < n_model / 10


def test_lora_grads_match_jax_partitioned_grads():
    """LoRA gradients of one batch, the port's against ``jax.grad`` over
    the reference's pruned subtree, from the same weights (``lora_b``
    drawn away from zero, so ``lora_a`` has a gradient)."""
    jcfg, tcfg = _configs()
    jtr = _jax_trainer(jcfg)
    jstate = jtr.init()
    params = _with_random_lora_b(_numpy(jstate.params))
    tparams = from_jax_params(params)
    back = to_jax_params(tparams, build_trainer(tcfg, "cpu").bundle.cfg)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)  # the bridge is lossless
    host = next(iter(JSource(jtr.bundle.make_batch, jcfg.data, BATCH,
                             seed=7)))
    batch = jtr.shard_batch(host)
    mask = jtr.bundle.trainable_mask(params)
    sub = jpartition.prune(params, mask)

    def loss_of(sub_params):
        full = jpartition.overlay(params, sub_params)
        loss, _ = jtr.bundle.loss_fn(full, batch, rngs=jax.random.PRNGKey(0),
                                     model_state={})
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(sub)
    want = from_jax_params(_numpy(jgrads))
    loss, grads = _torch_grads(tcfg, tparams, host)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        ref = want[k].numpy()
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_grad_accum_equals_whole_batch_and_remat_keeps_grads(remat):
    """Two microbatches give the whole batch's LoRA step; through remat the
    adapters still get their gradients (non-reentrant checkpointing: the
    blocks' inputs need no gradient for the adapters inside to get one)."""
    results = []
    for accum in (1, 2):
        _, tcfg = _configs(accum=accum, remat=remat,
                           opt=dict(name="sgd", learning_rate=1.0,
                                    momentum=0.0))
        tr = build_trainer(tcfg, device="cpu")
        state = tr.init(seed=0)
        before = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()
                  if p.requires_grad}
        host = next(iter(SyntheticSource(tr.bundle.make_batch, tcfg.data,
                                         BATCH, seed=4)))
        state, m = tr.step(state, tr.place(host))
        # sgd at lr 1 without momentum: the step is minus the gradient.
        results.append((float(m["loss"]), {
            k: before[k] - p.detach()
            for k, p in state.model.named_parameters() if p.requires_grad}))
    (l1, g1), (l2, g2) = results
    assert l2 == pytest.approx(l1, rel=1e-6)
    for k in g1:
        if k.endswith("lora_b.kernel"):  # lora_a's is 0 while lora_b is
            assert g1[k].abs().max() > 0, k
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-5, atol=1e-7)


def test_three_lora_fused_ce_steps_match_jax():
    """Three adamw steps of LoRA with the fused loss, the port (plain K4/K5
    on the CPU) against the JAX trainer (its Pallas K4/K5 in interpret
    mode): losses, grad norms and the adapters after every step."""
    jcfg, tcfg = _configs(fused=True)
    jtr = _jax_trainer(jcfg)
    jstate = jtr.init()
    ttr = build_trainer(tcfg, device="cpu")
    tstate = ttr.init(params=from_jax_params(_numpy(jstate.params)))
    jit = iter(JSource(jtr.bundle.make_batch, jcfg.data, BATCH, seed=7))
    tit = iter(SyntheticSource(ttr.bundle.make_batch, tcfg.data, BATCH,
                               seed=7))
    mask = jtr.bundle.trainable_mask(jstate.params)
    for _ in range(STEPS):
        jstate, jm = jtr.step(jstate, jtr.shard_batch(next(jit)))
        tstate, tm = ttr.step(tstate, ttr.place(next(tit)))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **LOSS_TOL, err_msg=key)
        want = from_jax_params(_numpy(jpartition.prune(jstate.params, mask)))
        got = tstate.model.state_dict()
        for k, ref in want.items():
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(),
                                       **PARAM_TOL, err_msg=k)
    assert float(tm["lr"]) == pytest.approx(OPT["learning_rate"])  # warmup 0


# configs/llama8b_lora_elastic.json's optimizer, with weight decay added so
# the decay rule over the adapters is exercised (the config has none).
LORA_OPT = dict(name="adamw", learning_rate=2e-4, warmup_steps=100,
                decay_steps=10000, grad_clip_norm=1.0, weight_decay=0.1)


def test_optimizer_over_lora_subtree_matches_optax():
    """The adapters of llama_tiny in the port's layout: three updates
    against optax (f32, the same formulas in another order), and the
    schedule at the config's values. Under 100 warmup steps the update at
    step 0 has lr 0, as in optax: the first step moves nothing."""
    _, tcfg = _configs()
    model = build_trainer(tcfg, "cpu").init().model
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()
              if p.requires_grad}
    rng = np.random.default_rng(0)
    params0 = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}
    tx = jax_make_optimizer(JOptimizerConfig(**LORA_OPT))
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = tx.init(jp)
    opt = make_optimizer(OptimizerConfig(**LORA_OPT))
    names = sorted(shapes)
    tp = [torch.from_numpy(params0[k].copy()) for k in names]
    tstate = opt.init(tp)
    for step in range(3):
        g = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
             for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        opt.update(tp, [torch.from_numpy(g[k].copy()) for k in names],
                   tstate)
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=k)
            if step == 0:
                np.testing.assert_array_equal(t.numpy(), params0[k])
    for count, want in ((0, 0.0), (1, 2e-6), (50, 1e-4), (100, 2e-4)):
        assert lr_at(opt.schedule, count) == pytest.approx(want, rel=1e-6)
    assert lr_at(opt.schedule, 10000) == 0.0


def test_lm_train_flops_counts_frozen_params_at_four():
    _, tcfg = _configs()
    tr = build_trainer(tcfg, device="cpu")
    state = tr.init()
    cfg = tr.bundle.cfg
    params = dict(state.model.named_parameters())
    mask = lora_trainable_mask(params)
    adapters = sum(p.numel() for k, p in params.items() if mask[k])
    frozen = sum(p.numel() for k, p in params.items()
                 if not mask[k] and k != "embedder.embedding")
    assert adapters == cfg.n_layers * RANK * (2 * cfg.d_model
                                              + cfg.n_heads * cfg.head_dim
                                              + cfg.kv_heads * cfg.head_dim)
    tokens = BATCH * SEQ
    attention = 6 * cfg.n_layers * BATCH * SEQ ** 2 * cfg.d_model
    assert step_flops(tcfg, tr, state) == (4 * tokens * frozen
                                           + 6 * tokens * adapters
                                           + attention)
    # Without a mask every parameter but the embedding table trains: 6.
    n = sum(p.numel() for p in params.values())
    dense = n - cfg.vocab_size * cfg.d_model
    assert lm_train_flops(n, cfg.vocab_size, cfg.d_model, cfg.n_layers,
                          BATCH, SEQ) == 6 * tokens * dense + attention
