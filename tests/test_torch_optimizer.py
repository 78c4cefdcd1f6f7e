"""The port's optimizers and schedules against optax, through the JAX
package's ``make_optimizer`` / ``make_schedule``: five updates of a small
tree (two matrices and a vector, so the decay mask matters) from the same
numpy gradients, the params compared after every update."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.config import OptimizerConfig as JOptimizerConfig
from serverless_learn_tpu.training.optimizer import (
    make_optimizer as jax_make_optimizer, make_schedule as jax_make_schedule)
from serverless_learn_tpu_torch.config import OptimizerConfig
from serverless_learn_tpu_torch.training.optimizer import (
    global_norm, lr_at, make_optimizer, make_schedule)

SHAPES = {"w": (4, 3), "b": (3,), "e": (5, 2)}
STEPS = 5
# f32 on both sides, the same formulas in another operation order (FMAs,
# f32 vs f64 powers in the bias correction): a few ulps of each param.
TOL = dict(rtol=1e-6, atol=1e-7)

CASES = {
    "adamw_decay_mask_clip_cosine": dict(
        name="adamw", learning_rate=1e-2, weight_decay=0.1, warmup_steps=2,
        decay_steps=4, grad_clip_norm=1.0),
    "adamw_decay_all_no_clip": dict(
        name="adamw", learning_rate=3e-3, weight_decay=0.05,
        decay_exclude_1d=False),
    "adam_linear_warmup_clip": dict(
        name="adam", learning_rate=1e-2, warmup_steps=3, grad_clip_norm=0.5,
        b1=0.8, b2=0.99),
    "sgd_momentum_constant": dict(name="sgd", learning_rate=0.1,
                                  momentum=0.9),
    "sgd_momentum_clip_cosine": dict(
        name="sgd", learning_rate=0.1, momentum=0.5, warmup_steps=1,
        decay_steps=3, grad_clip_norm=2.0),
}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_optax(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    params0 = _tree(rng)
    grads = [_tree(rng, scale=0.2 + i) for i in range(STEPS)]  # some clip

    tx = jax_make_optimizer(JOptimizerConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = tx.init(jp)
    opt = make_optimizer(OptimizerConfig(**kw))
    names = sorted(SHAPES)
    tp = [torch.from_numpy(params0[k].copy()) for k in names]
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        opt.update(tp, [torch.from_numpy(g[k].copy()) for k in names],
                   tstate)
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **TOL,
                                       err_msg=f"{case}: {k}")
    assert tstate["count"] == STEPS


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_optax(case):
    kw = CASES[case]
    want = jax_make_schedule(JOptimizerConfig(**kw))
    got = make_schedule(OptimizerConfig(**kw))
    for count in range(8):
        ref = want(count) if callable(want) else want
        np.testing.assert_allclose(lr_at(got, count), float(ref), rtol=1e-6,
                                   atol=1e-9)
    if kw.get("warmup_steps"):
        assert lr_at(got, 0) == 0.0  # the first update under warmup


def test_global_norm_and_clip_have_no_epsilon():
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    assert float(global_norm(g)) == 5.0
    opt = make_optimizer(OptimizerConfig(name="sgd", learning_rate=1.0,
                                         momentum=0.0, grad_clip_norm=1.0))
    p = [torch.zeros(2), torch.zeros(1, 1)]
    opt.update(p, g, opt.init(p))
    # optax: g / norm * limit exactly; clip_grad_norm_ would use norm + 1e-6.
    assert p[0].tolist() == [-0.6000000238418579, 0.0]
    assert p[1].tolist() == [[-0.800000011920929]]


def test_unported_and_invalid_optimizers_raise():
    for name in ("adafactor", "lion", "rmsprop"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_optimizer(OptimizerConfig(name=name))
    with pytest.raises(ValueError, match="weight_decay"):
        make_optimizer(OptimizerConfig(name="adam", weight_decay=0.1))
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptimizerConfig(name="adagrad"))
