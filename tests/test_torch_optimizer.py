"""The port's optimizers and schedules against optax, through the JAX
package's ``make_optimizer`` / ``make_schedule``: five updates of a small
tree (two matrices and a vector, so the decay mask matters) from the same
numpy gradients, the params compared after every update; adafactor, lion
and rmsprop also over a tree with leaves of 128 and more on two dims (which
adafactor factors), and every chain's ``state_tree`` against flax's
``to_state_dict`` of optax's state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from serverless_learn_tpu.config import OptimizerConfig as JOptimizerConfig
from serverless_learn_tpu.training.optimizer import (
    make_optimizer as jax_make_optimizer, make_schedule as jax_make_schedule)
from serverless_learn_tpu_torch.config import OptimizerConfig
from serverless_learn_tpu_torch.training.optimizer import (
    factored_dims, global_norm, lr_at, make_optimizer, make_schedule)
from serverless_learn_tpu_torch.utils.serialization import Seq

SHAPES = {"w": (4, 3), "b": (3,), "e": (5, 2)}
STEPS = 5
# f32 on both sides, the same formulas in another operation order (FMAs,
# f32 vs f64 powers in the bias correction): a few ulps of each param.
TOL = dict(rtol=1e-6, atol=1e-7)

# With leaves that adafactor factors: a matrix with both dims >= 128 and a
# 3-D leaf whose two largest dims are (over the first, the smallest).
SHAPES_WIDE = {**SHAPES, "f": (128, 160), "g": (3, 140, 130)}

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
    "adafactor_factored_constant": dict(name="adafactor",
                                        learning_rate=1e-2),
    "adafactor_unfactored_clip_cosine": dict(
        name="adafactor", learning_rate=1e-2, warmup_steps=1,
        decay_steps=4, grad_clip_norm=1.0),
    "lion_decay_mask_clip": dict(
        name="lion", learning_rate=1e-3, weight_decay=0.1,
        grad_clip_norm=1.0, b1=0.9, b2=0.99),
    "lion_decay_all_warmup": dict(
        name="lion", learning_rate=3e-4, weight_decay=0.05,
        decay_exclude_1d=False, warmup_steps=2),
    "rmsprop_momentum_constant": dict(name="rmsprop", learning_rate=1e-3,
                                      momentum=0.9),
    "rmsprop_no_momentum_clip_cosine": dict(
        name="rmsprop", learning_rate=1e-3, momentum=None, warmup_steps=1,
        decay_steps=4, grad_clip_norm=2.0),
}
# The new optimizers' cases run over SHAPES_WIDE but adafactor's
# unfactored one, which keeps every leaf under 128 on some dim.
WIDE = {c for c in CASES if c.split("_")[0] in ("lion", "rmsprop")
        or c == "adafactor_factored_constant"}


def _tree(rng, scale=1.0, shapes=SHAPES):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _run_both(case, steps=STEPS, check=None):
    """``steps`` updates of optax's chain and the port's from the same
    params and gradients; ``check(names, port params, jax params)`` after
    each. Returns (port optimizer, its state, names, optax state)."""
    kw = CASES[case]
    shapes = SHAPES_WIDE if case in WIDE else SHAPES
    rng = np.random.default_rng(0)
    params0 = _tree(rng, shapes=shapes)
    grads = [_tree(rng, scale=0.2 + i, shapes=shapes)
             for i in range(steps)]  # some clip

    tx = jax_make_optimizer(JOptimizerConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = tx.init(jp)
    opt = make_optimizer(OptimizerConfig(**kw))
    names = sorted(shapes)
    tp = [torch.from_numpy(params0[k].copy()) for k in names]
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        opt.update(tp, [torch.from_numpy(g[k].copy()) for k in names],
                   tstate)
        if check is not None:
            check(names, tp, jp)
    return opt, tstate, names, jstate


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_optax(case):
    def check(names, tp, jp):
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **TOL,
                                       err_msg=f"{case}: {k}")

    _, tstate, _, _ = _run_both(case, check=check)
    assert tstate["count"] == STEPS


def _plain(tree):
    """A state tree as nested dicts of numpy arrays: the port's Seq and
    Struct nodes, or flax's to_state_dict (tuples as "0", "1", ...)."""
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, sorted(got) if isinstance(got, dict) else got, sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, (
        path, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, **TOL, err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_tree_is_optax_layout(case):
    """The port's ``state_tree`` after three updates: the nesting, every
    leaf's shape and dtype, the counts, and the moments' values (within
    TOL) of flax's ``to_state_dict`` of optax's state."""
    opt, tstate, names, jstate = _run_both(case, steps=3)

    def nest(tensors, as_params=True):
        return dict(zip(names, tensors))

    tree = opt.state_tree(tstate, nest)
    assert isinstance(tree, Seq)
    _assert_same_tree(_plain(tree),
                      _plain(flax_serialization.to_state_dict(jstate)))


def test_adafactor_factors_as_optax():
    """optax's rule: the two largest dims, the smaller of them >= 128."""
    assert factored_dims((4, 3)) is None and factored_dims((128,)) is None
    assert factored_dims((127, 4096)) is None
    assert factored_dims((128, 160)) == (0, 1)
    assert factored_dims((3, 140, 130)) == (2, 1)
    assert factored_dims((4096, 16)) is None  # a rank-16 LoRA adapter


@pytest.mark.parametrize("name", ["adafactor", "rmsprop"])
def test_new_optimizers_refuse_weight_decay(name):
    with pytest.raises(ValueError, match="weight_decay"):
        make_optimizer(OptimizerConfig(name=name, weight_decay=0.1))
    make_optimizer(OptimizerConfig(name="lion", weight_decay=0.1))


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
    with pytest.raises(ValueError, match="weight_decay"):
        make_optimizer(OptimizerConfig(name="adam", weight_decay=0.1))
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptimizerConfig(name="adagrad"))
