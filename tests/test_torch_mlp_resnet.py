"""The port's image families against the JAX package's, on the CPU at small
sizes: ``mlp_mnist`` and ``resnet18_cifar`` (num_filters 8, or 32 for
group norm, whose 32 groups need 32 channels; 16x16 images) in all three
norms, with their stride-2 SAME convs; the ResNet-50 stems (space-to-depth
at 64x64, the classic 7x7/2 at 33x33, both with the SAME max-pool) over
one bottleneck stage; BatchNorm's running statistics after two sgd steps
and eval on them; ``device_crop_flip``; the registered models' trees
(paths and shapes at the registered widths) and FLOP counts.

The same numpy weights reach both packages (``bridge.from_jax_variables``)
and the same numpy batches both losses; the weights are drawn in the
port's tree, which ``test_registered_trees_match_jax`` holds to the
reference's. Comparisons run in f32 unless named bf16: XLA and ATen
convolve and reduce in other orders, so values agree to f32 round-off
grown through the network, not bit for bit. The reference's functions are
compiled at XLA's lowest optimisation level without its CPU fusion
emitters (the same results; the compile, which is most of this file's
time, takes a third as long).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from serverless_learn_tpu.models import resnet as jresnet
from serverless_learn_tpu.models.registry import get_model as jax_get_model
from serverless_learn_tpu_torch.bridge import (from_jax_variables, nest,
                                               to_jax_params, to_jax_variables)
from serverless_learn_tpu_torch.config import (ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.models import layers
from serverless_learn_tpu_torch.models import resnet as presnet
from serverless_learn_tpu_torch.models.registry import get_model
from serverless_learn_tpu_torch.training.loop import step_flops
from serverless_learn_tpu_torch.training.train_step import Trainer
from serverless_learn_tpu_torch.training.optimizer import make_optimizer

B = 4
# f32: the loss and logits to a few f32 ulps of their size; gradients to
# 2e-4 of each leaf's largest entry (a conv gradient sums B*H*W products),
# plus 1e-5 of the largest gradient anywhere: BatchNorm's backward
# subtracts two sums of like size, so a norm's bias or scale gradient can
# cancel to far below the terms whose round-off it keeps.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL, GRAD_FLOOR = 2e-4, 1e-5
# bf16 products: each layer's output rounds to 8 bits of mantissa on both
# sides, in other orders; the MLP's logits part by a few bf16 ulps of their
# size, its gradients by a few percent of each leaf's largest entry.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# XLA's lowest optimisation level, without its CPU fusion emitters: the
# same results, compiled in a third of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_cpu_use_fusion_emitters": False}
_COMPILED = {}


def _compile(fn, *args, key=None):
    """``fn`` compiled for ``args``; with ``key``, once for the file."""
    if key in _COMPILED:
        return _COMPILED[key]
    out = jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)
    if key is not None:
        _COMPILED[key] = out
    return out


def _variables(bundle, seed=0):
    """Random flax variables in the tree of ``bundle``'s model: kernels
    normal with variance 1/fan_in, norm scales near 1 (the zero initial
    scale of a branch's last norm would hide its convs from the
    gradients), biases and running means near 0, running variances in
    [0.5, 1.5]."""
    model = bundle.build("meta")
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if leaf == "scale":
            return (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    out = {"params": nest({n: fill(n, bundle.flax_shape(n, p.shape))
                           for n, p in model.named_parameters()})}
    buffers = dict(model.named_buffers())
    if buffers:
        out["batch_stats"] = nest({n: fill(n, tuple(b.shape))
                                   for n, b in buffers.items()})
    return out


def _port_model(bundle, variables):
    model = bundle.build("cpu", trainable=True)
    with torch.no_grad():
        model.load_state_dict(from_jax_variables(variables))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _assert_tree_close(got: dict, want, rel=GRAD_REL, floor=GRAD_FLOOR,
                       what="grad"):
    """Leaf by leaf: max |got - want| <= rel * max |leaf| + floor * the
    largest |entry| of the whole tree."""
    flat_w = dict((jax.tree_util.keystr(p), np.asarray(x)) for p, x in
                  jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict((jax.tree_util.keystr(p), np.asarray(x)) for p, x in
                  jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    top = max(float(np.abs(w).max()) for w in flat_w.values())
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max())
        bound = rel * float(np.abs(w).max()) + floor * top
        assert err <= bound, f"{what} {k}: {err} vs {bound}"


def _grads(model):
    return to_jax_params({n: p.grad for n, p in model.named_parameters()},
                         None)


def _grad_fn(bundle):
    """value_and_grad of a reference bundle's loss over (params,
    model_state, batch)."""
    return jax.value_and_grad(
        lambda p, ms, b: bundle.loss_fn(p, b, model_state=ms), has_aux=True)


def _run_both(name, port_overrides, jax_overrides, batch, variables):
    """(JAX loss, aux, grads), (port loss, aux, model): one training-mode
    loss and its gradients on each side."""
    jb = jax_get_model(name, **jax_overrides)
    ms = {k: v for k, v in variables.items() if k != "params"}
    key = (name, *sorted(jax_overrides.items()))
    (jl, jaux), jg = _compile(_grad_fn(jb), variables["params"], ms, batch,
                              key=key)(variables["params"], ms, batch)
    pb = get_model(name, **port_overrides)
    model = _port_model(pb, variables)
    loss, aux = pb.loss_fn(model, _torch_batch(batch))
    loss.backward()
    return (jl, jaux, jg), (loss, aux, model)


# ------------------------------------------------------------------ MLP --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_mnist_matches_jax(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jb = jax_get_model("mlp_mnist", dtype=jdt)
    batch = jb.make_batch(np.random.default_rng(1), None, B)
    variables = _variables(get_model("mlp_mnist"))
    (jl, jaux, jg), (loss, aux, model) = _run_both(
        "mlp_mnist", {"dtype": dtype}, {"dtype": jdt}, batch, variables)
    tol = LOSS_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(loss.item(), float(jl), **tol)
    assert float(aux["metrics"]["accuracy"]) == pytest.approx(
        float(jaux["metrics"]["accuracy"]))
    _assert_tree_close(_grads(model), jg,
                       GRAD_REL if dtype == "float32" else 5e-2)
    # The image flattens in NHWC order: a permuted batch parts the two.
    logits = model(torch.from_numpy(batch["image"]))
    want = jb.module.apply({"params": variables["params"]}, batch["image"])
    np.testing.assert_allclose(logits.float().detach().numpy(),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------- ResNet --

RESNET18 = {"batch": 8, "group": 32, "none": 8}  # norm -> num_filters


def _r18(norm, dtype="float32"):
    nf = RESNET18[norm]
    port = dict(norm=norm, num_filters=nf, image_shape=(16, 16, 3),
                dtype=dtype)
    jax_ = dict(port, dtype=jnp.dtype(dtype))
    return port, jax_


@pytest.mark.parametrize("norm", sorted(RESNET18))
def test_resnet18_cifar_matches_jax(norm):
    port, jax_ = _r18(norm)
    jb = jax_get_model("resnet18_cifar", **jax_)
    batch = jb.make_batch(np.random.default_rng(2), None, B)
    variables = _variables(get_model("resnet18_cifar", **port), seed=3)
    (jl, jaux, jg), (loss, aux, model) = _run_both(
        "resnet18_cifar", port, jax_, batch, variables)
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    assert float(aux["metrics"]["accuracy"]) == pytest.approx(
        float(jaux["metrics"]["accuracy"]))
    _assert_tree_close(_grads(model), jg)
    stats = to_jax_variables(model).get("batch_stats")
    if norm == "batch":
        # The training forward moved the running statistics as flax's
        # mutable batch_stats: ra = 0.9 ra + 0.1 batch, biased variance.
        _assert_tree_close(stats, jaux["model_state"]["batch_stats"],
                           rel=1e-5, what="batch_stats")
    else:
        assert stats is None and not jaux["model_state"]


def test_batch_stats_after_two_sgd_steps_and_eval():
    """Two steps of sgd (lr 0.1, momentum 0.9) through the port's trainer,
    the reference's loss and gradients stepped by hand beside it: the
    parameters, the momentum and the running statistics agree, and so
    does eval on the running statistics (the bundle's eval_loss_fn)."""
    port, jax_ = _r18("batch")
    jb = jax_get_model("resnet18_cifar", **jax_)
    batches = [jb.make_batch(np.random.default_rng(10 + i), None, B)
               for i in range(3)]
    pb = get_model("resnet18_cifar", **port)
    variables = _variables(pb, seed=6)
    cfg = ExperimentConfig(
        model="resnet18_cifar", model_overrides=port,
        optimizer=OptimizerConfig(name="sgd", learning_rate=0.1,
                                  momentum=0.9),
        train=TrainConfig(batch_size=B, dtype="float32"))
    tr = Trainer(config=cfg, bundle=pb, device=torch.device("cpu"),
                 optimizer=make_optimizer(cfg.optimizer))
    state = tr.init(params=from_jax_variables(variables))
    tx = optax.sgd(0.1, momentum=0.9)
    params, ms = variables["params"], {"batch_stats": variables[
        "batch_stats"]}
    opt = tx.init(params)
    step = _compile(_grad_fn(jb), params, ms, batches[0],
                    key=("resnet18_cifar", *sorted(jax_.items())))
    for b in batches[:2]:
        (_, aux), g = step(params, ms, b)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        ms = aux["model_state"]
        state, _ = tr.step(state, tr.place(b))
    got = to_jax_variables(state.model)
    _assert_tree_close(got["params"], params, rel=1e-4, what="param")
    _assert_tree_close(got["batch_stats"], ms["batch_stats"], rel=1e-4,
                       what="batch_stats")
    tree = tr.state_tree(state)
    assert set(tree["model_state"]) == {"batch_stats"}
    # Eval on the running statistics, which it leaves as they are.
    evl = jb.eval_loss_fn
    jl, _ = _compile(lambda p, m, b: evl(p, b, model_state=m), params, ms,
                     batches[2])(params, ms, batches[2])
    before = {n: b.clone() for n, b in state.model.named_buffers()}
    metrics = tr.eval_step(state, tr.place(batches[2]))
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=1e-4, atol=1e-4)
    assert all(torch.equal(b, before[n])
               for n, b in state.model.named_buffers())


STEMS = {"s2d_64": (64, True), "classic_33": (33, True)}


@pytest.mark.parametrize("stem", sorted(STEMS))
def test_resnet50_stems_match_jax(stem):
    """The ImageNet stems over one bottleneck stage, uint8 input
    normalised on the device: 64x64 takes the 2x2 space-to-depth 4x4/1
    stem (SAME pads (1, 2)), 33x33 (odd) the 7x7/2 stem (SAME pads
    (3, 3)); then the 3x3/2 SAME max-pool, pads (0, 1) at 32 with -inf."""
    hw, s2d = STEMS[stem]
    shape = (hw, hw, 3)
    jmod = jresnet.ResNet(stage_sizes=(1,), block_cls=jresnet.BottleneckBlock,
                          num_classes=10, num_filters=8, dtype=jnp.float32,
                          small_images=False, space_to_depth=s2d)
    jb = jresnet._bundle(jmod, 10, shape, input_dtype="uint8")
    cfg = presnet.ResNetConfig(stage_sizes=(1,), bottleneck=True,
                               num_classes=10, num_filters=8,
                               image_shape=shape, small_images=False,
                               space_to_depth=s2d, dtype="float32")
    assert cfg.stem == ("s2d" if s2d and hw % 2 == 0 else "classic")
    pb = presnet._bundle(cfg, input_dtype="uint8")
    batch = jb.make_batch(np.random.default_rng(7), None, 2)
    variables = _variables(pb, seed=8)
    ms = {"batch_stats": variables["batch_stats"]}
    fn = jax.value_and_grad(
        lambda p, m, b: jb.loss_fn(p, b, model_state=m), has_aux=True)
    (jl, jaux), jg = _compile(fn, variables["params"], ms, batch)(
        variables["params"], ms, batch)
    model = _port_model(pb, variables)
    loss, _ = pb.loss_fn(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    _assert_tree_close(_grads(model), jg)
    _assert_tree_close(to_jax_variables(model)["batch_stats"],
                       jaux["model_state"]["batch_stats"], rel=1e-5,
                       what="batch_stats")


@pytest.mark.parametrize("name, overrides, example", [
    ("mlp_mnist", {}, (1, 28, 28, 1)),
    ("resnet18_cifar", {}, (1, 32, 32, 3)),
    ("resnet50_imagenet", {}, (1, 224, 224, 3)),
], ids=["mlp_mnist", "resnet18_cifar", "resnet50_imagenet"])
def test_registered_trees_match_jax(name, overrides, example):
    """At the registered widths, the port's tree (paths, flax shapes, the
    zero-initialised branch scales) is the reference's, and a bridged
    round trip is exact."""
    jb = jax_get_model(name, **overrides)
    dt = jnp.uint8 if name == "resnet50_imagenet" else jnp.float32
    want = jax.eval_shape(lambda: jb.module.init(
        jax.random.PRNGKey(0), jnp.zeros(example, dt)))
    pb = get_model(name, **overrides)
    model = pb.build("meta")
    got = {"params": {n: pb.flax_shape(n, p.shape)
                      for n, p in model.named_parameters()}}
    if list(model.named_buffers()):
        got["batch_stats"] = {n: tuple(b.shape)
                              for n, b in model.named_buffers()}
    flat = {jax.tree_util.keystr(p)
            .replace("']['", ".").strip("[']"): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {f"{col}.{n}": s for col, d in got.items() for n, s in d.items()}
    assert mine == flat
    if name == "resnet18_cifar":
        small = get_model(name, num_filters=4, image_shape=(8, 8, 3))
        m = layers.init_layers(small.build("cpu"), seed=1)
        zero = [n for n, p in m.named_parameters()
                if n.endswith(".scale") and not p.any()]
        assert zero == [f"ResNetBlock_{i}.BatchNorm_1.scale"
                        for i in range(8)]
        back = from_jax_variables(to_jax_variables(m))
        assert all(torch.equal(back[n], t) for n, t in
                   m.state_dict().items())


def test_device_crop_flip_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (4, 12, 10, 3)).astype(np.uint8)
    ys, xs = np.array([0, 4, 2, 1]), np.array([2, 0, 3, 1])
    flip = np.array([True, False, True, False])
    want = jresnet.device_crop_flip(jnp.asarray(x), jnp.asarray(ys),
                                    jnp.asarray(xs), jnp.asarray(flip), 8, 7)
    got = presnet.device_crop_flip(torch.from_numpy(x), torch.from_numpy(ys),
                                   torch.from_numpy(xs),
                                   torch.from_numpy(flip), 8, 7)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size, k, s, pads", [
    (32, 3, 2, (0, 1)), (224, 7, 2, (2, 3)), (112, 4, 1, (1, 2)),
    (112, 3, 2, (0, 1)), (33, 7, 2, (3, 3)), (32, 1, 2, (0, 0)),
    (16, 3, 1, (1, 1))])
def test_same_pads_are_xla_s(size, k, s, pads):
    want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert layers.same_pads(size, k, s) == tuple(want) == pads


def test_image_flops_count_every_conv_and_dense():
    """ResNet-18 CIFAR's forward is 0.56 G multiply-adds a 32x32 image
    (the published figure), here summed conv by conv; the MLP's 784*512 +
    512*512 + 512*10; a step is 6x that a sample."""
    def conv(hw, c_in, c_out, k):
        return hw * hw * c_out * c_in * k * k

    want = conv(32, 3, 64, 3) + 4 * conv(32, 64, 64, 3) + 512 * 10
    for i, c in enumerate((128, 256, 512)):
        hw = 16 >> i
        want += (conv(hw, c // 2, c, 3) + 3 * conv(hw, c, c, 3)
                 + conv(hw, c // 2, c, 1))
    assert get_model("resnet18_cifar").macs() == want == 555_422_720
    assert get_model("mlp_mnist").macs() == 784 * 512 + 512 * 512 + 5120
    cfg = ExperimentConfig(model="mlp_mnist",
                           train=TrainConfig(batch_size=128))
    tr = Trainer(config=cfg, bundle=get_model("mlp_mnist"),
                 device=torch.device("cpu"),
                 optimizer=make_optimizer(cfg.optimizer))
    assert step_flops(cfg, tr, None) == 6.0 * 128 * (
        784 * 512 + 512 * 512 + 5120)
