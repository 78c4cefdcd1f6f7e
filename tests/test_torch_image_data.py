"""The port's image and MLM data path against the JAX package's, on the CPU:

* the transforms (``image_transform`` in the pad-4 CIFAR and the
  oversized-crop geometries, ``mlm_transform``, ``auto_transform``) give
  the same batches bit for bit at the same seed, and interior padding
  raises in both;
* ``load_idx`` / ``load_mnist`` / ``load_cifar10`` read files this test
  writes in each format, gzipped too, as the reference's loaders do;
* ``publish --format mnist|cifar10`` round-trips through the port's shard
  server, and ``imagefolder`` still refuses;
* ``data.learnable``, ``data.augment`` and ``data.mask_rate`` take
  effect, as the reference's do (the port refused them before it ran
  them);
* a ResNet checkpoint with ``batch_stats`` restores across the two
  packages in both directions, bit for bit;
* ``train`` and ``eval`` of the image families over published data, and
  ``models``, on the command line.

No JAX function is compiled here: the reference's data path is numpy.
"""

import gzip
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.config import DataConfig as JDataConfig
from serverless_learn_tpu.config import ExperimentConfig as JExperimentConfig
from serverless_learn_tpu.config import OptimizerConfig as JOptimizerConfig
from serverless_learn_tpu.config import TrainConfig as JTrainConfig
from serverless_learn_tpu.data import raw as jraw
from serverless_learn_tpu.data import transforms as jtf
from serverless_learn_tpu.data.datasets import SyntheticSource as JSource
from serverless_learn_tpu.models.registry import get_model as jax_get_model
from serverless_learn_tpu.models.registry import list_models as jax_models
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu.training.loop import make_source as jax_make_source
from serverless_learn_tpu.training.optimizer import (
    make_optimizer as jax_make_optimizer)
from serverless_learn_tpu.training.train_state import TrainState as JState
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.control import client as pclient
from serverless_learn_tpu_torch.control import daemons as pd
from serverless_learn_tpu_torch.data import raw as praw
from serverless_learn_tpu_torch.data import shard_client as psc
from serverless_learn_tpu_torch.data import transforms as ptf
from serverless_learn_tpu_torch.data.datasets import SyntheticSource
from serverless_learn_tpu_torch.models.registry import get_model
from serverless_learn_tpu_torch.training.checkpoint import (Checkpointer,
                                                             LocalStore)
from serverless_learn_tpu_torch.training.loop import make_source
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils import serialization as ser


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def shard_server(request, tmp_path):
    srv = pd.ShardServer(root=str(tmp_path / "root")).start()
    request.addfinalizer(srv.stop)
    return srv


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _images(n=6, hw=(12, 10), seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8),
            "label": rng.integers(0, 10, n).astype(np.int32)}


# ------------------------------------------------------------ transforms --

GEOMETRIES = {
    "cifar_train": dict(train=True),
    "cifar_eval": dict(train=False),
    "oversized_train": dict(train=True, out_hw=(8, 7)),
    "oversized_eval": dict(train=False, out_hw=(8, 7)),
    "uint8_train": dict(train=True, dtype=np.uint8, crop_pad=2),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_image_transform_matches_jax_bit_for_bit(geometry):
    kw = GEOMETRIES[geometry]
    ours = ptf.image_transform(seed=5, **kw)
    theirs = jtf.image_transform(seed=5, **kw)
    for i in range(3):  # the generator advances batch to batch alike
        batch = _images(seed=i)
        _same(ours(batch), theirs(batch))
    with pytest.raises(ValueError, match="smaller than"):
        ptf.image_transform(train=True, out_hw=(20, 20))(_images())


def test_mlm_transform_matches_jax_and_refuses_interior_padding():
    rng = np.random.default_rng(1)
    lengths = np.array([16, 9, 1, 0])
    ids = np.where(np.arange(16)[None] < lengths[:, None],
                   rng.integers(4, 260, (4, 16)), 0).astype(np.int32)
    ours = ptf.mlm_transform(260, mask_rate=0.4, seed=3)
    theirs = jtf.mlm_transform(260, mask_rate=0.4, seed=3)
    for _ in range(3):
        a, b = ours({"input_ids": ids}), theirs({"input_ids": ids})
        _same(a, b)
        assert not (a["mlm_mask"] & (ids == 0)).any()  # never a pad
    assert a["attn_mask"].sum(1).tolist() == lengths.tolist()
    bad = ids.copy()
    bad[0, 3] = 0
    for fn in (ours, theirs):
        with pytest.raises(ValueError, match="interior padding"):
            fn({"input_ids": bad})


def _fields(arrays):
    return [psc.FieldSpec(k, str(v.dtype), tuple(v.shape[1:]))
            for k, v in sorted(arrays.items())]


@pytest.mark.parametrize("name, overrides, train, augment", [
    ("mlp_mnist", {"image_shape": (12, 10, 3)}, True, False),
    ("resnet18_cifar", {"image_shape": (12, 10, 3)}, True, True),
    ("resnet18_cifar", {"image_shape": (12, 10, 3)}, False, True),
    ("resnet50_imagenet", {"image_shape": (8, 7, 3)}, True, True),
    ("resnet50_imagenet", {"image_shape": (8, 7, 3)}, False, True),
], ids=["mlp_convert", "r18_augment", "r18_eval", "r50_crop_train",
        "r50_center_eval"])
def test_auto_transform_matches_jax_for_images(name, overrides, train,
                                               augment):
    batch = _images()
    jb = jax_get_model(name, **overrides)
    pb = get_model(name, **overrides)
    dc = DataConfig()
    theirs = jtf.auto_transform(_fields(batch), jb.input_spec(dc, 6),
                                task=jb.task, train=train, seed=2,
                                augment=augment)
    ours = ptf.auto_transform(_fields(batch), pb.input_spec(dc, 6),
                              task=pb.task, train=train, seed=2,
                              augment=augment)
    assert theirs is not None and ours is not None
    for _ in range(2):
        _same(ours(batch), theirs(batch))


def test_auto_transform_for_token_rows_and_the_rest():
    ids = {"input_ids": np.arange(1, 17, dtype=np.int32).reshape(2, 8)}
    for task, name in (("mlm", "bert_tiny"), ("lm", "llama_tiny")):
        dc = DataConfig(seq_len=8)
        pb, jb = get_model(name), jax_get_model(name)
        ours = ptf.auto_transform(_fields(ids), pb.input_spec(dc, 2), task,
                                  train=True, seed=4, mask_rate=0.5,
                                  vocab_size=pb.cfg.vocab_size)
        theirs = jtf.auto_transform(_fields(ids), jb.input_spec(
            JDataConfig(seq_len=8), 2), task, train=True, seed=4,
            mask_rate=0.5, vocab_size=jb.module.cfg.vocab_size)
        _same(ours(ids), theirs(ids))
    with pytest.raises(ValueError, match="no transform bridges"):
        ptf.auto_transform(_fields({"x": ids["input_ids"]}),
                           pb.input_spec(dc, 2), "lm", train=True)


# --------------------------------------------------------------- loaders --


def _idx(arr: np.ndarray, code: int) -> bytes:
    head = bytes([0, 0, code, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    return head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()


def _write_mnist(root, n=20, seed=0, learnable=True, gz=False):
    """An MNIST directory of ``n`` records; labels from a fixed projection
    of the image when ``learnable``."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
    if learnable:
        proj = np.random.default_rng(7).standard_normal((784, 10))
        lab = np.argmax((img.reshape(n, -1) / 255.0) @ proj, 1)
    else:
        lab = rng.integers(0, 10, n)
    root.mkdir(parents=True, exist_ok=True)
    for name, data in (("train-images-idx3-ubyte", _idx(img, 0x08)),
                       ("train-labels-idx1-ubyte",
                        _idx(lab.astype(np.uint8), 0x08))):
        if gz:
            (root / (name + ".gz")).write_bytes(gzip.compress(data))
        else:
            (root / name).write_bytes(data)
    return img, lab


def _write_cifar(root, n=12, seed=0, gz=False):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    proj = np.random.default_rng(7).standard_normal((3072, 10))
    lab = np.argmax((img.reshape(n, -1) / 255.0) @ proj, 1).astype(np.uint8)
    recs = np.concatenate([lab[:, None], img.transpose(0, 3, 1, 2).reshape(
        n, -1)], 1).astype(np.uint8).tobytes()
    base = root / "cifar-10-batches-bin"
    base.mkdir(parents=True, exist_ok=True)
    if gz:
        (base / "data_batch_1.bin.gz").write_bytes(gzip.compress(recs))
    else:
        (base / "data_batch_1.bin").write_bytes(recs)
    return img, lab


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_loaders_read_what_the_reference_reads(tmp_path, gz):
    img, lab = _write_mnist(tmp_path / "mnist", gz=gz)
    ours = praw.load_mnist(str(tmp_path / "mnist"))
    _same(ours, jraw.load_mnist(str(tmp_path / "mnist")))
    assert np.array_equal(ours["image"][..., 0], img)
    assert ours["label"].tolist() == lab.tolist()
    f = tmp_path / "x.idx"
    f.write_bytes(_idx(np.arange(6, dtype=np.int32).reshape(2, 3), 0x0C))
    assert np.array_equal(praw.load_idx(str(f)), jraw.load_idx(str(f)))
    f.write_bytes(b"\x01\x00\x08\x01")
    with pytest.raises(ValueError, match="not an IDX"):
        praw.load_idx(str(f))
    cimg, clab = _write_cifar(tmp_path / "cifar", gz=gz)
    ours = praw.load_cifar10(str(tmp_path / "cifar"))
    _same(ours, jraw.load_cifar10(str(tmp_path / "cifar")))
    assert np.array_equal(ours["image"], cimg)  # CHW planes -> HWC
    assert ours["label"].tolist() == clab.tolist()


def _cli_json(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _published(addr, dataset):
    meta = psc.load_meta(addr, dataset)
    client = pclient.ShardClient(addr)
    try:
        parts = []
        for i in range(meta.num_shards):
            lo, hi = meta.shard_range(i)
            parts.append(psc.decode_shard(
                meta, client.fetch(psc.shard_key(dataset, i)), hi - lo))
    finally:
        client.close()
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_publish_mnist_and_cifar10_round_trip(shard_server, tmp_path,
                                              capsys):
    _write_mnist(tmp_path / "m", n=10, gz=True)
    _write_cifar(tmp_path / "c", n=9)
    for fmt, d, ds in (("mnist", "m", "mn"), ("cifar10", "c", "cf")):
        pub = _cli_json(capsys, ["publish", "--shard-server",
                                 shard_server.addr, "--dataset", ds,
                                 "--format", fmt, "--path",
                                 str(tmp_path / d), "--records-per-shard",
                                 "4"])
        assert pub["fields"] == ["image", "label"] and pub["num_shards"] == 3
        want = jraw.LOADERS[fmt](str(tmp_path / d), split="train")
        _same(_published(shard_server.addr, ds), want)
    with pytest.raises(SystemExit, match="imagefolder.*not yet ported"):
        cli.main(["publish", "--shard-server", shard_server.addr,
                  "--dataset", "i", "--format", "imagefolder", "--path",
                  str(tmp_path)])


# --------------------------------------------- the three data fields --


def test_data_learnable_takes_effect():
    """mlp_mnist's labels become the argmax of the image's projection by
    the fixed seed-771 matrix, the reference's batches bit for bit."""
    cfg = ExperimentConfig.from_dict({"model": "mlp_mnist",
                                      "data": {"learnable": True}})
    assert cfg.data.learnable
    pb, jb = get_model("mlp_mnist"), jax_get_model("mlp_mnist")
    ours = next(iter(SyntheticSource(pb.make_batch, cfg.data, 16, seed=1)))
    theirs = next(iter(JSource(jb.make_batch, JDataConfig(learnable=True),
                               16, seed=1)))
    _same(ours, theirs)
    proj = np.random.default_rng(771).standard_normal((784, 10))
    assert ours["label"].tolist() == np.argmax(
        ours["image"].reshape(16, -1) @ proj.astype(np.float32), -1).tolist()
    plain = next(iter(SyntheticSource(pb.make_batch, DataConfig(), 16,
                                      seed=1)))
    assert not np.array_equal(plain["label"], ours["label"])


def _stub(name, overrides):
    return types.SimpleNamespace(bundle=jax_get_model(name, **overrides))


def _configs(name, overrides, data):
    tc = dict(batch_size=4, seed=3)
    ours = ExperimentConfig(model=name, model_overrides=overrides,
                            train=TrainConfig(**tc), data=DataConfig(**data))
    theirs = JExperimentConfig(model=name, model_overrides=overrides,
                               train=JTrainConfig(**tc),
                               data=JDataConfig(**data))
    return ours, theirs


def _first(source):
    try:
        return next(iter(source))
    finally:
        source.close()


def test_data_augment_takes_effect(shard_server, tmp_path):
    """A streamed CIFAR dataset's training batches are cropped and flipped
    with ``data.augment``, as the reference's (same batches bit for bit);
    eval batches never are."""
    _write_cifar(tmp_path / "c", n=8)
    psc.publish_dataset(shard_server.addr, "cf",
                        praw.load_cifar10(str(tmp_path / "c")),
                        records_per_shard=8)
    over = {"num_filters": 4}
    batches = {}
    for augment in (False, True):
        data = dict(dataset="cf", shard_server_addr=shard_server.addr,
                    augment=augment)
        ours, theirs = _configs("resnet18_cifar", over, data)
        tr = types.SimpleNamespace(bundle=get_model("resnet18_cifar", **over))
        a = _first(make_source(ours, tr))
        _same(a, _first(jax_make_source(theirs, _stub("resnet18_cifar",
                                                      over))))
        batches[augment] = a
        ev = _first(make_source(ours, tr, seed=9, train=False))
        _same(ev, _first(jax_make_source(theirs, _stub(
            "resnet18_cifar", over), seed=9, train=False)))
    assert batches[False]["image"].dtype == np.float32
    assert not np.array_equal(batches[False]["image"], batches[True]["image"])
    assert np.array_equal(batches[False]["label"], batches[True]["label"])


def test_data_mask_rate_takes_effect(shard_server):
    """A streamed token dataset reaches bert_tiny masked at
    ``data.mask_rate``, as the reference's (same batches bit for bit)."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(40, 65, 16)
    ids = np.where(np.arange(64)[None] < lengths[:, None],
                   rng.integers(4, 260, (16, 64)), 0).astype(np.int32)
    psc.publish_dataset(shard_server.addr, "tok", {"input_ids": ids},
                        records_per_shard=8)
    frac = {}
    for rate in (0.15, 0.6):
        data = dict(dataset="tok", shard_server_addr=shard_server.addr,
                    seq_len=64, mask_rate=rate)
        ours, theirs = _configs("bert_tiny", {}, data)
        tr = types.SimpleNamespace(bundle=get_model("bert_tiny"))
        a = _first(make_source(ours, tr))
        _same(a, _first(jax_make_source(theirs, _stub("bert_tiny", {}))))
        frac[rate] = a["mlm_mask"].sum() / a["attn_mask"].sum()
    assert frac[0.15] < 0.3 < frac[0.6]


# ---------------------------------------------------------- checkpoints --

R18 = {"num_filters": 4, "image_shape": (8, 8, 3)}
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9)


def _jax_resnet_state(seed):
    """A reference TrainState of resnet18_cifar at ``R18`` with random
    leaves (step 5): params, sgd momentum, batch_stats, in the reference's
    tree, built from its module's shapes (no compile)."""
    jb = jax_get_model("resnet18_cifar", **R18)
    shapes = jax.eval_shape(lambda: jb.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    rng = np.random.default_rng(seed)
    fill = lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype)  # noqa
    params = jax.tree_util.tree_map(fill, shapes["params"])
    opt = jax_make_optimizer(JOptimizerConfig(**OPT)).init(params)
    opt = jax.tree_util.tree_map(
        lambda x: fill(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else jnp.full(x.shape, 5, x.dtype), opt)
    stats = jax.tree_util.tree_map(fill, shapes["batch_stats"])
    return JState(step=jnp.asarray(5, jnp.int32), params=params,
                  opt_state=opt, model_state={"batch_stats": stats})


def _port_resnet_trainer():
    cfg = ExperimentConfig(model="resnet18_cifar", model_overrides=R18,
                           optimizer=OptimizerConfig(**OPT),
                           train=TrainConfig(batch_size=2))
    return build_trainer(cfg, device="cpu")


def _assert_same_leaves(port_tree, jax_tree):
    got = [(p, t.detach()) for p, t in ser.leaves_with_paths(port_tree)]
    want = [(jax.tree_util.keystr(p), ser._as_tensor(np.asarray(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(jax_tree)[0]]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resnet_checkpoint_with_batch_stats_crosses_packages(tmp_path,
                                                             direction):
    jstate = _jax_resnet_state(seed=1)
    tr = _port_resnet_trainer()
    state = tr.init(seed=2)
    if direction == "jax_to_port":
        jck.Checkpointer(jck.LocalStore(str(tmp_path)), name="run",
                         async_save=False).save(jstate)
        tree = tr.state_tree(state)
        Checkpointer(LocalStore(str(tmp_path)), name="run").restore(tree)
        tr.load_tree(state, tree)
        assert state.step == 5
        _assert_same_leaves(tr.state_tree(state), jstate)
        # The restored running statistics are the model's BatchNorm
        # buffers (conv kernels went HWIO -> OIHW).
        bn = state.model.ResNetBlock_0.BatchNorm_0
        want = jstate.model_state["batch_stats"]["ResNetBlock_0"][
            "BatchNorm_0"]
        assert np.array_equal(bn.mean.numpy(), np.asarray(want["mean"]))
        assert np.array_equal(
            state.model.conv_init.kernel.detach().numpy(),
            np.asarray(jstate.params["conv_init"]["kernel"]).transpose(
                3, 2, 0, 1))
    else:
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for _, leaf in ser.leaves_with_paths(tr.state_tree(state)):
                if leaf.is_floating_point():
                    leaf.copy_(torch.randn(leaf.shape, generator=g))
        state.step, state.opt_state["count"] = 7, 7
        saver = Checkpointer(LocalStore(str(tmp_path)), name="run")
        assert saver.save(tr.state_tree(state)) == 7
        saver.close()
        back = jck.Checkpointer(jck.LocalStore(str(tmp_path)),
                                name="run").restore(jstate)
        _assert_same_leaves(tr.state_tree(state), back)


# ------------------------------------------------------ the command line --


def test_models_lists_the_reference_names(capsys):
    assert cli.main(["models"]) == 0
    assert capsys.readouterr().out.split() == jax_models()


def test_train_and_eval_image_families_over_published_data(shard_server,
                                                           tmp_path,
                                                           capsys):
    """``publish`` then ``train`` (with a checkpoint) and ``eval`` from it,
    for resnet18_cifar over CIFAR-10 with augmentation and mlp_mnist over
    MNIST; eval reads the running statistics back from the checkpoint."""
    _write_cifar(tmp_path / "c", n=16)
    _write_mnist(tmp_path / "m", n=16)
    for fmt, d in (("cifar10", "c"), ("mnist", "m")):
        _cli_json(capsys, ["publish", "--shard-server", shard_server.addr,
                           "--dataset", fmt, "--format", fmt, "--path",
                           str(tmp_path / d)])
    runs = {"resnet18_cifar": ["--set", "model_overrides.num_filters=4",
                               "--set", "data.augment=true", "--dataset",
                               "cifar10", "--optimizer", "sgd"],
            "mlp_mnist": ["--set", "model_overrides.features=[16]",
                          "--dataset", "mnist"]}
    for model, extra in runs.items():
        common = ["--model", model, "--batch-size", "4", "--device", "cpu",
                  "--shard-server", shard_server.addr, *extra,
                  "--checkpoint-dir", str(tmp_path / model)]
        done = _cli_json(capsys, ["train", *common, "--steps", "2"])
        assert done["final_step"] == 2 and np.isfinite(done["losses"]).all()
        ev = _cli_json(capsys, ["eval", *common, "--eval-steps", "2"])
        assert ev["checkpoint_step"] == 2 and np.isfinite(ev["eval_loss"])
        assert 0.0 <= ev["eval_accuracy"] <= 1.0
    with pytest.raises(NotImplementedError, match="imagefolder"):
        praw.LOADERS["imagefolder"](str(tmp_path))
