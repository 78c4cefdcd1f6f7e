"""The port's checkpoints against the JAX package's, on the CPU at
llama_tiny size:

* a checkpoint the reference's ``Checkpointer`` wrote, blob and sharded
  (also from a mesh of two devices), restores into the port bit for bit
  (params, moments, counts, step) for adamw + clip + warmup-cosine, adamw
  with unmasked decay and no clip, adam over bf16 params with a linear
  warmup, sgd with momentum, LoRA and QLoRA (int8 base, bf16 adapters);
  blobs with flax's chunk
  threshold lowered so the embedding and head are chunked;
* the port, writing the same state, writes the same bytes, and a state it
  writes restores in the reference (``restore`` and
  ``restore_params_host``) bit for bit;
* the codec: flax's bytes decode and re-encode to the same bytes;
* a run saved, restored into a fresh trainer and continued equals an
  uninterrupted one bit for bit;
* the corruption and fallback cases of ``tests/test_recover.py``;
* the command line: ``train --checkpoint-dir``, then ``eval`` (held to the
  reference's ``run_eval`` on the same checkpoint) and ``generate``.
"""

import functools
import itertools
import json
import os
import re
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from serverless_learn_tpu.config import (DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         MeshConfig as JMeshConfig,
                                         OptimizerConfig as JOptimizerConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu.training.loop import run_eval as jax_run_eval
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.bridge import port_shape
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.data.datasets import SyntheticSource
from serverless_learn_tpu_torch.inference.generate import generate
from serverless_learn_tpu_torch.inference.quantize import (
    random_quantized_params)
from serverless_learn_tpu_torch.training import checkpoint as ck
from serverless_learn_tpu_torch.training.checkpoint import (
    CheckpointCorrupt, Checkpointer, LocalStore)
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils import serialization as ser

# name -> (optimizer, model overrides, param dtype)
CHAINS = {
    "adamw": (dict(name="adamw", weight_decay=0.1, warmup_steps=1,
                   decay_steps=4, grad_clip_norm=1.0), {}, "float32"),
    # no clip (a one-state chain) and decay on every param (no mask)
    "adamw_unmasked": (dict(name="adamw", weight_decay=0.1,
                            decay_exclude_1d=False), {}, "float32"),
    "adam": (dict(name="adam", warmup_steps=3), {}, "bfloat16"),
    "sgd": (dict(name="sgd"), {}, "float32"),
    "lora": (dict(name="adamw", weight_decay=0.1, grad_clip_norm=1.0),
             {"lora_rank": 4}, "float32"),
    # QLoRA: int8 base leaves, bf16 adapters and moments
    "qlora": (dict(name="adamw"), {"lora_rank": 4, "quant": "int8"},
              "bfloat16"),
}
CHUNK = 4096  # bytes: the embedding and lm_head (256 KB each) are chunked


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # tiny ops lose to thread hand-offs


def _configs(chain):
    opt, overrides, pdt = CHAINS[chain]
    jcfg = JExperimentConfig(
        model="llama_tiny", model_overrides=dict(overrides),
        mesh=JMeshConfig(dp=1), optimizer=JOptimizerConfig(**opt),
        train=JTrainConfig(batch_size=2, dtype="float32", param_dtype=pdt),
        data=JDataConfig(seq_len=64))
    tcfg = ExperimentConfig(
        model="llama_tiny", model_overrides=dict(overrides),
        optimizer=OptimizerConfig(**opt),
        train=TrainConfig(batch_size=2, dtype="float32", param_dtype=pdt),
        data=DataConfig(seq_len=64))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_state(chain, fsdp=1):
    """The reference's trainer and a state of random leaves (counts and
    step 5), on ``fsdp`` of the virtual CPU devices."""
    jcfg, _ = _configs(chain)
    jcfg = JExperimentConfig(**{**jcfg.__dict__,
                                "mesh": JMeshConfig(dp=1, fsdp=fsdp)})
    tr = jax_build_trainer(jcfg, mesh=make_mesh(
        jcfg.mesh, devices=jax.devices()[:fsdp]))
    rng = np.random.default_rng(0)

    def fill(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            v = jnp.full(x.shape, 5, x.dtype)
        else:
            v = jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        return jax.device_put(v, x.sharding)

    return tr, jax.tree_util.tree_map(fill, tr.init())


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), ser._as_tensor(np.asarray(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_same_leaves(port_tree, jax_tree):
    got = [(p, t.detach().cpu()) for p, t in
           ser.leaves_with_paths(port_tree)]
    want = _jax_leaves(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want]  # flatten order
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def _assert_moments_are_the_optimizers(state, jstate):
    """Each moment the port's optimizer steps with (its ``mu``, ``nu`` or
    ``trace`` list, in its parameters' order) holds the JAX state's
    moment of the same name and parameter, found by path alone: the
    layout may not swap moments or parameters."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    found = 0
    for path, x in jax.tree_util.tree_flatten_with_path(jstate.opt_state)[0]:
        m = re.match(r".*\.(mu|nu|trace)((\['[^']+'\])+)$",
                     jax.tree_util.keystr(path))
        if not m:
            continue
        name = ".".join(re.findall(r"\['([^']+)'\]", m.group(2)))
        got = state.opt_state[m.group(1)][names.index(name)]
        want = ser._as_tensor(np.asarray(x))
        assert torch.equal(got, want.reshape(port_shape(name, want.shape))), \
            (m.group(1), name)
        found += 1
    assert found == len(names) * (1 if "trace" in state.opt_state else 2)


def _port_trainer(chain):
    return build_trainer(_configs(chain)[1], device="cpu")


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _lower_chunks(monkeypatch):
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", CHUNK)
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", CHUNK)


CASES = [(layout, chain) for layout in ("blob", "sharded")
         for chain in CHAINS]


@pytest.mark.parametrize("layout, chain", CASES)
def test_jax_checkpoint_restores_into_port_bit_exact(tmp_path, monkeypatch,
                                                     layout, chain):
    _lower_chunks(monkeypatch)
    jtr, jstate = _jax_state(chain)
    sharded = layout == "sharded"
    jck.Checkpointer(jck.LocalStore(str(tmp_path / "jax")), name="run",
                     async_save=False, sharded=sharded).save(jstate)
    if not sharded:
        blob = (tmp_path / "jax" / "run" / "step-0000000005").read_bytes()
        assert b"__msgpack_chunked_array__" in blob
    tr = _port_trainer(chain)
    state = tr.init(seed=3)
    tree = tr.state_tree(state)
    restored = Checkpointer(LocalStore(str(tmp_path / "jax")), name="run")
    got = restored.restore(tree)
    assert got is tree  # written in place
    tr.load_tree(state, tree)
    assert state.step == 5 and state.opt_state["count"] == 5
    _assert_same_leaves(tr.state_tree(state), jstate)
    _assert_moments_are_the_optimizers(state, jstate)
    if chain == "adam":
        assert state.model.embedder.embedding.dtype == torch.bfloat16
    if chain in ("lora", "qlora"):
        assert len(state.opt_state["mu"]) == 8  # 2 layers x q/v x a/b
    # The port, writing the same state, writes the same bytes.
    Checkpointer(LocalStore(str(tmp_path / "port")), name="run",
                 async_save=False, sharded=sharded).save(tr.state_tree(state))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("layout, chain", CASES)
def test_port_checkpoint_restores_in_reference_bit_exact(tmp_path,
                                                         monkeypatch,
                                                         layout, chain):
    _lower_chunks(monkeypatch)
    jtr, _ = _jax_state(chain)
    tr = _port_trainer(chain)
    state = tr.init(seed=4)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for _, leaf in ser.leaves_with_paths(tr.state_tree(state)):
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=g))
    state.step, state.opt_state["count"] = 7, 7
    saver = Checkpointer(LocalStore(str(tmp_path)), name="run",
                         sharded=layout == "sharded")
    assert saver.save(tr.state_tree(state)) == 7
    saver.close()
    ref = jck.Checkpointer(jck.LocalStore(str(tmp_path)), name="run")
    assert ref.latest_step() == 7
    back = ref.restore(jtr.abstract_state(), shardings=jtr.state_shardings)
    _assert_same_leaves(tr.state_tree(state), back)
    params = ref.restore_params_host()
    _assert_same_leaves(tr.state_tree(state)["params"],
                        jax.tree_util.tree_map(jnp.asarray, params))


def test_sharded_checkpoint_from_two_devices_restores_onto_one(tmp_path):
    jtr, jstate = _jax_state("adamw", fsdp=2)
    jck.Checkpointer(jck.LocalStore(str(tmp_path)), name="run",
                     async_save=False, sharded=True).save(jstate)
    idx = json.loads((tmp_path / "run" / "step-0000000005" /
                      "proc-00000.idx").read_text())
    per_leaf = [sum(c["leaf"] == i for c in idx["chunks"])
                for i in range(1 + max(c["leaf"] for c in idx["chunks"]))]
    assert max(per_leaf) == 2  # fsdp split leaves in two boxes
    tr = _port_trainer("adamw")
    state = tr.init()
    tr.load_tree(state, Checkpointer(LocalStore(str(tmp_path)),
                                     name="run").restore(
                                         tr.state_tree(state)))
    _assert_same_leaves(tr.state_tree(state), jstate)
    host = Checkpointer(LocalStore(str(tmp_path)),
                        name="run").restore_params_host()
    _assert_same_leaves(host, jstate.params)


# -- the codec ---------------------------------------------------------------

@pytest.mark.parametrize("chain", ["adamw", "adam"])
def test_codec_round_trip_is_byte_exact(monkeypatch, chain):
    """flax's bytes of a whole state (chunked leaves; bf16 ones for adam)
    decode and re-encode to the same bytes."""
    _lower_chunks(monkeypatch)
    _, jstate = _jax_state(chain)
    blob = flax_serialization.to_bytes(jax.device_get(jstate))
    tree = ser.decode(blob)
    assert bytes(ser.encode(tree)) == blob
    leaf = tree["params"]["embedder"]["embedding"]
    assert leaf.shape == (512, 128)
    assert leaf.dtype == (torch.bfloat16 if chain == "adam" else torch.float32)


def _every_form():
    rng = np.random.default_rng(1)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63]
    return {
        "ints": ints, "floats": [0.0, -1.5, 1e300], "bools": [True, False],
        "none": None, "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                               "é" * 40000],
        "bin": b"\x00\xff" * 200, "big_bin": b"z" * 70000,
        "empty": {}, "wide": {f"k{i}": i for i in range(20)},
        "long": list(range(20)),
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "zero_d": np.asarray(7, np.int32), "i8": np.arange(-5, 5, dtype=np.int8),
        "u8_16k": rng.integers(0, 255, 70000).astype(np.uint8),
        "bf16": np.asarray(jnp.linspace(-2, 2, 9, dtype=jnp.bfloat16)),
        "empty_arr": np.zeros((0, 3), np.float32), "bool_arr": np.array([True]),
        "scalar": np.float32(2.5), "scalar_i": np.int64(-3),
        "f64": np.arange(3, dtype=np.float64),
    }


def test_codec_writes_msgpacks_bytes_for_every_form():
    """Every msgpack form flax writes: the smallest int encodings, fix/8/
    16/32-bit strings, bins, maps, arrays, ext headers by size, 0-d and
    empty arrays, numpy scalars (ext 3), bf16."""
    import copy

    tree = _every_form()
    want = flax_serialization.msgpack_serialize(copy.deepcopy(tree),
                                                in_place=True)
    assert bytes(ser.encode(tree)) == want
    back = ser.decode(want)
    assert bytes(ser.encode(back)) == want
    assert back["ints"] == tree["ints"] and back["strs"] == tree["strs"]
    assert back["scalar"] == np.float32(2.5) and isinstance(back["scalar"],
                                                            np.float32)
    assert back["zero_d"].shape == () and int(back["zero_d"]) == 7
    assert back["bf16"].dtype == torch.bfloat16
    ref = flax_serialization.msgpack_restore(bytes(ser.encode(tree)))
    np.testing.assert_array_equal(ref["f32"], tree["f32"])


def test_codec_refuses_what_it_does_not_take():
    with pytest.raises(TypeError):
        ser.encode({"c": 1 + 2j})
    with pytest.raises(TypeError):
        ser.encode({"t": (1, 2)})  # flax writes tuples as maps
    blob = flax_serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="complex"):
        ser.decode(blob)
    good = bytes(ser.encode({"w": np.ones(8, np.float32)}))
    with pytest.raises(ValueError, match="truncated"):
        ser.decode(good[:-3])
    with pytest.raises(ValueError, match="trailing"):
        ser.decode(good + b"\xc0")


def test_crc_in_parts_equals_zlib(monkeypatch):
    data = np.random.default_rng(2).integers(0, 255, 10_001).astype(np.uint8)
    a, b = data[:3000].tobytes(), data[3000:].tobytes()
    assert ck.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == \
        zlib.crc32(a + b)
    monkeypatch.setattr(ck, "_CRC_PART", 1000)
    assert ck._crc(data.tobytes()) == zlib.crc32(data.tobytes())


# -- resume --------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["adamw", "sgd", "lora", "qlora"])
def test_resume_equals_an_uninterrupted_run(tmp_path, chain):
    _, tcfg = _configs(chain)
    tr = _port_trainer(chain)
    batches = list(itertools.islice(SyntheticSource(
        tr.bundle.make_batch, tcfg.data, 2, seed=9), 4))
    # From scratch QLoRA trains over flax's zero base, where no gradient
    # flows: random int8 weights make the run move.
    kw = {"fill": random_quantized_params} if chain == "qlora" else {}
    whole = tr.init(**kw)
    for b in batches:
        tr.step(whole, tr.place(b))
    first = tr.init(**kw)
    for b in batches[:2]:
        tr.step(first, tr.place(b))
    saver = Checkpointer(LocalStore(str(tmp_path)), name="run")
    saver.save(tr.state_tree(first))
    saver.close()
    fresh = _port_trainer(chain)
    resumed = fresh.init(seed=11)
    tree = fresh.state_tree(resumed)
    Checkpointer(LocalStore(str(tmp_path)), name="run").restore(tree)
    fresh.load_tree(resumed, tree)
    for b in batches[2:]:
        fresh.step(resumed, fresh.place(b))
    assert resumed.step == whole.step == 4
    assert resumed.opt_state["count"] == whole.opt_state["count"]
    for (p, a), (_, b) in zip(ser.leaves_with_paths(tr.state_tree(whole)),
                              ser.leaves_with_paths(
                                  fresh.state_tree(resumed))):
        assert torch.equal(a, b), p


# -- corruption and fallback (tests/test_recover.py's cases) -----------------

def _state(step: int, n: int = 16) -> dict:
    return {"step": torch.tensor(step, dtype=torch.int64),
            "w": torch.arange(n, dtype=torch.float32) + step}


def _template(n: int = 16) -> dict:
    return {"step": torch.tensor(0, dtype=torch.int64), "w": torch.zeros(n)}


def _blob_path(root, name, step):
    return os.path.join(str(root), name, f"step-{step:010d}")


def _flip_byte(path, offset=None):
    off = os.path.getsize(path) // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _ckpt(root, **kw):
    kw.setdefault("async_save", False)
    kw.setdefault("name", "t")
    return Checkpointer(LocalStore(str(root)), **kw)


def test_truncated_blob_falls_back_and_quarantines(tmp_path):
    c = _ckpt(tmp_path)
    c.save(_state(1), step=1)
    c.save(_state(2), step=2)
    path = _blob_path(tmp_path, "t", 2)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    restored = c.restore_host(_template())
    assert int(restored["step"]) == 1, "must fall back to the last good step"
    assert torch.equal(restored["w"], _state(1)["w"])
    assert os.path.isfile(path + ".CORRUPT")
    assert c.candidate_steps() == [1]
    assert os.path.isfile(path)  # kept for forensics


def test_bitflipped_blob_falls_back(tmp_path):
    c = _ckpt(tmp_path)
    c.save(_state(3), step=3)
    c.save(_state(4), step=4)
    _flip_byte(_blob_path(tmp_path, "t", 4))
    template = _template()
    assert c.restore(template) is template  # in place
    assert int(template["step"]) == 3
    assert c.candidate_steps() == [3]


def test_missing_latest_listing_wins(tmp_path):
    c = _ckpt(tmp_path)
    c.save(_state(1), step=1)
    c.save(_state(2), step=2)
    LocalStore(str(tmp_path)).delete("t/LATEST")
    assert c.latest_step() == 2
    assert int(c.restore_host(_template())["step"]) == 2


def test_stale_latest_pointing_at_deleted_step(tmp_path):
    c = _ckpt(tmp_path)
    c.save(_state(5), step=5)
    store = LocalStore(str(tmp_path))
    store.put("t/LATEST", json.dumps({"step": 99}).encode())
    assert c.latest_step() == 5, "a stale pointer must not hide real steps"
    assert int(c.restore_host(_template())["step"]) == 5
    store.put("t/LATEST", b"\x00not json")
    assert c.latest_step() == 5


def test_explicit_restore_of_corrupt_step_raises(tmp_path):
    c = _ckpt(tmp_path)
    c.save(_state(1), step=1)
    c.save(_state(2), step=2)
    _flip_byte(_blob_path(tmp_path, "t", 2))
    template = _template()
    with pytest.raises(CheckpointCorrupt) as ei:
        c.restore(template, step=2)
    assert ei.value.step == 2
    assert not os.path.isfile(_blob_path(tmp_path, "t", 2) + ".CORRUPT")
    assert int(template["step"]) == 0  # nothing reached the state


def test_every_copy_corrupt_raises_never_loads_garbage(tmp_path):
    c = _ckpt(tmp_path)
    for s in (1, 2):
        c.save(_state(s), step=s)
        _flip_byte(_blob_path(tmp_path, "t", s))
    with pytest.raises(CheckpointCorrupt):
        c.restore_host(_template())


def test_gc_never_collects_last_verified_step(tmp_path):
    c = _ckpt(tmp_path, keep=1)
    c.save(_state(1), step=1)
    assert int(c.restore_host(_template())["step"]) == 1  # verified
    c.save(_state(2), step=2)  # keep=1 would collect step 1
    assert 1 in c.candidate_steps(), "the last verified step survives GC"
    _flip_byte(_blob_path(tmp_path, "t", 2))
    assert int(c.restore_host(_template())["step"]) == 1


def test_sharded_chunk_corruption_detected(tmp_path):
    c = _ckpt(tmp_path, sharded=True)
    c.save(_state(1), step=1)
    c.save(_state(2), step=2)
    dat = os.path.join(str(tmp_path), "t", "step-0000000002",
                       "proc-00000.dat")
    _flip_byte(dat, offset=os.path.getsize(dat) - 4)  # inside "w"
    with pytest.raises(CheckpointCorrupt):
        c.restore_host(_template(), step=2)
    assert int(c.restore_host(_template())["step"]) == 1
    with open(dat, "r+b") as f:
        f.truncate(os.path.getsize(dat) // 2)
    with pytest.raises(CheckpointCorrupt):
        c.restore_host(_template(), step=2)


def test_localstore_sweeps_orphan_tmp_from_dead_writers(tmp_path):
    os.makedirs(str(tmp_path / "t"))
    dead = str(tmp_path / "t" / "step-0000000001.tmp.99999999")
    live = str(tmp_path / "t" / f"step-0000000002.tmp.{os.getpid()}")
    for p in (dead, live):
        with open(p, "wb") as f:
            f.write(b"partial")
    LocalStore(str(tmp_path))
    assert not os.path.exists(dead), "a dead writer's tmp debris must go"
    assert os.path.exists(live), "a live writer's tmp must stay"


def test_localstore_moves_data_in_bounded_calls(tmp_path, monkeypatch):
    """put and get move a buffer in ``_IO_CHUNK`` calls (one call over a
    many-GB blob stalls other threads' host allocations) and keep its
    bytes: the JAX package's store reads what the port wrote, and back."""
    calls = []

    class Recording:
        def __init__(self, f):
            self.f = f

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

        def write(self, b):
            calls.append(("write", len(b)))
            return self.f.write(b)

        def readinto(self, b):
            calls.append(("read", len(b)))
            return self.f.readinto(b)

        def __getattr__(self, name):
            return getattr(self.f, name)

    monkeypatch.setattr(ck, "_IO_CHUNK", 1000)
    monkeypatch.setattr(ck, "open", lambda *a, **k: Recording(open(*a, **k)),
                        raising=False)
    data = np.random.default_rng(3).integers(
        0, 255, 10_001).astype(np.uint8).tobytes()
    store = LocalStore(str(tmp_path))
    store.put("t/x", data)
    assert [n for op, n in calls if op == "write"] == [1000] * 10 + [1]
    calls.clear()
    assert bytes(store.get("t/x")) == data
    assert bytes(store.get_range("t/x", 5, 2500)) == data[5:2505]
    assert calls and max(n for _, n in calls) <= 1000
    assert bytes(jck.LocalStore(str(tmp_path)).get("t/x")) == data
    jck.LocalStore(str(tmp_path)).put("t/y", data[::-1])
    assert bytes(store.get("t/y")) == data[::-1]


def test_close_drains_pending_async_commit(tmp_path):
    gate = threading.Event()

    class GatedStore(LocalStore):
        def put(self, key, data):
            gate.wait(timeout=10.0)
            super().put(key, data)

    store = GatedStore(str(tmp_path))
    c = Checkpointer(store, name="t", async_save=True)
    c.save(_state(1), step=1)
    assert not store.exists("t/LATEST"), "the upload is still gated"
    assert c._atexit_armed, "an async save arms the atexit drain"
    gate.set()
    c.close()
    assert store.exists("t/LATEST") and c.latest_step() == 1
    assert not c._atexit_armed


def test_waiting_for_the_upload_is_charged_to_checkpoint(tmp_path):
    """The caller held by ``wait`` (the end of ``train``) is in the
    ``checkpoint`` phase, which the step watchdog excuses."""
    from serverless_learn_tpu_torch.telemetry import goodput

    gate = threading.Event()

    class GatedStore(LocalStore):
        def put(self, key, data):
            gate.wait(timeout=10.0)
            super().put(key, data)

    prev = goodput.set_ledger(goodput.PhaseLedger(emit=False))
    try:
        c = Checkpointer(GatedStore(str(tmp_path)), name="t")
        c.save(_state(1), step=1)
        before = goodput.get_ledger().snapshot()["phases"]["checkpoint"]
        threading.Timer(0.3, gate.set).start()
        c.wait()
        after = goodput.get_ledger().snapshot()["phases"]["checkpoint"]
    finally:
        goodput.set_ledger(prev)
    assert after["seconds"] - before["seconds"] >= 0.25
    assert after["count"] == before["count"] + 1
    c.close()


def test_wrong_structure_raises_and_no_checkpoint_raises(tmp_path):
    c = _ckpt(tmp_path)
    with pytest.raises(FileNotFoundError):
        c.restore(_template())  # never a fallback to the template's values
    c.save(_state(1), step=1)
    with pytest.raises(ValueError, match="does not fit"):
        c.restore({"step": torch.tensor(0), "v": torch.zeros(16)})
    with pytest.raises(ValueError, match=r"\(8,\)"):
        c.restore(_template(8))


# -- the command line ------------------------------------------------------

BASE = ["--model", "llama_tiny", "--batch-size", "2", "--seq-len", "64",
        "--device", "cpu", "--set", "train.dtype=float32"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_then_eval_and_generate_from_the_checkpoint(tmp_path,
                                                              capsys):
    root = str(tmp_path / "ck")
    assert cli.main(["train", *BASE, "--steps", "3", "--checkpoint-every",
                     "2", "--checkpoint-dir", root, "--set",
                     "checkpoint.keep=1"]) == 0
    assert _last_json(capsys)["final_step"] == 3
    assert sorted(os.listdir(os.path.join(root, "ckpt"))) == [
        "LATEST", "step-0000000003", "step-0000000003.manifest"]
    assert cli.main(["eval", *BASE, "--checkpoint-dir", root,
                     "--eval-steps", "2"]) == 0
    got = _last_json(capsys)
    assert got["checkpoint_step"] == 3
    # The reference's run_eval on the same checkpoint and the same held-out
    # batches: f32 on both sides, sums in another order (rtol 1e-5).
    jcfg = JExperimentConfig(model="llama_tiny", mesh=JMeshConfig(dp=1),
                             train=JTrainConfig(batch_size=2,
                                                dtype="float32"),
                             data=JDataConfig(seq_len=64))
    jtr = jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                 devices=jax.devices()[:1]))
    jstate = jck.Checkpointer(jck.LocalStore(root)).restore(
        jtr.abstract_state(), shardings=jtr.state_shardings)
    want = jax_run_eval(jcfg, jtr, jstate, num_batches=2)
    assert set(got) - {"checkpoint_step"} == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)

    gen = ["generate", "--model", "llama_tiny", "--device", "cpu",
           "--checkpoint-dir", root, "--prompt", "5,9,11",
           "--max-new-tokens", "6"]
    assert cli.main(gen) == 0
    plain = _last_json(capsys)
    assert plain["checkpoint_step"] == 3
    model, step = cli._model_from_args(cli.build_parser().parse_args(gen),
                                       {})
    want_tokens = generate(model, torch.tensor([[5, 9, 11]]), 6)
    assert plain["tokens"] == want_tokens.tolist() and step == 3
    assert cli.main([*gen, "--draft-layers", "1", "--spec-k", "2"]) == 0
    spec = _last_json(capsys)
    assert spec["tokens"] == plain["tokens"]
    assert set(spec["speculative"]) == {"acceptance", "rounds"}
    assert cli.main([*gen, "--quant", "int8"]) == 0
    assert len(_last_json(capsys)["tokens"][0]) == 9
    with pytest.raises(SystemExit, match="greedy-only"):
        cli.main([*gen, "--draft-layers", "1", "--temperature", "0.7"])
    with pytest.raises(SystemExit, match="draft_layers"):
        cli.main([*gen, "--draft-layers", "2"])  # llama_tiny has 2 layers

    # A checkpoint that does not fit the serving config names the paths
    # and shapes.
    with pytest.raises(SystemExit, match=r"do not fit.*mlp.*\(128, 512\)"):
        cli.main([*gen, "--set", "model_overrides.d_ff=256"])


@pytest.mark.parametrize("cmd", ["eval", "generate", "serve"])
def test_cli_empty_store_exits(tmp_path, cmd):
    argv = ([cmd, *BASE] if cmd == "eval" else
            [cmd, "--model", "llama_tiny", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        cli.main([*argv, "--checkpoint-dir", str(tmp_path)])


# -- the emergency save ----------------------------------------------------

DRILL = ["--model", "llama_tiny", "--batch-size", "2", "--seq-len", "32",
         "--device", "cpu", "--set", "train.dtype=float32",
         "--set", "model_overrides.n_layers=1"]


def test_sigterm_drill_commits_the_shadow_for_both_packages(tmp_path):
    """``train`` in a child process, SIGTERM'd after its third step line:
    the flight dump (reason sigterm) carries the emergency save's step,
    which is the newest shadow's, and ``slt_ckpt_emergency_saves_total``
    = 1; the emergency blob restores into the reference's
    ``Checkpointer`` and into the port bit for bit, and equals that many
    steps of an uninterrupted run (one CPU thread on both sides, so the
    sums run in one order)."""
    import signal
    import subprocess
    import sys

    root, flight_dir = tmp_path / "ck", tmp_path / "flight"
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, torch; torch.set_num_threads(1); "
         "from serverless_learn_tpu_torch.cli import main; "
         "sys.exit(main(sys.argv[1:]))",
         "train", *DRILL, "--steps", "100000", "--checkpoint-dir", str(root),
         "--checkpoint-every", "1000", "--flight-dir", str(flight_dir),
         "--verbose", "--set", "train.log_every=1",
         "--set", "checkpoint.emergency_min_interval_s=0"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    try:
        steps = 0
        for line in child.stderr:
            if line.startswith('{"step"'):
                steps += 1
                if steps == 3:
                    child.send_signal(signal.SIGTERM)
                    break
        child.stderr.read()
        assert child.wait(timeout=120) == -signal.SIGTERM
    finally:
        if child.poll() is None:
            child.kill()
    (dump_name,) = os.listdir(flight_dir)
    dump = json.load(open(flight_dir / dump_name))
    assert dump["reason"] == "sigterm"
    saved = dump["death_hooks"]["ckpt:ckpt"]
    shadows = [e["step"] for e in dump["events"]
               if e.get("event") == "ckpt_shadow"]
    step = saved["step"]
    # The step-3 line precedes its shadow refresh (the loop logs, then
    # calls the checkpointer); a signal inside a refresh saves the step
    # it was copying.
    assert step >= 2
    assert step == shadows[-1] + (saved["source"] == "refresh")
    assert dump["metrics"]["slt_ckpt_emergency_saves_total"][
        "series"][0]["value"] == 1
    manifest = json.load(open(root / "ckpt" / f"step-{step:010d}.manifest"))
    assert manifest["emergency"] == "emergency:sigterm"

    # The same config, uninterrupted, for `step` steps, in this process.
    cfg = ExperimentConfig(
        model="llama_tiny", model_overrides={"n_layers": 1},
        train=TrainConfig(batch_size=2, num_steps=step, dtype="float32"),
        data=DataConfig(seq_len=32))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from serverless_learn_tpu_torch.training.loop import run_training
        from serverless_learn_tpu_torch.telemetry.registry import (
            MetricsRegistry)
        from serverless_learn_tpu_torch.telemetry.goodput import PhaseLedger

        tr = build_trainer(cfg, device="cpu")
        state, _ = run_training(cfg, trainer=tr, device="cpu",
                                registry=MetricsRegistry(),
                                ledger=PhaseLedger(emit=False))
    finally:
        torch.set_num_threads(n)
    tree = tr.state_tree(state)
    got = Checkpointer(LocalStore(str(root))).restore_host(tree, step=step)
    live = dict(ser.leaves_with_paths(tree))
    for path, leaf in ser.leaves_with_paths(got):
        assert torch.equal(leaf, live[path].detach().cpu()), path

    jcfg = JExperimentConfig(
        model="llama_tiny", model_overrides={"n_layers": 1},
        mesh=JMeshConfig(dp=1),
        train=JTrainConfig(batch_size=2, dtype="float32"),
        data=JDataConfig(seq_len=32))
    jtr = jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                 devices=jax.devices()[:1]))
    jstate = jck.Checkpointer(jck.LocalStore(str(root))).restore(
        jtr.abstract_state(), step=step, shardings=jtr.state_shardings)
    assert int(jstate.step) == step
    _assert_same_leaves(got, jstate)


def test_emergency_save_rate_limit_and_shadow(tmp_path):
    """The shadow refreshes at most once an interval and allocates its
    host buffer once; the death hook commits the shadow's step, then
    refuses a second save inside the interval; a disarmed checkpointer
    has no hook and no shadow."""
    from serverless_learn_tpu_torch.telemetry import flight

    c = _ckpt(tmp_path)
    c.arm_emergency(min_interval_s=3600)
    assert f"ckpt:{c.name}" in flight._death_hooks
    s1 = _state(1)
    assert c.note_state(s1) is not None
    shadow, step = c.host_shadow()
    buf = shadow["w"].untyped_storage().data_ptr()
    assert step == 1 and torch.equal(shadow["w"], s1["w"])
    assert c.note_state(_state(2)) is None  # inside the interval
    assert c.host_shadow()[1] == 1
    c._emg_shadow_t = None  # the interval has passed
    s3 = _state(3)
    assert c.note_state(lambda: s3) is not None
    shadow, step = c.host_shadow()
    assert step == 3 and torch.equal(shadow["w"], s3["w"])
    assert shadow["w"].untyped_storage().data_ptr() == buf  # reused
    s3["w"].add_(1)  # the live state moves on; the shadow does not
    assert not torch.equal(shadow["w"], s3["w"])
    saved = c._emergency_save("drill")
    assert saved["step"] == 3 and saved["source"] == "shadow"
    assert saved["nbytes"] == os.path.getsize(_blob_path(tmp_path, "t", 3))
    assert c._emergency_save("again") == {"skipped": "rate-limited"}
    got = c.restore_host(_template(), step=3)
    assert torch.equal(got["w"], shadow["w"])
    c.close()
    assert f"ckpt:{c.name}" not in flight._death_hooks
    assert c.host_shadow() == (None, None)
    assert c.note_state(s3) is None  # disarmed


def test_emergency_save_during_a_refresh_saves_the_tree_being_copied(
        tmp_path, monkeypatch):
    """A signal that lands inside a shadow refresh finds the shadow half
    overwritten: the death hook then saves the tree the refresh was
    copying (whole, at a step boundary), not the torn shadow."""
    c = _ckpt(tmp_path)
    c.arm_emergency(min_interval_s=0)
    c.note_state(_state(1))
    live = _state(2)
    saved, landed = {}, []
    real = ck._host_shadow

    def torn(tree, shadow=None):
        if tree is live and not landed:  # the signal lands mid-copy
            landed.append(True)
            shadow["step"].copy_(tree["step"])  # one leaf copied so far
            saved.update(c._emergency_save("sigterm"))
            raise KeyboardInterrupt
        return real(tree, shadow)

    monkeypatch.setattr(ck, "_host_shadow", torn)
    with pytest.raises(KeyboardInterrupt):
        c.note_state(live)
    assert saved["step"] == 2 and saved["source"] == "refresh"
    got = c.restore_host(_template(), step=2)
    assert torch.equal(got["w"], live["w"]) and int(got["step"]) == 2
    assert c._emg_refreshing is None
    c.close()
