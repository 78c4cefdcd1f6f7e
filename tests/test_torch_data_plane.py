"""The port's data plane against the JAX package's: datasets published by
either package stream the same batches through either package's
``ShardStreamSource`` (same seed, stripe and resume step, over two
epochs), stripes are disjoint and cover every shard, both packages refuse
the same arguments with the same errors, a lost shard server raises out
of the source, the tokenizer and the corpus loaders give the reference's
ids and rows, the shard-server checkpoint store carries checkpoints
between the packages bit for bit, and ``train``/``eval --shard-server``
stream a published dataset and keep their checkpoints on the shard server
(``generate`` restores from there), and a killed shard server fails the
run.

Every daemon binds port 0 and is stopped by a finalizer; every join and
child wait has a timeout.
"""

import gzip
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from serverless_learn_tpu.config import (DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         MeshConfig as JMeshConfig,
                                         OptimizerConfig as JOptimizerConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.data import raw as jraw
from serverless_learn_tpu.data import shard_client as jsc
from serverless_learn_tpu.data import tokenizer as jtok
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               TrainConfig)
from serverless_learn_tpu_torch.control import client as pclient
from serverless_learn_tpu_torch.control import daemons as pd
from serverless_learn_tpu_torch.data import raw as praw
from serverless_learn_tpu_torch.data import shard_client as psc
from serverless_learn_tpu_torch.data import tokenizer as ptok
from serverless_learn_tpu_torch.data.transforms import auto_transform
from serverless_learn_tpu_torch.models.registry import Spec
from serverless_learn_tpu_torch.training import checkpoint as pck
from serverless_learn_tpu_torch.training.loop import make_source
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils import serialization as ser

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 16, 4
WAIT_S = 60.0  # the longest a child or a thread is waited for


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def shard_server(request, tmp_path):
    srv = pd.ShardServer(root=str(tmp_path / "root")).start()
    request.addfinalizer(srv.stop)
    return srv


def _arrays(n=44, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (n, SEQ)).astype(np.int32),
            "weight": rng.standard_normal((n, 3)).astype(np.float32)}


def _take(source, n):
    it = iter(source)
    try:
        return [next(it) for _ in range(n)]
    finally:
        source.close()


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


STRIPES = [(0, 1), (0, 2), (1, 2), (2, 3)]


@pytest.mark.parametrize("publisher", ["jax", "port"])
@pytest.mark.parametrize("rank,size", STRIPES)
def test_both_sources_stream_the_same_batches(shard_server, publisher,
                                              rank, size):
    """One dataset (published by either package, 44 records in shards of
    5: a ragged last shard), the same seed and stripe: bit-equal batches
    over two epochs and more, carry-over across shard boundaries
    included."""
    publish = (jsc.publish_dataset if publisher == "jax"
               else psc.publish_dataset)
    meta = publish(shard_server.addr, "ds", _arrays(), records_per_shard=5)
    assert meta.num_shards == 9
    kw = dict(batch_size=BATCH, seed=11, dp_rank=rank, dp_size=size)
    src = psc.ShardStreamSource(shard_server.addr, "ds", **kw)
    per_epoch = sum(meta.shard_range(i)[1] - meta.shard_range(i)[0]
                    for i in src.shards)
    n = 2 * (per_epoch // BATCH) + 1  # two epochs and into a third
    ours = _take(src, n)
    theirs = _take(jsc.ShardStreamSource(shard_server.addr, "ds", **kw), n)
    _assert_batches_equal(ours, theirs)


def test_make_source_folds_the_resume_step(shard_server):
    """``make_source`` streams ``data.dataset`` with the seed moved by
    100_003 a resume step (no replayed batches after a restore), as the
    reference's, and its synthetic branch is the reference's too."""
    jsc.publish_dataset(shard_server.addr, "lm", {"tokens": _arrays()[
        "tokens"]}, records_per_shard=6)
    cfg = ExperimentConfig(
        model="llama_tiny", train=TrainConfig(batch_size=BATCH, seed=3),
        data=DataConfig(seq_len=SEQ, dataset="lm",
                        shard_server_addr=shard_server.addr))
    tr = build_trainer(cfg, device="cpu")
    ours = _take(make_source(cfg, tr, dp_rank=1, dp_size=2, start_step=4), 7)
    theirs = _take(jsc.ShardStreamSource(
        shard_server.addr, "lm", BATCH, seed=3 + 100_003 * 4, dp_rank=1,
        dp_size=2), 7)
    _assert_batches_equal(ours, theirs)
    cfg = ExperimentConfig(model="llama_tiny",
                           train=TrainConfig(batch_size=BATCH, seed=3),
                           data=DataConfig(seq_len=SEQ))
    a = next(iter(make_source(cfg, tr, start_step=2)))
    b = tr.bundle.make_batch(np.random.default_rng(3 + 100_003 * 2),
                             cfg.data, BATCH)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_stripes_are_disjoint_and_cover(shard_server):
    meta = psc.publish_dataset(shard_server.addr, "ds", _arrays(n=60),
                               records_per_shard=4)
    for size in (1, 2, 3, 5):
        for subs in (1, 2):
            seen = []
            for rank in range(size):
                for sub in range(subs):
                    kw = dict(dp_rank=rank, dp_size=size, sub_rank=sub,
                              sub_count=subs)
                    src = psc.ShardStreamSource(shard_server.addr, "ds", 2,
                                                **kw)
                    ref = jsc.ShardStreamSource(shard_server.addr, "ds", 2,
                                                **kw)
                    assert src.shards == ref._my_shards
                    seen += src.shards
                    src.close()
                    ref.close()
            assert sorted(seen) == list(range(meta.num_shards))


@pytest.mark.parametrize("kw", [
    dict(dp_rank=2, dp_size=2), dict(sub_rank=1, sub_count=1),
    dict(dp_rank=0, dp_size=4, sub_rank=1, sub_count=2),
    dict(dp_rank=5, dp_size=6, sub_rank=0, sub_count=2),
    dict(batch_size=40, dp_rank=0, dp_size=2)])
def test_both_packages_refuse_alike(shard_server, kw):
    psc.publish_dataset(shard_server.addr, "ds", _arrays(n=20),
                        records_per_shard=5)
    kw = dict({"batch_size": 2}, **kw)
    with pytest.raises(ValueError) as ours:
        psc.ShardStreamSource(shard_server.addr, "ds", **kw)
    with pytest.raises(ValueError) as theirs:
        jsc.ShardStreamSource(shard_server.addr, "ds", **kw)
    assert str(ours.value) == str(theirs.value)


def test_a_lost_shard_server_raises_out_of_the_source(tmp_path):
    srv = pd.ShardServer(root=str(tmp_path)).start()
    psc.publish_dataset(srv.addr, "ds", _arrays(n=40), records_per_shard=2)
    src = psc.ShardStreamSource(srv.addr, "ds", 2, prefetch_shards=1)
    it = iter(src)
    next(it)
    srv.stop()
    got = []

    def drain():
        try:
            for _ in it:
                pass
            got.append("clean end")
        except OSError as e:
            got.append(e)

    th = threading.Thread(target=drain)
    th.start()
    th.join(timeout=WAIT_S)
    src.close()
    assert not th.is_alive() and isinstance(got[0], OSError), got


def test_auto_transform_bridges_lm_and_refuses_the_rest():
    spec = lambda name, dt, shape: psc.FieldSpec(name, dt, shape)  # noqa
    lm = {"tokens": Spec((1, 8), np.dtype(np.int32))}
    assert auto_transform([spec("tokens", "int32", (8,))], lm, "lm",
                          train=True) is None
    fn = auto_transform([spec("input_ids", "int32", (8,))], lm, "lm",
                        train=True)
    out = fn({"input_ids": np.arange(8, dtype=np.int64)[None]})
    assert list(out) == ["tokens"] and out["tokens"].dtype == np.int32
    # The MLM and image bridges run now (tests/test_torch_image_data.py
    # holds them to the reference's); the MLM one needs the vocabulary.
    with pytest.raises(ValueError, match="vocab size"):
        auto_transform([spec("input_ids", "int32", (8,))],
                       {"tokens": lm["tokens"], "labels": lm["tokens"]},
                       "mlm", train=True)
    image = {"image": Spec((1, 4, 4, 3), np.dtype(np.float32)),
             "label": Spec((1,), np.dtype(np.int32))}
    fn = auto_transform([spec("image", "uint8", (4, 4, 3)),
                         spec("label", "int32", ())], image,
                        "classification", train=True)
    assert fn({"image": np.full((1, 4, 4, 3), 255, np.uint8),
               "label": np.zeros(1, np.int32)})["image"].dtype == np.float32
    with pytest.raises(ValueError, match="no transform bridges"):
        auto_transform([spec("x", "int32", (8,))], lm, "lm", train=True)


# -- tokenizer and corpora ---------------------------------------------------

TEXT = ("Hello world, it's 2026!  The cafés' 12345 tokens   don't merge.\n"
        "\n\nSecond doc: ünïcödé → 漢字 and tabs\tand  spaces \n\n"
        "Third: x1 y22 z333 ___ ... !!!\n\n" * 3)


def _write_vocab(tmp_path):
    """A small GPT-2-format vocab: the 256 byte symbols, merges learnt by
    counting pairs in TEXT, and an end-of-text token."""
    b2u = ptok._bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(sorted(b2u.values()))}
    words = [[b2u[b] for b in w.encode()] for w in
             TEXT.replace("\n", " ").split(" ") if w]
    merges = []
    for _ in range(60):
        pairs = {}
        for w in words:
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] = pairs.get((a, b), 0) + 1
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        words = [_merge(w, a, b) for w in words]
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def _merge(w, a, b):
    out, i = [], 0
    while i < len(w):
        if i < len(w) - 1 and w[i] == a and w[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(w[i])
            i += 1
    return out


def test_tokenizer_and_corpora_match_the_reference(tmp_path):
    vocab, merges = _write_vocab(tmp_path)
    ours = ptok.BPETokenizer.from_files(vocab, merges)
    theirs = jtok.BPETokenizer.from_files(vocab, merges)
    for text in [TEXT, "", " ", "a", "don't 'll 've", "\t\n  x  ",
                 "日本語のテキスト 123 ½ ²"]:
        ids = ours.encode(text)
        np.testing.assert_array_equal(ids, theirs.encode(text))
        assert ours.decode(ids) == theirs.decode(ids) == text
    assert ours.eos_id == theirs.eos_id and \
        ours.vocab_size == theirs.vocab_size
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(TEXT * 4)
    for kw in (dict(vocab_file=vocab, merges_file=merges), {}):
        a = ptok.load_text_corpus(str(corpus), 24, **kw)
        b = jtok.load_text_corpus(str(corpus), 24, **kw)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    docs = [ours.encode(d) for d in TEXT.split("\n\n")]
    for seq in (2, 7, 32):
        np.testing.assert_array_equal(
            ptok.pack_token_docs(docs, seq)["input_ids"],
            jtok.pack_token_docs(docs, seq)["input_ids"])
        assert ptok.packing_efficiency(docs, seq) == \
            jtok.packing_efficiency(docs, seq)
    ids = np.random.default_rng(0).integers(0, 60000, 999).astype(np.uint16)
    (tmp_path / "c.bin").write_bytes(ids.tobytes())
    with gzip.open(tmp_path / "c.tokens.gz", "wb") as f:
        f.write(ids.tobytes())
    for path in ("c.bin", "c.tokens.gz", "corpus.txt"):
        a = praw.load_token_corpus(str(tmp_path / path), 33)
        b = jraw.load_token_corpus(str(tmp_path / path), 33)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    raw = TEXT.encode()
    np.testing.assert_array_equal(praw.tokenize_bytes(raw),
                                  jraw.tokenize_bytes(raw))
    assert praw.detokenize_bytes(praw.tokenize_bytes(raw)) == raw
    assert (praw.BOS_ID, praw.EOS_ID, praw.MASK_ID) == \
        (jraw.BOS_ID, jraw.EOS_ID, jraw.MASK_ID)


# -- checkpoints on the shard server -----------------------------------------

def _jax_state():
    jcfg = JExperimentConfig(
        model="llama_tiny", mesh=JMeshConfig(dp=1),
        optimizer=JOptimizerConfig(name="adamw", weight_decay=0.1),
        train=JTrainConfig(batch_size=2, dtype="float32"),
        data=JDataConfig(seq_len=32))
    tr = jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                devices=jax.devices()[:1]))
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda x: (np.full(x.shape, 5, x.dtype) if np.issubdtype(
            x.dtype, np.integer) else rng.standard_normal(x.shape).astype(
                x.dtype)), jax.device_get(tr.init()))
    return tr, jax.device_put(state)


def _port_trainer():
    from serverless_learn_tpu_torch.config import OptimizerConfig

    return build_trainer(ExperimentConfig(
        model="llama_tiny",
        optimizer=OptimizerConfig(name="adamw", weight_decay=0.1),
        train=TrainConfig(batch_size=2, dtype="float32"),
        data=DataConfig(seq_len=32)), device="cpu")


@pytest.mark.parametrize("sharded", [False, True])
def test_checkpoints_cross_the_shard_server_bit_exact(shard_server,
                                                      monkeypatch, sharded):
    """The JAX package's Checkpointer saves through its ShardServerStore
    to the port's shard server; the port restores it through its own
    store, moving data in bounded calls, bit for bit; and the port's save
    restores in the reference."""
    jtr, jstate = _jax_state()
    jck.Checkpointer(jck.ShardServerStore(shard_server.addr), name="run",
                     async_save=False, sharded=sharded).save(jstate)
    monkeypatch.setattr(pck, "_IO_CHUNK", 4096)
    store = pck.ShardServerStore(shard_server.addr)
    calls = []
    real = pclient.ShardClient.fetch_into

    def counting(self, key, dst, *a):
        calls.append(len(dst))
        return real(self, key, dst, *a)

    monkeypatch.setattr(pclient.ShardClient, "fetch_into", counting)
    tr = _port_trainer()
    state = tr.init(seed=9)
    tree = tr.state_tree(state)
    ck = pck.Checkpointer(store, name="run", sharded=sharded)
    assert ck.latest_step() == 5
    ck.restore(tree)
    tr.load_tree(state, tree)
    assert max(calls) <= 4096 and len(calls) > 10
    want = [(jax.tree_util.keystr(p), ser._as_tensor(np.asarray(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    got = list(ser.leaves_with_paths(tr.state_tree(state)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert torch.equal(g, w), p
    state.step = 6
    ck.save(tr.state_tree(state))
    ck.close()
    ref = jck.Checkpointer(jck.ShardServerStore(shard_server.addr),
                           name="run")
    assert ref.latest_step() == 6
    back = ref.restore(jtr.abstract_state(), shardings=jtr.state_shardings)
    for (p, g), (_, w) in zip(got, [
            (jax.tree_util.keystr(p), ser._as_tensor(np.asarray(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(back)[0]]):
        if "step" not in p:
            assert torch.equal(g, w), p
    assert not store.exists("run/step-0000000099")
    assert store.list("nothing-here") == []
    store.close()


# -- the command line --------------------------------------------------------

def _cli_json(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_and_eval_stream_a_published_text_corpus(shard_server,
                                                       tmp_path, capsys):
    corpus = tmp_path / "c.txt"
    corpus.write_text(TEXT * 6)
    pub = _cli_json(capsys, ["publish", "--shard-server", shard_server.addr,
                             "--dataset", "txt", "--format", "text",
                             "--path", str(corpus), "--seq-len", "32",
                             "--records-per-shard", "4"])
    assert pub["fields"] == ["input_ids"] and pub["num_shards"] >= 3
    common = ["--model", "llama_tiny", "--batch-size", "2", "--seq-len",
              "32", "--device", "cpu", "--shard-server", shard_server.addr,
              "--dataset", "txt"]
    done = _cli_json(capsys, ["train", *common, "--steps", "3",
                              "--checkpoint-store", shard_server.addr])
    assert done["final_step"] == 3 and len(done["losses"]) == 3
    # Byte-level ids (< 260) through llama_tiny's 512-way head.
    assert all(np.isfinite(done["losses"]))
    ev = _cli_json(capsys, ["eval", *common, "--eval-steps", "2",
                            "--checkpoint-store", shard_server.addr])
    assert ev["checkpoint_step"] == 3 and ev["eval_on_train_data"] == 1.0
    assert np.isfinite(ev["eval_loss"])
    gen = _cli_json(capsys, ["generate", "--model", "llama_tiny", "--device",
                             "cpu", "--checkpoint-store", shard_server.addr,
                             "--prompt", "5,9", "--max-new-tokens", "3"])
    assert gen["checkpoint_step"] == 3 and len(gen["tokens"][0]) == 5
    syn = _cli_json(capsys, ["publish", "--shard-server", shard_server.addr,
                             "--dataset", "syn", "--model", "llama_tiny",
                             "--seq-len", "32", "--num-records", "12"])
    assert syn == {"dataset": "syn", "num_records": 12, "num_shards": 1,
                   "fields": ["tokens"]}
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["publish", "--shard-server", shard_server.addr,
                  "--dataset", "m", "--format", "imagefolder", "--path",
                  "x"])


def test_a_killed_shard_server_fails_the_train_run(request, tmp_path):
    ss = pd.start_shard_server(root=str(tmp_path / "root"))
    request.addfinalizer(lambda: pd.stop_process(ss))
    psc.publish_dataset(ss.addr, "ds", {"tokens": _arrays(n=64)["tokens"]},
                        records_per_shard=2)
    child = subprocess.Popen(
        [sys.executable, "-m", "serverless_learn_tpu_torch", "train",
         "--model", "llama_tiny", "--batch-size", "2", "--seq-len",
         str(SEQ), "--device", "cpu", "--steps", "100000", "--verbose",
         "--set", "train.log_every=1", "--shard-server", ss.addr,
         "--dataset", "ds"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    request.addfinalizer(lambda: pd.stop_process(child))
    lines, first = [], threading.Event()

    def read():
        for line in child.stderr:
            lines.append(line)
            if line.startswith('{"step"'):
                first.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    assert first.wait(WAIT_S), "".join(lines)[-2000:]
    ss.kill()
    ss.wait(timeout=WAIT_S)
    rc = child.wait(timeout=WAIT_S)
    reader.join(timeout=WAIT_S)
    err = "".join(lines)
    assert rc != 0, err[-2000:]
    assert "ConnectionRefusedError" in err or "cannot connect" in err \
        or "Connection" in err, err[-2000:]
