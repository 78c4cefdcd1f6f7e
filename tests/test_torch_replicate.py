"""Checkpoint replicas (``serverless_learn_tpu_torch/training/replicate.py``
and the per-source restore of ``training/checkpoint.py``) against the JAX
package's, on the CPU:

* the reference's replica cases (``tests/test_recover.py``), each run
  through both packages' ``ReplicatedStore`` and ``Checkpointer`` over
  ``LocalStore`` directories: a cache serves a restore without a read of
  the primary; an intact primary heals a corrupt cache copy (the
  ``ckpt_corrupt`` event names the cache); a peer carries a restore past a
  partitioned primary; the replicas' ``LATEST`` vote; ``maybe_replicated``
  is the identity without config;
* the JAX package's ``ShardServerStore`` reads a cache the port serves
  (``serve_cache``), and the port's restores from it as a peer;
* ``worker`` parses ``--ckpt-cache-dir``, ``--ckpt-peers`` and
  ``--ckpt-serve-cache`` as the reference's does, and merges them into the
  config as the reference does;
* the heartbeat-RTT item: both packages' ``ElasticTrainer`` (llama_tiny)
  through one transition, with each package's health engine, a
  coordinator that answers heartbeats 0.3 s late while a save runs: the
  same heartbeat-RTT alert from both. The port's trainer restores that
  transition from its cache.

Every daemon binds port 0 and is stopped; waits poll under a deadline.
"""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from serverless_learn_tpu import cli as jcli
from serverless_learn_tpu.config import (CheckpointConfig as JCheckpointConfig,
                                         ControlConfig as JControlConfig,
                                         DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         HealthConfig as JHealthConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.control import client as jc
from serverless_learn_tpu.telemetry import get_registry as jax_registry
from serverless_learn_tpu.telemetry import tracing as jtracing
from serverless_learn_tpu.telemetry.health import HealthEngine as JHealth
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu.training import replicate as jrep
from serverless_learn_tpu.training.elastic import (
    ElasticTrainer as JElasticTrainer)
from serverless_learn_tpu_torch import cli as pcli
from serverless_learn_tpu_torch.config import (CheckpointConfig,
                                               ControlConfig, DataConfig,
                                               ExperimentConfig, HealthConfig,
                                               TrainConfig)
from serverless_learn_tpu_torch.control import daemons as pd
from serverless_learn_tpu_torch.control import wire
from serverless_learn_tpu_torch.telemetry import goodput
from serverless_learn_tpu_torch.telemetry import tracing as ptracing
from serverless_learn_tpu_torch.telemetry.goodput import PhaseLedger
from serverless_learn_tpu_torch.telemetry.health import HealthEngine
from serverless_learn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                           get_registry)
from serverless_learn_tpu_torch.training import checkpoint as pck
from serverless_learn_tpu_torch.training import replicate as prep
from serverless_learn_tpu_torch.training.elastic import ElasticTrainer

WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    # The JAX clients take the socket path (the committed libslt.so is not
    # this image's to load).
    monkeypatch.setattr(jc._NativeLib, "get", classmethod(lambda cls: None))


def wait_for(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"waited {timeout}s for {what}")


class _Pkg:
    """One package's checkpoint surface and its state trees (the
    reference test's ``_state``: a step and 16 floats)."""

    def __init__(self, name):
        self.name = name
        mod = jck if name == "jax" else pck
        rep = jrep if name == "jax" else prep
        self.ck, self.rep = mod, rep
        self.Config = JCheckpointConfig if name == "jax" else CheckpointConfig
        self.tracing = jtracing if name == "jax" else ptracing

    def state(self, step, n=16):
        if self.name == "jax":
            return {"step": np.asarray(step, np.int64),
                    "w": np.arange(n, dtype=np.float32) + np.float32(step)}
        return {"step": torch.tensor(step, dtype=torch.int64),
                "w": torch.arange(n, dtype=torch.float32) + step}

    def template(self, n=16):
        if self.name == "jax":
            return {"step": np.asarray(0, np.int64),
                    "w": np.zeros(n, np.float32)}
        return {"step": torch.tensor(0, dtype=torch.int64),
                "w": torch.zeros(n)}

    def local(self, path):
        return self.ck.LocalStore(str(path))

    def checkpointer(self, store):
        return self.ck.Checkpointer(store, name="t", async_save=False)


PKGS = ("jax", "torch")


def _w(tree):
    return np.asarray(tree["w"])


class _CountingStore:
    """Delegates to a store and records the keys it is read at."""

    def __init__(self, inner):
        self.inner = inner
        self.reads = []

    def put(self, key, data):
        self.inner.put(key, data)

    def get(self, key):
        self.reads.append(key)
        return self.inner.get(key)

    def get_range(self, key, offset, length, **kw):
        self.reads.append(key)
        return self.inner.get_range(key, offset, length, **kw)

    def exists(self, key):
        return self.inner.exists(key)

    def list(self, prefix):
        return self.inner.list(prefix)

    def delete(self, key):
        self.inner.delete(key)


class _DownStore:
    """Every call fails as a partitioned shard server's does."""

    def _down(self, *a, **k):
        raise ConnectionError("primary partitioned (injected)")

    put = get = get_range = exists = list = delete = _down


def _blob_path(root, step):
    return os.path.join(str(root), "t", f"step-{step:010d}")


def _flip_byte(path):
    off = os.path.getsize(path) // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("pkg", PKGS)
def test_cache_serves_restore_without_primary_reads(tmp_path, pkg):
    p = _Pkg(pkg)
    primary = _CountingStore(p.local(tmp_path / "store"))
    rs = p.rep.ReplicatedStore(primary, cache=p.local(tmp_path / "cache"))
    ck = p.checkpointer(rs)
    ck.save(p.state(1), step=1)
    peer0 = ck._m_peer_restores.value
    primary.reads.clear()
    restored = ck.restore_host(p.template())
    assert int(restored["step"]) == 1
    # A transition's restore of what it just saved is a local read: no
    # blob or manifest byte from the primary.
    assert primary.reads == []
    assert ck._m_peer_restores.value == peer0 + 1
    if pkg == "torch":
        assert ck.timings["restore_source"] == "cache"
    rs.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_intact_primary_heals_corrupt_cache_copy(tmp_path, pkg, monkeypatch):
    p = _Pkg(pkg)
    events = []
    monkeypatch.setattr(p.tracing, "emit_event", events.append)
    rs = p.rep.ReplicatedStore(_CountingStore(p.local(tmp_path / "store")),
                               cache=p.local(tmp_path / "cache"))
    ck = p.checkpointer(rs)
    ck.save(p.state(1), step=1)
    _flip_byte(_blob_path(tmp_path / "cache", 1))
    c0, fb0 = ck._m_corrupt.value, ck._m_fallbacks.value
    restored = ck.restore_host(p.template())
    np.testing.assert_array_equal(_w(restored), _w(p.state(1)))
    assert ck._m_corrupt.value == c0 + 1, "the cache's corruption is seen"
    assert ck._m_fallbacks.value == fb0, "healed within the step"
    assert not os.path.isfile(
        _blob_path(tmp_path / "store", 1) + ".CORRUPT"), \
        "a step healed by a replica is not quarantined"
    corrupt = [e for e in events if e.get("event") == "ckpt_corrupt"]
    assert [(e["step"], e["source"]) for e in corrupt] == [(1, "cache")]
    if pkg == "torch":
        assert ck.timings["restore_source"] == "primary"
    rs.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_peer_replica_survives_partitioned_primary(tmp_path, pkg):
    p = _Pkg(pkg)
    # Commit through a healthy tier with one peer ...
    peer = p.local(tmp_path / "peer")
    rs = p.rep.ReplicatedStore(p.local(tmp_path / "store"), peers=[peer],
                               fanout=1)
    ck = p.checkpointer(rs)
    ck.save(p.state(1), step=1)
    ck.save(p.state(2), step=2)
    assert rs.flush(), "the peer pushes drain"
    rs.close()
    # ... then rejoin with the central store down: the peer carries it.
    rs2 = p.rep.ReplicatedStore(_DownStore(), peers=[peer], fanout=1)
    ck2 = p.checkpointer(rs2)
    restored = ck2.restore_host(p.template())
    assert int(restored["step"]) == 2
    np.testing.assert_array_equal(_w(restored), _w(p.state(2)))
    if pkg == "torch":
        assert ck2.timings["restore_source"] == "peer:peer-0"
    # Every copy corrupt: only then does the restore raise CheckpointCorrupt.
    for s in (1, 2):
        _flip_byte(_blob_path(tmp_path / "peer", s))
    with pytest.raises(p.ck.CheckpointCorrupt):
        ck2.restore_host(p.template(), step=2)
    rs2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_latest_vote_when_primary_partitioned(tmp_path, pkg):
    p = _Pkg(pkg)
    stale = p.local(tmp_path / "a")
    stale.put("t/LATEST", json.dumps({"step": 1}).encode())
    fresh = p.local(tmp_path / "b")
    fresh.put("t/LATEST", json.dumps({"step": 3}).encode())
    rs = p.rep.ReplicatedStore(_DownStore(), peers=[stale, fresh])
    assert json.loads(bytes(rs.get("t/LATEST")))["step"] == 3, \
        "a lagging peer must not roll the run back"
    rs.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_maybe_replicated_identity_without_config(tmp_path, pkg):
    p = _Pkg(pkg)
    store = p.local(tmp_path)
    assert p.rep.maybe_replicated(store, None) is store
    assert p.rep.maybe_replicated(store, p.Config()) is store
    wrapped = p.rep.maybe_replicated(
        store, p.Config(cache_dir=str(tmp_path / "cache")))
    assert isinstance(wrapped, p.rep.ReplicatedStore)
    assert wrapped.primary is store and wrapped.fanout == 2
    wrapped.close()


def test_reference_reads_a_cache_the_port_serves(tmp_path):
    """A port worker's cache served by ``serve_cache``: the JAX package's
    ``ShardServerStore`` lists it and restores its blob bit for bit, and the
    port's Checkpointer restores from it as a peer when its own cache and
    primary are gone. Pushes to the served cache land as the port's."""
    p = _Pkg("torch")
    cache_root = tmp_path / "served"
    srv = prep.serve_cache(str(cache_root))
    try:
        rs = prep.ReplicatedStore(p.local(tmp_path / "store"),
                                  cache=p.local(cache_root),
                                  peers=[srv.addr], fanout=1)
        ck = p.checkpointer(rs)
        ck.save(p.state(4), step=4)
        assert rs.flush()
        rs.close()
        jstore = jck.ShardServerStore(srv.addr)
        assert "t/step-0000000004" in jstore.list("t")
        got = jck.Checkpointer(jstore, name="t").restore_host(
            _Pkg("jax").template())
        assert int(got["step"]) == 4
        np.testing.assert_array_equal(got["w"], _w(p.state(4)))
        rs2 = prep.ReplicatedStore(_DownStore(), peers=[srv.addr])
        ck2 = p.checkpointer(rs2)
        restored = ck2.restore_host(p.template())
        assert int(restored["step"]) == 4
        assert ck2.timings["restore_source"] == f"peer:{srv.addr}"
        rs2.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("argv", [
    [],
    ["--ckpt-cache-dir", "/c"],
    ["--ckpt-peers", "a:1,b:2"],
    ["--ckpt-serve-cache"],
    ["--ckpt-cache-dir", "", "--ckpt-peers", "a:1", "--ckpt-serve-cache"],
], ids=["none", "cache", "peers", "serve", "all"])
def test_worker_ckpt_flags_parse_and_merge_as_the_reference(argv):
    base = ["worker", "--model", "llama_tiny"]
    got = pcli.build_parser().parse_args(base + argv)
    want = jcli.build_parser().parse_args(base + argv)
    for name in ("ckpt_cache_dir", "ckpt_peers", "ckpt_serve_cache"):
        assert getattr(got, name) == getattr(want, name), name
    cfg = ExperimentConfig(model="llama_tiny", checkpoint=CheckpointConfig(
        cache_dir="/cfg", peers="cfg:9", serve_cache=False))
    ck = pcli._with_ckpt_flags(cfg, got).checkpoint
    # The reference's merge (cli.py:1075-1087): a flag given wins.
    assert ck.cache_dir == (want.ckpt_cache_dir
                            if want.ckpt_cache_dir is not None else "/cfg")
    assert ck.peers == (want.ckpt_peers if want.ckpt_peers is not None
                        else "cfg:9")
    assert ck.serve_cache == bool(want.ckpt_serve_cache)


# -- the heartbeat-RTT item ---------------------------------------------------

HB_MS, LEASE_MS, SWEEP_MS = 20, 5000, 50
HB_DELAY_S = 0.3   # the coordinator's late heartbeat answers during a save
SAVE_HOLD_S = 0.9  # how long the slowed save holds its put of the data
TICK_S = 0.05
# Heartbeat-RTT samples each engine takes before the transition: past its
# anomaly_min_samples (12), so a z is computed, with a baseline of more.
BASELINE_SAMPLES = 20


class _SlowBeats(pd.Coordinator):
    """Answers heartbeats ``HB_DELAY_S`` late while ``slow`` is set."""

    slow = threading.Event()

    def handle(self, conn, reader, mtype, payload):
        if mtype == wire.MSG_HEARTBEAT_REQ and self.slow.is_set():
            time.sleep(HB_DELAY_S)
        return super().handle(conn, reader, mtype, payload)


class _SlowSave:
    """A store whose first armed put of a sharded save's data holds for
    ``SAVE_HOLD_S`` with the coordinator's heartbeats slowed: a stand-in
    for a multi-GB save that starves the heartbeat thread."""

    def __init__(self, inner):
        self.inner = inner
        self.armed = threading.Event()

    def put(self, key, data):
        if key.endswith(".dat") and self.armed.is_set():
            self.armed.clear()
            _SlowBeats.slow.set()
            try:
                time.sleep(SAVE_HOLD_S)
                return self.inner.put(key, data)
            finally:
                _SlowBeats.slow.clear()
        return self.inner.put(key, data)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _transition_alerts(et, engine, store, steps_now, join):
    """Run ``et`` in a thread under ``engine``; once the engine holds
    ``BASELINE_SAMPLES`` heartbeat-RTT samples and two steps ran, a member
    joins (one transition, whose save is slowed), and two steps after the
    re-formation the run stops. Returns the alert events."""
    alerts, out, errors = [], [], []
    engine._emit = alerts.append
    engine.start()

    def run():
        try:
            out.append(et.run(num_steps=100_000))
        except BaseException as e:  # re-raised below
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    joiner = None
    try:
        wait_for(lambda: et.transitions or errors, "the first formation")
        wait_for(lambda: (steps_now() >= 2 and engine._anomaly[
            "heartbeat_rtt"].n >= BASELINE_SAMPLES) or errors,
            "a baseline of heartbeat-RTT samples")
        store.armed.set()
        joiner = join()
        wait_for(lambda: len(et.transitions) > 1 or errors, "the transition")
        base = steps_now()
        wait_for(lambda: steps_now() >= base + 2 or errors,
                 "steps after the transition")
        time.sleep(3 * TICK_S)
    finally:
        et.request_stop()
        th.join(timeout=WAIT_S)
        engine.stop()
        if joiner is not None:
            joiner()
    if errors:
        raise errors[0]
    assert not th.is_alive() and out
    return [a for a in alerts if a.get("event") == "alert"]


def _hb_alerts(alerts):
    return sorted({(a["alert"], a["severity"]) for a in alerts
                   if "heartbeat" in a["alert"]})


def test_heartbeat_rtt_alert_through_a_transition_matches_the_reference(
        tmp_path):
    """Settles ROADMAP queue 3's heartbeat-RTT item: with the heartbeats
    answered late while a transition's save runs, the reference's health
    engine warns on heartbeat RTT as the port's does (the same alert, a
    warning, no page), so the warning in the port's phase 13 is behaviour
    the reference shares. The port's transition restores from its
    worker-local cache."""
    co = _SlowBeats(lease_ttl_ms=LEASE_MS, sweep_ms=SWEEP_MS).start()
    try:
        # The reference, llama_tiny, its health engine over its registry.
        jcfg = JExperimentConfig(
            model="llama_tiny", train=JTrainConfig(batch_size=2, seed=0),
            data=JDataConfig(seq_len=16),
            control=JControlConfig(heartbeat_interval_ms=HB_MS))
        jstore = _SlowSave(jck.LocalStore(str(tmp_path / "jax")))
        jsteps = jax_registry().counter("slt_train_steps_total")
        j0 = jsteps.value
        jet = JElasticTrainer(jcfg, jstore, coordinator_addr=co.addr,
                              advertise_addr="jax:1", n_chips=1,
                              name="jax-worker")

        def jjoin():
            agent = jc.WorkerAgent(co.addr, "joiner:1", name="jjoiner",
                                   n_chips=1,
                                   heartbeat_interval_ms=HB_MS).start()
            return lambda: agent.stop()

        jalerts = _transition_alerts(
            jet, JHealth(registry=jax_registry(),
                         config=JHealthConfig(sample_interval_s=TICK_S),
                         interval_s=TICK_S),
            jstore, lambda: jsteps.value - j0, jjoin)
        assert len(jet.transitions) == 2

        # The port, llama_tiny, its cache on, its engine over its registry.
        cfg = ExperimentConfig(
            model="llama_tiny", train=TrainConfig(batch_size=2, seed=0,
                                                  dtype="float32"),
            data=DataConfig(seq_len=16),
            control=ControlConfig(heartbeat_interval_ms=HB_MS),
            checkpoint=CheckpointConfig(cache_dir=str(tmp_path / "cache")))
        pstore = _SlowSave(pck.LocalStore(str(tmp_path / "port")))
        reg, led = MetricsRegistry(), PhaseLedger(emit=False)
        prev = goodput.set_ledger(led)
        try:
            et = ElasticTrainer(cfg, pstore, coordinator_addr=co.addr,
                                name="port-worker", device="cpu",
                                registry=reg)
            steps = reg.counter("slt_train_steps_total")

            def pjoin():
                from serverless_learn_tpu_torch.control import client as pc
                agent = pc.WorkerAgent(co.addr, "joiner:2", name="pjoiner",
                                       n_chips=1,
                                       heartbeat_interval_ms=HB_MS).start()
                return lambda: agent.stop()

            palerts = _transition_alerts(
                et, HealthEngine(registry=get_registry(),
                                 config=HealthConfig(
                                     sample_interval_s=TICK_S),
                                 interval_s=TICK_S, ledger=led),
                pstore, lambda: steps.value, pjoin)
        finally:
            goodput.set_ledger(prev)
    finally:
        co.stop()
    assert len(et.transitions) == 2
    want = _hb_alerts(jalerts)
    assert want, f"the reference did not warn: {jalerts}"
    assert _hb_alerts(palerts) == want
    assert all(sev == "warning" for _, sev in want)
    # The transition's restore read the worker's own cache.
    rec = et.remesh_records[1]
    assert rec["restore_source"] == "cache"
    assert rec["restored_step"] == rec["saved_step"]


REPLICA_VALUES = {"cache_dir": "ckpt-cache", "peers": "a:1,b:2",
                  "replica_fanout": 3, "serve_cache": True,
                  "serve_cache_port": 50070}


@pytest.mark.parametrize("name", sorted(REPLICA_VALUES),
                         ids=lambda n: f"checkpoint.{n}")
def test_replica_field_loads_as_the_reference(name, tmp_path):
    """Each replication field of the reference's CheckpointConfig loads off
    its default (it raised "not yet ported" before), to the value the
    reference's config loads; with a cache or peers it tiers the store."""
    from serverless_learn_tpu.config import (
        ExperimentConfig as JExperimentConfig)

    raw = {"model": "llama_tiny", "checkpoint": {name: REPLICA_VALUES[name]}}
    ck = ExperimentConfig.from_dict(raw).checkpoint
    assert getattr(ck, name) == getattr(
        JExperimentConfig.from_dict(raw).checkpoint, name)
    store = pck.LocalStore(str(tmp_path / "store"))
    if name == "cache_dir":
        ck = CheckpointConfig(cache_dir=str(tmp_path / "cache"))
    wrapped = prep.maybe_replicated(store, ck)
    if name in ("cache_dir", "peers"):
        assert isinstance(wrapped, prep.ReplicatedStore)
        assert wrapped.fanout == ck.replica_fanout
        wrapped.close()
    else:
        assert wrapped is store
