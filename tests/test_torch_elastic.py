"""The port's elastic trainer (``serverless_learn_tpu_torch/training/
elastic.py``) against the JAX package's, on the port's coordinator and
shard server, on the CPU:

* a join and a crash (heartbeats stop, the lease expires) give the
  reference's transitions, epoch and stripe, from the JAX
  ``ElasticTrainer`` and the port's alike, the step going on from the
  saved step at each;
* the port's losses across those transitions equal the JAX trainer's
  over the same stripe sources and steps (from the same initial params)
  within ``tests/test_torch_train.py``'s tolerance;
* the state is bit-equal across a save and restore through the shard
  server, as ``tests/test_elastic.py``'s remesh test shows for the JAX
  package, and the next step from it too;
* a solo run resumes from its newest checkpoint; a fenced-out worker
  raises without saving; an exclusive name held by a live worker is
  refused.

Every daemon binds port 0 and is stopped by a finalizer; every join has a
timeout; waits poll a condition under a deadline.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.config import (ControlConfig as JControlConfig,
                                         DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         MeshConfig as JMeshConfig,
                                         OptimizerConfig as JOptimizerConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.control import client as jc
from serverless_learn_tpu.data.shard_client import (
    ShardStreamSource as JShardStreamSource)
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.telemetry import get_registry as jax_registry
from serverless_learn_tpu.training import checkpoint as jck
from serverless_learn_tpu.training.elastic import (
    ElasticTrainer as JElasticTrainer)
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch.bridge import from_jax_params
from serverless_learn_tpu_torch.config import (ControlConfig, DataConfig,
                                               ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.control import client as pc
from serverless_learn_tpu_torch.control import daemons as pd
from serverless_learn_tpu_torch.data.shard_client import (ShardStreamSource,
                                                          publish_dataset)
from serverless_learn_tpu_torch.telemetry import goodput
from serverless_learn_tpu_torch.telemetry.goodput import PhaseLedger
from serverless_learn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                           get_registry)
from serverless_learn_tpu_torch.training.checkpoint import (Checkpointer,
                                                            LocalStore,
                                                            ShardServerStore)
from serverless_learn_tpu_torch.training.elastic import ElasticTrainer
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils import serialization as ser

SEQ, BATCH = 16, 2
WAIT_S = 30.0
# A lease of 30 heartbeats: under a loaded test run (six busy workers on a
# few cores) a 1 s lease lapsed now and then, and a lapse is a membership
# change of its own.
LEASE_MS, SWEEP_MS, HEARTBEAT_MS = 3000, 50, 100
# tests/test_torch_train.py's: f32 on both sides, XLA and ATen summing in
# other orders.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    # The JAX clients take the socket path (the committed libslt.so is not
    # this image's to load).
    monkeypatch.setattr(jc._NativeLib, "get", classmethod(lambda cls: None))


@pytest.fixture
def coordinator(request):
    srv = pd.Coordinator(lease_ttl_ms=LEASE_MS, sweep_ms=SWEEP_MS).start()
    request.addfinalizer(srv.stop)
    return srv


@pytest.fixture
def shard_server(request, tmp_path):
    srv = pd.ShardServer(root=str(tmp_path / "root")).start()
    request.addfinalizer(srv.stop)
    return srv


def wait_for(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"waited {timeout}s for {what}")


def _port_config():
    return ExperimentConfig(
        model="llama_tiny", optimizer=OptimizerConfig(name="adamw"),
        train=TrainConfig(batch_size=BATCH, dtype="float32", seed=0),
        data=DataConfig(seq_len=SEQ, dataset="ds"),
        control=ControlConfig(heartbeat_interval_ms=HEARTBEAT_MS))


def _jax_llama_trainer():
    jcfg = JExperimentConfig(
        model="llama_tiny", mesh=JMeshConfig(dp=1),
        optimizer=JOptimizerConfig(name="adamw"),
        train=JTrainConfig(batch_size=BATCH, dtype="float32", seed=0),
        data=JDataConfig(seq_len=SEQ))
    return jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                  devices=jax.devices()[:1]))


# Steps each formation of the join-and-crash run trains before the test's
# next event; the trainer is then held until its membership changes or it
# is stopped, so the run is as long whatever the lease and the joins take.
SEGMENT_STEPS = 2


def _hold_each_formation(et, steps_now):
    """Bound ``et.run``'s steps per formation to SEGMENT_STEPS: its step
    loop asks ``_remesh_due()`` before every step, and the wrapper answers
    only once the formation has taken its steps, holding the trainer until
    the real answer is yes or a stop is requested. Returns one event per
    formation, set when that formation is held."""
    held = [threading.Event() for _ in range(3)]
    starts = {}
    remesh_due = et._remesh_due

    def gated():
        n = len(et.transitions)  # formations so far; this one is the n-th
        start = starts.setdefault(n, steps_now())
        while steps_now() - start >= SEGMENT_STEPS and not et._stop.is_set():
            if n <= len(held):
                held[n - 1].set()
            if remesh_due():
                return True
            time.sleep(0.01)
        return remesh_due()

    et._remesh_due = gated
    return held


def _join_and_crash(et, coordinator, steps_now, joiner_chips=1):
    """Drive ``et.run`` in a thread, SEGMENT_STEPS steps a formation: after
    its first formation's steps a second member joins; after the
    re-formation's, the member crashes (its heartbeats stop, no
    deregister); after the eviction's re-formation's, the run is stopped.
    Returns run()'s result."""
    out, errors = [], []
    held = _hold_each_formation(et, steps_now)

    def run():
        try:
            out.append(et.run(num_steps=100_000))
        except BaseException as e:  # re-raised below
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    joiner = None
    try:
        for k in range(3):
            wait_for(lambda: held[k].is_set() or errors,
                     f"formation {k + 1}'s {SEGMENT_STEPS} steps")
            if errors:
                break
            if k == 0:
                joiner = pc.WorkerAgent(coordinator.addr, "joiner:1",
                                        name="joiner", n_chips=joiner_chips,
                                        heartbeat_interval_ms=HEARTBEAT_MS
                                        ).start()
            elif k == 1:
                joiner._stop.set()  # a crash: heartbeats stop
                joiner._thread.join(timeout=WAIT_S)
    finally:
        et.request_stop()
        th.join(timeout=WAIT_S)
        if joiner is not None:
            joiner.client.close()
    if errors:
        raise errors[0]
    assert not th.is_alive() and out
    return out[0]


def _publish(addr, n=48, per_shard=4):
    rng = np.random.default_rng(2)
    publish_dataset(addr, "ds", {"tokens": rng.integers(
        0, 512, (n, SEQ)).astype(np.int32)}, records_per_shard=per_shard)


def test_join_and_crash_match_the_reference(coordinator, shard_server,
                                            tmp_path):
    """The same join-and-crash against the port's coordinator: the JAX
    package's ElasticTrainer (mlp_mnist, as its own test) and the port's
    (llama_tiny streaming a dataset from the shard server, its checkpoints
    there too) form at the same epochs with the same stripes, each
    formation at the step the drain saved. The port's losses equal the
    JAX trainer's over the same stripe sources and steps, from the same
    initial params (a step-0 checkpoint of the JAX init)."""
    # The reference, on the port's coordinator.
    jcfg = JExperimentConfig(
        model="mlp_mnist",
        optimizer=JOptimizerConfig(name="sgd", learning_rate=0.05),
        train=JTrainConfig(batch_size=16), data=JDataConfig(),
        control=JControlConfig(heartbeat_interval_ms=HEARTBEAT_MS),
        model_overrides={"dtype": jnp.float32})
    jsteps = jax_registry().counter("slt_train_steps_total")
    j0 = jsteps.value
    jet = JElasticTrainer(jcfg, jck.LocalStore(str(tmp_path / "jax")),
                          coordinator_addr=coordinator.addr,
                          advertise_addr="trainer:1", n_chips=1,
                          name="jax-worker")
    _join_and_crash(jet, coordinator, lambda: jsteps.value - j0)
    want = [(t.epoch, t.stripe) for t in jet.transitions]
    assert [s for _, s in want] == [(0, 1), (0, 2), (0, 1)]

    # The port, on a fresh coordinator: the same epochs from 1.
    coordinator.stop()
    co2 = pd.Coordinator(lease_ttl_ms=LEASE_MS, sweep_ms=SWEEP_MS).start()
    try:
        _publish(shard_server.addr)
        cfg = _port_config()
        cfg = ExperimentConfig(**{**cfg.__dict__, "data": DataConfig(
            seq_len=SEQ, dataset="ds", shard_server_addr=shard_server.addr)})
        jtr = _jax_llama_trainer()
        jstate = jtr.init()
        tr = build_trainer(cfg, device="cpu")
        init = tr.init(params=from_jax_params(jax.tree_util.tree_map(
            np.asarray, jstate.params)))
        Checkpointer(ShardServerStore(shard_server.addr), name="port-worker",
                     async_save=False, sharded=True).save(
                         tr.state_tree(init))
        # The checkpointer charges the process's ledger: make it this run's.
        reg, led = MetricsRegistry(), PhaseLedger(emit=False)
        prev_ledger = goodput.set_ledger(led)
        verified = get_registry().counter("slt_ckpt_verified_restores_total")
        v0 = verified.value  # the checkpointer's series are process-wide
        et = ElasticTrainer(cfg, ShardServerStore(shard_server.addr),
                            coordinator_addr=co2.addr, name="port-worker",
                            device="cpu", registry=reg)
        steps = reg.counter("slt_train_steps_total")
        state, losses = _join_and_crash(et, co2, lambda: steps.value)
    finally:
        goodput.set_ledger(prev_ledger)
        co2.stop()
    got = [(t.epoch, t.stripe) for t in et.transitions]
    assert got == want
    recs = et.remesh_records
    assert [r["restored_step"] for r in recs] == [t.step for t in
                                                  et.transitions]
    assert [r["saved_step"] for r in recs[1:]] == [t.step for t in
                                                   et.transitions[1:]]
    starts = [t.step for t in et.transitions] + [state.step]
    assert starts == sorted(starts) and starts[0] == 0
    # Each formation took its SEGMENT_STEPS, no more.
    assert [b - a for a, b in zip(starts, starts[1:])] == [SEGMENT_STEPS] * 3
    assert len(losses) == state.step  # no step lost or repeated
    snap = reg.snapshot()
    value = lambda name, **lab: next(  # noqa: E731
        s["value"] for s in snap[name]["series"]
        if all(s["labels"].get(k) == v for k, v in lab.items()))
    assert value("slt_remesh_total") == 3
    assert value("slt_membership_epoch") == 3
    assert value("slt_membership_size") == 1
    assert value("slt_dcn_bytes_total", consumer="remesh",
                 direction="tx") > 0
    assert verified.value - v0 == 3
    assert {"remesh", "checkpoint", "step", "compile", "data_wait"} <= \
        set(led.report()["phases"])

    # The JAX trainer over the same segments: the source each formation
    # built (its stripe, seeded at its start step), as many steps.
    jlosses = []
    for (t, nxt) in zip(et.transitions, starts[1:]):
        src = JShardStreamSource(shard_server.addr, "ds", BATCH,
                                 seed=100_003 * t.step, dp_rank=t.stripe[0],
                                 dp_size=t.stripe[1])
        it = iter(src)
        for _ in range(nxt - t.step):
            jstate, m = jtr.step(jstate, jtr.shard_batch(next(it)))
            jlosses.append(float(m["loss"]))
        src.close()
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)


def test_state_is_bit_equal_across_a_remesh(shard_server):
    """Train 3 steps, save through the shard server, restore into a fresh
    trainer allocated empty: every leaf bit for bit, and the next step
    from either equal too."""
    cfg = _port_config()
    _publish(shard_server.addr)
    tr = build_trainer(cfg, device="cpu")
    state = tr.init()
    src = iter(ShardStreamSource(shard_server.addr, "ds", BATCH, seed=3))
    for _ in range(3):
        state, _ = tr.step(state, tr.place(next(src)))
    ck = Checkpointer(ShardServerStore(shard_server.addr), name="w",
                      async_save=False, sharded=True)
    ck.save(tr.state_tree(state))
    tr2 = build_trainer(cfg, device="cpu")
    fresh = tr2.init(fill=lambda model, seed: model)
    tree = tr2.state_tree(fresh)
    ck.restore(tree)
    tr2.load_tree(fresh, tree)
    assert fresh.step == 3

    def leaves(t, s):
        return [(p, x.detach().clone())
                for p, x in ser.leaves_with_paths(t.state_tree(s))]

    for (p, a), (q, b) in zip(leaves(tr, state), leaves(tr2, fresh)):
        assert p == q and torch.equal(a, b), p
    batch = next(src)
    state, m1 = tr.step(state, tr.place(batch))
    fresh, m2 = tr2.step(fresh, tr2.place(batch))
    assert torch.equal(m1["loss"], m2["loss"])
    for (p, a), (_, b) in zip(leaves(tr, state), leaves(tr2, fresh)):
        assert torch.equal(a, b), p


def test_solo_run_resumes_fencing_and_exclusive_names(tmp_path,
                                                      coordinator):
    """Without a coordinator a worker forms once and resumes from its
    newest checkpoint; a worker fenced out (its name taken during a lapsed
    lease) raises without saving; a name a live worker holds is refused
    once ``name_wait_s`` runs out."""
    cfg = _port_config()
    store = LocalStore(str(tmp_path / "ckpt"))
    et = ElasticTrainer(cfg, store, device="cpu", registry=MetricsRegistry())
    state, losses = et.run(num_steps=3)
    assert len(losses) == 3 and state.step == 3
    assert [(t.step, t.stripe, t.n_devices) for t in et.transitions] == \
        [(0, (0, 1), 1)]
    et = ElasticTrainer(cfg, store, device="cpu", registry=MetricsRegistry())
    state, losses = et.run(num_steps=5)
    assert et.transitions[0].step == 3 and len(losses) == 2

    reg = MetricsRegistry()
    live = ElasticTrainer(cfg, LocalStore(str(tmp_path / "b")),
                          coordinator_addr=coordinator.addr, name="held",
                          device="cpu", registry=reg)
    errors = []

    def run():
        try:
            live.run(num_steps=100_000)
        except RuntimeError as e:
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    steps = reg.counter("slt_train_steps_total")
    wait_for(lambda: steps.value >= 2, "steps")
    twin = ElasticTrainer(cfg, LocalStore(str(tmp_path / "c")),
                          coordinator_addr=coordinator.addr, name="held",
                          device="cpu", name_wait_s=0.3,
                          registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="already held"):
        twin.run(num_steps=1)
    live._agent.fatal = "name 'held' taken over"
    th.join(timeout=WAIT_S)
    assert not th.is_alive()
    assert errors and "worker fenced out" in str(errors[0])
    assert Checkpointer(LocalStore(str(tmp_path / "b")),
                        name="held").latest_step() is None


def test_worker_needs_the_card_by_default(coordinator):
    """``worker`` runs on the card: without one (and without ``--device
    cpu``) it raises before registering with anyone."""
    from serverless_learn_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["worker", "--model", "llama_tiny", "--coordinator",
                  coordinator.addr, "--steps", "1"])
    assert coordinator._workers == {}
