"""The port's numerics layer against the JAX package's
(``telemetry/numerics.py``, ``training/audit.py``): the statistics and
fingerprints of trees with NaN and +-inf, the subtree names and order of
llama_tiny's parameters, one adamw step's ``metrics["numerics"]``, the
NaN-injection drill through ``run_training`` (sgd, and adamw with clipping),
the provenance sweep on an overflowing layer, the loss-health detectors and
their alerts, the cadence of the fetches, ``numerics diff`` across the two
packages' trails, ``--self-check`` and the elastic worker's
``remesh_restore`` fingerprint. The stats kernels' own tests are in
``tests/test_torch_tensor_stats.py``.

The JAX trainers are built once for the module (a compile each); both
packages run in f32 on the CPU, where the port's wrappers run the stats
kernels' plain versions.
"""

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu import cli as jcli
from serverless_learn_tpu.config import (DataConfig as JDataConfig,
                                         ExperimentConfig as JExperimentConfig,
                                         MeshConfig as JMeshConfig,
                                         NumericsConfig as JNumericsConfig,
                                         OptimizerConfig as JOptimizerConfig,
                                         TrainConfig as JTrainConfig)
from serverless_learn_tpu.data.datasets import SyntheticSource as JSource
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.telemetry import health as jhealth
from serverless_learn_tpu.telemetry import numerics as jn
from serverless_learn_tpu.telemetry import registry as jregistry
from serverless_learn_tpu.training.audit import NumericsAuditor as JAuditor
from serverless_learn_tpu.training.loop import run_training as jrun_training
from serverless_learn_tpu.training.optimizer import make_optimizer
from serverless_learn_tpu.training.train_state import (
    TrainState as JTrainState)
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.bridge import (from_jax_params, to_flax,
                                              to_jax_params)
from serverless_learn_tpu_torch.config import (DataConfig, ExperimentConfig,
                                               NumericsConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.telemetry import health as thealth
from serverless_learn_tpu_torch.telemetry import numerics as tn
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.goodput import PhaseLedger
from serverless_learn_tpu_torch.telemetry.registry import MetricsRegistry
from serverless_learn_tpu_torch.training.audit import NumericsAuditor
from serverless_learn_tpu_torch.training.checkpoint import LocalStore
from serverless_learn_tpu_torch.training.elastic import ElasticTrainer
from serverless_learn_tpu_torch.training.loop import run_training
from serverless_learn_tpu_torch.training.train_step import build_trainer

BATCH, SEQ, STEPS = 2, 16, 5
# One of llama_tiny's two layers: each JAX trainer with numerics in its
# step compiles for ~12 s on one core, the second layer adds ~2.5 s.
OVERRIDES = {"n_layers": 1}
INJECT = dict(inject_nan_step=3, inject_nan_subtree="layer_0")
ADAMW = dict(name="adamw", learning_rate=1e-3, weight_decay=0.1,
             grad_clip_norm=1.0)
SGD = dict(name="sgd", learning_rate=1e-2)
# Norms, maxima and ratios: the kernels' plain versions square in f32 and
# sum in f64, XLA sums in f32 in its own order; ~1e-6 relative, and adam's
# updates (every weight moves by ~lr) carry the step's own f32 round-off.
STAT_TOL = dict(rtol=2e-5, atol=1e-7)
# Sums and chunk sums of ~1e5 signed values cancel: the reference's f32
# sum is ~sqrt(n) 2^-24 of the subtree's L1 away from the exact one.
SUM_TOL = dict(rtol=1e-4, atol=2e-3)


def _configs(opt, cadence=4, overrides=OVERRIDES, **numerics):
    n = dict(enabled=True, cadence=cadence, **numerics)
    jcfg = JExperimentConfig(
        model="llama_tiny", model_overrides=dict(overrides),
        mesh=JMeshConfig(dp=1),
        optimizer=JOptimizerConfig(**opt),
        train=JTrainConfig(batch_size=BATCH, num_steps=STEPS, seed=0,
                           dtype="float32"),
        data=JDataConfig(seq_len=SEQ), numerics=JNumericsConfig(**n))
    tcfg = ExperimentConfig(
        model="llama_tiny", model_overrides=dict(overrides),
        optimizer=OptimizerConfig(**opt),
        train=TrainConfig(batch_size=BATCH, num_steps=STEPS, seed=0,
                          dtype="float32"),
        data=DataConfig(seq_len=SEQ), numerics=NumericsConfig(**n))
    return jcfg, tcfg


def _jax_state(jtr, host):
    """A JAX TrainState at step 0 over ``host`` params (the optimizer's own
    init, eagerly; the trainer's jitted init would cost a compile), placed
    as the trainer's jitted step takes it (else the step compiles again)."""
    params = jax.tree_util.tree_map(jnp.asarray, host)
    state = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=make_optimizer(jtr.config.optimizer).init(params),
        model_state={})
    return jax.device_put(state, jtr.state_shardings)


@pytest.fixture(scope="module")
def init_params():
    """llama_tiny's initial params from the port's seeded init, and the
    same in the reference's flax tree."""
    torch.set_num_threads(1)
    _, tcfg = _configs(SGD)
    tr = build_trainer(tcfg, device="cpu")
    named = {k: v.detach().clone() for k, v in
             tr.init().model.state_dict().items()}
    return named, to_jax_params(named, tr.bundle.cfg)


def _drill(opt, init_params):
    """The first step's numerics in both packages, and each package's
    auditor records of a run_training drill with a NaN injected into
    layer_0's gradients at step 3."""
    named, host = init_params
    jcfg, tcfg = _configs(opt, **INJECT)
    jtr = jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                 devices=jax.devices()[:1]))
    batch = next(iter(JSource(jtr.bundle.make_batch, jcfg.data, BATCH,
                              seed=7)))
    _, m = jtr.step(_jax_state(jtr, host), jtr.shard_batch(batch))
    j_first = {k: float(v) for k, v in jax.device_get(m["numerics"]).items()}
    ttr = build_trainer(tcfg, device="cpu")
    _, m = ttr.step(ttr.init(params=named), ttr.place(batch))
    t_first = m["numerics"].fetch()

    # The JAX auditor's records from the params pass alone (module None):
    # its eager capture sweep costs seconds, and the sweep has its own test.
    jrecs, trecs = [], []
    jaud = JAuditor(jcfg, bundle=types.SimpleNamespace(module=None),
                    emit=jrecs.append)
    jrun_training(jcfg, trainer=jtr, state=_jax_state(jtr, host),
                  auditor=jaud)
    reg, led = MetricsRegistry(), PhaseLedger()
    taud = NumericsAuditor(tcfg, registry=reg, bundle=ttr.bundle,
                           emit=trecs.append, ledger=led)
    tstate, meter = run_training(tcfg, trainer=ttr,
                                 state=ttr.init(params=named),
                                 auditor=taud, registry=reg, ledger=led)
    return types.SimpleNamespace(
        jtr=jtr, host=host, named=named, batch=batch, j_first=j_first,
        t_first=t_first, jrecs=jrecs, trecs=trecs, jaud=jaud, taud=taud,
        reg=reg, led=led, tstate=tstate, meter=meter, ttr=ttr, tcfg=tcfg)


@pytest.fixture(scope="module")
def adamw_run(init_params):
    return _drill(ADAMW, init_params)


@pytest.fixture(scope="module")
def sgd_run(init_params):
    return _drill(SGD, init_params)


def _trees():
    """A small tree with NaN, +inf and -inf planted, and its twin of the
    same structure (grads, updates)."""
    rng = np.random.default_rng(3)
    tree = {"dense_0": {"kernel": rng.normal(size=(9, 7)).astype(np.float32),
                        "bias": rng.normal(size=(7,)).astype(np.float32)},
            "head": {"kernel": rng.normal(size=(7, 5)).astype(np.float32)},
            "layer_10": {"w": rng.normal(size=(13,)).astype(np.float32)},
            "layer_2": {"w": rng.normal(size=(3, 4)).astype(np.float32)}}
    tree["dense_0"]["kernel"][2, 3] = np.nan
    tree["head"]["kernel"][0, 1] = np.inf
    tree["head"]["kernel"][4, 4] = -np.inf
    tree["layer_2"]["w"][1, 1] = 1e30  # squares to inf in f32
    twin = jax.tree_util.tree_map(
        lambda a: (a * 0.5 + 0.25).astype(np.float32), tree)
    return tree, twin


def _close(got, want, key):
    tol = SUM_TOL if ("/sum" in key or "/c" in key) else STAT_TOL
    if math.isnan(want) or math.isinf(want):
        assert got == want or (math.isnan(got) and math.isnan(want)), key
        return
    np.testing.assert_allclose(got, want, err_msg=key, **tol)


def test_stats_and_fingerprints_with_nan_and_inf():
    """tree_stats, fingerprint and step_summary of trees holding NaN, +-inf
    and a value whose square overflows: non-finite values counted and left
    out of the norms, sums and chunk sums; the unmasked global norms NaN or
    inf as the reference's."""
    tree, twin = _trees()
    ref = jax.jit(lambda t, tw, loss: (
        jn.tree_stats(t), jn.fingerprint(t, chunks=3),
        jn.step_summary(t, tw, tw, loss=loss)))
    jst, jfp, jsum = jax.device_get(ref(tree, twin, np.float32(np.nan)))
    tst = tn.tree_stats(tree)
    assert list(tst) == list(jst)
    for name in jst:
        for k in ("l2", "rms", "absmax", "nonfinite"):
            _close(float(tst[name][k]), float(jst[name][k]), f"{name}/{k}")
    assert int(tst["head"]["nonfinite"]) == 2
    tfp = tn.fingerprint(tree, chunks=3)
    for name in jfp:
        for k in jfp[name]:
            _close(float(tfp[name][k]), float(jfp[name][k]),
                   f"fp/{name}/{k}")
    js = {k: float(v) for k, v in jsum.items()}
    tsum = tn.step_summary(tree, twin, twin, loss=torch.tensor(np.nan))
    assert sorted(tsum) == sorted(js)
    for k, v in tsum.fetch().items():
        _close(v, js[k], k)
    # 3 non-finite values in each tree (the grads' twin keeps them) + the loss
    assert math.isnan(js["param_norm"]) and js["nonfinite_total"] == 7


def test_subtree_names_and_order_through_the_bridge():
    """The port's subtrees of llama_tiny's params (its state dict through
    ``bridge.to_flax``) are the reference's flax names in jax's flatten
    order, leaf for leaf in the same shapes (so the same element order
    inside each subtree), and the train step groups its tensors the same
    way. Names sort as strings: layer_10 before layer_2."""
    jcfg, tcfg = _configs(SGD, overrides={})
    jtr = jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                 devices=jax.devices()[:1]))
    flax = jtr.abstract_state().params  # traced, not compiled
    ttr = build_trainer(tcfg, device="cpu")
    model = ttr.init().model
    ported = to_flax(dict(model.named_parameters()), ttr.bundle.cfg)
    want = list(jn.subtrees(flax))
    assert list(tn.subtrees(ported)) == want
    names = [n for n, _ in model.named_parameters()]
    plan = tn.StepNumerics(names, [1] * len(names)).plan
    assert plan.names == want
    for depth in (1, 2):
        assert {k: [tuple(x.shape) for x in v] for k, v in
                tn.subtrees(ported, depth).items()} == \
            {k: [tuple(x.shape) for x in v] for k, v in
             jn.subtrees(flax, depth).items()}
    assert [n for n in want if n.startswith("layer_")] == ["layer_0",
                                                           "layer_1"]
    assert list(tn.subtrees({"layer_2": 1, "layer_10": 2})) == list(
        jn.subtrees({"layer_2": 1, "layer_10": 2})) == ["layer_10",
                                                        "layer_2"]


def test_one_adamw_step_numerics_match(adamw_run):
    """The first adamw step (clipping live, weight decay on):
    ``metrics["numerics"]`` has the reference's keys and values."""
    j, t = adamw_run.j_first, adamw_run.t_first
    assert sorted(t) == sorted(j)
    for k in j:
        _close(t[k], j[k], k)
    assert j["grad_norm"] > ADAMW["grad_clip_norm"]  # clipping is live
    assert t["nonfinite_total"] == 0


def _incident(recs):
    bad = [r for r in recs if r["event"] == "numerics_nonfinite"]
    return [(r["step"], r["first"], r["bad_subtrees"], r["nonfinite"])
            for r in bad]


@pytest.mark.parametrize("run", ["sgd_run", "adamw_run"])
def test_nan_injection_drill_matches(run, request):
    """run_training with a NaN injected into layer_0's gradients at step 3:
    both packages record the incident at step 3 with the same first bad
    subtree and bad subtrees. Without clipping only layer_0's parameters go
    bad (``params:layer_0``); with clipping the NaN norm scales every
    gradient, so every parameter subtree is bad and ``first`` is the first
    in sorted order, while ``grad:`` names only the injected one."""
    r = request.getfixturevalue(run)
    j, t = _incident(r.jrecs), _incident(r.trecs)
    assert t == j
    step, first, bad, _ = t[0]
    assert step == INJECT["inject_nan_step"]
    assert [b for b in bad if b.startswith("grad:")] == ["grad:layer_0"]
    if run == "sgd_run":
        assert first == "params:layer_0"
        assert bad == ["grad:layer_0", "param:layer_0"]
    else:
        assert first == "params:embedder"
        assert len(bad) == 1 + len(jn.subtrees(r.host))
    prov = next(x for x in r.trecs
                if x["event"] == "numerics_nonfinite")["provenance"]
    assert prov["source"] == "live_state" and prov["kind"] == "nan"
    assert r.reg.counter("slt_numerics_nonfinite_total").value == 3
    # clean steps before the injection: the same losses as numerics off
    off = dataclasses.replace(r.tcfg, numerics=NumericsConfig())
    ttr = build_trainer(off, device="cpu")
    _, meter = run_training(off, trainer=ttr,
                            state=ttr.init(params=r.named),
                            registry=MetricsRegistry(), ledger=PhaseLedger())
    clean = INJECT["inject_nan_step"] - 1
    assert [s.metrics["loss"] for s in meter.history[:clean]] == \
        [s.metrics["loss"] for s in r.meter.history[:clean]]


def test_fetch_cadence(adamw_run):
    """Cadence 4 over 5 steps: the forced fetch at the incident (step 3),
    the cadence (4) and the final step (5), as the reference's auditor; the
    fetches land in the ``numerics`` goodput phase."""
    r = adamw_run
    stats = lambda recs: [x["step"] for x in recs  # noqa: E731
                          if x["event"] == "numerics_stats"]
    assert stats(r.trecs) == stats(r.jrecs) == [3, 4, 5]
    assert r.taud.fetches == r.jaud.fetches == 3
    assert r.reg.counter("slt_numerics_fetches_total").value == 3
    assert r.led.report()["phases"]["numerics"]["count"] == 3


def test_overflowing_layer_named_by_the_sweep(adamw_run):
    """Weights scaled so that layer_0's MLP overflows: the parameters stay
    finite, and both sweeps name the same first module whose output is
    non-finite, with the same set of bad modules."""
    host = adamw_run.host
    bad = jax.tree_util.tree_map(np.array, host)
    for proj in ("gate_proj", "up_proj"):
        bad["layer_0"]["mlp"][proj]["kernel"] *= np.float32(1e20)
    tokens = adamw_run.batch["tokens"]
    jrep = jn.nonfinite_provenance(adamw_run.jtr.bundle.module, bad,
                                   {"tokens": tokens})
    model = adamw_run.ttr.init(params=adamw_run.named).model
    cfg = adamw_run.ttr.bundle.cfg
    trep = tn.nonfinite_provenance(
        model, to_flax({k: torch.as_tensor(v) for k, v in
                        from_jax_params(bad).items()}, cfg),
        {"tokens": torch.from_numpy(tokens)})
    assert jrep["param"] is None and trep["param"] is None
    assert trep["first"] == jrep["first"] == "intermediates:layer_0"
    assert trep["kind"] == jrep["kind"]
    assert [x["layer"] for x in trep["intermediates"]] == \
        [x["layer"] for x in jrep["intermediates"]]
    assert sorted(trep["activations"]) == sorted(jrep["activations"])
    for name, a in jrep["activations"].items():
        np.testing.assert_allclose(trep["activations"][name]["rms"],
                                   a["rms"], rtol=1e-3, err_msg=name)
    # the sweep's hooks are gone
    assert all(not m._forward_hooks for m in model.modules())


def _series():
    rng = np.random.default_rng(11)
    out = []
    for i in range(80):
        loss = 3.0 - 0.02 * i + 0.01 * rng.normal()
        grad = 1.0 + 0.05 * rng.normal()
        if i == 40:
            loss = 40.0  # a spike
        if i == 55:
            grad = 400.0  # an explosion
        if i >= 60:
            loss = 1.9  # a plateau
        out.append((i + 1, loss, grad))
    out.append((81, float("nan"), 1.0))
    return out


def test_loss_health_findings_and_alerts_match():
    """The same loss / grad-norm series through both packages'
    LossHealth and, as step records, through both health engines: the same
    findings at every step and the same numerics alerts at every tick."""
    kw = dict(spike_z=6.0, plateau_window=10, min_samples=8)
    jlh, tlh = jn.LossHealth(**kw), tn.LossHealth(**kw)
    fired = set()
    for step, loss, grad in _series():
        j, t = jlh.update(step, loss, grad), tlh.update(step, loss, grad)
        assert _shape(t) == _shape(j), step
        fired |= {k for k, v in t.items() if v}
    assert fired == {"loss_spike", "loss_plateau", "grad_explosion",
                     "nonfinite"}

    def run(numerics, health, registry_cls):
        numerics.clear_steps()
        eng = health.HealthEngine(
            registry=registry_cls(),
            config={"numerics_plateau_window": 10, "anomaly_min_samples": 8},
            emit=lambda r: None, dump_on_critical=False)
        ticks = []
        for k, (step, loss, grad) in enumerate(_series()):
            numerics.note_step({"step": step, "loss": loss,
                                "grad_norm": grad,
                                "nonfinite": 1 if math.isnan(loss) else 0})
            if k % 4 == 3 or k == 80:
                eng.sample_once(now=1000.0 + k)
                ticks.append(sorted(
                    (a["alert"], a["severity"], a["state"])
                    for a in eng.alerts() if a["alert"].startswith(
                        "numerics.")))
        numerics.clear_steps()
        return ticks

    jt = run(jn, jhealth, jregistry.MetricsRegistry)
    tt = run(tn, thealth, MetricsRegistry)
    assert tt == jt
    assert ("numerics.nonfinite", "critical", "firing") in tt[-1]


def _shape(findings):
    return {k: (None if v is None else (v["severity"], v["threshold"]))
            for k, v in findings.items()}


def test_numerics_diff_across_packages(adamw_run, tmp_path, capsys):
    """A JAX trail and a port trail of the same first step agree under both
    packages' ``numerics diff`` (at the stated tolerance); a port trail with
    one subtree's digest moved at step 2 is named at step 2."""
    r = adamw_run
    fp = lambda d: {  # noqa: E731
        name: {f: d[f"fp/{name}/{f}"] for f in
               ("l2", "sum", "absmax", "c0", "c1", "c2", "c3")}
        for name in jn.subtrees(r.host)}
    ja, ta = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    moved = tmp_path / "moved.jsonl"
    for path, first, shift in ((ja, r.j_first, 0.0), (ta, r.t_first, 0.0),
                               (moved, r.t_first, 1.0)):
        with open(path, "w") as f:
            for step in (1, 2):
                d = fp(first)
                if step == 2:
                    d["layer_0"]["c2"] += shift
                f.write(json.dumps({"event": "numerics_fingerprint",
                                    "step": step, "fp": d}) + "\n")
    tol = ["--rtol", "1e-4", "--atol", "2e-3"]  # SUM_TOL
    for main in (cli.main, jcli.main):
        assert main(["numerics", "diff", str(ja), str(ta), "--compact",
                     *tol]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert not rep["diverged"] and rep["steps_compared"] == 2
        assert main(["numerics", "diff", str(ja), str(moved), "--compact",
                     *tol]) == 1
        rep = json.loads(capsys.readouterr().out)
        assert (rep["first_divergent_step"], rep["subtree"],
                rep["field"]) == (2, "layer_0", "c2")
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps(x) + "\n" for x in r.trecs))
    assert cli.main(["numerics", "summary", str(events), "--compact"]) == 1
    summ = json.loads(capsys.readouterr().out)
    assert summ["audited_steps"] == 3
    assert summ["nonfinite_incidents"][0]["first"] == "params:embedder"


def test_self_check(capsys):
    """``numerics --self-check`` passes every check the reference's does."""
    assert cli.main(["numerics", "--self-check", "--compact"]) == 0
    rep = json.loads(capsys.readouterr().out)
    # serverless_learn_tpu/telemetry/numerics.py self_check's checks
    want = ["stats_exact", "global_norm_exact", "nan_named",
            "bisect_finds_seeded_divergence", "loss_spike_fires",
            "parity_identical_zero_ulp"]
    assert rep["ok"] and [c["check"] for c in rep["checks"]] == want


def test_remesh_restore_fingerprint(tmp_path, monkeypatch):
    """A worker that resumes from a saved state emits one
    ``remesh_restore`` fingerprint at the restored step, equal to the saved
    state's (``remesh_save``), and equal within the stated tolerance to
    the reference's fingerprint of the same parameters."""
    cfg = ExperimentConfig(
        model="llama_tiny", optimizer=OptimizerConfig(**ADAMW),
        train=TrainConfig(batch_size=BATCH, seed=0, dtype="float32"),
        data=DataConfig(seq_len=SEQ),
        numerics=NumericsConfig(enabled=True))
    recs = []
    monkeypatch.setattr(ttrace, "emit_event", recs.append)
    store = LocalStore(str(tmp_path / "ckpt"))
    ElasticTrainer(cfg, store, device="cpu",
                   registry=MetricsRegistry()).run(num_steps=2)
    et = ElasticTrainer(cfg, store, device="cpu", registry=MetricsRegistry())
    state, _ = et.run(num_steps=3)
    fps = [(x["reason"], x["step"], x["fp"]) for x in recs
           if x.get("event") == "numerics_fingerprint"]
    assert [(a, b) for a, b, _ in fps] == [
        ("remesh_restore", 0), ("remesh_save", 2), ("remesh_restore", 2),
        ("remesh_save", 3)]
    assert fps[2][2] == fps[1][2]
    want = {k: {f: float(v) for f, v in d.items()} for k, d in
            jax.device_get(jax.jit(jn.fingerprint)(
                _jax_params(state, cfg))).items()}
    assert jn.diff_fingerprints(fps[3][2], want, rtol=1e-4,
                                atol=2e-3) is None


def _jax_params(state, cfg):
    from serverless_learn_tpu_torch.bridge import to_jax_params

    return to_jax_params(dict(state.model.named_parameters()),
                         build_trainer(cfg, device="cpu").bundle.cfg)
