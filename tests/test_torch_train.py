"""The port's training slice as a whole against the JAX package: llama_tiny
with flash attention in f32, the reference's initial params carried across
with ``bridge.from_jax_params``, the same ``SyntheticSource`` batches, three
adamw steps with warmup, cosine decay, weight decay and clipping; then the
``train`` command line on the CPU.

The reference's flash kernels run in interpret mode (T = 128 is one Pallas
block); the port's run their plain versions on the CPU.
"""

import json
import socket
import subprocess
import sys
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
from serverless_learn_tpu.data.datasets import SyntheticSource as JSource
from serverless_learn_tpu.parallel.mesh import make_mesh
from serverless_learn_tpu.training.train_step import (
    build_trainer as jax_build_trainer)
from serverless_learn_tpu_torch.bridge import from_jax_params
from serverless_learn_tpu_torch.config import (_FIELDS_NOT_PORTED,
                                               DataConfig, ExperimentConfig,
                                               OptimizerConfig, TrainConfig)
from serverless_learn_tpu_torch.data.datasets import SyntheticSource, prefetch
from serverless_learn_tpu_torch.ops import flash_attention as fa
from serverless_learn_tpu_torch.training.loop import run_training
from serverless_learn_tpu_torch.training.train_step import build_trainer

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 3, 2, 128
OVERRIDES = {"attention_impl": "flash"}
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.1,
           warmup_steps=1, decay_steps=4, grad_clip_norm=1.0)
# f32 on both sides; XLA and ATen sum in other orders, so losses and grad
# norms agree to f32 round-off grown through 2 layers and a 512-way
# softmax. Adam divides each update by sqrt(nu), so every weight moves by
# up to lr (1e-3) a step whatever the size of its gradient, and round-off
# in a small gradient shows at that scale: atol 5e-6 is half a percent of
# one update.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-6)


def _configs(accum):
    jcfg = JExperimentConfig(
        model="llama_tiny", model_overrides=dict(OVERRIDES),
        mesh=JMeshConfig(dp=1), optimizer=JOptimizerConfig(**OPT),
        train=JTrainConfig(batch_size=BATCH, num_steps=STEPS, seed=0,
                           dtype="float32", grad_accum=accum),
        data=JDataConfig(seq_len=SEQ))
    tcfg = ExperimentConfig(
        model="llama_tiny", model_overrides=dict(OVERRIDES),
        optimizer=OptimizerConfig(**OPT),
        train=TrainConfig(batch_size=BATCH, num_steps=STEPS, seed=0,
                          dtype="float32", grad_accum=accum),
        data=DataConfig(seq_len=SEQ))
    return jcfg, tcfg


def _run_both(accum):
    jcfg, tcfg = _configs(accum)
    # One of the 8 virtual CPU devices (tests/conftest.py): no sharding.
    jtr = jax_build_trainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                                 devices=jax.devices()[:1]))
    jstate = jtr.init()
    params = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                    jstate.params))
    jbatches = JSource(jtr.bundle.make_batch, jcfg.data, BATCH, seed=7)
    jit = iter(jbatches)
    jmetrics = []
    for _ in range(STEPS):
        jstate, m = jtr.step(jstate, jtr.shard_batch(next(jit)))
        jmetrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    jparams = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))

    ttr = build_trainer(tcfg, device="cpu")
    tstate = ttr.init(params=params)
    source = SyntheticSource(ttr.bundle.make_batch, tcfg.data, BATCH, seed=7)
    before = fa.flash_fwd.launches  # the CPU path counts no launches
    check = iter(JSource(jtr.bundle.make_batch, jcfg.data, BATCH, seed=7))
    tmetrics = []
    for host in iter(source):
        np.testing.assert_array_equal(host["tokens"], next(check)["tokens"])
        tstate, m = ttr.step(tstate, ttr.place(host))
        tmetrics.append({k: float(v) for k, v in m.items()})
        if len(tmetrics) == STEPS:
            break
    assert fa.flash_fwd.launches == before
    return jmetrics, tmetrics, jparams, tstate.model.state_dict(), tstate


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_jax(accum):
    jm, tm, jparams, tparams, state = _run_both(accum)
    assert state.step == STEPS
    for j, t in zip(jm, tm):
        for key in ("loss", "perplexity", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], **LOSS_TOL,
                                       err_msg=key)
    assert tm[0]["lr"] == 0.0  # warmup: optax's first update uses lr 0
    assert tm[0]["grad_norm"] > OPT["grad_clip_norm"]  # clipping is live
    assert sorted(jparams) == sorted(tparams)
    for name, ref in jparams.items():
        np.testing.assert_allclose(tparams[name].numpy(), ref.numpy(),
                                   **PARAM_TOL, err_msg=name)


def test_remat_and_eval_step():
    """remat recomputes each block in the backward and changes no gradient;
    eval_step reports the loss of the current weights without a step."""
    _, tcfg = _configs(1)
    batch = next(iter(SyntheticSource(
        build_trainer(tcfg, device="cpu").bundle.make_batch, tcfg.data,
        BATCH, seed=3)))
    grads, evals = [], []
    for remat in (False, True):
        cfg = ExperimentConfig(
            model="llama_tiny", model_overrides=dict(OVERRIDES, remat=remat),
            optimizer=OptimizerConfig(**OPT), train=tcfg.train,
            data=tcfg.data)
        tr = build_trainer(cfg, device="cpu")
        state = tr.init(seed=0)
        placed = tr.place(batch)
        evals.append(float(tr.eval_step(state, placed)["loss"]))
        loss, _ = tr.bundle.loss_fn(state.model, placed)
        loss.backward()
        grads.append({k: p.grad for k, p in
                      state.model.named_parameters()})
        state, m = tr.step(state, placed)
        assert float(m["loss"]) == pytest.approx(evals[-1], rel=1e-6)
    assert evals[0] == evals[1]
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=0)


def test_run_training_and_its_meter():
    """run_training drives the same steps from the config's own source and
    the meter counts tokens and analytic FLOPs."""
    _, tcfg = _configs(1)
    state, meter = run_training(tcfg, device="cpu")
    assert state.step == STEPS and len(meter.history) == STEPS
    assert all(np.isfinite(s.metrics["loss"]) for s in meter.history)
    summary = meter.steady_state(skip=1)
    assert summary["tokens_per_sec"] == pytest.approx(
        summary["samples_per_sec"] * SEQ)
    assert "mfu" not in summary  # no card, no peak to hold it against


def test_unported_options_raise():
    _, tcfg = _configs(1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExperimentConfig.from_dict({"model": "llama_tiny",
                                    "train": {"zero_stage": 1}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExperimentConfig.from_dict({"mesh": {"dp": 2}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExperimentConfig.from_dict({"local_sgd": {"outer": "average"}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_trainer(tcfg)  # the card is the default device


# A value away from the default for every field the port keeps but does not
# run.
UNPORTED_VALUES = {
    ("train", "zero_stage"): 1, ("train", "donate_state"): False,
    ("membership", "mode"): "gossip", ("elastic", "remesh_wire_dtype"): "int8",
}


def test_every_unported_field_has_a_case():
    assert set(UNPORTED_VALUES) == set(_FIELDS_NOT_PORTED)


@pytest.mark.parametrize("field", sorted(UNPORTED_VALUES),
                         ids=lambda f: ".".join(f))
def test_unported_field_raises_off_its_default(field):
    section, name = field
    raw = {"model": "llama_tiny", section: {name: UNPORTED_VALUES[field]}}
    with pytest.raises(NotImplementedError,
                       match=rf"{section}\.{name}=.*ROADMAP"):
        ExperimentConfig.from_dict(raw)
    default = getattr(ExperimentConfig(), section)
    raw[section][name] = getattr(default, name)
    ExperimentConfig.from_dict(raw)  # its default loads


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_places_batches_ahead_in_order(depth):
    placed = []

    def place(b):
        placed.append(b)
        return -b

    got = []
    for b in prefetch(range(5), place, depth):
        # the batch handed out and the `depth` after it are placed
        assert len(placed) == min(len(got) + 1 + depth, 5)
        got.append(b)
    assert got == [0, -1, -2, -3, -4] and placed == list(range(5))


def test_train_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "serverless_learn_tpu_torch", "train",
         "--model", "llama_tiny", "--batch-size", "2", "--seq-len", "64",
         "--steps", "3", "--device", "cpu", "--set",
         "model_overrides.attention_impl=flash", "--set",
         "optimizer.grad_clip_norm=1.0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    done = json.loads(out.stdout.strip().splitlines()[-1])
    assert done["event"] == "done" and done["final_step"] == 3
    assert len(done["losses"]) == 3
    # The CPU runs the plain versions: no kernel launches.
    assert done["kernel_launches"] == {"flash_fwd": 0, "flash_dq": 0,
                                       "flash_dkv": 0, "cross_entropy_fwd": 0,
                                       "cross_entropy_bwd": 0}
    assert all(np.isfinite(x) for x in done["losses"])
    # A checkpoint store that cannot be reached fails the run: it never
    # trains on without checkpoints.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = "127.0.0.1:%d" % s.getsockname()[1]
    bad = subprocess.run(
        [sys.executable, "-m", "serverless_learn_tpu_torch", "train",
         "--model", "llama_tiny", "--steps", "1", "--device", "cpu",
         "--checkpoint-store", closed],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and f"cannot connect to {closed}" in bad.stderr


# -- the loop's telemetry ---------------------------------------------------

EVAL_STEPS = 4  # steps of the telemetry runs; in-loop eval every 2


def _series(snap):
    """{family: (type, sorted label sets)} of a registry snapshot."""
    return {name: (fam["type"], sorted(json.dumps(s["labels"],
                                                  sort_keys=True)
                                       for s in fam["series"]))
            for name, fam in snap.items()}


def _eval_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and "eval_loss" in line]


def test_run_training_telemetry_matches_jax(monkeypatch, capsys):
    """run_training with train.eval_every=2 publishes the JAX loop's
    registry series with its label sets; the step counter and the
    configuration gauges equal it, the loss gauge and the in-loop eval
    metrics agree to LOSS_TOL (the two runs' losses, above), and the last
    in-loop eval equals run_eval on the final state exactly."""
    from serverless_learn_tpu.telemetry import goodput as jgoodput
    from serverless_learn_tpu.telemetry import registry as jregistry
    from serverless_learn_tpu.training.loop import (
        run_training as jax_run_training)
    from serverless_learn_tpu_torch.telemetry.goodput import PhaseLedger
    from serverless_learn_tpu_torch.telemetry.registry import MetricsRegistry
    from serverless_learn_tpu_torch.training.loop import run_eval

    jcfg, tcfg = _configs(1)
    import dataclasses
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, num_steps=EVAL_STEPS, eval_every=2, eval_steps=2))
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, num_steps=EVAL_STEPS, eval_every=2, eval_steps=2))
    jreg = jregistry.MetricsRegistry()
    monkeypatch.setattr(jregistry, "_default_registry", jreg)
    prev = jgoodput.set_ledger(jgoodput.PhaseLedger(emit=False))
    try:
        jtr = jax_build_trainer(jcfg, mesh=make_mesh(
            jcfg.mesh, devices=jax.devices()[:1]))
        jstate = jtr.init()
        params = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))
        jax_run_training(jcfg, trainer=jtr, state=jstate, verbose=True)
        jled = jgoodput.get_ledger().report()
    finally:
        jgoodput.set_ledger(prev)
    j_evals = _eval_lines(capsys.readouterr().err)

    treg, tled = MetricsRegistry(), PhaseLedger(emit=False)
    ttr = build_trainer(tcfg, device="cpu")
    state, meter = run_training(tcfg, trainer=ttr,
                                state=ttr.init(params=params), verbose=True,
                                device="cpu", registry=treg, ledger=tled)
    t_evals = _eval_lines(capsys.readouterr().err)

    js, ts = jreg.snapshot(), treg.snapshot()
    assert _series(ts) == _series(js)
    value = lambda snap, name: snap[name]["series"][0]["value"]  # noqa: E731
    assert value(ts, "slt_train_steps_total") == EVAL_STEPS
    for name in ("slt_train_steps_total", "slt_train_grad_accum",
                 "slt_train_batch_size", "slt_train_n_chips",
                 "slt_train_zero_stage", "slt_opt_state_bytes"):
        assert value(ts, name) == value(js, name), name
    assert ts["slt_train_step_seconds"]["series"][0]["count"] == EVAL_STEPS
    np.testing.assert_allclose(value(ts, "slt_train_loss"),
                               value(js, "slt_train_loss"), **LOSS_TOL)
    assert len(t_evals) == len(j_evals) == EVAL_STEPS // 2
    for t, j in zip(t_evals, j_evals):
        assert t["step"] == j["step"]
        for key in ("eval_loss", "eval_perplexity"):
            np.testing.assert_allclose(t[key], j[key], **LOSS_TOL,
                                       err_msg=key)
    final = run_eval(tcfg, ttr, state)
    for key, v in final.items():
        assert round(v, 5) == t_evals[-1][key], key
    tphases, jphases = tled.report()["phases"], jled["phases"]
    for name in ("compile", "step", "eval"):
        assert tphases[name]["count"] == jphases[name]["count"], name
    assert tphases["eval"]["count"] == EVAL_STEPS // 2


def _train_cli(capsys, tmp_path, *sets):
    from serverless_learn_tpu_torch import cli

    argv = ["train", "--model", "llama_tiny", "--batch-size", "2",
            "--seq-len", "64", "--steps", "3", "--device", "cpu",
            "--set", "model_overrides.n_layers=1",
            "--set", "train.dtype=float32", "--set", "train.eval_steps=1",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--checkpoint-every", "100"]
    for s in sets:
        argv += ["--set", s]
    assert cli.main(argv) == 0
    cap = capsys.readouterr()
    done = json.loads(cap.out.strip().splitlines()[-1])
    shadows = [json.loads(line) for line in cap.err.splitlines()
               if '"ckpt_shadow"' in line]
    return done, shadows


@pytest.mark.parametrize("field", [
    "train.eval_every", "checkpoint.emergency_save",
    "checkpoint.emergency_min_interval_s"])
def test_telemetry_fields_take_effect(field, capsys, tmp_path):
    """The three fields that raised before the telemetry was ported now
    change what ``train`` does: in-loop evals, the emergency shadow, and
    its refresh interval."""
    from serverless_learn_tpu_torch.telemetry import goodput

    if field == "train.eval_every":
        prev = goodput.set_ledger(goodput.PhaseLedger(emit=False))
        try:
            done, _ = _train_cli(capsys, tmp_path, "train.eval_every=1")
            evals = goodput.get_ledger().report()["phases"]["eval"]
        finally:
            goodput.set_ledger(prev)
        assert evals["count"] == 3 and done["final_step"] == 3
        assert "eval" in done["badput_breakdown"]
    elif field == "checkpoint.emergency_save":
        _, on = _train_cli(capsys, tmp_path)  # armed by default
        _, off = _train_cli(capsys, tmp_path / "off",
                            "checkpoint.emergency_save=false")
        assert [s["step"] for s in on] == [1] and off == []
    else:
        _, every = _train_cli(capsys, tmp_path,
                              "checkpoint.emergency_min_interval_s=0")
        _, once = _train_cli(capsys, tmp_path / "b",
                             "checkpoint.emergency_min_interval_s=1e9")
        assert [s["step"] for s in every] == [1, 2, 3]
        assert [s["step"] for s in once] == [1]
        assert all(s["seconds"] >= 0 for s in every)
    section, name = field.split(".")
    if name != "emergency_save":  # a negative count or interval is refused
        with pytest.raises(ValueError, match=name):
            ExperimentConfig.from_dict({"model": "llama_tiny",
                                        section: {name: -1}})
