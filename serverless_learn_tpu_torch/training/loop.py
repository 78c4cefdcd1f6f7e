"""The training loop, the port of ``serverless_learn_tpu/training/loop.py``:
a trainer, a synthetic batch source placed on the device ahead of the
step, the throughput meter, the forward-only eval over a held-out
synthetic stream (the ``eval`` command, and in the loop every
``train.eval_every`` steps), and the reference's telemetry of the loop:

* the registry series (``slt_train_*``, ``slt_opt_state_bytes``);
* the goodput ledger's phases: ``compile`` for the first step (it builds
  the kernels), ``step`` for the rest, ``eval`` for in-loop evals. Each
  step's phase closes after its metrics are read back to the host, which
  waits for the card, so goodput never counts queued work;
* a ``train/run`` span around the loop and a ``train/step`` span a step
  (emitted to the event log when tracing has a sink), the host tracer's
  ``train/step`` aggregate and a flight record a step;
* ``slt_train_mfu`` from the analytic step FLOPs at the end.

Each iteration (step, eval, callback) runs inside
``profiler.device_work()``, so a profiler session started from another
thread starts and stops between iterations.

The numerics auditor (``training/audit.py``) waits for ROADMAP.md queue 1
item 3g.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from serverless_learn_tpu_torch.config import ExperimentConfig
from serverless_learn_tpu_torch.data.datasets import SyntheticSource, prefetch
from serverless_learn_tpu_torch.telemetry import flight, goodput, profiler
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.registry import get_registry
from serverless_learn_tpu_torch.training.optimizer import (
    publish_opt_state_gauge)
from serverless_learn_tpu_torch.training.train_step import (Trainer,
                                                            build_trainer)
from serverless_learn_tpu_torch.utils.metrics import (H100_BF16_PEAK,
                                                      ThroughputMeter,
                                                      lm_train_flops, log_json)


def make_source(config: ExperimentConfig, trainer: Trainer,
                seed: Optional[int] = None, start_step: int = 0):
    """The synthetic source of the reference's ``make_source`` on one
    process: seed ``train.seed + 100_003 * start_step`` (a fresh stream per
    resume point), so its batches are the JAX package's, bit for bit."""
    seed = config.train.seed if seed is None else seed
    return SyntheticSource(trainer.bundle.make_batch, config.data,
                           config.train.batch_size,
                           seed=seed + 100_003 * start_step)


def eval_uses_train_data(config: ExperimentConfig) -> bool:
    """True when eval batches would come from the training split (a shard
    server without ``data.eval_dataset``); the port streams no shard
    server yet (``data.shard_server_addr`` raises), so always False here."""
    return bool(config.data.shard_server_addr) and not config.data.eval_dataset


def make_eval_source(config: ExperimentConfig, trainer: Trainer):
    """The held-out source of eval passes: the training source re-seeded
    at ``train.seed + 995_801``, as the reference's, so both packages eval
    on the same batches."""
    return make_source(config, trainer, seed=config.train.seed + 995_801)


def run_eval(config: ExperimentConfig, trainer: Trainer, state,
             source=None, num_batches: Optional[int] = None) -> dict:
    """Forward-only metrics over ``num_batches`` (default
    ``train.eval_steps``) eval batches, each averaged over the batches as
    ``eval_<name>``; ``eval_perplexity`` is the exp of the mean loss, not a
    mean of exps. The state is not touched."""
    num_batches = num_batches or config.train.eval_steps
    eval_on_train = source is None and eval_uses_train_data(config)
    if source is None:
        source = make_eval_source(config, trainer)
    sums: dict = {}
    it = iter(source)
    for _ in range(num_batches):
        metrics = trainer.eval_step(state, trainer.place(next(it)))
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    out = {f"eval_{k}": v / max(num_batches, 1) for k, v in sums.items()}
    if "eval_perplexity" in out:
        out["eval_perplexity"] = float(np.exp(out["eval_loss"]))
    if eval_on_train:
        out["eval_on_train_data"] = 1.0
    return out


def step_flops(config: ExperimentConfig, trainer: Trainer, state) -> float:
    """Model FLOPs of one step; frozen parameters count 4 a token, trained
    ones 6 (``utils/metrics.py``). Every parameter but the embedding
    counts: an int8 base's ``kernel_q`` weights are frozen parameters, and
    their per-column scales count as the norm scales do."""
    cfg = trainer.bundle.cfg
    params = list(state.model.parameters())
    n_trainable = (None if trainer.bundle.trainable_mask is None
                   else sum(p.numel() for p in params if p.requires_grad))
    return lm_train_flops(sum(p.numel() for p in params), cfg.vocab_size,
                          cfg.d_model, cfg.n_layers, config.train.batch_size,
                          config.data.seq_len, n_trainable)


def run_training(config: ExperimentConfig, trainer: Optional[Trainer] = None,
                 state=None, source=None,
                 step_callback: Optional[Callable] = None,
                 verbose: bool = False, device="cuda", registry=None,
                 ledger=None):
    """Run ``config.train.num_steps`` steps from ``state.step``; returns
    (state, meter). ``step_callback(step, state, stats)`` runs after each
    step. Each step's metrics are read back to the host (which waits for
    the card), so step times are honest. ``registry`` and ``ledger``
    default to the process's (``get_registry``, ``goodput.get_ledger``)."""
    trainer = trainer or build_trainer(config, device)
    if state is None:
        state = trainer.init()
    if source is None:
        source = make_source(config, trainer, start_step=state.step)
    batches = prefetch(source, trainer.place, config.data.prefetch)
    meter = ThroughputMeter(
        batch_size=config.train.batch_size,
        flops_per_step=step_flops(config, trainer, state),
        peak_flops=H100_BF16_PEAK if trainer.device.type == "cuda" else None,
        tokens_per_sample=config.data.seq_len)
    reg = registry or get_registry()
    metrics_of = {
        "steps": reg.counter("slt_train_steps_total", "optimizer steps run"),
        "step_t": reg.histogram("slt_train_step_seconds",
                                "wall time per step"),
        "sps": reg.gauge("slt_train_samples_per_sec"),
        "sps_chip": reg.gauge("slt_train_samples_per_sec_per_chip"),
        "loss": reg.gauge("slt_train_loss"),
        # The health engine's staleness watchdog and /healthz read this:
        # a loop wedged inside one step stops advancing it.
        "last_step": reg.gauge("slt_train_last_step_unix_s",
                               "wall time of the latest optimizer step")}
    reg.gauge("slt_train_grad_accum",
              "microbatches per step").set(config.train.grad_accum)
    reg.gauge("slt_train_batch_size").set(config.train.batch_size)
    reg.gauge("slt_train_n_chips").set(1)
    reg.gauge("slt_train_zero_stage").set(config.train.zero_stage)
    publish_opt_state_gauge(trainer.state_tree(state)["opt_state"],
                            registry=reg)
    led = ledger or goodput.get_ledger()
    led.ensure_started()
    tracer = ttrace.get_tracer()
    start_step = state.step
    meter.start()
    with ttrace.span("train/run", steps=config.train.num_steps,
                     model=config.model) as run_span:
        try:
            for i, batch in zip(range(start_step, config.train.num_steps),
                                batches):
                with profiler.device_work():
                    state = _one_step(config, trainer, state, batch, i,
                                      i == start_step, meter, led, tracer,
                                      metrics_of, step_callback, verbose)
        finally:
            run_span.meta["last_step"] = state.step
    summary = meter.steady_state()
    if "mfu" in summary:
        reg.gauge("slt_train_mfu", "model FLOPs utilization").set(
            summary["mfu"])
    if "tflops_per_sec_per_chip" in summary:
        reg.gauge("slt_train_tflops_per_sec_per_chip").set(
            summary["tflops_per_sec_per_chip"])
    return state, meter


def _one_step(config, trainer, state, batch, i: int, first: bool, meter,
              led, tracer, m, step_callback, verbose):
    """Step ``i + 1`` of :func:`run_training`: the step and its readback,
    its telemetry (``m``: the registry series), the in-loop eval when due,
    then the callback. Returns the state."""
    # The first step builds the kernels: "compile", so it poisons neither
    # goodput nor the step-time baseline.
    with ttrace.step_annotation(i + 1), \
            ttrace.span("train/step", step=i + 1), \
            tracer.span("train/step", annotate_device=False), \
            led.phase("compile" if first else "step"):
        state, metrics = trainer.step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
    stats = meter.record(i + 1, metrics)
    flight.record({"event": "train_step", "step": i + 1,
                   "step_time_s": round(stats.step_time_s, 5),
                   **{k: round(v, 5) for k, v in metrics.items()}})
    m["steps"].inc()
    m["step_t"].observe(stats.step_time_s)
    m["last_step"].set(time.time())
    m["sps"].set(stats.samples_per_sec)
    m["sps_chip"].set(stats.samples_per_sec)
    if "loss" in metrics:
        m["loss"].set(metrics["loss"])
    if verbose and (i + 1) % config.train.log_every == 0:
        log_json({"step": stats.step,
                  "step_time_s": round(stats.step_time_s, 5),
                  "samples_per_sec": round(stats.samples_per_sec, 1),
                  **{k: round(v, 5) for k, v in metrics.items()}})
    every = config.train.eval_every
    if every > 0 and (i + 1) % every == 0:
        # A fresh source each pass: every eval scores the same seeded
        # batches, so eval losses compare across the run.
        with led.phase("eval"):
            eval_metrics = run_eval(config, trainer, state)
        if verbose:
            log_json({"step": i + 1, **{k: round(v, 5)
                                        for k, v in eval_metrics.items()}})
        meter.start()  # eval time must not count in the next step's window
    if step_callback is not None:
        step_callback(i + 1, state, stats)
    return state
