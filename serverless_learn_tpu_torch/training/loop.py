"""The training loop, the port of ``serverless_learn_tpu/training/loop.py``:
a trainer, a batch source placed on the device ahead of the step (a
dataset streamed from the shard server when ``data.shard_server_addr`` is
set, else synthetic batches), the throughput meter, the forward-only eval
over a held-out stream (the ``eval`` command, and in the loop every
``train.eval_every`` steps), and the reference's telemetry of the loop:

* the registry series (``slt_train_*``, ``slt_opt_state_bytes``);
* the goodput ledger's phases: ``compile`` for the first step (it builds
  the kernels), ``step`` for the rest, ``eval`` for in-loop evals,
  ``data_wait`` for the time the loop waits on its source. Each
  step's phase closes after its metrics are read back to the host, which
  waits for the card, so goodput never counts queued work;
* a ``train/run`` span around the loop and a ``train/step`` span a step
  (emitted to the event log when tracing has a sink), the host tracer's
  ``train/step`` aggregate and a flight record a step;
* ``slt_train_mfu`` from the analytic step FLOPs at the end;
* with ``numerics.enabled`` (or an ``auditor``), the numerics auditor
  (``training/audit.py``): the step's ``metrics["numerics"]`` stays on the
  card, out of the per-step readback, and the auditor fetches it at its
  cadence in its own ``numerics`` phase.

Each iteration (step, eval, callback) runs inside
``profiler.device_work()``, so a profiler session started from another
thread starts and stops between iterations.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from serverless_learn_tpu_torch.config import ExperimentConfig
from serverless_learn_tpu_torch.data.datasets import SyntheticSource, prefetch
from serverless_learn_tpu_torch.data.shard_client import ShardStreamSource
from serverless_learn_tpu_torch.data.transforms import (TransformedSource,
                                                        auto_transform)
from serverless_learn_tpu_torch.telemetry import flight, goodput, profiler
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.registry import get_registry
from serverless_learn_tpu_torch.training.optimizer import (
    publish_opt_state_gauge)
from serverless_learn_tpu_torch.training.train_step import (Trainer,
                                                            build_trainer)
from serverless_learn_tpu_torch.utils.metrics import (H100_BF16_PEAK,
                                                      ThroughputMeter,
                                                      conv_train_flops,
                                                      lm_train_flops, log_json)


def make_source(config: ExperimentConfig, trainer: Trainer,
                dataset: Optional[str] = None, seed: Optional[int] = None,
                dp_rank: int = 0, dp_size: int = 1, start_step: int = 0,
                train: bool = True):
    """The batch source of a config, as the reference's ``make_source`` on
    one process. With ``data.shard_server_addr`` it streams ``dataset``
    (default ``data.dataset``) from the shard server, the shards of stripe
    ``dp_rank`` of ``dp_size`` (the elastic trainer passes its rank in the
    live membership), bridged to the model's inputs
    (``data/transforms.py``: images converted, and with ``data.augment``
    cropped and flipped when ``train``; token rows masked at
    ``data.mask_rate`` for MLM); else synthetic batches from the bundle's
    ``make_batch``. ``start_step`` is folded into the seed (``seed +
    100_003 * start_step``): a source rebuilt at a resume does not replay
    the batches the restored model trained on. Both packages' sources give
    the same batches for the same arguments."""
    seed = config.train.seed if seed is None else seed
    seed = seed + 100_003 * start_step
    bundle = trainer.bundle
    if config.data.shard_server_addr:
        source = ShardStreamSource(
            config.data.shard_server_addr, dataset or config.data.dataset,
            config.train.batch_size, seed=seed, dp_rank=dp_rank,
            dp_size=dp_size)
        try:
            fn = auto_transform(
                source.meta.fields,
                bundle.input_spec(config.data, config.train.batch_size),
                task=bundle.task, train=train, seed=seed + dp_rank,
                augment=config.data.augment, mask_rate=config.data.mask_rate,
                vocab_size=getattr(bundle.cfg, "vocab_size", None))
        except Exception:
            source.close()
            raise
        return TransformedSource(source, fn) if fn is not None else source
    return SyntheticSource(bundle.make_batch, config.data,
                           config.train.batch_size, seed=seed + dp_rank)


def eval_uses_train_data(config: ExperimentConfig) -> bool:
    """True when eval batches come from the training split: a shard server
    without ``data.eval_dataset``."""
    return bool(config.data.shard_server_addr) and not config.data.eval_dataset


def make_eval_source(config: ExperimentConfig, trainer: Trainer):
    """The held-out source of eval passes: ``data.eval_dataset`` from the
    shard server when published, else the training source re-seeded at
    ``train.seed + 995_801``, as the reference's, so both packages eval on
    the same batches. Eval sources convert images but never augment."""
    return make_source(config, trainer,
                       dataset=config.data.eval_dataset or None,
                       seed=config.train.seed + 995_801, train=False)


def run_eval(config: ExperimentConfig, trainer: Trainer, state,
             source=None, num_batches: Optional[int] = None) -> dict:
    """Forward-only metrics over ``num_batches`` (default
    ``train.eval_steps``) eval batches, each averaged over the batches as
    ``eval_<name>``; ``eval_perplexity`` is the exp of the mean loss, not a
    mean of exps. The state is not touched."""
    num_batches = num_batches or config.train.eval_steps
    created = source is None
    eval_on_train = created and eval_uses_train_data(config)
    if created:
        source = make_eval_source(config, trainer)
    sums: dict = {}
    try:
        it = iter(source)
        for _ in range(num_batches):
            metrics = trainer.eval_step(state, trainer.place(next(it)))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
    finally:
        if created and hasattr(source, "close"):
            source.close()
    out = {f"eval_{k}": v / max(num_batches, 1) for k, v in sums.items()}
    if "eval_perplexity" in out:
        out["eval_perplexity"] = float(np.exp(out["eval_loss"]))
    if eval_on_train:
        out["eval_on_train_data"] = 1.0
    return out


def step_flops(config: ExperimentConfig, trainer: Trainer, state) -> float:
    """Model FLOPs of one step (``utils/metrics.py``). A transformer's:
    frozen parameters count 4 a token, trained ones 6, every parameter but
    the embedding tables (an int8 base's ``kernel_q`` weights are frozen
    parameters, and their per-column scales count as the norm scales do),
    and attention by its mask. An image model's: 3 x 2 x the multiply-adds
    of its convolutions and dense layers a sample."""
    bundle = trainer.bundle
    if bundle.macs is not None:
        return conv_train_flops(bundle.macs(), config.train.batch_size)
    cfg = bundle.cfg
    params = list(state.model.parameters())
    n_trainable = (None if bundle.trainable_mask is None
                   else sum(p.numel() for p in params if p.requires_grad))
    positions = 0 if cfg.use_rope else cfg.max_seq_len * cfg.d_model
    return lm_train_flops(sum(p.numel() for p in params) - positions,
                          cfg.vocab_size, cfg.d_model, cfg.n_layers,
                          config.train.batch_size, config.data.seq_len,
                          n_trainable, causal=cfg.causal)


def run_training(config: ExperimentConfig, trainer: Optional[Trainer] = None,
                 state=None, source=None,
                 step_callback: Optional[Callable] = None,
                 verbose: bool = False, device="cuda", registry=None,
                 ledger=None, auditor=None):
    """Run ``config.train.num_steps`` steps from ``state.step``; returns
    (state, meter). ``step_callback(step, state, stats)`` runs after each
    step. Each step's metrics are read back to the host (which waits for
    the card), so step times are honest. ``registry`` and ``ledger``
    default to the process's (``get_registry``, ``goodput.get_ledger``).
    ``auditor`` (built here when ``numerics.enabled``) sees each step's
    numerics. A source this call makes is closed at the end; a source's
    error (a lost shard server) raises out of the loop."""
    trainer = trainer or build_trainer(config, device)
    led = ledger or goodput.get_ledger()
    own_auditor = auditor is None and config.numerics.enabled
    if own_auditor:
        from serverless_learn_tpu_torch.training.audit import NumericsAuditor

        auditor = NumericsAuditor(config, registry=registry,
                                  bundle=trainer.bundle, ledger=led)
    if state is None:
        state = trainer.init()
    created_source = source is None
    if created_source:
        source = make_source(config, trainer, start_step=state.step)
    led.ensure_started()
    batches = prefetch(source, trainer.place, config.data.prefetch,
                       ledger=led)
    meter = ThroughputMeter(
        batch_size=config.train.batch_size,
        flops_per_step=step_flops(config, trainer, state),
        peak_flops=H100_BF16_PEAK if trainer.device.type == "cuda" else None,
        tokens_per_sample=(config.data.seq_len
                           if trainer.bundle.task in ("lm", "mlm") else 0))
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
                                      metrics_of, step_callback, verbose,
                                      auditor)
        finally:
            run_span.meta["last_step"] = state.step
            batches.close()
            if own_auditor:
                auditor.close()
            if created_source and hasattr(source, "close"):
                source.close()
    summary = meter.steady_state()
    if "mfu" in summary:
        reg.gauge("slt_train_mfu", "model FLOPs utilization").set(
            summary["mfu"])
    if "tflops_per_sec_per_chip" in summary:
        reg.gauge("slt_train_tflops_per_sec_per_chip").set(
            summary["tflops_per_sec_per_chip"])
    return state, meter


def _one_step(config, trainer, state, batch, i: int, first: bool, meter,
              led, tracer, m, step_callback, verbose, auditor=None):
    """Step ``i + 1`` of :func:`run_training`: the step and its readback,
    the auditor, its telemetry (``m``: the registry series), the in-loop
    eval when due, then the callback. Returns the state."""
    # The first step builds the kernels: "compile", so it poisons neither
    # goodput nor the step-time baseline.
    with ttrace.step_annotation(i + 1), \
            ttrace.span("train/step", step=i + 1), \
            tracer.span("train/step", annotate_device=False), \
            led.phase("compile" if first else "step"):
        state, metrics = trainer.step(state, batch)
        # The numerics stay on the card: the auditor fetches them at its
        # cadence, in its own phase, never in the per-step readback.
        num_tree = metrics.pop("numerics", None)
        metrics = {k: float(v) for k, v in metrics.items()}
    if auditor is not None:
        auditor.on_step(i + 1, num_tree, metrics, state=state, batch=batch,
                        final=i + 1 == config.train.num_steps)
    del num_tree
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
