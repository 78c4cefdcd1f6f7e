"""The training loop, the port of ``serverless_learn_tpu/training/loop.py``:
a trainer, a synthetic batch source placed on the device ahead of the
step, the throughput meter, and the forward-only eval of the ``eval``
command over a held-out synthetic stream. The reference's metrics registry, goodput
ledger, flight recorder and tracing spans wait for the telemetry item of
ROADMAP.md.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from serverless_learn_tpu_torch.config import ExperimentConfig
from serverless_learn_tpu_torch.data.datasets import SyntheticSource, prefetch
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
                 verbose: bool = False, device="cuda"):
    """Run ``config.train.num_steps`` steps from ``state.step``; returns
    (state, meter). ``step_callback(step, state, stats)`` runs after each
    step. Each step's metrics are read back to the host (which waits for
    the card), so step times are honest."""
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
    meter.start()
    for i, batch in zip(range(state.step, config.train.num_steps), batches):
        state, metrics = trainer.step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        stats = meter.record(i + 1, metrics)
        if verbose and (i + 1) % config.train.log_every == 0:
            log_json({"step": stats.step,
                      "step_time_s": round(stats.step_time_s, 5),
                      "samples_per_sec": round(stats.samples_per_sec, 1),
                      **{k: round(v, 5) for k, v in metrics.items()}})
        if step_callback is not None:
            step_callback(i + 1, state, stats)
    return state, meter
