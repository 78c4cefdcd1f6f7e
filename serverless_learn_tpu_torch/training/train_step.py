"""The train step, the port of ``serverless_learn_tpu/training/
train_step.py`` for one device: forward, backward through the flash
kernels, gradient accumulation over microbatches, and the optimizer update
with optax's semantics (``training/optimizer.py``).

The reference compiles the step with ``jax.jit`` over a mesh and donates
the state; here the step runs eagerly on one card and updates the
:class:`TrainState` in place. With the bundle's ``trainable_mask`` (LoRA)
only the trainable parameters have ``requires_grad``
(``training/partition.py``): the frozen base gets no weight-gradient
products, and the optimizer state, the global norm and the clipping cover
the trainable parameters alone; the state keeps the whole model. Over an
int8 base (QLoRA) the base's projections pass the gradient to their
inputs and keep none; with ``param_dtype=bfloat16`` the adapters and their
optimizer moments are bf16, as optax keeps moments in the parameter's
dtype (``mu_dtype=None``). Metrics are those of the reference:
``loss``, ``perplexity`` (exp of the averaged loss), ``lr`` (the schedule
at the state's step) and ``grad_norm`` (the global norm of the averaged
gradients, before clipping), returned as 0-dim tensors on the device so
the step itself never waits for the card.

With ``numerics.enabled`` the step also returns ``metrics["numerics"]``,
the reference's in-step statistics (``telemetry.numerics.StepNumerics``:
the gradients before the clipping, each update where the optimizer forms
it, the updated parameters, all read on the card), and
``numerics.inject_nan_step`` poisons the named subtree's gradients with NaN
at that step, after the backward and before the global norm and the
clipping, where the reference's step does (``training/audit.inject_nan``).
Neither changes what the step computes otherwise.

The model comes from the bundle (``ModelBundle.build``), so the step runs
every family: a model with running statistics (ResNet's BatchNorm) moves
them in each training forward, one microbatch after another under gradient
accumulation, as the reference threads ``model_state`` through its scan;
:meth:`Trainer.eval_step` runs the bundle's ``eval_loss_fn`` (the running
statistics) where it has one. The loss gets the step's seed as ``rng``
(``train.seed``, the step and the microbatch), which only a device-side
augmentation reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from serverless_learn_tpu_torch.config import ExperimentConfig
from serverless_learn_tpu_torch.data.datasets import to_device
from serverless_learn_tpu_torch.models.registry import (ModelBundle, get_model,
                                                        resolve_device)
from serverless_learn_tpu_torch.telemetry.numerics import StepNumerics
from serverless_learn_tpu_torch.training.audit import inject_nan
from serverless_learn_tpu_torch.training.optimizer import (
    Optimizer, global_norm, lr_at, make_optimizer)
from serverless_learn_tpu_torch.training.partition import set_trainable
from serverless_learn_tpu_torch.training.train_state import (TrainState,
                                                             load_tree,
                                                             state_tree)


def trainable_params(model: torch.nn.Module) -> List[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


@dataclass
class Trainer:
    """One (model, config, device) triple: :meth:`init`, :meth:`step` and
    :meth:`eval_step`, as the reference's ``Trainer``."""

    config: ExperimentConfig
    bundle: ModelBundle
    device: torch.device
    optimizer: Optimizer

    def init(self, seed: Optional[int] = None,
             params: Optional[Dict[str, torch.Tensor]] = None,
             fill: Optional[Callable[..., Any]] = None) -> TrainState:
        """A fresh state: weights from ``seed`` (the bundle's ``init``),
        from the state dict ``params`` (for example a flax tree through
        ``bridge.from_jax_params``, or ``bridge.from_jax_variables`` with
        its ``batch_stats``; running statistics it leaves out keep the
        values they are built with, mean 0 and variance 1), or written
        into the trainer's own model by ``fill(model, seed)`` (for example
        ``inference.quantize.random_quantized_params``: one int8 base on
        the card, never a second state beside it); and a zero optimizer
        state over the trainable parameters."""
        model = self.bundle.build(self.device, trainable=True)
        seed = self.config.train.seed if seed is None else seed
        if params is not None:
            with torch.no_grad():
                missing, unexpected = model.load_state_dict(params,
                                                            strict=False)
            buffers = {n for n, _ in model.named_buffers()}
            if unexpected or set(missing) - buffers:
                raise RuntimeError(f"params do not fit {self.config.model}: "
                               f"missing {sorted(set(missing) - buffers)}, "
                               f"unexpected {sorted(unexpected)}")
        else:
            (fill or self.bundle.init)(model, seed)
        if self.bundle.trainable_mask is not None:
            set_trainable(model, self.bundle.trainable_mask(
                name for name, _ in model.named_parameters()))
        return TrainState(step=0, model=model,
                          opt_state=self.init_opt_state(model))

    def init_opt_state(self, model: torch.nn.Module) -> Dict[str, Any]:
        """A zero state of this trainer's optimizer over ``model``'s
        trainable parameters, each with its shape in the reference's tree
        (which adafactor factors by)."""
        trained = [(n, p) for n, p in model.named_parameters()
                   if p.requires_grad]
        return self.optimizer.init(
            [p for _, p in trained],
            shapes=[self.bundle.flax_shape(n, p.shape) for n, p in trained])

    def place(self, host_batch: Dict[str, np.ndarray]
              ) -> Dict[str, torch.Tensor]:
        """A host batch onto this trainer's device."""
        return to_device(host_batch, self.device)

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One optimizer step over ``batch``; returns (state, metrics)."""
        model, accum = state.model, self.config.train.grad_accum
        params = trainable_params(model)
        for p in params:
            p.grad = None
        if accum == 1:
            loss, aux = self.bundle.loss_fn(model, batch,
                                            rng=self._rng(state.step, 0))
            loss.backward()
            loss, metrics = loss.detach(), {k: v.detach() for k, v in
                                            aux["metrics"].items()}
        else:
            loss, metrics = self._accumulate(model, params, batch, accum,
                                             state.step)
        grads = [p.grad for p in params]
        ncfg = self.config.numerics
        if ncfg.inject_nan_step:
            inject_nan(self._named_grads(model), state.step + 1,
                       ncfg.inject_nan_step, ncfg.inject_nan_subtree,
                       ncfg.depth)
        norm = global_norm(grads)
        lr = lr_at(self.optimizer.schedule, state.step)
        stats = self._step_numerics(model) if ncfg.enabled else None
        if stats is not None:
            stats.grads(grads)
        self.optimizer.update(params, grads, state.opt_state, norm=norm,
                              stats=stats)
        for p in params:
            p.grad = None
        if "perplexity" in metrics:
            # exp of the averaged loss, not an average of exps.
            metrics["perplexity"] = torch.exp(loss)
        metrics.update(loss=loss, lr=torch.tensor(lr), grad_norm=norm)
        if stats is not None:
            metrics["numerics"] = stats.summary(loss, norm, params)
        state.step += 1
        return state, metrics

    @staticmethod
    def _named_grads(model) -> Dict[str, torch.Tensor]:
        return {n: p.grad for n, p in model.named_parameters()
                if p.requires_grad}

    def _step_numerics(self, model) -> StepNumerics:
        """The step's numerics over ``model``'s trainable parameters, kept
        while the trained set stays the same."""
        named = [(n, p.numel()) for n, p in model.named_parameters()
                 if p.requires_grad]
        cached = getattr(self, "_numerics", None)
        if cached is None or cached[0] != named:
            ncfg = self.config.numerics
            cached = (named, StepNumerics(
                [n for n, _ in named], [k for _, k in named],
                depth=max(1, ncfg.depth), chunks=ncfg.chunks,
                with_fingerprint=ncfg.fingerprint))
            self._numerics = cached
        return cached[1]

    def _rng(self, step: int, micro: int) -> int:
        """The seed a loss gets at ``step``'s microbatch ``micro`` (the
        reference folds the step and the microbatch into its PRNG)."""
        return ((self.config.train.seed & 0xFFFFFFFF) << 31
                | (step & 0xFFFFFF) << 7 | micro & 0x7F)

    def _accumulate(self, model, params, batch, accum: int, step: int):
        """Backward over ``accum`` microbatches (consecutive row blocks),
        each gradient weighted by its ``loss_weight`` (1 when the loss does
        not report one), then divided by the summed weight: the
        whole-batch gradient for any normalisation. Running statistics
        move once a microbatch, in order."""
        b = next(iter(batch.values())).shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {accum}")
        w_sum, loss_sum, m_sum = 0.0, 0.0, {}
        for m in range(accum):
            rows = slice(m * b // accum, (m + 1) * b // accum)
            loss, aux = self.bundle.loss_fn(
                model, {k: v[rows] for k, v in batch.items()},
                rng=self._rng(step, m))
            w = aux.get("loss_weight", 1.0)
            (loss * w).backward()
            w_sum = w_sum + w
            loss_sum = loss_sum + loss.detach() * w
            for k, v in aux["metrics"].items():
                m_sum[k] = m_sum.get(k, 0.0) + v.detach() * w
        with torch.no_grad():
            for p in params:
                p.grad.div_(w_sum)
        return loss_sum / w_sum, {k: v / w_sum for k, v in m_sum.items()}

    def state_tree(self, state: TrainState):
        """``state`` in the reference's ``to_state_dict`` form, over its
        live tensors (``train_state.state_tree``): what a checkpoint saves
        and a restore writes into."""
        return state_tree(state, self.optimizer, self.bundle.cfg)

    def load_tree(self, state: TrainState, tree) -> TrainState:
        """Take the step and the optimizer count of a restored
        :meth:`state_tree` (its tensors were written in place)."""
        return load_tree(state, tree, self.optimizer)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, Any]:
        """Forward-only metrics on one batch through the bundle's
        inference-mode loss (running statistics); the state is not
        touched."""
        loss, aux = (self.bundle.eval_loss_fn or self.bundle.loss_fn)(
            state.model, batch)
        return dict(aux["metrics"], loss=loss)


def build_trainer(config: ExperimentConfig, device="cuda") -> Trainer:
    """The trainer for ``config`` on ``device`` (the card by default; cpu
    for tests only). ``train.dtype`` / ``train.param_dtype`` /
    ``train.remat`` reach the model unless ``model_overrides`` sets them."""
    dev = resolve_device(device)
    overrides = dict(config.model_overrides)
    overrides.setdefault("dtype", config.train.dtype)
    overrides.setdefault("param_dtype", config.train.param_dtype)
    if config.train.remat:
        overrides.setdefault("remat", True)
    bundle = get_model(config.model, **overrides)
    return Trainer(config=config, bundle=bundle, device=dev,
                   optimizer=make_optimizer(config.optimizer))
