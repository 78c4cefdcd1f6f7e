"""Optimizers and learning-rate schedules with optax's semantics, the port of
``serverless_learn_tpu/training/optimizer.py``, written as plain tensor code.

What is kept from optax, step for step:

* ``clip_by_global_norm``: ``g`` unchanged where the global norm is below
  the limit, else ``g / norm * limit`` (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
* ``adam`` / ``adamw``: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu +
  (1 - b2) g^2``, both bias-corrected by ``1 - b^count`` with the count
  incremented first, update ``mu_hat / (sqrt(nu_hat) + 1e-8)``; adamw then
  adds ``weight_decay * param`` (only to params of ndim >= 2 when
  ``decay_exclude_1d``);
* ``sgd`` with momentum: ``trace = g + momentum * trace``, update = trace;
* the update is scaled by ``-lr`` with the schedule evaluated at the
  optimizer's own count, which starts at 0: with warmup the first update
  uses lr 0, as optax's does;
* ``linear_schedule`` and ``warmup_cosine_decay_schedule`` in f32.

adafactor, lion and rmsprop are not ported and raise. Updates are in place:
the reference's optax chain returns new trees.

:meth:`Optimizer.state_tree` describes, as data, the nesting that flax's
``to_state_dict`` gives the optax state of the same chain, so checkpoints
carry the state in the JAX package's layout (``training/checkpoint.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from serverless_learn_tpu_torch.config import OptimizerConfig, not_ported
from serverless_learn_tpu_torch.utils.serialization import (
    Seq, Struct, leaves_with_paths)

Schedule = Union[float, Callable[[int], float]]
EPS = 1e-8  # optax's adam eps (eps_root 0)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule, in f32."""
    init, end = np.float32(init_value), np.float32(end_value)

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return float(init)
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float((init - end) * frac + end)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1), in f32."""
    init = np.float32(init_value)

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        return float(init * ((np.float32(1) - np.float32(alpha)) * cos
                             + np.float32(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup to the peak, then a
    cosine decay over ``decay_steps - warmup_steps`` (optax's
    ``join_schedules`` at the warmup boundary)."""
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    alpha = end_value / peak_value if peak_value else 0.0
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    if cfg.warmup_steps <= 0 and cfg.decay_steps <= 0:
        return cfg.learning_rate
    if cfg.decay_steps > 0:
        return warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, max(cfg.warmup_steps, 1),
            max(cfg.decay_steps, cfg.warmup_steps + 1))
    return linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)


def lr_at(schedule: Schedule, count: int) -> float:
    return schedule(count) if callable(schedule) else float(schedule)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32 (a 0-dim tensor
    on their device; no host sync)."""
    total = sum(t.float().flatten().dot(t.float().flatten()) for t in tensors)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


class Optimizer:
    """The reference's ``make_optimizer`` chain: optional global-norm clip,
    then the core optimizer, then ``-lr``. :meth:`init` makes the state,
    :meth:`update` applies one step to ``params`` in place."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.name in ("adafactor", "lion", "rmsprop"):
            raise not_ported(f"optimizer {cfg.name!r}")
        if cfg.name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        if cfg.weight_decay > 0 and cfg.name != "adamw":
            raise ValueError(
                f"weight_decay={cfg.weight_decay} is ignored by optimizer "
                f"{cfg.name!r}; use 'adamw' or 'lion', or set weight_decay=0")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params: List[torch.Tensor]) -> Dict:
        # In the parameter's dtype, as optax's (mu_dtype None).
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.cfg.name == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, norm: Optional[torch.Tensor] = None) -> None:
        """One step. ``grads`` are clipped in place; ``norm`` is their
        global norm if the caller has it."""
        cfg = self.cfg
        if cfg.grad_clip_norm > 0:
            norm = global_norm(grads) if norm is None else norm
            keep = norm < cfg.grad_clip_norm
            div = torch.where(keep, torch.ones_like(norm), norm)
            mul = torch.where(keep, torch.ones_like(norm),
                              torch.full_like(norm, cfg.grad_clip_norm))
            for g in grads:
                g.div_(div).mul_(mul)
        lr = lr_at(self.schedule, state["count"])
        state["count"] += 1
        if cfg.name == "sgd":
            for p, g, t in zip(params, grads, state["trace"]):
                t.mul_(cfg.momentum).add_(g)
                p.add_(t, alpha=-lr)
            return
        n = state["count"]
        bc1, bc2 = 1.0 - cfg.b1 ** n, 1.0 - cfg.b2 ** n
        decay = cfg.weight_decay if cfg.name == "adamw" else 0.0
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            nu.mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(EPS))
            if decay and (p.ndim >= 2 or not cfg.decay_exclude_1d):
                u.add_(p, alpha=decay)
            p.add_(u, alpha=-lr)


    def state_tree(self, state: Dict,
                   nest: Callable[[List[torch.Tensor]], dict]) -> Seq:
        """``state`` in the form ``to_state_dict`` gives the reference's
        optax state of this chain (read off ``to_state_dict(trainer.init()
        .opt_state)`` for each chain): an optax chain is a tuple,
        ``clip_by_global_norm``'s state and a constant learning rate's are
        ``EmptyState`` ({}), adam's is ``ScaleByAdamState(count, mu, nu)``,
        sgd's momentum ``TraceState(trace)``, a schedule's
        ``ScaleByScheduleState(count)``, and adamw's decay under the 1-D
        mask ``MaskedState(inner_state=EmptyState)``:

            clip?  ({}, core)  else  (core,)
            adamw  (adam, {} | {inner_state: {}}, sched)
            adam   (adam, sched)
            sgd    ({trace}, sched)

        ``nest`` maps a list of per-parameter tensors to their flax tree.
        The counts are fresh 0-d int32 tensors (:meth:`load_count` reads
        them back); the moments are the state's own tensors."""
        cfg = self.cfg
        count = lambda: torch.tensor(state["count"], dtype=torch.int32)  # noqa: E731
        sched = Struct(count=count()) if callable(self.schedule) else {}
        if cfg.name == "sgd":
            core = Seq(Struct(trace=nest(state["trace"])), sched)
        else:
            adam = Struct(count=count(), mu=nest(state["mu"]),
                          nu=nest(state["nu"]))
            if cfg.name == "adamw":
                masked = cfg.weight_decay > 0 and cfg.decay_exclude_1d
                core = Seq(adam, Struct(inner_state={}) if masked else {},
                           sched)
            else:
                core = Seq(adam, sched)
        return Seq({}, core) if cfg.grad_clip_norm > 0 else Seq(core)

    @staticmethod
    def load_count(state: Dict, tree: Seq) -> None:
        """Set ``state["count"]`` from the counts of a restored
        :meth:`state_tree`; they must agree (one count steps them all)."""
        counts = {int(v) for p, v in leaves_with_paths(tree)
                  if p.endswith(".count")}
        if len(counts) > 1:
            raise ValueError(f"optimizer counts disagree: {sorted(counts)}")
        if counts:
            state["count"] = counts.pop()


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)
