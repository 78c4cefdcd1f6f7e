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
* ``adafactor``, ``lion`` and ``rmsprop`` as optax builds them with the
  reference's arguments (each method's docstring gives the rule);
* the update is scaled by ``-lr`` with the schedule evaluated at the
  optimizer's own count, which starts at 0: with warmup the first update
  uses lr 0, as optax's does;
* ``linear_schedule`` and ``warmup_cosine_decay_schedule`` in f32.

Updates are in place: the reference's optax chain returns new trees. A
``stats`` object given to :meth:`Optimizer.update` (the train step's
``telemetry.numerics.StepNumerics``) sees each parameter's update, the
signed, lr-scaled tensor optax would return, as ``stats.update(i, u,
scale)`` where the optimizer forms it (``scale * u``; no copy is kept).

:meth:`Optimizer.state_tree` describes, as data, the nesting that flax's
``to_state_dict`` gives the optax state of the same chain, so checkpoints
carry the state in the JAX package's layout (``training/checkpoint.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from serverless_learn_tpu_torch.config import OptimizerConfig
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


# optax.adafactor's defaults, which the reference's make_optimizer keeps.
ADAFACTOR_MIN_DIM = 128   # min_dim_size_to_factor
ADAFACTOR_DECAY = 0.8     # decay_rate: second-moment decay 1 - t^-0.8
ADAFACTOR_EPS = 1e-30     # added to g^2
ADAFACTOR_CLIP = 1.0      # clip_by_block_rms threshold
ADAFACTOR_MIN_SCALE = 1e-3  # scale_by_param_block_rms floor
# optax.rmsprop's defaults.
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) axes of a
    shape whose second largest dim is >= ADAFACTOR_MIN_DIM, else None (the
    moment is kept whole)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


def _safe_rms(x: torch.Tensor, floor: float) -> torch.Tensor:
    """optax's ``safe_root_mean_squares``: max(rms(x), floor)."""
    rms = _rms(x)
    return torch.where(rms <= floor, torch.full_like(rms, floor), rms)


@functools.lru_cache(maxsize=4096)
def _consts(dtype: torch.dtype, *values: float) -> Tuple[float, ...]:
    """``values`` rounded to ``dtype``: optax multiplies a tensor by a
    Python scalar (``b1``, ``1 - b1``, eps, ``-lr`` ...) in the tensor's
    dtype, so under bf16 parameters it multiplies by bf16(0.9) =
    0.8984375; PyTorch would use the f32 value. With these and one rounding
    after each product and sum, as optax's, the port's bf16 updates and
    moments equal optax's bit for bit."""
    return tuple(torch.tensor(values, dtype=dtype).tolist())


def _add_scaled(t: torch.Tensor, c: float, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t += c * x`` (``c * x * y`` with ``y``) in place. A low-precision
    ``t`` takes optax's roundings, the product in its dtype and then the
    sum, which the bf16 updates need to equal optax's bit for bit; an f32
    ``t`` takes PyTorch's fused form, one pass over the tensors where the
    product would take another (the sum is then at most an f32 rounding
    from optax's)."""
    if t.dtype == torch.float32:
        return (t.add_(x, alpha=c) if y is None
                else t.addcmul_(x, y, value=c))
    return t.add_(x * c if y is None else (x * y).mul_(c))


class _NoStats:
    def update(self, i, u, scale):
        pass


_NO_STATS = _NoStats()


class Optimizer:
    """The reference's ``make_optimizer`` chain: optional global-norm clip,
    then the core optimizer, then ``-lr``. :meth:`init` makes the state,
    :meth:`update` applies one step to ``params`` in place. The
    reference's ``multi_transform`` freeze is the trainer's partition here
    (frozen parameters never reach the optimizer, ``training/
    partition.py``), as the JAX package's trainer prunes them too."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.name not in ("adamw", "adam", "sgd", "adafactor", "lion",
                            "rmsprop"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        if cfg.weight_decay > 0 and cfg.name not in ("adamw", "lion"):
            raise ValueError(
                f"weight_decay={cfg.weight_decay} is ignored by optimizer "
                f"{cfg.name!r}; use 'adamw' or 'lion', or set weight_decay=0")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params: List[torch.Tensor],
             shapes: Optional[List[Tuple[int, ...]]] = None) -> Dict:
        """A zero state for ``params``. ``shapes``: each parameter's shape
        in the reference's tree (``bridge.flax_shape``), which adafactor
        factors by; the parameters' own shapes by default."""
        # In the parameter's dtype, as optax's (mu_dtype None).
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        name = self.cfg.name
        if name == "sgd":
            return ({"count": 0} if self.cfg.momentum is None
                    else {"count": 0, "trace": zeros()})
        if name == "lion":
            return {"count": 0, "mu": zeros()}
        if name == "rmsprop":
            state = {"count": 0, "nu": zeros()}
            if self.cfg.momentum is not None:
                state["trace"] = zeros()
            return state
        if name == "adafactor":
            shapes = [tuple(p.shape) if shapes is None else tuple(shapes[i])
                      for i, p in enumerate(params)]
            state = {"count": 0, "shapes": shapes, "v_row": [], "v_col": [],
                     "v": []}
            for p, shape in zip(params, shapes):
                one = lambda: p.new_zeros(1)  # noqa: E731
                dims = factored_dims(shape)
                if dims is None:
                    row, col, full = one(), one(), p.new_zeros(shape)
                else:
                    d1, d0 = dims
                    row = p.new_zeros(tuple(np.delete(shape, d0)))
                    col = p.new_zeros(tuple(np.delete(shape, d1)))
                    full = one()
                state["v_row"].append(row)
                state["v_col"].append(col)
                state["v"].append(full)
            return state
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, norm: Optional[torch.Tensor] = None,
               stats=None) -> None:
        """One step. ``grads`` are clipped in place; ``norm`` is their
        global norm if the caller has it; ``stats`` sees the updates (the
        module docstring)."""
        stats = stats or _NO_STATS
        cfg = self.cfg
        if cfg.grad_clip_norm > 0:
            if any(g.dtype != torch.float32 for g in grads):
                # optax's norm of low-precision leaves: each leaf's sum of
                # squares in its dtype, added and rooted in it
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
            elif norm is None:
                norm = global_norm(grads)
            keep = norm < cfg.grad_clip_norm
            # t / norm * limit in t's dtype where clipping, else t / 1 * 1
            factors = {}
            for g in grads:
                if g.dtype not in factors:
                    one = torch.ones((), dtype=g.dtype, device=g.device)
                    (limit,) = _consts(g.dtype, cfg.grad_clip_norm)
                    factors[g.dtype] = (
                        torch.where(keep, one, norm.to(g.dtype)),
                        torch.where(keep, one, torch.full_like(one, limit)))
                div, mul = factors[g.dtype]
                g.div_(div).mul_(mul)
        lr = lr_at(self.schedule, state["count"])
        count = state["count"]
        state["count"] += 1
        if cfg.name == "sgd":
            for i, (p, g) in enumerate(zip(params, grads)):
                (nlr,) = _consts(p.dtype, -lr)
                if "trace" in state:
                    g = state["trace"][i].mul_(_consts(
                        p.dtype, cfg.momentum)[0]).add_(g)
                stats.update(i, g, nlr)
                _add_scaled(p, nlr, g)
            return
        if cfg.name == "adafactor":
            self._adafactor(params, grads, state, count, lr, stats)
            return
        if cfg.name == "lion":
            self._lion(params, grads, state, lr, stats)
            return
        if cfg.name == "rmsprop":
            self._rmsprop(params, grads, state, lr, stats)
            return
        # optax's bias corrections, 1 - b^count, in f32
        n = np.float32(state["count"])
        bc1 = np.float32(1) - np.float32(cfg.b1) ** n
        bc2 = np.float32(1) - np.float32(cfg.b2) ** n
        decay = cfg.weight_decay if cfg.name == "adamw" else 0.0
        for i, (p, g, mu, nu) in enumerate(zip(params, grads, state["mu"],
                                               state["nu"])):
            b1, c1, b2, c2, r1, r2, eps, wd, nlr = _consts(
                p.dtype, cfg.b1, 1.0 - cfg.b1, cfg.b2, 1.0 - cfg.b2,
                float(bc1), float(bc2), EPS, decay, -lr)
            _add_scaled(mu.mul_(b1), c1, g)
            _add_scaled(nu.mul_(b2), c2, g, g)
            u = (mu / r1).div_((nu / r2).sqrt_().add_(eps))
            if decay and self._decays(p):
                _add_scaled(u, wd, p)
            stats.update(i, u, nlr)
            _add_scaled(p, nlr, u)

    def _decays(self, p: torch.Tensor) -> bool:
        """Whether decoupled weight decay reaches ``p``: every parameter, or
        under ``decay_exclude_1d`` those of ndim >= 2 (the reference's
        mask)."""
        return p.ndim >= 2 or not self.cfg.decay_exclude_1d

    def _adafactor(self, params, grads, state, count: int, lr: float,
                   stats):
        """optax.adafactor at its defaults: ``scale_by_factored_rms``
        (decay rate ``1 - (count + 1)^-0.8`` in f32, epsilon 1e-30 added to
        g^2, a parameter's second moment factored into row and column means
        over its two largest dims where the smaller of them is >= 128, the
        reference's shape), ``clip_by_block_rms(1)``, the learning rate,
        ``scale_by_param_block_rms`` (times max(rms(p), 1e-3)), then -1."""
        t = np.float32(count + 1)
        rate = np.float32(1) - t ** np.float32(-ADAFACTOR_DECAY)
        keep, new = float(rate), float(np.float32(1) - rate)
        for i, (p, g) in enumerate(zip(params, grads)):
            eps, lr_, floor = _consts(p.dtype, ADAFACTOR_EPS, lr,
                                      ADAFACTOR_MIN_SCALE)
            shape = state["shapes"][i]
            gv, pv = g.view(shape), p.view(shape)
            sq = gv * gv + eps
            dims = factored_dims(shape)
            if dims is None:
                v = state["v"][i]
                v.copy_(v.float().mul(keep).add_(sq.float().mul(new)))
                u = gv * v.pow(-0.5)
            else:
                d1, d0 = dims
                row, col = state["v_row"][i], state["v_col"][i]
                row.copy_(row.float().mul(keep).add_(
                    sq.mean(dim=d0).float().mul(new)))
                col.copy_(col.float().mul(keep).add_(
                    sq.mean(dim=d1).float().mul(new)))
                rd1 = d1 - 1 if d1 > d0 else d1
                row_factor = (row / row.mean(dim=rd1, keepdim=True)).pow(-0.5)
                u = (gv * row_factor.unsqueeze(d0)
                     * col.pow(-0.5).unsqueeze(d1))
            u = u / torch.clamp(_rms(u) / ADAFACTOR_CLIP, min=1.0)
            u = u * lr_
            u = u * _safe_rms(pv, floor)
            stats.update(i, u, -1.0)
            p.sub_(u.view(p.shape))

    def _lion(self, params, grads, state, lr: float, stats):
        """optax.lion: ``sign((1 - b1) g + b1 mu)``, then ``mu = (1 - b2) g
        + b2 mu``; decayed weights added (under the 1-D mask), then -lr."""
        cfg = self.cfg
        for i, (p, g, mu) in enumerate(zip(params, grads, state["mu"])):
            c1, b1, c2, b2, wd, nlr = _consts(
                p.dtype, 1.0 - cfg.b1, cfg.b1, 1.0 - cfg.b2, cfg.b2,
                cfg.weight_decay, -lr)
            u = torch.sign(g * c1 + mu * b1)
            _add_scaled(mu.mul_(b2), c2, g)
            if self._decays(p):
                _add_scaled(u, wd, p)
            stats.update(i, u, nlr)
            _add_scaled(p, nlr, u)

    def _rmsprop(self, params, grads, state, lr: float, stats):
        """optax.rmsprop at its defaults (decay 0.9, eps 1e-8 inside the
        root, no centering, no bias correction): ``nu = 0.1 g^2 + 0.9 nu``,
        ``u = g / sqrt(nu + eps)``, -lr, then with ``momentum`` optax's
        ``trace`` of the scaled updates (``t = u + momentum t``)."""
        cfg = self.cfg
        traces = state.get("trace", [None] * len(params))
        for i, (p, g, nu, t) in enumerate(zip(params, grads, state["nu"],
                                              traces)):
            c, d, eps, nlr, m = _consts(
                p.dtype, 1.0 - RMSPROP_DECAY, RMSPROP_DECAY, RMSPROP_EPS,
                -lr, cfg.momentum or 0.0)
            _add_scaled(nu.mul_(d), c, g, g)
            u = torch.rsqrt(nu + eps).mul_(g).mul_(nlr)
            if t is not None:
                u = t.mul_(m).add_(u)
            stats.update(i, u, 1.0)
            p.add_(u)

    def state_tree(self, state: Dict, nest: Callable[..., dict]) -> Seq:
        """``state`` in the form ``to_state_dict`` gives the reference's
        optax state of this chain (read off ``to_state_dict(trainer.init()
        .opt_state)`` for each chain): an optax chain is a tuple,
        ``clip_by_global_norm``'s state and a constant learning rate's are
        ``EmptyState`` ({}), adam's is ``ScaleByAdamState(count, mu, nu)``,
        sgd's momentum ``TraceState(trace)``, a schedule's
        ``ScaleByScheduleState(count)``, decay under the 1-D mask
        ``MaskedState(inner_state=EmptyState)``, adafactor's
        ``FactoredState(count, v_row, v_col, v)``, lion's
        ``ScaleByLionState(count, mu)``, rmsprop's ``ScaleByRmsState(nu)``:

            clip?     ({}, core)  else  (core,)
            adamw     (adam, {} | {inner_state: {}}, sched)
            adam      (adam, sched)
            sgd       ({trace} | {}, sched)
            adafactor (factored, {}, sched, {}, {})
            lion      (lion, {} | {inner_state: {}}, sched)
            rmsprop   ({nu}, sched, {trace} | {})

        ``nest(tensors)`` maps a list of per-parameter tensors in the
        parameters' shapes to their flax tree; ``nest(tensors,
        as_params=False)`` one in shapes of their own (adafactor's
        factored moments, already in the reference's). The counts are
        fresh 0-d int32 tensors (:meth:`load_count` reads them back); the
        moments are the state's own tensors."""
        cfg = self.cfg
        count = lambda: torch.tensor(state["count"], dtype=torch.int32)  # noqa: E731
        sched = Struct(count=count()) if callable(self.schedule) else {}
        masked = cfg.weight_decay > 0 and cfg.decay_exclude_1d
        decay = Struct(inner_state={}) if masked else {}
        if cfg.name == "sgd":
            core = Seq(Struct(trace=nest(state["trace"]))
                       if "trace" in state else {}, sched)
        elif cfg.name == "adafactor":
            factored = Struct(
                count=count(),
                **{k: nest(state[k], as_params=False)
                   for k in ("v_row", "v_col", "v")})
            core = Seq(factored, {}, sched, {}, {})
        elif cfg.name == "lion":
            core = Seq(Struct(count=count(), mu=nest(state["mu"])), decay,
                       sched)
        elif cfg.name == "rmsprop":
            core = Seq(Struct(nu=nest(state["nu"])), sched,
                       Struct(trace=nest(state["trace"]))
                       if "trace" in state else {})
        else:
            adam = Struct(count=count(), mu=nest(state["mu"]),
                          nu=nest(state["nu"]))
            if cfg.name == "adamw":
                core = Seq(adam, decay, sched)
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


def publish_opt_state_gauge(opt_tree, registry=None) -> float:
    """Set ``slt_opt_state_bytes``, the resident optimizer-state bytes of
    the card, from the state in the reference's optax layout
    (``state_tree``: moments and counts); returns the value. The port of
    ``serverless_learn_tpu/training/zero.py:publish_opt_state_gauge`` on
    one card."""
    from serverless_learn_tpu_torch.telemetry.registry import get_registry

    val = float(sum(t.numel() * t.element_size()
                    for _, t in leaves_with_paths(opt_tree)))
    (registry or get_registry()).gauge(
        "slt_opt_state_bytes",
        "resident optimizer-state bytes per chip "
        "(shrinks ~1/dp under train.zero_stage >= 1)").set(val)
    return val
