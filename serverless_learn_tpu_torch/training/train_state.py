"""Training state, the port of ``serverless_learn_tpu/training/
train_state.py``.

The reference threads an immutable pytree through a jitted step that
donates it, so the old state's buffers are reused for the new one. Here
the step updates this object in place (the model's parameters and the
optimizer's moments) and returns it: one copy of the state lives on the
card, which is what donation buys the reference.

:func:`state_tree` gives the state in the form flax's ``to_state_dict``
gives the reference's ``TrainState`` (``{"step", "params", "opt_state",
"model_state"}``), over the live tensors: a checkpoint writes it, and a
restore copies into it leaf by leaf, in place (``training/checkpoint.py``).
The reference's ``model_state`` (BatchNorm's running statistics, flax's
``batch_stats``) is the model's buffers, which its training forward moves
in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from serverless_learn_tpu_torch.bridge import nest as nest_names
from serverless_learn_tpu_torch.bridge import to_flax
from serverless_learn_tpu_torch.utils.serialization import Struct


@dataclass
class TrainState:
    step: int  # optimizer steps taken
    model: nn.Module  # parameters and running statistics live here
    opt_state: Dict[str, Any]  # the optimizer's count and moments


def state_tree(state: TrainState, optimizer, cfg) -> Struct:
    """``to_state_dict`` of the reference's ``TrainState`` for this state:
    ``step`` a 0-d int32 tensor, ``params`` the flax tree of the model's
    parameters and ``opt_state`` the optax layout of ``optimizer``'s state
    (``Optimizer.state_tree``), both views of the live tensors in flax's
    shapes (``bridge.to_flax``), and ``model_state`` ``{"batch_stats":
    ...}`` over the model's buffers, {} for a model without any.
    ``params`` holds every parameter, an int8 base's ``kernel_q`` and
    ``scale`` among them (QLoRA), as the reference's tree does. ``cfg`` is
    the model's config (``bridge.to_flax`` reads a transformer's)."""
    named = dict(state.model.named_parameters())
    trainable = [n for n, p in named.items() if p.requires_grad]
    buffers = dict(state.model.named_buffers())

    def nest(tensors, as_params=True):
        by_name = dict(zip(trainable, tensors))
        return to_flax(by_name, cfg) if as_params else nest_names(by_name)

    return Struct(step=torch.tensor(state.step, dtype=torch.int32),
                  params=to_flax({n: p.detach() for n, p in named.items()},
                                 cfg),
                  opt_state=optimizer.state_tree(state.opt_state, nest),
                  model_state=({"batch_stats": to_flax(buffers, cfg)}
                               if buffers else {}))


def load_tree(state: TrainState, tree: Struct, optimizer) -> TrainState:
    """After a restore wrote into :func:`state_tree`'s tensors, take its
    step and optimizer count (which a constant-rate sgd does not keep: its
    count is the step)."""
    state.step = int(tree["step"])
    state.opt_state["count"] = state.step
    optimizer.load_count(state.opt_state, tree["opt_state"])
    return state
