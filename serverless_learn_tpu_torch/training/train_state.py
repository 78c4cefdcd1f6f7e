"""Training state, the port of ``serverless_learn_tpu/training/
train_state.py``.

The reference threads an immutable pytree through a jitted step that
donates it, so the old state's buffers are reused for the new one. Here
the step updates this object in place (the model's parameters and the
optimizer's moments) and returns it: one copy of the state lives on the
card, which is what donation buys the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from torch import nn


@dataclass
class TrainState:
    step: int  # optimizer steps taken
    model: nn.Module  # parameters live here
    opt_state: Dict[str, Any]  # the optimizer's count and moments
