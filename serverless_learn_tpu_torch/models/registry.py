"""Model registry: each family registers a factory that turns overrides into
a ``TransformerConfig``, keyed by the name the CLI's ``--model`` takes.
Port of ``serverless_learn_tpu/models/registry.py``: :func:`build_model`
makes a registered model with serving weights from a seed, and
:func:`get_model` the training :class:`ModelBundle`. Checkpoint restore
comes later; ``bridge.py`` loads a flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from serverless_learn_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, random_params)

_REGISTRY: Dict[str, Callable[..., TransformerConfig]] = {}


@dataclasses.dataclass
class ModelBundle:
    """What the trainer needs of a model family, as the reference's bundle:
    ``loss_fn(model, batch) -> (loss, {"metrics": {...}})`` (an optional
    ``"loss_weight"`` beside ``"metrics"`` weights grad-accumulation
    microbatches), ``make_batch(rng, data_config, batch_size)`` -> a dict
    of numpy arrays, the task name, ``trainable_mask(names) -> {name:
    bool}`` over the model's state-dict names where only part of the model
    trains (None: all of it), and ``input_names``, the fields of a batch
    (what a streamed dataset is bridged to, ``data/transforms.py``)."""

    cfg: TransformerConfig
    loss_fn: Callable
    make_batch: Callable
    task: str = "lm"
    trainable_mask: Optional[Callable] = None
    input_names: Tuple[str, ...] = ("tokens",)


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model_config(name: str, **overrides) -> TransformerConfig:
    from serverless_learn_tpu_torch.models import llama, moe  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)


def get_model(name: str, **overrides) -> ModelBundle:
    """The training bundle of a registered model; ``fused_ce`` is a bundle
    option, the rest are config overrides."""
    from serverless_learn_tpu_torch.models.llama import lm_bundle

    fused_ce = overrides.pop("fused_ce", False)
    return lm_bundle(get_model_config(name, **overrides), fused_ce=fused_ce)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA is asked for and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on "
                           "the card; device='cpu' is for tests only")
    return dev


def build_model(name: str, *, device="cuda", quant=None, seed: int = 0,
                **overrides) -> Transformer:
    """A registered model with random weights from ``seed``, allocated and
    filled on ``device``. With ``quant="int8"`` the projections are filled
    directly in the int8 layout (``random_quantized_params``)."""
    from serverless_learn_tpu_torch.inference.quantize import (
        random_quantized_params)

    dev = resolve_device(device)
    cfg = get_model_config(name, quant=quant, **overrides)
    model = Transformer(cfg, device=dev).eval()
    if quant is None:
        return random_params(model, seed)
    return random_quantized_params(model, seed)
