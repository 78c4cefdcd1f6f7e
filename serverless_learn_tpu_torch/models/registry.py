"""Model registry, the port of ``serverless_learn_tpu/models/registry.py``:
each family registers a factory that turns overrides into a
:class:`ModelBundle`, keyed by the name the CLI's ``--model`` takes
(:func:`list_models` lists them, the same names as the reference's).
:func:`get_model` gives the training bundle; :func:`build_model` makes a
registered transformer with serving weights from a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from serverless_learn_tpu_torch import bridge
from serverless_learn_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, init_params, random_params)

_REGISTRY: Dict[str, Callable[..., "ModelBundle"]] = {}


class Spec(NamedTuple):
    """One input field of a batch: its shape and numpy dtype (the
    reference's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


@dataclasses.dataclass
class ModelBundle:
    """What the trainer needs of a model family, as the reference's bundle:

    * ``cfg``: the family's config (``TransformerConfig`` for the
      transformers, which serving builds from);
    * ``build(device, trainable=False)``: the family's ``nn.Module``, its
      tensors allocated on ``device`` and not filled; ``init(model, seed)``
      fills them;
    * ``loss_fn(model, batch, rng=None) -> (loss, {"metrics": {...}})``,
      with an optional ``"loss_weight"`` beside ``"metrics"`` that weights
      grad-accumulation microbatches; ``rng`` is the step's seed (the
      reference's step PRNG), which only a device-side augmentation reads.
      A forward in training mode moves the model's running statistics (the
      reference's ``model_state``, the module's buffers);
    * ``eval_loss_fn``: the inference-mode loss (BatchNorm's running
      statistics), None where ``loss_fn`` is already state-free;
    * ``make_batch(rng, data_config, batch_size)``: a dict of numpy arrays;
    * ``task``: "classification", "mlm" or "lm";
    * ``input_spec(data_config, batch_size)``: {field: :class:`Spec`},
      what a streamed dataset is bridged to (``data/transforms.py``); its
      keys name the batch's fields;
    * ``trainable_mask(names) -> {name: bool}`` over the model's state-dict
      names where only part of the model trains (None: all of it);
    * ``macs``: multiply-adds a sample of one forward, for the analytic
      FLOPs of the image families (``utils/metrics.py``); None for the
      transformers, which count by their config.

    :meth:`flax_shape` names each tensor's shape in the reference's tree
    (the optimizer state's shapes, which adafactor factors by)."""

    cfg: Any
    build: Callable[..., torch.nn.Module]
    loss_fn: Callable
    make_batch: Callable
    input_spec: Callable
    task: str = "lm"
    init: Callable = init_params
    eval_loss_fn: Optional[Callable] = None
    trainable_mask: Optional[Callable] = None
    macs: Optional[Callable[[], int]] = None

    def flax_shape(self, name: str, shape) -> Tuple[int, ...]:
        return bridge.flax_shape(name, shape, self.cfg)


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _load_families():
    from serverless_learn_tpu_torch.models import (  # noqa: F401
        bert, llama, mlp, moe, resnet)


def get_model(name: str, **overrides) -> ModelBundle:
    """The training bundle of a registered model; the causal LMs take the
    bundle option ``fused_ce``, the rest are config overrides."""
    _load_families()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)


def list_models():
    _load_families()
    return sorted(_REGISTRY)


def get_model_config(name: str, **overrides) -> TransformerConfig:
    """The ``TransformerConfig`` of a registered transformer (the serving
    paths build from it)."""
    cfg = get_model(name, **overrides).cfg
    if not isinstance(cfg, TransformerConfig):
        raise ValueError(f"{name} is not a transformer")
    return cfg


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


def transformer_build(cfg: TransformerConfig) -> Callable:
    """``ModelBundle.build`` of a transformer family."""
    def build(device, trainable: bool = False) -> Transformer:
        return Transformer(cfg, device=device, trainable=trainable)

    return build
