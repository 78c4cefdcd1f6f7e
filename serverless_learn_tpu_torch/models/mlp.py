"""The MNIST MLP, the port of ``serverless_learn_tpu/models/mlp.py``:
``dense_0``, ``dense_1`` (ReLU) and ``head``, bf16 products over f32
parameters. The image is flattened in its NHWC order, as the reference
flattens it, so a bridged ``dense_0`` kernel sees the same pixels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from serverless_learn_tpu_torch.models.common import as_dtype
from serverless_learn_tpu_torch.models.layers import (Dense, count_macs,
                                                      init_layers)
from serverless_learn_tpu_torch.models.registry import (ModelBundle, Spec,
                                                        register_model)
from serverless_learn_tpu_torch.ops.losses import softmax_cross_entropy

# The fixed projection behind data.learnable's labels (the reference's
# seed, independent of any stream seed).
LEARNABLE_SEED = 771


class MLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int],
                 num_classes: int, dtype, param_dtype, device=None,
                 trainable: bool = False):
        super().__init__()
        self.dtype = dtype
        dims = [in_features, *features]
        self.hidden = []
        for i in range(len(features)):
            layer = Dense(dims[i], dims[i + 1], dtype, param_dtype, device)
            self.add_module(f"dense_{i}", layer)
            self.hidden.append(layer)
        self.head = Dense(dims[-1], num_classes, dtype, param_dtype, device)
        for p in self.parameters():
            p.requires_grad_(trainable)

    def forward(self, image: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        x = image.reshape(image.shape[0], -1).to(self.dtype)
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.head(x)


@register_model("mlp_mnist")
def make_mlp_mnist(features=(512, 512), num_classes=10, dtype="bfloat16",
                   param_dtype="float32", image_shape=(28, 28, 1)):
    image_shape = tuple(image_shape)
    dt, pdt = as_dtype(dtype), as_dtype(param_dtype)
    cfg = dict(features=tuple(features), num_classes=num_classes,
               image_shape=image_shape)
    n_in = int(np.prod(image_shape))

    def build(device, trainable: bool = False) -> MLP:
        model = MLP(n_in, tuple(features), num_classes, dt, pdt, device,
                    trainable)
        model.cfg = cfg
        return model

    def loss_fn(model, batch, rng=None):
        loss, metrics = softmax_cross_entropy(model(batch["image"]),
                                              batch["label"])
        return loss, {"metrics": metrics}

    def input_spec(data_config, batch_size):
        return {"image": Spec((batch_size, *image_shape),
                              np.dtype(np.float32)),
                "label": Spec((batch_size,), np.dtype(np.int32))}

    proj_cache: list = []

    def make_batch(rng: np.random.Generator, data_config, batch_size):
        """The reference's batch, bit for bit: normal images; labels
        uniform, or with ``data.learnable`` the argmax of the images'
        projection by a fixed matrix (seed 771), the same function for
        every stream, so the task is learnable."""
        image = rng.standard_normal((batch_size, *image_shape),
                                    dtype=np.float32)
        if getattr(data_config, "learnable", False):
            if not proj_cache:
                proj_cache.append(np.random.default_rng(
                    LEARNABLE_SEED).standard_normal(
                        (n_in, num_classes)).astype(np.float32))
            label = np.argmax(image.reshape(batch_size, -1) @ proj_cache[0],
                              axis=-1).astype(np.int32)
        else:
            label = rng.integers(0, num_classes,
                                 (batch_size,)).astype(np.int32)
        return {"image": image, "label": label}

    def macs() -> int:
        return count_macs(build("meta"), torch.empty(
            (1, *image_shape), device="meta"))

    return ModelBundle(cfg=cfg, build=build, loss_fn=loss_fn,
                       make_batch=make_batch, input_spec=input_spec,
                       task="classification", init=init_layers, macs=macs)
