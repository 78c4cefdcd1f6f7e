"""The ResNet family, the port of ``serverless_learn_tpu/models/resnet.py``:
``resnet18_cifar`` (basic blocks, the CIFAR 3x3/1 stem) and
``resnet50_imagenet`` (bottleneck blocks; the 2x2 space-to-depth 4x4/1
stem on even image sizes, else the 7x7/2 stem; then a 3x3/2 SAME
max-pool), with ``norm`` batch, group or none (``models/layers.py``). The
last norm of each residual branch starts with a zero scale, so every block
starts as the identity.

Convolutions run on cuDNN through ``torch.nn.functional.conv2d`` in bf16
over channels-last activations; the reference computes them in XLA, outside
any Pallas kernel. Module names are the flax tree's (``conv_init``,
``norm_init``, ``ResNetBlock_0.Conv_0``, ``BatchNorm_1``, ``conv_proj``,
``norm_proj``, ``head``), so ``bridge.py`` maps the two one to one; the
BatchNorm buffers are the tree's ``batch_stats``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from serverless_learn_tpu_torch.models.common import as_dtype
from serverless_learn_tpu_torch.models.layers import (NORMS, Conv, Dense,
                                                      count_macs, init_layers,
                                                      max_pool_same)
from serverless_learn_tpu_torch.models.registry import (ModelBundle, Spec,
                                                        register_model)
from serverless_learn_tpu_torch.ops.losses import softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...]
    bottleneck: bool
    num_classes: int = 10
    num_filters: int = 64
    image_shape: Tuple[int, int, int] = (32, 32, 3)  # what the stem sees
    small_images: bool = True  # the CIFAR stem; else the ImageNet stems
    space_to_depth: bool = True
    norm: str = "batch"  # batch | group | none
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.norm not in NORMS:
            raise ValueError(f"unknown norm {self.norm!r} "
                             "(batch | group | none)")
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))

    @property
    def stem(self) -> str:
        """"cifar" (3x3/1), "s2d" (space-to-depth, 4x4/1) or "classic"
        (7x7/2): the reference picks s2d only for even image sizes."""
        if self.small_images:
            return "cifar"
        h, w = self.image_shape[:2]
        return "s2d" if self.space_to_depth and h % 2 == 0 and w % 2 == 0 \
            else "classic"


class _Block(nn.Module):
    """A residual block of ``convs`` [(kernel, out channels, stride)]: each
    conv then its norm (ReLU between), the last norm's scale zero; a 1x1
    ``conv_proj`` + ``norm_proj`` on the residual when its shape changes."""

    def __init__(self, cfg: ResNetConfig, in_ch: int, convs, device):
        super().__init__()
        norm_cls = NORMS[cfg.norm]
        self.pairs = []
        ch = in_ch
        for i, (k, out, s) in enumerate(convs):
            conv = Conv(ch, out, k, s, cfg.dtype, cfg.param_dtype, device)
            norm = norm_cls(out, cfg.dtype, cfg.param_dtype,
                            zero_scale=i == len(convs) - 1, device=device)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"{norm_cls.__name__}_{i}", norm)
            self.pairs.append((conv, norm))
            ch = out
        stride = max(s for _, _, s in convs)
        self.proj = ch != in_ch or stride != 1
        if self.proj:
            self.conv_proj = Conv(in_ch, ch, 1, stride, cfg.dtype,
                                  cfg.param_dtype, device)
            self.norm_proj = norm_cls(ch, cfg.dtype, cfg.param_dtype,
                                      device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        for i, (conv, norm) in enumerate(self.pairs):
            y = norm(conv(y), train)
            if i < len(self.pairs) - 1:
                y = torch.relu(y)
        residual = (self.norm_proj(self.conv_proj(x), train) if self.proj
                    else x)
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """image [B, H, W, C] (the stem's size, ``cfg.image_shape``) ->
    logits [B, classes] in ``cfg.dtype``. ``train=False`` normalises by
    BatchNorm's running statistics and leaves them as they are."""

    def __init__(self, cfg: ResNetConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        nf, c = cfg.num_filters, cfg.image_shape[2]
        k, s, in_ch = {"cifar": (3, 1, c), "s2d": (4, 1, 4 * c),
                       "classic": (7, 2, c)}[cfg.stem]
        self.conv_init = Conv(in_ch, nf, k, s, cfg.dtype, cfg.param_dtype,
                              device)
        self.norm_init = NORMS[cfg.norm](nf, cfg.dtype, cfg.param_dtype,
                                         device=device)
        kind = "BottleneckBlock" if cfg.bottleneck else "ResNetBlock"
        self.blocks = []
        ch = nf
        for i, count in enumerate(cfg.stage_sizes):
            f = nf * 2 ** i
            for j in range(count):
                st = 2 if i > 0 and j == 0 else 1
                convs = ([(1, f, 1), (3, f, st), (1, 4 * f, 1)]
                         if cfg.bottleneck else [(3, f, st), (3, f, 1)])
                block = _Block(cfg, ch, convs, device)
                self.add_module(f"{kind}_{len(self.blocks)}", block)
                self.blocks.append(block)
                ch = convs[-1][1]
        self.head = Dense(ch, cfg.num_classes, cfg.dtype, cfg.param_dtype,
                          device)
        for p in self.parameters():
            p.requires_grad_(trainable)

    def forward(self, image: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        cfg = self.cfg
        x = image.to(cfg.dtype)
        if cfg.stem == "s2d":
            # (dy, dx, c) channel order, the reference's
            # transpose(0, 1, 3, 2, 4, 5).
            B, H, W, C = x.shape
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        # NHWC -> the logical NCHW, channels-last in memory (no copy).
        x = self.conv_init(x.permute(0, 3, 1, 2))
        x = torch.relu(self.norm_init(x, train))
        if not cfg.small_images:
            x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x, train)
        x = x.float().mean(dim=(2, 3)).to(cfg.dtype)
        return self.head(x)


def device_crop_flip(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     flip: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Per-sample crop of ``oh`` x ``ow`` at (ys[b], xs[b]) and a
    horizontal flip where ``flip[b]``, on the device in one gather: x
    [B, H, W, C] -> [B, oh, ow, C] (the reference's vmapped
    ``dynamic_slice`` and select)."""
    B = x.shape[0]
    dev = x.device
    rows = ys.to(dev).long()[:, None] + torch.arange(oh, device=dev)
    ar = torch.arange(ow, device=dev)
    cols = xs.to(dev).long()[:, None] + torch.where(
        flip.to(dev)[:, None], ow - 1 - ar, ar)
    b = torch.arange(B, device=dev)[:, None, None]
    return x[b, rows[:, :, None], cols[:, None, :]]


def _bundle(cfg: ResNetConfig, input_dtype: str = "float32",
            stored_shape: Optional[Tuple[int, int, int]] = None
            ) -> ModelBundle:
    """``input_dtype="uint8"``: images arrive as uint8 and are normalised
    (x / 255 in f32) on the device. ``stored_shape`` (larger than
    ``cfg.image_shape``): batches carry stored-size records, a training
    step crops and flips them on the device from its ``rng``
    (:func:`device_crop_flip`), and eval takes the center crop."""
    in_dtype = np.dtype(input_dtype)
    batch_shape = tuple(stored_shape or cfg.image_shape)
    oh, ow = cfg.image_shape[:2]

    def build(device, trainable: bool = False) -> ResNet:
        return ResNet(cfg, device=device, trainable=trainable)

    def _norm(x):
        if not x.is_floating_point():
            return x.float() * (1.0 / 255.0)
        return x

    def _augment(x, rng):
        if stored_shape is None:
            return x
        B, H, W = x.shape[:3]
        if rng is None:  # eval: the center crop
            y0, x0 = (H - oh) // 2, (W - ow) // 2
            return x[:, y0:y0 + oh, x0:x0 + ow]
        g = torch.Generator(device=x.device)
        g.manual_seed(rng)
        ys = torch.randint(0, H - oh + 1, (B,), generator=g, device=x.device)
        xs = torch.randint(0, W - ow + 1, (B,), generator=g, device=x.device)
        fl = torch.rand((B,), generator=g, device=x.device) < 0.5
        return device_crop_flip(x, ys, xs, fl, oh, ow)

    def loss_fn(model, batch, rng=None):
        logits = model(_norm(_augment(batch["image"], rng)), train=True)
        loss, metrics = softmax_cross_entropy(logits, batch["label"])
        return loss, {"metrics": metrics}

    def eval_loss_fn(model, batch, rng=None):
        logits = model(_norm(_augment(batch["image"], None)), train=False)
        loss, metrics = softmax_cross_entropy(logits, batch["label"])
        return loss, {"metrics": metrics}

    def input_spec(data_config, batch_size):
        return {"image": Spec((batch_size, *batch_shape), in_dtype),
                "label": Spec((batch_size,), np.dtype(np.int32))}

    def make_batch(rng: np.random.Generator, data_config, batch_size):
        """The reference's batch, bit for bit."""
        if np.issubdtype(in_dtype, np.integer):
            image = rng.integers(0, 256, (batch_size, *batch_shape)).astype(
                in_dtype)
        else:
            image = rng.standard_normal((batch_size, *batch_shape),
                                        dtype=np.float32)
        return {"image": image,
                "label": rng.integers(0, cfg.num_classes,
                                      (batch_size,)).astype(np.int32)}

    def macs() -> int:
        return count_macs(build("meta"), torch.empty(
            (1, *cfg.image_shape), device="meta"))

    return ModelBundle(cfg=cfg, build=build, loss_fn=loss_fn,
                       eval_loss_fn=eval_loss_fn, make_batch=make_batch,
                       input_spec=input_spec, task="classification",
                       init=init_layers, macs=macs)


@register_model("resnet18_cifar")
def make_resnet18_cifar(num_classes=10, dtype="bfloat16",
                        param_dtype="float32", image_shape=(32, 32, 3),
                        input_dtype="float32", norm="batch", num_filters=64):
    cfg = ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False,
                       num_classes=num_classes, num_filters=num_filters,
                       image_shape=tuple(image_shape), small_images=True,
                       norm=norm, dtype=dtype, param_dtype=param_dtype)
    return _bundle(cfg, input_dtype=input_dtype)


@register_model("resnet50_imagenet")
def make_resnet50_imagenet(num_classes=1000, dtype="bfloat16",
                           param_dtype="float32", image_shape=(224, 224, 3),
                           space_to_depth=True, input_dtype="uint8",
                           norm="batch", device_augment=False,
                           stored_hw=(256, 256)):
    cfg = ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                       num_classes=num_classes, image_shape=tuple(image_shape),
                       small_images=False, space_to_depth=space_to_depth,
                       norm=norm, dtype=dtype, param_dtype=param_dtype)
    stored = (*stored_hw, image_shape[2]) if device_augment else None
    return _bundle(cfg, input_dtype=input_dtype, stored_shape=stored)
