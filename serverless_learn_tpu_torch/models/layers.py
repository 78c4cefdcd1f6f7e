"""The flax layers the image families are built from, in PyTorch: ``Dense``
(``nn.Dense``: kernel ``[I, O]`` and a bias), ``Conv`` (``nn.Conv`` with
SAME padding and no bias), ``BatchNorm``, ``GroupNorm`` and ``ScaleBias``
(``serverless_learn_tpu/models/resnet.py:29``), each computing as flax does:
parameters in ``param_dtype`` (f32), products in ``dtype`` (bf16).

Activations run in the logical NCHW layout PyTorch's convolutions take; an
NHWC image permuted to it is channels-last in memory, so cuDNN runs its NHWC
kernels and no copy is made. Conv kernels are kept as PyTorch's OIHW
(``bridge.py`` maps them to and from flax's HWIO).

Where flax and PyTorch differ, these follow flax:

* SAME padding is asymmetric when the window overhangs by an odd amount (a
  3x3 stride-2 conv on 32 pads (0, 1), the 7x7/2 stem on 224 pads (2, 3)):
  :func:`same_pads` computes XLA's split and an uneven one is padded
  explicitly;
* BatchNorm's statistics are f32 over (N, H, W), the variance the biased
  E[x^2] - E[x]^2 clipped at zero (flax's ``use_fast_variance``), and the
  running averages move as ``ra = 0.9 ra + 0.1 batch`` (flax's momentum
  0.9, the biased variance): not ``torch.nn.BatchNorm2d``'s update.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from serverless_learn_tpu_torch.models.common import leaf_generator

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5
GROUPS = 32


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME for one spatial dim: the output
    is ceil(size / s), the low side gets the smaller half."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's ``lecun_normal``: a normal truncated to [-2, 2] std, scaled so
    the variance is 1 / fan_in (0.8796...: the std of the truncated unit
    normal)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, both cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(self.dtype) @ self.kernel.to(self.dtype)
                + self.bias.to(self.dtype))

    def init_(self, gen_of):
        _lecun_normal_(self.kernel, self.kernel.shape[0], gen_of("kernel"))
        self.bias.zero_()

    def macs(self, out: torch.Tensor) -> int:
        return out.numel() * self.kernel.shape[0]


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` over [N, C, H, W]
    for a square ``k`` x ``k`` window and stride ``s``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, s: int, dtype,
                 param_dtype, device=None):
        super().__init__()
        self.dtype, self.k, self.s = dtype, k, s
        self.kernel = nn.Parameter(torch.empty(
            out_ch, in_ch, k, k, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hl, hh), (wl, wh) = (same_pads(x.shape[2], self.k, self.s),
                              same_pads(x.shape[3], self.k, self.s))
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        if (hl, wl) == (hh, wh):
            return F.conv2d(x, w, stride=self.s, padding=(hl, wl))
        return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=self.s)

    def init_(self, gen_of):
        o, i, kh, kw = self.kernel.shape
        _lecun_normal_(self.kernel, i * kh * kw, gen_of("kernel"))

    def macs(self, out: torch.Tensor) -> int:
        _, i, kh, kw = self.kernel.shape
        return out.numel() * i * kh * kw


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: the pad
    is -inf."""
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, s), same_pads(x.shape[3],
                                                                k, s)
    return F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")), k,
                        s)


def _fast_stats(xf: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's ``_compute_stats`` with ``use_fast_variance``: f32 mean and
    E[x^2] - E[x]^2 clipped at zero."""
    mean = xf.mean(dim=dims)
    var = (xf.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
    return mean, var


class _Norm(nn.Module):
    """A per-channel scale (ones, or zeros for the last norm of a residual
    branch) and bias in ``param_dtype``."""

    def __init__(self, ch: int, dtype, param_dtype, zero_scale=False,
                 device=None):
        super().__init__()
        self.dtype, self.zero_scale = dtype, zero_scale
        self.scale = nn.Parameter(torch.empty(ch, dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.empty(ch, dtype=param_dtype,
                                             device=device))

    def init_(self, gen_of):
        self.scale.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()

    def _apply_stats(self, x, mean, var, eps):
        """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) +
        bias in f32, cast to ``dtype``. ``mean``/``var`` broadcast to x."""
        mul = torch.rsqrt(var + eps) * self.scale.float()[:, None, None]
        return ((x.float() - mean) * mul
                + self.bias.float()[:, None, None]).to(self.dtype)


class BatchNorm(_Norm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``; the running
    statistics are the buffers ``mean`` and ``var`` (flax's
    ``batch_stats``), moved in place by each training forward."""

    def __init__(self, ch, dtype, param_dtype, zero_scale=False,
                 device=None):
        super().__init__(ch, dtype, param_dtype, zero_scale, device)
        self.register_buffer("mean", torch.zeros(ch, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(ch, dtype=torch.float32,
                                               device=device))

    def init_(self, gen_of):
        super().init_(gen_of)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean, var = _fast_stats(x.float(), (0, 2, 3))
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return self._apply_stats(x, mean[:, None, None], var[:, None, None],
                                 BN_EPSILON)


class GroupNorm(_Norm):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-5)``: per-sample
    statistics over each group's channels and the spatial dims."""

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        n, c, h, w = x.shape
        if c % GROUPS:
            raise ValueError(f"GroupNorm({GROUPS}) over {c} channels")
        xg = x.float().reshape(n, GROUPS, c // GROUPS, h, w)
        mean, var = _fast_stats(xg, (2, 3, 4))
        rep = lambda t: t.repeat_interleave(c // GROUPS, dim=1)[  # noqa
            :, :, None, None]
        return self._apply_stats(x, rep(mean), rep(var), BN_EPSILON)


class ScaleBias(_Norm):
    """The reference's ``ScaleBias`` (``norm="none"``): ``x * scale + bias``
    with both cast to x's dtype; no statistics."""

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return (x * self.scale.to(x.dtype)[:, None, None]
                + self.bias.to(x.dtype)[:, None, None])


NORMS = {"batch": BatchNorm, "group": GroupNorm, "none": ScaleBias}


@torch.no_grad()
def init_layers(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every layer of ``model`` from ``seed`` with flax's
    initializers' distributions (each tensor from its own generator, as
    ``transformer.init_params`` does); the values differ from flax's."""
    for prefix, mod in model.named_modules():
        if hasattr(mod, "init_"):
            dev = next(mod.parameters()).device
            mod.init_(lambda leaf, p=prefix, d=dev: leaf_generator(
                seed, f"{p}.{leaf}", d))
    return model


def count_macs(model: nn.Module, example: torch.Tensor) -> int:
    """Multiply-adds of every ``Conv`` and ``Dense`` in one forward of
    ``example`` (an eval forward: running statistics are not touched)."""
    total: List[int] = [0]

    def hook(mod, inp, out):
        total[0] += mod.macs(out)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            model(example, train=False)
    finally:
        for h in handles:
            h.remove()
    return total[0]
