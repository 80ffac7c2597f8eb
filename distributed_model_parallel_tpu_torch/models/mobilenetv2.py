"""MobileNetV2, CIFAR-adapted, as a staged unit sequence — the port of
``distributed_model_parallel_tpu/models/mobilenetv2.py``.

19 units: stem, 17 inverted-residual blocks, head. ``input_layout=
"cifar"`` keeps the reference's 32 px adaptation (stride-1 stem and first
groups); ``"imagenet"`` the standard stride table. ``bn_mode="none"`` is
the no-BatchNorm variant (biases on every conv, no BN anywhere).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_model_parallel_tpu_torch.models.layers import (
    ClassifierHead,
    Conv,
    ConvUnit,
    _apply_norm,
    _norm,
)
from distributed_model_parallel_tpu_torch.models.staged import StagedModel

# (expansion, out_channels, num_blocks, stride) — CIFAR-adapted MobileNetV2.
CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 1),   # stride 1 for CIFAR (2 for ImageNet)
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# Standard ImageNet strides (torchvision mobilenet_v2).
CFG_IMAGENET = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    """Expand 1x1 → depthwise 3x3 → project 1x1, residual iff stride == 1.

    ``style="reference"``: the CIFAR block (unconditional expand conv; a
    projected 1x1+BN shortcut when channel counts differ at stride 1).
    ``"torchvision"``: no expand conv at expansion 1, and a residual only
    when stride == 1 and the channel counts agree."""

    def __init__(self, in_features: int, expansion: int, features: int,
                 stride: int, bn_mode: str = "local",
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 style: str = "reference", axis=None):
        super().__init__()
        hidden = in_features * expansion
        use_bias = bn_mode == "none"
        self.stride, self.style = stride, style
        self.residual = stride == 1 and (in_features == features
                                         or style == "reference")
        norm = dict(momentum=bn_momentum, epsilon=bn_epsilon, axis=axis)

        self.has_expand = not (expansion == 1 and style == "torchvision")
        if self.has_expand:
            self.expand = Conv(in_features, hidden, 1, use_bias=use_bias,
                               dtype=dtype)
            self.expand_bn = _norm(bn_mode, hidden, **norm)
        self.depthwise = Conv(hidden, hidden, 3, stride, groups=hidden,
                              use_bias=use_bias, dtype=dtype)
        self.depthwise_bn = _norm(bn_mode, hidden, **norm)
        self.project = Conv(hidden, features, 1, use_bias=use_bias,
                            dtype=dtype)
        self.project_bn = _norm(bn_mode, features, **norm)
        self.has_shortcut = self.residual and in_features != features
        if self.has_shortcut:
            self.shortcut = Conv(in_features, features, 1,
                                 use_bias=use_bias, dtype=dtype)
            self.shortcut_bn = _norm(bn_mode, features, **norm)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        if self.has_expand:
            y = F.relu(_apply_norm(self.expand_bn, self.expand(y), train))
        y = F.relu(_apply_norm(self.depthwise_bn, self.depthwise(y), train))
        y = _apply_norm(self.project_bn, self.project(y), train)
        if not self.residual:
            return y
        if self.has_shortcut:
            x = _apply_norm(self.shortcut_bn, self.shortcut(x), train)
        return y + x


def build_mobilenetv2(num_classes: int = 10, *, bn_mode: str = "local",
                      bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                      dtype: torch.dtype = torch.float32,
                      input_layout: str = "cifar",
                      in_channels: int = 3, axis=None) -> StagedModel:
    """19 units: stem, 17 inverted-residual blocks, head. Weights are
    uninitialized; :func:`~..models.get_model` initializes them. ``axis``:
    the process group of ``bn_mode="sync"``."""
    if input_layout not in ("cifar", "imagenet"):
        raise ValueError(f"unknown input_layout: {input_layout!r}")
    imagenet = input_layout == "imagenet"
    common = dict(bn_mode=bn_mode, bn_momentum=bn_momentum,
                  bn_epsilon=bn_epsilon, dtype=dtype, axis=axis)
    units: list[nn.Module] = [ConvUnit(
        in_channels, ({"features": 32, "kernel": 3,
                       "stride": 2 if imagenet else 1},), **common)]
    c = 32
    for expansion, features, num_blocks, stride in (
            CFG_IMAGENET if imagenet else CFG):
        for b in range(num_blocks):
            units.append(InvertedResidual(
                c, expansion, features, stride if b == 0 else 1,
                style="torchvision" if imagenet else "reference", **common))
            c = features
    units.append(ClassifierHead(c, num_classes, conv_features=1280,
                                **common))
    name = "mobilenetv2" if bn_mode != "none" else "mobilenetv2_nobn"
    if imagenet:
        name += "_imagenet"
    return StagedModel(units, name=name)
