"""ResNet-18/34/50 as staged unit sequences — the port of
``distributed_model_parallel_tpu/models/resnet.py``.

Units: the stem, one unit per residual block (8 for ResNet-18, 16 for
ResNet-34 and ResNet-50), the head. ``input_layout="cifar"`` is the 32 px
adaptation (a 3x3 stride-1 stem, no pool); ``"imagenet"`` the standard
stem (7x7 stride 2, then a 3x3 stride-2 SAME max-pool) for 224 px inputs.
Children keep flax's names (``conv0..2``, ``bn0..2``, ``shortcut``,
``shortcut_bn``), which ``params_from_jax`` walks.
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

# name -> (block kind, blocks per group)
ARCH = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}
GROUP_FEATURES = (64, 128, 256, 512)


class ResBlock(nn.Module):
    """Basic (3x3, 3x3) or bottleneck (1x1, 3x3, 1x1 x4) residual block:
    ReLU after every conv but the last, a projected shortcut (1x1 conv +
    BN) when the stride is not 1 or the widths differ, ReLU after the
    add. Convs take a bias only under ``bn_mode="none"``."""

    def __init__(self, in_features: int, kind: str, features: int,
                 stride: int, bn_mode: str = "local",
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, axis=None):
        super().__init__()
        use_bias = bn_mode == "none"
        out = features * (4 if kind == "bottleneck" else 1)
        norm = dict(momentum=bn_momentum, epsilon=bn_epsilon, axis=axis)
        if kind == "basic":
            specs = [(features, 3, stride), (features, 3, 1)]
        elif kind == "bottleneck":
            specs = [(features, 1, 1), (features, 3, stride), (out, 1, 1)]
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        self.n_convs = len(specs)
        c = in_features
        for i, (f, k, s) in enumerate(specs):
            setattr(self, f"conv{i}", Conv(c, f, k, s, use_bias=use_bias,
                                           dtype=dtype))
            setattr(self, f"bn{i}", _norm(bn_mode, f, **norm))
            c = f
        self.has_shortcut = stride != 1 or in_features != out
        if self.has_shortcut:
            self.shortcut = Conv(in_features, out, 1, stride,
                                 use_bias=use_bias, dtype=dtype)
            self.shortcut_bn = _norm(bn_mode, out, **norm)
        self.out_features = out

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        for i in range(self.n_convs):
            y = _apply_norm(getattr(self, f"bn{i}"),
                            getattr(self, f"conv{i}")(y), train)
            if i < self.n_convs - 1:
                y = F.relu(y)
        if self.has_shortcut:
            x = _apply_norm(self.shortcut_bn, self.shortcut(x), train)
        return F.relu(y + x)


def build_resnet(arch: str = "resnet18", num_classes: int = 10, *,
                 bn_mode: str = "local", bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 input_layout: str = "cifar", in_channels: int = 3,
                 axis=None) -> StagedModel:
    """The stem, one unit per residual block, the head (global average
    pool, Dense). Weights are uninitialized; :func:`~..models.get_model`
    initializes them. ``axis``: the process group of ``bn_mode="sync"``.
    The name carries ``_imagenet`` for the ImageNet layout."""
    if input_layout not in ("cifar", "imagenet"):
        raise ValueError(f"unknown input_layout: {input_layout!r}")
    if arch not in ARCH:
        raise KeyError(f"unknown ResNet {arch!r}; known: {', '.join(ARCH)}")
    imagenet = input_layout == "imagenet"
    kind, groups = ARCH[arch]
    common = dict(bn_mode=bn_mode, bn_momentum=bn_momentum,
                  bn_epsilon=bn_epsilon, dtype=dtype, axis=axis)
    stem = ({"features": 64, "kernel": 7, "stride": 2, "maxpool": 2}
            if imagenet else {"features": 64, "kernel": 3, "stride": 1})
    units: list[nn.Module] = [ConvUnit(in_channels, (stem,), **common)]
    c = 64
    for g, num_blocks in enumerate(groups):
        for b in range(num_blocks):
            block = ResBlock(c, kind, GROUP_FEATURES[g],
                             2 if g > 0 and b == 0 else 1, **common)
            units.append(block)
            c = block.out_features
    units.append(ClassifierHead(c, num_classes, conv_features=None,
                                **common))
    return StagedModel(units, name=arch + ("_imagenet" if imagenet else ""))
