"""The rest of the CIFAR model zoo — the port of
``distributed_model_parallel_tpu/models/zoo.py``: the 16 builders of its
``ZOO_BUILDERS`` (VGG-11/13/16/19, PreActResNet-18, SENet-18, GoogLeNet,
DenseNet-121, ResNeXt-29 2x64d, MobileNet v1, DPN-92, ShuffleNet G2,
ShuffleNetV2, EfficientNet-B0, RegNetX-200MF, SimpleDLA), each a
:class:`~.staged.StagedModel` of ``nn.Module`` units at its published
CIFAR widths, NCHW (channels-last in memory), with the three BatchNorm
modes of ``models/layers.py``.

Children keep flax's module names (``conv``/``conv_bn``, ``pre_bn``,
``se_fc0``, ``l3_conv1``, ``left``/``right``/``root``, ...), which the
weight carrier (``staged.params_from_jax``) pairs by name; a DLA tree
nests its sub-trees and blocks as flax does. What a literal translation
would get wrong, and what this module does instead:

* the squeeze-excite convs (``se_fc0``/``se_fc1``) are flax's bare
  ``nn.Conv``: they carry a bias whatever ``bn_mode`` is, while the
  zoo's other convs carry one only under ``bn_mode="none"``;
* ShuffleNet v1's stride-2 shortcut is flax's ``avg_pool(x, (3, 3),
  (2, 2), padding="SAME")``: XLA's asymmetric SAME padding (0 low, 1
  high on an even input), zeros counted, every window divided by 9
  (:func:`avg_pool_same`), which ``F.avg_pool2d(..., padding=1)`` is
  not;
* GoogLeNet's max-pools are SAME (−∞ padding, ``layers.max_pool_same``);
  VGG's max-pool and DenseNet's transition average are 2x2 VALID;
* the channel shuffle is defined on NHWC's last axis
  (:func:`channel_shuffle`); slices and concatenations keep JAX's
  channel order (ShuffleNetV2's halves, DPN's residual ``[:d]`` and
  dense ``[d:]`` parts, DenseNet's growing concat, Inception's
  branches);
* swish is ``F.silu`` and the gates ``torch.sigmoid``; a spatial mean
  of a bf16 map accumulates in f32 and rounds once, as ``jnp.mean``
  does; DenseNet's head is f32, as ``ClassifierHead`` is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_model_parallel_tpu_torch.models.layers import (
    ClassifierHead,
    Conv,
    ConvUnit,
    Dense,
    _apply_norm,
    _norm,
    max_pool_same,
    same_padding,
)
from distributed_model_parallel_tpu_torch.models.staged import StagedModel

__all__ = ["ZOO_BUILDERS", "avg_pool_same", "channel_shuffle"]


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """JAX's NHWC ``_channel_shuffle`` of NCHW ``x``: output channel
    ``j·groups + i`` is input channel ``i·(C/groups) + j`` (the same order
    as ``x.view(N, g, C/g, H, W).transpose(1, 2)``); the result is
    channels-last in memory."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups)
    return y.transpose(3, 4).reshape(n, h, w, c).permute(0, 3, 1, 2)


def avg_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """flax's ``nn.avg_pool(x, (window,)*2, (stride,)*2, padding="SAME")``
    of NCHW ``x``: XLA's SAME padding with zeros, every window divided by
    ``window²`` (flax's ``count_include_pad=True``)."""
    ph = same_padding(x.shape[2], window, stride)
    pw = same_padding(x.shape[3], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.avg_pool2d(x, window, stride)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2), keepdims=True)`` of NCHW ``x``: f32
    accumulation, rounded once to ``x``'s dtype."""
    return torch.mean(x, (2, 3), keepdim=True,
                      dtype=torch.float32).to(x.dtype)


class _Block(nn.Module):
    """Shared plumbing of the zoo blocks: ``_conv``/``_norm_``/``_cbr``
    register children under flax's names, ``_run`` applies a ``_cbr``.
    (The helpers are underscored: a child named ``conv`` or ``bn`` must
    not be shadowed by a method.)"""

    def __init__(self, bn_mode: str = "local", bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, axis=None):
        super().__init__()
        self.hp = dict(bn_mode=bn_mode, bn_momentum=bn_momentum,
                       bn_epsilon=bn_epsilon, dtype=dtype, axis=axis)

    def _conv(self, name: str, cin: int, features: int, kernel: int = 3,
              stride: int = 1, groups: int = 1) -> None:
        setattr(self, name, Conv(cin, features, kernel, stride, groups,
                                 use_bias=self.hp["bn_mode"] == "none",
                                 dtype=self.hp["dtype"]))

    def _gate(self, name: str, cin: int, features: int) -> None:
        """A bare flax ``nn.Conv`` 1x1: biased under every ``bn_mode``."""
        setattr(self, name, Conv(cin, features, 1, use_bias=True,
                                 dtype=self.hp["dtype"]))

    def _norm_(self, name: str, features: int) -> None:
        setattr(self, name, _norm(self.hp["bn_mode"], features,
                                  momentum=self.hp["bn_momentum"],
                                  epsilon=self.hp["bn_epsilon"],
                                  axis=self.hp["axis"]))

    def _cbr(self, name: str, cin: int, features: int, kernel: int = 3,
             stride: int = 1, groups: int = 1) -> None:
        """conv ``name`` → norm ``{name}_bn`` (applied by :meth:`_run`)."""
        self._conv(name, cin, features, kernel, stride, groups)
        self._norm_(f"{name}_bn", features)

    def _bn(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        return _apply_norm(getattr(self, name), x, train)

    def _run(self, name: str, x: torch.Tensor, train: bool,
             act: bool = True) -> torch.Tensor:
        x = self._bn(f"{name}_bn", getattr(self, name)(x), train)
        return F.relu(x) if act else x

    def _shortcut_if(self, cin: int, features: int, stride: int,
                     norm: bool = True) -> None:
        """A projected shortcut (1x1 conv, and ``shortcut_bn``) when the
        stride is not 1 or the widths differ."""
        self.has_shortcut = stride != 1 or cin != features
        if self.has_shortcut:
            self._conv("shortcut", cin, features, 1, stride)
            if norm:
                self._norm_("shortcut_bn", features)

    def _project(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not self.has_shortcut:
            return x
        return self._bn("shortcut_bn", self.shortcut(x), train)


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

VGG_CFG = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGGUnit(_Block):
    """One 3x3 conv-BN-ReLU, optionally followed by a 2x2 VALID
    max-pool."""

    def __init__(self, cin: int, features: int = 64, pool: bool = False,
                 **hp):
        super().__init__(**hp)
        self.pool = pool
        self._cbr("conv", cin, features)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self._run("conv", x, train)
        return F.max_pool2d(x, 2, 2) if self.pool else x


def build_vgg(arch: str = "vgg16", num_classes: int = 10,
              **hp) -> StagedModel:
    cfg = VGG_CFG[arch]
    units: list[nn.Module] = []
    c, i = 3, 0
    while i < len(cfg):
        pool = i + 1 < len(cfg) and cfg[i + 1] == "M"
        units.append(VGGUnit(c, cfg[i], pool, **hp))
        c = cfg[i]
        i += 2 if pool else 1
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name=arch)


# ---------------------------------------------------------------------------
# PreActResNet / SENet
# ---------------------------------------------------------------------------


class PreActBlock(_Block):
    """Pre-activation residual block (BN→ReLU→conv ×2); ``se_ratio > 0``
    adds SENet-18's squeeze-excite gate on the residual branch."""

    def __init__(self, cin: int, features: int = 64, stride: int = 1,
                 se_ratio: float = 0.0, **hp):
        super().__init__(**hp)
        self._norm_("pre_bn", cin)
        self._shortcut_if(cin, features, stride, norm=False)
        self._conv("conv0", cin, features, 3, stride)
        self._norm_("bn0", features)
        self._conv("conv1", features, features, 3, 1)
        self.se = se_ratio > 0
        if self.se:
            squeezed = max(1, int(features * se_ratio))
            self._gate("se_fc0", features, squeezed)
            self._gate("se_fc1", squeezed, features)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        pre = F.relu(self._bn("pre_bn", x, train))
        shortcut = self.shortcut(pre) if self.has_shortcut else x
        y = F.relu(self._bn("bn0", self.conv0(pre), train))
        y = self.conv1(y)
        if self.se:
            w = self.se_fc1(F.relu(self.se_fc0(spatial_mean(y))))
            y = y * torch.sigmoid(w)
        return y + shortcut


def _build_preact(name: str, num_classes: int, se_ratio: float,
                  **hp) -> StagedModel:
    # Bare conv stem: the first block's pre-activation BN normalizes it.
    units: list[nn.Module] = [ConvUnit(3, ({
        "features": 64, "kernel": 3, "stride": 1, "act": False,
        "norm": False},), **hp)]
    c = 64
    for g, feats in enumerate((64, 128, 256, 512)):
        for b in range(2):
            units.append(PreActBlock(c, feats, 2 if g > 0 and b == 0 else 1,
                                     se_ratio, **hp))
            c = feats
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name=name)


def build_preact_resnet18(num_classes: int = 10, **hp) -> StagedModel:
    return _build_preact("preactresnet18", num_classes, 0.0, **hp)


def build_senet18(num_classes: int = 10, **hp) -> StagedModel:
    """SENet-18: PreAct blocks with squeeze-excite (ratio 1/16)."""
    return _build_preact("senet18", num_classes, 1.0 / 16.0, **hp)


# ---------------------------------------------------------------------------
# GoogLeNet
# ---------------------------------------------------------------------------

# (n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_planes), pool after
GOOGLE_CFG = (
    ((64, 96, 128, 16, 32, 32), False),
    ((128, 128, 192, 32, 96, 64), True),
    ((192, 96, 208, 16, 48, 64), False),
    ((160, 112, 224, 24, 64, 64), False),
    ((128, 128, 256, 24, 64, 64), False),
    ((112, 144, 288, 32, 64, 64), False),
    ((256, 160, 320, 32, 128, 128), True),
    ((256, 160, 320, 32, 128, 128), False),
    ((384, 192, 384, 48, 128, 128), False),
)


class Inception(_Block):
    """Four branches (1x1; 1x1→3x3; 1x1→3x3→3x3; 3x3 SAME max-pool→1x1)
    concatenated in that order; optionally a 3x3 stride-2 SAME max-pool
    after."""

    def __init__(self, cin: int, spec: tuple = GOOGLE_CFG[0][0],
                 pool_after: bool = False, **hp):
        super().__init__(**hp)
        n1, n3r, n3, n5r, n5, npool = spec
        self.pool_after = pool_after
        self._cbr("b1", cin, n1, 1)
        self._cbr("b2a", cin, n3r, 1)
        self._cbr("b2b", n3r, n3, 3)
        self._cbr("b3a", cin, n5r, 1)
        self._cbr("b3b", n5r, n5, 3)
        self._cbr("b3c", n5, n5, 3)
        self._cbr("b4", cin, npool, 1)
        self.out_features = n1 + n3 + n5 + npool

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b1 = self._run("b1", x, train)
        b2 = self._run("b2b", self._run("b2a", x, train), train)
        b3 = self._run("b3a", x, train)
        b3 = self._run("b3c", self._run("b3b", b3, train), train)
        b4 = self._run("b4", max_pool_same(x, 3, 1), train)
        y = torch.cat([b1, b2, b3, b4], 1)
        return max_pool_same(y, 3, 2) if self.pool_after else y


def build_googlenet(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 192, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 192
    for spec, pool_after in GOOGLE_CFG:
        units.append(Inception(c, spec, pool_after, **hp))
        c = units[-1].out_features
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="googlenet")


# ---------------------------------------------------------------------------
# DenseNet-121
# ---------------------------------------------------------------------------


class DenseBlock(_Block):
    """``num_layers`` bottleneck layers (BN→ReLU→1x1→BN→ReLU→3x3, each
    output concatenated after its input), optionally a transition
    (BN→ReLU→1x1 to ``int(C·reduction)``→2x2 VALID average)."""

    def __init__(self, cin: int, num_layers: int = 6, growth: int = 32,
                 transition: bool = True, reduction: float = 0.5, **hp):
        super().__init__(**hp)
        self.num_layers, self.transition = num_layers, transition
        c = cin
        for i in range(num_layers):
            self._norm_(f"l{i}_bn0", c)
            self._conv(f"l{i}_conv0", c, 4 * growth, 1)
            self._norm_(f"l{i}_bn1", 4 * growth)
            self._conv(f"l{i}_conv1", 4 * growth, growth, 3)
            c += growth
        if transition:
            self._norm_("t_bn", c)
            self._conv("t_conv", c, int(c * reduction), 1)
            c = int(c * reduction)
        self.out_features = c

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(self.num_layers):
            y = F.relu(self._bn(f"l{i}_bn0", x, train))
            y = getattr(self, f"l{i}_conv0")(y)
            y = F.relu(self._bn(f"l{i}_bn1", y, train))
            y = getattr(self, f"l{i}_conv1")(y)
            x = torch.cat([x, y], 1)
        if self.transition:
            x = self.t_conv(F.relu(self._bn("t_bn", x, train)))
            x = F.avg_pool2d(x, 2, 2)
        return x


class DenseHead(_Block):
    """BN → ReLU → global average pool → Dense (f32)."""

    def __init__(self, cin: int, num_classes: int = 10, **hp):
        super().__init__(**hp)
        self._norm_("bn", cin)
        self.linear = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self._bn("bn", x, train))
        return self.linear(spatial_mean(x).flatten(1))


def build_densenet121(num_classes: int = 10, **hp) -> StagedModel:
    growth = 32
    # Bare conv stem: the first dense layer's BN normalizes it.
    units: list[nn.Module] = [ConvUnit(3, ({
        "features": 2 * growth, "kernel": 3, "stride": 1, "act": False,
        "norm": False},), **hp)]
    c = 2 * growth
    for i, num_layers in enumerate((6, 12, 24, 16)):
        units.append(DenseBlock(c, num_layers, growth, i < 3, **hp))
        c = units[-1].out_features
    units.append(DenseHead(c, num_classes, **hp))
    return StagedModel(units, name="densenet121")


# ---------------------------------------------------------------------------
# ResNeXt-29 (2x64d)
# ---------------------------------------------------------------------------


class ResNeXtBlock(_Block):
    """1x1 → grouped 3x3 (``cardinality`` groups) → 1x1 (expansion 2),
    projected shortcut, ReLU after the add."""

    def __init__(self, cin: int, cardinality: int = 2, width: int = 64,
                 stride: int = 1, **hp):
        super().__init__(**hp)
        gw = cardinality * width
        out = 2 * gw
        self._cbr("conv0", cin, gw, 1)
        self._cbr("conv1", gw, gw, 3, stride, cardinality)
        self._cbr("conv2", gw, out, 1)
        self._shortcut_if(cin, out, stride)
        self.out_features = out

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self._run("conv1", self._run("conv0", x, train), train)
        y = self._run("conv2", y, train, act=False)
        return F.relu(y + self._project(x, train))


def build_resnext29_2x64d(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 64, "kernel": 3,
                                            "stride": 1},), **hp)]
    c, width = 64, 64
    for g in range(3):
        for b in range(3):
            units.append(ResNeXtBlock(c, 2, width,
                                      2 if g > 0 and b == 0 else 1, **hp))
            c = units[-1].out_features
        width *= 2
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="resnext29_2x64d")


# ---------------------------------------------------------------------------
# MobileNet (v1)
# ---------------------------------------------------------------------------

MOBILENET_CFG = (64, (128, 2), 128, (256, 2), 256, (512, 2),
                 512, 512, 512, 512, 512, (1024, 2), 1024)


class DepthwiseSeparable(_Block):
    """Depthwise 3x3 → pointwise 1x1, BN + ReLU after each."""

    def __init__(self, cin: int, features: int = 64, stride: int = 1, **hp):
        super().__init__(**hp)
        self._cbr("dw", cin, cin, 3, stride, cin)
        self._cbr("pw", cin, features, 1)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self._run("pw", self._run("dw", x, train), train)


def build_mobilenetv1(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 32, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 32
    for entry in MOBILENET_CFG:
        feats, stride = entry if isinstance(entry, tuple) else (entry, 1)
        units.append(DepthwiseSeparable(c, feats, stride, **hp))
        c = feats
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="mobilenetv1")


# ---------------------------------------------------------------------------
# DPN-92
# ---------------------------------------------------------------------------

# per stage: (bottleneck_width, out_planes, num_blocks, dense_depth, stride)
DPN92_CFG = ((96, 256, 3, 16, 1), (192, 512, 4, 32, 2),
             (384, 1024, 20, 24, 2), (768, 2048, 3, 128, 2))


class DPNBlock(_Block):
    """Dual-path block: the residual add on the first ``out_planes``
    channels, the dense concatenation of ``dense_depth`` new channels
    after the input's dense part."""

    def __init__(self, cin: int, width: int = 96, out_planes: int = 256,
                 dense_depth: int = 16, stride: int = 1, first: bool = False,
                 **hp):
        super().__init__(**hp)
        self.d, self.first = out_planes, first
        self._cbr("conv0", cin, width, 1)
        self._cbr("conv1", width, width, 3, stride, 32)
        self._cbr("conv2", width, out_planes + dense_depth, 1)
        if first:
            self._conv("shortcut", cin, out_planes + dense_depth, 1, stride)
            self._norm_("shortcut_bn", out_planes + dense_depth)
        self.out_features = ((out_planes + dense_depth if first else cin)
                             + dense_depth)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        d = self.d
        y = self._run("conv1", self._run("conv0", x, train), train)
        y = self._run("conv2", y, train, act=False)
        if self.first:
            x = self._bn("shortcut_bn", self.shortcut(x), train)
        res = x[:, :d] + y[:, :d]
        return F.relu(torch.cat([res, x[:, d:], y[:, d:]], 1))


def build_dpn92(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 64, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 64
    for width, out_planes, blocks, dense_depth, stride in DPN92_CFG:
        for b in range(blocks):
            units.append(DPNBlock(c, width, out_planes, dense_depth,
                                  stride if b == 0 else 1, b == 0, **hp))
            c = units[-1].out_features
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="dpn92")


# ---------------------------------------------------------------------------
# ShuffleNet (G2) and ShuffleNetV2
# ---------------------------------------------------------------------------


class ShuffleV1Block(_Block):
    """Grouped 1x1 → channel shuffle → depthwise 3x3 → grouped 1x1;
    stride-2 blocks concatenate the SAME-averaged input before the new
    channels (ShuffleNet v1, groups 2); stage 1's first block has an
    ungrouped first 1x1."""

    def __init__(self, cin: int, features: int = 200, groups: int = 2,
                 stride: int = 1, first_group: bool = False, **hp):
        super().__init__(**hp)
        self.groups, self.stride = groups, stride
        out = features - cin if stride == 2 else features
        mid = max(groups, out // 4)
        mid -= mid % groups
        self._cbr("conv0", cin, mid, 1, 1, 1 if first_group else groups)
        self._cbr("dw", mid, mid, 3, stride, mid)
        self._cbr("conv1", mid, out, 1, 1, groups)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = channel_shuffle(self._run("conv0", x, train), self.groups)
        y = self._run("dw", y, train, act=False)
        y = self._run("conv1", y, train, act=False)
        if self.stride == 2:
            return F.relu(torch.cat([avg_pool_same(x, 3, 2), y], 1))
        return F.relu(y + x)


def build_shufflenetg2(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 24, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 24
    for s, (feats, blocks) in enumerate(zip((200, 400, 800), (4, 8, 4))):
        for b in range(blocks):
            units.append(ShuffleV1Block(c, feats, 2, 2 if b == 0 else 1,
                                        s == 0 and b == 0, **hp))
            c = feats
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="shufflenetg2")


class ShuffleV2Block(_Block):
    """ShuffleNetV2's basic block (stride 1: split the channels in
    halves, transform the right one, concatenate, shuffle) or its
    down-sampling block (stride 2: both branches transform the input)."""

    def __init__(self, cin: int, features: int = 116, stride: int = 1,
                 **hp):
        super().__init__(**hp)
        self.stride = stride
        if stride == 1:
            self.half = cin // 2
            f = features - self.half
            self._cbr("r0", cin - self.half, f, 1)
            self._cbr("r_dw", f, f, 3, 1, f)
            self._cbr("r1", f, f, 1)
        else:
            f = features // 2
            self._cbr("l_dw", cin, cin, 3, 2, cin)
            self._cbr("l0", cin, f, 1)
            self._cbr("r0", cin, f, 1)
            self._cbr("r_dw", f, f, 3, 2, f)
            self._cbr("r1", f, features - f, 1)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.stride == 1:
            left, right = x[:, :self.half], x[:, self.half:]
        else:
            left = self._run("l0", self._run("l_dw", x, train, act=False),
                            train)
            right = x
        right = self._run("r_dw", self._run("r0", right, train), train,
                         act=False)
        right = self._run("r1", right, train)
        return channel_shuffle(torch.cat([left, right], 1), 2)


def build_shufflenetv2(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 24, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 24
    for feats, blocks in zip((116, 232, 464), (4, 8, 4)):
        for b in range(blocks):
            units.append(ShuffleV2Block(c, feats, 2 if b == 0 else 1, **hp))
            c = feats
    units.append(ClassifierHead(c, num_classes, 1024, **hp))
    return StagedModel(units, name="shufflenetv2")


# ---------------------------------------------------------------------------
# EfficientNet-B0
# ---------------------------------------------------------------------------

# (expansion, out, num_blocks, kernel, stride)
EFFNET_CFG = ((1, 16, 1, 3, 1), (6, 24, 2, 3, 2), (6, 40, 2, 5, 2),
              (6, 80, 3, 3, 2), (6, 112, 3, 5, 1), (6, 192, 4, 5, 2),
              (6, 320, 1, 3, 1))


class MBConv(_Block):
    """Mobile inverted bottleneck: (1x1 expand → BN → swish) → depthwise
    → BN → swish → squeeze-excite (swish, sigmoid) → 1x1 project → BN,
    residual when the stride is 1 and the widths agree."""

    def __init__(self, cin: int, expansion: int = 6, features: int = 16,
                 kernel: int = 3, stride: int = 1, se_ratio: float = 0.25,
                 **hp):
        super().__init__(**hp)
        hidden = cin * expansion
        self.expand_ = expansion != 1
        if self.expand_:
            self._conv("expand", cin, hidden, 1)
            self._norm_("expand_bn", hidden)
        self._conv("dw", hidden, hidden, kernel, stride, hidden)
        self._norm_("dw_bn", hidden)
        squeezed = max(1, int(cin * se_ratio))
        self._gate("se_fc0", hidden, squeezed)
        self._gate("se_fc1", squeezed, hidden)
        self._conv("project", hidden, features, 1)
        self._norm_("project_bn", features)
        self.residual = stride == 1 and cin == features
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        if self.expand_:
            y = F.silu(self._bn("expand_bn", self.expand(y), train))
        y = F.silu(self._bn("dw_bn", self.dw(y), train))
        w = torch.sigmoid(self.se_fc1(F.silu(self.se_fc0(spatial_mean(y)))))
        y = self._bn("project_bn", self.project(y * w), train)
        return y + x if self.residual else y


def build_efficientnetb0(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 32, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 32
    for expansion, feats, blocks, kernel, stride in EFFNET_CFG:
        for b in range(blocks):
            units.append(MBConv(c, expansion, feats, kernel,
                                stride if b == 0 else 1, **hp))
            c = feats
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="efficientnetb0")


# ---------------------------------------------------------------------------
# RegNetX-200MF
# ---------------------------------------------------------------------------

# (width, depth, stride), group width 8, bottleneck ratio 1
REGNET_CFG = ((24, 1, 1), (56, 1, 1), (152, 4, 2), (368, 7, 2))


class RegNetBlock(_Block):
    """1x1 → grouped 3x3 (``features // group_width`` groups) → 1x1,
    projected shortcut, ReLU after the add (the X variant: no SE)."""

    def __init__(self, cin: int, features: int = 24, stride: int = 1,
                 group_width: int = 8, **hp):
        super().__init__(**hp)
        self._cbr("conv0", cin, features, 1)
        self._cbr("conv1", features, features, 3, stride,
                 features // group_width)
        self._cbr("conv2", features, features, 1)
        self._shortcut_if(cin, features, stride)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self._run("conv1", self._run("conv0", x, train), train)
        y = self._run("conv2", y, train, act=False)
        return F.relu(y + self._project(x, train))


def build_regnetx_200mf(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [ConvUnit(3, ({"features": 64, "kernel": 3,
                                            "stride": 1},), **hp)]
    c = 64
    for width, depth, stride in REGNET_CFG:
        for b in range(depth):
            units.append(RegNetBlock(c, width, stride if b == 0 else 1, 8,
                                     **hp))
            c = width
    units.append(ClassifierHead(c, num_classes, None, **hp))
    return StagedModel(units, name="regnetx_200mf")


# ---------------------------------------------------------------------------
# SimpleDLA
# ---------------------------------------------------------------------------


class DLABasic(_Block):
    """Two 3x3 convs with a projected shortcut, ReLU after the add."""

    def __init__(self, cin: int, features: int = 64, stride: int = 1, **hp):
        super().__init__(**hp)
        self._cbr("conv0", cin, features, 3, stride)
        self._cbr("conv1", features, features, 3)
        self._shortcut_if(cin, features, stride)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self._run("conv1", self._run("conv0", x, train), train, act=False)
        return F.relu(y + self._project(x, train))


class DLATree(_Block):
    """Deep-layer-aggregation tree: at level 1 two :class:`DLABasic`
    blocks (``left``, then ``right`` on its output), at higher levels two
    sub-trees; their outputs meet at the ``root`` (1x1 conv on the
    concatenation, BN, ReLU). The children nest as flax nests them."""

    def __init__(self, cin: int, features: int = 64, level: int = 1,
                 stride: int = 1, **hp):
        super().__init__(**hp)
        if level == 1:
            self.left = DLABasic(cin, features, stride, **hp)
            self.right = DLABasic(features, features, 1, **hp)
        else:
            self.left = DLATree(cin, features, level - 1, stride, **hp)
            self.right = DLATree(features, features, level - 1, 1, **hp)
        self._conv("root", 2 * features, features, 1)
        self._norm_("root_bn", features)
        self.out_features = features

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        left = self.left(x, train)
        right = self.right(left, train)
        root = self.root(torch.cat([left, right], 1))
        return F.relu(self._bn("root_bn", root, train))


def build_simpledla(num_classes: int = 10, **hp) -> StagedModel:
    units: list[nn.Module] = [
        ConvUnit(3, ({"features": 16, "kernel": 3, "stride": 1},), **hp),
        ConvUnit(16, ({"features": 16, "kernel": 3, "stride": 1},), **hp),
        ConvUnit(16, ({"features": 32, "kernel": 3, "stride": 1},), **hp),
        DLATree(32, 64, 1, 1, **hp),
        DLATree(64, 128, 2, 2, **hp),
        DLATree(128, 256, 2, 2, **hp),
        DLATree(256, 512, 1, 2, **hp),
        ClassifierHead(512, num_classes, None, **hp),
    ]
    return StagedModel(units, name="simpledla")


ZOO_BUILDERS = {
    "vgg11": lambda **kw: build_vgg("vgg11", **kw),
    "vgg13": lambda **kw: build_vgg("vgg13", **kw),
    "vgg16": lambda **kw: build_vgg("vgg16", **kw),
    "vgg19": lambda **kw: build_vgg("vgg19", **kw),
    "preactresnet18": build_preact_resnet18,
    "senet18": build_senet18,
    "googlenet": build_googlenet,
    "densenet121": build_densenet121,
    "resnext29_2x64d": build_resnext29_2x64d,
    "mobilenetv1": build_mobilenetv1,
    "dpn92": build_dpn92,
    "shufflenetg2": build_shufflenetg2,
    "shufflenetv2": build_shufflenetv2,
    "efficientnetb0": build_efficientnetb0,
    "regnetx_200mf": build_regnetx_200mf,
    "simpledla": build_simpledla,
}
