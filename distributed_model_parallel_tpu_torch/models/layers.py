"""Shared building blocks of the CNN models — the port of
``distributed_model_parallel_tpu/models/layers.py`` (flax) as
``nn.Module``s.

Layout: the modules take NCHW tensors whose memory is channels-last (the
staged model's public functions take the JAX package's NHWC and permute,
a free view), so cuDNN runs its NHWC kernels. Parameters are float32;
``dtype`` is the compute dtype, to which each call casts the conv kernel
and the input, as flax does. What each piece keeps of flax's numerics:

* :class:`Conv` — ``padding="SAME"`` as XLA pads it: total
  ``max((ceil(in/s) - 1)·s + k - in, 0)``, the low side taking the floor
  of half. At stride 2 on an even input that is (0, 1), not torch's
  symmetric (1, 1). flax's explicit paddings (``"VALID"``, an int, or
  per-dim ints or ``(low, high)`` pairs) are taken as given.
* :func:`max_pool_same` — flax's ``nn.max_pool(x, (k, k), (s, s),
  padding="SAME")``: XLA's SAME pads with −∞ and asymmetrically (0, 1 at
  stride 2 on an even input), which ``F.max_pool2d``'s symmetric
  ``padding`` cannot express; the input is padded explicitly with −∞ (bf16
  holds it too) and pooled with padding 0.
* :class:`BatchNorm` — flax's ``BatchNorm``: batch statistics in f32,
  normalization in f32 rounded once to ``dtype``, and running averages
  ``ra = μ·ra + (1 - μ)·stat`` with the *biased* batch variance. The
  normalization is ``F.batch_norm`` (cuDNN on the card); its running
  variance, which torch updates with the unbiased variance n/(n-1)·var,
  is corrected in place after each training call. With a process
  ``group`` of more than one rank (``bn_mode="sync"``) the batch
  statistics span every rank's batch, as flax's ``axis_name`` BN computes
  them: one all-reduce of the per-rank E[x] and E[x²] (f32), the variance
  E[x²] − E[x]² clamped at 0, and an all-reduce of their gradients in the
  backward (:class:`AllReduceSum`).
* :class:`Dense` — float32 whatever ``dtype`` is (the classifier head).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    world_size,
)

# flax's lecun_normal: truncated normal on [-2, 2] scaled to unit variance.
_TRUNC_STD = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def explicit_padding(padding, size: int, kernel: int,
                     stride: int, dim: int) -> tuple[int, int]:
    """flax's conv ``padding`` of spatial dim ``dim`` (0: H, 1: W) as
    (low, high): ``"SAME"`` (XLA's rule), ``"VALID"``, an int for every
    side, or a sequence per dim of an int or a ``(low, high)`` pair."""
    if isinstance(padding, str):
        if padding == "SAME":
            return same_padding(size, kernel, stride)
        if padding == "VALID":
            return 0, 0
        raise ValueError(f"conv padding {padding!r}: the port takes 'SAME', "
                         f"'VALID' and explicit padding")
    if isinstance(padding, int):
        return padding, padding
    p = padding[dim]
    if isinstance(p, int):
        return p, p
    lo, hi = p
    return int(lo), int(hi)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """flax's ``nn.max_pool(x, (window,)*2, strides=(stride,)*2,
    padding="SAME")`` of NCHW ``x``: XLA's SAME padding, filled with −∞."""
    ph = same_padding(x.shape[2], window, stride)
    pw = same_padding(x.shape[3], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init (variance scaling 1, fan-in, truncated
    normal), in place."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class Conv(nn.Module):
    """flax ``nn.Conv``: weight ``[O, I/g, k, k]`` (channels-last in
    memory), optional bias, compute in ``dtype``; ``padding`` as flax
    takes it (:func:`explicit_padding`)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, padding="SAME"):
        super().__init__()
        self.kernel, self.stride, self.groups = kernel, stride, groups
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel, kernel)
            .contiguous(memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def pads(self, h: int, w: int) -> tuple[tuple, tuple]:
        """(low, high) padding of H and W for an ``h`` x ``w`` input."""
        return (explicit_padding(self.padding, h, self.kernel, self.stride,
                                 0),
                explicit_padding(self.padding, w, self.kernel, self.stride,
                                 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.pads(x.shape[2], x.shape[3])
        x = x.to(self.dtype)
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            ph = pw = (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride,
                        (ph[0], pw[0]), 1, self.groups)


class Dense(nn.Module):
    """flax ``nn.Dense`` in float32: weight ``[O, I]``, bias ``[O]``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the gradient over the
    group too (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        all_reduce_(x, group, kind="sync_bn")
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_(g, ctx.group, kind="sync_bn")
        return g, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim: ``weight``/``bias`` are
    flax's ``scale``/``bias``, ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var``. ``momentum`` is flax's (the running
    average keeps ``momentum`` of the old value). ``group``: the process
    group whose ranks' batches the training statistics span (None: this
    rank's batch; at world 1 the two are the same and the local path
    runs)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, group=None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.group = group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        if self.group is not None and world_size(self.group) > 1:
            return self._sync_forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * self.momentum
        # torch updates a scratch copy of the running variance (autograd
        # keeps the tensor it was given for the backward, so it must not
        # change afterwards) to kept + (1 - μ)·n/(n-1)·var; flax keeps
        # kept + (1 - μ)·var, i.e. the new term scaled by (n-1)/n.
        scratch = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, scratch, self.weight,
                         self.bias, True, 1.0 - self.momentum, self.epsilon)
        with torch.no_grad():
            torch.lerp(scratch, kept, 1.0 / n, out=self.running_var)
        return y

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax's BN with ``axis_name``: statistics in (at least) f32
        averaged over the group, normalization in f32 rounded once to
        ``x.dtype``."""
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
        stats = AllReduceSum.apply(stats, self.group) / world_size(
            self.group)
        mean, mean2 = stats[:c], stats[c:]
        var = (mean2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        with torch.no_grad():
            mu = self.momentum
            self.running_mean.copy_(mu * self.running_mean
                                    + (1 - mu) * mean.detach())
            self.running_var.copy_(mu * self.running_var
                                   + (1 - mu) * var.detach())
        return y.to(x.dtype)


def _norm(bn_mode: str, features: int, *, momentum: float,
          epsilon: float, axis=None) -> BatchNorm | None:
    """A BatchNorm for ``"local"`` (this rank's statistics) and ``"sync"``
    (statistics over the process group ``axis``), nothing for
    ``"none"``."""
    if bn_mode == "none":
        return None
    if bn_mode == "sync":
        if axis is None:
            raise ValueError("sync BatchNorm requires an axis (the data "
                             "axis' process group)")
        return BatchNorm(features, momentum, epsilon, group=axis)
    if bn_mode != "local":
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    return BatchNorm(features, momentum, epsilon)


def _apply_norm(bn: BatchNorm | None, x: torch.Tensor,
                train: bool) -> torch.Tensor:
    return x if bn is None else bn(x, train)


class ConvUnit(nn.Module):
    """Conv → (BN) → (ReLU) → (max-pool), once per entry of ``ops`` (dicts
    with keys features, kernel, stride, padding, groups, act, norm, and
    maxpool: the stride of a trailing 3x3 SAME max-pool, e.g. the ImageNet
    ResNet stem's; 0/absent = none). Children are named ``conv{i}``/
    ``bn{i}`` as flax names them."""

    def __init__(self, in_features: int, ops: Sequence[dict],
                 bn_mode: str = "local", bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, axis=None):
        super().__init__()
        self.ops = tuple(dict(op) for op in ops)
        c = in_features
        for i, op in enumerate(self.ops):
            normed = op.get("norm", True)
            setattr(self, f"conv{i}", Conv(
                c, op["features"], op.get("kernel", 3), op.get("stride", 1),
                op.get("groups", 1),
                use_bias=bn_mode == "none" or not normed, dtype=dtype,
                padding=op.get("padding", "SAME")))
            if normed:
                setattr(self, f"bn{i}", _norm(
                    bn_mode, op["features"], momentum=bn_momentum,
                    epsilon=bn_epsilon, axis=axis))
            c = op["features"]
        self.out_features = c

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i, op in enumerate(self.ops):
            x = getattr(self, f"conv{i}")(x)
            if op.get("norm", True):
                x = _apply_norm(getattr(self, f"bn{i}"), x, train)
            if op.get("act", True):
                x = F.relu(x)
            if op.get("maxpool"):
                x = max_pool_same(x, 3, op["maxpool"])
        return x


class ClassifierHead(nn.Module):
    """(Conv 1x1 → BN → ReLU) → global average pool → Dense (f32). The
    pool of a bf16 map averages in f32 and rounds to bf16, as ``jnp.mean``
    does."""

    def __init__(self, in_features: int, num_classes: int,
                 conv_features: int | None = None, bn_mode: str = "local",
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, axis=None):
        super().__init__()
        c = in_features
        if conv_features is not None:
            self.conv = Conv(c, conv_features, 1,
                             use_bias=bn_mode == "none", dtype=dtype)
            self.bn = _norm(bn_mode, conv_features, momentum=bn_momentum,
                            epsilon=bn_epsilon, axis=axis)
            c = conv_features
        self.has_conv = conv_features is not None
        self.linear = Dense(c, num_classes)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.has_conv:
            x = F.relu(_apply_norm(self.bn, self.conv(x), train))
        x = torch.mean(x, (2, 3), dtype=torch.float32).to(x.dtype)
        return self.linear(x)
