"""A small staged CNN for fast tests and CPU smoke runs — the port of
``distributed_model_parallel_tpu/models/tinycnn.py``."""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.models.layers import (
    ClassifierHead,
    ConvUnit,
)
from distributed_model_parallel_tpu_torch.models.staged import StagedModel


def build_tinycnn(num_classes: int = 10, *, bn_mode: str = "local",
                  bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                  dtype: torch.dtype = torch.float32, width: int = 16,
                  depth: int = 4, in_channels: int = 3,
                  axis=None) -> StagedModel:
    """stem + ``depth`` conv units (stride 2 on the middle one) + head;
    ``axis``: the process group of ``bn_mode="sync"``."""
    common = dict(bn_mode=bn_mode, bn_momentum=bn_momentum,
                  bn_epsilon=bn_epsilon, dtype=dtype, axis=axis)
    units = [ConvUnit(in_channels, ({"features": width, "kernel": 3,
                                     "stride": 1},), **common)]
    for i in range(depth):
        stride = 2 if i == depth // 2 else 1
        units.append(ConvUnit(width, ({"features": width, "kernel": 3,
                                       "stride": stride},), **common))
    units.append(ClassifierHead(width, num_classes, conv_features=None,
                                **common))
    return StagedModel(units, name="tinycnn")
