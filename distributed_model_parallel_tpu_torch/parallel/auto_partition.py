"""Cost-balanced pipeline stage boundaries — the port of
``distributed_model_parallel_tpu/parallel/auto_partition.py``.

The JAX package costs each unit with XLA's ``cost_analysis`` of the
unit's compiled forward and cuts the unit sequence by an exact minimax
DP. The port counts the same FLOPs itself, so that it cuts where the JAX
package cuts: counting only convolutions and matmuls (as
``torch.utils.flop_counter.FlopCounterMode`` does) gives other cuts at
every stage count for MobileNetV2, because XLA also counts BatchNorm,
activations and residual adds (1.2-15.6 % of a unit, most in the early,
wide units), and counts a convolution's taps over the input, not over
its zero padding. :func:`unit_costs` runs each unit once on the ``meta``
device (shapes only) and adds, per operation, what XLA counts:

* convolution: ``2 · N · C_out · C_in/groups · Π_d taps_d``, where
  ``taps_d`` sums, over the outputs along spatial dim d, the kernel taps
  that land inside the input (SAME padding's taps are not counted);
* dense: ``2 · rows · in · out`` plus one add per output (the bias);
* BatchNorm in training: ``6`` per element plus ``6`` per channel (the
  two moments, normalize, scale and shift; the running averages are not
  part of a unit's output, and XLA drops them);
* ReLU and a residual add: 1 per element; a mean: 1 per input element;
* a max-pool (XLA's reduce-window): window − 1 comparisons per output
  element, whatever the padding (ResNet's ImageNet stem: 8 for its 3x3
  window).

The per-unit counts equal JAX's ``unit_costs`` to XLA's float32
rounding (``tests/test_torch_auto_partition.py``), except where XLA's CPU
cost analysis counts a reduction over a length that is not a power of two
as a few elements longer (BN statistics over 112/56/28/14/7 px maps:
ResNet-50's ImageNet layout, up to 0.26% of a unit), which the cuts do
not notice.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from distributed_model_parallel_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
)
from distributed_model_parallel_tpu_torch.models.staged import StagedModel

__all__ = ["auto_boundaries", "cost_balanced_boundaries",
           "microbatch_rows", "unit_costs"]


def conv_taps(size: int, kernel: int, stride: int,
              pads: tuple[int, int] | None = None) -> int:
    """Kernel taps inside the input, summed over the outputs of one
    spatial dim under ``pads`` (low, high; default XLA's SAME padding)."""
    if pads is None:
        out = -(-size // stride)
        lo = max((out - 1) * stride + kernel - size, 0) // 2
    else:
        lo = pads[0]
        out = (size + pads[0] + pads[1] - kernel) // stride + 1
    return sum(min(o * stride - lo + kernel, size) - max(o * stride - lo, 0)
               for o in range(out))


_ELEMENTWISE = (F.relu, torch.relu, torch.Tensor.relu, torch.add,
                torch.Tensor.add, torch.Tensor.__add__)
_REDUCTIONS = (torch.mean, torch.Tensor.mean)
_POOLS = (F.max_pool2d,)


class _Count(TorchFunctionMode):
    """FLOPs of the functional operations outside the counted modules."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.inside = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside:
            if func in _ELEMENTWISE:
                self.flops += out.numel()
            elif func in _REDUCTIONS:
                self.flops += args[0].numel()
            elif func in _POOLS:
                window = args[1] if len(args) > 1 else kwargs["kernel_size"]
                self.flops += (window * window - 1) * out.numel()
        return out


def _module_flops(m, x: torch.Tensor, y: torch.Tensor) -> float:
    if isinstance(m, Conv):
        n, cin, h, w = x.shape
        ph, pw = m.pads(h, w)
        return (2.0 * n * y.shape[1] * (cin // m.groups)
                * conv_taps(h, m.kernel, m.stride, ph)
                * conv_taps(w, m.kernel, m.stride, pw))
    if isinstance(m, BatchNorm):
        return 6.0 * y.numel() + 6.0 * y.shape[1]
    return 2.0 * x.numel() * m.weight.shape[0] + y.numel()       # Dense


def meta_copy(model: StagedModel) -> StagedModel:
    """``model`` on the ``meta`` device (shapes only), its BatchNorms
    without a process group (a synchronized BN's group is not copied)."""
    memo = {id(m.group): None for m in model.modules()
            if isinstance(m, BatchNorm) and m.group is not None}
    return copy.deepcopy(model, memo).to("meta")


def unit_costs(model: StagedModel,
               sample_shape: Sequence[int]) -> list[float]:
    """Per-unit cost of one training forward at ``sample_shape`` (NHWC),
    in XLA's FLOP count: one float ``>= 1.0`` per unit, in unit order.
    Each unit runs on a ``meta`` copy of the model, at its true input
    shape."""
    meta = meta_copy(model)
    n, h, w, c = sample_shape
    x = torch.empty(n, c, h, w, device="meta")
    costs = []
    for unit in meta.units:
        count = _Count()

        def enter(_m, _inp):
            count.inside += 1

        def leave(m, inp, out):
            count.inside -= 1
            count.flops += _module_flops(m, inp[0], out)

        hooks = []
        for m in unit.modules():
            if isinstance(m, (Conv, BatchNorm, Dense)):
                hooks += [m.register_forward_pre_hook(enter),
                          m.register_forward_hook(leave)]
        with count:
            x = unit(x, True)
        for hook in hooks:
            hook.remove()
        costs.append(max(count.flops, 1.0))
    return costs


def cost_balanced_boundaries(costs: Sequence[float],
                             num_stages: int) -> list[int]:
    """Contiguous minimax partition of ``costs`` into ``num_stages``
    stages: boundaries (length ``num_stages + 1``, ``b[0] = 0``, ``b[-1] =
    len(costs)``, strictly increasing). Exact O(S·N²) DP; among minimax
    ties the latest cut wins (``<=``), pushing extra units onto the
    earliest stages, as ``balanced_boundaries`` does."""
    n = len(costs)
    if not (1 <= num_stages <= n):
        raise ValueError(f"cannot split {n} units into {num_stages} stages")
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    best = np.full((num_stages + 1, n + 1), np.inf)
    cut = np.zeros((num_stages + 1, n + 1), np.int64)
    best[0][0] = 0.0
    for s in range(1, num_stages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(best[s - 1][j], prefix[i] - prefix[j])
                if v <= best[s][i]:
                    best[s][i] = v
                    cut[s][i] = j
    bounds = [n]
    for s in range(num_stages, 0, -1):
        bounds.append(int(cut[s][bounds[-1]]))
    return bounds[::-1]


def auto_boundaries(model: StagedModel, sample_shape: Sequence[int],
                    num_stages: int) -> list[int]:
    """Unit costs at ``sample_shape`` → the minimax stage boundaries."""
    return cost_balanced_boundaries(unit_costs(model, sample_shape),
                                    num_stages)


def microbatch_rows(batch_size: int, num_microbatches: int,
                    data_shards: int = 1) -> int:
    """Rows of one microbatch as a stage sees it — the batch
    ``auto_boundaries`` should cost at: the global batch over the data
    shards, then over the microbatches."""
    return max(1, batch_size // (max(1, data_shards)
                                 * max(1, num_microbatches)))
