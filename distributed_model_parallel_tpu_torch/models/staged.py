"""Stage-able model representation — the port of
``distributed_model_parallel_tpu/models/staged.py``.

A model is an ordered sequence of *units* (``nn.Module``s taking
``(x, train)``); a stage partition is a list of unit-index boundaries.
The JAX package threads parameter and state tuples through pure
functions; here they live in the units, and ``apply*`` return the BN
running statistics (the JAX ``batch_stats``) as the new state, updated in
place under ``train=True``.

The public functions take and return the JAX package's NHWC layout; the
units run NCHW views of it (a permute, no copy), whose memory is
channels-last.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from distributed_model_parallel_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.ndim == 4 else x


class StagedModel(nn.Module):
    """An ordered sequence of unit modules with the JAX ``StagedModel``'s
    apply functions."""

    def __init__(self, units: Sequence[nn.Module], name: str = "staged"):
        super().__init__()
        self.units = nn.ModuleList(units)
        self.name = name

    @property
    def num_units(self) -> int:
        return len(self.units)

    def unit_state(self, i: int) -> dict:
        """Unit i's BN running statistics as the JAX ``batch_stats``
        subtree: ``{bn_name: {"mean": ..., "var": ...}}`` ({} if none)."""
        return {name: {"mean": m.running_mean, "var": m.running_var}
                for name, m in self.units[i].named_modules()
                if isinstance(m, BatchNorm)}

    def state(self) -> tuple:
        return tuple(self.unit_state(i) for i in range(self.num_units))

    def apply_unit(self, i: int, x: torch.Tensor, *, train: bool):
        """Apply unit i to NHWC ``x``. Returns (y, new_state_i)."""
        return (_to_nhwc(self.units[i](_to_nchw(x), train)),
                self.unit_state(i))

    def apply_range(self, x: torch.Tensor, lo: int, hi: int, *,
                    train: bool):
        """Apply units [lo, hi) to NHWC ``x``. Returns (y,
        new_state_slice)."""
        x = _to_nchw(x)
        for i in range(lo, hi):
            x = self.units[i](x, train)
        return _to_nhwc(x), tuple(self.unit_state(i) for i in range(lo, hi))

    def apply(self, x: torch.Tensor, *, train: bool):
        """Full forward of NHWC images. Returns (logits, new_state)."""
        return self.apply_range(x, 0, self.num_units, train=train)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.apply(x, train=train)[0]

    def reset_parameters(self, seed: int) -> None:
        """Fresh weights from ``seed`` (flax's default initializers: lecun
        normal kernels, zero biases, unit BN scales, fresh statistics).
        The port's own draws: not the bits of the JAX package's init."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)


# -- the weight carrier: the JAX package's staged trees <-> the units --------

# How a JAX leaf maps onto a port tensor: conv kernels are
# [kH, kW, I/g, O] against [O, I/g, kH, kW], Dense kernels [I, O] against
# [O, I]; everything else keeps its shape.
_FROM_JAX = {"conv": lambda a: a.transpose(3, 2, 0, 1),
             "dense": lambda a: a.T, None: lambda a: a}
_TO_JAX = {"conv": lambda t: t.permute(2, 3, 1, 0),
           "dense": lambda t: t.t(), None: lambda t: t}


def _unit_slots(unit: nn.Module) -> tuple[dict, dict]:
    """Unit children by flax module name: ({name: {leaf: (tensor, kind)}}
    for params, the same for batch_stats)."""
    params, state = {}, {}
    for name, m in unit.named_children():
        if isinstance(m, Conv):
            params[name] = {"kernel": (m.weight, "conv")}
            if m.bias is not None:
                params[name]["bias"] = (m.bias, None)
        elif isinstance(m, Dense):
            params[name] = {"kernel": (m.weight, "dense"),
                            "bias": (m.bias, None)}
        elif isinstance(m, BatchNorm):
            params[name] = {"scale": (m.weight, None),
                            "bias": (m.bias, None)}
            state[name] = {"mean": (m.running_mean, None),
                           "var": (m.running_var, None)}
        else:
            raise TypeError(f"unit child {name!r} of type "
                            f"{type(m).__name__} has no JAX counterpart")
    return params, state


def _load(where: str, slots: dict, tree) -> None:
    tree = dict(tree)
    if set(tree) != set(slots):
        raise ValueError(f"{where}: the JAX tree has modules {sorted(tree)}, "
                         f"the port's unit {sorted(slots)}")
    for name, leaves in slots.items():
        if set(tree[name]) != set(leaves):
            raise ValueError(f"{where}.{name}: the JAX tree has leaves "
                             f"{sorted(tree[name])}, the port "
                             f"{sorted(leaves)}")
        for leaf, (t, kind) in leaves.items():
            a = _FROM_JAX[kind](np.asarray(tree[name][leaf], np.float32))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"{where}.{name}.{leaf}: JAX shape "
                    f"{np.shape(tree[name][leaf])} maps to {tuple(a.shape)}"
                    f", the port's {name}.{leaf} is {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def params_from_jax(model: StagedModel, params: Sequence, state: Sequence,
                    device="cuda") -> StagedModel:
    """Load the JAX package's staged trees — ``params`` and ``state``
    (``batch_stats``), tuples over units of dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, ...)`` — into ``model`` on ``device``,
    walking both sides by unit and module name (never by flat order:
    ``jax.tree.leaves`` sorts dict keys). Every pairing is shape-checked;
    a mismatch raises with both names. Values are copied into the
    existing tensors, so views (e.g. the fused optimizer's buckets) stay
    bound. Returns ``model``."""
    from distributed_model_parallel_tpu_torch.models.transformer import (
        resolve_device,
    )

    model.to(resolve_device(device))
    if len(params) != model.num_units or len(state) != model.num_units:
        raise ValueError(f"the JAX trees have {len(params)} / {len(state)} "
                         f"units, the port's {model.name} "
                         f"{model.num_units}")
    for i, unit in enumerate(model.units):
        p_slots, s_slots = _unit_slots(unit)
        _load(f"unit {i} ({type(unit).__name__}) params", p_slots, params[i])
        _load(f"unit {i} ({type(unit).__name__}) state", s_slots, state[i])
    return model


def params_to_jax(model: StagedModel, *, grads: bool = False
                  ) -> tuple[tuple, tuple]:
    """``(params, state)`` in the JAX package's layout as float32 numpy
    trees; with ``grads=True`` the parameters' ``.grad`` in place of the
    parameters."""
    params, state = [], []
    for unit in model.units:
        p_slots, s_slots = _unit_slots(unit)

        def tree(slots, use_grad):
            return {n: {k: _TO_JAX[kind](t.grad if use_grad else t).detach()
                        .float().cpu().numpy().copy()
                        for k, (t, kind) in leaves.items()}
                    for n, leaves in slots.items()}

        params.append(tree(p_slots, grads))
        state.append(tree(s_slots, False))
    return tuple(params), tuple(state)


def balanced_boundaries(num_units: int, num_stages: int) -> list[int]:
    """Split ``num_units`` units into ``num_stages`` contiguous stages:
    boundaries ``b`` with b[0] = 0, b[-1] = num_units; the remainder goes
    to the earliest stages."""
    if not (1 <= num_stages <= num_units):
        raise ValueError(
            f"cannot split {num_units} units into {num_stages} stages")
    base, rem = divmod(num_units, num_stages)
    bounds = [0]
    for s in range(num_stages):
        bounds.append(bounds[-1] + base + (1 if s < rem else 0))
    return bounds


def stage_slices(num_units: int, num_stages: int,
                 boundaries: Sequence[int] | None = None
                 ) -> list[tuple[int, int]]:
    """(lo, hi) unit ranges per stage, honoring explicit boundaries."""
    if boundaries is None:
        b = balanced_boundaries(num_units, num_stages)
    else:
        b = list(boundaries)
        if b[0] != 0 or b[-1] != num_units or len(b) != num_stages + 1:
            raise ValueError(f"boundaries {b} invalid for {num_units} units "
                             f"/ {num_stages} stages")
        if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"boundaries {b} must be strictly increasing")
    return [(b[s], b[s + 1]) for s in range(num_stages)]


def partition_tree(tree: tuple, slices: Sequence[tuple[int, int]]
                   ) -> list[tuple]:
    """Split a per-unit tuple into per-stage tuples."""
    return [tuple(tree[lo:hi]) for lo, hi in slices]


def merge_tree(parts: Sequence[tuple]) -> tuple:
    """Inverse of :func:`partition_tree`."""
    out: list = []
    for p in parts:
        out.extend(p)
    return tuple(out)
