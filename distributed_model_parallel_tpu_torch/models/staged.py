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

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

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
        subtree: ``{bn_name: {"mean": ..., "var": ...}}``, nested by
        module path as flax nests it ({} if none)."""
        state: dict = {}
        for path, m in unit_modules(self.units[i]):
            if isinstance(m, BatchNorm):
                subtree(state, path[:-1])[path[-1]] = {
                    "mean": m.running_mean, "var": m.running_var}
        return state

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
# The port dim of each JAX dim, per kind (the permutation _TO_JAX applies).
_JAX_DIMS = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


_LEAF_MODULES = (Conv, Dense, BatchNorm)


def subtree(tree: dict, path: tuple) -> dict:
    """The dict at module ``path`` of a nested tree, created as needed."""
    for name in path:
        tree = tree.setdefault(name, {})
    return tree


def unit_modules(unit: nn.Module, prefix: tuple = ()) -> list[tuple]:
    """``(path, module)`` for every Conv, Dense and BatchNorm of ``unit``,
    ``path`` its flax module path (child names, nested as flax nests
    submodules: a DLA tree's ``("left", "right", "conv0")``), in
    registration order. A child that is none of these and holds none of
    them has no JAX counterpart and raises."""
    out = []
    for name, m in unit.named_children():
        path = prefix + (name,)
        if isinstance(m, _LEAF_MODULES):
            out.append((path, m))
        elif any(isinstance(c, _LEAF_MODULES) for c in m.modules()):
            out.extend(unit_modules(m, path))
        else:
            raise TypeError(f"unit child {'.'.join(path)!r} of type "
                            f"{type(m).__name__} has no JAX counterpart")
    return out


def leaf_attrs(m: nn.Module) -> tuple:
    """``(JAX leaf, attribute, kind)`` of each parameter of a Conv, Dense
    or BatchNorm (a Conv's bias may be None)."""
    if isinstance(m, Conv):
        return (("kernel", "weight", "conv"), ("bias", "bias", None))
    if isinstance(m, Dense):
        return (("kernel", "weight", "dense"), ("bias", "bias", None))
    return (("scale", "weight", None), ("bias", "bias", None))


class Leaf(NamedTuple):
    """One leaf of a model in the JAX package's layout: its unit, flax
    module path and JAX leaf name, and the port's module, attribute and
    layout kind (a key of ``_TO_JAX``/``_FROM_JAX``). The one place that
    knows how a leaf at rest — whole, or a parametrization's slice such
    as FSDP's — maps to and from the JAX layout."""

    unit: int
    path: tuple
    name: str
    module: nn.Module
    attr: str
    kind: str | None

    @property
    def _gathered(self):
        """The parametrization gathering the leaf (FSDP's), or None."""
        if parametrize.is_parametrized(self.module, self.attr):
            return self.module.parametrizations[self.attr]
        return None

    @property
    def stored(self) -> torch.Tensor:
        """The tensor at rest, no gather: a parametrized leaf's
        ``original`` (this rank's slice), else the attribute."""
        plist = self._gathered
        return plist.original if plist is not None else getattr(
            self.module, self.attr)

    @property
    def shard_dim(self) -> int | None:
        """The port dim a parametrized leaf is gathered along, None for a
        whole leaf."""
        plist = self._gathered
        return plist[0].dim if plist is not None else None

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole port-layout tensor of the leaf's
        shape (the parametrization's ``right_inverse``), on the leaf's
        device."""
        full = full.to(self.stored.device)
        plist = self._gathered
        return plist[0].right_inverse(full) if plist is not None else full

    @property
    def jax_dims(self) -> tuple:
        """The port dim of each of the leaf's JAX dims."""
        return _JAX_DIMS.get(self.kind, tuple(range(self.stored.ndim)))

    def full_shape(self, n: int) -> tuple:
        """The whole leaf's port shape, when its shard dim (if any) is cut
        over ``n`` ranks (no value read)."""
        shape = list(self.stored.shape)
        if self.shard_dim is not None:
            shape[self.shard_dim] *= n
        return tuple(shape)

    @property
    def jax_shape(self) -> tuple:
        """A whole leaf's shape in the JAX layout (reads no value, so a
        ``meta`` model's leaves have one too)."""
        return tuple(_TO_JAX[self.kind](torch.empty(
            self.stored.shape, device="meta")).shape)

    def to_jax(self, t: torch.Tensor) -> np.ndarray:
        """A port-layout tensor of this leaf as a float32 JAX-layout
        numpy array."""
        return _TO_JAX[self.kind](t).detach().float().cpu().numpy().copy()

    def from_jax(self, a) -> torch.Tensor:
        """A JAX-layout array of this leaf as a float32 port-layout CPU
        tensor."""
        return torch.from_numpy(np.ascontiguousarray(
            _FROM_JAX[self.kind](np.asarray(a, np.float32))))

    @torch.no_grad()
    def load(self, a) -> None:
        """Copy a whole JAX-layout array into the leaf at rest."""
        self.stored.copy_(self.local(self.from_jax(a)))


def model_leaves(model: "StagedModel", *, state: bool = False
                 ) -> list[Leaf]:
    """Every parameter leaf of ``model`` that exists (a Conv may have no
    bias) or, with ``state``, every BatchNorm statistic (``mean``,
    ``var``), by unit and module path in registration order. Reads no
    parametrized value, so it gathers nothing."""
    out = []
    for u, unit in enumerate(model.units):
        for path, m in unit_modules(unit):
            if state:
                if isinstance(m, BatchNorm):
                    out += [Leaf(u, path, "mean", m, "running_mean", None),
                            Leaf(u, path, "var", m, "running_var", None)]
                continue
            for jname, attr, kind in leaf_attrs(m):
                if (parametrize.is_parametrized(m, attr)
                        or getattr(m, attr) is not None):
                    out.append(Leaf(u, path, jname, m, attr, kind))
    return out


def leaf_tree(model: "StagedModel", fn, *, state: bool = False) -> tuple:
    """Per unit, the JAX-layout nested dict holding ``fn(leaf)`` at every
    leaf of :func:`model_leaves`."""
    out = tuple({} for _ in model.units)
    for leaf in model_leaves(model, state=state):
        subtree(out[leaf.unit], leaf.path)[leaf.name] = fn(leaf)
    return out


@torch.no_grad()
def load_leaves(model: "StagedModel", params, state) -> None:
    """Copy whole JAX-layout ``params`` and ``state`` trees into
    ``model``'s leaves at rest, each in place on its own device: a fused
    bucket's views stay its views, an FSDP-sharded leaf takes this
    rank's slice. No collective; no module moves."""
    for tree, stats in ((params, False), (state, True)):
        for leaf in model_leaves(model, state=stats):
            leaf.load(tree_at(tree, leaf))


def tree_at(tree: Sequence, leaf: Leaf):
    """The value at ``leaf``'s place in a per-unit JAX-layout tree."""
    node = tree[leaf.unit]
    for name in leaf.path:
        node = node[name]
    return node[leaf.name]


def _leaf_slots(m: nn.Module) -> tuple[dict, dict | None]:
    """One module's {leaf: (tensor, kind)} for params and for
    batch_stats (None when it has none)."""
    params = {}
    for jname, attr, kind in leaf_attrs(m):
        t = getattr(m, attr)
        if t is not None:
            params[jname] = (t, kind)
    if not isinstance(m, BatchNorm):
        return params, None
    return params, {"mean": (m.running_mean, None),
                    "var": (m.running_var, None)}


def _unit_slots(unit: nn.Module) -> tuple[dict, dict]:
    """Unit modules by flax module path: ({name: {leaf: (tensor, kind)}}
    for params, the same for batch_stats), nested where flax nests
    (:func:`unit_modules`); a submodule without statistics is absent
    from batch_stats, as in flax."""
    params, state = {}, {}
    for path, m in unit_modules(unit):
        p, s = _leaf_slots(m)
        subtree(params, path[:-1])[path[-1]] = p
        if s is not None:
            subtree(state, path[:-1])[path[-1]] = s
    return params, state


def map_slots(fn, slots: dict) -> dict:
    """``slots`` with every ``(tensor, kind)`` leaf replaced by
    ``fn(tensor, kind)``, the nesting kept."""
    return {name: (fn(*v) if isinstance(v, tuple) else map_slots(fn, v))
            for name, v in slots.items()}


def slot_leaves(slots: dict) -> list[tuple]:
    """Every ``(tensor, kind)`` leaf of ``slots``, depth first in the
    slots' order."""
    out = []
    for v in slots.values():
        out.extend([v] if isinstance(v, tuple) else slot_leaves(v))
    return out


def _load(where: str, slots: dict, tree) -> None:
    tree = dict(tree)
    if set(tree) != set(slots):
        raise ValueError(f"{where}: the JAX tree has modules {sorted(tree)}, "
                         f"the port's unit {sorted(slots)}")
    for name, leaves in slots.items():
        if not all(isinstance(v, tuple) for v in leaves.values()):
            _load(f"{where}.{name}", leaves, tree[name])
            continue
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
    walking both sides by unit and module path (never by flat order:
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
            return map_slots(lambda t, kind: _TO_JAX[kind](
                t.grad if use_grad else t).detach().float().cpu().numpy()
                .copy(), slots)

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
