"""Fully-sharded data parallelism (FSDP, ZeRO stage 3) — the port of
``distributed_model_parallel_tpu/parallel/fsdp.py``.

The JAX package annotates each parameter and optimizer-state leaf with a
sharding that splits its largest divisible dimension over the data axis,
and XLA's partitioner inserts the all-gather before each use and the
reduce-scatter behind each gradient. The port does the same by hand:

* :func:`leaf_spec` / :func:`tree_shardings` — the JAX rule, per leaf
  shape (in the JAX package's layout): shard the largest N-divisible
  dimension, ties to the last; leaves under ``max(min_size, N)`` stay
  replicated. A spec is that dimension, or None;
* :func:`shard_pytree` — a rank's slices of a tree;
* :func:`shard_model` — at rest each rank keeps its slice of every sharded
  parameter (a parametrization's ``original``, so the optimizer and its
  state see only slices); each use of the parameter all-gathers it
  along its shard dimension (:class:`AllGatherShard`), and the gradient
  comes back by ``reduce_scatter_mean`` along the same dimension. Only
  the unit being computed holds its whole weights, as XLA schedules the
  JAX package's gathers: while a unit runs forward, autograd saves in
  place of each gathered weight (or of its cast to the compute type, or
  a view of it) a note of its slice (:func:`regather_in_backward`), so
  the whole weight
  is freed when the unit is done, and the backward gathers it again
  when the unit's gradient needs it (the same gathers in the same order
  on every rank). The model's :class:`GatherLedger` counts the whole
  weights alive;
* :class:`FsdpReducer` — after the backward: the mean all-reduce of the
  replicated leaves' gradients (the optimizer clips, over the slices and
  the replicated leaves, by its ``adaptive.LeafLayout`` of each), and
  the step's reduction time.

The step keeps the gspmd strategy's semantics (BatchNorm over the global
batch, the global batch's augmentation draws); the sharding changes where
the collectives run, not the math.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from distributed_model_parallel_tpu_torch.mesh import MeshSpec
from distributed_model_parallel_tpu_torch.models.staged import (
    StagedModel,
    leaf_tree,
    model_leaves,
)
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
    bucketed_psum,
    reduce_scatter_mean,
    tree_map,
    world_size,
)

# Leaves smaller than this stay replicated: sharding a 10-element bias
# over 8 ranks saves nothing and costs a collective.
DEFAULT_MIN_SHARD_SIZE = 1024

# Port dim of each JAX dim, per leaf kind: conv kernels are [kH, kW, I, O]
# in JAX and [O, I, kH, kW] here, Dense kernels [I, O] and [O, I].
_PORT_DIM = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


def leaf_spec(shape, n: int,
              min_size: int = DEFAULT_MIN_SHARD_SIZE) -> int | None:
    """The dimension of a leaf of ``shape`` that FSDP shards over ``n``
    ranks: the largest one divisible by ``n``, ties to the last; None
    (replicated) for a leaf under ``max(min_size, n)`` elements or with no
    divisible dimension."""
    shape = tuple(shape)
    if int(np.prod(shape, dtype=np.int64)) < max(min_size, n):
        return None
    best = None
    for d in range(len(shape)):
        if shape[d] % n == 0 and (best is None or shape[d] >= shape[best]):
            best = d
    return best


def tree_shardings(tree: Any, n: int,
                   min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Any:
    """:func:`leaf_spec` of every leaf of ``tree`` (arrays or tensors)."""
    return tree_map(lambda x: leaf_spec(np.shape(x), n, min_size), tree)


def shard_pytree(tree: Any, n: int, rank: int,
                 min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Any:
    """Rank ``rank``'s part of every leaf of ``tree``: slice ``rank`` of
    ``n`` along the leaf's shard dimension, or the whole leaf when it
    stays replicated (numpy leaves give numpy slices, tensors views)."""
    def one(x):
        d = leaf_spec(np.shape(x), n, min_size)
        if d is None:
            return x
        size = np.shape(x)[d] // n
        index = [slice(None)] * len(np.shape(x))
        index[d] = slice(rank * size, (rank + 1) * size)
        return x[tuple(index)]

    return tree_map(one, tree)


def _mark(cuda: bool):
    """A timing mark: a recorded CUDA event on the card, the host clock on
    the CPU."""
    if cuda:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_us(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e6
    return start.elapsed_time(end) * 1e3


class GatherLedger:
    """One sharded model's accounts: the whole (gathered) weights alive
    now and at most since the last reset, in count and bytes, and the
    ``(start, end)`` marks of the reductions since the reducer last
    collected them."""

    def __init__(self):
        self.now = self.peak = self.bytes = self.peak_bytes = 0
        self.reductions: list = []

    def track(self, full: torch.Tensor) -> None:
        """Count ``full`` alive until it is freed."""
        nbytes = full.numel() * full.element_size()
        self.now += 1
        self.bytes += nbytes
        self.peak = max(self.peak, self.now)
        self.peak_bytes = max(self.peak_bytes, self.bytes)
        weakref.finalize(full, self._freed, nbytes)

    def _freed(self, nbytes: int) -> None:
        self.now -= 1
        self.bytes -= nbytes

    def stats(self, reset: bool = False) -> dict:
        """The live counts; ``reset`` starts the peaks at now."""
        out = dict(now=self.now, peak=self.peak, bytes=self.bytes,
                   peak_bytes=self.peak_bytes)
        if reset:
            self.peak, self.peak_bytes = self.now, self.bytes
        return out


class AllGatherShard(torch.autograd.Function):
    """A parameter's slices concatenated along ``dim`` over ``group``;
    the backward hands each rank its slice of the mean gradient
    (``reduce_scatter_mean`` along ``dim``), its time marked in
    ``ledger``."""

    @staticmethod
    def forward(ctx, shard, dim: int, group, ledger: GatherLedger):
        ctx.dim, ctx.group, ctx.ledger = dim, group, ledger
        return all_gather_concat(shard, group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        start = _mark(g.is_cuda)
        out = reduce_scatter_mean(g, ctx.group, axis=ctx.dim)
        ctx.ledger.reductions.append((start, _mark(g.is_cuda)))
        return out, None, None, None


# Per unit forward in progress: grad_fn of each gathered weight -> (slice,
# its parametrization), read by the saved-tensor pack hook.
_gathered_fns: list[dict] = []


class _Gathered(nn.Module):
    """The parametrization of a sharded parameter: ``original`` is this
    rank's slice; reading the parameter gathers it (channels-last again
    for a conv kernel, the layout the replicated model keeps)."""

    def __init__(self, dim: int, group, n: int, rank: int,
                 channels_last: bool, ledger: GatherLedger):
        super().__init__()
        self.dim, self.group, self.n, self.rank = dim, group, n, rank
        self.channels_last = channels_last
        self.ledger = ledger

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        full = AllGatherShard.apply(shard, self.dim, self.group, self.ledger)
        if self.channels_last:
            full = full.contiguous(memory_format=torch.channels_last)
        self.ledger.track(full)
        if _gathered_fns and full.grad_fn is not None:
            _gathered_fns[-1][id(full.grad_fn)] = (shard, self)
        return full

    @torch.no_grad()
    def regather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole weight again, for the backward (no autograd)."""
        full = all_gather_concat(shard.detach(), self.group, axis=self.dim)
        if self.channels_last:
            full = full.contiguous(memory_format=torch.channels_last)
        self.ledger.track(full)
        return full

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(self.n, self.dim)[self.rank].clone()


class _Regather:
    """What autograd keeps of a gathered weight it saved: the slice, the
    parametrization that gathers it, the type it was cast to and, for a
    view of the weight (a Dense kernel's transpose), the view's geometry."""

    def __init__(self, shard, gathered: _Gathered, dtype=None, view=None):
        self.shard, self.gathered = shard, gathered
        self.dtype, self.view = dtype, view

    def value(self) -> torch.Tensor:
        full = self.gathered.regather(self.shard)
        if self.view is not None:
            full = full.as_strided(*self.view)
        return full if self.dtype is None else full.to(self.dtype)


def _pack(x: torch.Tensor):
    known = _gathered_fns[-1]
    fn = x.grad_fn
    if fn is None:
        return x
    if id(fn) in known:
        return _Regather(*known[id(fn)])
    base = x._base
    if base is not None and base.grad_fn is not None \
            and id(base.grad_fn) in known:
        return _Regather(*known[id(base.grad_fn)], view=(
            x.size(), x.stride(), x.storage_offset()))
    if type(fn).__name__.startswith("ToCopyBackward"):
        src = fn.next_functions[0][0]
        if id(src) in known:
            return _Regather(*known[id(src)], dtype=x.dtype)
    return x


def _unpack(x):
    return x.value() if isinstance(x, _Regather) else x


@contextlib.contextmanager
def regather_in_backward():
    """While a unit runs forward: autograd saves a note of the slice in
    place of each weight gathered here (or its cast, or a view of it),
    and the backward gathers the weight again from it."""
    _gathered_fns.append({})
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield
    finally:
        _gathered_fns.pop()


def _regathering(forward):
    def run(*args, **kwargs):
        with regather_in_backward():
            return forward(*args, **kwargs)
    return run


def jax_shape(t: torch.Tensor, kind: str | None) -> tuple:
    """The shape of a port parameter in the JAX package's layout."""
    if kind is None:
        return tuple(t.shape)
    return tuple(t.shape[d] for d in _PORT_DIM[kind])


def shard_model(model: StagedModel, spec: MeshSpec,
                min_size: int = DEFAULT_MIN_SHARD_SIZE) -> list[tuple]:
    """Shard ``model``'s parameters over ``spec``'s data axis in place, by
    :func:`leaf_spec` of each leaf's JAX shape (so rank r keeps the JAX
    package's shard r). Returns ``(module, name, port dim)`` per sharded
    parameter. Every rank must call, with the same (replicated)
    weights. Each unit holding a sharded parameter runs its forward
    under :func:`regather_in_backward`; ``model.gather_ledger`` (a
    :class:`GatherLedger`) counts its whole weights alive and times its
    reductions. At one rank nothing is sharded."""
    n, group = spec.num_data, spec.group
    rank = spec.data_index
    out = []
    if n == 1:
        return out
    units = set()
    model.gather_ledger = ledger = GatherLedger()
    for leaf in model_leaves(model):
        d = leaf_spec(jax_shape(leaf.stored, leaf.kind), n, min_size)
        if d is None:
            continue
        dim = d if leaf.kind is None else _PORT_DIM[leaf.kind][d]
        parametrize.register_parametrization(
            leaf.module, leaf.attr, _Gathered(dim, group, n, rank,
                                              leaf.kind == "conv", ledger),
            unsafe=True)
        out.append((leaf.module, leaf.attr, dim))
        units.add(leaf.unit)
    for u in sorted(units):
        unit = model.units[u]
        unit.forward = _regathering(unit.forward)
    return out


def local_params_to_jax(model: StagedModel) -> tuple:
    """This rank's parameters at rest in the JAX package's layout (float32
    numpy, per unit and module): the slice of each sharded leaf, the whole
    of each replicated one. No collective."""
    return leaf_tree(model, lambda leaf: leaf.to_jax(leaf.stored))


@torch.no_grad()
def sharded_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The slices :func:`shard_model` left as parameters."""
    return [p for name, p in model.named_parameters()
            if name.endswith(".original")]


def resident_bytes(model: nn.Module, optimizer=None) -> dict:
    """Bytes this rank holds at rest: parameters (slices and replicated
    leaves) and, with ``optimizer``, its momentum traces."""
    params = list(model.parameters())
    out = {"params": sum(p.numel() * p.element_size() for p in params)}
    if optimizer is not None:
        moms = [optimizer.momentum_buffer(i) for i in range(len(params))]
        out["momentum"] = sum(m.numel() * m.element_size()
                              for m in moms if m is not None)
    return out


class FsdpReducer:
    """The gradient reduction the FSDP step runs after its backward (the
    sharded leaves' gradients were reduce-scattered by the backward
    itself): the mean over ranks of the replicated leaves' gradients,
    bucketed, in place. The optimizer clips, once per update under
    accumulation, over the slices and the replicated leaves
    (``optim.clip_by_global_norm_`` with each parameter's
    ``adaptive.LeafLayout``). The step's reduction time — the backward's
    reduce-scatters and this all-reduce, each timed alone (CUDA events on
    the card, the host clock on the CPU) and added — is kept per step and
    read by :meth:`take_times_us`."""

    def __init__(self, model: nn.Module, group):
        sharded = {id(p) for p in sharded_parameters(model)}
        self.params = list(model.parameters())
        self.replicated = [p for p in self.params if id(p) not in sharded]
        self.group = group
        self.ledger = getattr(model, "gather_ledger", None) or GatherLedger()
        self.times = collections.deque(maxlen=4096)

    @torch.no_grad()
    def finish(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.replicated]
        marks = self.ledger.reductions
        if grads and world_size(self.group) > 1:
            start = _mark(grads[0].is_cuda)
            for g, r in zip(grads, bucketed_psum(grads, self.group)):
                g.copy_(r)
            marks.append((start, _mark(grads[0].is_cuda)))
        self.times.append(list(marks))
        marks.clear()

    def take_times_us(self) -> list[float]:
        """µs of each step's reductions since the last call (waits for the
        card)."""
        out = [sum(_elapsed_us(a, b) for a, b in step) for step in self.times]
        self.times.clear()
        return out
