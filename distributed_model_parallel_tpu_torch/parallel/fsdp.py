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
  momentum see only slices); each use of the parameter all-gathers it
  along its shard dimension (:class:`AllGatherShard`), and the gradient
  comes back by ``reduce_scatter_mean`` along the same dimension. The
  gathered weights live until their unit's backward has run;
* :class:`FsdpReducer` — after the backward: the mean all-reduce of the
  replicated leaves' gradients and the global-norm clip over slices and
  replicated leaves.

The step keeps the gspmd strategy's semantics (BatchNorm over the global
batch, the global batch's augmentation draws); the sharding changes where
the collectives run, not the math.
"""

from __future__ import annotations

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
    all_reduce_,
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


class AllGatherShard(torch.autograd.Function):
    """A parameter's slices concatenated along ``dim`` over ``group``;
    the backward hands each rank its slice of the mean gradient
    (``reduce_scatter_mean`` along ``dim``)."""

    @staticmethod
    def forward(ctx, shard, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_concat(shard, group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_mean(g, ctx.group, axis=ctx.dim), None, None


class _Gathered(nn.Module):
    """The parametrization of a sharded parameter: ``original`` is this
    rank's slice; reading the parameter gathers it (channels-last again
    for a conv kernel, the layout the replicated model keeps)."""

    def __init__(self, dim: int, group, n: int, rank: int,
                 channels_last: bool):
        super().__init__()
        self.dim, self.group, self.n, self.rank = dim, group, n, rank
        self.channels_last = channels_last

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        full = AllGatherShard.apply(shard, self.dim, self.group)
        if self.channels_last:
            full = full.contiguous(memory_format=torch.channels_last)
        return full

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(self.n, self.dim)[self.rank].clone()


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
    weights. At one rank nothing is sharded."""
    n, group = spec.num_data, spec.group
    rank = spec.data_index
    out = []
    if n == 1:
        return out
    for leaf in model_leaves(model):
        d = leaf_spec(jax_shape(leaf.stored, leaf.kind), n, min_size)
        if d is None:
            continue
        dim = d if leaf.kind is None else _PORT_DIM[leaf.kind][d]
        parametrize.register_parametrization(
            leaf.module, leaf.attr, _Gathered(dim, group, n, rank,
                                              leaf.kind == "conv"),
            unsafe=True)
        out.append((leaf.module, leaf.attr, dim))
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
    bucketed, in place; then optax's ``clip_by_global_norm`` over the
    whole tree when ``clip`` is set — the squared sums of the slices are
    all-reduced, the replicated leaves' added once."""

    def __init__(self, model: nn.Module, group, clip: float | None = None):
        sharded = {id(p) for p in sharded_parameters(model)}
        self.params = list(model.parameters())
        self.sharded = [p for p in self.params if id(p) in sharded]
        self.replicated = [p for p in self.params if id(p) not in sharded]
        self.group = group
        self.clip = clip

    @torch.no_grad()
    def finish(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.replicated]
        if grads and world_size(self.group) > 1:
            for g, r in zip(grads, bucketed_psum(grads, self.group)):
                g.copy_(r)
        if self.clip is not None:
            sq = sum(p.grad.float().pow(2).sum() for p in self.sharded)
            sq = torch.as_tensor(sq, dtype=torch.float32,
                                 device=self.params[0].device)
            all_reduce_(sq, self.group, kind="clip_norm")
            norm = torch.sqrt(sq + sum(g.float().pow(2).sum()
                                       for g in grads))
            keep = norm < self.clip
            for p in self.params:
                p.grad.copy_(torch.where(
                    keep, p.grad, p.grad / norm.to(p.grad.dtype) * self.clip))
