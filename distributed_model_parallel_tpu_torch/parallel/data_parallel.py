"""DataParallel: scatter → replicate → parallel apply → gather — the port
of ``distributed_model_parallel_tpu/parallel/data_parallel.py``.

The reference's ``nn.DataParallel`` splits the batch over the cards of one
process, copies the module to each, runs one thread per replica and
gathers the outputs; the JAX package spells the four phases as
shardings. Here each replica is a rank of the process group (one process
per card), so the four phases are a rank's rows of the batch, a broadcast
from rank 0, the apply itself, and an all-gather in rank order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from distributed_model_parallel_tpu_torch.mesh import MeshSpec
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
    broadcast_,
    tree_flatten,
    tree_map,
)


def scatter(batch: Any, spec: MeshSpec) -> Any:
    """This rank's rows (dim 0) of every tensor of ``batch``
    (comm.scatter)."""
    return tree_map(lambda x: x[spec.rows(x.shape[0])], batch)


@torch.no_grad()
def _broadcast_coalesced(tensors: list, spec: MeshSpec) -> None:
    """Rank 0's values into ``tensors`` in place: one broadcast per dtype
    over their concatenation (broadcast_coalesced)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        broadcast_(flat, spec.group, kind="replicate")
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def replicate(tree: Any, spec: MeshSpec) -> Any:
    """Rank 0's copy on every rank (broadcast_coalesced): a module's
    parameters and buffers are overwritten in place and the module is
    returned; a tree of tensors is returned as new tensors."""
    if isinstance(tree, nn.Module):
        _broadcast_coalesced([*tree.parameters(), *tree.buffers()], spec)
        return tree
    leaves, rebuild = tree_flatten(tree)
    leaves = [x.clone() for x in leaves]
    _broadcast_coalesced(leaves, spec)
    return rebuild(leaves)


def gather(x: torch.Tensor, spec: MeshSpec) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order
    (comm.gather; here every rank receives it)."""
    return all_gather_concat(x, spec.group)


def parallel_apply(fn: Callable, spec: MeshSpec) -> Callable:
    """``apply(params, shard)`` of one replica of DataParallel's threaded
    ``parallel_apply``: each replica is a rank in its own process, so a
    rank's apply is ``fn`` itself on its shard (the other replicas run on
    the other ranks of ``spec``)."""
    return fn


def data_parallel_apply(fn: Callable, params: Any, batch: torch.Tensor,
                        spec: MeshSpec) -> torch.Tensor:
    """The full DataParallel.forward: scatter → replicate → apply →
    gather."""
    p = replicate(params, spec)
    return gather(parallel_apply(fn, spec)(p, scatter(batch, spec)), spec)
