"""Explicit ring all-reduce, the DDP Reducer's wire algorithm — the port
of ``distributed_model_parallel_tpu/ops/ring_reduce.py``.

The classic bandwidth-optimal ring over the ranks of a process group:
N − 1 reduce-scatter hops, then N − 1 all-gather hops, each carrying 1/N
of the zero-padded flat buffer to the right neighbour (group rank i sends
to i + 1 and receives from i − 1), built on ``collectives.exchange``, one
``batch_isend_irecv`` a hop. The chunk convention is the JAX package's
(``lax.psum_scatter(..., tiled=True)``'s): rank i ends the reduce-scatter
owning reduced chunk i. Each chunk is summed on one rank, in ring order,
and copied to the others, so every rank ends with the same bits.

Every rank of the group must call; the hops block. Without a process
group (or at one rank) each function returns its input's value. Hops are
counted under ``ring_send``/``ring_recv`` in ``collectives.calls``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.ops.collectives import (
    bucketed_psum,
    exchange,
    world_size,
)


def _ring(group) -> tuple[int, int, int, int]:
    """(n, this rank's index in the group, global rank of the right
    neighbour, of the left one)."""
    n = world_size(group)
    i = dist.get_rank(group)
    glob = (lambda j: dist.get_global_rank(group, j % n)
            if group is not None and group is not dist.group.WORLD
            else j % n)
    return n, i, glob(i + 1), glob(i - 1)


def _reduce_scatter_phase(chunks: torch.Tensor, group) -> torch.Tensor:
    """N − 1 hops, in place; afterwards rank i's row i holds the sum of
    every rank's row i. At hop s rank i sends row (i − s − 1) mod N to its
    right neighbour and adds the incoming row into (i − s − 2) mod N."""
    n, idx, right, left = _ring(group)
    recv = torch.empty_like(chunks[0])
    for s in range(n - 1):
        exchange([(chunks[(idx - s - 1) % n], right)], [(recv, left)],
                 group, kind="ring")
        chunks[(idx - s - 2) % n] += recv
    return chunks


def _all_gather_phase(chunks: torch.Tensor, group) -> torch.Tensor:
    """N − 1 hops, in place; from rank i owning reduced row i, afterwards
    every rank holds every reduced row. At hop s rank i sends row
    (i − s) mod N and stores the incoming row at (i − s − 1) mod N."""
    n, idx, right, left = _ring(group)
    for s in range(n - 1):
        exchange([(chunks[(idx - s) % n], right)],
                 [(chunks[(idx - s - 1) % n], left)], group, kind="ring")
    return chunks


def ring_all_reduce(x: torch.Tensor, group=None, *,
                    mean: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (divided by N under
    ``mean``) by the explicit two-phase ring, as a new tensor of ``x``'s
    shape: ``x`` flattened, zero-padded to N chunks."""
    n = world_size(group)
    if n == 1:
        return x.clone()
    size = x.numel()
    flat = x.reshape(-1).clone()
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.view(n, -1)
    _reduce_scatter_phase(chunks, group)
    _all_gather_phase(chunks, group)
    out = flat[:size].view(x.shape)
    return out / n if mean else out


def ring_reduce_scatter(x: torch.Tensor, group=None, *,
                        mean: bool = False) -> torch.Tensor:
    """Rank i's slice i (along dim 0) of the sum over the ring — the
    semantics of ``lax.psum_scatter(..., tiled=True)`` on axis 0.
    Requires ``x.shape[0] % N == 0``."""
    n = world_size(group)
    if n == 1:
        return x.clone()
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by {n}")
    chunks = x.reshape(n, x.shape[0] // n, *x.shape[1:]).clone()
    _reduce_scatter_phase(chunks, group)
    out = chunks[dist.get_rank(group)].clone()
    return out / n if mean else out


def ring_psum_tree(tree: Any, group=None, *,
                   bucket_bytes: int = 25 * 1024 * 1024,
                   mean: bool = True) -> Any:
    """Bucketed ring all-reduce of a gradient tree: ``bucketed_psum``'s
    size-capped flat buckets, each making one trip round the ring."""
    return bucketed_psum(tree, group, bucket_bytes=bucket_bytes, mean=mean,
                         reduce_fn=ring_all_reduce)
