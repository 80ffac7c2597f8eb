"""Sparse-gradient embedding path (BASELINE.json config 5) — the port of
``distributed_model_parallel_tpu/ops/sparse.py``.

The embedding gradient of a batch of tokens is kept as COO pairs
``(ids [N], values [N, d])`` with N = batch x seq tokens and duplicates
kept: :func:`embedding_grad_sparse` only reshapes, nothing is densified.
The cross-rank reduction is DDP's sparse all-reduce, a concatenation of
every rank's pairs (:func:`sparse_allreduce`, values pre-scaled by
1/world), and :func:`apply_sparse_grad` folds the pairs into the table
with one ``index_add_``.

On the card ``index_add_`` accumulates duplicate ids by atomics, in an
order the scheduler picks; replicas that apply the same pairs must end
bitwise equal, so the add runs under ``torch.use_deterministic_algorithms``,
where torch sorts the ids and reduces each run of duplicates in that order
(:func:`_deterministic`).
"""

from __future__ import annotations

import contextlib

import torch

from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
    world_size,
)


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """[V, d] x [B, T] -> [B, T, d]."""
    return table[tokens]


def embedding_grad_sparse(tokens: torch.Tensor, d_out: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """COO gradient of :func:`embedding_lookup` with respect to the table:
    tokens ``[B, T]``, cotangent ``d_out [B, T, d]`` -> ``(ids [N],
    values [N, d])``, N = B·T, duplicates kept."""
    ids = tokens.reshape(-1)
    return ids, d_out.reshape(ids.shape[0], -1)


def sparse_allreduce(ids: torch.Tensor, vals: torch.Tensor, group=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """DDP's sparse gradient exchange: every rank's COO pairs concatenated
    in rank order (an all-gather of each), values scaled by 1/world first,
    so that the result is the mean gradient."""
    n = world_size(group)
    return (all_gather_concat(ids, group),
            all_gather_concat(vals / n, group))


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms inside (the previous mode restored)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def apply_sparse_grad(table: torch.Tensor, ids: torch.Tensor,
                      vals: torch.Tensor, scale: float = 1.0
                      ) -> torch.Tensor:
    """``table - scale · scatter_add(COO)`` as a new table; duplicate ids
    accumulate, in an order that does not depend on scheduling."""
    out = table.clone()
    with _deterministic():
        out.index_add_(0, ids.long(), -scale * vals.to(table.dtype))
    return out


def densify(ids: torch.Tensor, vals: torch.Tensor,
            num_rows: int) -> torch.Tensor:
    """COO -> dense ``[num_rows, d]`` (for parity with dense autodiff)."""
    out = vals.new_zeros((num_rows, vals.shape[-1]))
    with _deterministic():
        out.index_add_(0, ids.long(), vals)
    return out
