"""Bucket planning — the port's copy of ``plan_buckets`` from
``distributed_model_parallel_tpu/ops/collectives.py``. The fused SGD
update runs over these buckets; the bucketed allreduce and the other
collectives come with multi-GPU data parallelism (ROADMAP A6)."""

from __future__ import annotations

from typing import Sequence


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):               # torch.Tensor
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)                         # numpy array


def plan_buckets(leaves: Sequence, bucket_bytes: int = 25 * 1024 * 1024
                 ) -> list[list[int]]:
    """Group leaf indices into size-capped buckets, in reverse leaf order
    (the DDP Reducer's order: the last parameters' gradients are ready
    first in the backward). A leaf larger than the cap gets a bucket of
    its own."""
    buckets: list[list[int]] = [[]]
    used = 0
    for idx in reversed(range(len(leaves))):
        nbytes = _nbytes(leaves[idx])
        if buckets[-1] and used + nbytes > bucket_bytes:
            buckets.append([])
            used = 0
        buckets[-1].append(idx)
        used += nbytes
    return buckets
