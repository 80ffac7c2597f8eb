"""Explicit DDP — the port of
``distributed_model_parallel_tpu/parallel/ddp.py``.

Each rank runs its own shard of the global batch with its own BatchNorm
state (per-replica statistics, DDP without SyncBN), unless the model was
built with ``bn_mode="sync"`` (statistics over the process group).
Gradients are averaged by the Reducer (``train/optim.GradReducer``): one
all-reduce per leaf (``allreduce="psum"``) or per flat bucket
(``"bucketed"``), launched from autograd hooks, or each flat bucket round
the explicit neighbour ring (``"ring"``, ``ops/ring_reduce.py``: blocking
hops, run in bucket order when the backward is done), completed before
gradient clipping and the optimizer, as the JAX step runs ``tx.update``
after ``psum_mean``. Parameters and the optimizer state stay identical on
every rank; :func:`assert_ddp_replicated` checks that bit for bit.

Not ported yet, and refused by name: ``allreduce="hierarchical"`` (a
two-level data axis, ``dcn_data > 1``, ROADMAP A6).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.mesh import MeshSpec
from distributed_model_parallel_tpu_torch.models.staged import (
    StagedModel,
    _unit_slots,
)
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
    tree_map,
)
from distributed_model_parallel_tpu_torch.train.optim import (
    DDP_BUCKET_BYTES,
    GradReducer,
)
from distributed_model_parallel_tpu_torch.train.trainer import (
    make_eval_step,
    make_train_step,
    reduce_metrics,
)


def resolve_allreduce(allreduce: str = "psum", bucket_bytes: int | None = None,
                      grad_bucket_mb: float | None = None
                      ) -> tuple[str, int | None]:
    """The JAX package's transport rules: ``grad_bucket_mb`` sets the
    bucket cap, and a cap with ``"psum"`` means ``"bucketed"``. Returns
    ``(allreduce, bucket_bytes)``."""
    if grad_bucket_mb is not None:
        bucket_bytes = int(grad_bucket_mb * 1024 * 1024)
    if allreduce == "psum" and bucket_bytes is not None:
        allreduce = "bucketed"
    if allreduce == "hierarchical":
        raise ValueError("allreduce='hierarchical' needs a two-level data "
                         "axis (MeshConfig.dcn_data > 1), which is not "
                         "ported yet (ROADMAP A6, multi-node)")
    if allreduce not in ("psum", "bucketed", "ring"):
        raise KeyError(f"unknown allreduce {allreduce!r}")
    return allreduce, bucket_bytes


def replicate_model_state(state, num_replicas: int):
    """Give every leaf of a (numpy) BN state tree a leading per-replica
    axis — the layout in which the JAX DDP step carries it."""
    return tree_map(lambda x: np.broadcast_to(
        np.asarray(x)[None], (num_replicas,) + np.shape(x)).copy(), state)


def replica_state(state, rank: int):
    """Rank ``rank``'s slice of a per-replica state tree."""
    return tree_map(lambda x: np.asarray(x)[rank], state)


def gather_replica_state(model: StagedModel, spec: MeshSpec) -> tuple:
    """Every rank's BN state in the JAX package's layout (the ``state``
    of ``params_to_jax``) with the leading per-replica axis: an all-gather
    per leaf, so every rank must call."""
    state = []
    for unit in model.units:
        _, slots = _unit_slots(unit)
        state.append({name: {k: all_gather_concat(t.detach()[None],
                                                  spec.group)
                             .float().cpu().numpy()
                             for k, (t, _) in leaves.items()}
                      for name, leaves in slots.items()})
    return tuple(state)


def _fingerprint(tensors: list, device) -> torch.Tensor:
    """Per tensor, two int64 sums over its bit pattern (plain and
    position-weighted): any change of one element's bits changes them."""
    rows = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        rows.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return torch.stack(rows).to(device)


def assert_ddp_replicated(model: StagedModel, optimizer,
                          spec: MeshSpec) -> None:
    """DDP's invariant: parameters and momentum bitwise identical on every
    rank (BN state is per replica under ``"local"`` and left out). Every
    rank must call: their fingerprints are all-gathered and compared with
    rank 0's; raises AssertionError naming the first leaf that differs."""
    params = list(model.parameters())
    moms = [optimizer.momentum_buffer(i) for i in range(len(params))]
    tensors = params + [m for m in moms if m is not None]
    fp = _fingerprint(tensors, spec.device)
    every = all_gather_concat(fp[None], spec.group)
    for r in range(1, every.shape[0]):
        diff = (every[r] != every[0]).any(-1).nonzero()
        if diff.numel():
            i = int(diff[0])
            what = (f"parameter {i}" if i < len(params)
                    else f"momentum of leaf {i - len(params)}")
            raise AssertionError(f"DDP replicas diverged: {what} differs "
                                 f"between rank 0 and rank {r}")


def make_ddp_train_step(model: StagedModel, optimizer, spec: MeshSpec, *,
                        mean, std, augment: bool = True,
                        dtype=torch.float32, bucket_bytes: int | None = None,
                        allreduce: str = "psum"):
    """``step(images_u8, labels, generator=None) -> metrics``: this rank's
    shard → its own augmentation draws (``generator``) → forward with its
    BN state → backward, the Reducer averaging the gradients → the
    optimizer. Metrics are the global batch's (loss ``sum/N``, batch and
    top-k counts summed). The step's ``reducer`` (None without a process
    group) keeps the reduction's times."""
    allreduce, bucket_bytes = resolve_allreduce(allreduce, bucket_bytes)
    reducer = None
    if spec.group is not None:
        reducer = GradReducer(model.parameters(), spec.group, optimizer,
                              allreduce=allreduce,
                              bucket_bytes=bucket_bytes or DDP_BUCKET_BYTES)
    step = make_train_step(model, optimizer, mean=mean, std=std,
                           augment=augment, dtype=dtype, reducer=reducer)

    def ddp_step(images_u8, labels, generator=None):
        return reduce_metrics(step(images_u8, labels, generator), spec)

    ddp_step.reducer = reducer
    return ddp_step


def make_ddp_eval_step(model: StagedModel, spec: MeshSpec, *, mean, std,
                       dtype=torch.float32):
    """``step(images_u8, labels) -> metrics``: this rank's shard with its
    own BN running statistics; metrics of the global batch."""
    step = make_eval_step(model, mean=mean, std=std, dtype=dtype)
    return lambda images_u8, labels: reduce_metrics(step(images_u8, labels),
                                                    spec)
