"""The Transformer LM's training step over a ``(data, model, seq)`` mesh —
the port of ``distributed_model_parallel_tpu/parallel/spmd_pipeline.py``
where the stage axis is 1, with one microbatch under ``gpipe``
(``_make_loss_fn``, ``make_spmd_train_step``, ``make_spmd_eval_loss``).

The JAX step is one jitted SPMD program: the batch sharded
``P(data, seq)``, the blocks inside a ``shard_map`` with the parameters
cut by ``parallel/tensor_parallel``'s specs, the loss the mean over every
token. Here each rank runs its part as a process of the mesh's group
(``mesh.MeshSpec``):

* :func:`shard_batch` — this rank's rows (its data row's) and tokens (its
  seq shard's) of a global batch; uneven shards raise, as JAX's sharding
  does;
* the loss of a rank is the mean over its tokens (``models/transformer.
  lm_loss`` with the rank's mesh: Megatron's all-reduces over the model
  group, ring or Ulysses attention over the seq group); with equal shards
  the mean over every token is the mean of the ranks' means;
* :func:`reduce_grads` — every gradient averaged over the replica group
  (data x seq: the ranks that hold the same slices). A tensor-parallel
  slice is never reduced over the model group, and a replicated leaf not
  a second time: the model group's all-reduces inside the block already
  made each rank's gradient of a replicated leaf the whole one;
* :func:`make_spmd_train_step` and :func:`make_spmd_eval_loss`.

More than one microbatch, ``"1f1b"``, interleaved virtual stages and a
stage axis raise, naming ROADMAP A9: spmd_pipeline.
"""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.models import transformer as tfm
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    bucketed_psum,
    world_size,
)

PIPELINE_ITEM = "ROADMAP A9: spmd_pipeline"


def check_spmd_config(mesh, num_microbatches: int = 1,
                      schedule: str = "gpipe",
                      virtual_stages: int = 1) -> None:
    """Raise on what this step does not run: a stage axis (``mesh``, a
    ``MeshConfig``), more than one microbatch, ``"1f1b"`` and virtual
    stages (by ROADMAP item), and an unknown schedule (in the JAX
    package's words)."""
    stages = mesh.stage
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown spmd pipeline schedule {schedule!r}; "
                         f"known: gpipe, 1f1b")
    refused = {f"MeshConfig(stage={stages})": stages > 1,
               f"num_microbatches={num_microbatches}": num_microbatches > 1,
               "pipeline_schedule='1f1b'": schedule == "1f1b",
               f"virtual_stages={virtual_stages}": virtual_stages > 1}
    named = [k for k, bad in refused.items() if bad]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)} not ported yet for the LM ({PIPELINE_ITEM}"
            f"); the port runs the data, model and seq axes with one "
            f"microbatch")


def _seq_shards(cfg, spec) -> int:
    return spec.num_seq if cfg.sp_axis is not None else 1


def shard_batch(tokens: torch.Tensor, targets: torch.Tensor, cfg,
                spec) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of a global ``[B, T]`` batch: the rows of its data
    row and, under ``cfg.sp_axis``, the tokens of its seq shard (JAX's
    ``P(data, seq)``). Raises on an uneven split."""
    b, t = tokens.shape
    if b % spec.num_data:
        raise ValueError(f"global batch {b} not divisible by "
                         f"data={spec.num_data}")
    n_seq = _seq_shards(cfg, spec)
    if t % n_seq:
        raise ValueError(f"seq len {t} not divisible by seq={n_seq}")
    rows = spec.rows(b)
    t_local = t // n_seq
    cols = slice(spec.seq_index * t_local, (spec.seq_index + 1) * t_local) \
        if n_seq > 1 else slice(None)
    return tokens[rows, cols], targets[rows, cols]


def make_loss_fn(cfg, spec):
    """``loss_fn(params, tokens, targets) -> 0-d tensor``: this rank's mean
    loss over its shard, through the dense or chunked head — the one
    definition the train step and the eval loss share."""
    tfm.check_training_config(cfg)

    def loss_fn(params, tokens, targets):
        return tfm.lm_loss(params, tokens, targets, cfg, spec)

    return loss_fn


def _replica_mean(x: torch.Tensor, spec) -> torch.Tensor:
    """The mean of a rank-local scalar over the replica group."""
    group = spec.replicas
    n = world_size(group) if group is not None else 1
    if n == 1:
        return x
    x = x.detach().float().clone()
    all_reduce_(x, group, kind="loss")
    return x / n


@torch.no_grad()
def reduce_grads(leaves: list, spec) -> None:
    """Every gradient := its mean over the replica group (data x seq), in
    place, in flat buckets (``collectives.bucketed_psum``). A leaf off
    the loss path gets zeros."""
    group = spec.replicas
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    if group is None or world_size(group) == 1:
        for p, g in zip(leaves, grads):
            p.grad = g
        return
    for p, g in zip(leaves, bucketed_psum(grads, group, mean=True)):
        p.grad = g


def make_spmd_train_step(cfg, spec, optimizer, leaves: list, *,
                         num_microbatches: int = 1, schedule: str = "gpipe",
                         virtual_stages: int = 1):
    """``step(params, tokens, targets) -> {"loss": 0-d tensor}`` on this
    rank's shard (:func:`shard_batch`): the value and gradient of the
    rank's loss, the gradients averaged over the replica group, then the
    optimizer's update in place over ``leaves`` (the parameters it
    holds). The loss returned is the mean over every token (the replica
    group's mean of the ranks' means)."""
    check_spmd_config(spec.config, num_microbatches, schedule,
                      virtual_stages)
    loss_fn = make_loss_fn(cfg, spec)

    def step(params, tokens, targets):
        optimizer.zero_grad()
        loss = loss_fn(params, tokens, targets)
        loss.backward()
        reduce_grads(leaves, spec)
        optimizer.step()
        return {"loss": _replica_mean(loss.detach(), spec)}

    return step


def make_spmd_eval_loss(cfg, spec, num_microbatches: int = 1):
    """``eval_loss(params, tokens, targets) -> 0-d tensor``: the forward
    of the train step's loss on this rank's shard, averaged over the
    replica group (the mean over every token), no gradient."""
    check_spmd_config(spec.config, num_microbatches)
    loss_fn = make_loss_fn(cfg, spec)

    @torch.no_grad()
    def eval_loss(params, tokens, targets):
        return _replica_mean(loss_fn(params, tokens, targets), spec)

    return eval_loss
