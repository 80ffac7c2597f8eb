"""The Transformer LM's training step over a ``(data, stage, model, seq,
expert)`` mesh — the port of ``distributed_model_parallel_tpu/parallel/
spmd_pipeline.py``'s ``make_spmd_train_step`` and ``make_spmd_eval_loss``.

The JAX step is one jitted SPMD program: the batch sharded
``P(data, seq)``, the blocks inside a ``shard_map`` with the parameters
cut by ``parallel/tensor_parallel``'s specs, the loss the mean over every
token plus the MoE terms. Here each rank runs its part as a process of
the mesh's group (``mesh.MeshSpec``):

* :func:`shard_batch` — this rank's rows (its data row's) and tokens (its
  seq shard's) of a global batch; uneven shards raise, as JAX's sharding
  does;
* the rank's loss runs through ``parallel/spmd_pipeline.LMPipeline``
  over the stage ring, one stage and one microbatch included (its table
  is then one forward and one backward of the whole model); the blocks
  run with the rank's mesh: Megatron's all-reduces over the model group,
  ring or Ulysses attention over the seq group, the experts' all-to-alls
  over the expert group;
* :func:`reduce_grads` — JAX's ``_reduce_axes``, leaf by leaf: every
  gradient averaged over the replica group (data x seq: the ranks that
  hold the same slices); a leaf not cut over the stage axis (embedding,
  positions, final norm, head: only stage 0 or the last stage has its
  gradient) first summed over the stage ring. Nothing is reduced over
  the model or the expert group: the model group's all-reduces inside
  the block make each rank's gradient of a leaf it does not cut the
  whole one, and the expert exchange's backward gives the experts the
  gradient of the group's mean loss and every other leaf its rank's own
  (``ops/moe.moe_ffn``), which the group's replicated tokens make equal;
* :func:`make_spmd_train_step` and :func:`make_spmd_eval_loss`.
"""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.models import transformer as tfm
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    bucketed_psum,
    world_size,
)
from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline


def check_spmd_config(cfg, mesh, num_microbatches: int = 1,
                      schedule: str = "gpipe",
                      virtual_stages: int = 1) -> None:
    """Raise, in the JAX package's words, on a schedule it refuses
    (``spmd_pipeline.check_pipeline_config``); ``mesh`` a
    ``MeshConfig``."""
    tfm.check_training_config(cfg)
    spmd_pipeline.check_pipeline_config(cfg, mesh.stage, num_microbatches,
                                        schedule, virtual_stages)


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


def _replica_mean(x: torch.Tensor, spec) -> torch.Tensor:
    """The mean of a rank-local tensor over the replica group."""
    group = spec.replicas
    n = world_size(group) if group is not None else 1
    if n == 1:
        return x
    x = x.detach().float().clone()
    all_reduce_(x, group, kind="loss")
    return x / n


@torch.no_grad()
def reduce_grads(leaves: list, spec, cuts: list | None = None) -> None:
    """Complete every gradient over the mesh in place (the module
    docstring's rule), in flat buckets (``collectives.bucketed_psum``): a
    leaf whose ``cuts`` (``tensor_parallel.param_cuts``, one tuple per
    leaf) lack the stage axis summed over the stage ring, then every leaf
    averaged over the replica group. A leaf off the loss path gets
    zeros."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    if spec.stage_group is not None:
        if cuts is None:
            raise ValueError("a stage axis needs each leaf's cuts: the "
                             "leaves it does not cut are summed over the "
                             "stage ring")
        idx = [i for i, c in enumerate(cuts)
               if all(axis != "stage" for axis, _ in c)]
        summed = bucketed_psum([grads[i] for i in idx], spec.stage_group,
                               mean=False)
        for i, g in zip(idx, summed):
            grads[i] = g
    group = spec.replicas
    if group is not None and world_size(group) > 1:
        grads = bucketed_psum(grads, group, mean=True)
    for p, g in zip(leaves, grads):
        p.grad = g


def _metrics(cfg, loss: torch.Tensor, aux: torch.Tensor) -> dict:
    """The step's metrics: the loss; the router stats for an MoE model."""
    out = {"loss": loss}
    if cfg.moe_experts:
        out.update(moe_balance=aux[0], moe_z=aux[1], moe_drop=aux[2])
    return out


def _pipeline_loss(pipe, cfg, spec, params, tokens, targets, train: bool):
    """The rank's loss and stats (the replica group's means) from one
    pass of the pipeline."""
    nll, aux_sum = pipe.run(params, tokens, targets, train=train)
    both = _replica_mean(torch.cat([
        (nll / tokens.numel())[None], aux_sum / (pipe.M * pipe.D)]), spec)
    loss = both[0] + (tfm.aux_loss(both[1:], cfg) if cfg.moe_experts else 0.0)
    return loss, both[1:]


def make_loss_and_grad(cfg, spec, leaves: list, *,
                       num_microbatches: int = 1, schedule: str = "gpipe",
                       virtual_stages: int = 1, cuts: list | None = None):
    """``loss_and_grad(params, tokens, targets) -> metrics`` on this rank's
    shard (:func:`shard_batch`): the gradient of the rank's loss (the
    pipeline's schedule) left in ``leaves``' ``.grad``, completed over the
    mesh (:func:`reduce_grads`, ``cuts`` per leaf). The metrics: the loss
    — the mean over every token plus the MoE terms — and, for an MoE
    model, ``moe_balance``, ``moe_z`` and ``moe_drop``, the same on every
    rank. ``params`` keep the blocks in JAX's storage order under
    ``virtual_stages > 1``. ``.pipeline``: the rank's ``LMPipeline``."""
    check_spmd_config(cfg, spec.config, num_microbatches, schedule,
                      virtual_stages)
    pipe = spmd_pipeline.LMPipeline(cfg, spec, num_microbatches, schedule,
                                    virtual_stages)

    def loss_and_grad(params, tokens, targets):
        loss, aux = _pipeline_loss(pipe, cfg, spec, params, tokens, targets,
                                   True)
        reduce_grads(leaves, spec, cuts)
        return _metrics(cfg, loss, aux)

    loss_and_grad.pipeline = pipe
    return loss_and_grad


def make_spmd_train_step(cfg, spec, optimizer, leaves: list, *,
                         num_microbatches: int = 1, schedule: str = "gpipe",
                         virtual_stages: int = 1, cuts: list | None = None):
    """``step(params, tokens, targets) -> metrics``: the gradients of
    :func:`make_loss_and_grad`, then the optimizer's update in place over
    ``leaves`` (the parameters it holds). ``.pipeline`` as there."""
    loss_and_grad = make_loss_and_grad(
        cfg, spec, leaves, num_microbatches=num_microbatches,
        schedule=schedule, virtual_stages=virtual_stages, cuts=cuts)

    def step(params, tokens, targets):
        optimizer.zero_grad()
        metrics = loss_and_grad(params, tokens, targets)
        optimizer.step()
        return metrics

    step.pipeline = loss_and_grad.pipeline
    return step


def make_spmd_eval_loss(cfg, spec, num_microbatches: int = 1, *,
                        schedule: str = "gpipe", virtual_stages: int = 1):
    """``eval_loss(params, tokens, targets) -> 0-d tensor``: the forward
    of the train step's loss on this rank's shard, averaged over the
    replica group (the mean over every token plus the MoE terms), no
    gradient — through the pipeline's forwards."""
    check_spmd_config(cfg, spec.config, num_microbatches, schedule,
                      virtual_stages)
    pipe = spmd_pipeline.LMPipeline(cfg, spec, num_microbatches, schedule,
                                    virtual_stages)

    @torch.no_grad()
    def eval_loss(params, tokens, targets):
        return _pipeline_loss(pipe, cfg, spec, params, tokens, targets,
                              False)[0]

    return eval_loss
