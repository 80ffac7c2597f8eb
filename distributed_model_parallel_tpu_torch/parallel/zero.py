"""ZeRO-style sharded-optimizer data parallelism — the port of
``distributed_model_parallel_tpu/parallel/zero.py``.

Instead of every rank holding the full optimizer state and applying the
full update:

* the flat gradient is reduce-scattered: each rank receives only its 1/N
  slice of the mean gradient;
* the momentum lives sharded: each rank keeps and updates only its slice
  (ZeRO stages 1 and 2), with one launch of the fused SGD kernel
  (``ops/fused_sgd.py``, ``csrc/fused_sgd.cu``) over its flat f32 slice,
  or of ``plain_sgd`` without momentum — what the JAX package's ZeRO does
  when its ``tx`` is ``pallas_optim.fused_sgd``;
* the updated slices are all-gathered back into full parameters.

Every leaf is flattened in leaf order into one f32 vector zero-padded to a
multiple of N (``collectives.flatten_padded``), so rank r's slice covers
the elements of the JAX package's row r, and the scatter and gather are
two large contiguous collectives.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig
from distributed_model_parallel_tpu_torch.mesh import MeshSpec
from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
    all_reduce_,
    flatten_padded,
    reduce_scatter_mean,
    tree_flatten,
    unflatten_like,
    world_size,
)


@dataclasses.dataclass
class ZeroState:
    """One rank's optimizer state: its momentum slice (None without
    momentum) and the update count the schedule reads."""

    momentum: torch.Tensor | None
    count: int = 0


def make_zero_train_step(loss_fn: Callable, optimizer_config: OptimizerConfig,
                         spec: MeshSpec, *,
                         schedule: Callable[[int], float] | None = None
                         ) -> tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for ZeRO over the data axis of ``spec``.

    ``loss_fn(params, batch) -> scalar tensor``, ``params`` a tree of
    tensors (``collectives.tree_flatten``'s leaf order). ``init_fn(params)
    -> ZeroState``: this rank's zeroed momentum slice. ``step_fn(params,
    state, batch) -> (new_params, state, loss)``, on this rank's rows of
    the batch: the gradient of ``loss_fn`` → ``flatten_padded`` →
    ``reduce_scatter_mean`` to this rank's slice → the SGD update of the
    slice of params and momentum → ``all_gather_concat`` →
    ``unflatten_like`` (new tensors, views of one flat buffer); the loss
    is the mean over ranks. The update is ``optimizer_config``'s SGD
    (momentum, weight decay, nesterov) at ``schedule(count)`` (default:
    the constant ``learning_rate``, as an optax ``sgd`` with a float
    rate). With ``fused`` it is one launch of the fused SGD kernel a step
    (``plain_sgd`` at momentum 0) on the card and its plain version on
    the CPU; without, the plain version everywhere. Clipping,
    accumulation and EMA are not part of this step and raise.
    ``step_fn.take_times_us()`` returns the µs of each step's reduction,
    from the reduce-scatter to the end of the all-gather (CUDA events on
    the card, the host clock on the CPU), since its last call."""
    cfg = optimizer_config
    if cfg.name != "sgd":
        raise ValueError(f"the ZeRO step runs the sgd recipe, got "
                         f"name={cfg.name!r} (other optimizers: ROADMAP A4)")
    if (cfg.grad_clip_norm is not None or cfg.accum_steps != 1
            or cfg.ema_decay is not None):
        raise ValueError("the ZeRO step takes no grad_clip_norm, "
                         "accum_steps or ema_decay")
    group = spec.group
    n = world_size(group)
    rank = spec.data_index if group is not None else 0
    mu = float(cfg.momentum or 0.0)
    wd = float(cfg.weight_decay)
    nesterov = bool(cfg.nesterov and mu)
    lr_at = schedule or (lambda _count: cfg.learning_rate)

    def init_fn(params: Any) -> ZeroState:
        size = flatten_padded(params, n).numel() // n
        leaf = tree_flatten(params)[0][0]
        return ZeroState(torch.zeros(size, dtype=torch.float32,
                                     device=leaf.device) if mu else None)

    def update(p, m, g, lr) -> None:
        if not cfg.fused:
            fs.fused_sgd_plain(p, m, g, lr, mu, wd, nesterov)
        elif m is None:
            fs.plain_sgd_kernel(p, g, lr, wd)
        else:
            fs.fused_sgd_kernel(p, m, g, lr, mu, wd, nesterov)

    times = collections.deque(maxlen=4096)

    def mark(cuda: bool):
        if cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def step_fn(params: Any, state: ZeroState, batch):
        leaves, rebuild = tree_flatten(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        loss = loss_fn(rebuild(live), batch)
        grads = torch.autograd.grad(loss, live)
        cuda = leaves[0].is_cuda
        with torch.no_grad():
            start = mark(cuda)
            g_slice = reduce_scatter_mean(flatten_padded(grads, n), group)
            flat_p = flatten_padded(leaves, n)
            size = flat_p.numel() // n
            p_slice = flat_p[rank * size:(rank + 1) * size]
            update(p_slice, state.momentum, g_slice, lr_at(state.count))
            new_flat = all_gather_concat(p_slice, group)
            times.append((start, mark(cuda)))
            loss = loss.detach().clone()
            all_reduce_(loss, group, kind="metrics")
        state.count += 1
        return unflatten_like(new_flat, params), state, loss / n

    def take_times_us() -> list[float]:
        out = [a.elapsed_time(b) * 1e3 if not isinstance(a, float)
               else (b - a) * 1e6 for a, b in times]
        times.clear()
        return out

    step_fn.take_times_us = take_times_us
    return init_fn, step_fn
