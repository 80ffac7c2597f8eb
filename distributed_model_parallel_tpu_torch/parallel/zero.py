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


class SliceUpdate:
    """The ZeRO update of one rank's slice, shared by
    :func:`make_zero_train_step` and :class:`ZeroSGD`: the gradients
    flattened and padded (``flatten_padded``), reduce-scattered to this
    rank's slice of their mean, the SGD update of that slice of the
    parameters and of the momentum slice in place (one launch of the
    fused kernel, or of ``plain_sgd`` without momentum, under ``fused``;
    the plain version otherwise), then all-gathered into the new flat
    vector. Refuses what the ZeRO update does not run: another optimizer,
    clipping, accumulation and EMA."""

    def __init__(self, config: OptimizerConfig, spec: MeshSpec):
        if config.name != "sgd":
            raise ValueError(f"the ZeRO step runs the sgd recipe, got "
                             f"name={config.name!r} (other optimizers: "
                             f"ROADMAP A4)")
        if (config.grad_clip_norm is not None or config.accum_steps != 1
                or config.ema_decay is not None):
            raise ValueError("the ZeRO step takes no grad_clip_norm, "
                             "accum_steps or ema_decay (it clips, "
                             "accumulates and averages nothing)")
        self.fused = bool(config.fused)
        self.mu = float(config.momentum or 0.0)
        self.wd = float(config.weight_decay)
        self.nesterov = bool(config.nesterov and self.mu)
        self.group = spec.group
        self.n = world_size(spec.group)
        self.rank = spec.data_index if spec.group is not None else 0

    def slice_size(self, numel: int) -> int:
        """Elements of each rank's slice of ``numel`` padded elements."""
        return -(-numel // self.n)

    def local(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of a flat padded vector."""
        size = flat.numel() // self.n
        return flat[self.rank * size:(self.rank + 1) * size]

    def momentum(self, numel: int, device) -> torch.Tensor | None:
        """A zeroed momentum slice for ``numel`` parameter elements (None
        without momentum)."""
        if not self.mu:
            return None
        return torch.zeros(self.slice_size(numel), dtype=torch.float32,
                           device=device)

    @torch.no_grad()
    def __call__(self, leaves, grads, momentum, lr: float) -> torch.Tensor:
        """The new flat padded parameter vector (every rank's slices);
        ``momentum`` (this rank's slice) is updated in place."""
        g = reduce_scatter_mean(flatten_padded(grads, self.n), self.group)
        p = self.local(flatten_padded(leaves, self.n))
        if not self.fused:
            fs.fused_sgd_plain(p, momentum, g, lr, self.mu, self.wd,
                               self.nesterov)
        elif momentum is None:
            fs.plain_sgd_kernel(p, g, lr, self.wd)
        else:
            fs.fused_sgd_kernel(p, momentum, g, lr, self.mu, self.wd,
                                self.nesterov)
        return all_gather_concat(p, self.group)


def make_zero_train_step(loss_fn: Callable, optimizer_config: OptimizerConfig,
                         spec: MeshSpec, *,
                         schedule: Callable[[int], float] | None = None
                         ) -> tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for ZeRO over the data axis of ``spec``.

    ``loss_fn(params, batch) -> scalar tensor``, ``params`` a tree of
    tensors (``collectives.tree_flatten``'s leaf order). ``init_fn(params)
    -> ZeroState``: this rank's zeroed momentum slice. ``step_fn(params,
    state, batch) -> (new_params, state, loss)``, on this rank's rows of
    the batch: the gradient of ``loss_fn``, then :class:`SliceUpdate`
    (reduce-scatter, the update of this rank's slice, all-gather), then
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
    update = SliceUpdate(optimizer_config, spec)
    n = update.n
    lr_at = schedule or (lambda _count: optimizer_config.learning_rate)

    def init_fn(params: Any) -> ZeroState:
        leaves = tree_flatten(params)[0]
        return ZeroState(update.momentum(sum(x.numel() for x in leaves),
                                         leaves[0].device))

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
            new_flat = update(leaves, grads, state.momentum,
                              lr_at(state.count))
            times.append((start, mark(cuda)))
            loss = loss.detach().clone()
            all_reduce_(loss, update.group, kind="metrics")
        state.count += 1
        return unflatten_like(new_flat, params), state, loss / n

    def take_times_us() -> list[float]:
        out = [a.elapsed_time(b) * 1e3 if not isinstance(a, float)
               else (b - a) * 1e6 for a, b in times]
        times.clear()
        return out

    step_fn.take_times_us = take_times_us
    return init_fn, step_fn


class ZeroSGD:
    """The trainer's ZeRO optimizer (``TrainConfig(strategy="zero")``):
    :class:`~..train.optim.SGD`'s interface over full, replicated
    parameters, with :class:`SliceUpdate` — the update
    :func:`make_zero_train_step` runs — written back into the parameters
    in place. Momentum is 1/N per rank. :meth:`full_momentum` /
    :meth:`load_full_momentum` move the momentum between the slices and
    whole leaves (collectives: every rank calls)."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float], spec: MeshSpec):
        self.update = SliceUpdate(config, spec)
        self.params = list(params)
        self.schedule = schedule
        self.clip = None
        self.count = 0
        self.momentum = self.update.momentum(
            sum(p.numel() for p in self.params), self.params[0].device)

    @property
    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @staticmethod
    def _scatter_back(flat: torch.Tensor, leaves: list) -> None:
        off = 0
        for x in leaves:
            x.copy_(flat[off:off + x.numel()].view(x.shape))
            off += x.numel()

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self._scatter_back(self.update(self.params, grads, self.momentum,
                                       self.lr), self.params)
        self.count += 1

    @torch.no_grad()
    def full_momentum(self) -> list[torch.Tensor | None]:
        """Every leaf's whole momentum (None per leaf without momentum),
        gathered from the ranks' slices."""
        if self.momentum is None:
            return [None] * len(self.params)
        out = [torch.empty_like(p, dtype=torch.float32) for p in self.params]
        self._scatter_back(all_gather_concat(self.momentum,
                                             self.update.group), out)
        return out

    @torch.no_grad()
    def load_full_momentum(self, moms: list) -> None:
        """This rank's slice of whole per-leaf momenta."""
        if self.momentum is not None:
            self.momentum.copy_(self.update.local(
                flatten_padded(moms, self.update.n)))
