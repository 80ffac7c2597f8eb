"""ZeRO-style sharded-optimizer data parallelism — the port of
``distributed_model_parallel_tpu/parallel/zero.py``.

Instead of every rank holding the full optimizer state and applying the
full update:

* the flat gradient is reduce-scattered: each rank receives only its 1/N
  slice of the mean gradient;
* the optimizer state lives sharded: each rank keeps and updates only its
  slice (ZeRO stages 1 and 2). SGD's momentum slice takes one launch of
  the fused SGD kernel (``ops/fused_sgd.py``, ``csrc/fused_sgd.cu``) over
  the flat f32 slice, or of ``plain_sgd`` without momentum — what the JAX
  package's ZeRO does when its ``tx`` is ``pallas_optim.fused_sgd``;
  adam, adamw, lamb, lars and adafactor (``train/adaptive.py``) run on
  the slice as one leaf, as the JAX package runs any ``tx`` on it — so
  lars' and lamb's trust ratio is the slice's, and adafactor's second
  moment is unfactored;
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
from distributed_model_parallel_tpu_torch.train import adaptive


@dataclasses.dataclass
class ZeroState:
    """One rank's optimizer state: its SGD momentum slice (None without
    momentum or for another optimizer), the update count the schedule
    reads, and another optimizer's chain over the slice (its state is
    ``tx.state``)."""

    momentum: torch.Tensor | None
    count: int = 0
    tx: Any = None


class SliceUpdate:
    """The ZeRO update of one rank's slice, shared by
    :func:`make_zero_train_step` and :class:`ZeroOptimizer`: the gradients
    flattened and padded (``flatten_padded``), reduce-scattered to this
    rank's slice of their mean, the update of that slice of the
    parameters and of the state slice in place (SGD: one launch of the
    fused kernel, or of ``plain_sgd`` without momentum, under ``fused``,
    the plain version otherwise; another optimizer: its chain over the
    slice), then all-gathered into the new flat vector. Refuses what the
    ZeRO update does not run: clipping, accumulation and EMA."""

    def __init__(self, config: OptimizerConfig, spec: MeshSpec):
        if config.name != "sgd" and config.name not in adaptive.NAMES:
            raise KeyError(f"unknown optimizer {config.name!r}")
        if config.fused and config.name != "sgd":
            raise ValueError(f"OptimizerConfig.fused implements the sgd "
                             f"recipe, got name={config.name!r} — no silent "
                             f"ignores")
        if (config.grad_clip_norm is not None or config.accum_steps != 1
                or config.ema_decay is not None):
            raise ValueError("the ZeRO step takes no grad_clip_norm, "
                             "accum_steps or ema_decay (it clips, "
                             "accumulates and averages nothing)")
        self.config = config
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
        without momentum, or for another optimizer than sgd)."""
        if not self.mu or self.config.name != "sgd":
            return None
        return torch.zeros(self.slice_size(numel), dtype=torch.float32,
                           device=device)

    def transform(self, numel: int, device) -> adaptive.Transform | None:
        """Another optimizer's chain over a zeroed slice for ``numel``
        parameter elements (None for sgd)."""
        if self.config.name == "sgd":
            return None
        return adaptive.make_transform(self.config, [torch.zeros(
            self.slice_size(numel), dtype=torch.float32, device=device)])

    @torch.no_grad()
    def __call__(self, leaves, grads, momentum, lr: float, tx=None,
                 count: int = 0) -> torch.Tensor:
        """The new flat padded parameter vector (every rank's slices);
        ``momentum`` (this rank's slice) or ``tx``'s state is updated in
        place; ``count`` is the number of earlier updates."""
        g = reduce_scatter_mean(flatten_padded(grads, self.n), self.group)
        p = self.local(flatten_padded(leaves, self.n))
        if tx is not None:
            p.add_(tx.update([g], [p], lr, count)[0])
        elif not self.fused:
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
    -> ZeroState``: this rank's zeroed state slice. ``step_fn(params,
    state, batch) -> (new_params, state, loss)``, on this rank's rows of
    the batch: the gradient of ``loss_fn``, then :class:`SliceUpdate`
    (reduce-scatter, the update of this rank's slice, all-gather), then
    ``unflatten_like`` (new tensors, views of one flat buffer); the loss
    is the mean over ranks. The update is ``optimizer_config``'s (SGD:
    momentum, weight decay, nesterov; or adam, adamw, lamb, lars,
    adafactor on the slice) at ``schedule(count)`` (default: the constant
    ``learning_rate``, as an optax optimizer with a float rate). SGD with
    ``fused`` is one launch of the fused SGD kernel a step (``plain_sgd``
    at momentum 0) on the card and its plain version on the CPU; without,
    the plain version everywhere. Clipping,
    accumulation and EMA are not part of this step and raise.
    ``step_fn.take_times_us()`` returns the µs of each step's reduction,
    from the reduce-scatter to the end of the all-gather (CUDA events on
    the card, the host clock on the CPU), since its last call."""
    update = SliceUpdate(optimizer_config, spec)
    n = update.n
    lr_at = schedule or (lambda _count: optimizer_config.learning_rate)

    def init_fn(params: Any) -> ZeroState:
        leaves = tree_flatten(params)[0]
        numel = sum(x.numel() for x in leaves)
        return ZeroState(update.momentum(numel, leaves[0].device),
                         tx=update.transform(numel, leaves[0].device))

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
                              lr_at(state.count), state.tx, state.count)
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


class ZeroOptimizer:
    """The trainer's ZeRO optimizer (``TrainConfig(strategy="zero")``):
    :class:`~..train.optim.SGD`'s interface over full, replicated
    parameters, with :class:`SliceUpdate` — the update
    :func:`make_zero_train_step` runs — written back into the parameters
    in place. The optimizer state is 1/N per rank: SGD's momentum slice,
    or another optimizer's chain over the slice. :meth:`full_momentum` /
    :meth:`load_full_momentum` and :meth:`leaf_state` / :meth:`load_state`
    move the state between the slices and whole leaves (collectives:
    every rank calls)."""

    accum = None
    boundary = True

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float], spec: MeshSpec):
        self.update = SliceUpdate(config, spec)
        self.params = list(params)
        self.schedule = schedule
        self.clip = None
        self.count = 0
        numel = sum(p.numel() for p in self.params)
        self.momentum = self.update.momentum(numel, self.params[0].device)
        self.tx = self.update.transform(numel, self.params[0].device)

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
                                       self.lr, self.tx, self.count),
                           self.params)
        self.count += 1

    def _full(self, part: torch.Tensor) -> list[torch.Tensor]:
        """Whole per-leaf tensors from this rank's slice of a flat padded
        state vector, gathered from every rank's."""
        out = [torch.empty_like(p, dtype=torch.float32) for p in self.params]
        self._scatter_back(all_gather_concat(part, self.update.group), out)
        return out

    @torch.no_grad()
    def full_momentum(self) -> list[torch.Tensor | None]:
        """Every leaf's whole momentum (None per leaf without momentum),
        gathered from the ranks' slices."""
        if self.momentum is None:
            return [None] * len(self.params)
        return self._full(self.momentum)

    @torch.no_grad()
    def load_full_momentum(self, moms: list) -> None:
        """This rank's slice of whole per-leaf momenta."""
        if self.momentum is not None:
            self.momentum.copy_(self.update.local(
                flatten_padded(moms, self.update.n)))

    def momentum_buffer(self, i: int) -> None:
        """A momentum of one leaf lives on every rank in slices:
        :meth:`full_momentum` gathers them."""
        return None

    @torch.no_grad()
    def leaf_state(self) -> dict[str, list]:
        """Every leaf's whole state tensors by name, gathered from the
        ranks' slices (another optimizer's; SGD keeps its momentum in
        :meth:`full_momentum`)."""
        if self.tx is None:
            return {}
        return {name: self._full(parts[0])
                for name, parts in self.tx.state.items()}

    def state_shard_axes(self, name: str) -> list:
        return [None] * len(self.params)

    def counters(self) -> dict[str, int]:
        return {"count": self.count}

    @torch.no_grad()
    def load_state(self, counters: dict, leaf_state: dict) -> None:
        """This rank's slices of whole per-leaf states and the count."""
        self.count = int(counters["count"])
        if self.tx is None:
            return
        for name, parts in self.tx.state.items():
            parts[0].copy_(self.update.local(
                flatten_padded(leaf_state[name], self.update.n)))
