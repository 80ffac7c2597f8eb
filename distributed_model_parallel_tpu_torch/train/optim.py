"""Optimizer: SGD with momentum and weight decay, linear warmup then cosine
annealing — the port of ``distributed_model_parallel_tpu/train/optim.py``
for ``name="sgd"``.

The JAX package chains ``clip_by_global_norm`` (optional),
``add_decayed_weights`` and ``optax.sgd``; :class:`torch.optim.SGD` keeps
the same order — weight decay added to the raw gradient before the
momentum buffer, the buffer starting at the first gradient (optax's
trace), nesterov as ``g + μ·buf``. The learning rate of update n is
``schedule(n)``, counted before the increment, as optax's count is.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig


def make_schedule(config: OptimizerConfig, steps_per_epoch: int,
                  epochs: int) -> Callable[[int], float]:
    """Linear warmup then cosine annealing to 0, per step: optax's
    ``warmup_cosine_decay_schedule`` with ``decay_steps = warmup + decay``,
    or ``cosine_decay_schedule`` when warmup is 0."""
    decay = config.cosine_decay_steps
    if decay is None:
        decay = max(1, steps_per_epoch * epochs)
    warmup = max(0, config.warmup_steps)
    peak = config.learning_rate

    def cosine(count: int) -> float:
        count = min(count, decay)
        return peak * 0.5 * (1 + math.cos(math.pi * count / decay))

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        return cosine(count - warmup)

    return schedule


class SGD:
    """``torch.optim.SGD`` driven by the schedule, with optax's
    ``clip_by_global_norm`` in front when ``grad_clip_norm`` is set.
    ``step()`` updates the parameters in place."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.clip = config.grad_clip_norm
        self.count = 0
        momentum = config.momentum or 0.0
        self.opt = torch.optim.SGD(
            self.params, lr=schedule(0), momentum=momentum,
            weight_decay=config.weight_decay,
            # optax ignores nesterov without a momentum trace
            nesterov=bool(config.nesterov and momentum))

    @property
    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _clip(self) -> None:
        # optax: t where ||g|| < max_norm, else (t / ||g||) * max_norm —
        # on the device, no host sync.
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        keep = norm < self.clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.clip))

    def step(self) -> None:
        if self.clip is not None:
            self._clip()
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()
        self.count += 1


def make_optimizer(config: OptimizerConfig, steps_per_epoch: int,
                   epochs: int, params) -> SGD:
    """The SGD chain over ``params``. Other names, ``fused``,
    ``accum_steps > 1`` and ``ema_decay`` are not ported yet (ROADMAP A4)
    and raise."""
    if config.name != "sgd":
        raise ValueError(f"optimizer {config.name!r} is not ported yet; the "
                         f"port runs 'sgd' (ROADMAP A4)")
    if config.fused:
        raise ValueError("OptimizerConfig.fused (the fused SGD kernel) is not "
                         "ported yet (ROADMAP A4, queue B1/B2)")
    if config.accum_steps != 1:
        raise ValueError("accum_steps > 1 is not ported yet (ROADMAP A4)")
    if config.ema_decay is not None:
        raise ValueError("ema_decay is not ported yet (ROADMAP A4)")
    schedule = make_schedule(config, max(1, steps_per_epoch * epochs), 1)
    return SGD(params, config, schedule)
