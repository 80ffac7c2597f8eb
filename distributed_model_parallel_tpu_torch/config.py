"""Typed configuration of the port — its own copy of the JAX package's
``config.py`` dataclasses that the ported slices read (the port imports
nothing of the JAX package). So far: :class:`OptimizerConfig`."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """SGD + cosine annealing + linear warmup, field for field the JAX
    package's ``OptimizerConfig``. The port runs ``name="sgd"`` without
    ``fused``, ``accum_steps`` or ``ema_decay`` (``train/optim.py`` raises
    on those, ROADMAP A4)."""

    name: str = "sgd"
    learning_rate: float = 0.4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    cosine_decay_steps: int | None = None   # if None: derived from epochs
    warmup_steps: int = 0
    grad_clip_norm: float | None = None
    accum_steps: int = 1
    ema_decay: float | None = None
    fused: bool = False
