"""Running meters — the port's own copy of ``AverageMeter`` and
``StepTimer`` from ``distributed_model_parallel_tpu/train/metrics.py``
(which imports jax). Host-side plain Python; values must be floats."""

from __future__ import annotations

import time


class AverageMeter:
    """Running average of plain floats."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0
        self.last = 0.0

    def update(self, value: float, n: int = 1):
        self.last = float(value)
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(1, self.count)


class StepTimer:
    """Separates data-loading time from step (compute) time per batch.
    The caller makes the step's device work finish before
    :meth:`step_done` (the LM trainer reads the loss, and synchronizes
    the card, first)."""

    def __init__(self):
        self.data = AverageMeter("data_time")
        self.step = AverageMeter("step_time")
        self._mark = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data.update(now - self._mark)
        self._mark = now

    def step_done(self):
        now = time.perf_counter()
        self.step.update(now - self._mark)
        self._mark = now
