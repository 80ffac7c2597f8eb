"""Metrics — the port's own copy of ``distributed_model_parallel_tpu/
train/metrics.py`` (which imports jax): ``topk_correct`` on the device,
and the host-side running meters (plain Python; values must be
floats)."""

from __future__ import annotations

import time

import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: tuple[int, ...] = (1, 5)) -> dict[str, torch.Tensor]:
    """Number of correct predictions at each k, summed over the batch (0-d
    device tensors, so they accumulate across steps without a sync).
    Ties may order differently from the JAX package's ``argsort``."""
    top = torch.topk(logits, max(ks), dim=-1).indices
    hit = top == labels[..., None]
    return {f"correct@{k}": hit[..., :k].sum() for k in ks}


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
    :meth:`step_done` / :meth:`window_done` (the LM trainer reads the loss,
    and synchronizes the card, first; the CNN trainer drains its metrics
    at the end of each window)."""

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

    def window_done(self, n_steps: int):
        """Attribute the time since the last mark to ``n_steps`` batches
        (async loops that synchronize every N steps); no-op for an empty
        window."""
        now = time.perf_counter()
        if n_steps > 0:
            self.step.update((now - self._mark) / n_steps, n_steps)
        self._mark = now
