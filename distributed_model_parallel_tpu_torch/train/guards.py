"""Training guards: replica-divergence and non-finite detection.

Counterpart of ``distributed_model_parallel_tpu/train/guards.py``. The
reference trusts DDP's lockstep blindly and has no failure detection at
all (SURVEY.md §5); these guards check the remaining failure surface
cheaply:

* :func:`assert_replicated` — a tree whose tensors claim to be
  replicated over a process group really is bitwise-identical on every
  rank (one all-gather of per-leaf bit checksums, then the leaves that
  differ are named);
* :func:`check_finite` — raises on NaN/Inf in a tree of tensors or host
  values; a tree of device tensors is checked with ONE host read (the
  per-leaf non-finite counts, stacked on the device), and the first bad
  leaf is named;
* :class:`StallDetector` — the post-hoc step-budget flag, kept for
  standalone use; the trainers run the live
  :class:`~.resilience.Watchdog` instead;
* :class:`GuardRunner` — the config-driven harness the trainers wire in
  (``check_finite_every``, ``stall_budget_s``, the ``sync`` site's
  injected stalls).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.utils import health


class ReplicaDivergenceError(AssertionError):
    pass


class NonFiniteError(FloatingPointError):
    pass


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of nested dicts/lists/tuples, dict keys sorted
    (``jax.tree_util.keystr``'s ``['a'][0]`` path form)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def assert_replicated(tree: Any, group=None, *, name: str = "tree") -> None:
    """Check every tensor of ``tree`` is bitwise-identical on every rank of
    ``group`` (the default group when None; nothing to check without a
    process group). Compares BIT PATTERNS, as the consistency sentinel
    does: ``-0.0`` vs ``+0.0`` diverges, equal NaN bytes do not."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.train.consistency import (
        leaf_bitsum,
    )

    if not dist.is_initialized() or dist.get_world_size(group) < 2:
        return
    flat = [(p, t) for p, t in named_leaves(tree)
            if isinstance(t, torch.Tensor)]
    if not flat:
        return
    sums = torch.stack([leaf_bitsum(t).to(torch.int64) for _, t in flat])
    sums = torch.stack([sums, torch.as_tensor(
        [t.numel() for _, t in flat], device=sums.device)])
    if dist.get_backend(group) == "gloo":
        sums = sums.cpu()
    parts = [torch.empty_like(sums) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, sums, group=group)
    ref = parts[0].cpu()
    for r, got in enumerate(parts[1:], start=1):
        got = got.cpu()
        bad = (got != ref).any(0).nonzero().flatten().tolist()
        if bad:
            raise ReplicaDivergenceError(
                f"{name}{flat[bad[0]][0]} diverges between rank 0 and rank "
                f"{r} of the group (bit patterns differ)")


def check_finite(tree: Any, *, name: str = "tree") -> None:
    """Raise :class:`NonFiniteError` naming the first leaf of ``tree`` that
    holds a NaN or Inf. Device tensors cost one host read for the whole
    tree."""
    flat = [(p, x) for p, x in named_leaves(tree) if x is not None]
    if not flat:
        return
    tensors = [(i, x) for i, (_, x) in enumerate(flat)
               if isinstance(x, torch.Tensor) and x.is_floating_point()]
    bad_counts: dict[int, int] = {}
    if tensors:
        by_dev: dict = {}
        for i, x in tensors:
            by_dev.setdefault(x.device, []).append((i, x))
        for group in by_dev.values():
            counts = torch.stack([(~torch.isfinite(x.detach())).sum()
                                  for _, x in group]).cpu().tolist()
            bad_counts.update({i: c for (i, _), c in zip(group, counts)})
    for i, (path, x) in enumerate(flat):
        if isinstance(x, torch.Tensor):
            if not bad_counts.get(i):
                continue
            arr = x.detach().float().cpu().numpy()
        else:
            arr = np.asarray(x)
            if not np.issubdtype(arr.dtype, np.number) or np.isfinite(
                    arr).all():
                continue
        raise NonFiniteError(
            f"{name}{path} contains {int(np.isnan(arr).sum())} NaN / "
            f"{int(np.isinf(arr).sum())} Inf values")


class StallDetector:
    """Flags steps exceeding ``budget_s``::

        stall = StallDetector(budget_s=60)
        with stall.step():
            train_step(...)
        if stall.stalled: ...
    """

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.stalled = False
        self.worst_s = 0.0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.worst_s = max(self.worst_s, dt)
            if dt > self.budget_s:
                self.stalled = True


class GuardRunner:
    """Config-driven guard harness the trainers wire in (off by default).

    ``check_finite_every=N``: every drained metrics window is checked
    (its values are on the host already), and every N steps the
    parameters too (one device->host read of their non-finite counts).
    ``stall_budget_s=S`` arms a live :class:`~.resilience.Watchdog`
    around every blocking drain: "still blocked after Ns" lines while it
    blocks, and an overrun escalates through ``on_stall`` (the recovery
    supervisor's checkpoint-and-exit under ``recovery.stall_exit``).
    ``injector`` serves planned ``stall`` faults inside the watched
    region; ``device_ids`` attribute every watched sync's wall time to
    the device-health sentinel (``utils/health.py``)."""

    def __init__(self, *, check_finite_every: int = 0,
                 stall_budget_s: float | None = None, logger=None,
                 watchdog_interval_s: float | None = None,
                 on_stall=None, injector=None, device_ids: tuple = ()):
        self.every = check_finite_every
        self.device_ids = tuple(device_ids)
        if stall_budget_s:
            from distributed_model_parallel_tpu_torch.train.resilience import (
                Watchdog,
            )

            self.stall = Watchdog(stall_budget_s,
                                  interval_s=watchdog_interval_s,
                                  logger=logger, on_escalate=on_stall)
        else:
            self.stall = None
        self.logger = logger
        self.injector = (injector if injector is not None
                         and injector.enabled else None)
        self._seen = 0
        self._next_params_check = check_finite_every

    @property
    def enabled(self) -> bool:
        return self.every > 0 or self.stall is not None

    def watch(self, what: str = "sync"):
        """Context manager around a blocking sync point; ``what`` labels
        the watchdog's lines and keys the injector's ``stall`` polls."""
        if (self.stall is None and self.injector is None
                and health.installed() is None):
            return contextlib.nullcontext()
        return self._watched(what)

    @contextlib.contextmanager
    def _watched(self, what: str):
        wd = (self.stall.watch(what) if self.stall is not None
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with wd:
                if self.injector is not None:
                    # Injected stalls sleep INSIDE the watched region, so
                    # the watchdog sees them as a wedged sync. The
                    # sentinel's "consistency-fingerprint" fetches poll
                    # their own site and never shift a planned stall@N.
                    self.injector.maybe_stall(what)
                yield
        finally:
            dt = time.perf_counter() - t0
            if what == "consistency-fingerprint":
                health.observe_fetch(self.device_ids, dt)
            else:
                health.observe_sync(self.device_ids, dt)

    def after_sync(self, host_metrics: Any, n_steps: int,
                   params: Any = None) -> None:
        """Run after a drain: ``host_metrics`` (already on the host) are
        checked every time, ``params`` when the step count crosses the
        N-step cadence."""
        if self.every <= 0:
            return
        check_finite(host_metrics, name="metrics")
        self._seen += n_steps
        if params is not None and self._seen >= self._next_params_check:
            self._next_params_check = self._seen + self.every
            check_finite(params, name="params")
