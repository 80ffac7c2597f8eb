"""Measured validation: time short real steps of the top-K candidates —
the port of ``distributed_model_parallel_tpu/autotune/measure.py``.

The analytic ranking is only as good as its coefficients, so the planner
can close the loop with measurements: the plan CLI's ``--measure K``
(``autotune/dmp_plan.py``) builds each of the analytic top-K plans as a
fresh program (an LM trainer on a fresh ``mesh.spawn`` of the plan's
ranks) and times a handful of steps. PyTorch returns before the card
finishes, so the timed calls are bracketed by ``torch.cuda.synchronize()``
on the step's device, less a separately measured empty sync; on the CPU a
call returns when its work is done and nothing is synchronized.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence

from distributed_model_parallel_tpu_torch.autotune.plan import ParallelPlan

__all__ = ["measure_plans", "time_step_fn"]


def _sync_for(device) -> Callable[[], None]:
    """A call that waits for ``device``'s queued work (default: the
    current card when there is one); a no-op on the CPU."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return lambda: None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(device)


def time_step_fn(step: Callable[[], object], *, warmup: int = 1,
                 iters: int = 2, device=None) -> float:
    """Seconds per call of ``step()`` (one train step): ``warmup`` calls
    (first-call costs, the cuDNN autotuner), then ``iters`` back-to-back
    calls bracketed by synchronizations of ``device``, minus the median
    of five empty synchronizations."""
    sync = _sync_for(device)
    for _ in range(max(1, warmup)):
        step()
    sync()
    empty = []
    for _ in range(5):
        t = time.perf_counter()
        sync()
        empty.append(time.perf_counter() - t)
    t_sync = statistics.median(empty)
    t0 = time.perf_counter()
    for _ in range(max(1, iters)):
        step()
    sync()
    return max(1e-9, time.perf_counter() - t0 - t_sync) / max(1, iters)


def measure_plans(plans: Sequence[ParallelPlan],
                  build_step: Callable[[ParallelPlan], Callable[[], object]],
                  *, warmup: int = 1, iters: int = 2,
                  device=None) -> list[dict]:
    """Measure each plan through ``build_step(plan) -> step()`` (a fresh
    per-plan program — the layout is fixed when it is built). Returns one
    row per plan, measurement order preserved; a candidate whose build or
    first step fails records its error instead of killing the sweep (the
    analytic ranking still stands for it)."""
    rows: list[dict] = []
    for p in plans:
        row = dict(p.payload())
        try:
            row["measured_s"] = time_step_fn(build_step(p), warmup=warmup,
                                             iters=iters, device=device)
        except Exception as e:  # noqa: BLE001 - reported, not fatal
            row["error"] = f"{type(e).__name__}: {e}"
        rows.append(row)
    return rows
