"""The planner: enumerate -> filter -> rank -> (optionally) measure ->
emit — the port of ``distributed_model_parallel_tpu/autotune/
planner.py``.

``plan_parallelism`` is the pure core: given a probed
:class:`~distributed_model_parallel_tpu.autotune.search.WorkloadSpec` and
a device count it enumerates every feasible ``(dp, pp, tp, sp, ep)``
layout (search.py), drops the ones the HBM filter rejects (memory.py),
ranks the survivors with the alpha-beta cost model (cost_model.py) and —
when the caller supplies a ``measure_fn`` — validates the analytic top-K
with short measured steps, letting a measurement overrule the model.
Everything is deterministic: same workload + device count + coefficients
-> the identical ranked list (ties break on the plan tuple, never hash
order).

Entry points the rest of the tree uses:

* ``plan_for_cnn`` / ``plan_for_lm`` / ``plan_for_stage_pipeline`` —
  ``strategy="auto"`` routing for the three trainers: probe the config's
  workload, plan on the LIVE device count, and return the rewritten
  config (an elastic restart therefore RE-PLANS on the refitted mesh
  instead of blindly shrinking dp — the planner may move devices to a
  different axis entirely). Every rank of a process group plans for
  itself, on inputs that are the same on every rank (a probe on ``meta``
  or CPU tensors, the card's ``total_memory``, its name's peak);
  :func:`check_plan_agreement` proves it before a mesh is built;
* ``emit_plan_record`` — the typed ``plan`` record every auto run writes
  into its run's ``.jsonl``, stamped with the global step it planned at;
* ``autotune/dmp_plan.py`` — the CLI over the same core.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from distributed_model_parallel_tpu_torch.autotune import cost_model, memory, search
from distributed_model_parallel_tpu_torch.autotune.cost_model import (
    CostCoefficients,
    PlanCost,
)
from distributed_model_parallel_tpu_torch.autotune.plan import (
    ParallelPlan,
    mesh_from_plan,
)
from distributed_model_parallel_tpu_torch.autotune.search import WorkloadSpec

__all__ = [
    "InfeasiblePlanError",
    "PlanAgreementError",
    "PlanDecision",
    "RankedPlan",
    "check_plan_agreement",
    "emit_plan_record",
    "lm_model_for_plan",
    "plan_for_cnn",
    "plan_for_lm",
    "plan_for_stage_pipeline",
    "plan_parallelism",
]


class InfeasiblePlanError(ValueError):
    """No candidate layout satisfies the constraints (device count,
    divisibility, memory). Carries the per-candidate rejection reasons so
    the fix is actionable, not archaeology."""


class PlanAgreementError(RuntimeError):
    """The ranks of one process group planned different layouts: an input
    to the plan differs between them, and a mesh built from the decisions
    would not be one mesh."""


@dataclasses.dataclass(frozen=True)
class RankedPlan:
    plan: ParallelPlan
    cost: PlanCost
    memory: Mapping[str, float]

    def payload(self) -> dict:
        return {**self.plan.payload(), "cost": self.cost.payload(),
                "mem_bytes_per_device": self.memory.get("total")}


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """The full outcome of one planning call — what was considered, what
    survived, what won, and why."""

    workload: str
    n_devices: int
    hbm_bytes: float | None
    ranked: tuple[RankedPlan, ...]          # feasible, best-first
    rejected: tuple[tuple[ParallelPlan, str], ...]
    chosen: RankedPlan
    measured: tuple[dict, ...] | None = None
    reason: str = "startup"                 # "startup" | "elastic-replan"

    @property
    def measurement_won(self) -> bool:
        """Whether a successful measurement actually picked ``chosen``
        (error-only measured rows keep the analytic best)."""
        return bool(self.measured) and any("measured_s" in m
                                           for m in self.measured)

    def describe(self) -> str:
        chosen = self.chosen
        how = "measured-best" if self.measurement_won else "analytic-best"
        return (f"autotune[{self.workload}]: {chosen.plan.describe()} "
                f"({how} of {len(self.ranked)} feasible / "
                f"{len(self.ranked) + len(self.rejected)} candidates "
                f"on {self.n_devices} devices, "
                f"predicted {chosen.cost.total_s * 1e3:.3g} ms/step)")

    def telemetry_payload(self, *, global_step: int = 0) -> dict:
        out = {
            "workload": self.workload,
            "reason": self.reason,
            "n_devices": self.n_devices,
            "global_step": int(global_step),
            "hbm_bytes": self.hbm_bytes,
            "n_feasible": len(self.ranked),
            "n_rejected": len(self.rejected),
            **self.chosen.payload(),
            "top": [r.payload() for r in self.ranked[:5]],
        }
        if self.measured is not None:
            out["measured"] = list(self.measured)
        return out


def _plan_sort_key(r: RankedPlan):
    return (r.cost.total_s, r.plan)


def plan_parallelism(workload: WorkloadSpec, n_devices: int, *,
                     coeffs: CostCoefficients | None = None,
                     hbm_bytes: float | None = None,
                     observed: Mapping[str, Mapping[str, float]] | None = None,
                     strategies: Sequence[str] | None = None,
                     candidates: Sequence[ParallelPlan] | None = None,
                     measure_fn: Callable[[ParallelPlan], float] | None = None,
                     measure_top: int = 0,
                     allow_undersubscribe: bool = False,
                     reason: str = "startup") -> PlanDecision:
    """Plan the mesh layout (module docstring).

    ``measure_fn(plan) -> seconds/step`` validates the analytic top
    ``measure_top`` candidates when provided; the measured-best becomes
    ``chosen`` (the analytic ranking is kept alongside). ``candidates``
    overrides enumeration for constrained spaces (the single-controller
    pipeline). ``allow_undersubscribe=True`` (the trainers' auto path)
    retries at the largest smaller device count when no factorization of
    ``n_devices`` is feasible — a 7-device slice after a quarantine
    plans 4/7 devices rather than crashing the restart, matching
    ``fit_mesh_to_devices``'s graceful shrink. Raises
    :class:`InfeasiblePlanError` when nothing survives.
    """
    coeffs = coeffs if coeffs is not None else \
        cost_model.default_coefficients()
    if candidates is None:
        candidates = search.enumerate_plans(workload, n_devices,
                                            strategies=strategies)
        n = n_devices
        while not candidates and allow_undersubscribe and n > 1:
            n -= 1
            candidates = search.enumerate_plans(workload, n,
                                                strategies=strategies)
        n_devices = n if candidates else n_devices
    if not candidates:
        raise InfeasiblePlanError(
            f"no {workload.kind} layout of {n_devices} devices satisfies "
            f"the divisibility constraints (batch={workload.batch_size}; "
            f"see autotune/search.py for the per-axis rules)")
    ranked: list[RankedPlan] = []
    rejected: list[tuple[ParallelPlan, str]] = []
    for p in candidates:
        fits, est, why = memory.memory_feasible(workload, p, hbm_bytes)
        if not fits:
            rejected.append((p, why or "memory"))
            continue
        ranked.append(RankedPlan(
            plan=p, cost=cost_model.plan_cost(workload, p, coeffs,
                                              observed=observed),
            memory=est))
    if not ranked:
        detail = "; ".join(f"{p.describe()}: {why}"
                           for p, why in rejected[:8])
        raise InfeasiblePlanError(
            f"all {len(rejected)} candidate layouts rejected by the "
            f"HBM feasibility filter — {detail}")
    ranked.sort(key=_plan_sort_key)

    measured: tuple[dict, ...] | None = None
    chosen = ranked[0]
    if measure_fn is not None and measure_top > 0:
        rows = []
        for r in ranked[:measure_top]:
            row = {**r.plan.payload(), "predicted_s": r.cost.total_s}
            try:
                row["measured_s"] = float(measure_fn(r.plan))
            except Exception as e:  # noqa: BLE001 - one candidate's
                # build/compile failure must not kill the sweep; the
                # analytic ranking still stands for it.
                row["error"] = f"{type(e).__name__}: {e}"
            rows.append(row)
        measured = tuple(rows)
        timed = [m for m in rows if "measured_s" in m]
        if timed:
            best = min(timed,
                       key=lambda m: (m["measured_s"], m["predicted_s"]))
            chosen = next(r for r in ranked
                          if r.plan.payload() == {k: best[k] for k in
                                                  ("strategy", "axes",
                                                   "num_microbatches")})
        # else: every candidate failed to measure — keep the analytic
        # best; the rows carry the errors for the caller to surface.
    return PlanDecision(
        workload=workload.kind, n_devices=n_devices, hbm_bytes=hbm_bytes,
        ranked=tuple(ranked), rejected=tuple(rejected), chosen=chosen,
        measured=measured, reason=reason)


def emit_plan_record(telemetry, decision: PlanDecision, *,
                     global_step: int = 0) -> None:
    """Write the typed ``plan`` record onto a run's record stream
    (``RunLogger.telemetry``) — stamped with the global step the run plans
    at, so an elastic re-plan is auditable at its exact resume point."""
    telemetry.record("plan",
                     **decision.telemetry_payload(global_step=global_step))


def check_plan_agreement(decision: PlanDecision) -> None:
    """With a process group, gather every rank's decision payload and
    raise :class:`PlanAgreementError` unless all are equal; a no-op for a
    lone process."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    mine = decision.telemetry_payload()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    differ = [r for r, p in enumerate(every) if p != mine]
    if differ:
        raise PlanAgreementError(
            f"rank {dist.get_rank()} planned "
            f"{decision.chosen.plan.describe()}, ranks {differ} planned "
            f"otherwise ({[every[r].get('strategy') for r in differ]}); "
            f"an input to the plan differs between the ranks")


# ---------------------------------------------------------------------------
# strategy="auto" routing for the trainers
# ---------------------------------------------------------------------------

def _reason_for(config) -> str:
    """"elastic-replan" only for a restart that will actually resume:
    elastic + resume + something under the checkpoint directory (a fresh
    first start of an elastic-and-resumable config is still "startup" —
    the trainers' own resume gate checks slot existence the same way)."""
    import os

    if not (getattr(config, "elastic", False)
            and getattr(config, "resume", False)):
        return "startup"
    ckpt_dir = getattr(config, "checkpoint_dir", None)
    try:
        has_ckpt = bool(ckpt_dir) and bool(os.listdir(ckpt_dir))
    except OSError:
        has_ckpt = False
    return "elastic-replan" if has_ckpt else "startup"


def _card_inputs(device) -> dict:
    """The coefficients and HBM capacity of the config's device: the
    card's (its name's peak, its ``total_memory``), or the CPU fallbacks
    and no HBM filter under ``device="cpu"``."""
    import torch

    on_card = torch.device(device).type == "cuda"
    return {"coeffs": cost_model.default_coefficients(
                device if on_card else "cpu"),
            "hbm_bytes": memory.device_hbm_bytes(device=device)}


def plan_for_cnn(config, n_devices: int):
    """Resolve ``TrainConfig(strategy="auto")``: probe the model, plan,
    and return ``(rewritten_config, PlanDecision)``.

    Per-strategy constraint pruning mirrors the trainers' own loud
    rejections, so the planner never picks a layout the Trainer would
    refuse: the consistency sentinel and fused optimizer exclude FSDP,
    EMA needs gspmd/fsdp, device-resident data needs gspmd/fsdp, and an
    explicit ``grad_bucket_mb`` pins the explicit DDP path.
    """
    if config.grad_bucket_mb is not None:
        strategies: tuple[str, ...] = ("ddp",)
    else:
        strategies = ("gspmd", "fsdp", "spmd_pipeline")
        if config.consistency_every or config.optimizer.fused:
            strategies = tuple(s for s in strategies if s != "fsdp")
        if (config.optimizer.ema_decay is not None
                or config.device_resident_data):
            strategies = tuple(s for s in strategies
                               if s in ("gspmd", "fsdp"))
    workload = search.cnn_workload(config.model, config.data)
    decision = plan_parallelism(
        workload, n_devices, **_card_inputs(config.device),
        strategies=strategies, allow_undersubscribe=True,
        reason=_reason_for(config))
    p = decision.chosen.plan
    new = config.replace(
        strategy=p.strategy, mesh=mesh_from_plan(p, config.mesh),
        num_microbatches=p.num_microbatches,
        # Pipeline plans balance their stage cut with the same unit costs
        # the workload probe measured (auto_partition.unit_costs).
        auto_partition=(config.auto_partition or p.pp > 1))
    return new, decision


def lm_model_for_plan(model, plan: ParallelPlan):
    """The model config a plan needs: tensor/sequence/expert parallelism
    live as model-config axis names (``tp_axis``/``sp_axis``/``ep_axis``
    — the same wiring the LM CLI, train/train_lm.py, does from its
    degrees), so a planned degree > 1 must switch the matching axis on,
    and a degree of 1 must switch it off."""
    updates = {}
    for field, axis, degree in (("tp_axis", "model", plan.tp),
                                ("sp_axis", "seq", plan.sp),
                                ("ep_axis", "expert", plan.ep)):
        want = axis if degree > 1 else None
        if getattr(model, field) != want:
            updates[field] = want
    return dataclasses.replace(model, **updates) if updates else model


def plan_for_lm(config, n_devices: int):
    """Resolve ``LMTrainConfig(strategy="auto")``: plan the
    dp x pp x tp x sp x ep degrees of the single-jit SPMD program and
    return ``(rewritten_config, PlanDecision)``. Planned tensor /
    sequence / expert axes are switched on in the model config
    (:func:`lm_model_for_plan`)."""
    workload = search.lm_workload(config.model, config.batch_size,
                                  config.seq_len)
    decision = plan_parallelism(
        workload, n_devices, **_card_inputs(config.device),
        allow_undersubscribe=True, reason=_reason_for(config))
    p = decision.chosen.plan
    new = dataclasses.replace(
        config, strategy="spmd", model=lm_model_for_plan(config.model, p),
        mesh=mesh_from_plan(p, config.mesh),
        num_microbatches=p.num_microbatches)
    return new, decision


def plan_for_stage_pipeline(config, n_stages: int):
    """Resolve ``strategy="auto"`` for the single-controller
    PipelineTrainer: the stage count is fixed by the device list, so the
    planner picks the microbatch count (bubble vs boundary-latency) and
    turns the cost-balanced stage cut on. Returns
    ``(rewritten_config, PlanDecision)``."""
    workload = search.cnn_workload(config.model, config.data)
    decision = plan_parallelism(
        workload, n_stages, **_card_inputs(config.device),
        candidates=search.enumerate_stage_pipeline_plans(workload,
                                                         n_stages),
        reason=_reason_for(config))
    p = decision.chosen.plan
    new = config.replace(
        mesh=dataclasses.replace(config.mesh, stage=n_stages),
        num_microbatches=p.num_microbatches,
        auto_partition=config.auto_partition
        or config.stage_boundaries is None)
    return new, decision
