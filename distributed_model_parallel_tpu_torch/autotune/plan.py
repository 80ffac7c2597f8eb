"""The typed parallel plan: one layout the planner can propose or a run
can report — the port of ``distributed_model_parallel_tpu/autotune/
plan.py``, field for field, so that plans sort identically.

A plan is the 6-tuple the whole strategy zoo composes from — data (dp),
pipeline (pp), tensor (tp), sequence (sp) and expert (ep) degrees plus the
engine ``strategy`` that drives the data axis ("gspmd" | "ddp" | "fsdp" |
"spmd_pipeline" for the CNN trainers, "spmd" for the LM SPMD program,
"pipeline" for the single-controller runner) —
and the microbatch count when a pipeline axis is active. The same payload
shape appears in three places so artifacts stay joinable:

* the ``plan`` telemetry record (autotune/planner.emit_plan_record);
* the trainers' ``/statusz`` provider (utils/statusz.register_trainer);
* the plan CLI's ranked output (autotune/dmp_plan.py).
"""

from __future__ import annotations

import dataclasses

from distributed_model_parallel_tpu_torch.config import MeshConfig

__all__ = ["ParallelPlan", "mesh_from_plan", "plan_payload"]


@dataclasses.dataclass(frozen=True, order=True)
class ParallelPlan:
    """One candidate (strategy, dp, pp, tp, sp, ep, M) layout.

    Ordered (field order above) so deterministic tie-breaking in the
    ranker is a plain tuple compare, never dict/hash order.
    """

    strategy: str
    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    num_microbatches: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    def axes(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp,
                "sp": self.sp, "ep": self.ep}

    def describe(self) -> str:
        degrees = "x".join(f"{k}{v}" for k, v in self.axes().items()
                           if v > 1) or "dp1"
        tail = (f" M={self.num_microbatches}"
                if self.pp > 1 and self.num_microbatches > 1 else "")
        return f"{self.strategy}[{degrees}]{tail}"

    def payload(self) -> dict:
        """JSON payload shared by telemetry, status and the CLI (module
        docstring)."""
        return {"strategy": self.strategy, "axes": self.axes(),
                "num_microbatches": self.num_microbatches}


def mesh_from_plan(plan: ParallelPlan,
                   base: MeshConfig | None = None) -> MeshConfig:
    """The plan's axis degrees over ``base``'s axis names.

    The dcn factor survives only when it still divides the planned dp —
    the same keep-or-drop rule as ``train/elastic.fit_mesh_to_devices``
    (a re-planned slice's host layout is unknown).
    """
    base = base if base is not None else MeshConfig()
    dcn = base.dcn_data if base.dcn_data > 1 and plan.dp % base.dcn_data == 0 \
        else 1
    return dataclasses.replace(base, data=plan.dp, stage=plan.pp,
                               model=plan.tp, seq=plan.sp, expert=plan.ep,
                               dcn_data=dcn)


def plan_payload(mesh: MeshConfig, strategy: str, *,
                 num_microbatches: int = 1) -> dict:
    """The plan payload for a run that already HAS a mesh (the trainers'
    status provider): same shape as ``ParallelPlan.payload`` so the
    planner's records and a running trainer's status are one schema."""
    return ParallelPlan(
        strategy=strategy, dp=mesh.data, pp=mesh.stage, tp=mesh.model,
        sp=mesh.seq, ep=mesh.expert,
        num_microbatches=num_microbatches).payload()
