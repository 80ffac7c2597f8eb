"""Cost-model-driven parallelism autotuner — the port of
``distributed_model_parallel_tpu/autotune/`` on a cost model of the card.

Given a model config and the live mesh, the planner (1) enumerates every
feasible ``(dp, pp, tp, sp, ep)`` factorization of the device count
(search.py — pruned by batch divisibility, per-strategy constraints and
the HBM feasibility filter in memory.py), (2) ranks them with an
alpha-beta comm/compute cost model whose comm terms are the SAME
ring-model estimators ``utils/telemetry.record_collective`` accounts and
whose compute term reuses the public ``parallel/auto_partition``
FLOP-count contract over the card's peak (cost_model.py), (3)
optionally validates the analytic top-K with short measured steps
(measure.py + dmp_plan.py: an LM trainer a candidate on a fresh spawn of
its ranks), and (4) emits the chosen layout as a typed ``plan`` record
(planner.py).

Entry points: ``strategy="auto"`` on the three trainers routes through
``plan_for_cnn`` / ``plan_for_lm`` / ``plan_for_stage_pipeline`` —
elastic restarts re-plan on the refitted mesh instead of blindly
shrinking dp — and ``python -m distributed_model_parallel_tpu_torch.
autotune.dmp_plan`` exposes the planner as a CLI.
"""

from distributed_model_parallel_tpu_torch.autotune.cost_model import (  # noqa: F401
    Collective,
    CostCoefficients,
    PlanCost,
    collective_time_s,
    default_coefficients,
    observed_comm_table,
    plan_collectives,
    plan_cost,
)
from distributed_model_parallel_tpu_torch.autotune.measure import (  # noqa: F401
    measure_plans,
    time_step_fn,
)
from distributed_model_parallel_tpu_torch.autotune.memory import (  # noqa: F401
    device_hbm_bytes,
    estimate_plan_memory,
    memory_feasible,
)
from distributed_model_parallel_tpu_torch.autotune.plan import (  # noqa: F401
    ParallelPlan,
    mesh_from_plan,
    plan_payload,
)
from distributed_model_parallel_tpu_torch.autotune.planner import (  # noqa: F401
    InfeasiblePlanError,
    PlanAgreementError,
    PlanDecision,
    RankedPlan,
    check_plan_agreement,
    emit_plan_record,
    lm_model_for_plan,
    plan_for_cnn,
    plan_for_lm,
    plan_for_stage_pipeline,
    plan_parallelism,
)
from distributed_model_parallel_tpu_torch.autotune.search import (  # noqa: F401
    WorkloadSpec,
    cnn_workload,
    enumerate_plans,
    enumerate_stage_pipeline_plans,
    lm_workload,
    pick_microbatches,
)
