"""Multi-tenant run orchestration over a shared device pool.

The counterpart of ``distributed_model_parallel_tpu/orchestrator/``: many
concurrent training jobs (CNN, LM/MoE, pipeline) on one pool of device
slots, with priorities, admission control and priority preemption.
Preempting a job goes through the trainers' own preempt checkpoint;
rescheduling it onto whatever slice is free goes through
``train/elastic.fit_mesh_to_devices`` and the resharded restore. A tenant
runs on a thread of the orchestrator's process, or, when its trainer
spans several slots, as a group of ranks (``tenants.py``). The serving
fleet (``serve/fleet.py``) places its replicas on the same
:class:`DevicePool`.
"""

from distributed_model_parallel_tpu_torch.orchestrator.scheduler import (
    DevicePool,
    DeviceSlot,
    Scheduler,
)
from distributed_model_parallel_tpu_torch.orchestrator.tenants import (
    RankGroupError,
    Tenant,
    TenantSpec,
    TenantState,
)
from distributed_model_parallel_tpu_torch.orchestrator.orchestrator import (
    Orchestrator,
    UnschedulableError,
)

__all__ = [
    "DevicePool",
    "DeviceSlot",
    "Orchestrator",
    "RankGroupError",
    "Scheduler",
    "Tenant",
    "TenantSpec",
    "TenantState",
    "UnschedulableError",
]
