"""Device-pool bookkeeping for the port's serving fleet.

Counterpart of ``distributed_model_parallel_tpu/orchestrator/``. Ported so
far: :class:`~.scheduler.DevicePool`, the ownership ledger the serving
fleet (``serve/fleet.py``) places its replicas on. Still to come
(ROADMAP A11): the tenant scheduler (``Scheduler``), ``tenants.py`` and
the multi-tenant ``Orchestrator``, which co-schedule training jobs and
the serving tier on one pool.
"""

from distributed_model_parallel_tpu_torch.orchestrator.scheduler import (
    DevicePool,
    DeviceSlot,
)

__all__ = ["DevicePool", "DeviceSlot"]
