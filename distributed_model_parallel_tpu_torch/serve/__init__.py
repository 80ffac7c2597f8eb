"""Continuous-batching decode service: paged KV cache + inflight scheduler.

* :mod:`.paged_kv` — the device page pool and host-side page tables,
  refcounted for prefix sharing, with request export/import by value;
* :mod:`.prefix_cache` — the radix tree over token prefixes;
* :mod:`.spec` — the n-gram proposer of speculative decoding;
* :mod:`.model` — the paged prefill/decode/verify forward (decode and
  verify attention through the paged CUDA kernel);
* :mod:`.scheduler` — request queue + iteration-level batching, with
  priority classes, queue and total deadlines and the queue bound;
* :mod:`.overload` — the brownout ladder and the admission circuit
  breaker;
* :mod:`.journal` — the write-ahead request journal and its fold;
* :mod:`.engine` — the loop wiring them together, with per-request TTFT
  and per-token latency, typed sheds, drain/import between engines, and
  the journal, metering, telemetry, tracing and status planes;
* :mod:`.capacity` — cost tables and billing invariants over the
  metering records;
* :mod:`.traffic` — seeded traffic programs and the virtual clock;
* :mod:`.router` — the SLO-aware replica picker (p2c over load, prefix
  affinity, home cells);
* :mod:`.cells` — the cell directory and the home-cell hash;
* :mod:`.fleet` — N engine replicas on a device pool behind the router:
  health quarantine, drain and migration, grow-back, cell faults, hard
  crashes recovered from the journal, and the fleet restart
  (``ServeFleet.recover``);
* :mod:`.generate` — the command-line entry point.

The fleet's device pool is the orchestrator's ``DevicePool``
(``orchestrator/``, which schedules the training tenants). Still to come
(ROADMAP A11): the serving CLIs (``dmp_soak``'s fleet scenarios among
them).
"""

from distributed_model_parallel_tpu_torch.serve.cells import (  # noqa: F401
    CellDirectory,
)
from distributed_model_parallel_tpu_torch.serve.engine import (  # noqa: F401
    Engine,
    EngineKilled,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve.fleet import (  # noqa: F401
    Replica,
    ServeFleet,
)
from distributed_model_parallel_tpu_torch.serve.model import (  # noqa: F401
    make_verify_step,
)
from distributed_model_parallel_tpu_torch.serve.overload import (  # noqa: F401
    BrownoutController,
    CircuitBreaker,
)
from distributed_model_parallel_tpu_torch.serve.paged_kv import (  # noqa: F401
    PagedKVCache,
    PagePool,
    PagePoolError,
)
from distributed_model_parallel_tpu_torch.serve.prefix_cache import (  # noqa: F401
    PrefixCache,
)
from distributed_model_parallel_tpu_torch.serve.router import (  # noqa: F401
    Router,
)
from distributed_model_parallel_tpu_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestState,
    Scheduler,
)
from distributed_model_parallel_tpu_torch.serve.spec import (  # noqa: F401
    NGramProposer,
)
from distributed_model_parallel_tpu_torch.serve.traffic import (  # noqa: F401
    SimClock,
    adversarial_flood,
    diurnal,
    flash_crowd,
    merge_traces,
    mixed_tenants,
)
