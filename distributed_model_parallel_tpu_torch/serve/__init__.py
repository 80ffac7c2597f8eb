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
* :mod:`.generate` — the command-line entry point.

Still to come with the serving fleet: the router, the multi-replica
fleet and its cells, the serve-side fault injector, the device pool, and
the fleet's crash recovery (``crash_replica``, ``recover``).
"""

from distributed_model_parallel_tpu_torch.serve.engine import (  # noqa: F401
    Engine,
    EngineKilled,
    ServeConfig,
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
