"""Continuous-batching decode service: paged KV cache + inflight scheduler.

* :mod:`.paged_kv` — the device page pool and host-side page tables;
* :mod:`.model` — the paged prefill/decode forward (decode attention
  through the paged CUDA kernel);
* :mod:`.scheduler` — request queue + iteration-level batching;
* :mod:`.engine` — the loop wiring them together, with per-request TTFT
  and per-token latency;
* :mod:`.generate` — the command-line entry point.
"""

from distributed_model_parallel_tpu_torch.serve.engine import (  # noqa: F401
    Engine,
    EngineKilled,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve.paged_kv import (  # noqa: F401
    PagedKVCache,
    PagePool,
    PagePoolError,
)
from distributed_model_parallel_tpu_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestState,
)
