"""Continuous-batching decode service: paged KV cache + inflight scheduler.

* :mod:`.paged_kv` — the device page pool and host-side page tables,
  refcounted for prefix sharing;
* :mod:`.prefix_cache` — the radix tree over token prefixes;
* :mod:`.spec` — the n-gram proposer of speculative decoding;
* :mod:`.model` — the paged prefill/decode/verify forward (decode and
  verify attention through the paged CUDA kernel);
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
from distributed_model_parallel_tpu_torch.serve.model import (  # noqa: F401
    make_verify_step,
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
)
from distributed_model_parallel_tpu_torch.serve.spec import (  # noqa: F401
    NGramProposer,
)
