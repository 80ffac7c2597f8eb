"""HBM memory-feasibility filter: reject layouts that cannot fit — the
port of ``distributed_model_parallel_tpu/autotune/memory.py``, its
footprint model unchanged.

Per-device footprint of a candidate plan, modeled after how the
trainers lay state out (not an idealized sharding); the model is the JAX
package's, unchanged, so that both packages accept and rank the same
layouts:

* **params** — LM: blocks shard over (pp, tp), experts additionally over
  ep, replicated over dp (``parallel/tensor_parallel.shard_tree``).
  CNN: replicated, except FSDP (sharded over dp,
  ``parallel/fsdp.shard_model``) and the single-controller pipeline
  (each stage's params live on their own device, ~1/pp,
  ``parallel/pipeline.py``); the SPMD CNN pipeline replicates.
* **grads** — transient copy of the locally-owned params (same sharding;
  FSDP's reduce-scatter output is 1/dp).
* **optimizer state** — one f32 momentum copy (``train/optim``'s SGD).
  LM: priced replicated, as the JAX LM trainer keeps it (the port's
  keeps each rank's slices, so the figure overstates a pp/tp plan's
  state and never flatters one). CNN: replicated, except FSDP (sharded
  over dp).
* **activations** — live residuals of the local layer/unit slice at the
  local batch (GPipe holds all M microbatches' residuals at peak, 1F1B
  bounds in-flight microbatches by the stage count), plus one
  microbatch's logits for the LM head (the largest single tensor at
  small models).

The capacity side is the card's ``total_memory``
(``torch.cuda.get_device_properties``), or the caller's override (CPU
test meshes, what-if planning).
"""

from __future__ import annotations

from typing import Mapping

from distributed_model_parallel_tpu_torch.autotune.plan import ParallelPlan
from distributed_model_parallel_tpu_torch.autotune.search import WorkloadSpec

__all__ = [
    "device_hbm_bytes",
    "estimate_plan_memory",
    "memory_feasible",
]

# Fraction of HBM a plan may claim: the rest covers XLA scratch,
# fragmentation, and the input pipeline's resident batches.
DEFAULT_FIT_FRACTION = 0.9


def device_hbm_bytes(default: float | None = None, *,
                     device=None) -> float | None:
    """Per-device HBM capacity of ``device`` (default: the current card):
    the card's ``total_memory`` (the same on every rank of a mesh of one
    card kind — never ``mem_get_info``, whose free bytes differ from rank
    to rank, so ranks that plan for themselves would disagree), else
    ``default`` on the CPU (None = unknown; the filter then passes
    everything and says so)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return default
    if not torch.cuda.is_available():
        return default
    index = torch.device(device).index if device is not None else None
    return float(torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).total_memory)


def estimate_plan_memory(w: WorkloadSpec, plan: ParallelPlan
                         ) -> dict[str, float]:
    """Per-device footprint breakdown (bytes) of one plan: params, grads,
    optimizer state, activations, and their ``total``."""
    dp, pp, tp, sp, ep = plan.dp, plan.pp, plan.tp, plan.sp, plan.ep
    M = max(1, plan.num_microbatches)
    local_b = max(1, w.batch_size // dp)
    micro_b = max(1, local_b // M)

    if w.kind == "lm":
        params = w.param_bytes / (pp * tp)
        if ep > 1 and w.expert_param_count:
            # Expert banks at the model's real storage width (bf16 params
            # are 2 B/param, not 4), sharded pp*tp like the rest.
            bytes_per_param = w.param_bytes / max(1, w.param_count)
            expert_bytes = (w.expert_param_count * bytes_per_param
                            / (pp * tp))
            params -= expert_bytes * (1 - 1 / ep)
        grads = params
        # Momentum is replicated in the LM trainer (module docstring).
        opt = w.param_count * 4.0
        seq_local = max(1, w.seq_len // sp)
        layers_local = max(1, w.n_layers // pp)
        # Residuals per microbatch per layer: ~2 block-IO copies under
        # remat; GPipe keeps all M microbatches' residuals live.
        inflight = M if pp > 1 else 1
        acts = (inflight * micro_b * seq_local * w.d_model
                * layers_local * 2 * w.dtype_bytes)
        # One microbatch's logits at the LM head.
        acts += micro_b * seq_local * w.vocab_size * w.dtype_bytes
    elif w.kind == "cnn":
        # FSDP shards over dp; the single-controller pipeline ("pipeline",
        # parallel/pipeline.py) places each stage's params + optimizer on
        # its own device (~1/pp each); the SPMD CNN pipeline and the
        # gspmd/ddp engines replicate (spmd_cnn_pipeline.py docstring).
        if plan.strategy == "fsdp":
            shard = dp
        elif plan.strategy == "pipeline":
            shard = max(1, pp)
        else:
            shard = 1
        params = w.param_bytes / shard
        grads = params
        opt = w.param_count * 4.0 / shard
        units_local = max(1, (w.n_units or 1) // max(1, pp))
        inflight = M if pp > 1 else 1
        acts = (inflight * micro_b * w.boundary_act_bytes_per_sample
                * units_local * 2)
    else:
        raise KeyError(f"unknown workload kind {w.kind!r}")
    out = {"params_bytes": float(params), "grads_bytes": float(grads),
           "opt_bytes": float(opt), "act_bytes": float(acts)}
    out["total"] = sum(out.values())
    return out


def memory_feasible(w: WorkloadSpec, plan: ParallelPlan,
                    hbm_bytes: float | None, *,
                    fit_fraction: float = DEFAULT_FIT_FRACTION
                    ) -> tuple[bool, Mapping[str, float], str | None]:
    """``(fits, breakdown, reason)``: whether the plan's estimated
    footprint fits ``fit_fraction`` of the per-device capacity. Unknown
    capacity (None) passes everything — the planner records that the
    filter did not run rather than silently trusting a made-up number."""
    est = estimate_plan_memory(w, plan)
    if hbm_bytes is None:
        return True, est, None
    budget = fit_fraction * hbm_bytes
    if est["total"] > budget:
        return False, est, (
            f"needs {est['total'] / 1e9:.2f} GB/device "
            f"> {budget / 1e9:.2f} GB budget "
            f"({fit_fraction:.0%} of {hbm_bytes / 1e9:.1f} GB)")
    return True, est, None
