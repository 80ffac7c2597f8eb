"""Search space: workload probes + feasible-layout enumeration — the port
of ``distributed_model_parallel_tpu/autotune/search.py``.

The planner never guesses model properties — it probes them once into a
:class:`WorkloadSpec` (param/FLOP/activation numbers) and then enumerates
every ``(dp, pp, tp, sp, ep)`` factorization of the device count that the
workload's divisibility rules allow:

* ``dp`` must divide the global batch (static shapes — ``mesh.
  local_batch_slice`` rejects uneven splits);
* ``pp`` must divide the LM block count (``parallel/spmd_pipeline`` splits
  the stacked blocks evenly) or stay within the staged CNN's unit count;
* ``tp`` must divide heads AND d_ff (Megatron column/row splits);
* ``sp`` must divide the sequence length AND the head count (ring shards
  the sequence, Ulysses additionally scatters heads);
* ``ep`` needs a routed MoE and must divide the expert count.

FLOP probes reuse the public ``parallel/auto_partition`` contract
(``unit_costs`` — XLA's FLOP count per unit, counted from shapes on the
``meta`` device — for staged CNNs, ``utils/profiling.lm_model_flops``
analytically for the Transformer), so the cost model ranks with the same
numbers the pipeline balancer cuts by. Every probe runs on ``meta`` or
CPU tensors, never on a card: each rank plans for itself, and every
input to the plan must be the same on every rank.

Enumeration is deterministic: candidates come out in sorted
``(strategy, dp, pp, tp, sp, ep)`` order, so equal inputs always produce
the identical candidate list (tests pin this).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

__all__ = [
    "WorkloadSpec",
    "cnn_workload",
    "enumerate_plans",
    "enumerate_stage_pipeline_plans",
    "lm_workload",
    "pick_microbatches",
]

from distributed_model_parallel_tpu_torch.autotune.plan import ParallelPlan

# Largest microbatch count the picker will choose: past this the GPipe
# bubble (S-1)/(M+S-1) is already small and each extra microbatch only
# adds boundary-ppermute latency (the alpha term).
MAX_MICROBATCHES = 32


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything the cost/memory models need to score a layout, probed
    once per planning call (no live model objects cross this boundary —
    the spec is plain data, picklable and hand-constructible in tests)."""

    kind: str                     # "lm" | "cnn"
    batch_size: int
    flops_per_step: float         # model FLOPs of ONE global-batch step
    param_count: int
    param_bytes: int              # at storage dtype (f32 here)
    dtype_bytes: int = 4          # activation/compute dtype width
    # -- LM geometry ---------------------------------------------------------
    seq_len: int = 0
    d_model: int = 0
    n_layers: int = 0
    n_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    moe_experts: int = 0
    moe_top_k: int = 1
    expert_param_count: int = 0   # subset of param_count sharded by ep
    # Sliding-window attention is incompatible with sequence parallelism
    # (models/transformer._attention rejects the combination), so a set
    # window pins sp = 1.
    attn_window: int | None = None
    # -- staged-CNN geometry -------------------------------------------------
    n_units: int = 0
    unit_flop_costs: tuple[float, ...] = ()
    # Largest inter-unit activation, bytes per sample (the pipeline
    # boundary payload).
    boundary_act_bytes_per_sample: int = 0


def lm_workload(model_cfg, batch_size: int, seq_len: int) -> WorkloadSpec:
    """Probe a ``TransformerConfig`` into a WorkloadSpec.

    Parameter counts come from the port's parameter tree layout
    (``models/transformer.param_specs``: shapes only, no tensor made),
    every leaf at the config's ``dtype`` as ``init_params`` makes it;
    FLOPs from the analytic ``utils/profiling.lm_model_flops``.
    """
    import math

    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        lm_model_flops,
    )

    cfg = model_cfg
    specs = tfm.param_specs(cfg)
    shapes = [s for k, v in specs.items()
              for s in (v.values() if k == "blocks" else (v,))]
    param_count = int(sum(math.prod(shape) for shape, _ in shapes))
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    expert_params = 0
    if cfg.moe_experts:
        # Per layer: expert FFN banks [E, d, f] + [E, f, d] (+ router d*E).
        expert_params = cfg.n_layers * cfg.moe_experts * (
            2 * cfg.d_model * cfg.d_ff + cfg.d_model)
    return WorkloadSpec(
        kind="lm", batch_size=batch_size,
        flops_per_step=lm_model_flops(cfg, batch_size, seq_len),
        param_count=param_count, param_bytes=param_count * itemsize,
        dtype_bytes=itemsize,
        seq_len=seq_len, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
        moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
        expert_param_count=min(expert_params, param_count),
        attn_window=cfg.attn_window)


def cnn_workload(model_cfg, data_cfg, *, probe_rows: int = 4) -> WorkloadSpec:
    """Probe a staged CNN (``models/get_model``) into a WorkloadSpec.

    Per-unit FLOPs come from the public ``parallel/auto_partition.
    unit_costs`` contract at ``probe_rows`` batch rows, scaled to the
    global batch; the forward count is tripled for fwd+bwd. A second walk
    of the unit chain on the ``meta`` device records the largest
    inter-unit activation — the pipeline's boundary-hop payload — at the
    width of the config's compute ``dtype`` (what a unit hands the next
    one, as the JAX probe counts it: 2 bytes an element in bf16).
    """
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        DTYPES,
        get_model,
    )
    from distributed_model_parallel_tpu_torch.parallel.auto_partition import (
        meta_copy,
        unit_costs,
    )

    model = get_model(model_cfg, device="cpu")
    hw = data_cfg.image_size
    costs = unit_costs(model, (probe_rows, hw, hw, 3))

    itemsize = torch.empty((), dtype=DTYPES[model_cfg.dtype]).element_size()
    meta = meta_copy(model)
    x = torch.empty(probe_rows, 3, hw, hw, device="meta")
    boundary = 0
    for i, unit in enumerate(meta.units):
        x = unit(x, True)
        if i < len(meta.units) - 1:   # the head's output never hops stages
            boundary = max(boundary, x.numel() // probe_rows * itemsize)

    param_count = int(sum(p.numel() for p in model.parameters()))
    scale = data_cfg.batch_size / probe_rows
    return WorkloadSpec(
        kind="cnn", batch_size=data_cfg.batch_size,
        flops_per_step=3.0 * float(sum(costs)) * scale,
        param_count=param_count, param_bytes=param_count * 4,
        dtype_bytes=4,
        n_units=len(meta.units), unit_flop_costs=tuple(costs),
        boundary_act_bytes_per_sample=boundary)


def pick_microbatches(local_batch: int, pp: int,
                      cap: int = MAX_MICROBATCHES) -> int:
    """Microbatch count for a pp-deep pipeline at per-replica batch
    ``local_batch``: the largest divisor of the local batch within
    ``cap`` (more microbatches = smaller GPipe bubble; the cap bounds the
    per-microbatch boundary-latency alpha cost). pp==1 pipelines don't
    microbatch."""
    if pp <= 1 or local_batch <= 1:
        return 1
    return max(m for m in range(1, min(local_batch, cap) + 1)
               if local_batch % m == 0)


def _factorizations(n: int, k: int) -> Iterator[tuple[int, ...]]:
    """All ordered k-tuples of positive ints with product n, sorted."""
    if k == 1:
        yield (n,)
        return
    for d in sorted(d for d in range(1, n + 1) if n % d == 0):
        for rest in _factorizations(n // d, k - 1):
            yield (d,) + rest


def _lm_axes_feasible(w: WorkloadSpec, dp: int, pp: int, tp: int,
                      sp: int, ep: int) -> bool:
    if w.batch_size % dp:
        return False
    if pp > 1 and (w.n_layers == 0 or w.n_layers % pp):
        return False
    if tp > 1 and (w.n_heads % tp or w.d_ff % tp):
        return False
    # sp divides the sequence AND the LOCAL head count after the tp cut
    # (Ulysses scatters the heads tp left on each device; checking
    # heads % sp alone admits tp x sp combos that die at trace time),
    # and windowed attention pins sp = 1 (transformer._attention).
    if sp > 1 and (w.seq_len % sp
                   or (w.n_heads // max(1, tp)) % sp
                   or w.attn_window is not None):
        return False
    if ep > 1 and (not w.moe_experts or w.moe_experts % ep):
        return False
    return True


def enumerate_plans(workload: WorkloadSpec, n_devices: int, *,
                    strategies: Sequence[str] | None = None
                    ) -> list[ParallelPlan]:
    """Every feasible layout of ``n_devices`` for the workload, in
    deterministic sorted order (same inputs -> identical list).

    LM: one strategy ("spmd", the single-jit dp x pp x tp x sp x ep
    program) over all axis factorizations. CNN: the data-axis engines
    (gspmd / fsdp / optionally ddp) use every device as dp; the SPMD CNN
    pipeline contributes every (dp, pp>=2) split within the unit count.
    """
    if n_devices < 1:
        raise ValueError(f"need >= 1 device, got {n_devices}")
    out: list[ParallelPlan] = []
    if workload.kind == "lm":
        for dp, pp, tp, sp, ep in _factorizations(n_devices, 5):
            if not _lm_axes_feasible(workload, dp, pp, tp, sp, ep):
                continue
            m = pick_microbatches(workload.batch_size // dp, pp)
            out.append(ParallelPlan("spmd", dp, pp, tp, sp, ep,
                                    num_microbatches=m))
    elif workload.kind == "cnn":
        strategies = tuple(strategies if strategies is not None
                           else ("gspmd", "fsdp", "spmd_pipeline"))
        for s in strategies:
            if s in ("gspmd", "ddp", "fsdp"):
                if workload.batch_size % n_devices == 0:
                    out.append(ParallelPlan(s, dp=n_devices))
            elif s == "spmd_pipeline":
                for pp in sorted(d for d in range(2, n_devices + 1)
                                 if n_devices % d == 0):
                    dp = n_devices // pp
                    if workload.n_units and pp > workload.n_units:
                        continue
                    if workload.batch_size % dp:
                        continue
                    m = pick_microbatches(workload.batch_size // dp, pp)
                    out.append(ParallelPlan(s, dp=dp, pp=pp,
                                            num_microbatches=m))
            else:
                raise KeyError(f"unknown cnn strategy {s!r}")
    else:
        raise KeyError(f"unknown workload kind {workload.kind!r}")
    return sorted(out)


def enumerate_stage_pipeline_plans(workload: WorkloadSpec, n_stages: int
                                   ) -> list[ParallelPlan]:
    """Single-controller PipelineRunner space (train/pipeline_trainer.py):
    the stage count is fixed by the device list, so the only free knob is
    the microbatch count — one candidate per divisor of the batch."""
    if workload.batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    return sorted(
        ParallelPlan("pipeline", dp=1, pp=n_stages, num_microbatches=m)
        for m in range(1, min(workload.batch_size, MAX_MICROBATCHES) + 1)
        if workload.batch_size % m == 0)
