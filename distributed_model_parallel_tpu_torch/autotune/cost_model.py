"""Alpha-beta comm/compute cost model for candidate layouts — the port
of ``distributed_model_parallel_tpu/autotune/cost_model.py`` on a cost
model of the card.

One collective over an n-way axis costs

    count * ( alpha * ops(kind, n)  +  wire_bytes(kind, payload, n) / BW )

where ``ops``/``wire_bytes`` are the SAME ring-algorithm estimators
``utils/telemetry.record_collective`` accounts into the metrics registry
(``wire_ops_estimate`` / ``wire_bytes_estimate``) — the planner's
analytic schedule and the comm table are one accounting, so measured
runs can audit the prediction. ``alpha`` is per-message launch/latency,
``BW`` the per-device wire bandwidth (ring model: every device
sends/receives its share).

The compute term divides the workload's model FLOPs (probed via the
``parallel/auto_partition`` FLOP-count contract or the analytic LM
count — autotune/search.py) over the FLOP-partitioning axes and the
card's peak from ``utils/profiling.GPU_PEAK_FLOPS``; pipeline plans
multiply by the GPipe bubble ``(M + S - 1) / M`` (steady-state
throughput is set by the bubble-inflated critical path).

Seeding from live runs: :func:`observed_comm_table` parses the per-axis
byte/op totals accounted into a registry and :func:`plan_cost`
substitutes them for the analytic volumes on matching axes — a plan
re-ranked after one accounted step uses observed, not modeled, comm
volume.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from distributed_model_parallel_tpu_torch.autotune.plan import ParallelPlan
from distributed_model_parallel_tpu_torch.autotune.search import WorkloadSpec
from distributed_model_parallel_tpu_torch.utils.profiling import GPU_PEAK_FLOPS
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    wire_bytes_estimate,
    wire_ops_estimate,
)

__all__ = [
    "Collective",
    "CostCoefficients",
    "PlanCost",
    "bubble_factor",
    "collective_time_s",
    "default_coefficients",
    "observed_comm_table",
    "plan_collectives",
    "plan_cost",
]

# The card's coefficients. Peak FLOP/s: utils/profiling.GPU_PEAK_FLOPS
# by the card's name; FALLBACK_PEAK_FLOPS is the same H100 SXM figure
# (data sheet, dense bf16), used only to rank candidates on the CPU (test
# meshes, what-if planning): there the absolute seconds mean nothing, but
# every candidate is scored against the same constants, so the ranking —
# the only thing the planner consumes — stays meaningful and
# deterministic. A card missing from the table is refused, never ranked
# on the fallback.
FALLBACK_PEAK_FLOPS = GPU_PEAK_FLOPS["NVIDIA H100 80GB HBM3"]
# Wire bytes/s a device and seconds a collective message, measured over
# NCCL on four H100 SXM cards joined by NVLink 4 ("NVIDIA H100 80GB HBM3,
# 700.00 W"; chip_smoke.py --autotune-only, phase 24a on 24e's ranks,
# rank 0's reading): 200 4-byte all-reduces back to back between two CUDA
# events took 105.8 us each, over wire_ops_estimate("psum", 4) = 6 ring
# messages; 20 of 67,108,864 B took 334.0 us each, so
# wire_bytes_estimate("psum", 64 MiB, 4) = 100.7 MB crossed in 334.0 us
# less those 6 messages: 441.2 GB/s (NVLink 4's data sheet gives 450 GB/s
# a direction).
FALLBACK_WIRE_BYTES_PER_S = 441154307570.1223
DEFAULT_ALPHA_S = 17.63026714324951e-6


@dataclasses.dataclass(frozen=True)
class CostCoefficients:
    """Alpha-beta-gamma coefficients: s/message, wire bytes/s, FLOP/s.

    ``overlap_fraction`` is the share of the compute time that
    OVERLAPPABLE collectives (the data-axis gradient reduction, which the
    trainers' ``GradReducer`` launches bucket by bucket during the
    backward) can hide under; 0 prices every byte on the critical path.
    """

    alpha_s: float = DEFAULT_ALPHA_S
    wire_bytes_per_s: float = FALLBACK_WIRE_BYTES_PER_S
    peak_flops_per_s: float = FALLBACK_PEAK_FLOPS
    overlap_fraction: float = 0.5


def default_coefficients(device=None) -> CostCoefficients:
    """Coefficients for ``device`` (default: the current card, else the
    CPU): the card's peak from the profiling table, the documented
    fallbacks on the CPU. A card the table lacks raises: ranking it on
    another card's peak would be a guess."""
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        _device_name,
        peak_flops_per_chip,
    )

    name = _device_name(device)
    peak = peak_flops_per_chip(device)
    if name and peak is None:
        raise ValueError(
            f"no peak FLOP/s for {name!r} in utils/profiling."
            f"GPU_PEAK_FLOPS; add the card's data-sheet figure (the cost "
            f"model does not rank a card on another card's peak)")
    return CostCoefficients(peak_flops_per_s=peak or FALLBACK_PEAK_FLOPS)


@dataclasses.dataclass(frozen=True)
class Collective:
    """``count`` executions per step of one collective: ``kind`` over an
    n-way ``axis`` moving ``payload_bytes`` logical payload each.
    ``overlappable`` marks gradient reductions the backward can hide
    (CostCoefficients.overlap_fraction); activation collectives sit on
    the critical path and never are."""

    kind: str
    axis: str
    payload_bytes: float
    n: int
    count: float = 1.0
    overlappable: bool = False


def collective_time_s(c: Collective, coeffs: CostCoefficients) -> float:
    """Alpha-beta time of ``count`` executions (module docstring)."""
    return c.count * (
        coeffs.alpha_s * wire_ops_estimate(c.kind, c.n)
        + wire_bytes_estimate(c.kind, c.payload_bytes, c.n)
        / coeffs.wire_bytes_per_s)


def plan_collectives(w: WorkloadSpec, plan: ParallelPlan
                     ) -> list[Collective]:
    """The analytic per-step collective schedule of a plan.

    Per-axis terms (all payloads are logical, the estimators apply the
    ring factors):

    * ``data``  — gradient allreduce of the locally-owned parameter shard
      (gspmd/ddp/spmd/spmd_pipeline); FSDP instead all-gathers params
      twice (fwd + bwd re-gather) and reduce-scatters gradients;
    * ``stage`` — one boundary ppermute per pipeline tick, 2(M+S-1) total
      (fwd + bwd sweeps), microbatch-activation payload;
    * ``model`` — Megatron's 4 activation allreduces per owned layer per
      microbatch;
    * ``seq``   — 4 all-to-alls per owned layer per microbatch
      (Ulysses-style head/sequence exchange; ring attention's ppermute
      chain moves the same K/V volume);
    * ``expert``— dispatch+combine all-to-alls, top_k-scaled token
      payload.
    """
    out: list[Collective] = []
    dp, pp, tp, sp, ep = plan.dp, plan.pp, plan.tp, plan.sp, plan.ep
    M = max(1, plan.num_microbatches)
    local_b = max(1, w.batch_size // dp)
    micro_b = max(1, local_b // M)

    if w.kind == "lm":
        seq_local = max(1, w.seq_len // sp)
        micro_act = micro_b * seq_local * w.d_model * w.dtype_bytes
        layers_local = max(1, w.n_layers // pp)
        # Parameters this device owns (grad-sync payload): blocks shard
        # over pp and tp, experts additionally over ep.
        param_local_bytes = w.param_bytes / (pp * tp)
        if ep > 1 and w.expert_param_count:
            # Expert banks at the model's real storage width, like the
            # memory model (memory.py) — not a hardcoded 4 B/param.
            bytes_per_param = w.param_bytes / max(1, w.param_count)
            expert_bytes = (w.expert_param_count * bytes_per_param
                            / (pp * tp))
            param_local_bytes -= expert_bytes * (1 - 1 / ep)
        if dp > 1:
            out.append(Collective("psum", "data", param_local_bytes, dp,
                                  overlappable=True))
        if pp > 1:
            out.append(Collective("ppermute", "stage", micro_act, pp,
                                  count=2 * (M + pp - 1)))
        if tp > 1:
            out.append(Collective("psum", "model", micro_act, tp,
                                  count=4 * layers_local * M))
        if sp > 1:
            out.append(Collective("all_to_all", "seq", micro_act, sp,
                                  count=4 * layers_local * M))
        if ep > 1:
            out.append(Collective("all_to_all", "expert",
                                  micro_act * w.moe_top_k, ep,
                                  count=4 * layers_local * M))
    elif w.kind == "cnn":
        if plan.strategy == "fsdp":
            out.append(Collective("all_gather", "data", w.param_bytes,
                                  dp, count=2))
            out.append(Collective("reduce_scatter", "data", w.param_bytes,
                                  dp, overlappable=True))
        elif dp > 1:
            out.append(Collective("psum", "data", w.param_bytes, dp,
                                  overlappable=True))
        if pp > 1:
            micro_act = micro_b * w.boundary_act_bytes_per_sample
            out.append(Collective("ppermute", "stage", micro_act, pp,
                                  count=2 * (M + pp - 1)))
    else:
        raise KeyError(f"unknown workload kind {w.kind!r}")
    return out


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Scored plan: the ranker sorts by ``total_s`` (ties broken by the
    plan tuple itself — plan.py's ordered dataclass). ``comm_s`` is the
    full collective time, ``comm_hidden_s`` the part credited as
    overlapped with the backward; ``total_s`` charges only the exposed
    remainder."""

    compute_s: float
    comm_s: float
    comm_hidden_s: float
    bubble: float
    total_s: float

    def payload(self) -> dict:
        return {"compute_s": self.compute_s, "comm_s": self.comm_s,
                "comm_hidden_s": self.comm_hidden_s,
                "bubble": self.bubble, "total_s": self.total_s}


def bubble_factor(plan: ParallelPlan) -> float:
    """GPipe/1F1B steady-state bubble multiplier (1.0 off-pipeline)."""
    if plan.pp <= 1:
        return 1.0
    M = max(1, plan.num_microbatches)
    return (M + plan.pp - 1) / M


def plan_cost(w: WorkloadSpec, plan: ParallelPlan,
              coeffs: CostCoefficients | None = None, *,
              observed: Mapping[str, Mapping[str, float]] | None = None
              ) -> PlanCost:
    """Alpha-beta score of one plan.

    ``observed`` ({axis: {"bytes": ..., "ops": ...}} from
    :func:`observed_comm_table`) overrides the analytic volume on
    matching axes: the accounting of a real step beats the
    model where both exist.
    """
    coeffs = coeffs if coeffs is not None else CostCoefficients()
    flop_shards = plan.dp * plan.pp * plan.tp * max(1, plan.sp)
    compute_s = (w.flops_per_step / flop_shards) / coeffs.peak_flops_per_s
    bubble = bubble_factor(plan)
    # Group analytically per axis first: an observed per-axis total
    # replaces the axis's analytic time as a whole, and its overlap
    # credit is apportioned by the ANALYTIC overlappable share of that
    # axis (the accounting counters don't distinguish grad reductions
    # from forward gathers, so e.g. FSDP's reduce-scatter keeps its
    # credit under observed re-ranking).
    analytic: dict[str, list[float]] = {}   # axis -> [total, overlappable]
    for c in plan_collectives(w, plan):
        t = collective_time_s(c, coeffs)
        bucket = analytic.setdefault(c.axis, [0.0, 0.0])
        bucket[0] += t
        if c.overlappable:
            bucket[1] += t
    comm_s = 0.0
    overlappable_s = 0.0
    for axis, (total_t, over_t) in sorted(analytic.items()):
        if observed and axis in observed:
            obs = observed[axis]
            t = (coeffs.alpha_s * float(obs.get("ops", 0.0))
                 + float(obs.get("bytes", 0.0)) / coeffs.wire_bytes_per_s)
            frac = over_t / total_t if total_t > 0 else 0.0
            comm_s += t
            overlappable_s += t * frac
        else:
            comm_s += total_t
            overlappable_s += over_t
    hidden = min(overlappable_s,
                 coeffs.overlap_fraction * compute_s * bubble)
    total = compute_s * bubble + comm_s - hidden
    return PlanCost(compute_s=compute_s, comm_s=comm_s,
                    comm_hidden_s=hidden, bubble=bubble, total_s=total)


def observed_comm_table(counters: Mapping[str, float] | None = None
                        ) -> dict[str, dict[str, float]]:
    """Per-axis comm volume observed by the collectives' accounting:
    ``{axis: {"bytes": wire-bytes-est total, "ops": ops-est total}}``.

    ``counters`` is a flat counter mapping — by default
    ``registry().snapshot()["counters"]`` of the live process, which
    ``utils/telemetry.record_collective`` accounts into. Keys look like
    ``collective_wire_bytes_est{axis=data,kind=psum}``; kinds are summed
    per axis (the cost model consumes per-axis totals).
    """
    if counters is None:
        from distributed_model_parallel_tpu_torch.utils.telemetry import (
            registry,
        )

        counters = registry().snapshot()["counters"]
    out: dict[str, dict[str, float]] = {}
    fields = {"collective_wire_bytes_est": "bytes",
              "collective_ops_est": "ops"}
    for key, val in counters.items():
        name, _, tags = key.partition("{")
        if name not in fields or not tags.endswith("}"):
            continue
        tag_map = dict(t.split("=", 1) for t in tags[:-1].split(",")
                       if "=" in t)
        axis = tag_map.get("axis")
        if axis is None:
            continue
        bucket = out.setdefault(axis, {"bytes": 0.0, "ops": 0.0})
        bucket[fields[name]] += float(val)
    return out
