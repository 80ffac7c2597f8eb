"""Capacity observatory: cost tables, headroom, billing invariants.

Counterpart of ``distributed_model_parallel_tpu/serve/capacity.py``. The
analysis half of the resource-metering plane (utils/metering.py emits;
this module reads). Input is a telemetry stream — the typed ``meter``
records (per-residency bills), ``utilization`` records (per-replica duty
ledgers), ``rtrace`` terminals and the ``serve`` summary — and the output
is the capacity report:

* **per-tenant cost table** — chip-seconds, page-seconds, resident
  time, tokens and sheds per tenant, straight from the terminal + hop
  meter records (a migrated request's residencies sum across replicas;
  nothing is double-billed because each record bills exactly one
  residency);
* **per-replica utilization** — each replica's duty-cycle ledger
  (busy / stalled / brownout / idle / quarantined fractions of its
  wall), plus the derived **sustainable tokens/s** (observed rate
  scaled to a fully-busy duty cycle) and **headroom** (sustainable
  minus observed);
* **what-if planning** (:func:`what_if`) — project fleet capacity at
  replicas ± N from the measured per-replica sustainable rate, pricing
  per-iteration launch overhead with the ``alpha_s`` coefficient of the
  autotuner's cost model of the card (or the caller's);
* **billing invariants** (:func:`check_invariants`) — the metering
  gate:

  1. every ``utilization`` record's duty buckets partition its wall
     within the tolerance (default 1%);
  2. billed chip-seconds never exceed the fleet's iterated wall —
     the sum over replicas of (wall − quarantined) seconds, i.e.
     wall × live replicas in ledger form (a meter that over-billed
     physical chip time would fail here);
  3. every trace's terminal ``rtrace`` events pair 1:1 with terminal
     ``meter`` records — exactly one bill closes per terminal, none
     without one (hop records are residency splits, not terminals,
     and are excluded on both sides).
"""

from __future__ import annotations

from distributed_model_parallel_tpu_torch.utils.metering import (
    LEDGER_BUCKETS,
    METER_TERMINAL_EVENTS,
)
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    RTRACE_TERMINAL_EVENTS,
)

__all__ = [
    "build_capacity",
    "check_invariants",
    "tenant_costs",
    "utilization_by_replica",
    "what_if",
]


def _meter_records(records) -> list[dict]:
    return [r for r in records if r.get("kind") == "meter"]


def _utilization_records(records) -> list[dict]:
    return [r for r in records if r.get("kind") == "utilization"]


def _last_serve_summary(records) -> dict | None:
    """The run's final ``serve`` summary — fleet-policy preferred (it
    carries replica counts); a single-engine summary works for the
    degenerate one-replica capacity view."""
    fleet = None
    any_summary = None
    for r in records:
        if r.get("kind") == "serve" and r.get("event") == "summary":
            any_summary = r
            if r.get("policy") == "fleet":
                fleet = r
    return fleet if fleet is not None else any_summary


def tenant_costs(records) -> dict[str, dict]:
    """Per-tenant cost table from the meter records. Hop records add
    cost figures only; terminal records also count the request, its
    tokens and (for shed/expired) the shed."""
    out: dict[str, dict] = {}
    for r in _meter_records(records):
        row = out.setdefault(
            r.get("tenant") or "-",
            {"requests": 0, "chip_s": 0.0, "page_s": 0.0,
             "resident_s": 0.0, "tokens": 0, "sheds": 0, "hops": 0})
        row["chip_s"] += float(r.get("chip_s") or 0.0)
        row["page_s"] += float(r.get("page_s") or 0.0)
        row["resident_s"] += float(r.get("resident_s") or 0.0)
        ev = r.get("event")
        if ev in METER_TERMINAL_EVENTS:
            row["requests"] += 1
            row["tokens"] += int(r.get("tokens") or 0)
            if ev in ("shed", "expired"):
                row["sheds"] += 1
        elif ev == "hop":
            row["hops"] += 1
    for row in out.values():
        for k in ("chip_s", "page_s", "resident_s"):
            row[k] = round(row[k], 6)
    return dict(sorted(out.items()))


def utilization_by_replica(records) -> dict[str, dict]:
    """Per-replica duty ledger, summed across that replica's
    ``utilization`` records (a hard-crashed predecessor's archived
    meter emits under the same replica name — its duty history folds
    in, exactly like the fleet summary's rollup)."""
    out: dict[str, dict] = {}
    for r in _utilization_records(records):
        name = str(r.get("replica") or "-")
        row = out.setdefault(
            name, {**{f"{b}_s": 0.0 for b in LEDGER_BUCKETS},
                   "wall_s": 0.0, "iterations": 0,
                   "meter_write_s": 0.0, "cell": r.get("cell")})
        for b in LEDGER_BUCKETS:
            row[f"{b}_s"] += float(r.get(f"{b}_s") or 0.0)
        row["wall_s"] += float(r.get("wall_s") or 0.0)
        row["iterations"] += int(r.get("iterations") or 0)
        row["meter_write_s"] += float(r.get("meter_write_s") or 0.0)
    return dict(sorted(out.items()))


def _duty_fractions(row: dict) -> dict:
    wall = row.get("wall_s") or 0.0
    if wall <= 0:
        return {b: 0.0 for b in LEDGER_BUCKETS}
    return {b: row[f"{b}_s"] / wall for b in LEDGER_BUCKETS}


def build_capacity(records) -> dict:
    """The full capacity report over one (merged) telemetry stream.

    Sustainable tokens/s scales the observed completion rate to a
    fully-busy duty cycle: a replica 40% busy that moved its share of
    tokens could move ~2.5x that before saturating (brownout time
    counts as busy — it IS serving, degraded). Fleet tokens apportion
    to replicas by their busy-second share (the meter bills chips, not
    tokens, so the stream has no per-replica token count)."""
    summary = _last_serve_summary(records)
    util = utilization_by_replica(records)
    tenants = tenant_costs(records)
    meters = _meter_records(records)
    chip_s = sum(float(r.get("chip_s") or 0.0) for r in meters)
    page_s = sum(float(r.get("page_s") or 0.0) for r in meters)

    wall_s = float((summary or {}).get("wall_s") or 0.0)
    tokens = int((summary or {}).get("tokens_generated") or 0)
    observed_tps = tokens / wall_s if wall_s > 0 else 0.0
    goodput_tps = (summary or {}).get("goodput_tokens_per_s") or 0.0

    served_s = {n: row["busy_s"] + row["brownout_s"]
                for n, row in util.items()}
    total_served = sum(served_s.values())
    replicas: dict[str, dict] = {}
    for name, row in util.items():
        frac = _duty_fractions(row)
        busy_frac = frac["busy"] + frac["brownout"]
        # This replica's share of the fleet's tokens, by busy-time
        # share — then scaled to a 100% duty cycle.
        share = (served_s[name] / total_served if total_served > 0
                 else 0.0)
        rep_tps = observed_tps * share
        sustainable = rep_tps / busy_frac if busy_frac > 0 else 0.0
        replicas[name] = {
            **{f"{b}_s": round(row[f"{b}_s"], 6)
               for b in LEDGER_BUCKETS},
            "wall_s": round(row["wall_s"], 6),
            "iterations": row["iterations"],
            "cell": row.get("cell"),
            "duty": {b: round(f, 4) for b, f in frac.items()},
            "tokens_per_s": round(rep_tps, 3),
            "sustainable_tokens_per_s": round(sustainable, 3),
            "headroom_tokens_per_s": round(
                max(0.0, sustainable - rep_tps), 3),
            "meter_write_s": round(row["meter_write_s"], 6),
        }
    fleet_sustainable = sum(r["sustainable_tokens_per_s"]
                            for r in replicas.values())
    iter_wall = sum(row["wall_s"] - row["quarantined_s"]
                    for row in util.values())
    write_s = sum(row["meter_write_s"] for row in util.values())
    return {
        "wall_s": round(wall_s, 6),
        "n_replicas": (summary or {}).get("n_replicas") or len(util),
        "live_replicas": (summary or {}).get("live_replicas"),
        "tokens": tokens,
        "tokens_per_s": round(observed_tps, 3),
        "goodput_tokens_per_s": (round(float(goodput_tps), 3)
                                 if goodput_tps else 0.0),
        "billed_chip_s": round(chip_s, 6),
        "billed_page_s": round(page_s, 6),
        "meter_records": len(meters),
        "tenants": tenants,
        "replicas": replicas,
        "sustainable_tokens_per_s": round(fleet_sustainable, 3),
        "headroom_tokens_per_s": round(
            max(0.0, fleet_sustainable - observed_tps), 3),
        "headroom_fraction": (
            round(max(0.0, 1.0 - observed_tps / fleet_sustainable), 4)
            if fleet_sustainable > 0 else None),
        "metering_overhead": {
            "meter_write_s": round(write_s, 6),
            "iteration_wall_s": round(iter_wall, 6),
            "fraction": (round(write_s / iter_wall, 6)
                         if iter_wall > 0 else 0.0),
        },
    }


def what_if(cap: dict, delta: int, coeffs=None) -> dict:
    """Project fleet capacity at ``n_replicas + delta``.

    The projection takes each replica as interchangeable at the
    measured mean sustainable rate, then prices per-iteration launch
    overhead with ``coeffs.alpha_s`` (seconds a launch): every engine
    iteration pays a fixed launch cost, so the same offered load on
    fewer replicas runs proportionally more iterations per replica and
    the overhead term does NOT amortize away. ``coeffs`` defaults to the
    autotuner's cost model of the card
    (``autotune.cost_model.default_coefficients``)."""
    if coeffs is None:
        from distributed_model_parallel_tpu_torch.autotune.cost_model import (
            default_coefficients,
        )

        coeffs = default_coefficients()
    replicas = cap.get("replicas") or {}
    n = len(replicas) or int(cap.get("n_replicas") or 1)
    n2 = max(1, n + int(delta))
    per_replica = (cap.get("sustainable_tokens_per_s", 0.0) / n
                   if n else 0.0)
    # Launch-overhead fraction at the CURRENT duty: iterations per
    # iterated-wall second × alpha_s. Scaling the fleet by n/n2 scales
    # each survivor's iteration rate by the same factor at fixed
    # offered load.
    iters = sum(r.get("iterations") or 0 for r in replicas.values())
    iter_wall = sum((r.get("wall_s") or 0.0)
                    - (r.get("quarantined_s") or 0.0)
                    for r in replicas.values())
    iter_rate = iters / iter_wall if iter_wall > 0 else 0.0
    overhead_now = min(0.9, coeffs.alpha_s * iter_rate)
    overhead_then = min(0.9, overhead_now * (n / n2))
    capacity_tps = (per_replica * n2
                    * (1.0 - overhead_then) / (1.0 - overhead_now)
                    if overhead_now < 1.0 else per_replica * n2)
    observed = cap.get("tokens_per_s", 0.0)
    return {
        "replicas": n2,
        "delta": int(delta),
        "capacity_tokens_per_s": round(capacity_tps, 3),
        "offered_tokens_per_s": round(observed, 3),
        "projected_utilization": (round(observed / capacity_tps, 4)
                                  if capacity_tps > 0 else None),
        "headroom_tokens_per_s": round(
            max(0.0, capacity_tps - observed), 3),
        "saturated": bool(capacity_tps > 0
                          and observed > capacity_tps),
        "alpha_s": coeffs.alpha_s,
        "launch_overhead_fraction": round(overhead_then, 6),
    }


def check_invariants(records, *, tolerance: float = 0.01) -> list[str]:
    """The metering gate's billing invariants (module docstring).
    Returns human-readable failure strings; empty means
    the stream's billing is sound."""
    failures: list[str] = []
    utils = _utilization_records(records)
    meters = _meter_records(records)

    # 1. Duty buckets partition each utilization record's wall.
    for r in utils:
        wall = float(r.get("wall_s") or 0.0)
        total = sum(float(r.get(f"{b}_s") or 0.0)
                    for b in LEDGER_BUCKETS)
        if wall <= 1e-9:
            if total > 1e-9:
                failures.append(
                    f"utilization record for {r.get('replica')}: "
                    f"buckets sum to {total:.6f}s on zero wall")
            continue
        err = abs(total - wall) / wall
        if err > tolerance:
            failures.append(
                f"duty buckets do not partition wall on "
                f"{r.get('replica')}: |{total:.6f} - {wall:.6f}| "
                f"= {err:.2%} > {tolerance:.0%}")

    # 2. Billed chip-seconds bounded by iterated wall (= wall x live
    # replicas in ledger form: quarantined time never iterates).
    chip_s = sum(float(r.get("chip_s") or 0.0) for r in meters)
    if utils:
        budget = sum(float(r.get("wall_s") or 0.0)
                     - float(r.get("quarantined_s") or 0.0)
                     for r in utils)
        source = "iterated wall (utilization ledger)"
    else:
        summary = _last_serve_summary(records)
        if summary is None:
            failures.append("no utilization records and no serve "
                            "summary: cannot bound billed chip time")
            budget = None
            source = None
        else:
            budget = (float(summary.get("wall_s") or 0.0)
                      * int(summary.get("n_replicas") or 1))
            source = "summary wall x n_replicas"
    if budget is not None and chip_s > budget * (1.0 + tolerance):
        failures.append(
            f"billed chip-seconds exceed {source}: "
            f"{chip_s:.6f}s > {budget:.6f}s")

    # 3. Terminal rtrace events pair 1:1 with terminal meter records.
    rtrace_terms: dict[str, int] = {}
    for r in records:
        if (r.get("kind") == "rtrace" and r.get("trace") is not None
                and r.get("event") in RTRACE_TERMINAL_EVENTS):
            t = str(r["trace"])
            rtrace_terms[t] = rtrace_terms.get(t, 0) + 1
    meter_terms: dict[str, int] = {}
    for r in meters:
        if (r.get("trace") is not None
                and r.get("event") in METER_TERMINAL_EVENTS):
            t = str(r["trace"])
            meter_terms[t] = meter_terms.get(t, 0) + 1
    for t, n in rtrace_terms.items():
        m = meter_terms.get(t, 0)
        if m != n:
            failures.append(
                f"trace {t}: {n} terminal rtrace event(s) but {m} "
                f"terminal meter record(s)")
    for t, m in meter_terms.items():
        if t not in rtrace_terms:
            failures.append(
                f"trace {t}: {m} terminal meter record(s) with no "
                f"terminal rtrace event")
    return failures
