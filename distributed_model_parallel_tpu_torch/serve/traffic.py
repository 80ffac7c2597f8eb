"""Seeded production-traffic programs + the engine's virtual clock.

Counterpart of ``distributed_model_parallel_tpu/serve/traffic.py`` (no
framework code; the port's own copy). Real serving load has diurnal
curves, flash crowds, adversarial long-prompt floods and mixed tenant
classes with different SLOs. This module synthesizes those shapes
DETERMINISTICALLY — every program is a pure function of its seed and
knobs, returning a plain list of request dicts
(``rid``/``prompt``/``max_new``/``arrival_s``/``priority``/``seed`` plus
optional per-request ``queue_budget_s``/``deadline_s``/``tenant``).

Arrivals come from a time-varying Poisson process via thinning (Lewis &
Shedler): draw candidate inter-arrivals at the program's peak rate, keep
each with probability ``rate(t)/peak`` — exact for any bounded rate
curve, and deterministic for a fixed ``random.Random`` seed.

:class:`SimClock` is the other half of determinism: a virtual monotonic
clock an engine stamps time from (``Engine(..., clock=)``). A driver
advances it by a fixed ``dt`` a round, idle gaps skip straight to the
next arrival, and every TTFT / deadline / goodput number is computed in
virtual seconds — so a scenario's event schedule is identical on a
loaded host and a fast one. Without a SimClock the engine keeps its real
``time.monotonic`` behavior.
"""

from __future__ import annotations

import random

__all__ = [
    "SimClock",
    "adversarial_flood",
    "diurnal",
    "flash_crowd",
    "merge_traces",
    "mixed_tenants",
    "poisson_arrivals",
]


class SimClock:
    """Virtual monotonic clock: starts at 0, advances only when told.

    Callable (``clock()`` -> current virtual seconds) so it drops in for
    ``time.monotonic``; :meth:`tick` advances one round's ``dt``
    and :meth:`advance_to` skips idle gaps (never backwards — the
    monotonic contract).
    """

    def __init__(self, dt: float = 0.02):
        if dt <= 0:
            raise ValueError(f"dt must be > 0, got {dt}")
        self.dt = float(dt)
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float | None = None) -> float:
        self.t += self.dt if dt is None else float(dt)
        return self.t

    def advance_to(self, t: float) -> float:
        self.t = max(self.t, float(t))
        return self.t


def poisson_arrivals(rng: random.Random, rate_fn, horizon_s: float,
                     peak_rate: float) -> list[float]:
    """Arrival times on [0, horizon_s) of an inhomogeneous Poisson
    process with intensity ``rate_fn(t) <= peak_rate``, by thinning.
    Deterministic for a fixed rng state."""
    if peak_rate <= 0:
        return []
    out, t = [], 0.0
    while True:
        t += rng.expovariate(peak_rate)
        if t >= horizon_s:
            return out
        if rng.random() * peak_rate <= rate_fn(t):
            out.append(t)


# Per-SLO-class request shapes: (prompt_len range, max_new range). Sized
# for the tiny-model drill fleets (vocab 64, max_seq_len 64) — scenario
# scale comes from replica count x request count, not sequence length.
_CLASSES = {
    "interactive": {"prompt": (4, 10), "gen": (6, 14)},
    "batch": {"prompt": (8, 20), "gen": (10, 22)},
}


def _request(rng: random.Random, rid: str, arrival_s: float, *,
             priority: str, vocab: int, tenant: str | None = None,
             prompt_len: tuple[int, int] | None = None,
             gen: tuple[int, int] | None = None,
             queue_budget_s: float | None = None,
             deadline_s: float | None = None) -> dict:
    shape = _CLASSES[priority if priority in _CLASSES else "interactive"]
    plo, phi = prompt_len or shape["prompt"]
    glo, ghi = gen or shape["gen"]
    return {
        "rid": rid,
        "prompt": [rng.randrange(vocab) for _ in range(rng.randint(plo,
                                                                   phi))],
        "max_new": rng.randint(glo, ghi),
        "arrival_s": round(arrival_s, 6),
        "priority": priority,
        "seed": rng.randrange(2 ** 31),
        "tenant": tenant or priority,
        "queue_budget_s": queue_budget_s,
        "deadline_s": deadline_s,
    }


def merge_traces(*traces: list[dict]) -> list[dict]:
    """Compose programs: one trace, arrival-ordered (ties by rid so the
    merge itself is deterministic). Duplicate rids are rejected — every
    request must stay attributable to the program that emitted it."""
    out = [r for t in traces for r in t]
    rids = [r["rid"] for r in out]
    if len(set(rids)) != len(rids):
        dup = sorted({r for r in rids if rids.count(r) > 1})
        raise ValueError(f"duplicate rids across merged traces: {dup}")
    return sorted(out, key=lambda r: (r["arrival_s"], r["rid"]))


def diurnal(seed: int, *, horizon_s: float, base_rate: float,
            peak_rate: float, vocab: int = 64, prefix: str = "d",
            interactive_share: float = 0.7,
            queue_budget_s: float | None = None,
            deadline_s: float | None = None) -> list[dict]:
    """One compressed diurnal cycle: a sinusoid from ``base_rate``
    (midnight) up to ``peak_rate`` (midday, at ``horizon_s/2``) and back
    down, mixed interactive/batch."""
    import math

    rng = random.Random(seed)
    half = (peak_rate - base_rate) / 2.0

    def rate(t: float) -> float:
        return (base_rate + half
                * (1.0 - math.cos(2.0 * math.pi * t / horizon_s)))

    out = []
    for i, t in enumerate(poisson_arrivals(rng, rate, horizon_s,
                                           peak_rate)):
        prio = ("interactive" if rng.random() < interactive_share
                else "batch")
        out.append(_request(rng, f"{prefix}{i}", t, priority=prio,
                            vocab=vocab, queue_budget_s=queue_budget_s,
                            deadline_s=deadline_s))
    return out


def flash_crowd(seed: int, *, horizon_s: float, base_rate: float,
                spike_at_s: float, spike_s: float, spike_rate: float,
                vocab: int = 64, prefix: str = "f",
                queue_budget_s: float | None = None,
                deadline_s: float | None = None) -> list[dict]:
    """Steady interactive load with a rectangular arrival spike: rate
    jumps to ``spike_rate`` on [spike_at_s, spike_at_s + spike_s) — the
    everyone-hits-refresh event the brownout ladder exists for."""
    rng = random.Random(seed)

    def rate(t: float) -> float:
        return (spike_rate if spike_at_s <= t < spike_at_s + spike_s
                else base_rate)

    return [
        _request(rng, f"{prefix}{i}", t, priority="interactive",
                 vocab=vocab, queue_budget_s=queue_budget_s,
                 deadline_s=deadline_s)
        for i, t in enumerate(poisson_arrivals(
            rng, rate, horizon_s, max(base_rate, spike_rate)))]


def adversarial_flood(seed: int, *, horizon_s: float, base_rate: float,
                      flood_at_s: float, flood_n: int,
                      flood_prompt_len: tuple[int, int] = (24, 40),
                      flood_gen: tuple[int, int] = (16, 24),
                      flood_spacing_s: float = 0.0, vocab: int = 64,
                      prefix: str = "a",
                      queue_budget_s: float | None = None,
                      deadline_s: float | None = None) -> list[dict]:
    """Interactive background traffic plus an adversarial long-prompt
    burst: ``flood_n`` batch-class requests with outsized prompts and
    generations land (near-)simultaneously at ``flood_at_s`` — the
    page-pool-eating abuse shape the priority shed order and bounded
    queues must absorb without starving the interactive class."""
    rng = random.Random(seed)
    out = [
        _request(rng, f"{prefix}{i}", t, priority="interactive",
                 vocab=vocab, queue_budget_s=queue_budget_s,
                 deadline_s=deadline_s)
        for i, t in enumerate(poisson_arrivals(
            rng, lambda _t: base_rate, horizon_s, base_rate))]
    flood = [
        _request(rng, f"{prefix}flood{j}",
                 flood_at_s + j * flood_spacing_s, priority="batch",
                 vocab=vocab, tenant="flood",
                 prompt_len=flood_prompt_len, gen=flood_gen,
                 queue_budget_s=queue_budget_s, deadline_s=deadline_s)
        for j in range(flood_n)]
    return merge_traces(out, flood)


def mixed_tenants(seed: int, *, horizon_s: float,
                  tenants: dict[str, dict], vocab: int = 64,
                  prefix: str = "m") -> list[dict]:
    """Independent per-tenant Poisson streams with per-tenant SLO
    classes: each entry of ``tenants`` maps a name to ``{"rate",
    "priority"}`` plus optional ``queue_budget_s`` / ``deadline_s`` /
    ``prompt_len`` / ``gen`` overrides — the interactive tenants ride
    the priority classes (batch sheds first), the batch tenants soak up
    slack capacity."""
    streams = []
    for k, (name, spec) in enumerate(sorted(tenants.items())):
        rng = random.Random((seed * 1_000_003 + k) & 0x7FFFFFFF)
        rate = float(spec["rate"])
        streams.append([
            _request(rng, f"{prefix}-{name}-{i}", t,
                     priority=spec.get("priority", "interactive"),
                     vocab=vocab, tenant=name,
                     prompt_len=spec.get("prompt_len"),
                     gen=spec.get("gen"),
                     queue_budget_s=spec.get("queue_budget_s"),
                     deadline_s=spec.get("deadline_s"))
            for i, t in enumerate(poisson_arrivals(
                rng, lambda _t: rate, horizon_s, rate))])
    return merge_traces(*streams)
