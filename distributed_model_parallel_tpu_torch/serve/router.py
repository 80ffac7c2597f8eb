"""SLO-aware request router for a multi-replica serving fleet.

Counterpart of ``distributed_model_parallel_tpu/serve/router.py`` (no
framework code; the port's own copy). One fleet-level decision per
request: which replica gets it. The policy is power-of-two-choices over
live load — two distinct seeded samples, the less loaded wins — with a
prefix-affinity override: a replica whose radix tree already holds a
usable prefix of the prompt wins unless it is more than
``affinity_slack`` busier than the least-loaded candidate.

Load is queued + resident requests + page occupancy, read off each
candidate engine's scheduler and cache at decision time. On a celled
fleet (serve/cells.py) the key is (cell, prefix, load): affinity still
wins outright, else p2c is confined to the prompt's home cell (reason
``cell-local``) and widens to the other cells only when the home cell
offers no candidate (reason ``failover``). Migration placements bypass
p2c and go least-loaded.

Determinism: the rng is ``random.Random(seed)`` and its draws come in
the JAX router's order, so given the same loads both packages pick the
same replica, draw for draw.
"""

from __future__ import annotations

import random

from distributed_model_parallel_tpu_torch.utils import tracing

__all__ = ["Router"]


class Router:
    """Deterministic SLO-aware replica picker (module docstring). The
    fleet owns replica lifecycle; the router keeps only its assignment
    bookkeeping."""

    def __init__(self, seed: int = 0, *, affinity_slack: float = 2.0,
                 affinity_min_tokens: int = 1, cells=None):
        if affinity_slack < 0:
            raise ValueError(f"affinity_slack must be >= 0, got "
                             f"{affinity_slack}")
        self._seed = int(seed)
        self._rng = random.Random(seed)
        self.affinity_slack = affinity_slack
        self.affinity_min_tokens = affinity_min_tokens
        self.cells = cells
        # name -> requests routed there (statusz + the fleet summary)
        self.assignments: dict[str, int] = {}
        self.affinity_hits = 0
        self.failovers = 0

    @staticmethod
    def load(replica) -> float:
        """A replica's live load: queued + resident requests, plus page
        occupancy as the fractional tie-break toward the emptier pool."""
        eng = replica.engine
        return (len(eng.sched.queue)
                + sum(1 for s in eng.sched.slots if s is not None)
                + eng.cache.occupancy)

    def pick(self, prompt: list[int], replicas: list, *,
             migrate: bool = False, commit: bool = True,
             request=None, sink=None) -> tuple[object, str, dict]:
        """Choose a live replica for ``prompt``. Returns ``(replica,
        reason, loads)``; reason is ``affinity``, ``p2c``, ``cell-local``,
        ``failover``, ``only`` (one candidate) or ``migrate``
        (least-loaded drain placement). ``commit=False`` defers the
        assignment bookkeeping to :meth:`commit`, for an admission that
        can still be refused; a traced ``request``/``sink`` gets its
        ``route`` rtrace at commit time."""
        if not replicas:
            raise ValueError("no live replica to route to")
        loads = {r.name: self.load(r) for r in replicas}
        if len(replicas) == 1:
            chosen, reason = replicas[0], "only"
        elif migrate:
            chosen = min(replicas, key=lambda r: (loads[r.name], r.name))
            reason = "migrate"
        else:
            chosen, reason = self._pick_new(prompt, replicas, loads)
        if commit:
            self.commit(chosen.name, reason, request=request, sink=sink,
                        loads=loads)
        return chosen, reason, loads

    def commit(self, name: str, reason: str, *, request=None, sink=None,
               loads: dict | None = None) -> None:
        """Count an assignment that landed (the engine accepted it)."""
        self.assignments[name] = self.assignments.get(name, 0) + 1
        if reason == "affinity":
            self.affinity_hits += 1
        if reason == "failover":
            self.failovers += 1
        if request is not None:
            fields = {"loads": loads} if loads is not None else {}
            tracing.rtrace(request, "route", sink=sink, replica=name,
                           reason=reason, **fields)

    def _pick_new(self, prompt, replicas, loads):
        best_aff, aff_rep = 0, None
        for r in replicas:
            cached = r.engine.cache.cached_prefix_tokens(prompt)
            if cached > best_aff:
                best_aff, aff_rep = cached, r
        min_load = min(loads.values())
        if (aff_rep is not None and best_aff >= self.affinity_min_tokens
                and loads[aff_rep.name] <= min_load + self.affinity_slack):
            return aff_rep, "affinity"
        if self.cells is not None:
            home = self.cells.home(prompt, self._seed)
            local = [r for r in replicas
                     if self.cells.cell_of(r.name) == home]
            if local:
                return self._p2c(local, loads), "cell-local"
            return self._p2c(replicas, loads), "failover"
        return self._p2c(replicas, loads), "p2c"

    def _p2c(self, replicas, loads):
        # Two distinct seeded samples, the less loaded wins; exact ties go
        # to the first sampled (the sample order is itself seeded, so idle
        # replicas share ties instead of herding onto one).
        if len(replicas) == 1:
            return replicas[0]
        a, b = self._rng.sample(range(len(replicas)), 2)
        ra, rb = replicas[a], replicas[b]
        return ra if loads[ra.name] <= loads[rb.name] else rb
