"""Overload protection: the brownout ladder and the admission breaker.

Counterpart of ``distributed_model_parallel_tpu/serve/overload.py`` (no
framework code; the port's own copy). Two pieces the serving stack leans
on when offered load exceeds capacity:

* :class:`BrownoutController` — a deterministic degradation ladder
  driven by the :class:`~utils.alerts.AlertEngine`. Two rules
  watch the engine live: a burn-rate rule over per-request TTFT (the
  SLO the queue actually violates first) and a page-occupancy ceiling.
  While either fires, the controller walks one ladder level up per
  ``hold`` ticks; when both are healthy it walks back down. The steps,
  in order — each strictly sheds *optional work*, never changes tokens:

  1. ``spec-off``: stop running speculative verify windows (the
     single-token decode step commits identical tokens — the pinned
     spec-on/off parity — at guaranteed-progress cost);
  2. ``prefill-share``: clamp ``prefill_chunks_per_iter`` to 1, so the
     resident batch's completions (which free pages) outrank new
     admissions' prefill;
  3. ``clamp-max-new``: cap newly admitted requests' ``max_new_tokens``
     at ``brownout_max_new`` — their reservation shrinks and they
     complete sooner. A clamped request's tokens are the bitwise PREFIX
     of its unclamped stream (tokens are a pure per-position function
     of (prompt, seed)), so degradation changes *which* requests
     complete and *when*, never the tokens they get.

  Every level move is a typed ``brownout`` record plus the
  ``serve_brownout_level`` gauge.

* :class:`CircuitBreaker` — the router-level per-replica admission
  breaker of a serving fleet: repeated admission failures (a full
  submission queue, or the injected ``admission_fail`` chaos kind)
  open the breaker and the router stops offering that replica traffic
  — *distinct from health quarantine*: the replica keeps serving its
  residents, it just takes no new work. After ``cooldown_rounds`` the
  breaker goes half-open and admits one probe; a success closes it, a
  failure re-opens. Transitions are typed ``breaker`` records.
"""

from __future__ import annotations

from distributed_model_parallel_tpu_torch.utils.alerts import (
    AlertEngine,
    BurnRate,
    GaugeCeiling,
)
from distributed_model_parallel_tpu_torch.utils import tracing

__all__ = ["BrownoutController", "CircuitBreaker", "LADDER",
           "apply_max_new_cap"]

# The degradation ladder, mildest first; level N applies steps [0, N).
LADDER = ("spec-off", "prefill-share", "clamp-max-new")


class DrainingBurnRate(BurnRate):
    """BurnRate that treats an empty/thin window as HEALTHY.

    The alerting engine's rule withholds a verdict below its evidence
    floor — right for an operator page, wrong for a control loop: a
    brownout that can only resolve while violations keep arriving never
    resolves after the load drops (the windows just drain). Here the
    burn is computed over whatever samples remain; firing still needs
    ``min_requests`` of evidence, but resolution does not — once the
    backlog drains, the ladder walks back.
    """

    def evaluate(self, state, now, signals):
        samples = state["samples"]
        while samples and now - samples[0][0] > self.long_s:
            samples.popleft()

        def burn(horizon: float) -> float:
            window = [bad for ts, bad in samples if now - ts <= horizon]
            if not window:
                return 0.0
            return (sum(window) / len(window)) / self.budget

        short, long_ = burn(self.short_s), burn(self.long_s)
        breached = (short > self.burn and long_ > self.burn
                    and len(samples) >= self.min_requests)
        return breached, {
            "value": round(short, 4), "threshold": self.burn,
            "burn_long": round(long_, 4), "metric": self.metric,
            "target_s": self.target_s}


class BrownoutController:
    """Deterministic degradation ladder over one engine (module
    docstring). The engine feeds it completions and occupancy and ticks
    it once per iteration; :meth:`tick` returns the transition payload
    (the typed ``brownout`` record body) when the level moved."""

    def __init__(self, serve):
        if serve.brownout_max_new < 1:
            raise ValueError(f"brownout_max_new must be >= 1, got "
                             f"{serve.brownout_max_new}")
        if serve.brownout_hold_iters < 1:
            raise ValueError(f"brownout_hold_iters must be >= 1, got "
                             f"{serve.brownout_hold_iters}")
        short = float(serve.brownout_window_s)
        self._max_new = int(serve.brownout_max_new)
        self.alerts = AlertEngine([
            DrainingBurnRate(
                metric="ttft_s", target_s=serve.brownout_ttft_target_s,
                budget=serve.brownout_budget, burn=1.0,
                short_s=short, long_s=4.0 * short, min_requests=4,
                name="brownout_ttft_burn", scope="global"),
            GaugeCeiling(signal="page_occupancy",
                         ceiling=serve.brownout_occupancy_ceiling,
                         name="brownout_page_saturation"),
        ])
        self.level = 0
        self.max_level = len(LADDER)
        self.max_level_seen = 0
        self.hold = int(serve.brownout_hold_iters)
        self.transitions: list[dict] = []
        self._ticks = 0
        self._last_move = -(10 ** 9)

    # -- feeds (the engine's per-iteration hooks) ---------------------------

    def observe_completed(self, ttft_s: float | None, now: float) -> None:
        if ttft_s is not None:
            self.alerts.observe({"kind": "serve", "event": "completed",
                                 "ttft_s": float(ttft_s),
                                 "ts": float(now)})

    def observe_occupancy(self, occupancy: float) -> None:
        self.alerts.set_signal("page_occupancy", float(occupancy))

    # -- the ladder ---------------------------------------------------------

    @property
    def spec_enabled(self) -> bool:
        """Level >= 1 stops dispatching speculative verify windows."""
        return self.level < 1

    @property
    def prefill_full_share(self) -> bool:
        """Level >= 2 clamps prefill_chunks_per_iter to 1."""
        return self.level < 2

    @property
    def max_new_cap(self) -> int | None:
        """Level >= 3 caps newly admitted requests' max_new_tokens."""
        return self._max_new if self.level >= 3 else None

    def tick(self, now: float) -> dict | None:
        """One evaluation pass at engine clock ``now``; walks the ladder
        one level (at most) per ``hold`` ticks and returns the
        transition payload, or ``None`` when the level held."""
        self.alerts.tick(now)
        self._ticks += 1
        firing = [f["rule"] for f in self.alerts.firing]
        if self._ticks - self._last_move < self.hold:
            return None
        old = self.level
        if firing and self.level < self.max_level:
            self.level += 1
        elif not firing and self.level > 0:
            self.level -= 1
        else:
            return None
        self._last_move = self._ticks
        self.max_level_seen = max(self.max_level_seen, self.level)
        transition = {
            "level": self.level, "previous": old,
            "direction": "degrade" if self.level > old else "recover",
            "applied": list(LADDER[:self.level]),
            "firing": firing,
        }
        self.transitions.append(transition)
        return transition

    def summary(self) -> dict:
        return {"level": self.level,
                "max_level_seen": self.max_level_seen,
                "transitions": len(self.transitions)}


def apply_max_new_cap(brown: BrownoutController, queue, now: float,
                      sink=None, trace_fields=None) -> int:
    """Apply the level-3 brownout clamp to arrived queued requests: cap
    ``max_new_tokens`` at the controller's ``max_new_cap``, remembering
    the original ask in ``max_new_requested``. Migrated-in requests
    (``resume`` payload) are exempt — their generation length is already
    committed on the source replica. Each newly clamped request gets a
    ``clamp`` rtrace record (the brownout's per-request attribution);
    returns how many were clamped this pass. A no-op below level 3."""
    cap = brown.max_new_cap
    if cap is None:
        return 0
    clamped = 0
    for r in queue:
        if r.arrival_s <= now and r.max_new_tokens > cap \
                and r.resume is None:
            if r.max_new_requested is None:
                r.max_new_requested = r.max_new_tokens
            r.max_new_tokens = cap
            clamped += 1
            tracing.rtrace(r, "clamp", sink=sink, cap=cap, level=3,
                           requested=r.max_new_requested,
                           **(trace_fields or {}))
    return clamped


# ---------------------------------------------------------------------------
# the admission circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-replica admission circuit breaker (module docstring).

    Deterministic: state moves only on :meth:`note` (admission
    outcomes) and :meth:`allows` (the cooldown expiring at a round
    count) — no wall clock. Transitions accumulate in
    :attr:`transitions` for the fleet to drain into typed ``breaker``
    records.
    """

    def __init__(self, *, threshold: int = 3, cooldown_rounds: int = 8):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_rounds < 1:
            raise ValueError(f"cooldown_rounds must be >= 1, got "
                             f"{cooldown_rounds}")
        self.threshold = threshold
        self.cooldown_rounds = cooldown_rounds
        self.opens = 0
        self.transitions: list[dict] = []
        self._cells: dict[str, dict] = {}

    def _cell(self, name: str) -> dict:
        return self._cells.setdefault(
            name, {"state": CLOSED, "fails": 0, "opened_round": None})

    def state(self, name: str) -> str:
        return self._cell(name)["state"]

    def snapshot(self) -> dict[str, str]:
        return {name: c["state"] for name, c in sorted(self._cells.items())}

    def group_state(self, names) -> str:
        """Aggregated state over a group of replicas (a serving cell's
        per-cell rollup, serve/fleet.py): ``open`` when EVERY member's
        breaker is open (the whole group refuses traffic), ``degraded``
        when any member is open or half-open, else ``closed``."""
        states = [self.state(n) for n in names]
        if states and all(s == OPEN for s in states):
            return OPEN
        if any(s in (OPEN, HALF_OPEN) for s in states):
            return "degraded"
        return CLOSED

    def _transition(self, name: str, state: str, rnd: int,
                    fails: int) -> None:
        self.transitions.append({"replica": name, "state": state,
                                 "round": rnd, "failures": fails})

    def allows(self, name: str, rnd: int) -> bool:
        """May the router offer replica ``name`` traffic at round
        ``rnd``? An open breaker goes half-open (probe allowed) once
        the cooldown has passed."""
        c = self._cell(name)
        if (c["state"] == OPEN
                and rnd - c["opened_round"] >= self.cooldown_rounds):
            c["state"] = HALF_OPEN
            self._transition(name, HALF_OPEN, rnd, c["fails"])
        return c["state"] != OPEN

    def note(self, name: str, ok: bool, rnd: int) -> None:
        """Record an admission outcome for ``name``: ``threshold``
        consecutive failures (or one half-open probe failure) open the
        breaker; any success closes it."""
        c = self._cell(name)
        if ok:
            if c["state"] != CLOSED:
                c.update(state=CLOSED, fails=0, opened_round=None)
                self._transition(name, CLOSED, rnd, 0)
            else:
                c["fails"] = 0
            return
        c["fails"] += 1
        if c["state"] == HALF_OPEN or (c["state"] == CLOSED
                                       and c["fails"] >= self.threshold):
            c.update(state=OPEN, opened_round=rnd)
            self.opens += 1
            self._transition(name, OPEN, rnd, c["fails"])

    def drain_transitions(self) -> list[dict]:
        out, self.transitions = self.transitions, []
        return out
