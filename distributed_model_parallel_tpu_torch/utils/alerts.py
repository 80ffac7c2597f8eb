"""SLO burn-rate alerts: declarative rules over the live telemetry.

Counterpart of ``distributed_model_parallel_tpu/utils/alerts.py`` (no
framework code; the port's own copy). An operator watching a fleet
needs a judgment *while it runs*. This module evaluates declarative rules against the records a campaign is
writing right now — fed either directly (:meth:`AlertEngine.observe`)
or by live-tailing streams across rotations
(:meth:`AlertEngine.watch` + :meth:`AlertEngine.poll`, built on
:class:`~.telemetry.StreamFollower`) — and emits **deduplicated typed
``alert`` records**: one ``firing`` record when a rule first breaches,
one ``resolved`` when it heals, never a record per evaluation.

Rules (each scoped per subject — per tenant for step/serve signals —
so one slow tenant cannot hide behind a fast fleet median):

* :class:`StepTimeDrift` — recent step-time p50 vs a reference: the
  caller's ``reference_s``, else a self-baseline from the run's own
  first healthy window (:func:`step_time_reference_from_ledger` waits
  for the port of the baseline ledger). Fires when
  ``p50 > max(ref * factor, ref + min_drift_s)`` (the absolute floor
  keeps millisecond CPU jitter from ever firing).
* :class:`BurnRate` — classic multiwindow burn rate over serve SLOs
  (``ttft_s`` / ``token_latency_s`` from per-request ``serve``
  records): the fraction of requests violating ``target_s``, divided
  by the error ``budget``, over a SHORT and a LONG window — firing
  only when **both** exceed ``burn`` (fast-burn detection that still
  ignores one bad request).
* :class:`GaugeCeiling` — a sustained level signal (page-pool
  occupancy from engine ``serve`` summaries / the live gauge feed)
  above a ceiling.
* :class:`HealthFloor` — any device-health score at/below a floor
  (fed by the orchestrator from the installed monitor).

Determinism: the engine takes its clock from the records (``now`` =
max observed ``ts``) unless the caller passes one — a replayed stream
produces the identical alert sequence.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from statistics import median
from typing import Any, Callable

from distributed_model_parallel_tpu_torch.utils.telemetry import StreamFollower

__all__ = [
    "AlertEngine",
    "BurnRate",
    "GaugeCeiling",
    "HealthFloor",
    "StepTimeDrift",
    "default_rules",
    "step_time_reference_from_ledger",
]


def step_time_reference_from_ledger(path: str,
                                    key: str | None = None) -> float | None:
    """The JAX package reads a step-time reference from its baseline
    ledger (``utils/baseline.py``). That module is not ported yet, so
    this refuses rather than guess a reference."""
    raise NotImplementedError(
        "step_time_reference_from_ledger needs the baseline ledger, "
        "which the port does not have yet (ROADMAP A11: baseline)")


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepTimeDrift:
    """Recent step-time p50 drifted above the reference band."""

    name: str = "step_time_drift"
    scope: str = "tenant"         # one state cell per tenant
    window: int = 4               # recent samples the p50 is taken over
    baseline_n: int = 4           # self-baseline: first N samples' median
    factor: float = 3.0           # fire when p50 > ref * factor ...
    min_drift_s: float = 0.05     # ... and p50 > ref + this (jitter floor)
    reference_s: float | None = None    # ledger band override

    def make_state(self) -> dict:
        return {"recent": deque(maxlen=self.window), "baseline": []}

    def observe(self, state: dict, rec: dict) -> None:
        if rec.get("kind") != "step":
            return
        t = rec.get("step_time_s")
        if not isinstance(t, (int, float)):
            return
        if (self.reference_s is None
                and len(state["baseline"]) < self.baseline_n):
            state["baseline"].append(float(t))
        state["recent"].append(float(t))

    def evaluate(self, state: dict, now: float,
                 signals: dict) -> tuple[bool, dict] | None:
        if len(state["recent"]) < state["recent"].maxlen:
            return None                       # not enough evidence yet
        ref = (self.reference_s if self.reference_s is not None
               else median(state["baseline"])
               if len(state["baseline"]) >= self.baseline_n else None)
        if ref is None:
            return None
        p50 = median(state["recent"])
        threshold = max(ref * self.factor, ref + self.min_drift_s)
        return p50 > threshold, {
            "value": round(p50, 6), "threshold": round(threshold, 6),
            "reference": round(ref, 6)}


@dataclasses.dataclass(frozen=True)
class BurnRate:
    """Serve-SLO burn rate over short + long windows."""

    metric: str = "ttft_s"        # per-request serve record key
    target_s: float = 1.0         # SLO: a request over this violates
    budget: float = 0.1           # tolerated violation fraction
    burn: float = 2.0             # fire when both windows burn > this
    short_s: float = 30.0         # short window (seconds of record ts)
    long_s: float = 300.0
    min_requests: int = 4         # evidence floor per window
    # Default name embeds the metric: two BurnRate rules (ttft +
    # token latency) must not collide on one engine state cell.
    name: str = ""
    scope: str = "tenant"

    def __post_init__(self):
        if not self.name:
            object.__setattr__(self, "name",
                               f"serve_burn_rate_{self.metric}")

    def make_state(self) -> dict:
        return {"samples": deque()}      # (ts, violated) pairs

    def observe(self, state: dict, rec: dict) -> None:
        if rec.get("kind") != "serve" or rec.get("event") != "completed":
            return
        v = rec.get(self.metric)
        ts = rec.get("ts")
        if isinstance(v, (int, float)) and isinstance(ts, (int, float)):
            state["samples"].append((float(ts), v > self.target_s))

    def _burn(self, samples, now: float, horizon: float) -> float | None:
        window = [bad for ts, bad in samples if now - ts <= horizon]
        if len(window) < self.min_requests:
            return None
        return (sum(window) / len(window)) / self.budget

    def evaluate(self, state: dict, now: float,
                 signals: dict) -> tuple[bool, dict] | None:
        samples = state["samples"]
        while samples and now - samples[0][0] > self.long_s:
            samples.popleft()
        short = self._burn(samples, now, self.short_s)
        long_ = self._burn(samples, now, self.long_s)
        if short is None or long_ is None:
            return None
        return (short > self.burn and long_ > self.burn), {
            "value": round(short, 4), "threshold": self.burn,
            "burn_long": round(long_, 4), "metric": self.metric,
            "target_s": self.target_s}


@dataclasses.dataclass(frozen=True)
class GaugeCeiling:
    """A level signal sustained above a ceiling (page-pool occupancy)."""

    signal: str = "page_occupancy"
    ceiling: float = 0.95
    name: str = "page_pool_saturation"
    scope: str = "global"

    def make_state(self) -> dict:
        return {"last": None}

    def observe(self, state: dict, rec: dict) -> None:
        # Engine summaries carry the occupancy aggregate; the live
        # signal feed (set_signal) overrides between records.
        if rec.get("kind") == "serve" and rec.get("event") == "summary":
            occ = rec.get(self.signal)
            v = occ.get("max") if isinstance(occ, dict) else occ
            if isinstance(v, (int, float)):
                state["last"] = float(v)

    def evaluate(self, state: dict, now: float,
                 signals: dict) -> tuple[bool, dict] | None:
        v = signals.get(self.signal, state["last"])
        if not isinstance(v, (int, float)):
            return None
        return v > self.ceiling, {"value": round(float(v), 4),
                                  "threshold": self.ceiling}


@dataclasses.dataclass(frozen=True)
class HealthFloor:
    """Any device-health score at/below the floor (fed from the
    installed DeviceHealthMonitor via ``set_signal('health_scores',
    monitor.snapshot()['scores'])``)."""

    floor: float = 0.5
    name: str = "device_health_floor"
    scope: str = "global"

    def make_state(self) -> dict:
        return {}

    def observe(self, state: dict, rec: dict) -> None:
        pass

    def evaluate(self, state: dict, now: float,
                 signals: dict) -> tuple[bool, dict] | None:
        scores = signals.get("health_scores")
        if not scores:
            return None
        worst_id, worst = min(scores.items(), key=lambda kv: kv[1])
        return worst <= self.floor, {
            "value": round(float(worst), 4), "threshold": self.floor,
            "device": worst_id}


def default_rules(*, ledger_path: str | None = None,
                  ledger_key: str | None = None) -> list:
    """The default rule set. A ledger path anchors the drift rule to the
    baseline band (refused until the baseline ledger is ported); without
    one it self-baselines on the run's first window."""
    ref = (step_time_reference_from_ledger(ledger_path, ledger_key)
           if ledger_path else None)
    return [
        StepTimeDrift(reference_s=ref),
        BurnRate(metric="ttft_s"),
        BurnRate(metric="token_latency_s", target_s=0.2),
        GaugeCeiling(),
        HealthFloor(),
    ]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class AlertEngine:
    """Evaluates rules on a cadence and emits deduplicated typed
    ``alert`` records.

    Feed it records with :meth:`observe` (or :meth:`watch` + the
    :meth:`poll` live-tail), level signals with :meth:`set_signal`,
    then call :meth:`tick` each cadence: every state *transition*
    (healthy->firing, firing->resolved) is returned and written to
    ``sink`` (anything with ``.record``). ``firing`` lists the
    currently-firing alerts for statusz/cockpit surfacing."""

    def __init__(self, rules: list | None = None, *, sink=None):
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            # State cells are keyed by rule name: two rules sharing one
            # would corrupt each other's windows — no silent merges.
            raise ValueError(f"duplicate alert rule names {dupes}; give "
                             f"each rule a distinct name=")
        self.sink = sink
        self.signals: dict[str, Any] = {}
        self.events: list[dict] = []        # every transition ever emitted
        self._followers: dict[str, StreamFollower] = {}
        # (rule name, subject) -> {"state": rule state, "firing": bool}
        self._state: dict[tuple[str, str], dict] = {}
        self._max_ts = 0.0

    # -- ingest --------------------------------------------------------------
    def watch(self, path: str) -> None:
        """Live-tail ``path`` (idempotent; rotation-safe)."""
        if path not in self._followers:
            self._followers[path] = StreamFollower(path)

    def poll(self) -> int:
        """Drain every watched stream into the rule states; returns how
        many records were ingested."""
        n = 0
        for follower in self._followers.values():
            for rec in follower.poll():
                self.observe(rec)
                n += 1
        return n

    def observe(self, rec: dict) -> None:
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            self._max_ts = max(self._max_ts, ts)
        subject = str(rec.get("tenant") or "")
        for rule in self.rules:
            # Global rules (health floor, page ceiling) keep ONE state
            # cell; tenant-scoped ones (drift, burn rate) keep one per
            # stream subject so a slow tenant can't hide in the fleet.
            cell = self._cell(rule, subject if rule.scope == "tenant"
                              else "")
            rule.observe(cell["state"], rec)

    def set_signal(self, name: str, value: Any) -> None:
        """Push a level signal (health scores, live gauge values) for
        the next tick."""
        self.signals[name] = value

    # -- evaluation ----------------------------------------------------------
    def _cell(self, rule, subject: str) -> dict:
        key = (rule.name, subject)
        cell = self._state.get(key)
        if cell is None:
            cell = self._state[key] = {"state": rule.make_state(),
                                       "firing": False}
        return cell

    def tick(self, now: float | None = None) -> list[dict]:
        """One evaluation pass; returns (and records to the sink) the
        transitions. ``now`` defaults to the max record ts seen —
        deterministic under replay."""
        if now is None:
            now = self._max_ts
        for rule in self.rules:
            if rule.scope == "global":
                self._cell(rule, "")    # signal-fed rules need no records
        out: list[dict] = []
        for (rule_name, subject), cell in sorted(self._state.items()):
            rule = next((r for r in self.rules if r.name == rule_name),
                        None)
            if rule is None:
                continue
            verdict = rule.evaluate(cell["state"], now, self.signals)
            if verdict is None:
                continue
            breached, detail = verdict
            if breached and not cell["firing"]:
                cell["firing"] = True
                out.append({"rule": rule_name, "subject": subject,
                            "state": "firing", **detail})
            elif not breached and cell["firing"]:
                cell["firing"] = False
                out.append({"rule": rule_name, "subject": subject,
                            "state": "resolved", **detail})
        for ev in out:
            self.events.append(ev)
            if self.sink is not None:
                try:
                    self.sink.record("alert", **ev)
                except Exception:
                    pass
        return out

    @property
    def firing(self) -> list[dict]:
        """Currently-firing alerts: ``[{rule, subject}]``."""
        return [{"rule": k[0], "subject": k[1]}
                for k, cell in sorted(self._state.items())
                if cell["firing"]]
