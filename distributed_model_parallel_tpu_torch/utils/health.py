"""Device-health sentinel: rolling per-device scores with hysteresis.

Counterpart of ``distributed_model_parallel_tpu/utils/health.py`` (no
framework code; the port's own copy). Devices degrade gradually before
they die, and one slow device stalls every synchronous collective. This
module turns host-side latency signals into a rolling per-device health
score, so a scheduler can quarantine a straggler before the crash and
reinstate it after a probation period.

Signals (all host-side wall clock): per-step timing (``observe_step``),
sync/drain latency (``observe_sync``), fingerprint-fetch latency
(``observe_fetch``), checkpoint I/O latency (``observe_io``),
serving-replica engine-iteration wall time (``observe_serve``, fed by the
serving fleet), and watchdog stall escalations (``observe_stall`` — a
hard penalty, no baseline needed).

Scoring model: every device starts at score 1.0. Timing observations are
compared against a per-(signal, device-slice) EWMA baseline — per slice,
because a CNN step and an LM step have nothing in common, and the first
``warmup`` observations only establish the baseline. An observation
exceeding ``max(baseline * outlier_factor, baseline + min_outlier_s)``
penalizes every device of the observing slice (a synchronous program
cannot tell *which* member stalled it — blame is shared, and the slice
that keeps stalling is the slice that holds the straggler); a healthy
observation credits them back. Hysteresis: a device whose score falls to
``quarantine_below`` is QUARANTINED (the orchestrator takes it out of
scheduling and migrates its holder); it is only reinstated after at
least ``min_probation_ticks`` quarantined control-loop ticks *and* its
score has healed past ``reinstate_above`` — the two thresholds are far
apart precisely so a device cannot flap in and out of service.

The monitor is deliberately pure bookkeeping: observations in, scored
state + typed events out; the caller owns the actions. The module-level
observe functions no-op unless a monitor is :func:`install`-ed, so a
standalone run pays one ``is None`` check per window.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Sequence

__all__ = [
    "DeviceDegradedError",
    "DeviceHealthMonitor",
    "HealthPolicy",
    "install",
    "installed",
    "observe_fetch",
    "observe_io",
    "observe_serve",
    "observe_stall",
    "observe_step",
    "observe_step_warmed",
    "observe_sync",
    "uninstall",
]


class DeviceDegradedError(RuntimeError):
    """A degraded/quarantined device was asked to do scheduled work.

    Raised by :meth:`DeviceHealthMonitor.assert_usable` (and by
    ``DevicePool.assign``'s defensive check) when a grant would land on a
    device the health sentinel has quarantined — a scheduling bug, since
    quarantined devices are removed from the free pool."""


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Scoring and hysteresis knobs (see the module docstring).

    Defaults are sized for the soak's simulated degradations: ~3
    consecutive outlier steps quarantine a slice, ~3 quiet probation
    ticks heal it back. Production values would be larger on both sides.
    """

    # Observations per (signal, slice) that only establish the baseline.
    warmup: int = 3
    # Outlier when value > max(baseline * factor, baseline + min_s):
    # the ratio catches slow big-step devices, the absolute floor keeps
    # microsecond-step CPU jitter from ever counting as degradation.
    outlier_factor: float = 3.0
    min_outlier_s: float = 0.1
    # Baseline EWMA weight (healthy observations only — outliers must not
    # teach the baseline that slow is normal).
    ewma: float = 0.3
    # Score dynamics: [0, 1], start 1.0.
    outlier_penalty: float = 0.25
    stall_penalty: float = 0.5
    recovery_credit: float = 0.05
    # Probation healing per control-loop tick while quarantined (the
    # device is idle — no observations arrive to credit it).
    idle_credit: float = 0.25
    # Hysteresis thresholds: quarantine at/below the low one, reinstate
    # only past the high one (and after min_probation_ticks).
    quarantine_below: float = 0.35
    reinstate_above: float = 0.8
    min_probation_ticks: int = 3

    def __post_init__(self):
        if not (0.0 <= self.quarantine_below < self.reinstate_above <= 1.0):
            raise ValueError(
                f"hysteresis requires 0 <= quarantine_below < "
                f"reinstate_above <= 1, got {self.quarantine_below} / "
                f"{self.reinstate_above}")
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {self.warmup}")


HEALTHY = "healthy"
QUARANTINED = "quarantined"


class DeviceHealthMonitor:
    """Rolling per-device health scores from slice-level observations.

    Thread-safe: trainers observe from tenant threads while the
    orchestrator ticks from the control loop. Deterministic: state is a
    pure function of the observation/tick sequence (no wall clock, no
    rng), so a seeded campaign replays identical health transitions.
    """

    def __init__(self, policy: HealthPolicy | None = None):
        self.policy = policy or HealthPolicy()
        self._lock = threading.Lock()
        self._score: dict[int, float] = {}
        self._state: dict[int, str] = {}
        self._probation: dict[int, int] = {}
        # Devices whose quarantine event has not yet been DELIVERED to
        # the control loop: the tick that hands the event over must not
        # already count as probation (the orchestrator has not even
        # migrated the holder yet).
        self._quarantine_pending: set[int] = set()
        # (signal, slice-ids) -> [ewma baseline, n observations]
        self._baseline: dict[tuple, list] = {}
        self._events: list[dict] = []
        self.ticks = 0

    # -- views ---------------------------------------------------------------
    def score(self, device_id: int) -> float:
        with self._lock:
            return self._score.get(device_id, 1.0)

    def state(self, device_id: int) -> str:
        with self._lock:
            return self._state.get(device_id, HEALTHY)

    @property
    def quarantined_ids(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(i for i, s in self._state.items()
                                if s == QUARANTINED))

    def quarantined_fraction(self, ids) -> float:
        """Fraction of ``ids`` currently quarantined (0.0 for an empty
        group) — the serving fleet's per-cell device-health rollup
        (serve/fleet.py ``_cell_status``)."""
        ids = list(ids)
        if not ids:
            return 0.0
        bad = set(self.quarantined_ids)
        return sum(1 for i in ids if i in bad) / len(ids)

    def snapshot(self) -> dict:
        """JSON-ready view of the sentinel's state — the statusz
        exporter's ``/statusz`` health block and the flight recorder's
        ``health.json``: per-device scores/states, the quarantine set,
        and the tick count."""
        with self._lock:
            ids = sorted(set(self._score) | set(self._state))
            return {
                "scores": {str(i): round(self._score.get(i, 1.0), 4)
                           for i in ids},
                "states": {str(i): self._state.get(i, HEALTHY)
                           for i in ids},
                "quarantined": sorted(i for i, s in self._state.items()
                                      if s == QUARANTINED),
                "ticks": self.ticks,
            }

    def assert_usable(self, device_ids: Iterable[int]) -> None:
        bad = sorted(set(device_ids) & set(self.quarantined_ids))
        if bad:
            raise DeviceDegradedError(
                f"devices {bad} are health-quarantined (scores "
                f"{[round(self.score(i), 3) for i in bad]}) — they must "
                f"not be scheduled until reinstated")

    # -- observations --------------------------------------------------------
    def _emit(self, event: str, devices: Sequence[int], **fields) -> None:
        self._events.append({"event": event,
                             "devices": [int(i) for i in devices],
                             **fields})

    def _penalize(self, ids: tuple[int, ...], amount: float, *,
                  signal: str, value: float, baseline: float | None) -> None:
        hit = []
        for i in ids:
            self._score[i] = max(0.0, self._score.get(i, 1.0) - amount)
            hit.append(i)
        self._emit("degrading", hit, signal=signal,
                   score=round(min(self._score[i] for i in hit), 4),
                   value=round(float(value), 4),
                   **({"baseline": round(baseline, 4)}
                      if baseline is not None else {}))
        for i in hit:
            if (self._state.get(i, HEALTHY) == HEALTHY
                    and self._score[i] <= self.policy.quarantine_below):
                self._state[i] = QUARANTINED
                self._probation[i] = 0
                self._quarantine_pending.add(i)
                self._emit("quarantine", [i],
                           score=round(self._score[i], 4))

    def observe(self, signal: str, device_ids: Iterable[int], value: float,
                n: int = 1) -> None:
        """One timing observation for a device slice: ``value`` is the
        per-unit wall time (e.g. per-step seconds averaged over an
        ``n``-step window). Outliers against the (signal, slice) baseline
        penalize every device of the slice; healthy values credit them
        and update the baseline."""
        ids = tuple(sorted(int(i) for i in device_ids))
        if not ids or value <= 0 or n <= 0:
            return
        p = self.policy
        with self._lock:
            base = self._baseline.setdefault((signal, ids), [0.0, 0])
            mean, count = base
            if count >= p.warmup and value > max(mean * p.outlier_factor,
                                                 mean + p.min_outlier_s):
                self._penalize(ids, p.outlier_penalty, signal=signal,
                               value=value, baseline=mean)
                return      # outliers never teach the baseline
            if count < p.warmup:
                # Warmup seeds the baseline with the MINIMUM observation:
                # the first window of a fresh slice carries one-time
                # kernel builds and first launches (seconds against a milliseconds steady
                # state), and seeding an average with it would blind the
                # outlier test to every real degradation under ~build
                # time. The min is the honest steady-state floor.
                base[0] = value if count == 0 else min(mean, value)
            else:
                base[0] = (1 - p.ewma) * mean + p.ewma * value
            base[1] = count + 1
            if count >= p.warmup:
                for i in ids:
                    if self._state.get(i, HEALTHY) == HEALTHY:
                        self._score[i] = min(
                            1.0, self._score.get(i, 1.0)
                            + p.recovery_credit * n)

    def observe_stall(self, device_ids: Iterable[int],
                      blocked_s: float) -> None:
        """A watchdog stall escalation on this slice: hard penalty, no
        baseline (a stall-budget overrun is already an adjudicated
        anomaly)."""
        ids = tuple(sorted(int(i) for i in device_ids))
        if not ids:
            return
        with self._lock:
            self._penalize(ids, self.policy.stall_penalty, signal="stall",
                           value=blocked_s, baseline=None)

    # -- the control-loop edge -----------------------------------------------
    def tick(self) -> list[dict]:
        """Advance probation for quarantined devices and drain the event
        queue. The orchestrator calls this once per scheduling round and
        applies the transitions (``quarantine`` events -> DevicePool
        quarantine + holder migration; ``reinstate`` events -> pool
        reinstate + possible tenant grow-back)."""
        p = self.policy
        with self._lock:
            self.ticks += 1
            for i, st in sorted(self._state.items()):
                if st != QUARANTINED:
                    continue
                if i in self._quarantine_pending:
                    # This tick only delivers the quarantine event;
                    # probation starts on the next one.
                    self._quarantine_pending.discard(i)
                    continue
                self._probation[i] = self._probation.get(i, 0) + 1
                self._score[i] = min(1.0, self._score.get(i, 0.0)
                                     + p.idle_credit)
                if (self._probation[i] >= p.min_probation_ticks
                        and self._score[i] >= p.reinstate_above):
                    self._state[i] = HEALTHY
                    self._emit("reinstate", [i],
                               score=round(self._score[i], 4),
                               probation_ticks=self._probation[i])
            out, self._events = self._events, []
            return out


# ---------------------------------------------------------------------------
# Process-wide installation: trainers feed whatever monitor the
# orchestrator installed, and pay one None-check when none is.
# ---------------------------------------------------------------------------

_monitor: DeviceHealthMonitor | None = None


def install(monitor: DeviceHealthMonitor) -> DeviceHealthMonitor:
    """Install ``monitor`` as the process-wide health sink (the
    orchestrator does this for the duration of a campaign)."""
    global _monitor
    _monitor = monitor
    return monitor


def installed() -> DeviceHealthMonitor | None:
    return _monitor


def uninstall() -> None:
    global _monitor
    _monitor = None


def observe_step(device_ids: Iterable[int], per_step_s: float,
                 n: int = 1) -> None:
    """Per-step wall time for one drained step window (trainers)."""
    if _monitor is not None:
        _monitor.observe("step", device_ids, per_step_s, n)


def observe_step_warmed(trainer, device_ids: Iterable[int],
                        per_step_s: float, n: int = 1) -> None:
    """:func:`observe_step`, skipping the FIRST window of ``trainer``'s
    life (tracked via a ``_health_warmed`` attribute on it): a trainer's
    first window carries one-time builds and first launches, and a re-admitted
    (migrated / grown-back) tenant must not have its fresh compile
    billed against the slice's steady-state baseline as a spurious
    degradation. One helper so every trainer shares the gate."""
    if n <= 0:
        return
    if not getattr(trainer, "_health_warmed", False):
        trainer._health_warmed = True
        return
    observe_step(device_ids, per_step_s, n)


def observe_serve(device_ids: Iterable[int], seconds: float) -> None:
    """One serving replica's engine-iteration wall time on its device
    slice (fed by the serving fleet) — the signal that lets the sentinel
    quarantine a degrading replica and trigger live request migration.
    Fed per fleet round; a fleet constructed with its own monitor feeds
    that directly instead."""
    if _monitor is not None:
        _monitor.observe("serve", device_ids, seconds)


def observe_sync(device_ids: Iterable[int], seconds: float) -> None:
    """One guarded blocking drain's wall time."""
    if _monitor is not None:
        _monitor.observe("sync", device_ids, seconds)


def observe_fetch(device_ids: Iterable[int], seconds: float) -> None:
    """One consistency-sentinel fingerprint fetch."""
    if _monitor is not None:
        _monitor.observe("fetch", device_ids, seconds)


def observe_io(device_ids: Iterable[int], seconds: float) -> None:
    """One checkpoint save's wall time."""
    if _monitor is not None:
        _monitor.observe("io", device_ids, seconds)


def observe_stall(device_ids: Iterable[int], blocked_s: float) -> None:
    """A watchdog stall escalation."""
    if _monitor is not None:
        _monitor.observe_stall(device_ids, blocked_s)
