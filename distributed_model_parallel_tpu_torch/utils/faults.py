"""Deterministic, config-driven fault injection: the plan parser, the
serving side and the training side.

Counterpart of ``distributed_model_parallel_tpu/utils/faults.py`` (no
framework code; the port's own copy). A fault plan names exactly which
fault fires at exactly which occurrence of which hook site, so a chaos
drill is a deterministic program, not a race. The parser knows every
kind, the training side's too, so that the serving fleet can refuse a
train-site plan in JAX's words.

Serve-side kinds (``kind`` → hook site → effect when fired):

================== ====== =================================================
``slow_replica``   serve  PERSISTENT: every later serve-site poll sleeps
                          ``param`` s (default 0.05) inside the victim
                          replica's timed fleet round
``crash_replica``  serve  hard-crash the victim replica (no drain); the
                          write-ahead journal re-admits its requests
``admission_fail`` admit  PERSISTENT (bounded): the next ``param``
                          admission attempts (default 6) to the victim fail
``kill_cell``      cell   quarantine + drain every replica of the victim
                          cell at once
``slow_cell``      cell   PERSISTENT: the victim cell's replicas step only
                          every ``param``-th fleet round (default 4, >= 2)
``partition``      cell   PERSISTENT (bounded): for ``param`` cell-site
                          polls (default 8) the router cannot reach the
                          victim cell; its residents keep decoding
================== ====== =================================================

Train-side kinds (the trainers poll ``step``, ``GuardRunner.watch``
polls ``sync``, ``train/checkpoint.Checkpointer.save`` polls ``save``):

================== ====== =================================================
``nan_loss``       step   poison that step's metrics with NaN
``nan_params``     step   poison the live parameters with NaN, in place
``preempt``        step   request a graceful preemption
``stall``          sync   sleep ``param`` s inside the guarded drain
``save_fail``      save   leave a torn version directory and raise
                          :class:`InjectedFaultError`
``tear_save``      save   let the save commit, then truncate its files
``bitflip``        step   flip the lowest exponent bit of element 0 of
                          float leaf ``param`` on ONE data replica
``desync``         step   multiply one replica's float leaves by
                          ``1 + param`` (default 1e-3)
``grad_skew``      step   add ``param`` (default 1e-3) to one replica's
                          float leaves
``slow_device``    step   PERSISTENT: every later step sleeps a ramp
``flaky_sync``     sync   PERSISTENT: every second later sync sleeps
================== ====== =================================================

Each ``poll(site)`` advances that site's occurrence counter; a spec fires
when its ``at`` index matches — once, independent of the wall clock.

The JAX package corrupts a replica inside a ``shard_map``; here every
rank holds its own copy, so :func:`corrupt_one_replica` runs on every
rank and only the rank whose data index is the target perturbs its
tensors, in place (a fused optimizer's bucket views stay its views).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Sequence

__all__ = [
    "CORRUPTION_KINDS",
    "DEGRADATION_KINDS",
    "FAULT_SITES",
    "FaultInjector",
    "FaultSpec",
    "InjectedFaultError",
    "corrupt_one_replica",
    "parse_faults",
    "poison",
    "tear_checkpoint",
    "validate_corruption_plan",
]


class InjectedFaultError(RuntimeError):
    """Raised by an injected ``save_fail`` fault (never by real code paths)."""


FAULT_SITES = {
    "nan_loss": "step",
    "nan_params": "step",
    "preempt": "step",
    "stall": "sync",
    "save_fail": "save",
    "tear_save": "save",
    "bitflip": "step",
    "desync": "step",
    "grad_skew": "step",
    "slow_device": "step",
    "flaky_sync": "sync",
    "slow_replica": "serve",
    "crash_replica": "serve",
    "admission_fail": "admit",
    "kill_cell": "cell",
    "slow_cell": "cell",
    "partition": "cell",
}

# Faults that silently corrupt ONE data-parallel replica's state (served by
# corrupt_one_replica); they need >= 2 replicas to be meaningful — and to be
# detectable at all.
CORRUPTION_KINDS = frozenset({"bitflip", "desync", "grad_skew"})

# PERSISTENT degradations: unlike every other kind (one effect at one
# occurrence), these register at their ``at`` occurrence and keep acting on
# every later poll of their site — gradual decline, not an event. Served by
# FaultInjector.poll itself (the injector owns the ramp state), detected by
# the device-health sentinel (utils/health.py), not by the guards.
DEGRADATION_KINDS = frozenset({"slow_device", "flaky_sync",
                               "slow_replica", "admission_fail",
                               "slow_cell", "partition"})

# slow_device ramp: delay = param * min(polls_since_firing, cap) — linear
# decline toward a bounded worst case, so a soak stays finite.
SLOW_DEVICE_RAMP_CAP = 4
# flaky_sync intermittency: sleep on every PERIOD-th sync after firing.
FLAKY_SYNC_PERIOD = 2
# admission_fail duration: admissions fail for this many admit-site polls
# after firing (param overrides) — bounded, so the breaker's half-open
# probe eventually lands and the cycle closes.
ADMISSION_FAIL_POLLS = 6
# slow_cell cadence: the victim cell's replicas run an engine iteration
# only every PERIOD-th fleet round while the degradation is active
# (param overrides; must be >= 2 or nothing is slowed).
SLOW_CELL_PERIOD = 4
# partition duration: the victim cell is router-unreachable for this
# many cell-site polls after firing (param overrides) — bounded, so the
# cell always heals and its residents drain out.
PARTITION_POLLS = 8


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: ``kind`` fires at the ``at``-th occurrence
    (0-based) of its hook site; ``param`` is the kind-specific knob
    (sleep seconds for ``stall``). ``None`` means "not given" — each
    consumer applies its own documented default, and an EXPLICIT value
    is never silently replaced (``desync@5:0`` is rejected, not bumped
    to the default magnitude)."""

    kind: str
    at: int
    param: float | None = None

    def __post_init__(self):
        if self.kind not in FAULT_SITES:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: "
                f"{sorted(FAULT_SITES)}")
        if self.at < 0:
            raise ValueError(f"fault occurrence index must be >= 0, got "
                             f"{self.at}")

    @property
    def site(self) -> str:
        return FAULT_SITES[self.kind]


def parse_faults(spec: str) -> tuple[FaultSpec, ...]:
    """Parse a CLI/env fault plan: comma-separated ``kind@at[:param]``
    entries, e.g. ``"nan_loss@1,stall@0:0.5"``."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise ValueError(
                f"bad fault entry {entry!r}: expected kind@at[:param]")
        kind, _, rest = entry.partition("@")
        at_s, _, param_s = rest.partition(":")
        out.append(FaultSpec(kind=kind.strip(), at=int(at_s),
                             param=float(param_s) if param_s else None))
    return tuple(out)


def _coerce_spec(f: "FaultSpec | str") -> FaultSpec:
    if isinstance(f, FaultSpec):
        return f
    parsed = parse_faults(f)
    if len(parsed) != 1:
        raise ValueError(f"one fault entry expected, got {f!r}")
    return parsed[0]


class FaultInjector:
    """Deterministic fault firing against named hook sites.

    ``poll(site)`` advances the site's occurrence counter and returns the
    specs scheduled for that occurrence (usually zero or one). A disabled
    injector (empty plan) polls as a cheap no-op, so trainers can call it
    unconditionally. ``on_fire`` (settable after construction — the
    supervisor wires itself in) observes every firing for telemetry.
    """

    def __init__(self, faults: Sequence["FaultSpec | str"] = (),
                 *, on_fire: Callable[[FaultSpec, str, int], None]
                 | None = None):
        self.plan: tuple[FaultSpec, ...] = tuple(
            _coerce_spec(f) for f in (faults or ()))
        self.on_fire = on_fire
        self.fired: list[FaultSpec] = []
        self._counts: dict[str, int] = {}
        # Active persistent degradations (DEGRADATION_KINDS): spec ->
        # polls of its site since it fired. The injector owns the ramp
        # state so every trainer gets the decline for free via poll().
        self._degradations: dict[FaultSpec, int] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.plan)

    @property
    def active_degradations(self) -> tuple[FaultSpec, ...]:
        return tuple(self._degradations)

    def poll(self, site: str) -> list[FaultSpec]:
        if not self.plan:
            return []
        i = self._counts.get(site, 0)
        self._counts[site] = i + 1
        out = [s for s in self.plan if s.site == site and s.at == i]
        for s in out:
            self.fired.append(s)
            if self.on_fire is not None:
                self.on_fire(s, site, i)
            if s.kind in DEGRADATION_KINDS:
                self._degradations[s] = 0
        self._serve_degradations(site)
        return out

    def _serve_degradations(self, site: str) -> None:
        """Serve the active persistent degradations scheduled on this
        site: ``slow_device`` sleeps its linear ramp on every step,
        ``flaky_sync`` sleeps intermittently (every FLAKY_SYNC_PERIOD-th
        sync). The sleeps land inside the trainers' timed regions, so
        the device-health sentinel observes them exactly like a real
        thermal throttle or flaky link (utils/health.py)."""
        for s, n in list(self._degradations.items()):
            if s.site != site:
                continue
            self._degradations[s] = n = n + 1
            if s.kind == "slow_device":
                time.sleep((s.param if s.param is not None else 0.05)
                           * min(n, SLOW_DEVICE_RAMP_CAP))
            elif s.kind == "flaky_sync" and n % FLAKY_SYNC_PERIOD == 0:
                time.sleep(s.param if s.param is not None else 0.05)
            elif s.kind == "slow_replica":
                # Flat per-round delay inside the fleet's timed engine
                # round (serve/fleet.py polls the serve site there) —
                # the health sentinel's serve signal sees the outlier.
                time.sleep(s.param if s.param is not None else 0.05)
            # admission_fail: no sleep — queried via admission_blocked().
            # slow_cell / partition: no sleep — queried by the fleet via
            # cell_slow_period() / partition_active(); a wall-clock
            # sleep would break the virtual-clock scenario replays.

    def admission_blocked(self) -> bool:
        """True while an ``admission_fail`` degradation is active: it
        fired, and fewer than its duration (``param`` admit-site polls,
        default ADMISSION_FAIL_POLLS) have elapsed since. The serving
        fleet consults this on every admission attempt to the victim
        replica (serve/fleet.py) — the failures open the router's
        circuit breaker, and the recovery closes it through a half-open
        probe."""
        for s, n in self._degradations.items():
            if s.kind != "admission_fail":
                continue
            dur = (int(s.param) if s.param is not None
                   else ADMISSION_FAIL_POLLS)
            if n <= dur:
                return True
        return False

    def cell_slow_period(self) -> int | None:
        """The active ``slow_cell`` degradation's iteration period, or
        ``None`` when no slow_cell is live: while active, the victim
        cell's replicas run an engine iteration only every period-th
        fleet round (serve/fleet.py) — lockstep cell-wide slowdown with
        no wall-clock sleep, so virtual-clock replays stay exact."""
        for s in self._degradations:
            if s.kind != "slow_cell":
                continue
            period = (int(s.param) if s.param is not None
                      else SLOW_CELL_PERIOD)
            if period < 2:
                raise ValueError(
                    f"slow_cell period must be >= 2 (a period of "
                    f"{period} slows nothing)")
            return period
        return None

    def partition_active(self) -> bool:
        """True while a ``partition`` degradation is active: it fired,
        and fewer than its duration (``param`` cell-site polls, default
        PARTITION_POLLS) have elapsed since. The serving fleet consults
        this once per round — an active partition removes the victim
        cell from the routing AND migration candidate sets while its
        residents keep decoding (serve/fleet.py)."""
        for s, n in self._degradations.items():
            if s.kind != "partition":
                continue
            dur = (int(s.param) if s.param is not None
                   else PARTITION_POLLS)
            if n <= dur:
                return True
        return False

    def maybe_stall(self, site: str = "sync") -> None:
        """Poll ``site`` and serve any ``stall`` fault by sleeping — called
        inside the watchdog-guarded region so the delay is observed."""
        for spec in self.poll(site):
            if spec.kind == "stall":
                time.sleep(spec.param or 0.0)


def _is_float(x) -> bool:
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def poison(tree: Any) -> Any:
    """NaN every floating-point leaf of a tree of tensors (or numpy
    arrays) IN PLACE and return the tree: the injected-NaN faults'
    payload. Parameters that are views of a fused optimizer's buckets
    stay views (the kernel goes on updating the same memory)."""
    import torch

    from distributed_model_parallel_tpu_torch.train.guards import (
        named_leaves,
    )

    with torch.no_grad():
        for _, x in named_leaves(tree):
            if not _is_float(x):
                continue
            if isinstance(x, torch.Tensor):
                x.fill_(float("nan"))
            else:
                x[...] = float("nan")
    return tree


def validate_corruption_plan(plan: Sequence[FaultSpec], n_replicas: int,
                             *, context: str) -> None:
    """Reject a fault plan that injects silent corruption into a run with
    no replicated data axis to diverge (``n_replicas < 2``) — the shared
    fail-fast check every trainer constructor runs. ``context`` names the
    topology for the error message (e.g. ``"strategy='fsdp'"``)."""
    corrupting = sorted({s.kind for s in plan if s.kind in CORRUPTION_KINDS})
    if corrupting and n_replicas < 2:
        raise ValueError(
            f"corruption faults {corrupting} perturb one data-parallel "
            f"replica relative to the others, but {context} has "
            f"{n_replicas} replicated replica(s) — nothing to diverge "
            f"from, and no redundancy for the consistency sentinel to "
            f"detect it with")


_INT_OF = {2: "int16", 4: "int32", 8: "int64"}


def flip_exponent_bit_(x) -> None:
    """Flip the lowest exponent bit of element 0 of ``x`` in place (a
    large but finite change; mantissa flips near zero can land on
    denormals that flush back to zero)."""
    import torch

    nmant = torch.finfo(x.dtype).bits - 1 - _exponent_bits(x.dtype)
    first = x.detach()[(0,) * x.ndim]          # a view, whatever the strides
    first.view(getattr(torch, _INT_OF[x.element_size()])).bitwise_xor_(
        1 << nmant)


def _exponent_bits(dtype) -> int:
    import torch

    return {torch.float16: 5, torch.bfloat16: 8, torch.float32: 8,
            torch.float64: 11}[dtype]


def corrupt_one_replica(tensors: Sequence, n_replicas: int,
                        data_index: int, kind: str,
                        param: float | None = None, *,
                        replica: int | None = None,
                        shard_index: Sequence[int] | None = None) -> bool:
    """Silently corrupt ONE data-parallel replica's copy of ``tensors``
    (this rank's leaves, in the JAX tree's order), in place.

    Every rank calls; the rank whose ``data_index`` is the target replica
    (default: the highest, ``n_replicas - 1``) perturbs its tensors, so
    the state still claims replication while one replica's buffers
    differ — what a flipped bit or a drifting core leaves behind. Returns
    whether this rank corrupted anything.

    ``bitflip`` flips the lowest exponent bit of element 0 of float leaf
    ``int(param)`` (default 0); ``desync`` multiplies every float leaf
    by ``1 + param``; ``grad_skew`` adds ``param`` to every float leaf
    (both default to 1e-3; an explicit 0 is rejected). ``shard_index``
    (per leaf): this rank's index over the non-data axes the leaf is CUT
    along (0 where it is whole) — a bitflip lands on shard 0 only, one
    element of the logical leaf, on every copy of that shard.
    """
    import torch

    if kind not in CORRUPTION_KINDS:
        raise ValueError(f"not a corruption fault kind: {kind!r} "
                         f"(known: {sorted(CORRUPTION_KINDS)})")
    if n_replicas < 2:
        raise ValueError(
            f"corruption fault {kind!r} perturbs one replica relative to "
            f"the others, but the mesh has {n_replicas} data-parallel "
            f"replica(s) — nothing to diverge from")
    target = n_replicas - 1 if replica is None else int(replica)
    if not 0 <= target < n_replicas:
        raise ValueError(
            f"corrupt_one_replica: replica index {target} out of range "
            f"for {n_replicas} data-parallel replicas")
    float_idx = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    if not float_idx:
        raise ValueError("corrupt_one_replica: tree has no float leaves")
    if kind == "bitflip":
        leaf_i = 0 if param is None else param
        if leaf_i != int(leaf_i):
            raise ValueError(
                f"bitflip leaf index must be a whole number, got {param}")
        leaf_i = int(leaf_i)
        if not 0 <= leaf_i < len(float_idx):
            raise ValueError(
                f"bitflip leaf index {leaf_i} out of range: the tree "
                f"has {len(float_idx)} float leaves")
    if param == 0 and kind in ("desync", "grad_skew"):
        raise ValueError(
            f"{kind} with explicit magnitude 0 perturbs nothing — omit "
            f"the param for the 1e-3 default or give a nonzero magnitude")
    if data_index != target:
        return False
    scale = 1e-3 if param is None else param
    with torch.no_grad():
        if kind == "bitflip":
            i = float_idx[leaf_i]
            if shard_index is None or shard_index[i] == 0:
                flip_exponent_bit_(tensors[i])
            return True
        for i in float_idx:
            t = tensors[i]
            if kind == "desync":
                t.mul_(1.0 + scale)
            else:                                        # grad_skew
                t.add_(torch.tensor(scale, dtype=t.dtype, device=t.device))
    return True


def tear_checkpoint(path: str) -> None:
    """Simulate a torn checkpoint write: truncate every regular file under
    ``path`` to half its size (the integrity manifest, when present, is
    left intact so verification can catch the tear)."""
    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        MANIFEST_FILENAME,
    )

    for root, _dirs, files in os.walk(path):
        for fn in files:
            if fn == MANIFEST_FILENAME:
                continue
            p = os.path.join(root, fn)
            size = os.path.getsize(p)
            with open(p, "r+b") as f:
                f.truncate(size // 2)
