"""Recovery supervisor: wires failure detection to recovery policy.

Counterpart of ``distributed_model_parallel_tpu/train/resilience.py``.
The reference loses everything since its last best-accuracy save on any
kill (SURVEY.md §5). The supervisor closes the loop:

* **non-finite loss/params** → restore the per-epoch "last good"
  checkpoint slot, optionally shrink the learning rate, and retry the
  epoch — bounded by ``RecoveryConfig.max_retries``;
* **torn/corrupt newest checkpoint** on any supervised restore → the
  integrity manifest rejects it and the restore falls back to the
  previous committed version (:meth:`RecoverySupervisor.note_fallback`);
* **failed save** of the good slot → recorded, retried once, and
  otherwise skipped (the previous committed version stays restorable);
* **stalled sync** → the :class:`Watchdog` logs "still blocked after Ns"
  lines while the sync blocks and, with ``RecoveryConfig.stall_exit``,
  escalates to a graceful checkpoint-and-exit through the preemption
  flag;
* **no-quorum replica divergence** (``train/consistency.py``) → restore
  the good slot and retry on the same bounded budget.

Every detection emits a ``failure`` record and every action a
``recovery`` record into the run's ``.jsonl`` (``RunLogger.telemetry``).

With a process group every rank runs a supervisor: the tree a save takes
is built on every rank (its gathers are collectives), rank 0
(``writer``) writes it, and the others wait at ``barrier``; a restore
reads the file on every rank.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Sequence

from distributed_model_parallel_tpu_torch.config import RecoveryConfig
from distributed_model_parallel_tpu_torch.utils import flightrec, health, tracing
from distributed_model_parallel_tpu_torch.utils.faults import (
    CORRUPTION_KINDS,
    FaultInjector,
    FaultSpec,
)


class Watchdog:
    """Live stall watchdog around blocking sync points.

    ``watch()`` arms one long-lived monitor thread for the scope of a
    blocking call: while the call runs, the monitor logs "still blocked
    after Ns" every ``interval_s`` and, past the stall budget, flips
    ``stalled`` and fires ``on_escalate(what, seconds)`` once. On exit the
    overrun is also checked after the fact (a short overrun can finish
    between two ticks)."""

    def __init__(self, budget_s: float, *, interval_s: float | None = None,
                 logger=None,
                 on_escalate: Callable[[str, float], None] | None = None):
        self.budget_s = float(budget_s)
        self.interval_s = (float(interval_s) if interval_s
                           else min(30.0, max(0.05, self.budget_s / 2)))
        self.logger = logger
        self.on_escalate = on_escalate
        self.stalled = False
        self.worst_s = 0.0
        self._overrun_logged = False
        self._escalated = False
        self._cv = threading.Condition()
        self._armed_at: float | None = None
        self._what = "sync"
        self._gen = 0
        self._thread: threading.Thread | None = None

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.log_line(msg)

    def _escalate(self, what: str, dt: float) -> None:
        if self._escalated or self.on_escalate is None:
            return
        self._escalated = True
        self.on_escalate(what, dt)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._monitor,
                                            daemon=True, name="dmp-watchdog")
            self._thread.start()

    def _monitor(self) -> None:
        while True:
            with self._cv:
                while self._armed_at is None:
                    self._cv.wait()
                gen, t0, what = self._gen, self._armed_at, self._what
                self._cv.wait(self.interval_s)
                still = self._armed_at is not None and self._gen == gen
                dt = (time.perf_counter() - t0) if still else 0.0
            if still:
                # Log outside the lock: slow sink I/O never blocks the
                # main thread's disarm.
                self._log(f"watchdog: {what} still blocked after {dt:.1f}s "
                          f"(budget {self.budget_s:.1f}s)")
                if dt > self.budget_s:
                    self.stalled = True
                    self._escalate(what, dt)

    @contextlib.contextmanager
    def watch(self, what: str = "sync"):
        self._ensure_thread()
        t0 = time.perf_counter()
        with self._cv:
            self._gen += 1
            self._armed_at = t0
            self._what = what
            self._cv.notify()
        try:
            yield self
        finally:
            with self._cv:
                self._gen += 1
                self._armed_at = None
            dt = time.perf_counter() - t0
            self.worst_s = max(self.worst_s, dt)
            if dt > self.budget_s:
                self.stalled = True
                if not self._overrun_logged:
                    self._overrun_logged = True
                    self._log(f"guard: sync exceeded the stall budget "
                              f"({dt:.1f}s > {self.budget_s:.1f}s)")
                self._escalate(what, dt)


def _short(e: BaseException, n: int = 300) -> str:
    return f"{type(e).__name__}: {e}"[:n]


class RecoverySupervisor:
    """Per-trainer recovery policy (see the module docstring).

    The trainer owns the mechanics (its checkpoint tree, how restored
    state goes back into its tensors — in place —, how its optimizer's
    learning rate shrinks); the supervisor owns the policy (when to
    restore, the retry budget, what to record). ``slot`` is the trainer's
    "last good" checkpoint name, saved by :meth:`note_good` after every
    clean epoch and at :meth:`begin`. ``writer`` (rank 0) writes it;
    ``barrier`` (every rank) follows each save."""

    def __init__(self, config: RecoveryConfig, *, logger, ckpt, preemption,
                 slot: str = "good", injector: FaultInjector | None = None,
                 check_finite_every: int | None = None,
                 consistency_every: int | None = None,
                 device_ids: Sequence[int] = (), writer: bool = True,
                 barrier: Callable[[], None] | None = None):
        if config.max_retries < 0:
            raise ValueError(
                f"recovery.max_retries must be >= 0, got {config.max_retries}")
        if not (0.0 < config.lr_shrink <= 1.0):
            raise ValueError(
                f"recovery.lr_shrink must be in (0, 1], got "
                f"{config.lr_shrink}")
        if config.keep_checkpoints < 1:
            raise ValueError(
                f"recovery.keep_checkpoints must be >= 1, got "
                f"{config.keep_checkpoints}")
        self.config = config
        self.logger = logger
        self.ckpt = ckpt
        self.preemption = preemption
        self.slot = slot
        self.device_ids = tuple(device_ids)
        self.writer = writer
        self.barrier = barrier
        self.injector = (injector if injector is not None
                         else FaultInjector(config.faults))
        self.injector.on_fire = self._on_fault_fired
        self.retries_left = config.max_retries
        self.lr_scale = 1.0
        self._stall_reported = False
        self._fallback_reported: set[str] = set()
        sentinel_on = (consistency_every or 0) > 0
        if check_finite_every is not None and check_finite_every <= 0:
            # An injected NaN nothing detects tests no recovery. The
            # sentinel's finiteness column detects nan_params only (it
            # never sees the step metrics); it is flushed at every epoch
            # end, so armed means at least once an epoch.
            undetectable = sorted({
                s.kind for s in self.injector.plan
                if s.kind == "nan_loss"
                or (s.kind == "nan_params" and not sentinel_on)})
            if undetectable:
                raise ValueError(
                    f"the fault plan injects NaN ({', '.join(undetectable)})"
                    f" but check_finite_every is 0, so the guards would "
                    f"never detect it; set check_finite_every >= 1"
                    + ("" if sentinel_on else
                       " (or, for nan_params only, consistency_every >= 1)"))
            if self.enabled and not sentinel_on:
                self.logger.log_line(
                    "resilience: warning — recovery.max_retries is set but "
                    "check_finite_every is 0, so non-finite steps are never "
                    "detected (stall/preempt/save recovery still active)")
        if not sentinel_on:
            corrupting = sorted({s.kind for s in self.injector.plan
                                 if s.kind in CORRUPTION_KINDS})
            if corrupting:
                raise ValueError(
                    f"the fault plan injects silent corruption "
                    f"({', '.join(corrupting)}) but consistency_every is "
                    f"0, so the cross-replica sentinel would never detect "
                    f"it; set consistency_every >= 1")

    @property
    def enabled(self) -> bool:
        return self.config.max_retries > 0

    @property
    def _telemetry(self):
        return self.logger.telemetry

    def _on_fault_fired(self, spec: FaultSpec, site: str, index: int) -> None:
        self._telemetry.record("fault", fault=spec.kind, site=site,
                               index=index)
        self.logger.log_line(
            f"chaos: injected fault {spec.kind} at {site}[{index}]")

    # -- budget persistence ---------------------------------------------------
    def budgets(self) -> dict:
        """What a checkpoint carries so a restarted run cannot launder its
        retry allowance or drop an applied LR shrink."""
        return {"retries_left": self.retries_left, "lr_scale": self.lr_scale}

    def restore_budgets(self, retries_left: int, lr_scale: float) -> None:
        """Adopt checkpointed budgets on resume (``retries_left`` clamped to
        the configured budget); the caller re-applies ``lr_scale``."""
        self.retries_left = max(0, min(int(retries_left),
                                       self.config.max_retries))
        self.lr_scale = float(lr_scale)

    # -- good-state bookkeeping -----------------------------------------------
    def begin(self, tree_fn: Callable[[], Any]) -> None:
        """Seed the good slot at ``fit`` start (no-op when disabled)."""
        self.note_good(tree_fn)

    def _save(self, tree) -> None:
        if self.writer:
            self.ckpt.save(tree, self.slot, wait=True)

    def note_good(self, tree_fn: Callable[[], Any]) -> None:
        """Persist the current (checked) state as "last good". A failed
        save is recorded, retried once, and otherwise skipped — it must
        not kill a run that was healthy a moment ago. Every rank calls
        (the tree's gathers are collectives); the writer saves."""
        if not self.enabled:
            return
        tree = tree_fn()
        try:
            self._save_retrying(tree)
        finally:
            if self.barrier is not None:
                self.barrier()

    def _save_retrying(self, tree) -> None:
        try:
            with tracing.span("good_save", slot=self.slot):
                t0 = time.perf_counter()
                self._save(tree)
            health.observe_io(self.device_ids, time.perf_counter() - t0)
            return
        except Exception as e:  # noqa: BLE001 - any save failure is handled
            self._telemetry.failure("checkpoint-save-failed", stage=self.slot,
                                    detail=_short(e))
            self.logger.log_line(
                f"resilience: save to {self.slot!r} failed "
                f"({type(e).__name__}) — retrying once")
        try:
            self._save(tree)
        except Exception as e:  # noqa: BLE001
            self._telemetry.recovery(action="save-skipped", slot=self.slot,
                                     detail=_short(e))
            self.logger.log_line(
                "resilience: retry failed — keeping the previous committed "
                "version of the good slot")
        else:
            self._telemetry.recovery(action="save-retried", slot=self.slot)
            self.logger.log_line("resilience: good-slot save retry succeeded")

    # -- recovery actions ------------------------------------------------------
    def _restore_and_retry(self, *, epoch: int, label: str,
                           restore: Callable[[], None],
                           shrink_lr: Callable[[float], None] | None
                           ) -> bool:
        """Restore the good slot and retry: True when the epoch should be
        retried, False when the caller must re-raise."""
        if not self.enabled:
            return False
        if self.retries_left <= 0:
            self.logger.log_line(
                f"resilience: {label} retry budget exhausted — raising")
            flightrec.dump(f"unrecovered-{label}",
                           telemetry_run=self._telemetry)
            return False
        self.retries_left -= 1
        try:
            with tracing.span("recovery_restore", slot=self.slot,
                              label=label):
                restore()
        except FileNotFoundError:
            self.logger.log_line(
                f"resilience: no {self.slot!r} checkpoint to restore — "
                f"raising")
            flightrec.dump(f"unrecovered-{label}",
                           telemetry_run=self._telemetry)
            return False
        except Exception as e:  # noqa: BLE001 - e.g. every version torn
            self._telemetry.failure("recovery-restore-failed",
                                    slot=self.slot, detail=_short(e))
            self.logger.log_line(
                f"resilience: restoring {self.slot!r} failed "
                f"({type(e).__name__}: {str(e)[:160]}) — raising the "
                f"original {label} error")
            flightrec.dump(f"unrecovered-{label}",
                           telemetry_run=self._telemetry, error=e)
            return False
        if shrink_lr is not None and self.config.lr_shrink != 1.0:
            self.lr_scale *= self.config.lr_shrink
            shrink_lr(self.config.lr_shrink)
        elif label == "non-finite":
            # The restored position replays the exact batches and draws,
            # so a data-deterministic NaN recurs without an LR shrink.
            self.logger.log_line(
                "resilience: retrying with lr_shrink=1.0 replays the "
                "identical batch/rng trajectory — a deterministic "
                "non-finite will recur; set recovery.lr_shrink < 1.0 to "
                "perturb the retry")
        self._telemetry.recovery(action="restored", slot=self.slot,
                                 epoch=epoch, retries_left=self.retries_left,
                                 lr_scale=self.lr_scale, detail=label)
        self.logger.log_line(
            f"resilience: {label} at epoch {epoch} — restored "
            f"{self.slot!r}, lr x{self.lr_scale:g}, retrying "
            f"({self.retries_left} retries left)")
        return True

    def recover_nonfinite(self, exc: BaseException, *, epoch: int,
                          restore: Callable[[], None],
                          shrink_lr: Callable[[float], None] | None = None
                          ) -> bool:
        """A NonFiniteError out of an epoch: record it, restore, retry."""
        self._telemetry.failure("non-finite", epoch=epoch,
                                detail=_short(exc),
                                retries_left=self.retries_left)
        return self._restore_and_retry(epoch=epoch, label="non-finite",
                                       restore=restore, shrink_lr=shrink_lr)

    def recover_divergence(self, exc: BaseException, *, epoch: int,
                           restore: Callable[[], None]) -> bool:
        """A no-quorum ReplicaDivergenceError from the sentinel (which
        already recorded the detection): restore the good slot and retry,
        with no LR shrink — divergence is a hardware or transport lie,
        not an optimization instability."""
        return self._restore_and_retry(epoch=epoch,
                                       label="replica-divergence",
                                       restore=restore, shrink_lr=None)

    def note_fallback(self, path: str, reason: str) -> None:
        """Checkpointer callback: a torn/corrupt version was skipped. One
        failure/recovery pair per path."""
        if path in self._fallback_reported:
            return
        self._fallback_reported.add(path)
        self._telemetry.failure("checkpoint-torn", detail=f"{path}: "
                                f"{reason}"[:300])
        self._telemetry.recovery(action="checkpoint-fallback", detail=path)
        self.logger.log_line(
            f"resilience: checkpoint {path} failed verification/restore "
            f"({reason[:120]}) — falling back to the previous version")

    def on_stall(self, what: str, blocked_s: float) -> None:
        """Watchdog escalation: record the stall (and penalize the
        device's health); with ``stall_exit`` request a graceful
        checkpoint-and-exit."""
        health.observe_stall(self.device_ids, blocked_s)
        if self._stall_reported:
            return
        self._stall_reported = True
        self._telemetry.failure(
            "stall", detail=f"{what} blocked {blocked_s:.1f}s "
            f"(budget exceeded)")
        flightrec.dump(f"stall-{what}", telemetry_run=self._telemetry)
        if self.config.stall_exit:
            self.logger.log_line(
                "resilience: stall budget exceeded — requesting graceful "
                "checkpoint-and-exit")
            self.preemption.request()


# -- the CLIs' flags --------------------------------------------------------------

def add_cli_flags(p, *, data_parallel: bool = True) -> None:
    """The JAX training scripts' resilience flags, on ``p``.
    ``data_parallel=False`` (the single-controller pipeline) leaves out
    ``--elastic``, which only refits a data axis."""
    p.add_argument("--check-finite-every", default=0, type=int,
                   help="check drained metrics every sync and the params "
                        "every N steps for NaN/Inf (0 = off)")
    p.add_argument("--stall-budget", default=None, type=float, metavar="S",
                   help="arm the live stall watchdog around blocking syncs")
    p.add_argument("--consistency-every", default=0, type=int, metavar="N",
                   help="cross-replica consistency sentinel every N steps "
                        "(0 = off)")
    p.add_argument("--barrier-timeout", default=None, type=float,
                   metavar="S",
                   help="hard bound on each consistency check's blocking "
                        "operations (a wedged rank is reported as a "
                        "straggler)")
    p.add_argument("--recovery-retries", default=0, type=int,
                   help="restore the last good checkpoint and retry the "
                        "epoch on non-finite or no-quorum detections, up "
                        "to N times (0 = fail fast)")
    p.add_argument("--recovery-lr-shrink", default=1.0, type=float,
                   help="multiply the LR by this factor on every "
                        "non-finite recovery (e.g. 0.5)")
    p.add_argument("--stall-exit", action="store_true",
                   help="escalate a stall-budget overrun to a graceful "
                        "checkpoint-and-exit")
    p.add_argument("--inject-faults", default=None, metavar="PLAN",
                   help="deterministic chaos plan, e.g. "
                        "'nan_loss@1,stall@0:0.5' (utils/faults.py)")
    p.add_argument("--emergency-every", default=0, type=int, metavar="N",
                   help="write the emergency checkpoint slot every N "
                        "steps (0 = only the preemption save)")
    if data_parallel:
        p.add_argument("--elastic", action="store_true",
                       help="refit the data axis to the live world on "
                            "start (resume reshards the checkpoint)")


def config_fields(args) -> dict:
    """The ``TrainConfig``/``LMTrainConfig`` fields of
    :func:`add_cli_flags`' flags."""
    from distributed_model_parallel_tpu_torch.utils.faults import (
        parse_faults,
    )

    return dict(
        check_finite_every=args.check_finite_every,
        stall_budget_s=args.stall_budget,
        consistency_every=args.consistency_every,
        emergency_every=args.emergency_every,
        elastic=getattr(args, "elastic", False),
        recovery=RecoveryConfig(
            max_retries=args.recovery_retries,
            lr_shrink=args.recovery_lr_shrink,
            stall_exit=args.stall_exit,
            barrier_timeout_s=args.barrier_timeout,
            faults=(parse_faults(args.inject_faults)
                    if args.inject_faults else ())))
