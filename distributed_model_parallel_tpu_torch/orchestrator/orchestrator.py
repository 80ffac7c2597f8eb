"""The multi-tenant control loop: admission, stepping, preemption, reap.

The counterpart of ``distributed_model_parallel_tpu/orchestrator/
orchestrator.py``: the same loop, records and messages. One
:class:`Orchestrator` owns a :class:`~.scheduler.DevicePool` over its
slots (default: every visible card, one slot each) and drives every
submitted :class:`~.tenants.Tenant` through its lifecycle:

    submit -> QUEUED -> (admission: exact slice granted, trainer built,
    possibly resumed/resharded) -> RUNNING -> step grants in deterministic
    round-robin -> {COMPLETED | PREEMPTING -> re-queued | FAILED}

Scheduling decisions happen only between settled states: tenants advance
one at a time (``Tenant.grant_steps`` is synchronous, for a tenant on a
thread and for a rank group alike), so a fixed submission order and seeds
replay the same campaign.

The orchestrator writes its own fleet stream (``fleet.jsonl``: typed
``tenant`` records for every lifecycle event, ``event`` records for
topology changes, ``health`` records for the device-health monitor's
transitions, and the ``round`` / ``drain_tenant`` / ``reap`` spans) next
to the per-tenant streams the trainers write; ``utils/telemetry.
merge_streams`` joins them. The ``fleet`` provider serves the tenant table
on the status exporter, and a failing tenant writes the flight recorder's
``tenant-failed-<name>`` bundle.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

from distributed_model_parallel_tpu_torch.orchestrator.scheduler import (
    DevicePool,
    Scheduler,
)
from distributed_model_parallel_tpu_torch.orchestrator.tenants import (
    Tenant,
    TenantSpec,
    TenantState,
)
from distributed_model_parallel_tpu_torch.utils import tracing
from distributed_model_parallel_tpu_torch.utils.telemetry import TelemetryRun
from distributed_model_parallel_tpu_torch.utils.tracing import span

__all__ = ["Orchestrator", "UnschedulableError"]


class UnschedulableError(RuntimeError):
    """The queue cannot make progress: tenants are waiting, nothing is
    running or draining, and no admission is possible (e.g. a pipeline
    tenant needs more devices than the shrunken pool has)."""


class Orchestrator:
    """Runs many heterogeneous training jobs on a shared device pool.

    ``devices``: ``torch.device`` s, device strings or
    :class:`~.scheduler.DeviceSlot` s (several slots may share a card);
    default every visible card, one slot each. ``quantum`` is the number
    of train steps granted per RUNNING tenant per round: the fairness
    knob, not a correctness one (every trainer checkpoint carries its
    exact position wherever the quantum falls).
    """

    def __init__(self, devices: Sequence | None = None, *,
                 workdir: str = "./orchestrator",
                 quantum: int = 2,
                 max_stagnant_rounds: int = 50,
                 health=None,
                 grow_back: bool = True,
                 statusz_port: int | None = None,
                 alerts=None,
                 flight_recorder=None):
        self.pool = DevicePool(devices)
        self.scheduler = Scheduler(self.pool)
        self.quantum = max(1, int(quantum))
        self.max_stagnant_rounds = max_stagnant_rounds
        # Device-health sentinel (utils/health.DeviceHealthMonitor): when
        # given, it is installed process-wide so the tenants' trainers
        # feed it timing signals, and every round consumes its
        # transitions — quarantine + proactive migration, probation
        # reinstate + grow-back. None = reactive-only orchestration.
        self.health = health
        self.grow_back = bool(grow_back)
        if health is not None:
            from distributed_model_parallel_tpu_torch.utils import health as hm

            hm.install(health)
        # Crash flight recorder (utils/flightrec.FlightRecorder): when
        # given, installed process-wide so every tenant's telemetry tees
        # into its ring and a failing tenant/stall dumps a postmortem
        # bundle. None = no ring, no bundles (the no-op default).
        self.flight_recorder = flight_recorder
        if flight_recorder is not None:
            from distributed_model_parallel_tpu_torch.utils import flightrec

            flightrec.install(flight_recorder)
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.telemetry = TelemetryRun(
            os.path.join(workdir, "fleet.jsonl"), run="fleet",
            meta={"n_devices": len(self.pool.devices)})
        # SLO alert engine (utils/alerts.AlertEngine): every round it
        # live-tails the tenants' streams, re-evaluates its rules, and
        # writes deduplicated typed ``alert`` records (firing/resolved)
        # onto the fleet stream. None = no alerting.
        self.alerts = alerts
        if alerts is not None and alerts.sink is None:
            alerts.sink = self.telemetry
        self.tenants: dict[str, Tenant] = {}
        self.rounds = 0
        self._seq = 0
        self._admit_seq = 0
        # Every (tenant, device-ids) grant ever made, for the
        # no-overlap/auditing tests and the fleet summary.
        self.assignment_log: list[dict] = []
        # Live status exporter (utils/statusz.py): the fleet's tenant
        # table / pool state under /statusz. Tenants join THIS exporter
        # as providers (one exporter per process; tenants are labels,
        # not ports). No-op when no port is configured anywhere.
        from distributed_model_parallel_tpu_torch.utils import statusz

        statusz.maybe_serve(statusz_port)
        statusz.register("fleet", self._status)

    # -- bookkeeping ----------------------------------------------------------
    def _status(self) -> dict:
        """The fleet's /statusz provider payload: the tenant table
        (state / devices / attempt / step), pool state, firing alerts."""
        return {
            "workload": "fleet",
            "rounds": self.rounds,
            "tenants": {
                t.name: {
                    "state": t.state.value,
                    "workload": t.spec.workload,
                    "priority": t.priority,
                    "devices": [d.id for d in t.devices],
                    "attempt": t.attempts,
                    "global_step": t.global_step,
                } for t in sorted(self.tenants.values(),
                                  key=lambda t: t.seq)},
            "pool": {
                "n_devices": len(self.pool.devices),
                "n_free": self.pool.n_free,
                "revoked": list(self.pool.revoked_ids),
                "quarantined": list(self.pool.quarantined_ids),
            },
            "alerts_firing": (self.alerts.firing
                              if self.alerts is not None else []),
            "failed_tenants": [t.name for t in self.tenants.values()
                               if t.state is TenantState.FAILED],
            # The control loop being alive IS fleet liveness: one failed
            # tenant is that tenant's problem (its row + alerts say so);
            # flipping the whole process's /healthz to 503 over it would
            # make a liveness probe restart a healthy fleet.
            "healthy": True,
        }

    def _apply_alerts(self) -> None:
        """One alert-engine pass: tail every tenant stream that exists,
        refresh the level signals (health scores), and tick — each
        firing/resolved transition lands as a typed ``alert`` record on
        the fleet stream (the engine's sink)."""
        if self.alerts is None:
            return
        for path in self.telemetry_paths()[1:]:
            self.alerts.watch(path)
        if self.health is not None:
            snap = self.health.snapshot()
            self.alerts.set_signal("health_scores",
                                   {int(k): v
                                    for k, v in snap["scores"].items()})
        self.alerts.poll()
        self.alerts.tick()

    def _record(self, tenant: Tenant, event: str, **fields) -> None:
        self.telemetry.record("tenant", name=tenant.name, event=event,
                              priority=tenant.priority, round=self.rounds,
                              **fields)

    def _by_state(self, *states: TenantState) -> list[Tenant]:
        return sorted((t for t in self.tenants.values()
                       if t.state in states), key=lambda t: t.seq)

    # -- submission / churn ---------------------------------------------------
    def submit(self, spec: TenantSpec) -> Tenant:
        if spec.name in self.tenants:
            raise ValueError(f"tenant name {spec.name!r} already submitted")
        log_key = (spec.config.log_dir, spec.config.log_name)
        for other in self.tenants.values():
            if other.spec.config.checkpoint_dir == spec.config.checkpoint_dir:
                raise ValueError(
                    f"tenant {spec.name!r} shares checkpoint_dir "
                    f"{spec.config.checkpoint_dir!r} with "
                    f"{other.name!r} — slots would clobber each other")
            if (other.spec.config.log_dir,
                    other.spec.config.log_name) == log_key:
                raise ValueError(
                    f"tenant {spec.name!r} shares telemetry stream "
                    f"{os.path.join(*log_key)}.jsonl with {other.name!r} — "
                    f"two tenants appending to one stream would merge "
                    f"under mixed attribution")
        tenant = Tenant(spec, self._seq)
        self._seq += 1
        self.tenants[spec.name] = tenant
        self._record(tenant, "submitted", workload=spec.workload)
        return tenant

    def cancel(self, name: str) -> None:
        """Tenant churn: withdraw a job. Queued jobs drop immediately; a
        running job is preempted (its checkpoint survives for a later
        campaign) and not re-queued."""
        tenant = self.tenants[name]
        if tenant.state is TenantState.QUEUED:
            tenant.state = TenantState.CANCELLED
            self._record(tenant, "cancelled")
        elif tenant.state in (TenantState.RUNNING, TenantState.PREEMPTING):
            tenant._cancel_on_reap = True
            self._preempt(tenant, reason="cancelled")

    # -- preemption -----------------------------------------------------------
    def preempt(self, name: str, *, reason: str = "manual") -> None:
        """Operator-initiated preemption of a running tenant (the
        scheduler's priority preemptions and topology shrinks route
        through the same path). The tenant drains through its preempt
        checkpoint on the next round and re-queues for resumption."""
        tenant = self.tenants[name]
        if tenant.state not in (TenantState.RUNNING,
                                TenantState.PREEMPTING):
            raise ValueError(f"tenant {name!r} is {tenant.state.value}, "
                             f"not running")
        self._preempt(tenant, reason=reason)

    def _preempt(self, tenant: Tenant, *, reason: str) -> None:
        if tenant.state is TenantState.PREEMPTING:
            return
        tenant.preemptions += 1
        tenant.request_preemption()
        self._record(tenant, "preempt-requested", reason=reason,
                     global_step=tenant.global_step)

    # -- topology churn -------------------------------------------------------
    def shrink(self, n: int) -> tuple[int, ...]:
        """Topology shrink: take ``n`` devices out of service. Tenants
        holding a revoked device are preempted; re-admission refits them
        to whatever remains (``fit_mesh_to_devices`` + resharded
        restore)."""
        ids = self.pool.revoke(n)
        self.telemetry.record("event",
                              message=f"topology shrink: revoked {ids}")
        for name in self.pool.holders_of_revoked():
            self._preempt(self.tenants[name], reason="topology-shrink")
        return ids

    def grow(self, n: int | None = None) -> tuple[int, ...]:
        """Topology grow: return revoked devices to service."""
        ids = self.pool.restore(n)
        if ids:
            self.telemetry.record("event",
                                  message=f"topology grow: restored {ids}")
        return ids

    # -- device health (utils/health.py) --------------------------------------
    def _apply_health(self) -> None:
        """Consume the health monitor's transitions for this round: every
        event becomes a typed ``health`` record on the fleet stream;
        newly quarantined devices leave the pool and their holders are
        proactively migrated — preempted through the ordinary
        preempt-checkpoint path *before* the degradation becomes a crash
        — and reinstated devices return to the free pool (where the
        grow-back pass may expand a shrunken tenant onto them)."""
        if self.health is None:
            return
        events = self.health.tick()
        quarantine: list[int] = []
        reinstate: list[int] = []
        for ev in events:
            self.telemetry.record("health", round=self.rounds, **ev)
            if ev["event"] == "quarantine":
                quarantine += ev["devices"]
            elif ev["event"] == "reinstate":
                reinstate += ev["devices"]
        if reinstate:
            back = self.pool.reinstate(reinstate)
            if back:
                self.telemetry.record(
                    "event", message=f"health reinstate: {back} back in "
                                     f"service after probation")
        if quarantine:
            # A maintenance-revoked device is already out of service —
            # quarantining it on top is a policy conflict the pool
            # rejects; it re-enters health scoring when restored.
            eligible = [i for i in quarantine
                        if i not in self.pool.revoked_ids]
            ids = self.pool.quarantine(eligible) if eligible else ()
            if ids:
                self.telemetry.record(
                    "event",
                    message=f"health quarantine: {ids} out of service")
            for name in self.pool.holders_of_quarantined():
                self._preempt(self.tenants[name], reason="device-degraded")

    def _maybe_grow_back(self) -> None:
        """Grow-back elasticity: a tenant running below its requested
        data-parallel degree (it was re-admitted onto a shrunken slice)
        is preempt-checkpointed and re-queued as soon as enough devices
        are free to place it larger — re-admission then lands it on the
        bigger slice at the exact global step. Only fires when the queue
        is empty (queued tenants own freed devices first — grow-back
        must not starve admissions) and at most one tenant per round
        (the re-queued tenant's own admission settles before the next
        candidate is considered, so growth never thrashes)."""
        if not self.grow_back or self.pool.n_free == 0:
            return
        if self._by_state(TenantState.QUEUED):
            return
        for t in sorted(self._by_state(TenantState.RUNNING),
                        key=lambda t: t.admit_seq):
            if not t.alive or t.spec.workload == "pipeline":
                continue
            cur = len(t.devices)
            want = self.scheduler.resolve_slice(
                t.spec, self.pool.n_free + cur)
            if want is not None and want > cur:
                # grow_backs counts GRANTED expansions: _admit compares
                # the re-admission grant against this size (the pool can
                # shrink again while the tenant drains, in which case
                # the cycle was churn, not growth).
                t._grow_back_from = cur
                self._preempt(t, reason="grow-back")
                self._record(t, "grow-back",
                             devices=[d.id for d in t.devices],
                             target_devices=want,
                             global_step=t.global_step)
                return

    # -- the control loop -----------------------------------------------------
    def _admit(self) -> int:
        """Serve the queue in (priority desc, submission order): grant
        free slices, or arrange preemptions for strictly-lower-priority
        victims. Head-of-line blocking — see scheduler.py. Returns how
        many tenants were admitted."""
        admitted = 0
        queue = sorted(self._by_state(TenantState.QUEUED),
                       key=lambda t: (-t.priority, t.seq))
        running = self._by_state(TenantState.RUNNING, TenantState.PREEMPTING)
        for waiter in queue:
            n = self.scheduler.resolve_slice(waiter.spec, self.pool.n_free)
            if n is not None:
                devices = self.pool.assign(waiter.name, n)
                granted = self.pool.assigned_ids(waiter.name)
                # Hard no-overlap invariant, independently of pool
                # internals: the grant must be disjoint from every other
                # live assignment.
                for other, ids in self.pool.assignments().items():
                    if other != waiter.name and set(ids) & set(granted):
                        raise RuntimeError(
                            f"device overlap: {waiter.name!r} granted "
                            f"{granted} while {other!r} holds {ids}")
                if getattr(waiter, "_grow_back_from", None) is not None:
                    if n > waiter._grow_back_from:
                        waiter.grow_backs += 1
                    waiter._grow_back_from = None
                waiter.start(devices, self._admit_seq)
                self._admit_seq += 1
                self.assignment_log.append(
                    {"round": self.rounds, "tenant": waiter.name,
                     "devices": granted, "attempt": waiter.attempts})
                self._record(waiter, "admitted", devices=list(granted),
                             attempt=waiter.attempts)
                # Settle construction (and any resume/reshard) before the
                # next scheduling decision; a construction that dies
                # immediately is reaped this same round.
                waiter.wait_boundary()
                admitted += 1
                continue
            victims = self.scheduler.pick_victims(waiter, running)
            if victims:
                for v in victims:
                    self._preempt(v, reason=f"priority:{waiter.name}")
            # Whether drains are pending or the waiter is simply too big
            # right now: hold the line so later (lower-priority) arrivals
            # can't steal the devices it is waiting for.
            break
        return admitted

    def _reap(self) -> None:
        """Collect finished tenant threads: free their devices and route
        the outcome — completed, preempted (re-queue with resume), or
        failed (the unrecovered ledger)."""
        for tenant in self._by_state(TenantState.RUNNING,
                                     TenantState.PREEMPTING):
            if tenant.alive:
                continue
            tenant.join()
            ids = self.pool.release(tenant.name)
            tenant.devices = ()
            if tenant.outcome == "failed":
                tenant.state = TenantState.FAILED
                self._record(tenant, "failed", devices=list(ids),
                             error=f"{type(tenant.error).__name__}: "
                                   f"{tenant.error}"[:300])
            elif tenant.outcome == "completed":
                tenant.state = TenantState.COMPLETED
                self._record(tenant, "completed", devices=list(ids),
                             global_step=tenant.global_step,
                             attempts=tenant.attempts)
            else:                   # preempted — checkpointed, resumable
                if tenant.state is TenantState.RUNNING:
                    # Self-preemption: an injected preempt fault or a
                    # stall-watchdog escalation inside the tenant, not an
                    # orchestrator decision — count it the same.
                    tenant.preemptions += 1
                tenant.preempted_at_step = tenant.global_step
                if getattr(tenant, "_cancel_on_reap", False):
                    tenant.state = TenantState.CANCELLED
                    self._record(tenant, "cancelled", devices=list(ids),
                                 global_step=tenant.global_step)
                else:
                    tenant.state = TenantState.QUEUED
                    self._record(tenant, "preempted", devices=list(ids),
                                 global_step=tenant.global_step)

    def pending(self) -> bool:
        return any(t.state in (TenantState.QUEUED, TenantState.RUNNING,
                               TenantState.PREEMPTING)
                   for t in self.tenants.values())

    def run_round(self) -> bool:
        """One scheduling round: admit, advance every running tenant by
        the quantum (admission order — deterministic), reap. Returns
        whether any tenant advanced or changed state. Each round is a
        ``round`` span on the fleet stream (utils/tracing.py) so the
        control loop's own cadence — and which rounds spent their time
        admitting/draining — renders on the fleet timeline next to the
        tenant lifecycle records."""
        before = {n: t.state for n, t in self.tenants.items()}
        # The exporter may have been started AFTER construction (a
        # tenant's statusz_port arriving first): re-registering is one
        # idempotent dict write, and keeps the fleet provider on
        # whatever exporter the process ended up with.
        from distributed_model_parallel_tpu_torch.utils import statusz

        statusz.register("fleet", self._status)
        with tracing.sink_scope(self.telemetry), \
                span("round", round=self.rounds) as sp:
            self._apply_health()
            self._apply_alerts()
            admitted = self._admit()
            self._maybe_grow_back()
            moved = admitted > 0
            for tenant in sorted(self._by_state(TenantState.RUNNING,
                                                TenantState.PREEMPTING),
                                 key=lambda t: t.admit_seq):
                if tenant.state is TenantState.PREEMPTING:
                    with span("drain_tenant", tenant=tenant.name):
                        tenant.drain()
                    moved = True
                elif tenant.alive:
                    tenant.grant_steps(self.quantum)
                    moved = True
            with span("reap"):
                self._reap()
            sp.annotate(admitted=admitted)
        self.rounds += 1
        after = {n: t.state for n, t in self.tenants.items()}
        return moved or after != before

    def run(self, *, on_round: Callable[["Orchestrator", int], None]
            | None = None, max_rounds: int | None = None) -> dict:
        """Drive rounds until every tenant reaches a terminal state.

        ``on_round(orchestrator, round_index)`` fires before each round —
        a campaign's injection point for topology churn and late tenant
        submissions. Raises :class:`UnschedulableError` when
        the queue stagnates (nothing running, nothing admissible) and
        RuntimeError past ``max_rounds``.
        """
        stagnant = 0
        try:
            while self.pending():
                if max_rounds is not None and self.rounds >= max_rounds:
                    pending = self._by_state(TenantState.QUEUED,
                                             TenantState.RUNNING,
                                             TenantState.PREEMPTING)
                    raise RuntimeError(
                        f"orchestrator exceeded {max_rounds} rounds with "
                        f"tenants still pending: "
                        f"{[t.name for t in pending]}")
                if on_round is not None:
                    on_round(self, self.rounds)
                if self.run_round():
                    stagnant = 0
                else:
                    stagnant += 1
                    if stagnant > self.max_stagnant_rounds:
                        waiting = [t.name for t in
                                   self._by_state(TenantState.QUEUED)]
                        raise UnschedulableError(
                            f"no progress for {stagnant} rounds; queued "
                            f"tenants {waiting} cannot be placed on "
                            f"{self.pool.n_free} free devices "
                            f"(revoked: {self.pool.revoked_ids}, "
                            f"quarantined: {self.pool.quarantined_ids})")
        except BaseException:
            # A campaign dying mid-run never reaches close(): the
            # process-wide health monitor must not keep collecting (and
            # queueing events for) a dead campaign from later runs in
            # the same process.
            self._uninstall_health()
            self._uninstall_flightrec()
            raise
        # Final alert pass: the last tenants' tail records (written
        # after their final round) must still be able to resolve a
        # firing alert before the campaign summary reads it.
        self._apply_alerts()
        return self.summary()

    # -- results --------------------------------------------------------------
    def telemetry_paths(self) -> list[str]:
        """Every telemetry stream of this campaign: the fleet stream plus
        one per tenant (deduplicated — a resumed tenant appends to the
        same stream)."""
        paths = [self.telemetry.path]
        for t in sorted(self.tenants.values(), key=lambda t: t.seq):
            if t.jsonl_path and t.jsonl_path not in paths:
                paths.append(t.jsonl_path)
        return paths

    def summary(self) -> dict:
        """Fleet outcome: per-tenant states, preemption/resume exactness
        accounting, and the unrecovered-failure ledger."""
        tenants = {}
        for t in sorted(self.tenants.values(), key=lambda t: t.seq):
            grants = [a["devices"] for a in self.assignment_log
                      if a["tenant"] == t.name]
            tenants[t.name] = {
                "workload": t.spec.workload,
                "priority": t.priority,
                "state": t.state.value,
                "attempts": t.attempts,
                "preemptions": t.preemptions,
                "grow_backs": t.grow_backs,
                "resumed_exact_step": t.resume_exact,
                "resume_fallbacks": t.resume_fallbacks,
                "global_step": t.global_step,
                "faults_injected": [s.kind for s in t.fired_faults],
                # Slice trajectory across admissions: the shrink/grow-back
                # story in one list (requested = the config-mesh ceiling).
                "requested_devices": t.spec.requested_devices(),
                "granted_sizes": [len(g) for g in grants],
                "counters": t.counter_deltas,
            }
        failed = {t.name: f"{type(t.error).__name__}: {t.error}"[:300]
                  for t in self.tenants.values()
                  if t.state is TenantState.FAILED}
        return {
            "rounds": self.rounds,
            "tenants": tenants,
            "unrecovered": failed,
            "all_resumes_exact": all(
                all(t.resume_exact) for t in self.tenants.values()),
            "assignments": self.assignment_log,
            # The campaign's alert story: every firing/resolved
            # transition the engine emitted, plus what is STILL firing
            # at summary time (an operator's "anything red?" answer).
            "alerts": (list(self.alerts.events)
                       if self.alerts is not None else []),
            "alerts_firing": (self.alerts.firing
                              if self.alerts is not None else []),
            "postmortems": (list(self.flight_recorder.dumps)
                            if self.flight_recorder is not None else []),
        }

    def _uninstall_health(self) -> None:
        if self.health is not None:
            from distributed_model_parallel_tpu_torch.utils import health as hm

            if hm.installed() is self.health:
                hm.uninstall()

    def _uninstall_flightrec(self) -> None:
        if self.flight_recorder is not None:
            from distributed_model_parallel_tpu_torch.utils import flightrec

            if flightrec.installed() is self.flight_recorder:
                flightrec.uninstall()

    def close(self, **fields) -> None:
        self._uninstall_health()
        self._uninstall_flightrec()
        from distributed_model_parallel_tpu_torch.utils import statusz

        statusz.unregister("fleet")
        self.telemetry.finish(**fields)
