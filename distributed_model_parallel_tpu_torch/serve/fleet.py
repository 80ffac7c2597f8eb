"""Self-healing multi-replica serving fleet.

Counterpart of ``distributed_model_parallel_tpu/serve/fleet.py``.
``ServeFleet`` runs N independent :class:`~.engine.Engine` replicas —
one model copy and one paged KV pool each, on a disjoint slice of a
:class:`~..orchestrator.scheduler.DevicePool` — behind a
:class:`~.router.Router` that admits requests with SLO-aware balancing
(power-of-two-choices over live queue depth + page occupancy, with a
prefix-affinity bonus toward the replica whose radix tree holds the
prompt). One fleet round = one router dispatch pass + one engine
iteration per live replica, all on one clock, so under a
:class:`~.traffic.SimClock` the whole fleet replays deterministically.

Placement: each replica's engine runs on the ``torch.device`` of the
first slot of its slice (the JAX fleet keeps only a ledger, its engines
all on JAX's default device). The default pool is one slot per card;
``devices=[torch.device("cuda", 0)] * n`` puts n replicas on one card,
``device="cpu"`` gives each replica a slot on the CPU. Parameters are
copied once to each card that holds a replica.

Self-healing: each replica's per-round wall time feeds the device-health
sentinel (``utils/health.DeviceHealthMonitor``) as a ``serve`` signal on
its slice; when the sentinel quarantines a replica's slots (or
:meth:`ServeFleet.kill_replica` / a ``kill_cell`` fault fires), the
replica is drained, not killed: every live request's committed tokens
and written K/V leave by value (``Engine.drain``), the prefix tree is
dropped and every page checked free (``Engine.clear_cache``), the slots
leave the pool, and each request re-admits on the least-loaded peer at
its committed position (``Engine.enqueue(force=True)``) — a typed
``migration`` record a move. A request's tokens are a function of
(prompt, seed), so a migrated request decodes bit for bit what an
unmigrated run decodes. The replica grows back on its exact slice after
the sentinel's probation (or ``revive_after`` rounds in drill mode).

Hard crashes (:meth:`ServeFleet.crash_replica`) discard a replica's
engine with no drain; the write-ahead journal (``serve/journal.py``)
re-admits each of its accepted, non-terminal requests on a live peer at
its disk watermark, and the peer's replay prefill re-derives the
committed prefix. :meth:`ServeFleet.recover` restarts a whole fleet from
a journal. A fleet whose loop dies fails every live request typed and
writes a flight-recorder bundle (``"fleet-killed"``,
``utils/flightrec.py``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from distributed_model_parallel_tpu_torch.models.transformer import (
    resolve_device,
)
from distributed_model_parallel_tpu_torch.orchestrator.scheduler import (
    DevicePool,
)
from distributed_model_parallel_tpu_torch.serve import (
    journal as journal_mod,
)
from distributed_model_parallel_tpu_torch.serve.cells import CellDirectory
from distributed_model_parallel_tpu_torch.serve.engine import (
    Engine,
    EngineKilled,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve.overload import (
    CircuitBreaker,
)
from distributed_model_parallel_tpu_torch.serve.router import Router
from distributed_model_parallel_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
    expiry_reason,
    next_arrived_by_class,
    overflow_victims,
    summarize,
    validate_request,
)
from distributed_model_parallel_tpu_torch.utils import flightrec, statusz
from distributed_model_parallel_tpu_torch.utils import health as health_mod
from distributed_model_parallel_tpu_torch.utils import tracing
from distributed_model_parallel_tpu_torch.utils.faults import FaultInjector
from distributed_model_parallel_tpu_torch.utils.metering import (
    LEDGER_BUCKETS,
    emit_meter,
)
from distributed_model_parallel_tpu_torch.utils.telemetry import registry

__all__ = ["Replica", "ServeFleet"]

LIVE = "live"
QUARANTINED = "quarantined"


@dataclasses.dataclass
class Replica:
    """One serving replica: an engine plus its device slice."""

    name: str
    engine: Engine
    device_ids: tuple[int, ...]
    state: str = LIVE
    quarantined_round: int | None = None
    kills: int = 0                   # quarantine cycles survived
    cell: str | None = None          # cell membership (serve/cells.py)
    crashes: int = 0                 # hard crashes (no-drain) survived


class ServeFleet:
    """N engine replicas behind an SLO-aware router (module docstring).

    Placement: ``pool`` (a :class:`DevicePool`) wins; else ``devices``
    (``torch.device`` s or :class:`~..orchestrator.scheduler.DeviceSlot`
    s) makes a fresh pool; else ``device`` does: ``"cuda"`` (the default)
    one slot per card, any other device ``n_replicas`` slots on it
    (``device="cpu"`` for the tests). Replicas hold their slices under
    ``serve-{name}``; each runs on its slice's first slot's device.
    ``health`` wires the device-health sentinel in;
    without it, :meth:`kill_replica` + ``revive_after`` drive the same
    quarantine/grow-back machinery (the chaos-drill mode).
    ``step_hook(round)`` runs once per fleet round — the drill's kill
    trigger, like the engine's per-iteration hook.
    """

    def __init__(self, params: dict, cfg, serve: ServeConfig,
                 n_replicas: int, *, pool=None, devices=None,
                 device=None, health=None, telemetry=None,
                 router_seed: int = 0, affinity_slack: float = 2.0,
                 revive_after: int | None = None,
                 step_hook=None, slo_metrics: bool = True,
                 breaker: CircuitBreaker | None = None,
                 faults=(), fault_replica: str | None = None,
                 cells=None, fault_cell: str | None = None,
                 cell_sick_threshold: float = 0.5, clock=None,
                 journal=None, meter: bool = True):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if not 0.0 < cell_sick_threshold <= 1.0:
            raise ValueError(f"cell_sick_threshold must be in (0, 1], "
                             f"got {cell_sick_threshold}")
        if serve.policy != "continuous":
            raise ValueError(
                "the fleet runs continuous-batching replicas; the static "
                "baseline exists for single-engine BENCH_serve comparisons")
        if device is not None and (pool is not None or devices is not None):
            raise ValueError("pass device= or devices=/pool=, not both")
        if pool is None:
            if devices is None:
                dev = resolve_device("cuda" if device is None else device)
                if dev.type != "cuda" or dev.index is not None:
                    devices = [dev] * n_replicas
            pool = DevicePool(devices)
        self.pool = pool
        per = pool.n_free // n_replicas
        if per < 1:
            raise ValueError(
                f"{n_replicas} replicas need >= 1 free device each; the "
                f"pool has {pool.n_free} free")
        self.serve = serve
        self.telemetry = telemetry
        self.health = health
        self.revive_after = revive_after
        self.step_hook = step_hook
        self._slo_metrics = slo_metrics
        # Resource metering (utils/metering.py): off switches the whole
        # billing plane — engine meters AND the fleet's own zero-cost
        # terminals — so the soak drill can A/B the schedule digest.
        self._meter = meter
        # Pluggable clock (serve/traffic.SimClock for the deterministic
        # chaos scenarios; the real monotonic clock otherwise). Virtual
        # mode advances one fixed dt per fleet round and skips idle gaps
        # to the next arrival, so every TTFT/deadline/goodput number is
        # a pure function of the trace + seed.
        self._virtual = clock is not None
        self._clock = clock if clock is not None else time.monotonic
        self._engine_clock = clock       # fresh post-crash engines reuse it
        # Write-ahead request journal (serve/journal.py): intent at
        # acceptance, committed-token watermarks from the engines,
        # exactly one terminal per trace. None = journal off — byte-
        # identical scheduling to a journal-less fleet. install() makes
        # it visible to the crash flight recorder's bundle.
        self.journal = journal
        if journal is not None:
            journal_mod.install(journal)
        # One copy of the parameters on each device that holds a replica.
        self._params: dict[torch.device, dict] = {}
        self.replicas: list[Replica] = []
        for i in range(n_replicas):
            name = f"r{i}"
            devs = pool.assign(f"serve-{name}", per)
            dev = devs[0].device
            eng = Engine(self._params_on(params, dev), cfg, serve,
                         device=dev, telemetry=telemetry,
                         slo_metrics=slo_metrics, replica=name,
                         clock=clock, journal=journal, meter=meter)
            self.replicas.append(Replica(
                name=name, engine=eng,
                device_ids=tuple(d.id for d in devs)))
        # Cell topology (serve/cells.py): an int partitions the replicas
        # into that many contiguous cells; a dict gives explicit
        # membership; a CellDirectory passes through; None keeps the
        # flat fleet. Contiguous blocks + the pool's
        # lowest-ids-first assignment make each cell's device slice a
        # contiguous id range.
        if cells is None:
            self.cells = None
        elif isinstance(cells, CellDirectory):
            self.cells = cells
        elif isinstance(cells, int):
            self.cells = CellDirectory.partition(
                [r.name for r in self.replicas], cells)
        else:
            self.cells = CellDirectory(cells)
        if self.cells is not None:
            known = {r.name for r in self.replicas}
            for c in self.cells.cells:
                missing = [n for n in self.cells.members(c)
                           if n not in known]
                if missing:
                    raise ValueError(f"cell {c!r} names unknown replicas "
                                     f"{missing}")
            for rep in self.replicas:
                rep.cell = self.cells.cell_of(rep.name)
        # Stamp each replica's meter with its cell so utilization
        # records roll up per cell (utils/metering.py).
        for rep in self.replicas:
            if rep.engine.meter is not None:
                rep.engine.meter.cell = rep.cell
        self.cell_sick_threshold = cell_sick_threshold
        self.router = Router(router_seed, affinity_slack=affinity_slack,
                             cells=self.cells)
        # Router-level admission circuit breaker (serve/overload.py):
        # repeated admission failures — a replica's bounded queue
        # staying full, or injected admission chaos — take the replica
        # out of the routing set until a half-open probe lands.
        # Distinct from health quarantine: an open breaker's replica
        # keeps serving its residents.
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # Serve-side chaos (utils/faults.py): slow_replica sleeps inside
        # the victim replica's timed round, admission_fail refuses its
        # admissions for a bounded run of attempts.
        self.injector = FaultInjector(faults) if faults else None
        for spec in (self.injector.plan if self.injector else ()):
            if spec.site not in ("serve", "admit", "cell"):
                raise ValueError(
                    f"fleet fault plans serve only the serve/admit/cell "
                    f"sites; {spec.kind!r} fires at {spec.site!r} "
                    f"(train-side faults belong on trainer "
                    f"RecoveryConfig plans)")
            if spec.site == "cell" and self.cells is None:
                raise ValueError(
                    f"{spec.kind!r} targets a cell, but the fleet has "
                    f"no cell topology (pass cells=)")
        self._fault_replica = fault_replica or self.replicas[-1].name
        if not any(r.name == self._fault_replica for r in self.replicas):
            raise ValueError(f"unknown fault_replica "
                             f"{self._fault_replica!r}")
        # The correlated-fault victim cell (kill_cell / slow_cell /
        # partition): default the LAST cell — disjoint from the c0
        # home-heavy head of the hash range often enough to keep drills
        # interesting, and symmetric with fault_replica's default.
        if self.cells is not None:
            self._fault_cell = fault_cell or self.cells.cells[-1]
            if self._fault_cell not in self.cells:
                raise ValueError(f"unknown fault_cell "
                                 f"{self._fault_cell!r}; known: "
                                 f"{list(self.cells.cells)}")
        elif fault_cell is not None:
            raise ValueError("fault_cell needs a cell topology "
                             "(pass cells=)")
        else:
            self._fault_cell = None
        # Correlated-fault runtime state: cells the router currently
        # cannot reach (partition), the active slow_cell period, cells
        # taken down whole (for the grow-back record), and the resident
        # requests caught inside an active partition (the drain-on-heal
        # accounting).
        self._partitioned: set[str] = set()
        self._slow_period: int | None = None
        self._cells_down: set[str] = set()
        self._partition_caught: list = []
        self._cell_kills = 0
        # Bounded fleet admission: beyond max_queue * n_replicas the
        # fleet REJECTS (typed, reason queue-full) instead of growing an
        # unbounded host-side list — batch sheds first: an arriving
        # interactive request displaces the newest queued batch one.
        self._max_pending = (serve.max_queue * n_replicas
                            if serve.max_queue is not None else None)
        self._pending: deque[Request] = deque()
        self._requests: list[Request] = []
        self._ids: set[str] = set()
        self._shed_by_reason: dict[str, int] = {}
        # Metering state the engines cannot see: per-tenant counts of
        # queue-only sheds (the request never reached an engine meter),
        # and the archived meters of hard-crashed engines — their
        # closed per-tenant rollups and duty history must survive the
        # engine object (crash_replica) or the cost table under-counts.
        self._tenant_sheds: dict[str, int] = {}
        self._dead_meters: list = []
        self._rejected = 0
        self._auto_rid = 0
        self._rounds = 0
        self._now = 0.0
        self._wall_s = 0.0
        self._migrations = 0
        self._kills = 0
        # Hard-crash accounting (serve/journal.py crash recovery):
        # crashes fired, requests re-admitted from the journal, and the
        # cumulative monotonic recovery-pass duration
        # (``recovery_time_s``, what a crash drill reports).
        self._crashes = 0
        self._crash_recovered = 0
        self.recovery_time_s = 0.0
        self.kill_times: dict[str, float] = {}
        self.revive_times: dict[str, float] = {}
        if slo_metrics:
            statusz.maybe_serve(serve.statusz_port)
            statusz.register("serve-fleet", self._status)
            self._set_live_gauge()

    def _params_on(self, params: dict, dev: torch.device) -> dict:
        """``params`` where they already live on ``dev``, else a copy there
        (made once per device)."""

        def here(t: torch.Tensor) -> bool:
            return t.device.type == dev.type and (
                dev.index is None or t.device.index == dev.index)

        if here(params["embed"]):
            return params
        if dev not in self._params:
            self._params[dev] = {
                k: ({bk: bv.to(dev) for bk, bv in v.items()}
                    if isinstance(v, dict) else v.to(dev))
                for k, v in params.items()}
        return self._params[dev]

    # -- views ---------------------------------------------------------------

    def _live(self) -> list[Replica]:
        return [r for r in self.replicas if r.state == LIVE]

    def _cell_members(self, cell: str) -> list[Replica]:
        return [r for r in self.replicas if r.cell == cell]

    def _live_cells(self) -> list[str]:
        """Cells with at least one live, reachable replica — the
        router's actual dispatch surface."""
        if self.cells is None:
            return []
        return [c for c in self.cells.cells
                if c not in self._partitioned
                and any(r.state == LIVE for r in self._cell_members(c))]

    def _holder(self, rep: Replica) -> str:
        return f"serve-{rep.name}"

    def _set_live_gauge(self) -> None:
        if self._slo_metrics:
            registry().gauge("serve_live_replicas").set(len(self._live()))
            if self.cells is not None:
                registry().gauge("serve_live_cells").set(
                    len(self._live_cells()))

    def _meters(self, *, cell: str | None = None) -> list:
        """Every meter in scope: the current engines' plus the archived
        meters of hard-crashed predecessors (``crash_replica`` swaps the
        engine object out, but its billed history must keep counting).
        ``cell`` narrows to one cell's members."""
        out = [r.engine.meter for r in self.replicas
               if r.engine.meter is not None
               and (cell is None or r.cell == cell)]
        out += [m for m in self._dead_meters
                if cell is None or m.cell == cell]
        return out

    @staticmethod
    def _merged_utilization(meters) -> dict | None:
        """Summed duty-cycle ledger across ``meters`` — the fleet and
        per-cell rollups for /statusz and the summary. Buckets keep
        partitioning wall exactly: sums of exact partitions."""
        if not meters:
            return None
        out = {b: 0.0 for b in LEDGER_BUCKETS}
        for m in meters:
            for bucket, s in m.ledger.items():
                out[bucket] += s
        return {**{f"{b}_s": round(s, 6) for b, s in out.items()},
                "wall_s": round(sum(out.values()), 6)}

    def _set_engine_gauges(self) -> None:
        """The fleet owns the process-global engine gauges: replica
        engines skip their own writes — N replicas flapping one
        unlabeled gauge would report whichever iterated last
        (per-replica numbers live on the /statusz providers).
        ``serve_page_occupancy`` is the MAX across live replicas (what
        the page-pool saturation alert wants to see),
        ``serve_shared_pages`` the fleet-wide sum, and the
        hit/accept-rate gauges pool the replicas' raw token counts (a
        per-replica mean would weight an idle replica like a busy
        one)."""
        live = self._live()
        if not (self._slo_metrics and live):
            return
        reg = registry()
        reg.gauge("serve_page_occupancy").set(
            max(r.engine.cache.occupancy for r in live))
        if self.serve.prefix_cache:
            reg.gauge("serve_shared_pages").set(
                sum(r.engine.cache.shared_pages for r in live))
            prompts = sum(r.engine._prompt_tokens for r in live)
            if prompts:
                reg.gauge("serve_cache_hit_rate").set(
                    sum(r.engine._cached_tokens for r in live) / prompts)
        if self.serve.spec_k:
            proposed = sum(r.engine._draft_proposed for r in live)
            if proposed:
                reg.gauge("serve_draft_accept_rate").set(
                    sum(r.engine._draft_accepted for r in live)
                    / proposed)
        if self.serve.brownout:
            # Worst (deepest) live replica level — the saturation view,
            # like the occupancy max above.
            reg.gauge("serve_brownout_level").set(
                max(r.engine.brownout.level for r in live))
        # Fleet duty-cycle gauges (utils/metering.py): each bucket's
        # fraction of the fleet's cumulative iteration wall, across ALL
        # replicas — a quarantined replica's dead time is the point.
        u = self._merged_utilization(self._meters())
        if u is not None and u["wall_s"] > 0:
            wall = u["wall_s"]
            reg.gauge("serve_utilization_busy").set(u["busy_s"] / wall)
            reg.gauge("serve_utilization_stalled").set(
                u["stalled_s"] / wall)
            reg.gauge("serve_utilization_brownout").set(
                u["brownout_s"] / wall)
            reg.gauge("serve_utilization_idle").set(u["idle_s"] / wall)
            reg.gauge("serve_utilization_quarantined").set(
                u["quarantined_s"] / wall)

    def _status(self) -> dict:
        """The fleet's /statusz provider: replica table + router state."""
        return {
            "workload": "serve-fleet",
            "n_replicas": len(self.replicas),
            "live": [r.name for r in self._live()],
            "pending": len(self._pending),
            "pending_bound": self._max_pending,
            "requests_shed": (
                sum(self._shed_by_reason.values())
                + sum(sum(r.engine._shed_by_reason.values())
                      for r in self.replicas)),
            "requests_rejected": (
                self._rejected
                + sum(r.engine._rejected for r in self.replicas)),
            "rounds": self._rounds,
            "migrations": self._migrations,
            "replica_kills": self._kills,
            "router": {"assignments": dict(self.router.assignments),
                       "affinity_hits": self.router.affinity_hits,
                       "failovers": self.router.failovers},
            "replicas": {
                r.name: {
                    "state": r.state,
                    "cell": r.cell,
                    "devices": list(r.device_ids),
                    "queue_depth": len(r.engine.sched.queue),
                    "active_requests": len(r.engine.sched.active()),
                    "page_occupancy": r.engine.cache.occupancy,
                    "assignments": self.router.assignments.get(r.name, 0),
                    "breaker": self.breaker.state(r.name),
                    "brownout_level": (r.engine.brownout.level
                                       if r.engine.brownout is not None
                                       else None),
                } for r in self.replicas},
            "cells": self._cell_status(),
            "utilization": self._merged_utilization(self._meters()),
            "healthy": bool(self._live()),
        }

    def _cell_status(self) -> dict | None:
        """Per-cell rollup for /statusz and the fleet summary: member
        liveness, reachability, aggregated breaker state, and (when the
        health sentinel is wired) the quarantined fraction of the
        cell's device slice."""
        if self.cells is None:
            return None
        out = {}
        for c in self.cells.cells:
            members = self._cell_members(c)
            devices = [d for r in members for d in r.device_ids]
            out[c] = {
                "members": [r.name for r in members],
                "live": [r.name for r in members if r.state == LIVE],
                "partitioned": c in self._partitioned,
                "breaker": self.breaker.group_state(
                    [r.name for r in members]),
                "assignments": sum(
                    self.router.assignments.get(r.name, 0)
                    for r in members),
                "utilization": self._merged_utilization(
                    self._meters(cell=c)),
                **({"device_quarantined_fraction": round(
                        self.health.quarantined_fraction(devices), 3)}
                   if self.health is not None else {}),
            }
        return out

    def results(self) -> list[Request]:
        return list(self._requests)

    def close(self) -> None:
        """Unregister the fleet's /statusz presence (the fleet provider
        plus every replica engine's). A discarded drill fleet must not
        keep feeding stale replica state — including ``healthy: false``
        from an all-quarantined end state — into /statusz and /healthz,
        or pin N engines' params in the exporter's provider table.
        Results stay readable; the fleet just leaves the exporter. The
        installed journal is uninstalled only if it is this fleet's."""
        if self._slo_metrics:
            statusz.unregister("serve-fleet")
            for rep in self.replicas:
                statusz.unregister(rep.engine._provider)
        if self.journal is not None:
            # Un-install only OUR journal: a crashed-and-recovered
            # successor fleet may have installed its own by now, and a
            # discarded fleet must not blind the flight recorder to it.
            if journal_mod.installed() is self.journal:
                journal_mod.install(None)

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, rid: str | None = None,
               arrival_s: float = 0.0, seed: int = 0,
               priority: str = "interactive",
               queue_budget_s: float | None = None,
               deadline_s: float | None = None,
               tenant: str | None = None) -> Request:
        """Queue a request at fleet level; the router assigns it to a
        replica when it arrives (open loop), so placement sees the load
        at arrival time, not submission time. A full fleet queue
        (``ServeConfig.max_queue`` × replicas) REJECTS with a typed
        record (reason ``queue-full``) — batch first: an interactive
        arrival displaces the newest queued batch request instead of
        being turned away itself. Callers check ``req.done``."""
        prompt = [int(t) for t in prompt]
        if rid is None:
            rid = f"req-{self._auto_rid}"
            self._auto_rid += 1
        if rid in self._ids:
            raise ValueError(f"duplicate request id {rid!r}")
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      arrival_s=float(arrival_s), seed=int(seed),
                      priority=priority, queue_budget_s=queue_budget_s,
                      deadline_s=deadline_s, tenant=tenant)
        # Geometry is fleet-uniform: any replica's cache speaks for all.
        ref = self.replicas[0].engine
        validate_request(req, ref.cache)
        bad = [t for t in prompt if not (0 <= t < ref.cfg.vocab_size)]
        if bad:
            raise ValueError(f"prompt tokens {bad} outside vocab "
                             f"[0, {ref.cfg.vocab_size})")
        self._ids.add(rid)
        self._requests.append(req)
        # Stamp the request trace at fleet admission — the identity that
        # survives routing, migration between replicas, and brownout
        # clamps (utils/tracing.py). Fleet-level rtrace
        # records carry no ``replica`` field: their origin IS the fleet.
        if self.telemetry is not None:
            req.trace_id = tracing.new_trace_id()
            tracing.rtrace(req, "submitted", sink=self.telemetry,
                           prompt_tokens=req.prompt_len,
                           max_new_tokens=req.max_new_tokens,
                           priority=req.priority)
        # Write-ahead intent (serve/journal.py): durable BEFORE any
        # engine touches the request, so an accepted request survives
        # any later crash. Every terminal path journals its matching
        # single terminal — including the queue-full shed just below.
        if self.journal is not None:
            self.journal.intent(req)
        # The bound rejects ALREADY-ARRIVED submissions against the live
        # arrived backlog (the runaway-client case); future-dated
        # open-loop trace entries enqueue and the per-round trim
        # (``_bound_pending``) sheds overflow once they arrive.
        if (self._max_pending is not None
                and req.arrival_s <= self._now
                and sum(1 for r in self._pending
                        if r.arrival_s <= self._now) >= self._max_pending):
            if req.priority == "batch":
                self._shed_request(req, "queue-full")
                return req
            victim = next((r for r in reversed(self._pending)
                           if r.priority == "batch"
                           and r.arrival_s <= self._now), None)
            if victim is None:
                self._shed_request(req, "queue-full")
                return req
            # Batch sheds first: the newest queued batch request gives
            # its place to the interactive arrival.
            self._pending.remove(victim)
            self._shed_request(victim, "queue-full")
        self._pending.append(req)
        return req

    def _bound_pending(self, now: float) -> None:
        """Per-round queue bound: shed arrived fleet-queue overflow
        beyond ``max_queue`` × replicas with typed ``queue-full``
        records — batch first, newest-arrival first within a class, so
        the oldest interactive waiters keep their place and the live
        backlog stays bounded no matter the offered load."""
        if self._max_pending is None:
            return
        arrived = [r for r in self._pending if r.arrival_s <= now]
        victims = overflow_victims(arrived, self._max_pending)
        if not victims:
            return
        gone = {id(r) for r in victims}
        self._pending = deque(r for r in self._pending
                              if id(r) not in gone)
        for req in victims:
            self._shed_request(req, "queue-full",
                               waited_s=max(0.0, now - req.arrival_s))

    def _shed_request(self, req: Request, reason: str, *,
                      waited_s: float | None = None) -> None:
        """Typed fleet-level shed: queue-full rejection/displacement or
        a fleet-queue deadline expiry — terminal, counted, recorded."""
        req.state = RequestState.FAILED
        req.shed_reason = reason
        req.error = f"shed: {reason}"
        if self.journal is not None:
            self.journal.terminal(req.rid, "shed")
        tracing.rtrace(req,
                       "expired" if reason in ("total-deadline",
                                               "queue-deadline")
                       else "shed",
                       sink=self.telemetry, reason=reason, state="queued",
                       **({"waited_s": round(waited_s, 4)}
                          if waited_s is not None else {}))
        self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + 1
        # Exactly one terminal meter record per terminal trace: a
        # queue-only request never reached an engine meter, so the
        # fleet bills its zero-cost terminal here (utils/metering.py)
        # and counts the shed against its tenant for the SLO rollup.
        if self._meter:
            emit_meter(self.telemetry, req,
                       "expired" if reason in ("total-deadline",
                                               "queue-deadline")
                       else "shed", replica="fleet")
        t = req.tenant or "-"
        self._tenant_sheds[t] = self._tenant_sheds.get(t, 0) + 1
        if reason == "queue-full":
            self._rejected += 1
        if self._slo_metrics:
            reg = registry()
            reg.counter("serve_shed_total").inc()
            if reason == "queue-full":
                reg.counter("serve_rejected_total").inc()
        if self.telemetry is not None:
            self.telemetry.record(
                "shed", request=req.rid, reason=reason,
                priority=req.priority, state="queued", policy="fleet",
                prompt_tokens=req.prompt_len,
                new_tokens=len(req.generated),
                **({"waited_s": round(waited_s, 4)}
                   if waited_s is not None else {}))

    def warmup(self) -> None:
        """Run every step once on each device that holds a replica, so the
        kernels' builds and first launches happen before a timed run."""
        seen = set()
        for rep in self.replicas:
            if rep.engine.device not in seen:
                seen.add(rep.engine.device)
                rep.engine.warmup()

    # -- the control loop ----------------------------------------------------

    def run(self, *, max_rounds: int | None = None,
            record_summary: bool = True) -> dict:
        """Drive the fleet until every submitted request is terminal (or
        ``max_rounds``). Same contract as ``Engine.run``: a death marks
        every live request failed (typed) before :class:`EngineKilled`
        propagates."""
        t0 = self._clock()
        try:
            with tracing.sink_scope(self.telemetry):
                while not self._idle():
                    if max_rounds is not None and self._rounds >= max_rounds:
                        break
                    now = self._clock() - t0
                    self._now = now
                    if self.step_hook is not None:
                        self.step_hook(self._rounds)
                    self._rounds += 1
                    self._poll_cell_faults()
                    self._expire_pending(now)
                    progress = self._dispatch(now)
                    # Queue-bound trim AFTER dispatch (work-conserving:
                    # requests the replicas just absorbed must not count
                    # against the bound).
                    self._bound_pending(now)
                    q0 = time.monotonic()
                    for rep in self.replicas:
                        if rep.state != LIVE:
                            continue
                        if (self._slow_period is not None
                                and rep.cell == self._fault_cell
                                and self._rounds % self._slow_period):
                            # slow_cell: the victim cell's replicas run
                            # an engine iteration only every period-th
                            # round — lockstep cell-wide slowdown, no
                            # wall-clock sleep (virtual replays stay
                            # exact). Residents decode slower; SLOs sag.
                            continue
                        w0 = time.monotonic()
                        if (self.injector is not None
                                and rep.name == self._fault_replica):
                            # slow_replica sleeps HERE, inside the timed
                            # window, so the health sentinel's serve
                            # signal observes it like a real throttle;
                            # crash_replica fires the hard-crash path on
                            # the same victim.
                            for spec in self.injector.poll("serve"):
                                if spec.kind == "crash_replica":
                                    self.crash_replica(rep.name)
                            if rep.state != LIVE:
                                continue     # crashed this round
                        stepped = rep.engine.step_once(now, t0)
                        if stepped:
                            # Only WORKING rounds feed the sentinel: an
                            # idle round's microsecond wall time would
                            # seed the warmup-min baseline so low that
                            # the first busy round reads as an outlier
                            # and a healthy replica gets quarantined.
                            self._observe(rep, time.monotonic() - w0)
                        progress = progress or stepped
                    # Quarantined duty: while its peers stepped, a
                    # quarantined replica's chips sat out the whole
                    # round — that wall lands in its ledger's
                    # ``quarantined`` bucket, same real-monotonic
                    # clock as the live replicas' iteration samples
                    # (utils/metering.py).
                    qdt = time.monotonic() - q0
                    for rep in self.replicas:
                        if (rep.state == QUARANTINED
                                and rep.engine.meter is not None):
                            rep.engine.meter.add_quarantined(qdt)
                    self._set_engine_gauges()
                    self._apply_health()
                    self._maybe_revive()
                    if (self._pending and not self._live()
                            and self.revive_after is None
                            and self.health is None):
                        # No live peer and no revive path (no sentinel,
                        # no drill timer): queued requests can never
                        # dispatch — fail them typed instead of spinning
                        # forever, like _migrate's no-live-peer branch.
                        self._fail_pending(
                            "all replicas quarantined with no revive "
                            "path")
                        continue
                    if self._virtual:
                        # One round = one dt of virtual time; an idle
                        # fleet skips straight to the next arrival.
                        self._clock.tick()
                        if not progress:
                            nxt = min((r.arrival_s for r in self._pending),
                                      default=None)
                            if nxt is not None:
                                self._clock.advance_to(t0 + nxt)
                    elif not progress:
                        nxt = min((r.arrival_s for r in self._pending),
                                  default=None)
                        if nxt is not None:
                            time.sleep(max(0.0, min(nxt - now, 0.05)))
        except BaseException as e:
            self._fail_fleet(f"{type(e).__name__}: {e}")
            self._wall_s += self._clock() - t0
            if self.telemetry is not None:
                self.telemetry.failure(
                    "fleet-killed", detail=f"{type(e).__name__}: {e}",
                    round=self._rounds)
            flightrec.dump("fleet-killed", telemetry_run=self.telemetry,
                           error=e)
            if not isinstance(e, Exception):
                raise
            raise EngineKilled(
                f"fleet died at round {self._rounds}; in-flight requests "
                f"marked failed") from e
        self._wall_s += self._clock() - t0
        return self.summary(record=record_summary)

    def _idle(self) -> bool:
        return not self._pending and all(r.engine.sched.idle()
                                         for r in self.replicas)

    def _expire_pending(self, now: float) -> None:
        """Shed arrived fleet-queue requests past their queue budget or
        total deadline — under sustained overload most shedding happens
        HERE, before any replica spends a page on the request."""
        expired = [
            (r, reason) for r in self._pending if r.arrival_s <= now
            and (reason := expiry_reason(
                r, now, queue_budget_s=self.serve.queue_budget_s,
                deadline_s=self.serve.deadline_s)) is not None]
        if not expired:
            return
        gone = {id(r) for r, _ in expired}
        self._pending = deque(r for r in self._pending
                              if id(r) not in gone)
        for req, reason in expired:
            self._shed_request(req, reason,
                               waited_s=max(0.0, now - req.arrival_s))

    def _next_pending(self, now: float) -> Request | None:
        """Next arrived fleet-queue request — the engine scheduler's
        two-class order, one shared definition
        (:func:`~serve.scheduler.next_arrived_by_class`)."""
        return next_arrived_by_class(self._pending, now)

    def _try_admit(self, rep: Replica, req: Request) -> bool:
        """One admission attempt: the injected ``admission_fail`` chaos
        (victim replica only) or a full bounded submission queue refuses
        it — the refusal feeds the circuit breaker."""
        if (self.injector is not None and rep.name == self._fault_replica):
            self.injector.poll("admit")
            if self.injector.admission_blocked():
                return False
        return rep.engine.try_enqueue(req)

    def _emit_breaker_records(self) -> None:
        for tr in self.breaker.drain_transitions():
            if self.telemetry is not None:
                self.telemetry.record("breaker", **tr)

    def _dispatch(self, now: float) -> bool:
        """Route every arrived fleet-queue request to a live replica
        whose circuit breaker admits traffic. A refused admission
        (bounded queue, chaos) feeds the breaker and leaves the request
        on the fleet queue for the next round — bounded-queue
        backpressure, never a drop."""
        progress = False
        while True:
            req = self._next_pending(now)
            if req is None:
                break
            live = self._live()
            if not live:
                break                 # all quarantined: wait for grow-back
            candidates = [r for r in live
                          if r.cell not in self._partitioned
                          and self.breaker.allows(r.name, self._rounds)]
            self._emit_breaker_records()   # half-open transitions
            if not candidates:
                break    # every breaker open / cell unreachable: wait
            placed = None
            while candidates:
                rep, reason, loads = self.router.pick(
                    req.prompt, candidates, commit=False)
                ok = self._try_admit(rep, req)
                self.breaker.note(rep.name, ok, self._rounds)
                self._emit_breaker_records()
                if ok:
                    placed = (rep, reason, loads)
                    break
                candidates = [r for r in candidates if r is not rep]
            if placed is None:
                break                 # nobody would take it: next round
            rep, reason, loads = placed
            self.router.commit(
                rep.name, reason, request=req, sink=self.telemetry,
                loads={k: round(v, 3) for k, v in sorted(loads.items())})
            self._pending.remove(req)
            if self._slo_metrics:
                registry().counter("serve_router_assignments").inc()
            if self.telemetry is not None:
                self.telemetry.record(
                    "router", request=req.rid, replica=rep.name,
                    reason=reason, round=self._rounds,
                    loads={k: round(v, 3) for k, v in sorted(loads.items())})
            progress = True
        return progress

    def _poll_cell_faults(self) -> None:
        """Once-per-round poll of the ``cell`` fault site (utils/faults):
        ``kill_cell`` fires the REAL quarantine→drain→migrate path for
        every member of the victim cell at once; ``partition`` flips the
        router's reachability for the victim cell (typed ``cell``
        records on both edges, with the drain-on-heal accounting of the
        residents caught inside); ``slow_cell`` sets the step-skip
        period the round loop honors. No sleeps, no randomness — the
        scenario replays bit-for-bit."""
        if self.injector is None or self._fault_cell is None:
            return
        for spec in self.injector.poll("cell"):
            if spec.kind == "kill_cell":
                self.kill_cell(self._fault_cell)
        self._slow_period = self.injector.cell_slow_period()
        active = self.injector.partition_active()
        if active and self._fault_cell not in self._partitioned:
            self._partitioned.add(self._fault_cell)
            # Residents caught inside the partition: they keep decoding
            # (the cell is unreachable, not dead) and the heal record
            # reports how many drained out in the meantime.
            self._partition_caught = [
                req for rep in self._cell_members(self._fault_cell)
                if rep.state == LIVE
                for req in rep.engine.sched.active()]
            if self.telemetry is not None:
                self.telemetry.record(
                    "cell", event="partition", cell=self._fault_cell,
                    round=self._rounds,
                    residents=len(self._partition_caught))
            self._set_live_gauge()
        elif not active and self._fault_cell in self._partitioned:
            self._partitioned.discard(self._fault_cell)
            drained = sum(1 for r in self._partition_caught if r.done)
            if self.telemetry is not None:
                self.telemetry.record(
                    "cell", event="heal", cell=self._fault_cell,
                    round=self._rounds,
                    residents=len(self._partition_caught),
                    drained=drained)
            self._partition_caught = []
            self._set_live_gauge()

    def _observe(self, rep: Replica, seconds: float) -> None:
        """Feed the replica's round wall time to the health sentinel as
        a ``serve`` signal on its device slice (the fleet's own monitor,
        else whatever the orchestrator installed process-wide)."""
        if self.health is not None:
            self.health.observe("serve", rep.device_ids, seconds)
        else:
            health_mod.observe_serve(rep.device_ids, seconds)

    # -- self-healing --------------------------------------------------------

    def _apply_health(self) -> None:
        """Consume the sentinel's transitions: quarantine events drain
        the hit replicas to their peers; reinstate events grow them
        back (typed ``health`` records on the fleet's stream, like the
        orchestrator's control loop)."""
        if self.health is None:
            return
        events = self.health.tick()
        quarantined: list[int] = []
        reinstated: list[int] = []
        for ev in events:
            if self.telemetry is not None:
                self.telemetry.record("health", round=self._rounds, **ev)
            if ev["event"] == "quarantine":
                quarantined += ev["devices"]
            elif ev["event"] == "reinstate":
                reinstated += ev["devices"]
        if quarantined:
            bad = set(quarantined)
            fresh = []
            for rep in self.replicas:
                if rep.state == LIVE and bad & set(rep.device_ids):
                    self._quarantine_replica(rep, reason="device-degraded")
                    fresh.append(rep)
            self._cell_sweep(fresh)
        if reinstated:
            back = set(reinstated)
            still_bad = set(self.health.quarantined_ids)
            for rep in self.replicas:
                if (rep.state == QUARANTINED
                        and back & set(rep.device_ids)
                        and not still_bad & set(rep.device_ids)):
                    self._revive(rep)

    def _maybe_revive(self) -> None:
        """Drill-mode grow-back: a killed replica revives after
        ``revive_after`` quarantined rounds. On a health-wired fleet
        this covers operator/drill kills the MONITOR never saw (no
        reinstate event will ever arrive for them) — but a replica
        whose devices the sentinel itself still quarantines stays down
        until probation heals them (the sentinel's verdict wins)."""
        if self.revive_after is None:
            return
        for rep in self.replicas:
            if (rep.state != QUARANTINED
                    or self._rounds - rep.quarantined_round
                    < self.revive_after):
                continue
            if (self.health is not None
                    and set(rep.device_ids)
                    & set(self.health.quarantined_ids)):
                continue
            self._revive(rep)

    def kill_replica(self, name: str, *, reason: str = "killed") -> int:
        """Chaos-drill entry point: quarantine + drain replica ``name``
        mid-stream (idempotent per cycle — killing an already
        quarantined replica raises). Returns requests migrated."""
        for rep in self.replicas:
            if rep.name == name:
                if rep.state != LIVE:
                    raise ValueError(f"replica {name!r} is {rep.state}")
                migrated = self._quarantine_replica(rep, reason=reason)
                self._cell_sweep([rep])
                return migrated
        raise KeyError(f"unknown replica {name!r}")

    def crash_replica(self, name: str, *,
                      reason: str = "injected-crash") -> int:
        """Hard-crash drill entry point (serve/journal.py): replica
        ``name``'s engine object, page pool and prefix tree are
        DISCARDED with no drain — nothing is exported, exactly what a
        process death leaves behind. A recovery pass then reconstructs
        every journaled non-terminal request the dead replica held from
        the write-ahead journal and re-admits it on a live peer at its
        disk watermark; the destination's replay prefill re-derives the
        committed prefix bitwise (the determinism contract) and asserts
        it against the journal. Returns requests re-admitted."""
        if self.journal is None:
            raise ValueError(
                "crash_replica needs a write-ahead journal (pass "
                "journal=RequestJournal(...)); without one a hard crash "
                "can only lose requests — kill_replica is the graceful "
                "drain path")
        rep = next((r for r in self.replicas if r.name == name), None)
        if rep is None:
            raise KeyError(f"unknown replica {name!r}")
        if rep.state != LIVE:
            raise ValueError(f"replica {name!r} is {rep.state}")
        t0 = time.monotonic()
        lost = [r for r in rep.engine._requests if not r.done]
        params, cfg = rep.engine.params, rep.engine.cfg
        rep.engine.kill(reason=reason)
        if rep.engine.meter is not None:
            # The dead engine's meter outlives it: closed per-tenant
            # rollups and duty history keep counting in the fleet
            # summary. Its OPEN bills die unbilled — the residents'
            # chip time since their last terminal/hop is lost, which is
            # the safe direction for the capacity gate (billed chip-
            # seconds can only under-shoot wall × live replicas).
            self._dead_meters.append(rep.engine.meter)
        # The crash: the old engine (scheduler, page pool, prefix tree)
        # is dropped on the floor — no drain, no clear_cache invariant
        # to satisfy, its pages die with it. A FRESH engine takes the
        # slot so the standard grow-back path revives the replica cold,
        # like a restarted process; its statusz provider re-registers
        # under the same name, replacing the dead engine's entry.
        rep.engine = Engine(params, cfg, self.serve,
                            device=rep.engine.device,
                            telemetry=self.telemetry,
                            slo_metrics=self._slo_metrics,
                            replica=rep.name, clock=self._engine_clock,
                            journal=self.journal, meter=self._meter)
        if rep.engine.meter is not None:
            rep.engine.meter.cell = rep.cell
        rep.state = QUARANTINED
        rep.quarantined_round = self._rounds
        rep.kills += 1
        rep.crashes += 1
        self._kills += 1
        self._crashes += 1
        self.kill_times[rep.name] = self._now
        self.pool.quarantine(rep.device_ids)
        self.pool.release(self._holder(rep))
        self._set_live_gauge()
        if self.telemetry is not None:
            self.telemetry.record(
                "event", message=f"fleet crash: replica {rep.name} "
                                 f"({reason}) devices {rep.device_ids} "
                                 f"hard-crashed, {len(lost)} requests to "
                                 f"recover from the journal")
        self._cell_sweep([rep])
        recovered = self._recover_lost(lost, rep)
        self.recovery_time_s += time.monotonic() - t0
        return recovered

    def _recover_lost(self, lost: list[Request], rep: Replica) -> int:
        """Journal-driven replay re-admission after a hard crash: every
        non-terminal request the dead replica held is reset to its DISK
        watermark (buffered watermarks died with the process) and
        re-admitted on a live peer, exactly-once by terminal dedup."""
        st = self.journal.state()
        recovered = 0
        for req in lost:
            if self.journal.is_terminal(req.rid):
                continue
            toks = st.tokens.get(req.rid, [])
            self.journal.discard_pending(req.rid)
            # Reset to the journaled state: committed prefix from the
            # disk watermark, every runtime-local field (slot, cursors,
            # resume payload) cleared — the peer admits it cold and the
            # replay prefill rebuilds the KV from token values.
            req.generated = list(toks)
            req.state = RequestState.QUEUED
            req.slot = None
            req.prefill_cursor = 0
            req.cached_prompt_tokens = 0
            req.resume = None
            req.mem_stalled = False
            req.replay = bool(toks)
            tracing.rtrace(req, "recovered", sink=self.telemetry,
                           from_replica=rep.name, committed=len(toks))
            live = [r for r in self._live()
                    if r.cell not in self._partitioned]
            if not live:
                # Same contract as _migrate's dead end: typed failure,
                # never a silent drop — and a journaled terminal, so a
                # later fleet restart does not resurrect it.
                req.state = RequestState.FAILED
                req.error = (f"fleet-killed: replica {rep.name} crashed "
                             f"with no reachable live peer")
                self.journal.terminal(req.rid, "failed")
                tracing.rtrace(req, "failed", sink=self.telemetry,
                               error="no-live-replica")
                if self._meter:
                    emit_meter(self.telemetry, req, "failed",
                               replica="fleet")
                if self._slo_metrics:
                    registry().counter("serve_requests_failed").inc()
                if self.telemetry is not None:
                    self.telemetry.record(
                        "serve", event="failed", request=req.rid,
                        policy="fleet", error="no-live-replica",
                        detail=req.error, prompt_tokens=req.prompt_len,
                        new_tokens=len(req.generated))
                continue
            candidates = [r for r in live
                          if self.breaker.allows(r.name, self._rounds)
                          ] or live
            self._emit_breaker_records()
            target, reason, loads = self.router.pick(
                req.prompt, candidates, migrate=True, request=req,
                sink=self.telemetry)
            target.engine.enqueue(req, force=True)
            recovered += 1
            self._crash_recovered += 1
            if self._slo_metrics:
                registry().counter("serve_router_assignments").inc()
            if self.telemetry is not None:
                self.telemetry.record(
                    "router", request=req.rid, replica=target.name,
                    reason=reason, round=self._rounds,
                    loads={k: round(v, 3)
                           for k, v in sorted(loads.items())})
                # The recovery ledger entry pairing the kill's failure
                # record — a report folds these like migrations.
                self.telemetry.record(
                    "recovery", action="replay-readmit", request=req.rid,
                    from_replica=rep.name, to_replica=target.name,
                    committed=len(toks), round=self._rounds)
        return recovered

    def kill_cell(self, cell: str, *, reason: str = "cell-killed") -> int:
        """Correlated-failure entry point: quarantine + drain EVERY live
        member of ``cell`` at once (a rack power event, a cell-wide
        rollout gone bad). Every member is drained BEFORE anyone is
        re-placed, so no request ever migrates onto a sibling that is
        about to die in the same event — placements go cross-cell by
        construction. Returns requests migrated."""
        if self.cells is None:
            raise ValueError("kill_cell needs a cell topology "
                             "(pass cells=)")
        if cell not in self.cells:
            raise KeyError(f"unknown cell {cell!r}; known: "
                           f"{list(self.cells.cells)}")
        victims = [r for r in self._cell_members(cell) if r.state == LIVE]
        if not victims:
            raise ValueError(f"cell {cell!r} has no live replica to kill")
        drained: list[tuple[Request, Replica]] = []
        for rep in victims:
            for req in self._drain_out(rep, reason=reason):
                drained.append((req, rep))
        self._cells_down.add(cell)
        self._cell_kills += 1
        if self.telemetry is not None:
            self.telemetry.record(
                "cell", event="kill", cell=cell, round=self._rounds,
                replicas=[r.name for r in victims], reason=reason,
                requests_draining=len(drained))
        migrated = 0
        for req, rep in drained:
            migrated += self._migrate(req, rep)
        return migrated

    def _cell_sweep(self, fresh: list[Replica]) -> None:
        """Cell-sick aggregation: when MORE than ``cell_sick_threshold``
        of a cell's members are quarantined, the stragglers are presumed
        to share the correlated cause (rack power, bad rollout wave) and
        are quarantined too — the cell fails as a unit, exactly as it
        grows back as one. Only FRESH quarantines trigger the sweep, so
        a cell growing back member-by-member is never re-condemned for
        still being mostly down."""
        if self.cells is None:
            return
        for cell in sorted({r.cell for r in fresh if r.cell is not None}):
            members = self._cell_members(cell)
            down = sum(1 for r in members if r.state == QUARANTINED)
            if down / len(members) <= self.cell_sick_threshold:
                continue
            rest = [r for r in members if r.state == LIVE]
            if not rest:
                continue
            if self.telemetry is not None:
                self.telemetry.record(
                    "cell", event="sick", cell=cell, round=self._rounds,
                    quarantined=down, members=len(members),
                    swept=[r.name for r in rest])
            self._cells_down.add(cell)
            for rep in rest:
                if rep.state == LIVE:
                    self._quarantine_replica(rep, reason="cell-sick")

    def _quarantine_replica(self, rep: Replica, *, reason: str) -> int:
        migrated = 0
        for req in self._drain_out(rep, reason=reason):
            migrated += self._migrate(req, rep)
        return migrated

    def _drain_out(self, rep: Replica, *, reason: str) -> list[Request]:
        """Take ``rep`` out of service and return its drained requests
        (committed tokens + KV pages serialized by value) WITHOUT
        re-placing them — ``kill_cell`` drains a whole cell before any
        migration, single-replica paths migrate immediately."""
        drained = rep.engine.drain()
        rep.engine.clear_cache()     # raises if any page is still held
        rep.state = QUARANTINED
        rep.quarantined_round = self._rounds
        rep.kills += 1
        self._kills += 1
        self.kill_times[rep.name] = self._now
        self.pool.quarantine(rep.device_ids)
        self.pool.release(self._holder(rep))
        self._set_live_gauge()
        if self.telemetry is not None:
            self.telemetry.record(
                "event", message=f"fleet quarantine: replica {rep.name} "
                                 f"({reason}) devices {rep.device_ids} out "
                                 f"of service, {len(drained)} requests "
                                 f"draining")
        return drained

    def _migrate(self, req: Request, source: Replica) -> int:
        # A partitioned cell's replicas are unreachable for placements
        # too: the router cannot hand existing load to a cell it cannot
        # talk to (its residents keep decoding — they just get no new
        # neighbors until the heal).
        live = [r for r in self._live()
                if r.cell not in self._partitioned]
        if not live:
            # Nowhere to drain to: the request fails typed, exactly like
            # an engine kill — never silently dropped.
            req.state = RequestState.FAILED
            req.error = (f"fleet-killed: replica {source.name} quarantined "
                         f"with no reachable live peer")
            req.resume = None
            if self.journal is not None:
                self.journal.terminal(req.rid, "failed")
            tracing.rtrace(req, "failed", sink=self.telemetry,
                           error="no-live-replica")
            # The source engine's drain already closed its hop bill;
            # this terminal is the zero-cost fleet-side record that
            # pairs the rtrace terminal (utils/metering.py).
            if self._meter:
                emit_meter(self.telemetry, req, "failed",
                           replica="fleet")
            if self._slo_metrics:
                registry().counter("serve_requests_failed").inc()
            if self.telemetry is not None:
                self.telemetry.record(
                    "serve", event="failed", request=req.rid,
                    policy="fleet", error="no-live-replica",
                    detail=req.error, prompt_tokens=req.prompt_len,
                    new_tokens=len(req.generated))
            return 0
        # Prefer breaker-admitting peers, but never fail a migration
        # over an open breaker — a migrated request is existing load
        # being rescued, and the bounded queue is bypassed for the same
        # reason (enqueue force=True).
        candidates = [r for r in live
                      if self.breaker.allows(r.name, self._rounds)] or live
        self._emit_breaker_records()
        target, reason, loads = self.router.pick(req.prompt, candidates,
                                                 migrate=True, request=req,
                                                 sink=self.telemetry)
        pages = int(req.resume["k"].shape[1]) if req.resume else 0
        target.engine.enqueue(req, force=True)
        self._migrations += 1
        if self._slo_metrics:
            registry().counter("serve_router_assignments").inc()
            registry().counter("serve_migrations").inc()
        if self.telemetry is not None:
            # A drain placement is an assignment like any other: the
            # typed router record (reason=migrate, or `only` with one
            # peer) keeps the report's folded counts, the counter and
            # Router.assignments in agreement.
            self.telemetry.record(
                "router", request=req.rid, replica=target.name,
                reason=reason, round=self._rounds,
                loads={k: round(v, 3) for k, v in sorted(loads.items())})
            self.telemetry.record(
                "migration", request=req.rid, from_replica=source.name,
                to_replica=target.name, round=self._rounds,
                state=(req.resume["state"] if req.resume else "queued"),
                tokens_committed=len(req.generated), pages=pages,
                loads={k: round(v, 3) for k, v in sorted(loads.items())})
        return 1

    def _revive(self, rep: Replica) -> None:
        """Grow the replica back: reinstate + re-claim its exact device
        slice, then let the router resume sending it traffic (its cache
        is empty — the prefix tree refills from live traffic)."""
        self.pool.reinstate(rep.device_ids)
        self.pool.assign_ids(self._holder(rep), rep.device_ids)
        rep.state = LIVE
        rep.quarantined_round = None
        self.revive_times[rep.name] = self._now
        self._set_live_gauge()
        if self.telemetry is not None:
            self.telemetry.record(
                "event", message=f"fleet grow-back: replica {rep.name} "
                                 f"devices {rep.device_ids} back in "
                                 f"service")
        if (rep.cell is not None and rep.cell in self._cells_down
                and all(r.state == LIVE
                        for r in self._cell_members(rep.cell))):
            # The whole cell is back on its exact device slices: the
            # correlated failure's grow-back edge, as a unit.
            self._cells_down.discard(rep.cell)
            if self.telemetry is not None:
                self.telemetry.record(
                    "cell", event="grow-back", cell=rep.cell,
                    round=self._rounds,
                    replicas=[r.name
                              for r in self._cell_members(rep.cell)])

    # -- full fleet restart (serve/journal.py) -------------------------------

    @classmethod
    def recover(cls, params: dict, cfg, serve: ServeConfig,
                n_replicas: int, *, journal, telemetry=None, clock=None,
                **kw) -> "ServeFleet":
        """Restart a crashed fleet from its write-ahead journal: build a
        fresh fleet (same geometry, fresh engines, empty caches), then
        re-queue every journaled ACCEPTED request without a terminal at
        its disk watermark — replay prefill re-derives each committed
        prefix bitwise, terminals journaled before the crash are never
        re-served (exactly-once by rid dedup). Requests bypass
        :meth:`submit`: they are rescued load, not new demand — no
        re-stamp (the journaled trace id survives the restart), no
        queue bound, and ``journal.intent`` dedups their rids anyway.
        Torn trailing journal lines (a crash mid-write) are skipped by
        the fold; recovery proceeds on the surviving prefix."""
        t0 = time.monotonic()
        fleet = cls(params, cfg, serve, n_replicas, telemetry=telemetry,
                    clock=clock, journal=journal, **kw)
        st = journal.state()
        for rid in st.pending():
            rec = st.intents[rid]
            toks = st.tokens.get(rid, [])
            journal.discard_pending(rid)   # stale if the object survived
            req = Request(
                rid=rid,
                prompt=[int(t) for t in rec.get("prompt", ())],
                max_new_tokens=int(rec.get("max_new_tokens", 1)),
                arrival_s=float(rec.get("arrival_s", 0.0)),
                seed=int(rec.get("seed", 0)),
                priority=rec.get("priority", "interactive"),
                queue_budget_s=rec.get("queue_budget_s"),
                deadline_s=rec.get("deadline_s"),
                tenant=rec.get("tenant"))
            req.trace_id = rec.get("trace")
            req.generated = list(toks)
            req.replay = bool(toks)
            fleet._ids.add(rid)
            fleet._requests.append(req)
            # seq restarts at 1 in the new process: the joiner treats
            # the seq drop as an epoch boundary and links the restart
            # hop through this ``recovered`` event.
            tracing.rtrace(req, "recovered", sink=fleet.telemetry,
                           committed=len(toks), restart=True)
            fleet._pending.append(req)
        fleet._crash_recovered += len(fleet._pending)
        fleet.recovery_time_s += time.monotonic() - t0
        return fleet

    def _fail_fleet(self, detail: str) -> None:
        for rep in self.replicas:
            rep.engine._fail_inflight(detail)
        self._fail_pending(detail)

    def _fail_pending(self, detail: str) -> None:
        while self._pending:
            req = self._pending.popleft()
            req.state = RequestState.FAILED
            req.error = f"fleet-killed: {detail}"
            if self.journal is not None:
                self.journal.terminal(req.rid, "failed")
            tracing.rtrace(req, "failed", sink=self.telemetry,
                           error="fleet-killed")
            if self._meter:
                emit_meter(self.telemetry, req, "failed",
                           replica="fleet")
            t = req.tenant or "-"
            self._tenant_sheds[t] = self._tenant_sheds.get(t, 0) + 1
            if self._slo_metrics:
                registry().counter("serve_requests_failed").inc()
            if self.telemetry is not None:
                self.telemetry.record(
                    "serve", event="failed", request=req.rid,
                    policy="fleet", error="fleet-killed", detail=detail,
                    prompt_tokens=req.prompt_len,
                    new_tokens=len(req.generated))

    # -- results -------------------------------------------------------------

    def summary(self, *, record: bool = True) -> dict:
        """Fleet-level SLO + throughput rollup (one typed ``serve``
        summary record with ``policy="fleet"`` when recording)."""
        completed = [r for r in self._requests
                     if r.state is RequestState.COMPLETED]
        shed = [r for r in self._requests
                if r.state is RequestState.FAILED and r.shed_reason]
        failed = [r for r in self._requests
                  if r.state is RequestState.FAILED and not r.shed_reason]
        # Fleet-wide shed-by-reason and rejected counts: the fleet's
        # own (queue-full, fleet-queue expiry) plus every replica
        # engine's (post-dispatch expiries and aborts land there) — the
        # two must stay in one scope, or the report's "shed (rejected)"
        # line stops reconciling.
        shed_by_reason: dict[str, int] = dict(self._shed_by_reason)
        rejected = self._rejected
        for rep in self.replicas:
            rejected += rep.engine._rejected
            for reason, n in rep.engine._shed_by_reason.items():
                shed_by_reason[reason] = shed_by_reason.get(reason, 0) + n
        tokens = sum(len(r.generated) for r in completed)
        goodput_tokens = sum(
            len(r.generated) for r in completed
            if self.replicas[0].engine._in_deadline(r))
        ttft = [max(0.0, r.t_first_token - r.arrival_s) for r in completed
                if r.t_first_token is not None]
        waits = [max(0.0, r.t_admitted - r.arrival_s) for r in completed
                 if r.t_admitted is not None]
        token_lat = [
            (r.t_done - r.t_first_token) / (len(r.generated) - 1)
            for r in completed
            if len(r.generated) > 1 and r.t_first_token is not None]
        out = {
            "policy": "fleet",
            "n_replicas": len(self.replicas),
            "n_slots": self.serve.n_slots,
            "live_replicas": len(self._live()),
            "replicas": {r.name: {"state": r.state,
                                  "devices": list(r.device_ids),
                                  "kills": r.kills,
                                  "crashes": r.crashes}
                         for r in self.replicas},
            "requests_completed": len(completed),
            "requests_failed": len(failed),
            "requests_shed": len(shed),
            "requests_rejected": rejected,
            "shed_by_reason": dict(sorted(shed_by_reason.items())),
            "goodput_tokens": goodput_tokens,
            "goodput_tokens_per_s": (goodput_tokens / self._wall_s
                                     if self._wall_s > 0 else None),
            "breaker": {"opens": self.breaker.opens,
                        "states": self.breaker.snapshot()},
            "brownout_level_max": (
                max((r.engine.brownout.max_level_seen
                     for r in self.replicas
                     if r.engine.brownout is not None), default=None)
                if self.serve.brownout else None),
            "requests_migrated": sum(1 for r in self._requests
                                     if r.migrations > 0),
            "migrations": self._migrations,
            "replica_kills": self._kills,
            "replica_crashes": self._crashes,
            "crash_recovered": self._crash_recovered,
            "recovery_time_s": round(self.recovery_time_s, 6),
            "journal": (self.journal.summary()
                        if self.journal is not None else None),
            "tokens_generated": tokens,
            "wall_s": self._wall_s,
            "tokens_per_s": (tokens / self._wall_s if self._wall_s > 0
                             else None),
            "rounds": self._rounds,
            "router": {"assignments": dict(self.router.assignments),
                       "affinity_hits": self.router.affinity_hits,
                       "failovers": self.router.failovers},
            "cells": ({"layout": self.cells.as_dict(),
                       "live": self._live_cells(),
                       "cell_kills": self._cell_kills,
                       "partitioned": sorted(self._partitioned)}
                      if self.cells is not None else None),
            "ttft_s": summarize(ttft),
            "queue_wait_s": summarize(waits),
            "token_latency_s": summarize(token_lat),
            "metering": self._metering_summary() if self._meter else None,
        }
        if record and self.telemetry is not None:
            # Per-replica utilization records BEFORE the summary: the
            # capacity observatory (serve/capacity.py) reads both, and
            # crashed predecessors' duty history rides the same stream
            # under the replica name it served as.
            for m in self._meters():
                m.record_utilization(self.telemetry)
            self.telemetry.record("serve", event="summary", **out)
        return out

    def _metering_summary(self) -> dict | None:
        """Fleet metering rollup (utils/metering.py): the per-tenant
        cost + SLO-attainment table (every replica meter's closed bills
        plus the fleet's queue-only sheds), per-replica duty-cycle
        ledgers (a crashed predecessor's ledger folds into its replica
        name), per-cell and fleet-wide utilization, and the metering
        plane's own bookkeeping overhead (serve/capacity.py reads
        the same records)."""
        meters = self._meters()
        if not meters:
            return None

        def _blank() -> dict:
            return {"requests": 0, "chip_s": 0.0, "page_s": 0.0,
                    "resident_s": 0.0, "tokens": 0, "good_tokens": 0,
                    "sheds": 0}

        by_tenant: dict[str, dict] = {}
        for m in meters:
            for tenant, row in m.by_tenant.items():
                agg = by_tenant.setdefault(tenant, _blank())
                for k, v in row.items():
                    agg[k] = agg.get(k, 0) + v
        for tenant, n in self._tenant_sheds.items():
            # Queue-only losses: no engine ever metered them, but the
            # tenant offered the demand — they count as requests and
            # sheds with zero chip time.
            agg = by_tenant.setdefault(tenant, _blank())
            agg["requests"] += n
            agg["sheds"] += n
        for agg in by_tenant.values():
            for k in ("chip_s", "page_s", "resident_s"):
                agg[k] = round(agg[k], 6)
            agg["goodput_fraction"] = (
                round(agg["good_tokens"] / agg["tokens"], 4)
                if agg["tokens"] else None)
        util: dict[str, dict] = {}
        for m in meters:
            name = m.replica or "-"
            u = m.utilization()
            if name in util:      # a crashed predecessor's ledger
                prev = util[name]
                for k, v in u.items():
                    prev[k] = prev.get(k, 0) + v
            else:
                util[name] = u
        return {
            "by_tenant": dict(sorted(by_tenant.items())),
            "utilization": util,
            "fleet_utilization": self._merged_utilization(meters),
            "cell_utilization": (
                {c: self._merged_utilization(self._meters(cell=c))
                 for c in self.cells.cells}
                if self.cells is not None else None),
            "chip_s": round(sum(m.chip_s_total() for m in meters), 6),
            "meter_write_s": round(sum(m.write_s for m in meters), 6),
        }
