"""Iteration-level (continuous) batching scheduler.

Counterpart of ``distributed_model_parallel_tpu/serve/scheduler.py``
(host-side bookkeeping, no framework code). The decode batch is a fixed
set of slots, and scheduling happens per engine iteration: a finishing
sequence's slot and pages go to a waiting request mid-batch, and long
prompts prefill in chunks interleaved with decode steps.

Admission takes the two priority classes in order (an arrived
``interactive`` request jumps queued ``batch`` ones; FIFO within a
class) with head-of-line blocking, gated on the page pool: a request is
admitted only when a slot is free and the pool holds pages for its whole
worst case (``prompt + max_new_tokens``). With a prefix cache the bill
is counted after sharing: a cached prefix's pages are retained, not
allocated, and tree-only pages count as reclaimable, so a cold request
on a warm pool queues exactly when its reservation exceeds free plus
evictable pages. Reservation is allocation, so decode never runs out of
pages mid-flight. A migrated request (``resume`` payload) admits through
``PagedKVCache.import_request``; a journal replay admits over prompt +
committed tokens.

Overload: queued requests past their queue budget or total deadline
expire with a typed reason (:meth:`Scheduler.expire`), and the arrived
backlog beyond ``max_queue`` is trimmed batch-first, newest-first
(:meth:`Scheduler.overflow`). ``policy="static"`` refills only once the
whole batch has drained — the baseline continuous batching is compared
against. The serving fleet's dispatch, which shares
:func:`next_arrived_by_class` and :func:`overflow_victims`, comes with
the fleet.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Any

from distributed_model_parallel_tpu_torch.utils import tracing


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    COMPLETED = "completed"
    FAILED = "failed"


# Admission classes, in shed order: under overload ``batch`` requests
# wait behind (and are displaced by) ``interactive`` ones, so best-effort
# work sheds first.
PRIORITIES = ("interactive", "batch")


def next_arrived_by_class(requests, now: float) -> "Request | None":
    """The next candidate among ``requests`` under the two-class order:
    an arrived interactive request jumps queued batch ones (batch
    waits, and therefore sheds, first), FIFO within a class. Shared by
    the engine scheduler's admission and a fleet's dispatch — one
    definition of the priority order."""
    batch_head = None
    for r in requests:
        if r.arrival_s > now:
            continue
        if r.priority != "batch":
            return r
        if batch_head is None:
            batch_head = r
    return batch_head


def overflow_victims(arrived: list["Request"],
                     bound: int) -> list["Request"]:
    """The requests to shed when ``arrived`` exceeds ``bound``, in shed
    order — batch first, newest first within a class, so the oldest
    interactive waiters keep their place. Shared by the engine
    scheduler's per-iteration trim and a fleet's per-round trim."""
    excess = len(arrived) - bound
    if excess <= 0:
        return []
    batch = [r for r in arrived if r.priority == "batch"]
    rest = [r for r in arrived if r.priority != "batch"]
    return (list(reversed(batch)) + list(reversed(rest)))[:excess]


def expiry_reason(req: "Request", now: float, *,
                  queue_budget_s: float | None = None,
                  deadline_s: float | None = None) -> str | None:
    """Typed shed reason for an arrived, still-queued request at clock
    ``now`` — ``total-deadline`` (the whole request can no longer matter)
    beats ``queue-deadline`` (it waited past its queue budget); ``None``
    while the request is still worth admitting. The per-request fields
    override the engine defaults passed in."""
    age = now - req.arrival_s
    dl = req.deadline_s if req.deadline_s is not None else deadline_s
    if dl is not None and age > dl:
        return "total-deadline"
    qb = (req.queue_budget_s if req.queue_budget_s is not None
          else queue_budget_s)
    if qb is not None and age > qb:
        return "queue-deadline"
    return None


@dataclasses.dataclass(eq=False)   # identity semantics: requests are live
class Request:                     # objects in slots/queues, not values
    """One generation request plus its lifecycle bookkeeping.

    ``arrival_s`` is seconds relative to the engine run's start (the
    open-loop load generator's clock); ``seed`` drives the per-request
    sampling stream (folded per position, so a request's tokens do not
    depend on who shares the batch).
    """

    rid: str
    prompt: list[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    seed: int = 0
    # -- overload protection --
    # Admission class: "interactive" jumps queued "batch" requests and
    # displaces them from a full submission queue — batch sheds first.
    priority: str = "interactive"
    # Queue-wait budget / total deadline (seconds from arrival_s); None
    # defers to the ServeConfig defaults. A queued request past either
    # is shed with a typed record instead of waiting forever; an
    # in-flight request past its total deadline is aborted and its
    # pages returned immediately.
    queue_budget_s: float | None = None
    deadline_s: float | None = None
    # Billing identity (utils/metering.py): which tenant's cost bucket
    # this request's chip-seconds and page-seconds land in. Rides the
    # traffic programs' ``tenant`` field (serve/traffic.py); None bills
    # to the "-" bucket.
    tenant: str | None = None

    # -- runtime state (engine-owned) --
    state: RequestState = RequestState.QUEUED
    generated: list[int] = dataclasses.field(default_factory=list)
    error: str | None = None
    prefill_cursor: int = 0          # prompt tokens already prefilled
    cached_prompt_tokens: int = 0    # prefix served from the radix tree
    slot: int | None = None
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    # Overload bookkeeping: why this request was shed (queue-deadline /
    # total-deadline / queue-full; None for a real failure or success),
    # and the pre-brownout-clamp max_new when level-3 brownout capped it.
    shed_reason: str | None = None
    max_new_requested: int | None = None
    # Live migration (``Engine.drain``): a drained request carries its
    # exported KV page contents here until the destination replica
    # admits it — admission then runs ``PagedKVCache.import_request``
    # instead of a cold allocation and the engine resumes the request
    # at its exact committed position.
    resume: dict | None = None
    migrations: int = 0              # times this request moved replicas
    # Request tracing (utils/tracing.rtrace): the identity
    # stamped once at admission into the serving tier, and the
    # per-request causal sequence number ``utils.tracing.rtrace``
    # increments per record. The Request OBJECT migrates between
    # replicas, so the sequence stays monotonic across the hop — the
    # timeline joiner links the two stream segments by (trace, seq).
    trace_id: str | None = None
    trace_seq: int = 0
    # Dedup flag for the ``memory_stall`` rtrace event: set on the first
    # head-of-line page-pressure block, cleared when the request finally
    # admits — one event per stall episode, not one per iteration.
    mem_stalled: bool = False
    # Crash recovery (serve/journal.py): a replayed request re-prefills
    # prompt + journaled committed tokens instead of just the prompt —
    # the final prefill chunk re-samples the last committed token and
    # the engine asserts it bitwise against the journal (the same
    # determinism contract migration relies on), then clears the flag.
    replay: bool = False

    @property
    def prefill_tokens(self) -> list[int]:
        """What prefill must process before decode (re)starts: the
        prompt — plus, for a journal-replay request, every committed
        token except the last (re-sampled and asserted by the final
        prefill chunk)."""
        if self.replay and self.generated:
            return self.prompt + self.generated[:-1]
        return self.prompt

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_capacity(self) -> int:
        """Positions this request may ever write (prompt + generated)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.state in (RequestState.COMPLETED, RequestState.FAILED)


def validate_request(req: Request, cache) -> None:
    """Shape/feasibility checks shared by per-engine submission and the
    a fleet's router-time admission — every replica runs the same
    geometry, so one cache's limits speak for the fleet."""
    if req.prompt_len < 1:
        raise ValueError(f"request {req.rid!r}: empty prompt")
    if req.max_new_tokens < 1:
        raise ValueError(f"request {req.rid!r}: max_new_tokens must "
                         f"be >= 1, got {req.max_new_tokens}")
    if req.total_capacity > cache.max_seq_len:
        raise ValueError(
            f"request {req.rid!r}: prompt ({req.prompt_len}) + "
            f"max_new_tokens ({req.max_new_tokens}) exceeds the "
            f"engine's max_seq_len {cache.max_seq_len}")
    if cache.pages_needed(req.total_capacity) > cache.pool.n_pages:
        raise ValueError(
            f"request {req.rid!r} needs "
            f"{cache.pages_needed(req.total_capacity)} pages but "
            f"the whole pool holds {cache.pool.n_pages}; it can "
            f"never be admitted")
    if req.priority not in PRIORITIES:
        raise ValueError(f"request {req.rid!r}: unknown priority "
                         f"{req.priority!r}; known: {PRIORITIES}")
    for name, v in (("queue_budget_s", req.queue_budget_s),
                    ("deadline_s", req.deadline_s)):
        if v is not None and v <= 0:
            raise ValueError(f"request {req.rid!r}: {name} must be > 0, "
                             f"got {v}")


class Scheduler:
    """Slot + queue bookkeeping; the engine drives it once per iteration.

    Owns no device state — admission consults the :class:`PagedKVCache`
    pool the engine passes in, so the page-accounting invariants
    (no double allocation, every page returned) live in one place.
    """

    def __init__(self, cache, n_slots: int, *, policy: str = "continuous",
                 prefill_chunks_per_iter: int = 1,
                 queue_budget_s: float | None = None,
                 deadline_s: float | None = None,
                 max_queue: int | None = None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}; known: "
                             f"continuous, static")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if prefill_chunks_per_iter < 1:
            raise ValueError(f"prefill_chunks_per_iter must be >= 1, got "
                             f"{prefill_chunks_per_iter}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.cache = cache
        self.n_slots = n_slots
        self.policy = policy
        self.prefill_chunks_per_iter = prefill_chunks_per_iter
        # Engine-wide deadline defaults (per-request fields override) and
        # the submission-queue bound — the overload-protection knobs.
        self.queue_budget_s = queue_budget_s
        self.deadline_s = deadline_s
        self.max_queue = max_queue
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self._ids: set[str] = set()
        # Request-trace sink: the engine points this at its telemetry
        # stream so admission's per-request ``rtrace`` records land even
        # when the scheduler runs outside a ``tracing.sink_scope``; a
        # fleet replica's engine also sets ``trace_fields`` to tag every
        # record with its origin (``{"replica": name}``) — the joiner
        # links migration hops by origin change (utils/telemetry.py).
        self.sink = None
        self.trace_fields: dict = {}

    # -- submission ---------------------------------------------------------

    @property
    def full(self) -> bool:
        """The submission queue is at its bound — the caller must reject
        with a typed record, not enqueue. (In fleet mode every queued
        request has already arrived — the fleet gates arrivals — so the
        raw count IS the live backlog; open-loop standalone engines
        bound the *arrived* backlog instead, via
        :meth:`arrived_backlog` + the engine's per-iteration trim.)"""
        return (self.max_queue is not None
                and len(self.queue) >= self.max_queue)

    def arrived_backlog(self, now: float) -> int:
        """Queued requests that have actually arrived by ``now`` — the
        backlog the queue bound applies to (future-dated open-loop trace
        entries are pre-registrations, not load)."""
        return sum(1 for r in self.queue if r.arrival_s <= now)

    def overflow(self, now: float) -> list[Request]:
        """Arrived requests beyond ``max_queue``, in shed order
        (:func:`overflow_victims`). The engine sheds these with typed
        ``queue-full`` records each iteration, so the live backlog
        stays bounded no matter how fast submissions arrive. Migrated
        requests (``resume`` payload) are exempt — rescued load is not
        new demand, the same contract that lets their force-enqueue
        bypass the bound — so they neither count against it nor get
        trimmed."""
        if self.max_queue is None:
            return []
        arrived = [r for r in self.queue
                   if r.arrival_s <= now and r.resume is None]
        victims = overflow_victims(arrived, self.max_queue)
        if not victims:
            return []
        gone = {id(r) for r in victims}
        self.queue = deque(r for r in self.queue if id(r) not in gone)
        return victims

    def submit(self, req: Request) -> None:
        if req.rid in self._ids:
            raise ValueError(f"duplicate request id {req.rid!r}")
        validate_request(req, self.cache)
        self._ids.add(req.rid)
        self.queue.append(req)

    # -- shedding -----------------------------------------------------------

    def expire(self, now: float) -> list[tuple[Request, str]]:
        """Remove arrived queued requests whose queue budget or total
        deadline has passed; returns ``(request, reason)`` pairs for the
        engine to shed with typed records. Queued requests hold no page
        reservation (reservation happens at admission), so removal is
        pure bookkeeping; their rids stay burned (a shed request is
        terminal, not resubmittable)."""
        out: list[tuple[Request, str]] = []
        keep: deque[Request] = deque()
        for r in self.queue:
            reason = (expiry_reason(r, now,
                                    queue_budget_s=self.queue_budget_s,
                                    deadline_s=self.deadline_s)
                      if r.arrival_s <= now else None)
            if reason is None:
                keep.append(r)
            else:
                out.append((r, reason))
        if out:
            self.queue = keep
        return out

    # -- admission ----------------------------------------------------------

    def admit(self, now: float) -> list[Request]:
        """Move arrived queue-head requests into free slots (continuous),
        or refill the whole batch once it has fully drained (static).
        Allocates every admitted request's full page reservation. An
        admission pass with a live queue records a span (utils/tracing.py)
        so the page-table writes show up on the engine timeline; empty
        passes stay span-free (one per idle engine iteration would drown
        the trace), and per-request attribution rides on the ``rtrace``
        plane — one ``admitted`` record per placed request, plus a
        deduplicated ``memory_stall`` when the queue head blocks on
        page pressure."""
        if self.policy == "static" and any(
                r is not None for r in self.slots):
            return []
        if not self.queue:
            return []
        admitted: list[Request] = []
        with tracing.span("admit") as sp:
            for slot in range(self.n_slots):
                if self.slots[slot] is not None:
                    continue
                req = self._next_admittable(now)
                if req is None:
                    break
                if req.resume is not None:
                    # A migrated-in request: its exported KV is
                    # authoritative, so the reservation is all fresh pages
                    # (no prefix sharing on arrival) with the payload's
                    # page contents written back in — same backpressure
                    # contract as a cold admission (False -> keep queuing,
                    # no side effects).
                    if not self.cache.import_request(
                            req.rid, req.resume["k"], req.resume["v"],
                            req.total_capacity, req=req, sink=self.sink,
                            trace_fields=self.trace_fields):
                        self._note_memory_stall(req)
                        break              # head-of-line: wait for pages
                else:
                    # One-pass fit check + admission (try_admit peeks the
                    # POST-SHARING bill — a cached prefix's pages are
                    # retained, not allocated, and tree-only pages count
                    # as reclaimable — and only when it fits performs the
                    # reservation; no second radix match / evictable walk
                    # on the hot path). A cold request on a warm pool
                    # queues exactly when its full reservation exceeds
                    # free + evictable (tests/test_prefix_cache.py pins
                    # the regression).
                    # (A journal-replay request admits over prompt +
                    # committed tokens — prefill_tokens — so its pages
                    # cover the whole replayed prefix.)
                    got = self.cache.try_admit(req.rid, req.prefill_tokens,
                                               req.total_capacity)
                    if got is None:
                        self._note_memory_stall(req)
                        break              # head-of-line: wait for pages
                    req.cached_prompt_tokens = got
                self.queue.remove(req)
                req.slot = slot
                req.state = RequestState.PREFILL
                if req.t_admitted is None:
                    # First admission only: a migrated request keeps its
                    # original admission stamp — queue-wait means "when
                    # did this request first get a slot",
                    # not "when did it land on its latest replica".
                    req.t_admitted = now
                self.slots[slot] = req
                admitted.append(req)
                req.mem_stalled = False    # stall episode (if any) ended
                tracing.rtrace(
                    req, "admitted", sink=self.sink, slot=slot,
                    cached_tokens=req.cached_prompt_tokens,
                    resumed=req.resume is not None, **self.trace_fields)
            sp.annotate(n=len(admitted))
        return admitted

    def _note_memory_stall(self, req: Request) -> None:
        """One ``memory_stall`` rtrace per stall episode: emitted when the
        queue-head request first blocks on page pressure, re-armed only
        after it admits — attribution for latency that is memory, not
        compute."""
        if req.mem_stalled:
            return
        req.mem_stalled = True
        tracing.rtrace(req, "memory_stall", sink=self.sink,
                       free_pages=self.cache.pool.free_pages,
                       need_capacity=req.total_capacity,
                       **self.trace_fields)

    def _next_admittable(self, now: float) -> Request | None:
        """The next admission candidate (:func:`next_arrived_by_class`).
        Head-of-line blocking applies to the CHOSEN candidate: when it
        does not fit, admission waits rather than skipping deeper
        (deterministic, starvation-free within class)."""
        return next_arrived_by_class(self.queue, now)

    # -- iteration views ----------------------------------------------------

    def prefilling(self) -> list[Request]:
        """Up to ``prefill_chunks_per_iter`` prefill candidates this
        iteration, in slot order (deterministic interleave)."""
        todo = [r for r in self.slots
                if r is not None and r.state is RequestState.PREFILL]
        return list(itertools.islice(todo, self.prefill_chunks_per_iter))

    def decoding(self) -> list[Request]:
        return [r for r in self.slots
                if r is not None and r.state is RequestState.DECODE]

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def evict(self, req: Request) -> None:
        """Release a finished/failed request's slot and pages — the
        mid-batch half of continuous batching."""
        if req.slot is None or self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid!r} is not resident")
        self.cache.release(req.rid)
        self.slots[req.slot] = None
        req.slot = None

    def withdraw(self, req: Request) -> None:
        """Remove a LIVE request from this scheduler entirely (the drain
        half of migration, ``Engine.drain``): a resident request gives up
        its slot and pages, a queued one leaves the queue, and the rid
        leaves the id set — the request will be resubmitted to a peer
        replica's scheduler, and may even return here after a
        quarantine/reinstate cycle."""
        if req.slot is not None:
            self.evict(req)
        else:
            if not any(q is req for q in self.queue):
                raise ValueError(f"request {req.rid!r} is not queued here")
            self.queue = deque(q for q in self.queue if q is not req)
        self._ids.discard(req.rid)

    def pending(self, now: float | None = None) -> int:
        """Queued requests (optionally only those already arrived)."""
        if now is None:
            return len(self.queue)
        return sum(1 for r in self.queue if r.arrival_s <= now)

    def next_arrival(self) -> float | None:
        return min((r.arrival_s for r in self.queue), default=None)

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)


def summarize(values: list[float]) -> dict[str, Any]:
    """p50/p99/mean/max over a host-side sample list (exact, sorted —
    the SLO numbers a serving run reports; registry histograms carry the
    same samples as bucketed estimates for the telemetry stream)."""
    if not values:
        return {"count": 0}
    ys = sorted(values)

    def pct(q: float) -> float:
        if len(ys) == 1:
            return ys[0]
        pos = q / 100.0 * (len(ys) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(ys) - 1)
        return ys[lo] + (pos - lo) * (ys[hi] - ys[lo])

    return {"count": len(ys), "mean": sum(ys) / len(ys),
            "p50": pct(50), "p99": pct(99), "max": ys[-1]}
