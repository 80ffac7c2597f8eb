"""Iteration-level (continuous) batching scheduler.

Counterpart of ``distributed_model_parallel_tpu/serve/scheduler.py``
(without priorities, deadlines, queue bounds, withdraw, migration and
request tracing — later slices). The decode batch is a fixed set of
slots, and scheduling happens per engine iteration: a finishing
sequence's slot and pages go to a waiting request mid-batch, and long
prompts prefill in chunks interleaved with decode steps.

Admission is FIFO with head-of-line blocking, gated on the page pool: a
request is admitted only when a slot is free and the pool holds pages for
its whole worst case (``prompt + max_new_tokens``). With a prefix cache
the bill is counted after sharing: a cached prefix's pages are retained,
not allocated, and tree-only pages count as reclaimable, so a cold
request on a warm pool queues exactly when its reservation exceeds free
plus evictable pages. Reservation is allocation, so decode never runs
out of pages mid-flight.
``policy="static"`` refills only once the whole batch has drained — the
baseline continuous batching is compared against.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Any


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclasses.dataclass(eq=False)   # identity semantics: requests are live
class Request:                     # objects in slots/queues, not values
    """One generation request plus its lifecycle bookkeeping.

    ``arrival_s`` is seconds since the engine run's start; ``seed``
    drives the request's own sampling stream (drawn per position).
    """

    rid: str
    prompt: list[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    seed: int = 0
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

    @property
    def prefill_tokens(self) -> list[int]:
        """What prefill processes before decode starts: the prompt (a
        journal replay's committed tokens join it when the journal is
        ported)."""
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
    """Shape/feasibility checks at submission."""
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


class Scheduler:
    """Slot + queue bookkeeping; the engine drives it once per iteration.
    Admission consults the :class:`PagedKVCache` pool, so the page
    accounting lives in one place."""

    def __init__(self, cache, n_slots: int, *, policy: str = "continuous",
                 prefill_chunks_per_iter: int = 1):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}; known: "
                             f"continuous, static")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if prefill_chunks_per_iter < 1:
            raise ValueError(f"prefill_chunks_per_iter must be >= 1, got "
                             f"{prefill_chunks_per_iter}")
        self.cache = cache
        self.n_slots = n_slots
        self.policy = policy
        self.prefill_chunks_per_iter = prefill_chunks_per_iter
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self._ids: set[str] = set()

    def submit(self, req: Request) -> None:
        if req.rid in self._ids:
            raise ValueError(f"duplicate request id {req.rid!r}")
        validate_request(req, self.cache)
        self._ids.add(req.rid)
        self.queue.append(req)

    def admit(self, now: float) -> list[Request]:
        """Move arrived requests into free slots (continuous), or refill
        the whole batch once it has fully drained (static), allocating
        each admitted request's page reservation after sharing
        (``cache.try_admit``; the cached token count lands in
        ``cached_prompt_tokens``). The first arrived request in queue
        order is the candidate; when it does not fit, admission waits
        (head-of-line blocking: deterministic and starvation-free)."""
        if self.policy == "static" and any(
                r is not None for r in self.slots):
            return []
        admitted: list[Request] = []
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            req = next((r for r in self.queue if r.arrival_s <= now), None)
            if req is None:
                break
            got = self.cache.try_admit(req.rid, req.prefill_tokens,
                                       req.total_capacity)
            if got is None:
                break
            req.cached_prompt_tokens = got
            self.queue.remove(req)
            req.slot = slot
            req.state = RequestState.PREFILL
            req.t_admitted = now
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    def prefilling(self) -> list[Request]:
        """Up to ``prefill_chunks_per_iter`` prefill candidates this
        iteration, in slot order."""
        todo = [r for r in self.slots
                if r is not None and r.state is RequestState.PREFILL]
        return list(itertools.islice(todo, self.prefill_chunks_per_iter))

    def decoding(self) -> list[Request]:
        return [r for r in self.slots
                if r is not None and r.state is RequestState.DECODE]

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def evict(self, req: Request) -> None:
        """Release a finished/failed request's slot and pages."""
        if req.slot is None or self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid!r} is not resident")
        self.cache.release(req.rid)
        self.slots[req.slot] = None
        req.slot = None

    def next_arrival(self) -> float | None:
        return min((r.arrival_s for r in self.queue), default=None)

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)


def summarize(values: list[float]) -> dict[str, Any]:
    """p50/p99/mean/max over a host-side sample list (exact, sorted,
    linear interpolation between ranks)."""
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
