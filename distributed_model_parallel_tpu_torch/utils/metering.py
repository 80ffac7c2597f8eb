"""Resource metering: per-request cost attribution + utilization ledger.

Counterpart of ``distributed_model_parallel_tpu/utils/metering.py`` (no
framework code; the port's own copy). It answers *who consumed the
capacity*: which tenant's requests ate which chip-seconds, how much
device page residency each request reserved, and how busy the engine
was between the idle gaps and the brownout clamps. Observation only: it
never changes the schedule.

Two ledgers per engine, one :class:`EngineMeter`:

* **Per-request bills.** A bill opens at residency start (scheduler
  admission, migration import, crash re-admission) and closes at
  residency end (terminal, or a drain/export hop). While open it
  accumulates:

  - *chip-seconds* — prefill chunks bill their full dispatch wall to
    the one request being prefilled (a chunk occupies the whole slice);
    decode/speculative rounds apportion the round's dispatch wall
    evenly across the live decode slots (one token per slot per round —
    equal shares of the batched matmul);
  - *page-seconds* — the request's page-pool reservation integrated
    over residency, with prefix-cache-shared pages credited at
    ``1/refcount`` (:meth:`~..serve.paged_kv.PagedKVCache.page_share`):
    a page three requests share costs each of them a third. Pages held
    only by the prefix cache itself are system overhead, billed to
    nobody;
  - *resident-seconds* — wall time the request held a slot at all.

  Closing a bill emits one typed ``meter`` record (:func:`emit_meter`)
  on the request's existing rtrace id. A migration emits a
  ``hop`` meter record on the source (billing that replica only for its
  own residency) and the destination opens a fresh bill, so the
  per-replica records chain by ``(trace, hop)`` — the terminal record
  is the LAST hop's. Terminal events (completed / shed / expired /
  failed) appear on exactly one meter record per trace, the invariant
  ``serve/capacity.check_invariants`` enforces. A replica that dies a hard death
  takes its open bills with it: a crashed residency is lost unbilled
  (under-billing is safe; phantom billing is not).

* **The utilization ledger.** Every engine iteration is classified into
  exactly one duty bucket — ``brownout`` (degraded-mode service,
  brownout level >= 1), ``busy`` (dispatched prefill or decode work),
  ``stalled`` (work exists but nothing dispatched: memory stalls,
  blocked admissions), ``idle`` (nothing to do) — and the iteration's
  measured wall sample is added to that bucket, so the buckets
  partition ``sum(engine._iter_s)`` *exactly by construction*. The
  fleet adds ``quarantined`` time for rounds a replica sat out of
  rotation (a quarantined engine never iterates, so it cannot classify
  itself). ``serve/capacity.check_invariants`` checks the partition
  against each replica's wall within 1%.

Timing is real-monotonic throughout (the same clock as
``Engine._iter_s``), even under a :class:`~..serve.traffic.SimClock` —
capacity is a statement about physical chip time, not virtual scenario
time. On the card a step's wall is its host enqueue plus the token
read-back that waits for the device, so a bill covers the device work
it caused. All metering bookkeeping self-times into
:attr:`EngineMeter.write_s` (the journal's ``write_s`` idiom).

Registry metrics (cached handles — a registry lookup per emission is
measurable on the overhead budget): ``meter_records``,
``meter_chip_seconds``, ``meter_page_seconds`` counters here; the fleet
sets the ``serve_utilization_*`` duty-fraction gauges from the merged
ledgers (per-replica engines never write process-global gauges).

``serve/capacity.py`` turns the emitted ``meter`` / ``utilization``
records into the capacity report: per-tenant cost tables, utilization,
sustainable tokens/s and headroom per replica.
"""

from __future__ import annotations

import time

from distributed_model_parallel_tpu_torch.utils.telemetry import registry

__all__ = [
    "EngineMeter",
    "LEDGER_BUCKETS",
    "METER_TERMINAL_EVENTS",
    "emit_meter",
]

# Duty-cycle buckets, in classification-priority order. Every engine
# iteration lands in exactly one of the first four; ``quarantined`` is
# fleet-added (a quarantined engine does not iterate).
LEDGER_BUCKETS = ("busy", "stalled", "brownout", "idle", "quarantined")

# Meter-record events that close a trace's billing — mirrors
# telemetry.RTRACE_TERMINAL_EVENTS; ``hop`` records (migration
# residency splits) are deliberately NOT terminal.
METER_TERMINAL_EVENTS = frozenset({"completed", "shed", "expired",
                                   "failed"})


def emit_meter(sink, req, event, *, replica=None, chip_s=0.0,
               page_s=0.0, resident_s=0.0, prefill_chunks=0,
               decode_rounds=0) -> None:
    """Write one typed ``meter`` record for ``req`` to ``sink``.

    The single emission path for billed (engine) and unbilled (fleet
    queue shed / rejection / dead-end failure) meter records, so every
    record carries the same shape: the request's trace id, rid, tenant,
    the billing replica, the event (terminal or ``hop``), the hop index
    (``req.migrations`` — hop records chain by it), and the cost
    figures. No-op without a sink. Registry counters are looked up per
    call here (fleet terminals are rare, off the iteration hot path);
    the hot path goes through :class:`EngineMeter`'s cached handles.
    """
    if sink is None:
        return
    sink.record("meter", trace=req.trace_id, request=req.rid,
                tenant=req.tenant, replica=replica, event=event,
                hop=req.migrations, chip_s=chip_s, page_s=page_s,
                resident_s=resident_s, prefill_chunks=prefill_chunks,
                decode_rounds=decode_rounds,
                tokens=len(req.generated),
                cached_tokens=req.cached_prompt_tokens)
    reg = registry()
    reg.counter("meter_records").inc()
    reg.counter("meter_chip_seconds").inc(max(0.0, chip_s))
    reg.counter("meter_page_seconds").inc(max(0.0, page_s))


class _Bill:
    """One open residency's accumulating cost figures."""

    __slots__ = ("chip_s", "page_s", "resident_s", "prefill_chunks",
                 "decode_rounds")

    def __init__(self):
        self.chip_s = 0.0
        self.page_s = 0.0
        self.resident_s = 0.0
        self.prefill_chunks = 0
        self.decode_rounds = 0


class EngineMeter:
    """Per-engine resource meter: request bills + utilization ledger.

    One per :class:`~..serve.engine.Engine` (constructed when metering
    is enabled). The engine drives it: :meth:`open_bill` at residency
    start, :meth:`bill_prefill` / :meth:`bill_decode` around dispatches,
    :meth:`tick` once per iteration (classification + page-second
    integration), :meth:`close_hop` on drain/export, :meth:`terminal`
    at the request's end. ``replica`` / ``cell`` label the emitted
    records (the fleet stamps ``cell`` after partitioning).
    """

    def __init__(self, *, replica: str | None = None,
                 cell: int | None = None):
        self.replica = replica
        self.cell = cell
        self._bills: dict[str, _Bill] = {}
        self.ledger: dict[str, float] = {b: 0.0 for b in LEDGER_BUCKETS}
        self.iterations = 0
        # Per-tenant cost rollup, folded at bill close: tenant ->
        # {requests, chip_s, page_s, resident_s, tokens, good_tokens,
        #  sheds}. ``requests`` counts terminals; hops add cost only.
        self.by_tenant: dict[str, dict] = {}
        # Monotonic seconds spent inside metering bookkeeping — the
        # numerator of metering's overhead share of iteration time.
        self.write_s = 0.0
        self._m_records = registry().counter("meter_records")
        self._m_chip = registry().counter("meter_chip_seconds")
        self._m_page = registry().counter("meter_page_seconds")

    # -- billing hooks (engine hot path) ------------------------------------

    def open_bill(self, rid: str) -> None:
        """Residency start: admission, migration import, or crash
        re-admission. Idempotent — re-opening an existing bill keeps
        its accumulated figures (a resumed prefill is one residency)."""
        t0 = time.monotonic()
        self._bills.setdefault(rid, _Bill())
        self.write_s += time.monotonic() - t0

    def bill_prefill(self, rid: str, dur_s: float) -> None:
        """One prefill-chunk dispatch: the whole dispatch wall bills to
        the one request being prefilled (the chunk owns the slice)."""
        t0 = time.monotonic()
        bill = self._bills.get(rid)
        if bill is not None:
            bill.chip_s += dur_s
            bill.prefill_chunks += 1
        self.write_s += time.monotonic() - t0

    def bill_decode(self, rids, dur_s: float) -> None:
        """One decode/spec round dispatch: the round's wall apportions
        evenly across the live decode slots it served."""
        t0 = time.monotonic()
        if rids:
            share = dur_s / len(rids)
            for rid in rids:
                bill = self._bills.get(rid)
                if bill is not None:
                    bill.chip_s += share
                    bill.decode_rounds += 1
        self.write_s += time.monotonic() - t0

    def tick(self, dt: float, *, progress: bool, brownout: bool,
             has_work: bool, cache=None) -> None:
        """Classify one iteration's wall sample ``dt`` into its duty
        bucket and integrate page-seconds/resident-seconds over every
        open bill. Called once per ``step_once`` with the SAME sample
        appended to ``_iter_s`` — that identity is what makes the duty
        buckets partition the engine's iteration wall exactly."""
        t0 = time.monotonic()
        if brownout:
            bucket = "brownout"
        elif progress:
            bucket = "busy"
        elif has_work:
            bucket = "stalled"
        else:
            bucket = "idle"
        self.ledger[bucket] += dt
        self.iterations += 1
        for rid, bill in self._bills.items():
            bill.resident_s += dt
            if cache is not None:
                bill.page_s += dt * cache.page_share(rid)
        self.write_s += time.monotonic() - t0

    # -- bill close ---------------------------------------------------------

    def _fold_tenant(self, req, bill, *, terminal: bool,
                     shed: bool = False, good_tokens: int = 0) -> None:
        row = self.by_tenant.setdefault(
            req.tenant or "-", {"requests": 0, "chip_s": 0.0,
                                "page_s": 0.0, "resident_s": 0.0,
                                "tokens": 0, "good_tokens": 0,
                                "sheds": 0})
        row["chip_s"] += bill.chip_s
        row["page_s"] += bill.page_s
        row["resident_s"] += bill.resident_s
        if terminal:
            row["requests"] += 1
            row["tokens"] += len(req.generated)
            row["good_tokens"] += good_tokens
            if shed:
                row["sheds"] += 1

    def close_hop(self, req, sink) -> None:
        """Residency end WITHOUT a terminal — a drain/export migration.
        Emits a ``hop`` meter record billing this replica only for its
        own residency; the destination opens a fresh bill and the
        records chain by ``(trace, hop)``."""
        t0 = time.monotonic()
        bill = self._bills.pop(req.rid, None)
        if bill is not None:
            self._fold_tenant(req, bill, terminal=False)
            self._emit(sink, req, "hop", bill)
        self.write_s += time.monotonic() - t0

    def terminal(self, req, event: str, sink, *,
                 good_tokens: int = 0) -> None:
        """The request's single terminal: close its bill (a zero bill
        when it never reached residency — queue sheds, rejections) and
        emit the one terminal meter record the capacity gate counts."""
        t0 = time.monotonic()
        bill = self._bills.pop(req.rid, None) or _Bill()
        self._fold_tenant(req, bill, terminal=True,
                          shed=event in ("shed", "expired"),
                          good_tokens=good_tokens)
        self._emit(sink, req, event, bill)
        self.write_s += time.monotonic() - t0

    def _emit(self, sink, req, event, bill) -> None:
        """Hot-path twin of :func:`emit_meter` using cached handles."""
        if sink is None:
            return
        sink.record("meter", trace=req.trace_id, request=req.rid,
                    tenant=req.tenant, replica=self.replica,
                    event=event, hop=req.migrations, chip_s=bill.chip_s,
                    page_s=bill.page_s, resident_s=bill.resident_s,
                    prefill_chunks=bill.prefill_chunks,
                    decode_rounds=bill.decode_rounds,
                    tokens=len(req.generated),
                    cached_tokens=req.cached_prompt_tokens)
        self._m_records.inc()
        self._m_chip.inc(max(0.0, bill.chip_s))
        self._m_page.inc(max(0.0, bill.page_s))

    # -- fleet integration --------------------------------------------------

    def add_quarantined(self, dt: float) -> None:
        """Fleet-added duty: wall a quarantined replica sat out of
        rotation (it never iterated, so it could not classify itself)."""
        self.ledger["quarantined"] += dt

    # -- rollups ------------------------------------------------------------

    def chip_s_total(self) -> float:
        """Chip-seconds billed so far (closed rollups + open bills)."""
        closed = sum(r["chip_s"] for r in self.by_tenant.values())
        return closed + sum(b.chip_s for b in self._bills.values())

    def utilization(self) -> dict:
        """The duty-cycle ledger: per-bucket seconds plus their sum
        (``wall_s`` — equals iteration wall + quarantined time by
        construction) and the iteration count."""
        out = {f"{b}_s": self.ledger[b] for b in LEDGER_BUCKETS}
        out["wall_s"] = sum(self.ledger.values())
        out["iterations"] = self.iterations
        return out

    def record_utilization(self, sink) -> None:
        """Emit one typed ``utilization`` record — the per-replica duty
        ledger the capacity report's timeline and partition gate read."""
        if sink is None:
            return
        sink.record("utilization", replica=self.replica, cell=self.cell,
                    meter_write_s=self.write_s, **self.utilization())

    def summary(self) -> dict:
        return {"utilization": self.utilization(),
                "by_tenant": {t: dict(r)
                              for t, r in sorted(self.by_tenant.items())},
                "open_bills": len(self._bills),
                "chip_s": self.chip_s_total(),
                "write_s": self.write_s}
