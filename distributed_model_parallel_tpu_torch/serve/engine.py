"""The serving engine loop: continuous batching over the paged KV cache.

Counterpart of ``distributed_model_parallel_tpu/serve/engine.py``. One
iteration = overload passes (expiry, deadline aborts, the brownout
ladder's admission knobs) -> admit -> queue-bound trim -> prefill (a
bounded number of chunks, interleaved so long prompts never stall the
resident batch) -> one decode round for every active slot -> evict
finished sequences (their slot and pages are reusable the next
iteration). The decode step runs at a fixed slot width with idle rows
masked, so a request's tokens are a function of its own (prompt, seed):
joining a busy batch mid-flight decodes exactly what a solo run would.

``prefix_cache`` keeps finished prefixes in a refcounted radix tree
(``serve/prefix_cache.py``): a request whose prompt shares a prefix with
one already prefilled admits holding the cached pages, prefills only the
suffix and is billed only for the pages it adds. ``spec_k`` turns on
speculative decoding: an n-gram proposer (``serve/spec.py``) drafts up to
``spec_k`` tokens a request, one verify forward
(``serve/model.make_verify_step``) commits the prefix the model agrees
with, and a request drafts for real only after its proposer has predicted
two committed tokens in a row.

Overload controls: two priority classes (``interactive`` jumps queued
``batch``), per-request queue budgets and total deadlines (a queued
request past either sheds typed; an in-flight one past its deadline is
aborted and its pages return at once), a bounded arrived backlog
(``max_queue``: submissions beyond it reject, overflow trims batch
first), and the brownout ladder (``serve/overload.py``: spec-off ->
prefill-share -> clamp-max-new, walked back on resolution).

Planes, all observation-only: the write-ahead request journal
(``serve/journal.py``: committed-token watermarks from the decode loop,
exactly one terminal per accepted request; a journal replay re-prefills
prompt + committed tokens and asserts the re-sampled last token),
resource metering (``utils/metering.py``), the telemetry stream
(``serve``/``shed``/``brownout`` records, SLO histograms in the process
registry), request tracing (``rtrace`` records and spans,
``utils/tracing.py``) and the live status exporter
(``utils/statusz.py``). :meth:`Engine.drain` takes every live request off
the engine with its written K/V by value, for :meth:`Engine.enqueue` on
another engine; :meth:`Engine.kill` abandons the engine without a
terminal, for the journal to replay.

Spans and bills time the host clock: on the card a decode round's wall is
its enqueue plus the token read-back that waits for the device. The
engine never adds a device synchronization of its own.

A killed engine never drops requests silently: every in-flight and
queued request is marked failed with a typed error before the exception
propagates as :class:`EngineKilled`, and a flight-recorder bundle
(``utils/flightrec.py``) is written when a recorder is installed.

The serving fleet (``serve/fleet.py``) drives engines through
``step_once``, ``try_enqueue``, ``drain``, ``enqueue(force=True)``,
``clear_cache`` and ``kill``, on slots of the orchestrator's
``DevicePool`` (``orchestrator/scheduler.py``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from distributed_model_parallel_tpu_torch.models.transformer import (
    TransformerConfig,
    resolve_device,
    validate_sampling,
)
from distributed_model_parallel_tpu_torch.ops.paged_attention import IMPLS
from distributed_model_parallel_tpu_torch.serve.model import (
    make_decode_step,
    make_prefill_step,
    make_verify_step,
)
from distributed_model_parallel_tpu_torch.serve.overload import (
    BrownoutController,
    apply_max_new_cap,
)
from distributed_model_parallel_tpu_torch.serve.paged_kv import (
    PagedKVCache,
    PagePoolError,
    memory_gauges,
    share_granularity_for,
)
from distributed_model_parallel_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
    Scheduler,
    summarize,
)
from distributed_model_parallel_tpu_torch.serve.spec import NGramProposer
from distributed_model_parallel_tpu_torch.utils import (
    flightrec,
    statusz,
    tracing,
)
from distributed_model_parallel_tpu_torch.utils.metering import EngineMeter
from distributed_model_parallel_tpu_torch.utils.telemetry import registry
from distributed_model_parallel_tpu_torch.utils.tracing import span


class EngineKilled(RuntimeError):
    """The engine loop died mid-stream; every in-flight request has been
    marked failed (typed) before this propagated."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine geometry + sampling policy + overload controls.

    ``n_pages`` is the pool capacity — the admission backpressure point;
    ``max_seq_len`` bounds any single request (prompt + generation) and
    sets the per-sequence page-table width; ``prefill_chunk`` is the one
    prompt-chunk size. ``attn_impl``: ``"kernel"`` (decode through the
    paged CUDA kernel; its plain version on CPU tensors) or ``"plain"``
    (the gather path everywhere). ``prefix_cache`` keeps finished prefixes
    in a radix tree for later requests to share; ``spec_k`` > 0 drafts up
    to that many tokens a round with an n-gram proposer of orders up to
    ``spec_ngram`` and verifies them in one forward (0: single-token
    decode).

    Overload: a queued request older than ``queue_budget_s`` sheds typed
    (``queue-deadline``); one past ``deadline_s`` sheds (queued) or aborts
    (in flight) with ``total-deadline`` — both per-request overridable,
    None = no budget. ``max_queue`` bounds the arrived backlog (beyond
    it: ``queue-full``). ``brownout`` arms the degradation ladder, driven
    by a TTFT burn rate against ``brownout_ttft_target_s`` and a
    page-occupancy ceiling. ``statusz_port`` starts the process's status
    exporter (None: ``DMP_STATUSZ_PORT``; unset: no exporter).
    """

    n_slots: int = 8
    page_size: int = 16
    n_pages: int = 256
    max_seq_len: int = 512
    prefill_chunk: int = 32
    prefill_chunks_per_iter: int = 1
    policy: str = "continuous"       # "continuous" | "static" (baseline)
    attn_impl: str = "kernel"
    prefix_cache: bool = False
    spec_k: int = 0
    spec_ngram: int = 3              # longest lookup order tried
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None
    queue_budget_s: float | None = None
    deadline_s: float | None = None
    max_queue: int | None = None
    brownout: bool = False
    brownout_ttft_target_s: float = 1.0   # SLO target feeding the burn rule
    brownout_budget: float = 0.25         # tolerated violation fraction
    brownout_window_s: float = 10.0       # short burn window (long = 4x)
    brownout_occupancy_ceiling: float = 0.95
    brownout_max_new: int = 32            # level-3 cap on admissions' max_new
    brownout_hold_iters: int = 8          # min ticks between level moves
    statusz_port: int | None = None


class Engine:
    """Continuous-batching decode engine over one model on ``device``.

    ``step_hook(iteration)`` (tests, chaos drills) runs once per loop
    iteration; an exception it raises takes the typed-failure path like
    any other engine death. ``telemetry`` is a
    :class:`~..utils.telemetry.TelemetryRun` (None: no records, no request
    traces); ``clock`` replaces ``time.monotonic`` for every timestamp the
    engine takes (a :class:`~.traffic.SimClock` makes a run a function of
    its trace); ``journal`` is a :class:`~.journal.RequestJournal`;
    ``meter=False`` turns metering off. ``slo_metrics=False`` keeps a
    probe engine out of the process registry and the status exporter;
    ``replica`` names the engine in a fleet (tags its records).
    """

    def __init__(self, params: dict, cfg: TransformerConfig,
                 serve: ServeConfig, *, device="cuda", telemetry=None,
                 step_hook=None, slo_metrics: bool = True,
                 replica: str | None = None, clock=None, journal=None,
                 meter: bool = True):
        if cfg.moe_experts:
            raise ValueError(
                "MoE decode routing is batch-coupled (expert-capacity "
                "drops depend on co-resident tokens), which breaks "
                "continuous batching's per-request determinism")
        if cfg.tp_axis is not None or cfg.sp_axis is not None:
            raise ValueError("the serving engine runs replicated; build "
                             "it with tp_axis=None/sp_axis=None")
        if serve.max_seq_len > cfg.max_seq_len:
            raise ValueError(
                f"serve max_seq_len {serve.max_seq_len} exceeds the "
                f"model's max_seq_len {cfg.max_seq_len}")
        if serve.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{serve.prefill_chunk}")
        if serve.attn_impl not in IMPLS:
            raise ValueError(f"unknown attn_impl {serve.attn_impl!r}; "
                             f"known: {', '.join(IMPLS)}")
        validate_sampling(cfg, serve.temperature, serve.top_k, serve.top_p)
        if serve.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {serve.spec_k}")
        if serve.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got "
                             f"{serve.spec_ngram}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.serve = serve
        self.telemetry = telemetry
        self.step_hook = step_hook
        self.journal = journal
        self.meter = EngineMeter(replica=replica) if meter else None
        self.replica = replica
        self._clock = clock if clock is not None else time.monotonic
        self._slo_metrics = slo_metrics
        # Shared prefixes end on a page and a prefill-chunk boundary, so a
        # cache-hit request's remaining chunks are the cold run's chunks
        # at the same positions.
        self.cache = PagedKVCache(
            cfg, n_pages=serve.n_pages, page_size=serve.page_size,
            max_seq_len=serve.max_seq_len, prefix_cache=serve.prefix_cache,
            share_granularity=share_granularity_for(serve.page_size,
                                                    serve.prefill_chunk),
            device=self.device)
        self.sched = Scheduler(self.cache, serve.n_slots,
                               policy=serve.policy,
                               prefill_chunks_per_iter=(
                                   serve.prefill_chunks_per_iter),
                               queue_budget_s=serve.queue_budget_s,
                               deadline_s=serve.deadline_s,
                               max_queue=serve.max_queue)
        # Admission-side rtrace records go to this engine's stream, tagged
        # with the replica in fleet mode.
        self.sched.sink = telemetry
        self._trace_fields = ({"replica": replica}
                              if replica is not None else {})
        self.sched.trace_fields = self._trace_fields
        self.brownout = BrownoutController(serve) if serve.brownout else None
        self._shed_by_reason: dict[str, int] = {}
        self._rejected = 0
        kw = dict(page_size=serve.page_size, n_pages=serve.n_pages,
                  impl=serve.attn_impl, temperature=serve.temperature,
                  top_k=serve.top_k, top_p=serve.top_p, device=self.device)
        self._prefill = make_prefill_step(cfg, chunk=serve.prefill_chunk,
                                          **kw)
        self._decode = make_decode_step(cfg, **kw)
        # Speculative decoding: a ladder of verify widths (powers of two up
        # to spec_k + 1); each round runs the smallest width covering its
        # longest live draft.
        self._verify_widths: list[int] = []
        self._verify: dict[int, object] = {}
        if serve.spec_k:
            w = 2
            while w < serve.spec_k + 1:
                self._verify_widths.append(w)
                w *= 2
            self._verify_widths.append(serve.spec_k + 1)
            self._verify = {w: make_verify_step(cfg, width=w, **kw)
                            for w in self._verify_widths}
        self._proposers: dict[str, NGramProposer] = {}
        # Shadow gating: a request drafts for real only after its proposer
        # predicted two consecutive committed tokens (scored on the cheap
        # path); a round that accepts nothing sends it back to shadow. A
        # pure function of the committed stream: it moves when drafts
        # ride, never which tokens commit.
        self._spec_streak: dict[str, int] = {}
        self._spec_live: dict[str, bool] = {}
        self._requests: list[Request] = []
        # Per-slot page tables, written once per admission (reservation
        # == allocation, so a request's table is final when it joins).
        self._tables_np = np.zeros(
            (serve.n_slots, self.cache.pages_per_seq), np.int32)
        self._auto_rid = 0
        self._iterations = 0
        self._now = 0.0               # open-loop clock of the last iteration
        self._decode_steps = 0
        self._decode_tokens = 0       # useful tokens out of decode steps
        self._occupancy: list[float] = []
        self._wall_s = 0.0            # accumulates across run() calls
        # Real (monotonic) per-iteration wall samples, whatever the clock.
        self._iter_s: list[float] = []
        # prefix-cache and speculative-decoding accounting
        self._prompt_tokens = 0       # prompt tokens of admitted requests
        self._cached_tokens = 0       # of those, served from the tree
        self._draft_proposed = 0
        self._draft_accepted = 0
        statusz.maybe_serve(serve.statusz_port)
        self._provider = (f"serve-{replica}" if replica is not None
                          else f"serve-{serve.policy}")
        if slo_metrics:
            statusz.register(self._provider, self._status)

    def _status(self) -> dict:
        """The engine's /statusz provider payload."""
        return {
            "workload": "serve",
            "policy": self.serve.policy,
            "replica": self.replica,
            "iterations": self._iterations,
            "queue_depth": len(self.sched.queue),
            "active_requests": sum(1 for r in self._requests
                                   if not r.done and r.slot is not None),
            "n_slots": self.serve.n_slots,
            "page_occupancy": self.cache.occupancy,
            "requests_submitted": len(self._requests),
            "requests_shed": sum(self._shed_by_reason.values()),
            "requests_rejected": self._rejected,
            "shed_by_reason": dict(sorted(self._shed_by_reason.items())),
            "brownout_level": (self.brownout.level
                               if self.brownout is not None else None),
            "max_queue": self.serve.max_queue,
            "prefix_cache": self.serve.prefix_cache,
            "spec_k": self.serve.spec_k,
            "cache_hit_rate": self.cache_hit_rate,
            "shared_pages": self.cache.shared_pages,
            "cached_prefix_pages": (len(self.cache.prefix)
                                    if self.cache.prefix is not None
                                    else 0),
            "draft_accept_rate": self.draft_accept_rate,
            "utilization": (self.meter.utilization()
                            if self.meter is not None else None),
            "open_bills": (len(self.meter._bills)
                           if self.meter is not None else None),
            "healthy": True,
        }

    @property
    def cache_hit_rate(self) -> float | None:
        """Prompt tokens served from the prefix tree / prompt tokens
        admitted (None before any admission or with the cache off)."""
        if not self.serve.prefix_cache or not self._prompt_tokens:
            return None
        return self._cached_tokens / self._prompt_tokens

    @property
    def draft_accept_rate(self) -> float | None:
        if not self.serve.spec_k or not self._draft_proposed:
            return None
        return self._draft_accepted / self._draft_proposed

    def warmup(self) -> None:
        """Run every step once with inert inputs — no valid prefill token,
        no active decode or verify row, so every cache write is dropped
        and the outputs are discarded — so that the first launch of each
        kernel (and its ``nvcc`` build) happens here, never inside a timed
        serving run: the decode step's paged kernel and the verify
        ladder's window-row entry at every width. Pool contents, tables
        and stats are untouched; the kernels' launch counts are not (a
        caller that counts launches resets them after warming)."""
        b = self.serve.n_slots
        n = self.cache.pages_per_seq
        # Position 1 with no valid token: every query row sees key 0, so
        # no attention row is empty.
        self._prefill(self.params, self.cache.ck, self.cache.cv,
                      np.zeros((1, self.serve.prefill_chunk), np.int64),
                      1, 0, np.zeros((n,), np.int32), 0)
        tables = np.zeros((b, n), np.int32)
        idle = np.zeros((b,), bool)
        seeds = np.zeros((b,), np.int64)
        self._decode(self.params, self.cache.ck, self.cache.cv,
                     np.zeros((b,), np.int64), np.zeros((b,), np.int64),
                     tables, idle, seeds).tolist()
        for w in self._verify_widths:
            self._verify[w](self.params, self.cache.ck, self.cache.cv,
                            np.zeros((b, w), np.int64),
                            np.zeros((b,), np.int64),
                            np.ones((b,), np.int64), tables, idle,
                            seeds).tolist()

    def clear_cache(self) -> int:
        """Drop the prefix tree and check that every page is back on the
        free list — call after :meth:`drain` (or with nothing resident):
        a page still held would mean an exported request left a reference
        behind. Returns the tree pages freed."""
        freed = self.cache.drop_prefix()
        if self.cache.pool.used_pages:
            raise PagePoolError(
                f"engine {self._provider}: {self.cache.pool.used_pages} "
                f"pages still held after drain + prefix drop")
        return freed

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, rid: str | None = None,
               arrival_s: float = 0.0, seed: int = 0,
               priority: str = "interactive",
               queue_budget_s: float | None = None,
               deadline_s: float | None = None,
               tenant: str | None = None) -> Request:
        prompt = [int(t) for t in prompt]
        if rid is None:
            rid = f"req-{self._auto_rid}"
            self._auto_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      arrival_s=float(arrival_s), seed=int(seed),
                      priority=priority, queue_budget_s=queue_budget_s,
                      deadline_s=deadline_s, tenant=tenant)
        # The request trace starts at entry into the serving tier; with no
        # stream nothing is stamped and every later rtrace is a no-op.
        if self.telemetry is not None and req.trace_id is None:
            req.trace_id = tracing.new_trace_id()
            self._rtrace(req, "submitted", prompt_tokens=req.prompt_len,
                         max_new_tokens=req.max_new_tokens,
                         priority=req.priority)
        return self.enqueue(req)

    def _rtrace(self, req: Request, event: str, **fields) -> None:
        """Engine-side rtrace: this engine's stream as the sink, tagged
        with the replica in fleet mode."""
        tracing.rtrace(req, event, sink=self.telemetry,
                       **self._trace_fields, **fields)

    def _validate_prompt(self, req: Request) -> None:
        bad = [t for t in req.prompt
               if not (0 <= t < self.cfg.vocab_size)]
        if bad:
            raise ValueError(f"prompt tokens {bad} outside vocab "
                             f"[0, {self.cfg.vocab_size})")

    def enqueue(self, req: Request, *, force: bool = False) -> Request:
        """Accept an already-built :class:`Request` — a fleet router's
        entry point, and the re-admission path of a request drained off
        another engine (its committed tokens, cursor and ``resume``
        payload ride on the object) or replayed from a journal. A full
        bounded queue rejects an already-arrived request with a typed
        ``shed`` record (reason ``queue-full``) — callers check
        ``req.done``. ``force=True`` bypasses the bound: migrated load is
        not new demand."""
        self._validate_prompt(req)
        # The bound applies to the arrived backlog; future-dated trace
        # entries enqueue, and the per-iteration trim bounds them once
        # they arrive.
        if (not force and self.sched.max_queue is not None
                and req.arrival_s <= self._now
                and self.sched.arrived_backlog(self._now)
                >= self.sched.max_queue):
            self._reject(req, "queue-full")
            return req
        self.sched.submit(req)
        self._requests.append(req)
        return req

    def try_enqueue(self, req: Request) -> bool:
        """Bounded enqueue with no side effect on refusal (a fleet
        dispatcher's entry point: ``False`` keeps the request on the
        fleet's queue)."""
        self._validate_prompt(req)
        if self.sched.full:
            return False
        self.sched.submit(req)
        self._requests.append(req)
        return True

    def _reject(self, req: Request, reason: str) -> None:
        """Typed submission rejection: terminal, counted, recorded."""
        req.state = RequestState.FAILED
        req.shed_reason = reason
        req.error = f"rejected: {reason}"
        if self.journal is not None:
            # Usually the journal has no intent for it (a no-op); a
            # fleet-accepted request whose re-dispatch bounced still
            # owes its single terminal.
            self.journal.terminal(req.rid, "shed")
        if self.meter is not None:
            self.meter.terminal(req, "shed", self.telemetry)
        self._rtrace(req, "shed", reason=reason, state="queued")
        self._requests.append(req)
        self._rejected += 1
        self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + 1
        if self._slo_metrics:
            reg = registry()
            reg.counter("serve_rejected_total").inc()
            reg.counter("serve_shed_total").inc()
        if self.telemetry is not None:
            self.telemetry.record(
                "shed", request=req.rid, reason=reason,
                priority=req.priority, state="queued",
                policy=self.serve.policy, prompt_tokens=req.prompt_len,
                new_tokens=len(req.generated), **self._trace_fields)

    # -- live migration -----------------------------------------------------

    def drain(self) -> list[Request]:
        """Take every live request off this engine, in submission order,
        for :meth:`enqueue` (``force=True``) on another engine. A resident
        request's written K/V pages travel **by value** in its ``resume``
        payload (``PagedKVCache.export_request``: host tensors in the
        pool's dtype), so nothing references this engine's pool or tree
        afterwards; queued requests ride along as they are. Slots and
        pages return here at once; terminal requests stay for the
        record."""
        out: list[Request] = []
        for req in self._requests:
            if req.done:
                continue
            if req.slot is not None:
                if req.state is RequestState.PREFILL:
                    n_written = req.prefill_cursor   # [0, cursor) written
                else:
                    # Decode feeds a committed token back before writing
                    # its K/V, so the last committed token's slot is
                    # unwritten (or, under speculation, may hold a
                    # rejected draft's write) — the trim ``_complete``
                    # uses too.
                    n_written = req.prompt_len + len(req.generated) - 1
                k, v = self.cache.export_request(
                    req.rid, n_written, req=req, sink=self.telemetry,
                    trace_fields=self._trace_fields)
                req.resume = {
                    "k": k, "v": v, "n_written": n_written,
                    "state": ("decode" if req.state is RequestState.DECODE
                              else "prefill"),
                }
                req.state = RequestState.QUEUED
            if self.meter is not None:
                # Residency ends here: a ``hop`` meter record bills this
                # engine for exactly what it hosted.
                self.meter.close_hop(req, self.telemetry)
            self.sched.withdraw(req)
            self._forget_spec(req)
            req.migrations += 1
            out.append(req)
        self._requests = [r for r in self._requests if r.done]
        return out

    def _restore_imported(self, req: Request) -> None:
        """Finish admitting a migrated-in request (its pages are already
        imported): resume at the exact committed position — a mid-prefill
        cursor is chunk-aligned, so the remaining chunks are the cold
        run's; a mid-decode request rejoins the decode batch."""
        payload = req.resume
        req.resume = None
        req.state = (RequestState.DECODE if payload["state"] == "decode"
                     else RequestState.PREFILL)
        if self.serve.spec_k:
            # The proposer is a function of the committed stream; gating
            # restarts in shadow mode (moves when drafts ride, never
            # which tokens commit).
            prop = NGramProposer(self.serve.spec_k,
                                 max_order=self.serve.spec_ngram)
            prop.extend(req.prompt)
            prop.extend(req.generated)
            self._proposers[req.rid] = prop

    # -- hard crash ---------------------------------------------------------

    def kill(self, reason: str = "injected-crash") -> None:
        """Hard-crash this engine: no drain, no per-request terminal — the
        engine, its pool and its tree are simply abandoned by the caller.
        The exhaust is a typed failure record carrying the journal
        position (the exact replay point) and a flight-recorder bundle;
        re-serving the lost requests is the journal's job."""
        if self.telemetry is not None:
            self.telemetry.failure(
                "replica-crashed", detail=reason,
                iteration=self._iterations, **self._trace_fields,
                **({"journal": self.journal.position()}
                   if self.journal is not None else {}))
        flightrec.dump("replica-crashed", telemetry_run=self.telemetry)

    # -- the loop -----------------------------------------------------------

    def run(self, *, max_iterations: int | None = None,
            record_summary: bool = True) -> dict:
        """Drive the loop until every submitted request is terminal (or
        ``max_iterations``). Returns :meth:`summary` (also recorded as the
        ``serve`` summary record unless ``record_summary=False``)."""
        t0 = self._clock()
        try:
            # Spans from the loop go to this engine's stream for the run.
            with tracing.sink_scope(self.telemetry):
                while not self.sched.idle():
                    if (max_iterations is not None
                            and self._iterations >= max_iterations):
                        break
                    now = self._clock() - t0
                    if not self.step_once(now, t0):
                        nxt = self.sched.next_arrival()
                        if nxt is not None:
                            # Open loop: nothing resident and the next
                            # request has not arrived — wait for it (a
                            # virtual clock skips straight there).
                            adv = getattr(self._clock, "advance_to", None)
                            if adv is not None:
                                adv(t0 + nxt)
                            else:
                                time.sleep(max(0.0, min(nxt - now, 0.05)))
        except BaseException as e:
            self._fail_inflight(f"{type(e).__name__}: {e}")
            self._wall_s += self._clock() - t0
            if self.telemetry is not None:
                self.telemetry.failure(
                    "engine-killed", detail=f"{type(e).__name__}: {e}",
                    iteration=self._iterations,
                    **({"journal": self.journal.position()}
                       if self.journal is not None else {}))
            # The state at the moment of death (no-op without a recorder).
            flightrec.dump("engine-killed", telemetry_run=self.telemetry,
                           error=e)
            if not isinstance(e, Exception):
                raise
            raise EngineKilled(
                f"engine died at iteration {self._iterations}; "
                f"in-flight requests marked failed") from e
        self._wall_s += self._clock() - t0
        return self.summary(record=record_summary)

    def step_once(self, now: float, t0: float) -> bool:
        """One engine iteration at open-loop clock ``now`` (seconds since
        ``t0``). Returns whether any prefill or decode work ran."""
        if self.step_hook is not None:
            self.step_hook(self._iterations)
        self._iterations += 1
        self._now = now
        w0 = time.monotonic()
        progress = False
        try:
            progress = self._iterate(now, t0)
            return progress
        finally:
            dt = time.monotonic() - w0
            self._iter_s.append(dt)
            if self.meter is not None:
                # The same wall sample as ``_iter_s``: the duty buckets
                # partition the iteration wall exactly.
                self.meter.tick(
                    dt, progress=progress,
                    brownout=(self.brownout is not None
                              and self.brownout.level >= 1),
                    has_work=(any(r is not None for r in self.sched.slots)
                              or self.sched.arrived_backlog(now) > 0),
                    cache=self.cache)

    def _iterate(self, now: float, t0: float) -> bool:
        progress = False
        # Overload first: shed queued requests past their budgets, abort
        # in-flight ones past their total deadline (their pages return
        # before admission, so the room can admit someone this very
        # iteration), then the brownout ladder's admission-side knobs.
        for req, reason in self.sched.expire(now):
            self._shed(req, reason, now)
        for req in self.sched.active():
            dl = (req.deadline_s if req.deadline_s is not None
                  else self.serve.deadline_s)
            if dl is not None and now - req.arrival_s > dl:
                self._shed(req, "total-deadline", now)
        bo = self.brownout
        if bo is not None:
            self.sched.prefill_chunks_per_iter = (
                self.serve.prefill_chunks_per_iter
                if bo.prefill_full_share else 1)
            # Level 3 clamps waiting requests' max_new before admission
            # bills the reservation; the clamped stream is a prefix of
            # the unclamped one.
            apply_max_new_cap(bo, self.sched.queue, now,
                              sink=self.telemetry,
                              trace_fields=self._trace_fields)
        for req in self.sched.admit(now):
            self._tables_np[req.slot] = self.cache.table_array(req.rid)
            if self.meter is not None:
                self.meter.open_bill(req.rid)
            if req.resume is not None:
                # Migrated in: pages imported by the scheduler; no prompt
                # accounting (billed where it was prefilled) and no second
                # queue-wait sample.
                self._restore_imported(req)
                continue
            # A cache hit's shared pages already hold the prefix's K/V:
            # prefill starts at the first uncached token.
            req.prefill_cursor = req.cached_prompt_tokens
            self._prompt_tokens += req.prompt_len
            self._cached_tokens += req.cached_prompt_tokens
            if self.serve.spec_k:
                prop = NGramProposer(self.serve.spec_k,
                                     max_order=self.serve.spec_ngram)
                # A replay seeds the proposer with its whole replayed
                # prefix; the final chunk extends the re-sampled last.
                prop.extend(req.prefill_tokens)
                self._proposers[req.rid] = prop
            if self._slo_metrics and req.cached_prompt_tokens:
                registry().counter("serve_prefill_tokens_saved").inc(
                    req.cached_prompt_tokens)
            self._record_queue_wait(req)
        # Queue-bound trim after admission (work-conserving), so the
        # arrived backlog leaves every iteration within max_queue.
        for req in self.sched.overflow(now):
            self._shed(req, "queue-full", now)
        for req in self.sched.prefilling():
            self._prefill_chunk(req, t0)
            progress = True
        decoding = self.sched.decoding()
        if decoding:
            self._decode_round(decoding, t0)
            progress = True
        occ = self.cache.occupancy
        self._occupancy.append(occ)
        if bo is not None:
            bo.observe_occupancy(occ)
            transition = bo.tick(now)
            if transition is not None:
                if self.telemetry is not None:
                    self.telemetry.record(
                        "brownout", policy=self.serve.policy,
                        **transition, **self._trace_fields)
                if self._slo_metrics and self.replica is None:
                    registry().gauge("serve_brownout_level").set(bo.level)
        # Fleet replicas leave the process-global gauges to the fleet.
        if self._slo_metrics and self.replica is None:
            reg = registry()
            reg.gauge("serve_page_occupancy").set(occ)
            if self.serve.prefix_cache:
                reg.gauge("serve_shared_pages").set(self.cache.shared_pages)
                if self.cache_hit_rate is not None:
                    reg.gauge("serve_cache_hit_rate").set(
                        self.cache_hit_rate)
            if self.serve.spec_k and self.draft_accept_rate is not None:
                reg.gauge("serve_draft_accept_rate").set(
                    self.draft_accept_rate)
        return progress

    # -- prefill ------------------------------------------------------------

    def _prefill_chunk(self, req: Request, t0: float) -> None:
        with span("prefill_chunk", request=req.rid,
                  cursor=req.prefill_cursor):
            self._prefill_chunk_inner(req, t0)

    def _prefill_chunk_inner(self, req: Request, t0: float) -> None:
        chunk = self.serve.prefill_chunk
        # A journal replay prefills prompt + committed tokens minus the
        # last, which the final chunk re-samples.
        seq = req.prefill_tokens
        replaying = req.replay and bool(req.generated)
        lo = req.prefill_cursor
        n_valid = min(chunk, len(seq) - lo)
        toks = np.zeros((1, chunk), np.int64)
        toks[0, :n_valid] = seq[lo:lo + n_valid]
        m = self.meter
        d0 = time.monotonic() if m is not None else 0.0
        final = lo + n_valid == len(seq)
        tok = self._prefill(self.params, self.cache.ck, self.cache.cv,
                            toks, lo, n_valid, self._tables_np[req.slot],
                            req.seed)
        if final:
            first = int(tok[0])       # the read-back waits for the chunk
        if m is not None:
            # A prefill chunk owns the whole step: its wall bills to the
            # one request.
            m.bill_prefill(req.rid, time.monotonic() - d0)
        req.prefill_cursor = lo + n_valid
        if not final:
            self._rtrace(req, "prefill", cursor=req.prefill_cursor,
                         tokens=n_valid)
            return
        # Final chunk: its token is the request's first generated token —
        # or, on a replay, the last journaled token re-sampled, which the
        # determinism contract makes identical and which is checked.
        if replaying:
            want = req.generated[-1]
            if first != want:
                raise AssertionError(
                    f"journal replay diverged for {req.rid!r}: "
                    f"re-sampled token {first} != journaled {want} "
                    f"at position {len(seq)} — the determinism "
                    f"contract (tokens = f(prompt, seed)) is broken")
        else:
            req.generated.append(first)
            if self.journal is not None:
                self.journal.commit(req.rid, (first,))
        req.replay = False
        if req.t_first_token is None:
            req.t_first_token = self._clock() - t0
            self._record_ttft(req)
        req.state = RequestState.DECODE
        self._rtrace(req, "prefill", cursor=req.prefill_cursor,
                     tokens=n_valid, ttft_s=self._ttft(req),
                     **({"replayed": len(req.generated)}
                        if replaying else {}))
        # Every prefilled position's K/V is written: offer the pages to
        # the tree, so the next request with this prefix admits warm.
        self.cache.insert_prefix(req.rid, seq)
        prop = self._proposers.get(req.rid)
        if prop is not None:
            self._shadow_score(req, first)
            prop.extend([first])
        if self._finished(req, first):
            self._complete(req, t0)

    # -- decode -------------------------------------------------------------

    def _decode_round(self, decoding: list[Request], t0: float) -> None:
        # Brownout level >= 1 turns the verify windows off: the
        # single-token step commits the same tokens.
        spec = bool(self._verify) and (self.brownout is None
                                       or self.brownout.spec_enabled)
        with span("decode_round", batch=len(decoding), spec=spec):
            if spec:
                self._spec_round(decoding, t0)
            else:
                self._decode_round_plain(decoding, t0)

    def _decode_round_plain(self, decoding: list[Request],
                            t0: float) -> None:
        b = self.serve.n_slots
        tokens = np.zeros((b,), np.int64)
        positions = np.zeros((b,), np.int64)
        active = np.zeros((b,), bool)
        seeds = np.zeros((b,), np.int64)
        for req in decoding:
            s = req.slot
            tokens[s] = req.generated[-1]
            positions[s] = req.prompt_len + len(req.generated) - 1
            active[s] = True
            seeds[s] = req.seed
        m = self.meter
        d0 = time.monotonic() if m is not None else 0.0
        nxt = self._decode(self.params, self.cache.ck, self.cache.cv,
                           tokens, positions, self._tables_np, active,
                           seeds).tolist()
        if m is not None:
            # The round's wall (enqueue + read-back) in equal shares.
            m.bill_decode([r.rid for r in decoding],
                          time.monotonic() - d0)
        self._decode_steps += 1
        self._decode_tokens += len(decoding)
        gauges = (memory_gauges(self.cache) if self.telemetry is not None
                  else None)
        for req in decoding:
            tok = int(nxt[req.slot])
            req.generated.append(tok)
            if self.journal is not None:
                # The exact commit point: the journal never sees a token
                # the model did not choose.
                self.journal.commit(req.rid, (tok,))
            if gauges is not None:
                self._rtrace(req, "decode", new_tokens=1, **gauges)
            if self._finished(req, tok):
                self._complete(req, t0)
            else:
                # Draft-less rounds of a spec engine: score the shadow
                # prediction, then feed the proposer the committed token.
                prop = self._proposers.get(req.rid)
                if prop is not None:
                    self._shadow_score(req, tok)
                    prop.extend([tok])

    def _spec_round(self, decoding: list[Request], t0: float) -> None:
        """One speculative round: every active slot verifies its draft in
        one fixed-width forward and commits between 1 and ``width`` tokens.

        ``out[s, i]`` is the model's token for the position after window
        index ``i``; it is committed only while every draft before it
        matched the model's own choice, so the committed stream is the
        sequential decode stream. A rejected draft leaves K/V only at
        positions at or past the next round's window start, and every
        round rewrites its window before reading it; the last committed
        token's slot is the one that may still hold a rejected write, so
        completion trims it before offering pages to the tree."""
        b = self.serve.n_slots
        cap = self.serve.spec_k + 1
        proposals: dict[str, list[int]] = {}
        for req in decoding:
            remaining = req.max_new_tokens - len(req.generated)
            if remaining > 1 and self._spec_live.get(req.rid):
                proposals[req.rid] = self._proposers[req.rid].propose()[
                    :min(cap, remaining) - 1]
            else:
                proposals[req.rid] = []      # shadow mode: prove it first
        longest = max((len(d) for d in proposals.values()), default=0)
        if longest == 0:
            # No row drafted: the single-token step commits the same tokens.
            self._decode_round_plain(decoding, t0)
            return
        width = next(w for w in self._verify_widths if w >= longest + 1)
        tokens = np.zeros((b, width), np.int64)
        positions = np.zeros((b,), np.int64)
        # Idle rows keep n_valid 1 (their writes are dropped as inactive).
        n_valid = np.ones((b,), np.int64)
        active = np.zeros((b,), bool)
        seeds = np.zeros((b,), np.int64)
        drafts: dict[str, list[int]] = {}
        for req in decoding:
            s = req.slot
            w = min(width, req.max_new_tokens - len(req.generated))
            draft = proposals[req.rid][:w - 1]
            drafts[req.rid] = draft
            tokens[s, 0] = req.generated[-1]
            tokens[s, 1:1 + len(draft)] = draft
            positions[s] = req.prompt_len + len(req.generated) - 1
            n_valid[s] = w
            active[s] = True
            seeds[s] = req.seed
        m = self.meter
        d0 = time.monotonic() if m is not None else 0.0
        out = self._verify[width](self.params, self.cache.ck, self.cache.cv,
                                  tokens, positions, n_valid,
                                  self._tables_np, active, seeds).tolist()
        if m is not None:
            m.bill_decode([r.rid for r in decoding],
                          time.monotonic() - d0)
        self._decode_steps += 1
        round_proposed = round_accepted = 0
        gauges = (memory_gauges(self.cache) if self.telemetry is not None
                  else None)
        for req in decoding:
            s = req.slot
            draft = drafts[req.rid]
            emitted: list[int] = []
            for i in range(int(n_valid[s])):
                if i > 0 and tokens[s, i] != out[s][i - 1]:
                    break                      # draft i - 1 rejected
                tok = int(out[s][i])
                emitted.append(tok)
                if (self.serve.eos_id is not None
                        and tok == self.serve.eos_id):
                    break
            req.generated.extend(emitted)
            if self.journal is not None:
                # Only the model-verified prefix reaches ``generated``, so
                # the watermark never passes what the model committed.
                self.journal.commit(req.rid, emitted)
            self._decode_tokens += len(emitted)
            # Accept accounting over real proposals only.
            accepted = max(0, min(len(emitted) - 1, len(draft)))
            round_proposed += len(draft)
            round_accepted += accepted
            if draft:
                if accepted == 0:
                    self._spec_live[req.rid] = False
                    self._spec_streak[req.rid] = 0
            else:
                self._shadow_score(req, emitted[0])
            if gauges is not None:
                self._rtrace(req, "decode", new_tokens=len(emitted),
                             spec_proposed=len(draft),
                             spec_accepted=accepted, **gauges)
            if self._finished(req, emitted[-1]):
                self._complete(req, t0)
            else:
                self._proposers[req.rid].extend(emitted)
        self._draft_proposed += round_proposed
        self._draft_accepted += round_accepted
        if self._slo_metrics and round_proposed:
            reg = registry()
            reg.counter("serve_draft_tokens_proposed").inc(round_proposed)
            reg.counter("serve_draft_tokens_accepted").inc(round_accepted)

    def _shadow_score(self, req: Request, committed: int) -> None:
        """Score the proposer's one-token prediction against the committed
        token (before the proposer sees it): two hits in a row send the
        request live."""
        pred = self._proposers[req.rid].predict_next()
        if pred is not None and pred == committed:
            streak = self._spec_streak.get(req.rid, 0) + 1
            self._spec_streak[req.rid] = streak
            if streak >= 2:
                self._spec_live[req.rid] = True
        else:
            self._spec_streak[req.rid] = 0

    def _forget_spec(self, req: Request) -> None:
        self._proposers.pop(req.rid, None)
        self._spec_streak.pop(req.rid, None)
        self._spec_live.pop(req.rid, None)

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.generated) >= req.max_new_tokens
                or (self.serve.eos_id is not None
                    and tok == self.serve.eos_id))

    # -- lifecycle ----------------------------------------------------------

    def _complete(self, req: Request, t0: float) -> None:
        req.t_done = self._clock() - t0
        req.state = RequestState.COMPLETED
        if self.journal is not None:
            # Durable terminal before the engine forgets the request
            # (dedup'd by rid: a replayed request re-completing is a no-op).
            self.journal.terminal(req.rid, "completed")
        # Offer the committed sequence to the tree before eviction drops
        # this request's references (a multi-turn follow-up admits warm).
        # The last token is trimmed: its slot is unwritten (decode feeds a
        # token back before writing it) or may hold a rejected draft's.
        self.cache.insert_prefix(req.rid,
                                 (req.prompt + req.generated)[:-1])
        self._forget_spec(req)
        if self.meter is not None:
            # Close the bill before eviction drops the page table.
            self.meter.terminal(
                req, "completed", self.telemetry,
                good_tokens=(len(req.generated)
                             if self._in_deadline(req) else 0))
        self.sched.evict(req)
        if self.brownout is not None:
            self.brownout.observe_completed(self._ttft(req), req.t_done)
        token_s = None
        if len(req.generated) > 1 and req.t_first_token is not None:
            token_s = ((req.t_done - req.t_first_token)
                       / (len(req.generated) - 1))
        if self._slo_metrics:
            reg = registry()
            reg.counter("serve_requests_completed").inc()
            reg.counter("serve_tokens_generated").inc(len(req.generated))
            if token_s is not None:
                reg.histogram("serve_token_latency_s").observe(
                    token_s, exemplar=req.trace_id)
        self._rtrace(req, "completed", new_tokens=len(req.generated),
                     ttft_s=self._ttft(req),
                     queue_wait_s=self._queue_wait(req),
                     token_latency_s=token_s,
                     wall_s=req.t_done - req.arrival_s)
        if self.telemetry is not None:
            self.telemetry.record(
                "serve", event="completed", request=req.rid,
                policy=self.serve.policy,
                prompt_tokens=req.prompt_len,
                new_tokens=len(req.generated),
                queue_wait_s=self._queue_wait(req),
                ttft_s=self._ttft(req), token_latency_s=token_s,
                wall_s=req.t_done - req.arrival_s,
                **({"replica": self.replica, "migrations": req.migrations}
                   if self.replica is not None else {}))

    def _shed(self, req: Request, reason: str, now: float) -> None:
        """Shed one request with a typed record: a queued expiry (the
        scheduler already dequeued it) or an in-flight deadline abort,
        which evicts mid-stream and returns every reserved page at once.
        Terminal, counted, never silent."""
        state_at = req.state.value
        expired = reason in ("total-deadline", "queue-deadline")
        if self.meter is not None:
            self.meter.terminal(req, "expired" if expired else "shed",
                                self.telemetry)
        if req.slot is not None:
            self.sched.evict(req)
        self._forget_spec(req)
        req.state = RequestState.FAILED
        req.shed_reason = reason
        req.error = f"shed: {reason}"
        if self.journal is not None:
            self.journal.terminal(req.rid, "shed")
        self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + 1
        if reason == "queue-full":
            self._rejected += 1
        if self._slo_metrics:
            registry().counter("serve_shed_total").inc()
            if reason == "queue-full":
                registry().counter("serve_rejected_total").inc()
        waited = round(max(0.0, now - req.arrival_s), 4)
        self._rtrace(req, "expired" if expired else "shed", reason=reason,
                     state=state_at, waited_s=waited)
        if self.telemetry is not None:
            self.telemetry.record(
                "shed", request=req.rid, reason=reason,
                priority=req.priority, state=state_at,
                policy=self.serve.policy, waited_s=waited,
                prompt_tokens=req.prompt_len,
                new_tokens=len(req.generated), **self._trace_fields)

    def _fail_inflight(self, detail: str) -> None:
        for req in self._requests:
            if req.done:
                continue
            if self.meter is not None:
                self.meter.terminal(req, "failed", self.telemetry)
            if req.slot is not None:
                self.sched.evict(req)
            elif any(q is req for q in self.sched.queue):
                self.sched.queue = deque(
                    q for q in self.sched.queue if q is not req)
            self._forget_spec(req)
            req.state = RequestState.FAILED
            req.error = f"engine-killed: {detail}"
            if self.journal is not None:
                # A typed failure is reported to the client, so it is a
                # real terminal; a hard crash (``kill``) never runs this.
                self.journal.terminal(req.rid, "failed")
            self._rtrace(req, "failed", error="engine-killed")
            if self._slo_metrics:
                registry().counter("serve_requests_failed").inc()
            if self.telemetry is not None:
                self.telemetry.record(
                    "serve", event="failed", request=req.rid,
                    policy=self.serve.policy,
                    error="engine-killed", detail=detail,
                    prompt_tokens=req.prompt_len,
                    new_tokens=len(req.generated), **self._trace_fields)

    # -- SLO bookkeeping ----------------------------------------------------

    def _queue_wait(self, req: Request) -> float | None:
        if req.t_admitted is None:
            return None
        return max(0.0, req.t_admitted - req.arrival_s)

    def _ttft(self, req: Request) -> float | None:
        if req.t_first_token is None:
            return None
        return max(0.0, req.t_first_token - req.arrival_s)

    def _record_queue_wait(self, req: Request) -> None:
        w = self._queue_wait(req)
        if w is not None and self._slo_metrics:
            registry().histogram("serve_queue_wait_s").observe(
                w, exemplar=req.trace_id)

    def _record_ttft(self, req: Request) -> None:
        t = self._ttft(req)
        if t is not None and self._slo_metrics:
            registry().histogram("serve_ttft_s").observe(
                t, exemplar=req.trace_id)

    def _in_deadline(self, req: Request) -> bool:
        """Did this completed request land within its total deadline?
        (True with no deadline: goodput then equals throughput.)"""
        dl = (req.deadline_s if req.deadline_s is not None
              else self.serve.deadline_s)
        if dl is None or req.t_done is None:
            return True
        return req.t_done - req.arrival_s <= dl

    # -- results ------------------------------------------------------------

    def results(self) -> list[Request]:
        return list(self._requests)

    def summary(self, *, record: bool = True) -> dict:
        """Throughput, SLO and overload view over every request run so far
        (and the ``serve`` summary record when a stream is attached and
        ``record``)."""
        completed = [r for r in self._requests
                     if r.state is RequestState.COMPLETED]
        # Typed sheds are the overload controls working; a failure is
        # something breaking.
        shed = [r for r in self._requests
                if r.state is RequestState.FAILED and r.shed_reason]
        failed = [r for r in self._requests
                  if r.state is RequestState.FAILED and not r.shed_reason]
        tokens = sum(len(r.generated) for r in completed)
        goodput_tokens = sum(len(r.generated) for r in completed
                             if self._in_deadline(r))
        token_lat = [
            (r.t_done - r.t_first_token) / (len(r.generated) - 1)
            for r in completed
            if len(r.generated) > 1 and r.t_first_token is not None]
        out = {
            "policy": self.serve.policy,
            "n_slots": self.serve.n_slots,
            "requests_completed": len(completed),
            "requests_failed": len(failed),
            "requests_shed": len(shed),
            "requests_rejected": self._rejected,
            "shed_by_reason": dict(sorted(self._shed_by_reason.items())),
            "goodput_tokens": goodput_tokens,
            "goodput_tokens_per_s": (goodput_tokens / self._wall_s
                                     if self._wall_s > 0 else None),
            "brownout": (self.brownout.summary()
                         if self.brownout is not None else None),
            "tokens_generated": tokens,
            "wall_s": self._wall_s,
            "tokens_per_s": (tokens / self._wall_s if self._wall_s > 0
                             else None),
            "iterations": self._iterations,
            "decode_steps": self._decode_steps,
            # Useful tokens per decode round over the batch width — the
            # timing-free continuous-vs-static comparison (over 1.0 under
            # speculative decoding: tokens a round).
            "slot_utilization": (
                self._decode_tokens
                / (self._decode_steps * self.serve.n_slots)
                if self._decode_steps else None),
            "prefix_cache": self.serve.prefix_cache,
            "spec_k": self.serve.spec_k,
            "cache_hit_rate": self.cache_hit_rate,
            "prefill_tokens_saved": self._cached_tokens,
            "shared_pages": self.cache.shared_pages,
            "cached_prefix_pages": (len(self.cache.prefix)
                                    if self.cache.prefix is not None
                                    else 0),
            "prefix_evictions": (self.cache.prefix.evictions
                                 if self.cache.prefix is not None else 0),
            "draft_accept_rate": self.draft_accept_rate,
            "draft_tokens_proposed": self._draft_proposed,
            "draft_tokens_accepted": self._draft_accepted,
            "ttft_s": summarize(
                [t for t in (self._ttft(r) for r in completed)
                 if t is not None]),
            "queue_wait_s": summarize(
                [w for w in (self._queue_wait(r) for r in completed)
                 if w is not None]),
            "token_latency_s": summarize(token_lat),
            "page_occupancy": summarize(self._occupancy),
            # Real per-iteration wall time, whatever the clock.
            "iteration_s": summarize(self._iter_s),
            "metering": (self.meter.summary()
                         if self.meter is not None else None),
        }
        if record and self.telemetry is not None:
            self.telemetry.record("serve", event="summary", **out)
            if self.meter is not None and self.replica is None:
                self.meter.record_utilization(self.telemetry)
        return out
