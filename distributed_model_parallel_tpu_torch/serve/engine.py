"""The serving engine loop: continuous batching over the paged KV cache.

Counterpart of ``distributed_model_parallel_tpu/serve/engine.py``
(without the overload controls — priorities, queue and total deadlines,
``max_queue``, withdraw, shedding and rejection — and without the
journal, metering, brownout, status exporter, telemetry and tracing
planes and the fleet's migration: later slices). One iteration = admit
-> prefill (a bounded number of chunks, interleaved so long prompts never
stall the resident batch) -> one decode round for every active slot ->
evict finished sequences (their slot and pages are reusable the next
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

A killed engine never drops requests silently: every in-flight and
queued request is marked failed with a typed error before the exception
propagates as :class:`EngineKilled`.
"""

from __future__ import annotations

import dataclasses
import time

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
from distributed_model_parallel_tpu_torch.serve.paged_kv import (
    PagedKVCache,
    PagePoolError,
    share_granularity_for,
)
from distributed_model_parallel_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
    Scheduler,
    summarize,
)
from distributed_model_parallel_tpu_torch.serve.spec import NGramProposer


class EngineKilled(RuntimeError):
    """The engine loop died mid-stream; every in-flight request has been
    marked failed (typed) before this propagated."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine geometry + sampling policy.

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


class Engine:
    """Continuous-batching decode engine over one model on ``device``.

    ``step_hook(iteration)`` (tests, chaos drills) runs once per loop
    iteration; an exception it raises takes the typed-failure path like
    any other engine death.
    """

    def __init__(self, params: dict, cfg: TransformerConfig,
                 serve: ServeConfig, *, device="cuda", step_hook=None):
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
        self.step_hook = step_hook
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
                                   serve.prefill_chunks_per_iter))
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
        self._decode_steps = 0
        self._decode_tokens = 0       # useful tokens out of decode steps
        self._occupancy: list[float] = []
        self._wall_s = 0.0            # accumulates across run() calls
        # prefix-cache and speculative-decoding accounting
        self._prompt_tokens = 0       # prompt tokens of admitted requests
        self._cached_tokens = 0       # of those, served from the tree
        self._draft_proposed = 0
        self._draft_accepted = 0

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

    def clear_cache(self) -> int:
        """Drop the prefix tree and check that every page is back on the
        free list (call with nothing resident). Returns the tree pages
        freed."""
        freed = self.cache.drop_prefix()
        if self.cache.pool.used_pages:
            raise PagePoolError(
                f"engine: {self.cache.pool.used_pages} pages still held "
                f"after the prefix drop")
        return freed

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, rid: str | None = None,
               arrival_s: float = 0.0, seed: int = 0) -> Request:
        prompt = [int(t) for t in prompt]
        if rid is None:
            rid = f"req-{self._auto_rid}"
            self._auto_rid += 1
        bad = [t for t in prompt if not (0 <= t < self.cfg.vocab_size)]
        if bad:
            raise ValueError(f"prompt tokens {bad} outside vocab "
                             f"[0, {self.cfg.vocab_size})")
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      arrival_s=float(arrival_s), seed=int(seed))
        self.sched.submit(req)
        self._requests.append(req)
        return req

    # -- the loop -----------------------------------------------------------

    def run(self, *, max_iterations: int | None = None) -> dict:
        """Drive the loop until every submitted request is terminal (or
        ``max_iterations``). Returns :meth:`summary`."""
        t0 = time.monotonic()
        try:
            while not self.sched.idle():
                if (max_iterations is not None
                        and self._iterations >= max_iterations):
                    break
                now = time.monotonic() - t0
                if not self.step_once(now, t0):
                    nxt = self.sched.next_arrival()
                    if nxt is not None:
                        # Open loop: nothing resident and the next request
                        # has not arrived yet — wait for it.
                        time.sleep(max(0.0, min(nxt - now, 0.05)))
        except BaseException as e:
            self._fail_inflight(f"{type(e).__name__}: {e}")
            self._wall_s += time.monotonic() - t0
            if not isinstance(e, Exception):
                raise
            raise EngineKilled(
                f"engine died at iteration {self._iterations}; "
                f"in-flight requests marked failed") from e
        self._wall_s += time.monotonic() - t0
        return self.summary()

    def step_once(self, now: float, t0: float) -> bool:
        """One engine iteration at open-loop clock ``now`` (seconds since
        ``t0``). Returns whether any prefill or decode work ran."""
        if self.step_hook is not None:
            self.step_hook(self._iterations)
        self._iterations += 1
        return self._iterate(now, t0)

    def _iterate(self, now: float, t0: float) -> bool:
        progress = False
        for req in self.sched.admit(now):
            self._tables_np[req.slot] = self.cache.table_array(req.rid)
            # A cache hit's shared pages already hold the prefix's K/V:
            # prefill starts at the first uncached token.
            req.prefill_cursor = req.cached_prompt_tokens
            self._prompt_tokens += req.prompt_len
            self._cached_tokens += req.cached_prompt_tokens
            if self.serve.spec_k:
                prop = NGramProposer(self.serve.spec_k,
                                     max_order=self.serve.spec_ngram)
                prop.extend(req.prefill_tokens)
                self._proposers[req.rid] = prop
        for req in self.sched.prefilling():
            self._prefill_chunk(req, t0)
            progress = True
        decoding = self.sched.decoding()
        if decoding:
            self._decode_round(decoding, t0)
            progress = True
        self._occupancy.append(self.cache.occupancy)
        return progress

    def _prefill_chunk(self, req: Request, t0: float) -> None:
        chunk = self.serve.prefill_chunk
        lo = req.prefill_cursor
        n_valid = min(chunk, req.prompt_len - lo)
        toks = np.zeros((1, chunk), np.int64)
        toks[0, :n_valid] = req.prompt[lo:lo + n_valid]
        tok = self._prefill(self.params, self.cache.ck, self.cache.cv,
                            toks, lo, n_valid, self._tables_np[req.slot],
                            req.seed)
        req.prefill_cursor = lo + n_valid
        if req.prefill_cursor < req.prompt_len:
            return
        # Final chunk: its token is the request's first generated token.
        first = int(tok[0])
        req.generated.append(first)
        req.t_first_token = time.monotonic() - t0
        req.state = RequestState.DECODE
        # Every prompt position's K/V is written: offer the pages to the
        # tree, so the next request with this prefix admits warm.
        self.cache.insert_prefix(req.rid, req.prefill_tokens)
        prop = self._proposers.get(req.rid)
        if prop is not None:
            self._shadow_score(req, first)
            prop.extend([first])
        if self._finished(req, first):
            self._complete(req, t0)

    def _decode_round(self, decoding: list[Request], t0: float) -> None:
        if self._verify:
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
        nxt = self._decode(self.params, self.cache.ck, self.cache.cv,
                           tokens, positions, self._tables_np, active,
                           seeds).tolist()
        self._decode_steps += 1
        self._decode_tokens += len(decoding)
        for req in decoding:
            tok = int(nxt[req.slot])
            req.generated.append(tok)
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
        out = self._verify[width](self.params, self.cache.ck, self.cache.cv,
                                  tokens, positions, n_valid,
                                  self._tables_np, active, seeds).tolist()
        self._decode_steps += 1
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
            self._decode_tokens += len(emitted)
            # Accept accounting over real proposals only.
            accepted = max(0, min(len(emitted) - 1, len(draft)))
            self._draft_proposed += len(draft)
            self._draft_accepted += accepted
            if draft:
                if accepted == 0:
                    self._spec_live[req.rid] = False
                    self._spec_streak[req.rid] = 0
            else:
                self._shadow_score(req, emitted[0])
            if self._finished(req, emitted[-1]):
                self._complete(req, t0)
            else:
                self._proposers[req.rid].extend(emitted)

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

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.generated) >= req.max_new_tokens
                or (self.serve.eos_id is not None
                    and tok == self.serve.eos_id))

    # -- lifecycle ----------------------------------------------------------

    def _complete(self, req: Request, t0: float) -> None:
        req.t_done = time.monotonic() - t0
        req.state = RequestState.COMPLETED
        # Offer the committed sequence to the tree before eviction drops
        # this request's references (a multi-turn follow-up admits warm).
        # The last token is trimmed: its slot is unwritten (decode feeds a
        # token back before writing it) or may hold a rejected draft's.
        self.cache.insert_prefix(req.rid,
                                 (req.prompt + req.generated)[:-1])
        self._proposers.pop(req.rid, None)
        self._spec_streak.pop(req.rid, None)
        self._spec_live.pop(req.rid, None)
        self.sched.evict(req)

    def _fail_inflight(self, detail: str) -> None:
        for req in self._requests:
            if req.done:
                continue
            if req.slot is not None:
                self.sched.evict(req)
            elif any(q is req for q in self.sched.queue):
                self.sched.queue.remove(req)
            req.state = RequestState.FAILED
            req.error = f"engine-killed: {detail}"

    def summary(self) -> dict:
        """Throughput and SLO view over every request run so far."""
        completed = [r for r in self._requests
                     if r.state is RequestState.COMPLETED]
        failed = [r for r in self._requests
                  if r.state is RequestState.FAILED]
        tokens = sum(len(r.generated) for r in completed)
        token_lat = [
            (r.t_done - r.t_first_token) / (len(r.generated) - 1)
            for r in completed
            if len(r.generated) > 1 and r.t_first_token is not None]
        return {
            "policy": self.serve.policy,
            "n_slots": self.serve.n_slots,
            "requests_completed": len(completed),
            "requests_failed": len(failed),
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
            "ttft_s": summarize([max(0.0, r.t_first_token - r.arrival_s)
                                 for r in completed
                                 if r.t_first_token is not None]),
            "token_latency_s": summarize(token_lat),
            "page_occupancy": summarize(self._occupancy),
        }
