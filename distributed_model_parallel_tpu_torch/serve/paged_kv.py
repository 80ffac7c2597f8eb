"""Paged KV cache: a device page pool + host-side page tables.

Counterpart of ``distributed_model_parallel_tpu/serve/paged_kv.py``. The
cache is a pool of fixed-size pages —
``[L, n_pages, page_size, Hkv, Dh]`` per K and V on the device — and each
sequence owns exactly ``ceil(len / page_size)`` pages, recorded in a
host-side page table. Pages return to the free list the moment their
last holder lets go.

Pages are **refcounted** for prefix sharing (``serve/prefix_cache.py``):
a page written once for a token prefix backs every sequence whose prompt
starts with those tokens, each holder taking a reference. A sharer's own
writes always land past the shared prefix, in fresh pages, so a shared
page is never written twice and nothing is ever copied.

Allocation is deterministic (FIFO free list): the same submit/finish
order gives the same physical placement. Pages are not cleared on free:
the attention read masks past-length positions to exact 0, so stale
contents are unreachable by construction.

Live migration moves a request's written K/V **by value**:
:meth:`PagedKVCache.export_request` copies its pages to host tensors of
the pool's own dtype (``bf16`` has no numpy dtype, so the payload stays
a torch tensor) and :meth:`PagedKVCache.import_request` writes them into
fresh pages of another pool.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.models.transformer import (
    resolve_device,
)
from distributed_model_parallel_tpu_torch.utils import tracing


class PagePoolError(RuntimeError):
    """A page-accounting invariant was violated (double alloc/free) or an
    allocation exceeded capacity that admission should have checked."""


class PagePool:
    """Host-side refcounting allocator over ``n_pages`` physical ids.

    ``alloc`` hands out pages at refcount 1 in FIFO order; ``retain`` adds
    a reference (a sharer joining); ``free`` drops one reference per page
    and returns it to the free list at refcount 0. ``alloc`` raises
    :class:`PagePoolError` rather than over-commit — the scheduler checks
    ``free_pages`` first, so a raise is a scheduler bug, not backpressure.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {n_pages}")
        self.n_pages = n_pages
        self._free: deque[int] = deque(range(n_pages))
        self._refs: dict[int, int] = {}
        # Low-water mark of the free list over the pool's lifetime.
        self.free_watermark = n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._refs)

    @property
    def shared_pages(self) -> int:
        """Pages held by more than one reference."""
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"alloc count must be >= 0, got {n}")
        if n > len(self._free):
            raise PagePoolError(
                f"allocation of {n} pages exceeds the {len(self._free)} "
                f"free (of {self.n_pages}); admission must queue, not "
                f"over-commit")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.free_watermark = min(self.free_watermark, len(self._free))
        return pages

    def retain(self, pages: list[int]) -> None:
        """Add one reference to each allocated page (a sharer joining)."""
        for p in pages:
            if p not in self._refs:
                raise PagePoolError(
                    f"retaining page {p} that is not allocated")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise PagePoolError(
                    f"freeing page {p} that is not allocated (double "
                    f"free, or a page the pool never handed out)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


class PagedKVCache:
    """Device page pools + per-sequence page tables for one model.

    ``ck``/``cv``: [L, n_pages, page_size, Hkv, Dh] tensors on ``device``.
    The prefill/decode steps (serve/model.py) write them **in place**
    (``index_put_``); the JAX package threads immutable arrays through
    donating jitted calls instead. The page table of sequence ``sid``
    maps logical page ``i`` (tokens [i*page, (i+1)*page)) to a physical
    pool page; :meth:`table_array` pads it with id 0 — padded entries are
    masked by length in the attention read.

    ``prefix_cache=True`` keeps a radix tree over token prefixes
    (``serve/prefix_cache.py``): finished prefixes stay resident under the
    tree's reference, a new sequence whose prompt matches admits holding
    the cached pages, and the tree is evicted LRU-leaf-first when
    admission needs the room. ``share_granularity`` (tokens, a multiple of
    ``page_size``) quantizes how much prefix a sharer may reuse: the engine
    passes ``lcm(page_size, prefill_chunk)``, so a cache-hit request's
    remaining prefill chunks are the cold run's chunks at the same
    positions.
    """

    def __init__(self, cfg, *, n_pages: int, page_size: int,
                 max_seq_len: int, prefix_cache: bool = False,
                 share_granularity: int | None = None, device="cuda"):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_seq_len < 1:
            raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
        self.cfg = cfg
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.pages_per_seq = -(-max_seq_len // page_size)
        self.pool = PagePool(n_pages)
        self._tables: dict[object, list[int]] = {}
        if share_granularity is None:
            share_granularity = page_size
        if share_granularity % page_size != 0:
            raise ValueError(
                f"share_granularity {share_granularity} must be a "
                f"multiple of page_size {page_size}")
        self.share_granularity = share_granularity
        if prefix_cache:
            from distributed_model_parallel_tpu_torch.serve.prefix_cache import (
                PrefixCache,
            )

            self.prefix = PrefixCache(self.pool, page_size)
        else:
            self.prefix = None
        shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads,
                 cfg.head_dim)
        dev = resolve_device(device)
        self.ck = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.cv = torch.zeros_like(self.ck)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def open(self, sid) -> None:
        if sid in self._tables:
            raise PagePoolError(f"sequence {sid!r} is already open")
        self._tables[sid] = []

    def ensure(self, sid, n_tokens: int) -> None:
        """Grow ``sid``'s table to cover ``n_tokens`` positions."""
        if n_tokens > self.max_seq_len:
            raise PagePoolError(
                f"sequence {sid!r} wants {n_tokens} tokens > max_seq_len "
                f"{self.max_seq_len}")
        table = self._tables[sid]
        need = self.pages_needed(n_tokens) - len(table)
        if need > 0:
            table.extend(self.pool.alloc(need))

    def release(self, sid) -> None:
        """Drop ``sid``'s reference on every page of its table
        (eviction/completion); shared pages survive under the tree's or
        another sequence's reference."""
        self.pool.free(self._tables.pop(sid))

    def table_array(self, sid) -> np.ndarray:
        """[pages_per_seq] int32, padded with 0 (masked by length)."""
        table = self._tables[sid]
        out = np.zeros((self.pages_per_seq,), np.int32)
        out[:len(table)] = table
        return out

    @property
    def occupancy(self) -> float:
        return self.pool.used_pages / self.pool.n_pages

    # -- prefix sharing ------------------------------------------------------

    def _usable_prefix(self, tokens: list[int], matched_pages: int) -> int:
        """Tokens of a raw tree match a sharer may reuse: quantized down to
        ``share_granularity`` and capped at ``len(tokens) - 1`` (the last
        prompt token is always recomputed, so the last prefill chunk gives
        the first token's logits)."""
        g = self.share_granularity
        m = min(matched_pages * self.page_size, len(tokens) - 1)
        return max(0, (m // g) * g)

    def _admission(self, tokens: list[int],
                   capacity: int) -> tuple[int, list[int], int, int]:
        """One tree match and one evictable walk: ``(cached_tokens,
        shared_pages, fresh_pages, available_pages)``; the request fits
        iff ``fresh_pages <= available_pages``, available counting the
        free list and the tree pages evictable without touching the
        would-be-shared path."""
        cached = 0
        shared: list[int] = []
        if self.prefix is not None:
            pages = self.prefix.match(tokens, touch=False)
            cached = self._usable_prefix(tokens, len(pages))
            shared = pages[:cached // self.page_size]
        fresh = self.pages_needed(capacity) - len(shared)
        avail = self.pool.free_pages
        if self.prefix is not None:
            avail += self.prefix.evictable_pages(exclude=set(shared))
        return cached, shared, fresh, avail

    def peek_admission(self, tokens: list[int],
                       capacity: int) -> tuple[int, int, int]:
        """Side-effect-free admission bill: ``(cached_tokens, fresh_pages,
        available_pages)``."""
        cached, _, fresh, avail = self._admission(tokens, capacity)
        return cached, fresh, avail

    def try_admit(self, sid, tokens: list[int], capacity: int) -> int | None:
        """Admission in one pass: when the post-sharing bill fits, open
        ``sid`` holding the cached prefix, evict tree-only pages if the
        fresh part needs the room, and allocate the rest of the
        ``capacity`` reservation (reservation is allocation). Returns the
        cached token count, or ``None``, with no side effect, when the
        request must keep queuing."""
        cached, shared, fresh, avail = self._admission(tokens, capacity)
        if fresh > avail:
            return None
        self.open(sid)
        if shared:
            self.prefix.touch_path(tokens, len(shared))
            self.pool.retain(shared)
            self._tables[sid].extend(shared)
        short = (self.pages_needed(capacity) - len(self._tables[sid])
                 - self.pool.free_pages)
        if short > 0:
            self.prefix.evict(short)
        self.ensure(sid, capacity)
        return cached

    def admit_with_prefix(self, sid, tokens: list[int],
                          capacity: int) -> int:
        """:meth:`try_admit` for callers that checked the fit: no room here
        raises (an accounting bug, not backpressure)."""
        got = self.try_admit(sid, tokens, capacity)
        if got is None:
            _, fresh, avail = self.peek_admission(tokens, capacity)
            raise PagePoolError(
                f"sequence {sid!r} needs {fresh} fresh pages but only "
                f"{avail} are free or evictable; admission must queue")
        return got

    def insert_prefix(self, sid, tokens: list[int]) -> int:
        """Offer ``sid``'s pages for the fully written prefix ``tokens`` to
        the tree (no-op without a prefix cache); only full pages enter, and
        the tree retains each page it adopts. Callers pass only positions
        whose K/V is written — under speculative decoding the last
        committed token's slot may hold a rejected draft's, so the engine
        trims it. Returns the pages newly adopted."""
        if self.prefix is None:
            return 0
        return self.prefix.insert(tokens, self._tables[sid])

    @property
    def evictable_pages(self) -> int:
        if self.prefix is None:
            return 0
        return self.prefix.evictable_pages()

    def page_share(self, sid) -> float:
        """``sid``'s fractional share of the pool: one per exclusive page,
        ``1/refcount`` per shared one; 0.0 for an unknown sid."""
        table = self._tables.get(sid)
        if not table:
            return 0.0
        refcount = self.pool.refcount
        return sum(1.0 / c for p in table if (c := refcount(p)) > 0)

    @property
    def shared_pages(self) -> int:
        return self.pool.shared_pages

    # -- live request migration (Engine.drain) -----------------------------

    def export_request(self, sid, n_tokens: int, *, req=None, sink=None,
                       trace_fields=None):
        """Copy the K/V **contents** of ``sid``'s first ``n_tokens``
        written positions to host tensors ``(k, v)`` of shape
        ``[L, pages, page_size, Hkv, Dh]`` in the pool's dtype — whole
        pages, values only. Shared prefix pages are exported by value
        like any other, so the payload holds no reference to this pool.
        The caller guarantees every exported position is written (the
        engine's drain passes the committed-and-written prefix). A traced
        ``req`` (and its stream ``sink``) gets an ``export`` rtrace."""
        table = self._tables[sid]
        n = self.pages_needed(n_tokens)
        if n > len(table):
            raise PagePoolError(
                f"sequence {sid!r}: exporting {n_tokens} tokens spans "
                f"{n} pages but the table holds {len(table)}")
        idx = torch.as_tensor(table[:n], dtype=torch.long,
                              device=self.ck.device)
        # One gather and one copy to the host per pool.
        k = self.ck.index_select(1, idx).cpu()
        v = self.cv.index_select(1, idx).cpu()
        if req is not None:
            tracing.rtrace(req, "export", sink=sink, pages=n,
                           n_tokens=n_tokens, **(trace_fields or {}))
        return k, v

    def import_request(self, sid, k, v, capacity: int, *,
                       req=None, sink=None, trace_fields=None) -> bool:
        """Admit a migrated sequence: reserve ``capacity`` positions of
        **fresh** pages (evicting tree-only pages if the room is needed —
        the exported K/V is authoritative, so nothing is shared on
        arrival) and write the exported page contents into them. Returns
        ``False`` without side effects when the reservation does not fit
        (the scheduler keeps the request queued, as for a cold admission
        that finds no pages). A traced ``req``/``sink`` records an
        ``import`` rtrace on success only."""
        need = self.pages_needed(capacity)
        avail = self.pool.free_pages
        if self.prefix is not None:
            avail += self.prefix.evictable_pages()
        if need > avail:
            return False
        n = int(k.shape[1])
        if n > need:
            raise PagePoolError(
                f"sequence {sid!r}: payload carries {n} pages but the "
                f"reservation is only {need}")
        self.open(sid)
        short = need - self.pool.free_pages
        if short > 0:
            self.prefix.evict(short)
        self.ensure(sid, capacity)
        if n:
            idx = torch.as_tensor(self._tables[sid][:n], dtype=torch.long,
                                  device=self.ck.device)
            self.ck.index_copy_(1, idx, k.to(self.ck.device, self.ck.dtype))
            self.cv.index_copy_(1, idx, v.to(self.cv.device, self.cv.dtype))
        if req is not None:
            tracing.rtrace(req, "import", sink=sink, pages=n,
                           **(trace_fields or {}))
        return True

    def cached_prefix_tokens(self, tokens: list[int]) -> int:
        """Usable cached-prefix length of ``tokens`` (side-effect free; 0
        without a cache)."""
        if self.prefix is None:
            return 0
        pages = self.prefix.match(tokens, touch=False)
        return self._usable_prefix(tokens, len(pages))

    def drop_prefix(self) -> int:
        """Evict the whole tree; pages a resident sequence still holds
        survive. Returns the pages freed."""
        if self.prefix is None:
            return 0
        return len(self.prefix.evict(len(self.prefix)))


def memory_gauges(cache: PagedKVCache) -> dict:
    """The pool's memory-pressure snapshot: occupancy, free and used page
    counts, pages under the prefix tree, and the free list's low-water
    mark."""
    return {
        "occupancy": cache.occupancy,
        "free_pages": cache.pool.free_pages,
        "used_pages": cache.pool.used_pages,
        "prefix_pages": len(cache.prefix) if cache.prefix is not None else 0,
        "free_watermark": cache.pool.free_watermark,
    }


def share_granularity_for(page_size: int, prefill_chunk: int) -> int:
    """The engine's prefix-share quantum: a shared prefix ends on a page
    boundary (pages are the sharing unit) and on a prefill-chunk boundary
    (so the cold and cached runs prefill the same suffix chunks at the
    same positions)."""
    return math.lcm(page_size, prefill_chunk)
