"""Paged KV cache: a device page pool + host-side page tables.

Counterpart of ``distributed_model_parallel_tpu/serve/paged_kv.py``,
without the prefix tree and request migration (later slices). The cache
is a pool of fixed-size pages — ``[L, n_pages, page_size, Hkv, Dh]`` per
K and V on the device — and each sequence owns exactly
``ceil(len / page_size)`` pages, recorded in a host-side page table.
Pages return to the free list the moment a sequence finishes.

Allocation is deterministic (FIFO free list): the same submit/finish
order gives the same physical placement. Pages are not cleared on free:
the attention read masks past-length positions to exact 0, so stale
contents are unreachable by construction.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.models.transformer import (
    resolve_device,
)


class PagePoolError(RuntimeError):
    """A page-accounting invariant was violated (double alloc/free) or an
    allocation exceeded capacity that admission should have checked."""


class PagePool:
    """Host-side refcounting allocator over ``n_pages`` physical ids.

    ``alloc`` hands out pages at refcount 1 in FIFO order; ``free`` drops
    one reference per page and returns it to the free list at refcount
    0. ``alloc`` raises :class:`PagePoolError` rather than over-commit —
    the scheduler checks ``free_pages`` first, so a raise is a scheduler
    bug, not backpressure.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {n_pages}")
        self.n_pages = n_pages
        self._free: deque[int] = deque(range(n_pages))
        self._refs: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._refs)

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
        return pages

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
    """

    def __init__(self, cfg, *, n_pages: int, page_size: int,
                 max_seq_len: int, device="cuda"):
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

    def try_admit(self, sid, capacity: int) -> bool:
        """Reserve ``capacity`` positions for ``sid`` when the pool holds
        them (reservation is allocation); ``False``, with no side effect,
        when the request must keep queuing."""
        if self.pages_needed(capacity) > self.pool.free_pages:
            return False
        self.open(sid)
        self.ensure(sid, capacity)
        return True

    def release(self, sid) -> None:
        """Return every page of ``sid``'s table (eviction/completion)."""
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
