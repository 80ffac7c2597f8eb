"""Radix tree over token prefixes — the prefix-sharing index.

Counterpart of ``distributed_model_parallel_tpu/serve/prefix_cache.py``
(pure host code; the same operation sequence gives the same page ids,
evictions and admission bills in both packages). Automatic prefix
caching at **page granularity**: each tree node is one full page of
tokens (an edge label of ``page_size`` token ids) mapped to the physical
pool page holding that span's KV. A prompt's longest cached prefix is
the deepest path whose page-sized token chunks all match; the engine
retains those pages for the new sequence and prefills only the suffix.

The tree holds its own reference on every page it indexes
(``PagePool.retain``), so cached prefixes survive the sequences that
wrote them. When admission needs room, :meth:`evict` frees
**leaf-first, least-recently-matched** pages whose only remaining
reference is the tree's — a page some resident sequence still reads
(refcount > 1) is never evicted, and an interior node is evictable only
after its whole subtree is gone (children extend the parent's token
span; orphaning them would corrupt matching).

Everything here is deterministic: matching is exact token equality,
recency is a logical clock bumped per match (never wall time), and
eviction tie-breaks on insertion order — the same request sequence
always leaves the same tree.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _Node:
    page: int                        # physical pool page id
    last_used: int                   # logical clock of the last match
    seq: int                         # insertion order (eviction tie-break)
    key: tuple[int, ...] = ()        # edge label under the parent
    parent: "_Node | None" = None    # None at root level
    children: dict[tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)


class PrefixCache:
    """Page-granular radix tree over token prefixes (see module doc)."""

    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self._root: dict[tuple[int, ...], _Node] = {}
        self._clock = 0
        self._seq = 0
        self._pages = 0                  # nodes (== pages) in the tree
        # cumulative counters
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return self._pages

    def _keys(self, tokens: list[int]):
        """Full-page token chunks of ``tokens`` (the partial tail page is
        never indexable — its span isn't a complete edge label)."""
        p = self.page_size
        for i in range(len(tokens) // p):
            yield tuple(tokens[i * p:(i + 1) * p])

    # -- match --------------------------------------------------------------

    def match(self, tokens: list[int], *, touch: bool = True) -> list[int]:
        """Physical pages of the longest cached full-page prefix of
        ``tokens``, root-down. ``touch=True`` bumps the matched path's
        recency (an admission); ``touch=False`` is the side-effect-free
        peek the scheduler's fit check uses."""
        if touch:
            self._clock += 1
        pages: list[int] = []
        level = self._root
        for key in self._keys(tokens):
            node = level.get(key)
            if node is None:
                break
            if touch:
                node.last_used = self._clock
            pages.append(node.page)
            level = node.children
        if touch and pages:
            self.hits += 1
            self.hit_tokens += len(pages) * self.page_size
        return pages

    def touch_path(self, tokens: list[int], n_pages: int) -> None:
        """Bump recency (and hit accounting) for the first ``n_pages``
        of ``tokens``'s cached path — the admission-time side effect of
        a successful match, split out so the fit check can peek once
        with ``touch=False`` and the admission needs only this cheap
        path walk instead of a second full match."""
        if n_pages < 1:
            return
        self._clock += 1
        level = self._root
        for i, key in enumerate(self._keys(tokens)):
            if i >= n_pages:
                break
            node = level[key]
            node.last_used = self._clock
            level = node.children
        self.hits += 1
        self.hit_tokens += n_pages * self.page_size

    # -- insert -------------------------------------------------------------

    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Index ``tokens``'s full pages, adopting from ``pages`` (the
        owning sequence's table, logical order). Existing nodes win —
        a concurrent writer of the same prefix keeps its pages and ours
        simply drop with our table's release. Every newly adopted page
        is retained by the tree. Returns the number adopted."""
        self._clock += 1
        adopted = 0
        level = self._root
        parent: _Node | None = None
        for i, key in enumerate(self._keys(tokens)):
            node = level.get(key)
            if node is None:
                if i >= len(pages):
                    raise ValueError(
                        f"prefix of {len(tokens)} tokens spans more full "
                        f"pages than the sequence's table ({len(pages)})")
                self._seq += 1
                node = _Node(page=pages[i], last_used=self._clock,
                             seq=self._seq, key=key, parent=parent)
                self.pool.retain([node.page])
                level[key] = node
                self._pages += 1
                adopted += 1
            else:
                node.last_used = self._clock
            parent = node
            level = node.children
        return adopted

    # -- eviction -----------------------------------------------------------

    def _nodes(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _evictable_now(self, node: _Node) -> bool:
        """A leaf whose only reference is the tree's."""
        return not node.children and self.pool.refcount(node.page) == 1

    def evictable_pages(self, exclude: set[int] | None = None) -> int:
        """Pages the tree could eventually free (cascading leaf-first):
        a node counts iff its page's only reference is the tree's, it is
        not in ``exclude`` (a path about to be retained by an admission),
        and its whole subtree counts too — a pinned descendant pins every
        ancestor, since interior nodes cannot be orphaned."""
        exclude = exclude or set()

        def count(node: _Node) -> tuple[int, bool]:
            n, all_ok = 0, True
            for child in node.children.values():
                cn, ok = count(child)
                n += cn
                all_ok = all_ok and ok
            mine = (self.pool.refcount(node.page) == 1
                    and node.page not in exclude)
            return n + (1 if mine and all_ok else 0), mine and all_ok

        return sum(count(n)[0] for n in self._root.values())

    def evict(self, n: int) -> list[int]:
        """Free up to ``n`` tree-only pages, least-recently-matched leaf
        first (insertion order breaks ties). One tree walk seeds the
        candidate leaves; freeing a leaf may expose its parent, which
        joins the candidates, so a cold chain unwinds without a rescan
        per freed page. Returns the freed physical pages (now on the pool
        free list)."""
        freed: list[int] = []
        cands = {id(nd): nd for nd in self._nodes()
                 if self._evictable_now(nd)}
        while len(freed) < n and cands:
            node = min(cands.values(),
                       key=lambda nd: (nd.last_used, nd.seq))
            del cands[id(node)]
            level = (node.parent.children if node.parent is not None
                     else self._root)
            del level[node.key]
            self._pages -= 1
            self.pool.free([node.page])
            self.evictions += 1
            freed.append(node.page)
            parent = node.parent
            if parent is not None and self._evictable_now(parent):
                cands[id(parent)] = parent
        return freed
