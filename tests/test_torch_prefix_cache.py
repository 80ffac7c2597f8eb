"""The port's prefix sharing against the JAX package's: the refcounted
``PagePool``, the radix tree (``PrefixCache``), the cache's admission bill
and the scheduler's post-sharing admission, each driven through the
operation sequences of ``tests/test_prefix_cache.py`` in both packages —
page ids, evictions, bills and counts must be equal — and the engine with
the prefix cache on: greedy tokens and cached-token counts equal to the
JAX engine's on a shared-prompt and multi-turn trace, cache on == cache off
inside the port, a cache-hit request joining mid-batch == solo, and exact
page accounting every iteration."""

import jax.numpy as jnp
import pytest
import torch

from _torch_port_util import both_params
from distributed_model_parallel_tpu.serve import Engine as JEngine
from distributed_model_parallel_tpu.serve import PagedKVCache as JCache
from distributed_model_parallel_tpu.serve import PagePool as JPool
from distributed_model_parallel_tpu.serve import PrefixCache as JTree
from distributed_model_parallel_tpu.serve import ServeConfig as JServe
from distributed_model_parallel_tpu.serve import paged_kv as jkv
from distributed_model_parallel_tpu.serve import scheduler as jsched
from distributed_model_parallel_tpu_torch.serve import (
    Engine,
    PagedKVCache,
    PagePool,
    PagePoolError,
    PrefixCache,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve import paged_kv as tkv
from distributed_model_parallel_tpu_torch.serve import scheduler as tsched

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


class Pkg:
    """One package's serving pieces under common names."""

    def __init__(self, pool, tree, cache, kv, sched, dtype, **cache_kw):
        self.Pool, self.Tree, self.kv, self.sched = pool, tree, kv, sched
        self._cache, self._dtype, self._kw = cache, dtype, cache_kw

    def cache(self, n_pages=12, page=4, max_seq=32, **kw):
        cfg = type("C", (), {"n_layers": 1, "kv_heads": 1, "head_dim": 4,
                             "dtype": self._dtype})
        return self._cache(cfg, n_pages=n_pages, page_size=page,
                           max_seq_len=max_seq, prefix_cache=True,
                           **self._kw, **kw)


JAX = Pkg(JPool, JTree, JCache, jkv, jsched, jnp.float32)
PORT = Pkg(PagePool, PrefixCache, PagedKVCache, tkv, tsched, torch.float32,
           device="cpu")


# -- operation sequences: each returns what it observed ---------------------

def refcount_lifecycle(k: Pkg):
    pool = k.Pool(8)
    pages = pool.alloc(3)
    pool.retain(pages)
    out = [pages, pool.shared_pages]
    pool.free(pages)
    out += [pool.used_pages, pool.free_pages, pool.shared_pages]
    pool.free(pages)
    out += [pool.used_pages, pool.free_pages]
    a = pool.alloc(2)
    pool.retain(a)
    pool.free(a)
    out += [a, pool.alloc(2)]                  # never a shared page
    return out


def double_free_and_retain_raise(k: Pkg):
    pool = k.Pool(4)
    pages = pool.alloc(2)
    pool.free(pages)
    out = []
    for op in (pool.free, pool.retain):
        try:
            op(pages)
        except RuntimeError as e:               # PagePoolError
            out.append("not allocated" in str(e))
    return out


def insert_match_page_granular(k: Pkg):
    pool = k.Pool(16)
    tree = k.Tree(pool, 4)
    toks = list(range(10))
    pages = pool.alloc(3)
    return [tree.insert(toks, pages), tree.match(toks), tree.match(toks[:7]),
            tree.match([99] + toks[1:]), pool.refcount(pages[0]),
            pool.refcount(pages[2]), len(tree), tree.hits, tree.hit_tokens]


def duplicate_insert_keeps_existing(k: Pkg):
    pool = k.Pool(16)
    tree = k.Tree(pool, 4)
    first = pool.alloc(2)
    tree.insert(list(range(8)), first)
    second = pool.alloc(2)
    return [tree.insert(list(range(8)), second), tree.match(list(range(8))),
            pool.refcount(second[0])]


def lru_leaf_first_eviction(k: Pkg):
    pool = k.Pool(16)
    tree = k.Tree(pool, 4)
    a = pool.alloc(2)
    tree.insert(list(range(8)), a)
    b = pool.alloc(2)
    tree.insert([50, 51, 52, 53, 60, 61, 62, 63], b)
    pool.free(a)
    pool.free(b)
    tree.match(list(range(8)))
    return [tree.evict(3), tree.evictions, len(tree), pool.free_pages]


def pinned_descendant_pins_ancestors(k: Pkg):
    pool = k.Pool(16)
    tree = k.Tree(pool, 4)
    pages = pool.alloc(3)
    tree.insert(list(range(12)), pages)
    pool.free([pages[0], pages[1]])
    out = [tree.evictable_pages(), tree.evict(3)]
    pool.free([pages[2]])
    return out + [tree.evictable_pages(), tree.evict(3), pool.free_pages]


def exclude_protects_matched_path(k: Pkg):
    pool = k.Pool(16)
    tree = k.Tree(pool, 4)
    pages = pool.alloc(2)
    tree.insert(list(range(8)), pages)
    pool.free(pages)
    return [tree.evictable_pages(), tree.evictable_pages(exclude={pages[0]})]


def cow_fork(k: Pkg):
    cache = k.cache()
    toks = list(range(12))
    cache.open("a")
    cache.ensure("a", 16)
    cache.insert_prefix("a", toks)
    a_pages = list(cache._tables["a"])
    got = cache.admit_with_prefix("b", toks, 16)
    b_pages = list(cache._tables["b"])
    out = [got, a_pages, b_pages, cache.pool.refcount(a_pages[0]),
           cache.page_share("b"), cache.shared_pages]
    cache.release("a")
    out.append(cache.pool.refcount(b_pages[0]))
    cache.release("b")
    out += [cache.pool.refcount(b_pages[0]), cache.pool.used_pages,
            len(cache.prefix), cache.cached_prefix_tokens(toks),
            k.kv.memory_gauges(cache)]
    out += [cache.drop_prefix(), cache.pool.used_pages]
    return out


def admission_bills_only_uncached_suffix(k: Pkg):
    toks = list(range(16))
    out = []
    for rid, prompt in (("cold", [90 + t for t in toks]), ("hit", toks)):
        cache = k.cache(n_pages=8, page=4, max_seq=24)
        cache.admit_with_prefix("warm", toks, 20)
        cache.insert_prefix("warm", toks)
        out.append(cache.peek_admission(prompt, 20))
        sched = k.sched.Scheduler(cache, 2)
        req = k.sched.Request(rid=rid, prompt=prompt, max_new_tokens=4)
        sched.submit(req)
        out += [[r.rid for r in sched.admit(0.0)], req.state.value,
                req.cached_prompt_tokens, cache.pool.free_pages]
    return out


def admission_evicts_lru_tree_pages(k: Pkg):
    cache = k.cache(n_pages=6, page=4, max_seq=24)
    toks = list(range(16))
    cache.open("w")
    cache.ensure("w", 20)
    cache.insert_prefix("w", toks)
    cache.release("w")
    got = cache.admit_with_prefix("c", [70 + t for t in toks], 20)
    out = [got, cache.pool.used_pages, len(cache.prefix),
           list(cache._tables["c"]), cache.prefix.evictions]
    try:
        cache.admit_with_prefix("d", list(range(30, 46)), 20)
    except RuntimeError as e:                   # PagePoolError
        out.append("admission must queue" in str(e))
    return out


def share_granularity(k: Pkg):
    cache = k.cache(n_pages=16, page=4, max_seq=64, share_granularity=8)
    toks = list(range(13))
    cache.open("a")
    cache.ensure("a", 16)
    cache.insert_prefix("a", toks)
    return [k.kv.share_granularity_for(8, 4),
            k.kv.share_granularity_for(8, 32),
            k.kv.share_granularity_for(16, 12), cache.peek_admission(toks, 16)]


SCENARIOS = [refcount_lifecycle, double_free_and_retain_raise,
             insert_match_page_granular, duplicate_insert_keeps_existing,
             lru_leaf_first_eviction, pinned_descendant_pins_ancestors,
             exclude_protects_matched_path, cow_fork,
             admission_bills_only_uncached_suffix,
             admission_evicts_lru_tree_pages, share_granularity]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_operation_sequence_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_share_granularity_must_be_a_page_multiple():
    with pytest.raises(ValueError, match="multiple of page_size"):
        PORT.cache(page=4, share_granularity=6)
    with pytest.raises(PagePoolError, match="not allocated"):
        PagePool(2).retain([0])


# -- the engine -------------------------------------------------------------

GEOMETRY = dict(n_slots=2, page_size=8, n_pages=48, max_seq_len=96,
                prefill_chunk=4)
PROMPT = list(range(1, 19))                  # 18 tokens: 2 full pages


@pytest.fixture(scope="module")
def model():
    return both_params("mha")


def _trace(eng, turns: int = 2):
    """Two requests with one system prompt, then a follow-up whose prompt
    is turn 1's prompt and reply plus new tokens, in waves."""
    first = eng.submit(PROMPT, 10, rid="t1", seed=1)
    eng.run()
    again = eng.submit(PROMPT + [40, 41], 8, rid="t1b", seed=2)
    eng.run()
    follow = eng.submit(PROMPT + first.generated + [30, 31, 32], 8,
                        rid="t2", seed=3)
    eng.run()
    return [first, again, follow]


def test_engine_with_prefix_cache_matches_jax(model):
    """Greedy tokens, cached-prefix tokens per request and the summary's
    counts equal the JAX engine's on the same trace; the port's tokens
    equal its own cache-off run's; after the run the pool holds exactly
    the tree, and ``clear_cache`` returns every page."""
    jcfg, tcfg, jp, tp = model
    jeng = JEngine(jp, jcfg, JServe(**GEOMETRY, prefix_cache=True))
    jreqs = _trace(jeng)
    eng = Engine(tp, tcfg, ServeConfig(**GEOMETRY, prefix_cache=True),
                 device="cpu")
    reqs = _trace(eng)
    cold = Engine(tp, tcfg, ServeConfig(**GEOMETRY), device="cpu")
    creqs = _trace(cold)
    for r, jr, c in zip(reqs, jreqs, creqs):
        assert r.generated == jr.generated == c.generated, r.rid
        assert r.cached_prompt_tokens == jr.cached_prompt_tokens, r.rid
    assert reqs[1].cached_prompt_tokens == 16
    assert reqs[2].cached_prompt_tokens >= 16
    s, js = eng.summary(), jeng.summary()
    for key in ("cache_hit_rate", "prefill_tokens_saved", "shared_pages",
                "cached_prefix_pages", "prefix_evictions"):
        assert s[key] == js[key], key
    assert cold.summary()["cache_hit_rate"] is None
    assert eng.cache.pool.used_pages == len(eng.cache.prefix) > 0
    assert eng.clear_cache() > 0 and eng.cache.pool.free_pages == 48


def test_mid_batch_join_with_shared_prefix_matches_solo(model):
    _, tcfg, _, tp = model
    serve = ServeConfig(**dict(GEOMETRY, n_slots=3), prefix_cache=True)
    eng = Engine(tp, tcfg, serve, device="cpu")
    first = eng.submit(PROMPT, 20, seed=1)
    eng.run(max_iterations=8)
    joiners = [eng.submit(PROMPT, 10, seed=2, rid="j1"),
               eng.submit(PROMPT + [40, 41], 10, seed=3, rid="j2")]
    eng.run()
    assert joiners[0].cached_prompt_tokens > 0
    for req, (p, g, seed) in zip([first] + joiners,
                                 [(PROMPT, 20, 1), (PROMPT, 10, 2),
                                  (PROMPT + [40, 41], 10, 3)]):
        solo = Engine(tp, tcfg, ServeConfig(**GEOMETRY), device="cpu")
        ref = solo.submit(p, g, seed=seed)
        solo.run()
        assert req.generated == ref.generated


def test_page_accounting_with_sharing_exact(model):
    """Every iteration: pool references == resident tables' pages + the
    tree's; after the run the pool holds exactly the tree, unshared."""
    _, tcfg, _, tp = model
    eng = Engine(tp, tcfg, ServeConfig(**GEOMETRY, prefix_cache=True),
                 device="cpu")
    seen = []

    def hook(i):
        refs = sum(eng.cache.pool._refs.values())
        tables = sum(len(t) for t in eng.cache._tables.values())
        seen.append(refs == tables + len(eng.cache.prefix))

    eng.step_hook = hook
    for i in range(3):
        eng.submit(PROMPT, 8 + i, rid=f"r{i}")
    eng.run()
    assert seen and all(seen)
    assert eng.cache.pool.used_pages == len(eng.cache.prefix)
    assert eng.cache.pool.shared_pages == 0
