"""The port's serving path against the JAX package's, and its own
invariants.

Against JAX (same numpy weights, f32): one prefill step and one decode
step — logits and written pool contents, atol 1e-4 — and a whole engine
run, whose greedy token streams must be identical. Inside the port, as
tests/test_serve.py pins for JAX: page-pool invariants, a mid-batch join
decodes bitwise what a solo run does, the static policy decodes the
continuous policy's tokens, and a killed engine fails every request
typed. Entry points refuse ``device="cuda"`` without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import both_params
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.serve import Engine as JEngine
from distributed_model_parallel_tpu.serve import ServeConfig as JServe
from distributed_model_parallel_tpu.serve import model as jmodel
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.ops import paged_attention as tpa
from distributed_model_parallel_tpu_torch.serve import (
    Engine,
    EngineKilled,
    PagedKVCache,
    PagePool,
    PagePoolError,
    RequestState,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve import model as tmodel

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ATOL = 1e-4
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16]]
GENS = [12, 18, 7]
GEOMETRY = dict(n_slots=2, page_size=8, n_pages=32, max_seq_len=64,
                prefill_chunk=4)


@pytest.fixture(scope="module", params=["mha", "gqa", "window"])
def model(request):
    return both_params(request.param)


@pytest.fixture(scope="module")
def port_model():
    _, tcfg, _, tp = both_params("mha")
    return tcfg, tp


def _serve(**kw):
    return ServeConfig(**{**GEOMETRY, **kw})


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_jax(model):
    """Three prefill chunks of an 11-token prompt, then one decode step of
    a 2-slot batch (second slot idle): logits and both pools after every
    step, against the JAX package's step bodies with ``impl="xla"``."""
    jcfg, tcfg, jp, tp = model
    page, n_pages, chunk = 8, 16, 4
    shape = (tcfg.n_layers, n_pages, page, tcfg.kv_heads, tcfg.head_dim)
    jck, jcv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tck, tcv = torch.zeros(shape), torch.zeros(shape)
    table = np.asarray([5, 2, 9, 0, 0, 0, 0, 0], np.int32)
    prompt = [3, 14, 15, 9, 2, 6, 5, 35, 8, 9, 7]
    jstep = jmodel.make_prefill_step(jcfg, page_size=page, n_pages=n_pages,
                                     chunk=chunk, impl="xla")
    for lo in range(0, len(prompt), chunk):
        nv = min(chunk, len(prompt) - lo)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :nv] = prompt[lo:lo + nv]
        positions = (lo + jnp.arange(chunk))[None]
        pages = jnp.where(jnp.arange(chunk)[None] < nv,
                          jnp.asarray(table)[positions // page], n_pages)
        x = jmodel._embed_rows(jp, jnp.asarray(toks), positions, jcfg)
        x, _, _ = jmodel._layers_scan(
            jp, jck, jcv, x, positions, pages, positions % page,
            jnp.asarray(table)[None], jnp.asarray([lo + nv]), jcfg, "xla")
        ref = jtfm.unembed(jp, x[:, nv - 1:nv])[:, 0]
        jck, jcv, jtok = jstep(jp, jck, jcv, jnp.asarray(toks),
                               jnp.int32(lo), jnp.int32(nv),
                               jnp.asarray(table), jax.random.key(0))
        got = tmodel.prefill_logits(tp, tck, tcv, toks, lo, nv, table, tcfg,
                                    page_size=page, n_pages=n_pages,
                                    impl="kernel", device="cpu")
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tck.numpy(), _np(jck), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tcv.numpy(), _np(jcv), atol=ATOL, rtol=0)
        assert int(got.argmax(-1)[0]) == int(jtok[0])

    tokens = np.asarray([int(jtok[0]), 0], np.int32)
    positions = np.asarray([len(prompt), 0], np.int32)
    tables = np.stack([table, np.zeros_like(table)])
    active = np.asarray([True, False])
    pos2 = jnp.asarray(positions)[:, None]
    pages = jnp.where(jnp.asarray(active)[:, None],
                      jnp.take_along_axis(jnp.asarray(tables), pos2 // page,
                                          axis=1), n_pages)
    x = jmodel._embed_rows(jp, jnp.asarray(tokens)[:, None], pos2, jcfg)
    x, _, _ = jmodel._layers_scan(jp, jck, jcv, x, pos2, pages, pos2 % page,
                                  jnp.asarray(tables), pos2[:, 0] + 1, jcfg,
                                  "xla")
    ref = jtfm.unembed(jp, x)[:, 0]
    jck, jcv, jnxt = jmodel.make_decode_step(
        jcfg, page_size=page, n_pages=n_pages, impl="xla")(
        jp, jck, jcv, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(active), None)
    got = tmodel.decode_logits(tp, tck, tcv, tokens, positions, tables,
                               active, tcfg, page_size=page, n_pages=n_pages,
                               impl="kernel", device="cpu")
    np.testing.assert_allclose(got[:1].numpy(), _np(ref)[:1], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tck.numpy(), _np(jck), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcv.numpy(), _np(jcv), atol=ATOL, rtol=0)
    assert int(got[0].argmax()) == int(jnxt[0])


def test_engine_greedy_tokens_match_jax_engine(model):
    jcfg, tcfg, jp, tp = model
    jeng = JEngine(jp, jcfg, JServe(**GEOMETRY))
    jreqs = [jeng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    jeng.run()
    eng = Engine(tp, tcfg, _serve(), device="cpu")
    reqs = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    summary = eng.run()
    assert summary["requests_completed"] == len(PROMPTS)
    assert summary["tokens_generated"] == sum(GENS)
    for r, jr in zip(reqs, jreqs):
        assert r.state is RequestState.COMPLETED
        assert r.generated == jr.generated


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------

def test_pool_never_double_allocates():
    pool = PagePool(8)
    a = pool.alloc(3)
    b = pool.alloc(4)
    assert len(set(a) | set(b)) == 7
    with pytest.raises(PagePoolError, match="exceeds"):
        pool.alloc(2)
    pool.free(a)
    assert not set(pool.alloc(3)) & set(b)
    assert pool.free_pages + pool.used_pages == 8
    assert all(pool.refcount(p) == 1 for p in b)


def test_pool_rejects_double_free_and_foreign_pages():
    pool = PagePool(4)
    pages = pool.alloc(2)
    pool.free(pages)
    with pytest.raises(PagePoolError, match="not allocated"):
        pool.free(pages)
    with pytest.raises(PagePoolError, match="not allocated"):
        pool.free([99])


def test_pool_allocation_order_deterministic():
    orders = []
    for _ in range(2):
        pool = PagePool(6)
        pool.free(pool.alloc(2))
        orders.append(pool.alloc(4))
    assert orders[0] == orders[1] == [2, 3, 4, 5]


def test_cache_tables_and_admission(port_model):
    cfg, _ = port_model
    cache = PagedKVCache(cfg, n_pages=5, page_size=4, max_seq_len=16,
                         device="cpu")
    assert tuple(cache.ck.shape) == (2, 5, 4, 4, 8)
    # try_admit(sid, prompt tokens, capacity): the cached token count (0
    # without a prefix cache), or None when the request must queue.
    assert cache.try_admit("a", [1] * 5, 9) == 0  # 3 pages
    assert cache.try_admit("b", [1] * 5, 9) is None  # only 2 free: queue
    assert "b" not in cache._tables
    assert cache.table_array("a").tolist() == [0, 1, 2, 0]
    with pytest.raises(PagePoolError, match="max_seq_len"):
        cache.ensure("a", 17)
    cache.release("a")
    assert cache.occupancy == 0.0


def test_write_index_drops_out_of_range_pages():
    pages = torch.tensor([[3, 16, -1, 2]])
    offsets = torch.tensor([[0, 1, 2, 3]])
    keep = torch.tensor([[True, True, True, False]])
    rows, cols, p, o = tmodel.write_index(pages, offsets, keep, 16, "cpu")
    assert cols.tolist() == [0] and p.tolist() == [3] and o.tolist() == [0]


# ---------------------------------------------------------------------------
# engine invariants inside the port
# ---------------------------------------------------------------------------

def test_mid_batch_join_matches_solo_run(port_model):
    """A request joining a busy batch decodes bitwise what a solo run
    through the same engine geometry decodes — greedy and sampled."""
    cfg, params = port_model
    for kw in ({}, {"temperature": 0.9, "top_k": 16}):
        busy = Engine(params, cfg, _serve(**kw), device="cpu")
        reqs = [busy.submit(p, g, seed=i)
                for i, (p, g) in enumerate(zip(PROMPTS, GENS))]
        busy.run()
        for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
            solo = Engine(params, cfg, _serve(**kw), device="cpu")
            sr = solo.submit(p, g, seed=i)
            solo.run()
            assert sr.generated == reqs[i].generated, (i, kw)


def test_static_policy_decodes_identical_tokens(port_model):
    cfg, params = port_model
    outs, sums = [], {}
    prompts = [[i + 1, 2, 3] for i in range(6)]
    gens = [4, 30, 6, 28, 5, 26]
    for policy in ("continuous", "static"):
        eng = Engine(params, cfg, _serve(policy=policy, n_slots=3),
                     device="cpu")
        reqs = [eng.submit(p, g, seed=i)
                for i, (p, g) in enumerate(zip(prompts, gens))]
        sums[policy] = eng.run()
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]
    assert (sums["continuous"]["decode_steps"]
            < sums["static"]["decode_steps"])
    assert (sums["continuous"]["slot_utilization"]
            > sums["static"]["slot_utilization"])


def test_every_iteration_page_accounting_exact(port_model):
    cfg, params = port_model
    eng = Engine(params, cfg, _serve(), device="cpu")

    def hook(i):
        expect = sum(eng.cache.pages_needed(r.total_capacity)
                     for r in eng.sched.active())
        assert eng.cache.pool.used_pages == expect
        held = [p for tab in eng.cache._tables.values() for p in tab]
        assert len(held) == len(set(held))

    eng.step_hook = hook
    for p, g in zip(PROMPTS, GENS):
        eng.submit(p, g)
    summary = eng.run()
    assert eng.cache.pool.free_pages == eng.cache.pool.n_pages
    assert summary["ttft_s"]["count"] == len(PROMPTS)
    assert summary["ttft_s"]["p99"] >= summary["ttft_s"]["p50"] >= 0
    assert 0 < summary["slot_utilization"] <= 1
    assert summary["page_occupancy"]["max"] <= 1


def test_admission_beyond_capacity_queues(port_model):
    cfg, params = port_model
    eng = Engine(params, cfg, _serve(n_slots=3, n_pages=3, max_seq_len=24),
                 device="cpu")
    max_resident = 0

    def hook(i):
        nonlocal max_resident
        max_resident = max(max_resident, len(eng.sched.active()))

    eng.step_hook = hook
    reqs = [eng.submit([1 + i, 2, 3], 12) for i in range(3)]
    eng.run()
    assert all(r.state is RequestState.COMPLETED for r in reqs)
    assert max_resident == 1


def test_eos_stops_a_request(port_model):
    cfg, params = port_model
    ref = Engine(params, cfg, _serve(), device="cpu")
    r = ref.submit(PROMPTS[1], GENS[1])
    ref.run()
    eos = r.generated[2]
    eng = Engine(params, cfg, _serve(eos_id=eos), device="cpu")
    s = eng.submit(PROMPTS[1], GENS[1])
    eng.run()
    assert s.generated == r.generated[:r.generated.index(eos) + 1]


def test_submit_rejects_impossible_requests(port_model):
    cfg, params = port_model
    eng = Engine(params, cfg, _serve(n_pages=4, max_seq_len=64),
                 device="cpu")
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit([1] * 40, 20)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit([1] * 60, 30)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([9999], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1], 0)
    eng.submit([1, 2], 4, rid="dup")
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit([1, 2], 4, rid="dup")


@pytest.mark.parametrize("bad", [
    (dict(moe_experts=4), {}, "MoE"),
    (dict(tp_axis="model"), {}, "replicated"),
    ({}, dict(max_seq_len=4096), "max_seq_len"),
    ({}, dict(attn_impl="pallas"), "attn_impl"),
    ({}, dict(top_k=4), "temperature"),
])
def test_engine_rejects_unsupported_configs(port_model, bad):
    cfg, params = port_model
    model_kw, serve_kw, match = bad
    import dataclasses

    with pytest.raises(ValueError, match=match):
        Engine(params, dataclasses.replace(cfg, **model_kw),
               _serve(**serve_kw), device="cpu")


def test_kill_mid_stream_reports_typed_failures(port_model):
    cfg, params = port_model

    def bomb(iteration):
        if iteration == 6:
            raise RuntimeError("injected mid-stream death")

    eng = Engine(params, cfg, _serve(), device="cpu", step_hook=bomb)
    reqs = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
    reqs.append(eng.submit([5, 5, 5], 40, rid="tail"))
    with pytest.raises(EngineKilled):
        eng.run()
    assert all(r.done for r in reqs)
    failed = [r for r in reqs if r.state is RequestState.FAILED]
    assert failed and all(r.error.startswith("engine-killed")
                          for r in failed)
    assert eng.cache.pool.free_pages == eng.cache.pool.n_pages


def test_cuda_entry_points_refuse_without_a_card(port_model, monkeypatch):
    cfg, params = port_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttfm.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(params, cfg, _serve())
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.make_decode_step(cfg, page_size=8, n_pages=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.make_prefill_step(cfg, page_size=8, n_pages=4, chunk=4)


def test_plain_impl_decodes_the_kernel_path_tokens(port_model):
    """attn_impl="plain" takes the gather path for decode too; on CPU the
    kernel wrapper's plain version is that path, so the tokens agree and
    no launch is counted."""
    cfg, params = port_model
    before = tpa.paged_attention_kernel.launches
    outs = []
    for impl in ("kernel", "plain"):
        eng = Engine(params, cfg, _serve(attn_impl=impl), device="cpu")
        reqs = [eng.submit(p, g) for p, g in zip(PROMPTS, GENS)]
        eng.run()
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]
    assert tpa.paged_attention_kernel.launches == before


def test_generate_cli_on_cpu(capsys):
    from distributed_model_parallel_tpu_torch.serve import generate

    tokens = generate.main(["--device", "cpu", "--vocab", "64", "--d-model",
                            "32", "--heads", "4", "--layers", "2", "--d-ff",
                            "64", "--rope", "--prompt", "5,17,42",
                            "--gen-steps", "6"])
    assert tokens[:3] == [5, 17, 42] and len(tokens) == 9
    assert capsys.readouterr().out.strip() == ",".join(map(str, tokens))
    # Greedy decoding from the same seed is reproducible.
    assert generate.main(["--device", "cpu", "--vocab", "64", "--d-model",
                          "32", "--heads", "4", "--layers", "2", "--d-ff",
                          "64", "--rope", "--prompt", "5,17,42",
                          "--gen-steps", "6"]) == tokens


def test_learned_positions_engine_run(port_model):
    """The learned-position variant runs through the engine too (its
    position table is gathered per row, clipped)."""
    import dataclasses

    cfg, _ = port_model
    lcfg = dataclasses.replace(cfg, pos_embedding="learned")
    params = ttfm.init_params(lcfg, seed=1, device="cpu")
    eng = Engine(params, lcfg, _serve(), device="cpu")
    r = eng.submit(PROMPTS[0], 5)
    eng.run()
    assert r.state is RequestState.COMPLETED and len(r.generated) == 5
    assert max(r.generated) < lcfg.vocab_size
