"""The port's speculative decoding against the JAX package's: the n-gram
proposer's proposals on the same streams, the verify step's logits, written
pools and tokens against JAX's ``make_verify_step``, the window-row
attention entry's plain version against one-token reads at each row's
position, and the engine with ``spec_k`` on: greedy tokens and the draft
counts equal to the JAX engine's, spec on == spec off inside the port bit
for bit (greedy and sampled), a mid-batch join == solo, ``max_new_tokens``
and eos respected, a hostile proposer unable to corrupt tokens, and exact
page accounting with the prefix cache on too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import both_params
from distributed_model_parallel_tpu.serve import Engine as JEngine
from distributed_model_parallel_tpu.serve import NGramProposer as JProposer
from distributed_model_parallel_tpu.serve import ServeConfig as JServe
from distributed_model_parallel_tpu.serve import model as jmodel
from distributed_model_parallel_tpu_torch.ops import paged_attention as tpa
from distributed_model_parallel_tpu_torch.serve import (
    Engine,
    NGramProposer,
    ServeConfig,
    make_verify_step,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

GEOMETRY = dict(n_slots=2, page_size=8, n_pages=48, max_seq_len=96,
                prefill_chunk=4)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16]]
GENS = [12, 18, 7]
STREAMS = [
    [5, 6, 7, 8, 1, 2, 5, 6],
    [1, 2, 3, 9, 2, 3, 7, 1, 2, 3],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 1, 4, 1, 5],
    [int(t) for t in np.random.default_rng(0).integers(0, 6, 60)],
]


@pytest.fixture(scope="module")
def model():
    return both_params("mha")


@pytest.mark.parametrize("k, order", [(3, 2), (2, 3), (4, 3), (5, 1)])
def test_proposer_matches_jax(k, order):
    """Token by token through every stream: ``propose`` and
    ``predict_next`` equal JAX's after each token."""
    for stream in STREAMS:
        mine, ref = NGramProposer(k, max_order=order), JProposer(k, order)
        for t in stream:
            mine.extend([t])
            ref.extend([t])
            assert mine.propose() == ref.propose()
            assert mine.predict_next() == ref.predict_next()
    with pytest.raises(ValueError, match="k must be"):
        NGramProposer(k=0)
    with pytest.raises(ValueError, match="max_order"):
        NGramProposer(k=2, max_order=0)


def test_verify_step_matches_jax(model):
    """One verify round of width 4 over two slots (slot 1 near its budget:
    n_valid 2) after a prefill: the window logits' argmax, the emitted
    tokens and both pools against JAX's ``make_verify_step``."""
    jcfg, tcfg, jp, tp = model
    page, n_pages, w = 8, 16, 4
    shape = (tcfg.n_layers, n_pages, page, tcfg.kv_heads, tcfg.head_dim)
    rng = np.random.default_rng(3)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    tables = np.asarray([[5, 2, 9, 0], [1, 7, 0, 0]], np.int32)
    tokens = np.asarray([[3, 14, 15, 9], [2, 6, 5, 35]], np.int32)
    positions = np.asarray([11, 6], np.int32)
    n_valid = np.asarray([4, 2], np.int32)
    active = np.asarray([True, True])
    jck, jcv, jout = jmodel.make_verify_step(
        jcfg, page_size=page, n_pages=n_pages, width=w, impl="xla")(
        jp, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(n_valid),
        jnp.asarray(tables), jnp.asarray(active), None)
    ck, cv = (torch.from_numpy(p.copy()) for p in pools)
    out = make_verify_step(tcfg, page_size=page, n_pages=n_pages, width=w,
                           device="cpu")(tp, ck, cv, tokens, positions,
                                         n_valid, tables, active)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=1e-4,
                               rtol=0)
    jout = np.asarray(jout)
    assert out[0].tolist() == jout[0].tolist()
    assert out[1, :2].tolist() == jout[1, :2].tolist()
    with pytest.raises(ValueError, match="4-token windows"):
        make_verify_step(tcfg, page_size=page, n_pages=n_pages, width=4,
                         device="cpu")(tp, ck, cv, tokens[:, :3], positions,
                                       n_valid, tables, active)


def test_window_rows_equal_one_token_reads():
    """The window-row entry's plain version (CPU): window row i of each row
    equals the one-token read at positions[b] + i, within 1e-6, rows past
    the table clamped to its last slot — what the kernel's entry computes
    (the card checks the kernel itself bit for bit)."""
    rng = np.random.default_rng(1)
    b, w, h, hkv, dh, page, n, pool = 3, 5, 4, 2, 16, 4, 6, 20
    q = torch.from_numpy(rng.standard_normal((b, w, h, dh)).astype(
        np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (pool, page, hkv, dh)).astype(np.float32)) for _ in range(2))
    tables = torch.from_numpy(rng.integers(0, pool, (b, n)).astype(np.int32))
    positions = torch.tensor([0, 9, 21], dtype=torch.int32)
    for window in (None, 3):
        got = tpa.paged_attention_rows_kernel(q, kp, vp, tables, positions,
                                              window)
        for i in range(w):
            pos = (positions + i).clamp(max=n * page - 1)
            one = tpa.paged_attention_kernel(q[:, i:i + 1].contiguous(), kp,
                                             vp, tables, pos, window)
            np.testing.assert_allclose(got[:, i:i + 1].numpy(), one.numpy(),
                                       atol=1e-6, rtol=0)


def _run(eng, prompts=PROMPTS, gens=GENS):
    reqs = [eng.submit(p, g, seed=i) for i, (p, g) in
            enumerate(zip(prompts, gens))]
    eng.run()
    assert all(r.state.value == "completed" for r in reqs)
    return reqs


# A repetitive trace: the prompts repeat spans, so drafts go live.
LOOPY = [[1, 2, 3, 4] * 4, [9, 8, 7, 9, 8, 7, 9, 8], [5, 6] * 6]


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_spec_matches_jax_engine(model, prefix_cache):
    """spec_k 4 on both engines over the repetitive trace: the same greedy
    tokens, draft tokens proposed and accepted, decode rounds and cached
    prompt tokens."""
    jcfg, tcfg, jp, tp = model
    kw = dict(GEOMETRY, spec_k=4, prefix_cache=prefix_cache)
    gens = [20, 16, 24]
    jeng = JEngine(jp, jcfg, JServe(**kw))
    jreqs = _run(jeng, LOOPY, gens)
    eng = Engine(tp, tcfg, ServeConfig(**kw), device="cpu")
    reqs = _run(eng, LOOPY, gens)
    for r, jr in zip(reqs, jreqs):
        assert r.generated == jr.generated
        assert r.cached_prompt_tokens == jr.cached_prompt_tokens
    s, js = eng.summary(), jeng.summary(record=False)
    assert s["draft_tokens_accepted"] > 0
    assert s["decode_steps"] < s["tokens_generated"] - len(reqs)
    for key in ("draft_tokens_proposed", "draft_tokens_accepted",
                "decode_steps", "prefill_tokens_saved", "tokens_generated"):
        assert s[key] == js[key], key


@pytest.mark.parametrize("kw", [
    {},
    {"temperature": 0.9, "top_k": 16},
    {"temperature": 0.7, "top_p": 0.9},
])
def test_spec_on_off_identical_tokens(model, kw):
    _, tcfg, _, tp = model
    outs = []
    for spec_k in (0, 4):
        eng = Engine(tp, tcfg, ServeConfig(**GEOMETRY, spec_k=spec_k, **kw),
                     device="cpu")
        outs.append([r.generated for r in _run(eng, LOOPY, [20, 16, 24])])
    assert outs[0] == outs[1]


def test_spec_mid_batch_join_matches_solo(model):
    _, tcfg, _, tp = model
    busy = Engine(tp, tcfg, ServeConfig(**GEOMETRY, spec_k=3), device="cpu")
    first = busy.submit([1, 2, 3, 4] * 3, 24, seed=0)
    busy.run(max_iterations=6)
    joiner = busy.submit([9, 8, 7] * 3, 16, seed=1, rid="join")
    busy.run()
    assert busy.summary()["draft_tokens_proposed"] > 0
    for req, (p, g, s) in ((first, ([1, 2, 3, 4] * 3, 24, 0)),
                           (joiner, ([9, 8, 7] * 3, 16, 1))):
        solo = Engine(tp, tcfg, ServeConfig(**GEOMETRY), device="cpu")
        ref = solo.submit(p, g, seed=s)
        solo.run()
        assert req.generated == ref.generated


def test_hostile_drafts_never_corrupt_tokens(model):
    """Drafts chosen to be wrong (token + 1 + i), forced live every round:
    the committed stream is still the sequential one."""
    _, tcfg, _, tp = model
    ref = Engine(tp, tcfg, ServeConfig(**GEOMETRY), device="cpu")
    r0 = ref.submit(PROMPTS[0], 16)
    ref.run()
    eng = Engine(tp, tcfg, ServeConfig(**GEOMETRY, spec_k=4), device="cpu")

    class Hostile:
        def __init__(self, inner):
            self.inner = inner

        def extend(self, toks):
            self.inner.extend(toks)

        def propose(self):
            last = self.inner.tokens[-1]
            return [(last + 1 + i) % tcfg.vocab_size for i in range(4)]

        def predict_next(self):
            return self.propose()[0]

    r1 = eng.submit(PROMPTS[0], 16)

    def hook(i):
        prop = eng._proposers.get(r1.rid)
        if prop is not None:
            if not isinstance(prop, Hostile):
                eng._proposers[r1.rid] = Hostile(prop)
            eng._spec_live[r1.rid] = True

    eng.step_hook = hook
    eng.run()
    assert r1.generated == r0.generated
    assert eng.draft_accept_rate is not None and eng.draft_accept_rate < 0.5


def test_spec_respects_max_new_tokens_and_eos(model):
    _, tcfg, _, tp = model
    eng = Engine(tp, tcfg, ServeConfig(**GEOMETRY, spec_k=6), device="cpu")
    reqs = [eng.submit([1, 2, 3] * 4, 5, rid="short"),
            eng.submit([4, 5, 6], 1, rid="one")]
    eng.run()
    assert [len(r.generated) for r in reqs] == [5, 1]
    ref = Engine(tp, tcfg, ServeConfig(**GEOMETRY), device="cpu")
    rr = ref.submit([1, 2, 3] * 4, 12)
    ref.run()
    eos = rr.generated[4]
    outs = []
    for spec_k in (0, 4):
        e = Engine(tp, tcfg, ServeConfig(**GEOMETRY, spec_k=spec_k,
                                         eos_id=eos), device="cpu")
        r = e.submit([1, 2, 3] * 4, 12)
        e.run()
        outs.append(r.generated)
    assert outs[0] == outs[1] == rr.generated[:rr.generated.index(eos) + 1]


def test_page_accounting_with_spec_and_sharing_exact(model):
    _, tcfg, _, tp = model
    eng = Engine(tp, tcfg, ServeConfig(**GEOMETRY, spec_k=4,
                                       prefix_cache=True), device="cpu")
    seen = []

    def hook(i):
        refs = sum(eng.cache.pool._refs.values())
        tables = sum(len(t) for t in eng.cache._tables.values())
        seen.append(refs == tables + len(eng.cache.prefix))

    eng.step_hook = hook
    _run(eng, LOOPY, [20, 16, 24])
    _run(eng, LOOPY, [20, 16, 24])
    assert seen and all(seen)
    assert eng.cache.pool.used_pages == len(eng.cache.prefix)
    assert eng.clear_cache() == 0 or eng.cache.pool.used_pages == 0


@pytest.mark.parametrize("bad, match", [
    (dict(spec_k=-1), "spec_k"),
    (dict(spec_ngram=0), "spec_ngram"),
])
def test_spec_config_checks(model, bad, match):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match=match):
        Engine(tp, tcfg, ServeConfig(**GEOMETRY, **bad), device="cpu")
