"""Live migration between two port engines: ``drain`` on the source at an
iteration where requests are mid-prefill and mid-decode, ``enqueue`` on
the destination (``force=True``), with the prefix cache off and on and
speculative decoding off and on. Every request's tokens equal the
unmigrated run's bit for bit, and those equal the JAX engine's greedy
tokens; the source's pages are all free after ``drain`` +
``clear_cache``; the payload's pages travel by value in the pool's
dtype (bf16 included, which has no numpy dtype).

Mirrors the drain/import cases of ``tests/test_overload.py``
(test_deadline_survives_migration) and the fleet's migration tests, on
two engines by hand."""

import pytest
import torch

from _torch_serve_util import engines, model as _model, run_sim
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.serve import (
    Engine,
    PagedKVCache,
    ServeConfig,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# A 16-token shared system prefix: requests 0 and 2 share it (a cache hit
# with the prefix cache on); request 0's 17-token prompt prefills over 5
# chunks while request 1 decodes.
PREFIX = [5, 9, 2, 31, 7, 7, 40, 12, 3, 3, 18, 27, 60, 1, 44, 8]
PROMPTS = [PREFIX + [11], [7, 8, 9], PREFIX + [20, 21], [3, 3, 3]]
GENS = [10, 14, 9, 12]
DRAIN_AT = (1, 2, 3, 5, 8, 12)


@pytest.fixture(scope="module")
def model():
    return _model()


def _submit(e):
    return [e.submit(p, g, seed=i, rid=f"req-{i}")
            for i, (p, g) in enumerate(zip(PROMPTS, GENS))]


@pytest.mark.parametrize("prefix_cache,spec_k",
                         [(False, 0), (True, 0), (False, 3), (True, 3)])
def test_drain_and_import_match_unmigrated_run(model, prefix_cache, spec_k):
    kw = dict(prefix_cache=prefix_cache, spec_k=spec_k)
    ref = engines(model, **kw)
    refs = [_submit(e) for e in ref]
    for e in ref:
        run_sim(e)
    want = [r.generated for r in refs[1]]
    assert want == [r.generated for r in refs[0]]   # the JAX engine's
    s = ref[1].summary(record=False)
    assert (s["prefill_tokens_saved"] > 0) == prefix_cache
    assert (s["draft_tokens_proposed"] > 0) == bool(spec_k)
    _, tcfg, _, tp = model
    serve = ServeConfig(n_slots=2, page_size=8, n_pages=32, max_seq_len=64,
                        prefill_chunk=4, **kw)
    states = set()
    for drain_at in DRAIN_AT:
        src = Engine(tp, tcfg, serve, device="cpu", replica="a")
        dst = Engine(tp, tcfg, serve, device="cpu", replica="b")
        reqs = _submit(src)
        for it in range(drain_at):
            src.step_once(0.01 * it, 0.0)
        states |= {r.state.value for r in reqs if r.slot is not None}
        moved = src.drain()
        src.clear_cache()
        assert src.cache.pool.used_pages == 0
        for r in moved:
            if r.resume is not None:
                k = r.resume["k"]
                assert k.device.type == "cpu" and k.dtype == tcfg.dtype
                assert k.shape[1] == -(-r.resume["n_written"] // 8)
            dst.enqueue(r, force=True)
        dst.run()
        assert all(r.state.value == "completed" for r in reqs), drain_at
        assert [r.generated for r in reqs] == want, drain_at
        assert all(r.migrations == (r in moved) for r in reqs)
        dst.clear_cache()
    assert {"prefill", "decode"} <= states


def test_export_import_round_trip_bf16():
    """A bf16 pool's pages leave by value as bf16 tensors (no numpy
    round trip) and land bit for bit in fresh pages of another pool; an
    import that does not fit is refused with no side effect."""
    cfg = ttfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                 n_layers=2, d_ff=64, max_seq_len=64,
                                 pos_embedding="rope", dtype=torch.bfloat16)
    src = PagedKVCache(cfg, n_pages=8, page_size=4, max_seq_len=32,
                       device="cpu")
    src.ck.normal_()
    src.cv.normal_()
    assert src.try_admit("r", [1] * 9, 12) == 0
    k, v = src.export_request("r", 9)
    table = src._tables["r"][:3]
    assert k.dtype == torch.bfloat16 and tuple(k.shape) == (2, 3, 4, 4, 8)
    assert torch.equal(k, src.ck[:, table]) and torch.equal(v,
                                                            src.cv[:, table])
    dst = PagedKVCache(cfg, n_pages=4, page_size=4, max_seq_len=32,
                       device="cpu")
    dst.try_admit("other", [2], 4)              # page 0 taken
    assert not dst.import_request("big", k, v, 32)
    assert "big" not in dst._tables and dst.pool.used_pages == 1
    assert dst.import_request("r", k, v, 12)
    new = dst._tables["r"]
    assert len(new) == 3 and 0 not in new
    assert torch.equal(dst.ck[:, new], k) and torch.equal(dst.cv[:, new], v)
