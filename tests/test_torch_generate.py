"""The port's cached decoding (``models/transformer.generate`` and its
``_cached_block``) against the JAX package's, on one numpy weight tree:
the block at C 1 and C 8 over a cache with stale contents (x and the
written slab within 1e-5), greedy tokens equal to JAX's for multi-head,
grouped-query, learned positions, RoPE, a sliding window and MoE, chunked
prefill equal to the batched one, JAX's refusals in its words, and the
sampler's row streams (a row's draw depends on its seed, global index and
position only). f32, 2 layers, d 64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import numpy_params
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu_torch.models import transformer as ttfm

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64)
KINDS = {
    "mha_rope": dict(pos_embedding="rope"),
    "gqa": dict(pos_embedding="rope", n_kv_heads=2),
    "learned": dict(),
    "window": dict(pos_embedding="rope", attn_window=5, attn_impl="flash"),
    "moe": dict(pos_embedding="rope", moe_experts=4, moe_top_k=2),
}
B, T0, STEPS = 3, 8, 10


def _both(kind: str, seed: int = 0):
    jcfg = jtfm.TransformerConfig(**BASE, **KINDS[kind])
    tcfg = ttfm.TransformerConfig(**BASE, **KINDS[kind])
    tree = numpy_params(tcfg, seed)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, ttfm.params_from_jax(tree, tcfg, "cpu")


def _prompt(seed: int = 3, b: int = B, t: int = T0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("kind", ["gqa", "window"])
def test_cached_block_matches_jax(kind, c):
    """One block for C positions starting at 9 over a cache whose every
    slot holds random values (written and stale alike): the block's output
    and the written cache against JAX's ``_cached_block``."""
    jcfg, tcfg, jp, tp = _both(kind)
    rng = np.random.default_rng(5)
    total = 32
    shape = (tcfg.n_layers, 2, total, tcfg.kv_heads, tcfg.head_dim)
    ck0 = rng.standard_normal(shape).astype(np.float32)
    cv0 = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((2, c, tcfg.d_model)).astype(np.float32)
    positions = np.arange(9, 9 + c)
    layer = 1
    jbp = jax.tree.map(lambda a: a[layer], jp["blocks"])
    jx, jck, jcv = jtfm._cached_block(
        jbp, jnp.asarray(ck0), jnp.asarray(cv0), jnp.int32(layer),
        jnp.asarray(x), jnp.asarray(positions), jcfg)
    ck, cv = torch.from_numpy(ck0.copy()), torch.from_numpy(cv0.copy())
    tx = ttfm._cached_block(ttfm.layer_params(tp, layer), ck, cv, layer,
                            torch.from_numpy(x), torch.from_numpy(positions),
                            tcfg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_tokens_match_jax(kind):
    """Greedy decoding from the batched prefill (the port's also through
    its plain route, ``impl="plain"``) and from 4-token chunked prefill:
    all equal JAX's batched ``generate``. MoE capacity follows the tokens
    present, so its chunked prefill drops differently: there it is held
    against JAX's chunked prefill."""
    jcfg, tcfg, jp, tp = _both(kind)
    prompt = _prompt()
    want = np.asarray(jtfm.generate(jp, jcfg, jnp.asarray(prompt), STEPS))
    for kw in ({}, {"impl": "plain"}, {"prefill_chunk": 4}):
        got = ttfm.generate(tp, tcfg, prompt, STEPS, **kw)
        if kind == "moe" and "prefill_chunk" in kw:
            want = np.asarray(jtfm.generate(jp, jcfg, jnp.asarray(prompt),
                                            STEPS, **kw))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


def test_chunked_prefill_equals_batched_and_logits_close():
    """Chunked prefill (2 and 8 tokens a slice) against the batched one: the
    same tokens, and the first three sampling steps' logits within 1e-5."""
    _, tcfg, _, tp = _both("gqa", seed=1)
    prompt = _prompt(4)
    ref, ref_logits = ttfm.generate(tp, tcfg, prompt, STEPS, return_logits=3)
    assert ref_logits.shape == (B, 3, tcfg.vocab_size)
    for chunk in (2, 8):
        got, logits = ttfm.generate(tp, tcfg, prompt, STEPS,
                                    prefill_chunk=chunk, return_logits=3)
        assert torch.equal(got, ref), chunk
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   atol=1e-5, rtol=0)


def test_long_decode_crosses_read_segments():
    """A decode longer than one read segment (positions past 256, where the
    plain route's read boundary moves): greedy tokens equal JAX's."""
    cfg_kw = dict(BASE, max_seq_len=300, pos_embedding="rope")
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    tcfg = ttfm.TransformerConfig(**cfg_kw)
    tree = numpy_params(tcfg, 2)
    prompt = _prompt(6, b=1, t=250)
    want = jtfm.generate(jax.tree.map(jnp.asarray, tree), jcfg,
                         jnp.asarray(prompt), 12)
    got = ttfm.generate(ttfm.params_from_jax(tree, tcfg, "cpu"), tcfg,
                        prompt, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ttfm.generate.cache_shape == (2, 1, 272, 4, 16)


@pytest.mark.parametrize("kw, match", [
    (dict(steps=0), "steps must be >= 1"),
    (dict(steps=60), "exceeds max_seq_len"),
    (dict(prefill_chunk=3), "not divisible by prefill_chunk=3"),
    (dict(prefill_chunk=0), "prefill_chunk must be >= 1"),
    (dict(temperature=0.0, top_k=4), "set temperature > 0"),
])
def test_refusals_in_jax_words(kw, match):
    jcfg, tcfg, jp, tp = _both("mha_rope")
    prompt = _prompt()
    kw = dict(kw)
    steps = kw.pop("steps", STEPS)
    with pytest.raises(ValueError, match=match):
        jtfm.generate(jp, jcfg, jnp.asarray(prompt), steps, **kw)
    with pytest.raises(ValueError, match=match):
        ttfm.generate(tp, tcfg, prompt, steps, **kw)
    with pytest.raises(ValueError, match="unknown decode impl"):
        ttfm.generate(tp, tcfg, prompt, STEPS, impl="pallas")


def test_sampled_rows_depend_on_seed_index_and_position_only():
    """The row-stream property: the sampler's draw for a row equals that row
    drawn alone, and ``generate`` on rows 1..2 of a batch (``row_offset``
    1, as a data split hands them out) samples exactly those rows of the
    whole batch's run; another seed changes the stream."""
    _, tcfg, _, tp = _both("mha_rope")
    sample = ttfm.make_sampler(tcfg, 0.9, 16, 0.95)
    logits = torch.randn(4, tcfg.vocab_size,
                         generator=torch.Generator().manual_seed(0))
    seeds, positions = [11, 12, 13, 14], [5, 9, 9, 40]
    whole = sample(logits, seeds, positions)
    alone = [int(sample(logits[r:r + 1], seeds[r:r + 1],
                        positions[r:r + 1])[0]) for r in range(4)]
    assert whole.tolist() == alone
    prompt = _prompt(7, b=3)
    kw = dict(seed=5, temperature=1.0, top_k=20)
    full = ttfm.generate(tp, tcfg, prompt, STEPS, **kw)
    part = ttfm.generate(tp, tcfg, prompt[1:], STEPS, row_offset=1, **kw)
    assert torch.equal(part, full[1:])
    assert not torch.equal(ttfm.generate(tp, tcfg, prompt, STEPS,
                                         **dict(kw, seed=6)), full)
