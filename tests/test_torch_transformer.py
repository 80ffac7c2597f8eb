"""The port's Transformer pieces against the JAX package's on the same
inputs (f32, atol 1e-5): layer norm, RoPE with per-row positions, the
q/k/v projection, the FFN, the unembedding, the greedy sampler, and the
parameter layout both packages share."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import both_params, configs, numpy_params, t
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu_torch.models import transformer as ttfm

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ATOL = 1e-5


def _np(x):
    return np.asarray(x)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(_np(got.detach()), _np(ref), atol=atol, rtol=0)


def _bp(jp, tp, layer=1):
    return ({k: v[layer] for k, v in jp["blocks"].items()},
            ttfm.layer_params(tp, layer))


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_param_layout_matches_jax_init(kind):
    jcfg, tcfg = configs(kind)
    ref = jax.tree.map(lambda a: a.shape,
                       jtfm.init_params(jax.random.key(0), jcfg))
    got = ttfm.init_params(tcfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) == ref


def test_params_from_jax_rejects_mismatched_tree():
    _, tcfg = configs("mha")
    tree = numpy_params(tcfg)
    tree["head"] = tree["head"][:, :3]
    with pytest.raises(ValueError, match="head"):
        ttfm.params_from_jax(tree, tcfg, "cpu")
    _, gcfg = configs("gqa")
    with pytest.raises(ValueError, match="keys"):
        ttfm.params_from_jax(numpy_params(tcfg), gcfg, "cpu")


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((3, 5, 32), (32,), (32,)))
    _close(ttfm.layer_norm(t(x), t(s), t(b)),
           jtfm.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    pos = (rng.integers(0, 500, (3, 4)) if per_row
           else np.arange(7, 11)).astype(np.int32)
    _close(ttfm.apply_rope(t(x), t(pos), 10000.0),
           jtfm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_qkv_proj_ffn_unembed_match_jax(kind):
    jcfg, tcfg, jp, tp = both_params(kind)
    jbp, tbp = _bp(jp, tp)
    h = np.random.default_rng(2).standard_normal((2, 3, 32)).astype(
        np.float32)
    for got, ref in zip(ttfm._qkv_proj(tbp, t(h), tcfg),
                        jtfm._qkv_proj(jbp, jnp.asarray(h), jcfg)):
        assert tuple(got.shape) == ref.shape
        _close(got, ref)
    ref_ffn, _ = jtfm._ffn(jbp, jnp.asarray(h), jcfg, tp_axis=None,
                           ep_axis=None)
    _close(ttfm._ffn(tbp, t(h))[0], ref_ffn)
    _close(ttfm.unembed(tp, t(h)), jtfm.unembed(jp, jnp.asarray(h)))


def test_greedy_sampler_matches_jax():
    jcfg, tcfg = configs("mha")
    logits = np.random.default_rng(3).standard_normal((5, 64)).astype(
        np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # tie: first wins
    ref = jtfm.make_sampler(jcfg, 0.0, None, None)(jnp.asarray(logits),
                                                   None)
    got = ttfm.make_sampler(tcfg, 0.0, None, None)(t(logits))
    assert got.tolist() == np.asarray(ref).tolist()


@pytest.mark.parametrize("knobs", [dict(), dict(top_k=5), dict(top_p=0.5)])
def test_sampled_draws_depend_only_on_seed_and_position(knobs):
    _, tcfg = configs("mha")
    sample = ttfm.make_sampler(tcfg, 0.8, knobs.get("top_k"),
                               knobs.get("top_p"))
    logits = t(np.random.default_rng(4).standard_normal((3, 64)).astype(
        np.float32))
    a = sample(logits, [1, 2, 3], [10, 11, 12])
    # Row 1 alone, then with other neighbours: the same draw.
    b = sample(logits[1:2], [2], [11])
    c = sample(logits[[0, 1]], [9, 2], [0, 11])
    assert a[1] == b[0] == c[1]
    if "top_k" in knobs:
        top = set(torch.topk(logits, 5, dim=-1).indices[0].tolist())
        draws = {int(sample(logits[:1], [s], [0])[0]) for s in range(40)}
        assert draws <= top


def test_validate_sampling_rules_match_jax():
    jcfg, tcfg = configs("mha")
    for args in ((0.0, 4, None), (1.0, 0, None), (1.0, None, 1.5)):
        with pytest.raises(ValueError):
            jtfm.validate_sampling(jcfg, *args)
        with pytest.raises(ValueError):
            ttfm.validate_sampling(tcfg, *args)
    ttfm.validate_sampling(tcfg, 1.0, 8, 0.9)


def test_config_checks():
    with pytest.raises(ValueError, match="attn_window"):
        ttfm.TransformerConfig(attn_window=0)
    with pytest.raises(ValueError, match="divide"):
        ttfm.TransformerConfig(n_heads=4, n_kv_heads=3)
    with pytest.raises(ValueError, match="pos_embedding"):
        ttfm.TransformerConfig(pos_embedding="alibi")
    cfg = ttfm.TransformerConfig(d_model=64, n_heads=4, n_kv_heads=2)
    assert (cfg.head_dim, cfg.kv_heads, cfg.gqa) == (16, 2, True)
