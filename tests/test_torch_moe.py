"""The port's MoE (``ops/moe.py``) against the JAX package's
``ops/moe.py`` on the same numpy inputs: ``moe_ffn`` locally for top-1,
top-2 and raw gates, with capacity drops (second choices dropped), the
stats vector ``[balance, z, drop]`` and the routing of ``_route`` (experts,
gates, slots, kept choices), within 1e-5 (f32); forced ties resolved as
``lax.top_k`` resolves them (the lower expert first); the ``top_k``
range error in JAX's words; the plain per-token version. Over an expert
group of 2 and 4 gloo ranks (one spawn, ``parallel/workers.on_meshes``):
the output against JAX's, with the tokens replicated (the LM's layout)
and cut over the group (JAX's own EP test), and the gradients of
``router``, ``w_in``, ``w_out`` and the tokens at ``ep`` 2 and 4 against
JAX's at ``ep = 1`` — an expert gradient taken ``ep`` times would show
here as a factor of ``ep``. ``lm_model_flops`` of an MoE model equals
JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_model_parallel_tpu.config import MeshConfig as JMesh
from distributed_model_parallel_tpu.mesh import make_mesh
from distributed_model_parallel_tpu.ops import moe as jmoe
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.ops import moe as tmoe
from distributed_model_parallel_tpu_torch.parallel import workers

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
E, D, F = 4, 16, 32
WEIGHTS = (0.01, 0.001)
# name -> MoEConfig fields
CFGS = {
    "top1": dict(capacity_factor=8.0),
    "top2": dict(capacity_factor=8.0, top_k=2),
    "top2_raw": dict(capacity_factor=8.0, top_k=2, normalize_gates=False),
    "top1_tight": dict(capacity_factor=0.1),
    "top2_tight": dict(capacity_factor=0.25, top_k=2),
    "top3_tight": dict(capacity_factor=0.5, top_k=3),
}


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((D, E)) * D ** -0.5
                       ).astype(np.float32),
            "w_in": (rng.standard_normal((E, D, F)) * D ** -0.5
                     ).astype(np.float32),
            "w_out": (rng.standard_normal((E, F, D)) * F ** -0.5
                      ).astype(np.float32)}


def _x(seed=1, shape=(8, 4, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(name):
    kw = dict(num_experts=E, d_model=D, d_ff=F, **CFGS[name])
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jloss(params, x, dy, cfg):
    y, aux = jmoe.moe_ffn(params, x, cfg)
    return jnp.sum(y * dy) + WEIGHTS[0] * aux[0] + WEIGHTS[1] * aux[1]


@pytest.mark.parametrize("name", list(CFGS))
def test_moe_ffn_matches_jax(name):
    jc, tc = _cfgs(name)
    tree, x = _tree(), _x()
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                            jc)
    ty, taux = tmoe.moe_ffn(_t(tree), torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), atol=ATOL,
                               rtol=0)
    if "tight" in name:
        assert float(taux[2]) > 0
    else:
        assert float(taux[2]) == 0.0


@pytest.mark.parametrize("name", list(CFGS))
def test_route_matches_jax(name):
    """Experts, gates, slots, kept choices and the capacity of the index
    form, choice by choice."""
    jc, tc = _cfgs(name)
    tree, x = _tree(), _x().reshape(-1, D)
    je, jg, js, jk, jcap, _ = jmoe._route(jnp.asarray(tree["router"]),
                                          jnp.asarray(x), jc)
    te, tg, ts, tk, tcap, _ = tmoe.route(torch.from_numpy(tree["router"]),
                                         torch.from_numpy(x), tc)
    assert tcap == jcap
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL, rtol=0)


def test_second_choices_dropped_first():
    """Under a tight capacity the second choices queue behind every first
    choice: they are dropped first, and dropped choices give zero rows."""
    _, tc = _cfgs("top2_tight")
    x = torch.from_numpy(_x())
    _, _, _, keep, _, stats = tmoe.route(torch.from_numpy(_tree()["router"]),
                                         x.reshape(-1, D), tc)
    assert keep[:, 1].float().mean() < keep[:, 0].float().mean()
    np.testing.assert_allclose(float(stats[2]),
                               1.0 - keep.float().mean().item(), atol=1e-7)
    _, t1 = _cfgs("top1_tight")
    y, _ = tmoe.moe_ffn(_t(_tree()), x, t1)
    assert (y.reshape(-1, D).abs().sum(-1) == 0).any()


def test_ties_take_the_lower_expert_as_lax_top_k():
    """Equal router probabilities (a zero router: every expert ties, and
    pairs of equal columns) route to the lower expert index first, as
    ``jax.lax.top_k`` does."""
    for router in (np.zeros((D, E), np.float32),
                   np.repeat(_tree()["router"][:, :2], 2, axis=1)):
        x = _x().reshape(-1, D)
        for name in ("top1", "top2"):
            jc, tc = _cfgs(name)
            je = jmoe._route(jnp.asarray(router), jnp.asarray(x), jc)[0]
            te = tmoe.route(torch.from_numpy(router), torch.from_numpy(x),
                            tc)[0]
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    zero = tmoe.route(torch.zeros(D, E), torch.from_numpy(x), tc)[0]
    assert (zero[:, 0] == 0).all() and (zero[:, 1] == 1).all()


def test_top_k_out_of_range_raises_in_jax_words():
    for k in (0, 3):
        with pytest.raises(ValueError, match=r"top_k=\d must be in \[1, "
                                             r"num_experts=2\]"):
            tmoe.MoEConfig(num_experts=2, top_k=k)
        with pytest.raises(ValueError, match=r"top_k=\d must be in"):
            jmoe.MoEConfig(num_experts=2, top_k=k)


@pytest.mark.parametrize("name", ["top1", "top2", "top2_tight"])
def test_naive_version_matches(name):
    _, tc = _cfgs(name)
    x = torch.from_numpy(_x())
    y, _ = tmoe.moe_ffn(_t(_tree()), x, tc)
    torch.testing.assert_close(tmoe.naive_moe_ffn(_t(_tree()), x, tc), y,
                               atol=ATOL, rtol=0)


# -- over an expert group ---------------------------------------------------------

EP_CASES = {      # name -> (mesh, config, tokens cut over the group)
    "ep2_top2": (dict(data=2, expert=2), "top2", False),
    "ep2_top2_tight": (dict(data=2, expert=2), "top2_tight", False),
    "ep4_top1": (dict(expert=4), "top1", False),
    "ep4_top2_tight": (dict(expert=4), "top2_tight", False),
    "ep4_top2_sharded_x": (dict(expert=4), "top2", True),
}


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    tree, x = _tree(), _x()
    dy = _x(seed=2)
    cases = [(tconfig.MeshConfig(**mesh), "moe_exchange",
              (tree, x, dy, dict(num_experts=E, d_model=D, d_ff=F,
                                 **CFGS[cfg]), shard, WEIGHTS))
             for mesh, cfg, shard in EP_CASES.values()]
    out = tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                      timeout_s=240,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    return {name: [r[i] for r in out] for i, name in enumerate(EP_CASES)}


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_group_output_matches_jax(ep_runs, name):
    mesh, cfg, shard = EP_CASES[name]
    jc, _ = _cfgs(cfg)
    tree, x = _tree(), _x()
    ranks = ep_runs[name]
    if shard:
        # JAX's own EP test: tokens cut over the expert axis.
        spec = make_mesh(JMesh(**mesh))

        def fn(p, x):
            y, aux = jmoe.moe_ffn(p, x, jc, ep_axis="expert")
            return y, jax.lax.pmean(aux, "expert")

        y, _ = jax.shard_map(
            fn, mesh=spec.mesh,
            in_specs=({"router": P(), "w_in": P("expert"),
                       "w_out": P("expert")}, P("expert")),
            out_specs=(P("expert"), P()), check_vma=False)(
                jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
        np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                                   np.asarray(y), atol=ATOL, rtol=0)
        return
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                            jc)
    for r in ranks:
        np.testing.assert_allclose(r["y"], np.asarray(jy), atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["stats"], np.asarray(jaux), atol=ATOL,
                                   rtol=0)
        assert r["calls"].get("moe") == 4      # 2 forward, 2 backward


@pytest.mark.parametrize("name", [n for n, c in EP_CASES.items()
                                  if not c[2]])
def test_expert_group_grads_match_jax_at_ep1(ep_runs, name):
    """Tokens replicated over the group (the LM's layout): every rank's
    router and token gradients, and the experts' gradients gathered over
    the group, equal JAX's on one device — not ``ep`` times them."""
    _, cfg, _ = EP_CASES[name]
    jc, _ = _cfgs(cfg)
    tree, x, dy = _tree(), _x(), _x(seed=2)
    g, gx = jax.grad(_jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(dy), jc)
    ranks = ep_runs[name]
    n = E // ranks[0]["grads"]["w_in"].shape[0]     # ranks[:n]: expert 0..n-1
    for r in ranks:
        np.testing.assert_allclose(r["grads"]["router"],
                                   np.asarray(g["router"]), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(r["dx"], np.asarray(gx), atol=ATOL,
                                   rtol=0)
    for key in ("w_in", "w_out"):
        whole = np.concatenate([r["grads"][key] for r in ranks[:n]])
        np.testing.assert_allclose(whole, np.asarray(g[key]), atol=ATOL,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("k", [1, 2])
def test_lm_model_flops_counts_moe_as_jax(k):
    """``utils/profiling.lm_model_flops`` of an MoE model (the top-k
    experts' slice and the router) equals the JAX package's."""
    from distributed_model_parallel_tpu.models import transformer as jtfm
    from distributed_model_parallel_tpu.utils.profiling import (
        lm_model_flops as jflops,
    )
    from distributed_model_parallel_tpu_torch.models import (
        transformer as ttfm,
    )
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        lm_model_flops as tflops,
    )

    kw = dict(vocab_size=32_000, d_model=1024, n_heads=8, n_layers=8,
              d_ff=4096, moe_experts=8, moe_top_k=k)
    assert tflops(ttfm.TransformerConfig(**kw), 2, 8192) == jflops(
        jtfm.TransformerConfig(**kw), 2, 8192)
    dense = dict(kw, moe_experts=0)
    assert tflops(ttfm.TransformerConfig(**kw), 2, 8192) > tflops(
        ttfm.TransformerConfig(**dense), 2, 8192)
