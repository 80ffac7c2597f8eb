"""The port's ``generate_sharded`` against the JAX package's replicated
``generate`` (which ``tests/test_generate_sharded.py`` pins to JAX's own
``generate_sharded``): greedy tokens equal on (model 2), (data 2) and
(data 2, model 2) meshes of gloo ranks on the CPU — multi-head, learned
and rotary positions, grouped-query with the kv heads cut, multi-query
with ``wkv`` replicated, a sliding window, MoE with the experts
replicated, chunked prefill — each rank's cache holding its local kv
heads only, every rank returning the whole batch; sampled tokens on a data
split equal the port's replicated sampled run (a row's stream depends on
its global index); expert-parallel decode refused in JAX's words. One
spawn a mesh, every case inside it (``parallel/workers.generate_cases``).
f32, 2 layers, d 64."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import numpy_params
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.config import MeshConfig
from distributed_model_parallel_tpu_torch.models import transformer as ttfm

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64)
B, T0, STEPS = 4, 8, 8
SAMPLED = dict(seed=3, temperature=1.0, top_k=16)

# name -> (config kwargs, generate kwargs); the model axis is cut when the
# mesh has one (tp_axis="model").
CASES = {
    "mha_learned": (dict(), {}),
    "rope": (dict(pos_embedding="rope"), {}),
    "gqa_shard": (dict(pos_embedding="rope", n_kv_heads=2), {}),
    "mqa_replicate": (dict(pos_embedding="rope", n_kv_heads=1), {}),
    "window": (dict(pos_embedding="rope", attn_window=5,
                    attn_impl="flash"), {}),
    "moe": (dict(pos_embedding="rope", moe_experts=4, moe_top_k=2), {}),
    "chunked": (dict(pos_embedding="rope", n_kv_heads=2),
                dict(prefill_chunk=4)),
}
# mesh -> (MeshConfig kwargs, cases); one spawn a mesh, every case in it.
MESHES = {
    "model2": (dict(model=2), ["mha_learned", "gqa_shard", "mqa_replicate"]),
    "data2": (dict(data=2), ["rope", "moe", "sampled"]),
    "data2_model2": (dict(data=2, model=2),
                     ["gqa_shard", "window", "moe", "chunked", "sampled"]),
}


def _prompt():
    return np.random.default_rng(2).integers(0, 64, (B, T0)).astype(np.int32)


def _case(name: str, tp: bool):
    if name == "sampled":
        cfg_kw, kw = dict(pos_embedding="rope"), dict(SAMPLED)
    else:
        cfg_kw, kw = CASES[name]
    return dict(BASE, **cfg_kw, tp_axis="model" if tp else None), kw


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, tmp_path_factory):
    """One spawn of the mesh's ranks (gloo) running every case of
    ``MESHES[mesh]``; returns ``(mesh, {case: [rank results]})``."""
    from distributed_model_parallel_tpu_torch.parallel import workers

    name = request.param
    mesh_kw, names = MESHES[name]
    cases = []
    for case in names:
        cfg_kw, kw = _case(case, "model" in mesh_kw)
        tree = numpy_params(ttfm.TransformerConfig(**cfg_kw), seed=1)
        cases.append((cfg_kw, tree, _prompt(), STEPS, kw))
    world = mesh_kw.get("data", 1) * mesh_kw.get("model", 1)
    got = tmesh.spawn(workers.generate_cases, world, cases, device="cpu",
                      config=MeshConfig(**mesh_kw), threads=1,
                      store_dir=str(tmp_path_factory.mktemp("store")),
                      timeout_s=300)
    return name, {case: [rank[i] for rank in got]
                  for i, case in enumerate(names)}


@functools.lru_cache(maxsize=None)
def _jax_reference(name: str, shards: int) -> np.ndarray:
    """JAX's replicated ``generate`` of a case (no model axis), over the
    whole batch, or shard by shard of ``shards`` data rows: MoE capacity
    follows the tokens present, so a data split routes each shard's rows
    as a replicated run over those rows alone would (JAX's
    ``generate_sharded`` runs ``generate`` per shard too)."""
    cfg_kw, kw = _case(name, False)
    tree = numpy_params(ttfm.TransformerConfig(**cfg_kw), seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    rows = np.split(_prompt(), shards)
    return np.concatenate([np.asarray(jtfm.generate(
        jp, jcfg, jnp.asarray(r), STEPS,
        prefill_chunk=kw.get("prefill_chunk"))) for r in rows])


def test_greedy_tokens_equal_replicated_generate(mesh_run):
    mesh_name, out = mesh_run
    mesh_kw, names = MESHES[mesh_name]
    tp = "model" in mesh_kw
    for name in names:
        ranks = out[name]
        if name == "sampled":
            # The port's own replicated sampled run (JAX's draws differ).
            cfg_kw, kw = _case(name, False)
            tree = numpy_params(ttfm.TransformerConfig(**cfg_kw), seed=1)
            tcfg = ttfm.TransformerConfig(**cfg_kw)
            want = ttfm.generate(ttfm.params_from_jax(tree, tcfg, "cpu"),
                                 tcfg, _prompt(), STEPS, **kw).numpy()
            if tp:          # TP sums may move a draw at a near-tie: in vocab
                for r in ranks:
                    assert r["tokens"].shape == want.shape
                    assert ((r["tokens"] >= 0) & (r["tokens"] < 64)).all()
                continue
        else:
            moe = bool(CASES[name][0].get("moe_experts"))
            want = _jax_reference(name,
                                  mesh_kw.get("data", 1) if moe else 1)
        for rank, r in enumerate(ranks):
            np.testing.assert_array_equal(
                r["tokens"], want, err_msg=f"{mesh_name} {name} r{rank}")


def test_local_cache_holds_local_kv_heads_and_tp_reduces(mesh_run):
    """Each rank's cache: its data row's rows and its model slice of the
    kv heads (multi-query's single head replicated); two TP all-reduces a
    layer a step under a model axis (wo and the dense FFN; MoE's FFN is
    replicated, one), none without."""
    mesh_name, out = mesh_run
    mesh_kw, names = MESHES[mesh_name]
    d, m = mesh_kw.get("data", 1), mesh_kw.get("model", 1)
    for name in names:
        cfg = ttfm.TransformerConfig(**_case(name, m > 1)[0])
        hkv = cfg.kv_heads if cfg.kv_heads == 1 else cfg.kv_heads // m
        steps = T0 // 4 + STEPS - 1 if name == "chunked" else STEPS
        per_layer = 1 if cfg.moe_experts else 2
        for r in out[name]:
            assert r["cache_shape"] == (2, B // d, 16, hkv, 16), name
            assert r["tp_all_reduce"] == (
                per_layer * 2 * steps if m > 1 else 0), name


def test_expert_parallel_decode_refused():
    cfg = ttfm.TransformerConfig(**BASE, moe_experts=4, ep_axis="expert")
    with pytest.raises(ValueError, match="expert-parallel decode is not "
                                         "implemented"):
        ttfm.generate_sharded({}, cfg, _prompt(), STEPS, None)
    spec = tmesh.MeshSpec(MeshConfig(stage=2))
    with pytest.raises(ValueError, match=r"\(data, model\) mesh"):
        ttfm.generate_sharded({}, ttfm.TransformerConfig(**BASE), _prompt(),
                              STEPS, spec)
