"""The port's Megatron tensor parallelism (``parallel/tensor_parallel.py``
and the model's ``copy_to_group``/``reduce_from_group``) against the JAX
package: the cut dim of every leaf against JAX's PartitionSpecs, slices
that concatenate back to the whole leaf, and at ``(data 2, model 2)`` the
loss and every gradient (after the replica reduction, gathered whole)
against ``jax.value_and_grad`` of the single-device model, and one step
against JAX's sharded ``make_spmd_train_step`` — multi-head, grouped-query
with the kv heads cut (``n_kv_heads=2``) and multi-query with ``wkv``
replicated (``n_kv_heads=1``), mirroring ``tests/test_gqa.py``. A kv head
count that neither divides the tensor-parallel ways nor is 1 raises in
JAX's words. atol 1e-4 (f32)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_port_util import SHAPES, numpy_params
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.mesh import make_mesh
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel import tensor_parallel as jtp
from distributed_model_parallel_tpu.parallel.spmd_pipeline import (
    make_spmd_train_step,
    shard_params as jshard_params,
)
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import tensor_parallel as ttp
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm

pytestmark = pytest.mark.torch_port

ATOL = 1e-4
B, T = 4, 16
MESH = dict(data=2, model=2)
KINDS = {
    "mha": dict(SHAPES["learned"]),
    "gqa_shard": dict(SHAPES["gqa"]),                       # kv 2 / tp 2
    "mqa_replicate": dict(SHAPES["gqa"], n_kv_heads=1),
}
OPT = dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-2,
           grad_clip_norm=0.5)


def _batch(seed=7):
    tk = np.random.default_rng(seed).integers(0, 64, (B, T + 1))
    return tk[:, :-1].astype(np.int32), tk[:, 1:].astype(np.int32)


def _config(root, name, kind):
    cfg = ttfm.TransformerConfig(**KINDS[kind], tp_axis="model")
    return tlm.LMTrainConfig(
        model=cfg, mesh=tconfig.MeshConfig(**MESH),
        optimizer=tconfig.OptimizerConfig(**OPT), batch_size=B, seq_len=T,
        steps_per_epoch=1, n_tokens=500, eval_batches=0, device="cpu",
        log_dir=os.path.join(root, name),
        checkpoint_dir=os.path.join(root, name, "ckpt"))


def _tree(kind):
    return numpy_params(ttfm.TransformerConfig(**KINDS[kind]))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    toks, tgts = _batch()
    cases = []
    for kind in KINDS:
        config = _config(root, kind, kind)
        cases.append((config.mesh, "lm_grads",
                      (config, _tree(kind), toks, tgts)))
        cases.append((config.mesh, "lm_steps",
                      (_config(root, kind + "_step", kind), _tree(kind),
                       [(toks, tgts)])))
    out = tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                      timeout_s=300,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    return {kind: (out[0][2 * i], [r[2 * i + 1] for r in out])
            for i, kind in enumerate(KINDS)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_and_grads_match_jax_single_device(port, kind):
    grads, _ = port[kind]
    jcfg = jtfm.TransformerConfig(**KINDS[kind])
    toks, tgts = _batch()
    loss, g = jax.value_and_grad(jtfm.lm_loss)(
        jax.tree.map(jnp.asarray, _tree(kind)), jnp.asarray(toks),
        jnp.asarray(tgts), jcfg)
    assert abs(grads["loss"] - float(loss)) <= ATOL
    want = dict(_leaves(jax.tree.map(np.asarray, g)))
    for key, leaf in _leaves(grads["grads"]):
        np.testing.assert_allclose(leaf, want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("kind", list(KINDS))
def test_step_matches_jax_sharded_step(port, kind):
    _, steps = port[kind]
    jcfg = jtfm.TransformerConfig(**KINDS[kind], tp_axis="model")
    spec = make_mesh(jconfig.MeshConfig(**MESH))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(**OPT), 1, 1)
    host = jax.tree.map(jnp.asarray, _tree(kind))
    opt_state = jax.device_put(tx.init(host), NamedSharding(spec.mesh, P()))
    params = jshard_params(host, jcfg, spec)
    toks, tgts = _batch()
    params, _, m = make_spmd_train_step(jcfg, spec, tx)(
        params, opt_state, jnp.asarray(toks), jnp.asarray(tgts))
    assert abs(steps[0]["losses"][0] - float(m["loss"])) <= ATOL
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    for key, leaf in _leaves(steps[0]["params"]):
        np.testing.assert_allclose(leaf, want[key], atol=ATOL, rtol=0,
                                   err_msg=key)
    # The kv heads: cut over the model ranks, or whole on each (MQA).
    local = [dict(_leaves(r["local"])) for r in steps]
    if kind != "mha":
        whole = KINDS[kind].get("n_kv_heads", 2)
        shard = whole if kind == "mqa_replicate" else whole // 2
        assert local[0]["blocks.wkv"].shape[2] == shard


@pytest.mark.parametrize("kind", list(KINDS))
def test_shard_dims_follow_jax_specs(kind):
    """The port's cut dim of each leaf is where JAX's spec names the
    model axis; the slices concatenate back to the whole leaf."""
    tcfg = ttfm.TransformerConfig(**KINDS[kind], tp_axis="model")
    jcfg = jtfm.TransformerConfig(**KINDS[kind], tp_axis="model")
    spec = make_mesh(jconfig.MeshConfig(**MESH))
    specs = jtp.param_specs(None, "model", learned_pos=(
        tcfg.pos_embedding == "learned"), gqa=jcfg.gqa,
        shard_kv=jtp.kv_heads_shardable(jcfg, spec))
    dims = ttp.param_shard_dims(tcfg, 2)
    want = {k: (list(ps).index("model") if "model" in tuple(ps) else None)
            for k, ps in _leaves(jax.tree.map(
                lambda x: x, specs, is_leaf=lambda x: isinstance(x, P)))}
    assert dict(_leaves(dims)) == want
    tree = ttfm.params_from_jax(_tree(kind), tcfg, "cpu")
    parts = [ttp.shard_params(tree, tcfg, 2, i) for i in range(2)]
    for key, dim in _leaves(dims):
        whole = dict(_leaves(tree))[key]
        got = [dict(_leaves(p))[key] for p in parts]
        if dim is None:
            assert all(g is whole for g in got)
        else:
            torch.testing.assert_close(torch.cat(got, dim), whole, atol=0,
                                       rtol=0)


def test_unmappable_kv_heads_raise_in_jax_words():
    """n_kv_heads=2 over 4 tensor-parallel ways: neither divisible nor
    multi-query."""
    tcfg = ttfm.TransformerConfig(**SHAPES["gqa"], tp_axis="model")
    jcfg = jtfm.TransformerConfig(**SHAPES["gqa"], tp_axis="model")
    match = "neither divisible by the tensor-parallel ways"
    with pytest.raises(ValueError, match=match):
        ttp.kv_heads_shardable(tcfg, 4)
    with pytest.raises(ValueError, match=match):
        jtp.kv_heads_shardable(jcfg, make_mesh(jconfig.MeshConfig(model=4)))
    assert ttp.kv_heads_shardable(tcfg, 2)
    assert not ttp.kv_heads_shardable(
        ttfm.TransformerConfig(**SHAPES["gqa"] | dict(n_kv_heads=1),
                               tp_axis="model"), 4)
