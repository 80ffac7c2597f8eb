"""The port's LM training step over a ``(data, model, seq)`` mesh
(``parallel/spmd_lm.py`` through ``LMTrainer.train_step``) against the JAX
package's ``make_spmd_train_step`` on the same mesh: two steps of SGD
(momentum, weight decay, the global-norm clip over tensor-parallel
slices), adamw and lamb (its trust ratio over the slices) at ``(data 2,
model 2)``, ``(model 2, seq 2)`` with ring attention and ``(data 2, seq
2)`` with Ulysses, RoPE and learned positions — losses and the whole
parameters after, within 1e-4 (f32). Replicas hold bitwise equal slices.
Remat (full, dots) and the chunked head leave the loss and every gradient
within 1e-5 of the dense head without remat on the ``(model 2, seq 2)``
mesh, and a chunk JAX refuses raises in its words. The port's ranks are 4
gloo processes spawned once per module (``parallel/workers.on_meshes``);
JAX runs on 4 of conftest's virtual devices."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_port_util import SHAPES, numpy_params
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.mesh import make_mesh
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel.spmd_pipeline import (
    make_spmd_train_step,
    shard_params,
)
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm

pytestmark = pytest.mark.torch_port

ATOL = 1e-4
B, T = 4, 32
MESHES = {
    "data2_model2": (dict(data=2, model=2), dict(tp_axis="model")),
    "model2_seq2_ring": (dict(model=2, seq=2),
                         dict(tp_axis="model", sp_axis="seq")),
    "data2_seq2_ulysses": (dict(data=2, seq=2),
                           dict(sp_axis="seq", sp_impl="ulysses")),
}
OPTS = {
    "sgd": dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-2,
                grad_clip_norm=0.5),
    "adamw": dict(name="adamw", learning_rate=0.01, weight_decay=1e-2),
    "lamb": dict(name="lamb", learning_rate=0.01, weight_decay=1e-2),
}
# case -> (mesh, position embedding, optimizer)
CASES = {
    "data2_model2_rope_sgd": ("data2_model2", "rope", "sgd"),
    "model2_seq2_ring_rope_sgd": ("model2_seq2_ring", "rope", "sgd"),
    "data2_seq2_ulysses_rope_sgd": ("data2_seq2_ulysses", "rope", "sgd"),
    "model2_seq2_ring_learned_adamw": ("model2_seq2_ring", "learned",
                                       "adamw"),
    "data2_model2_learned_lamb": ("data2_model2", "learned", "lamb"),
    "data2_seq2_ulysses_learned_lamb": ("data2_seq2_ulysses", "learned",
                                        "lamb"),
}
# Remat and chunked-head variants on the (model 2, seq 2) ring mesh; the
# last chunk divides the whole sequence (as JAX requires) but not a
# rank's shard of 16 tokens.
VARIANTS = {
    "dense": {},
    "remat_full": dict(remat=True),
    "remat_dots": dict(remat=True, remat_policy="dots"),
    "loss_chunk8": dict(loss_chunk=8),
    "loss_chunk8_dots": dict(loss_chunk=8, remat=True, remat_policy="dots"),
    "loss_chunk32": dict(loss_chunk=32),
}


def _shape(pos):
    return SHAPES["learned" if pos == "learned" else "mha"]


def _batches(seed=3, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tk = rng.integers(0, 64, (B, T + 1)).astype(np.int32)
        out.append((tk[:, :-1], tk[:, 1:]))
    return out


def _port_config(root, name, mesh, model_kw, pos, opt):
    cfg = ttfm.TransformerConfig(**_shape(pos), **model_kw)
    return tlm.LMTrainConfig(
        model=cfg, mesh=tconfig.MeshConfig(**mesh),
        optimizer=tconfig.OptimizerConfig(**OPTS[opt]), batch_size=B,
        seq_len=T, steps_per_epoch=2, n_tokens=500, eval_batches=0,
        device="cpu", log_dir=os.path.join(root, name),
        checkpoint_dir=os.path.join(root, name, "ckpt"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    cases = []
    for name, (mesh_name, pos, opt) in CASES.items():
        mesh, kw = MESHES[mesh_name]
        config = _port_config(root, name, mesh, kw, pos, opt)
        cases.append((config.mesh, "lm_steps",
                      (config, numpy_params(config.model), _batches())))
    mesh, kw = MESHES["model2_seq2_ring"]
    toks, tgts = _batches(seed=5, n=1)[0]
    for name, extra in VARIANTS.items():
        config = _port_config(root, name, mesh, {**kw, **extra}, "rope",
                              "sgd")
        cases.append((config.mesh, "lm_grads",
                      (config, numpy_params(config.model), toks, tgts)))
    out = tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                      timeout_s=300,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    n = len(CASES)
    return ({name: [r[i] for r in out] for i, name in enumerate(CASES)},
            {name: out[0][n + i] for i, name in enumerate(VARIANTS)})


def _jax_steps(name):
    """Losses and final parameters of JAX's sharded step on the case's
    mesh, from the same weights and batches."""
    mesh_name, pos, opt = CASES[name]
    mesh, kw = MESHES[mesh_name]
    jcfg = jtfm.TransformerConfig(**_shape(pos), **kw)
    tree = numpy_params(ttfm.TransformerConfig(**_shape(pos)))
    spec = make_mesh(jconfig.MeshConfig(**mesh))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(**OPTS[opt]), 2, 1)
    host = jax.tree.map(jnp.asarray, tree)
    opt_state = jax.device_put(tx.init(host), NamedSharding(spec.mesh, P()))
    params = shard_params(host, jcfg, spec)
    step = make_spmd_train_step(jcfg, spec, tx)
    losses = []
    for toks, tgts in _batches():
        params, opt_state, m = step(params, opt_state, jnp.asarray(toks),
                                    jnp.asarray(tgts))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, params)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_spmd_train_step(port, name):
    runs, _ = port
    losses, params = _jax_steps(name)
    got = runs[name][0]
    np.testing.assert_allclose(got["losses"], losses, atol=ATOL, rtol=0)
    want = dict(_leaves(params))
    for key, leaf in _leaves(got["params"]):
        np.testing.assert_allclose(leaf, want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_replicas_hold_bitwise_equal_slices(port, name):
    """Every rank's losses are the same, and the ranks of one model index
    (the data and seq replicas) hold bitwise equal slices; a replicated
    leaf is bitwise equal across the model ranks too."""
    runs, _ = port
    ranks = runs[name]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["grid"][2], []).append(dict(_leaves(r["local"])))
    for group in by_model.values():
        for other in group[1:]:
            for key, leaf in group[0].items():
                np.testing.assert_array_equal(other[key], leaf, err_msg=key)
    tp = ttfm.TransformerConfig(**_shape(CASES[name][1]))
    whole = dict(_leaves(numpy_params(tp)))
    firsts = [g[0] for g in by_model.values()]
    for key, leaf in firsts[0].items():
        if leaf.shape == whole[key].shape:
            for other in firsts[1:]:
                np.testing.assert_array_equal(other[key], leaf, err_msg=key)


@pytest.mark.parametrize("name", [v for v in VARIANTS if v != "dense"])
def test_remat_and_chunked_head_match_dense(port, name):
    _, grads = port
    ref, got = grads["dense"], grads[name]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5
    want = dict(_leaves(ref["grads"]))
    for key, g in _leaves(got["grads"]):
        np.testing.assert_allclose(g, want[key], atol=1e-5, rtol=0,
                                   err_msg=key)


def test_dense_grads_match_jax_single_device(port):
    """The mesh's dense loss and gradients against ``jax.value_and_grad``
    of the single-device ``lm_loss`` on the same batch (1e-5 in loss,
    1e-4 a gradient)."""
    _, grads = port
    jcfg = jtfm.TransformerConfig(**_shape("rope"))
    tree = numpy_params(ttfm.TransformerConfig(**_shape("rope")))
    toks, tgts = _batches(seed=5, n=1)[0]
    loss, g = jax.value_and_grad(jtfm.lm_loss)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
        jnp.asarray(tgts), jcfg)
    assert abs(grads["dense"]["loss"] - float(loss)) <= 1e-5
    want = dict(_leaves(jax.tree.map(np.asarray, g)))
    for key, leaf in _leaves(grads["dense"]["grads"]):
        np.testing.assert_allclose(leaf, want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("chunk", [5, 24])
def test_chunk_jax_refuses_raises(chunk):
    """A chunk that does not divide the whole sequence raises in JAX's
    words in both packages (the port checks the whole sequence from a
    rank's shard: 16 tokens x seq 2)."""
    cfg = ttfm.TransformerConfig(**_shape("rope"), loss_chunk=chunk)
    with pytest.raises(ValueError, match=f"seq len 32 not divisible by "
                                         f"loss_chunk={chunk}"):
        ttfm.local_loss_chunk(cfg, 16, 2)
    jcfg = jtfm.TransformerConfig(**_shape("rope"), loss_chunk=chunk)
    tree = jax.tree.map(jnp.asarray, numpy_params(
        ttfm.TransformerConfig(**_shape("rope"))))
    toks = jnp.zeros((2, 32), jnp.int32)
    with pytest.raises(ValueError, match="not divisible by loss_chunk"):
        jtfm.lm_loss(tree, toks, toks, jcfg)


def test_unported_pipeline_options_raise():
    """The pipeline's options run now (tests/test_torch_spmd_pipeline_lm.
    py); what the step still refuses raises in the JAX package's words:
    virtual stages under gpipe, an unknown schedule, an interleaved
    microbatch count the stages do not divide, and a layer count the
    stages do not split."""
    from distributed_model_parallel_tpu_torch.parallel import spmd_lm

    cfg = ttfm.TransformerConfig(**dict(_shape("rope"), n_layers=4))
    for mesh, kw in ((tconfig.MeshConfig(), dict(num_microbatches=2)),
                     (tconfig.MeshConfig(), dict(schedule="1f1b")),
                     (tconfig.MeshConfig(stage=2),
                      dict(schedule="1f1b", num_microbatches=2,
                           virtual_stages=2))):
        spmd_lm.check_spmd_config(cfg, mesh, **kw)
    with pytest.raises(ValueError, match="1f1b schedule feature"):
        spmd_lm.check_spmd_config(cfg, tconfig.MeshConfig(),
                                  virtual_stages=2)
    with pytest.raises(ValueError, match="unknown spmd pipeline schedule"):
        spmd_lm.check_spmd_config(cfg, tconfig.MeshConfig(), schedule="zb")
    with pytest.raises(ValueError, match="Megatron constraint"):
        spmd_lm.check_spmd_config(cfg, tconfig.MeshConfig(stage=2),
                                  num_microbatches=3, schedule="1f1b",
                                  virtual_stages=2)
    with pytest.raises(ValueError, match="does not split over 3 stages"):
        spmd_lm.check_spmd_config(cfg, tconfig.MeshConfig(stage=3))
