"""The port's MoE Transformer LM over the expert axis, alone and with the
stage and model axes, against the JAX package's ``make_spmd_train_step``
on the same mesh: two steps of SGD (momentum, weight decay and the
global-norm clip over slices cut over one and two axes), adamw and lamb
(its trust ratio over a stage x expert slice) at ``(data 2, expert 2)``,
``(stage 2, expert 2)`` with interleaved 1F1B at ``virtual_stages=2``,
and ``(model 2, expert 2)`` — the losses, the router's stats (balance, z,
drop) and the whole parameters after, within 1e-4 (f32), top-2 routing
at capacity factor 1.5, so choices are dropped. After every step the
ranks that hold the same slice hold it bit for bit. The gradients at
``(expert 4)`` and ``(model 2, expert 2)`` — every token routed on every
rank — equal ``jax.value_and_grad`` of the one-device ``lm_loss``: the
expert weights' gradient is taken once, not ``ep`` times. 4 gloo ranks,
one spawn (``parallel/workers.on_meshes``); JAX on 4 of conftest's
virtual devices."""

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
from distributed_model_parallel_tpu.parallel import spmd_pipeline as jsp
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import (
    tensor_parallel as ttp,
)
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm

pytestmark = pytest.mark.torch_port

ATOL = 1e-4
B, T, LAYERS = 8, 32, 4
MOE = dict(moe_experts=4, moe_top_k=2)
MESHES = {     # name -> (mesh, model axes, M, schedule, V)
    "data2_expert2": (dict(data=2, expert=2), dict(ep_axis="expert"), 1,
                      "gpipe", 1),
    "stage2_expert2_v2": (dict(stage=2, expert=2), dict(ep_axis="expert"),
                          2, "1f1b", 2),
    "model2_expert2": (dict(model=2, expert=2),
                       dict(ep_axis="expert", tp_axis="model"), 1, "gpipe",
                       1),
}
OPTS = {
    "sgd": dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-2,
                grad_clip_norm=0.5),
    "adamw": dict(name="adamw", learning_rate=0.01, weight_decay=1e-2),
    "lamb": dict(name="lamb", learning_rate=0.01, weight_decay=1e-2),
}
CASES = {      # name -> (mesh, optimizer)
    "data2_expert2_sgd": ("data2_expert2", "sgd"),
    "data2_expert2_adamw": ("data2_expert2", "adamw"),
    "stage2_expert2_v2_sgd": ("stage2_expert2_v2", "sgd"),
    "stage2_expert2_v2_lamb": ("stage2_expert2_v2", "lamb"),
    "model2_expert2_sgd": ("model2_expert2", "sgd"),
}
GRAD_MESHES = {  # every token routed on every rank: the one-device routing
    "expert4": (dict(expert=4), dict(ep_axis="expert")),
    "model2_expert2": (dict(model=2, expert=2),
                       dict(ep_axis="expert", tp_axis="model")),
}
METRICS = ("loss", "moe_balance", "moe_z", "moe_drop")


def _shape():
    return dict(SHAPES["mha"], n_layers=LAYERS, **MOE)


def _batches(seed=3, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tk = rng.integers(0, 64, (B, T + 1)).astype(np.int32)
        out.append((tk[:, :-1], tk[:, 1:]))
    return out


def _config(root, name, mesh, axes, M, schedule, V, opt):
    return tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**_shape(), **axes),
        mesh=tconfig.MeshConfig(**mesh),
        optimizer=tconfig.OptimizerConfig(**OPTS[opt]), batch_size=B,
        seq_len=T, num_microbatches=M, pipeline_schedule=schedule,
        virtual_stages=V, steps_per_epoch=2, n_tokens=500, eval_batches=0,
        device="cpu", log_dir=os.path.join(root, name),
        checkpoint_dir=os.path.join(root, name, "ckpt"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    tree = numpy_params(ttfm.TransformerConfig(**_shape()))
    cases = []
    for name, (mesh_name, opt) in CASES.items():
        config = _config(root, name, *MESHES[mesh_name], opt)
        cases.append((config.mesh, "lm_steps", (config, tree, _batches())))
    toks, tgts = _batches(seed=5, n=1)[0]
    for name, (mesh, axes) in GRAD_MESHES.items():
        config = _config(root, f"grads_{name}", mesh, axes, 1, "gpipe", 1,
                         "sgd")
        cases.append((config.mesh, "lm_pipeline_grads",
                      (config, tree, toks, tgts, ["gpipe"])))
    out = tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                      timeout_s=400,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    n = len(CASES)
    return ({name: [r[i] for r in out] for i, name in enumerate(CASES)},
            {name: out[0][n + i]["gpipe"]
             for i, name in enumerate(GRAD_MESHES)})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _jax_steps(name):
    """JAX's per-step metrics and final parameters (canonical order) on
    the case's mesh, from the same weights and batches."""
    mesh_name, opt = CASES[name]
    mesh, axes, M, schedule, V = MESHES[mesh_name]
    jcfg = jtfm.TransformerConfig(**_shape(), **axes)
    host = jax.tree.map(jnp.asarray,
                        numpy_params(ttfm.TransformerConfig(**_shape())))
    S = mesh.get("stage", 1)
    host["blocks"] = jsp.interleave_block_rows(host["blocks"], LAYERS, S, V)
    spec = make_mesh(jconfig.MeshConfig(**mesh))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(**OPTS[opt]), 2, 1)
    opt_state = jax.device_put(tx.init(host), NamedSharding(spec.mesh, P()))
    params = jsp.shard_params(host, jcfg, spec)
    step = jsp.make_spmd_train_step(jcfg, spec, tx, num_microbatches=M,
                                    schedule=schedule, virtual_stages=V)
    metrics = []
    for toks, tgts in _batches():
        params, opt_state, m = step(params, opt_state, jnp.asarray(toks),
                                    jnp.asarray(tgts))
        metrics.append({k: float(m[k]) for k in METRICS})
    params = jax.tree.map(np.asarray, params)
    params["blocks"] = jsp.deinterleave_block_rows(params["blocks"], LAYERS,
                                                   S, V)
    return metrics, params


def _adam_conditioned(name) -> dict:
    """Per leaf, where JAX's first gradient on the case's mesh is zero
    (a token the batch lacks) or at least ADAM_FLOOR. Adam's first update is ``g / (|g| + 1e-8)``: where
    ``|g|`` is near its eps, the f32 noise between two correct gradients
    (1.7e-8 measured at data2_expert2, gradients up to 2e-2) moves the
    update by O(lr). Those few elements are held on their gradient
    (``test_expert_grads_match_jax_one_device`` and the SGD cases)."""
    mesh_name, _ = CASES[name]
    mesh, axes, M, _, _ = MESHES[mesh_name]
    jcfg = jtfm.TransformerConfig(**_shape(), **axes)
    spec = make_mesh(jconfig.MeshConfig(**mesh))
    params = jsp.shard_params(jax.tree.map(jnp.asarray, numpy_params(
        ttfm.TransformerConfig(**_shape()))), jcfg, spec)
    toks, tgts = (jnp.asarray(a) for a in _batches()[0])
    _, g = jax.jit(jax.value_and_grad(jsp._make_loss_fn(jcfg, spec, M),
                                      has_aux=True))(params, toks, tgts)
    return {k: (np.abs(v) >= ADAM_FLOOR) | (v == 0)
            for k, v in _leaves(jax.tree.map(np.asarray, g))}


ADAM_FLOOR = 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_spmd_train_step(port, name):
    runs, _ = port
    metrics, params = _jax_steps(name)
    got = runs[name][0]
    for step, (a, b) in enumerate(zip(got["metrics"], metrics)):
        for k in METRICS:
            assert abs(a[k] - b[k]) <= ATOL, (step, k, a[k], b[k])
    assert any(m["moe_drop"] > 0 for m in metrics)
    want = dict(_leaves(params))
    held = (_adam_conditioned(name) if OPTS[CASES[name][1]].get("name")
            == "adamw" else None)
    for key, leaf in _leaves(got["params"]):
        if held is None:
            np.testing.assert_allclose(leaf, want[key], atol=ATOL, rtol=0,
                                       err_msg=key)
            continue
        assert held[key].mean() > 0.999, key
        np.testing.assert_allclose(leaf[held[key]], want[key][held[key]],
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_slice_holders_bitwise_equal(port, name):
    """After every step, every rank's metrics are the same and the ranks
    that hold the same slice of a leaf (its replicas over data and seq,
    and over every axis it is not cut along: embedding and head over the
    stages, attention and the router over the experts) hold it bit for
    bit."""
    runs, _ = port
    ranks = runs[name]
    mesh, axes, *_ = MESHES[CASES[name][0]]
    spec = tmesh.MeshSpec(tconfig.MeshConfig(**mesh))
    cuts = dict(_leaves(ttp.param_cuts(
        ttfm.TransformerConfig(**_shape(), **axes), spec)))
    axis_index = {"stage": 1, "model": 2, "expert": 4}
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    for step in range(len(ranks[0]["steps_local"])):
        for key in cuts:
            held: dict = {}
            for r in ranks:
                slice_id = tuple(r["grid"][axis_index[a]]
                                 for a, _ in cuts[key])
                leaf = dict(_leaves(r["steps_local"][step]))[key]
                if slice_id in held:
                    np.testing.assert_array_equal(leaf, held[slice_id],
                                                  err_msg=key)
                held[slice_id] = leaf


@pytest.mark.parametrize("name", list(GRAD_MESHES))
def test_expert_grads_match_jax_one_device(port, name):
    """Every token routed on every rank: the loss, the stats and every
    gradient equal the one-device JAX ``lm_loss``'s (an expert gradient
    taken ``ep`` times would be 2 or 4 times it)."""
    _, grads = port
    jcfg = jtfm.TransformerConfig(**_shape())
    tree = jax.tree.map(jnp.asarray,
                        numpy_params(ttfm.TransformerConfig(**_shape())))
    toks, tgts = (jnp.asarray(a) for a in _batches(seed=5, n=1)[0])

    def loss_fn(p):
        logits, aux = jtfm.apply_with_aux(p, toks, jcfg)
        return jtfm.token_loss(logits, tgts, aux, jcfg), aux

    (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(tree)
    got = grads[name]
    assert abs(got["metrics"]["loss"] - float(loss)) <= ATOL
    for k, v in zip(METRICS[1:], np.asarray(aux)):
        assert abs(got["metrics"][k] - float(v)) <= ATOL, k
    want = dict(_leaves(jax.tree.map(np.asarray, g)))
    for key, leaf in _leaves(got["grads"]):
        np.testing.assert_allclose(leaf, want[key], atol=ATOL, rtol=0,
                                   err_msg=key)
