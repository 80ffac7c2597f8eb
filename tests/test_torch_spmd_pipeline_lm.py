"""The port's LM pipeline over the stage axis (``parallel/spmd_pipeline.py``
through ``parallel/spmd_lm.make_loss_and_grad``) against the JAX
package's on the same mesh: the loss, the stats vector and every gradient
of one step under the port's ``gpipe`` and ``1f1b`` (and interleaved 1F1B
at ``virtual_stages=2``), held against JAX's GPipe step
(``_make_loss_fn`` under ``jax.value_and_grad``) and its hand-scheduled
1F1B (``make_1f1b_loss_and_grad``) within 1e-4 (f32). Meshes of 4 gloo
ranks (one spawn, ``parallel/workers.on_meshes``): pp only, pp x dp (M
> S), pp x tp with grouped-query attention, pp x sp with ring attention
and learned positions, V 2 and V 2 x tp, remat ("dots") with the chunked
head. The interleave permutation equals JAX's, and the schedule errors
JAX raises are raised in its words."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_util import SHAPES, numpy_params
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.mesh import make_mesh
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel import spmd_pipeline as jsp
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline as tsp
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm

pytestmark = pytest.mark.torch_port

ATOL = 1e-4
B, T, LAYERS = 8, 32, 4
# name -> (mesh, model fields, shape, M, V, JAX schedules held against)
CASES = {
    "pp4_rope": (dict(stage=4), {}, "mha", 4, 1, ("gpipe", "1f1b")),
    "pp2_dp2_m4_learned": (dict(data=2, stage=2), {}, "learned", 4, 1,
                           ("gpipe",)),
    "pp2_tp2_gqa": (dict(stage=2, model=2), dict(tp_axis="model"), "gqa",
                    2, 1, ("gpipe",)),
    "pp2_sp2_ring_learned": (dict(stage=2, seq=2), dict(sp_axis="seq"),
                             "learned", 2, 1, ("gpipe",)),
    "pp2_dp2_v2": (dict(data=2, stage=2), {}, "mha", 2, 2, ("1f1b",)),
    "pp2_tp2_v2": (dict(stage=2, model=2), dict(tp_axis="model"), "mha", 2,
                   2, ("1f1b",)),
    "pp2_dp2_remat_dots_chunk8": (
        dict(data=2, stage=2), dict(remat=True, remat_policy="dots",
                                    loss_chunk=8), "mha", 2, 1, ("gpipe",)),
}


def _shape(kind):
    return dict(SHAPES[kind], n_layers=LAYERS)


def _batch(seed=11):
    tk = np.random.default_rng(seed).integers(0, 64, (B, T + 1)).astype(
        np.int32)
    return tk[:, :-1], tk[:, 1:]


def _port_schedules(V):
    return ["1f1b"] if V > 1 else ["gpipe", "1f1b"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    toks, tgts = _batch()
    cases = []
    for name, (mesh, kw, kind, M, V, _) in CASES.items():
        cfg = ttfm.TransformerConfig(**_shape(kind), **kw)
        config = tlm.LMTrainConfig(
            model=cfg, mesh=tconfig.MeshConfig(**mesh), batch_size=B,
            seq_len=T, num_microbatches=M, virtual_stages=V,
            pipeline_schedule=_port_schedules(V)[0], n_tokens=500,
            eval_batches=0, device="cpu", log_dir=os.path.join(root, name),
            checkpoint_dir=os.path.join(root, name, "ckpt"))
        cases.append((config.mesh, "lm_pipeline_grads",
                      (config, numpy_params(ttfm.TransformerConfig(
                          **_shape(kind))), toks, tgts, _port_schedules(V))))
    out = tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                      timeout_s=400,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    return {name: [r[i] for r in out] for i, name in enumerate(CASES)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _jax_step(name, schedule):
    """JAX's loss, stats and gradients (canonical layer order) on the
    case's mesh."""
    mesh, kw, kind, M, V, _ = CASES[name]
    jcfg = jtfm.TransformerConfig(**_shape(kind), **kw)
    spec = make_mesh(jconfig.MeshConfig(**mesh))
    host = jax.tree.map(jnp.asarray,
                        numpy_params(ttfm.TransformerConfig(**_shape(kind))))
    S = mesh["stage"]
    host["blocks"] = jsp.interleave_block_rows(host["blocks"], LAYERS, S, V)
    params = jsp.shard_params(host, jcfg, spec)
    toks, tgts = (jnp.asarray(a) for a in _batch())
    if schedule == "gpipe":
        (loss, aux), g = jax.jit(jax.value_and_grad(
            jsp._make_loss_fn(jcfg, spec, M), has_aux=True))(
                params, toks, tgts)
    else:
        loss, aux, g = jax.jit(jsp.make_1f1b_loss_and_grad(
            jcfg, spec, M, virtual_stages=V))(params, toks, tgts)
    g = jax.tree.map(np.asarray, g)
    g["blocks"] = jsp.deinterleave_block_rows(g["blocks"], LAYERS, S, V)
    return float(loss), np.asarray(aux), g


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_grads_match_jax(port, name):
    """Each port schedule's loss and gradients against each JAX schedule
    the case names, on every rank."""
    ranks = port[name]
    for jschedule in CASES[name][5]:
        loss, aux, g = _jax_step(name, jschedule)
        want = dict(_leaves(g))
        for schedule, got in ranks[0].items():
            assert abs(got["metrics"]["loss"] - loss) <= ATOL, (
                schedule, jschedule, got["metrics"]["loss"], loss)
            for key, leaf in _leaves(got["grads"]):
                np.testing.assert_allclose(
                    leaf, want[key], atol=ATOL, rtol=0,
                    err_msg=f"{key} port {schedule} vs JAX {jschedule}")
        assert np.abs(aux).max() == 0.0          # dense: the stats are zeros
    for r in ranks[1:]:
        for schedule in r:
            assert r[schedule]["metrics"] == ranks[0][schedule]["metrics"]


@pytest.mark.parametrize("name", ["pp4_rope", "pp2_dp2_m4_learned"])
def test_schedules_agree(port, name):
    """gpipe and 1f1b: the same loss, gradients within 1e-5."""
    runs = port[name][0]
    assert abs(runs["gpipe"]["metrics"]["loss"]
               - runs["1f1b"]["metrics"]["loss"]) <= 1e-5
    want = dict(_leaves(runs["gpipe"]["grads"]))
    for key, leaf in _leaves(runs["1f1b"]["grads"]):
        np.testing.assert_allclose(leaf, want[key], atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("L,S,V", [(4, 2, 2), (8, 2, 2), (8, 2, 4),
                                   (12, 3, 2), (4, 4, 1)])
def test_interleave_perm_matches_jax(L, S, V):
    assert tsp.interleave_perm(L, S, V) == jsp._interleave_perm(
        L, S, V).tolist()
    rows = {"w": np.arange(L * 3, dtype=np.float32).reshape(L, 3)}
    import torch

    got = tsp.interleave_block_rows({"w": torch.from_numpy(rows["w"])}, L,
                                    S, V)["w"]
    want = np.asarray(jsp.interleave_block_rows(
        jax.tree.map(jnp.asarray, rows), L, S, V)["w"])
    np.testing.assert_array_equal(got.numpy(), want)
    back = tsp.deinterleave_block_rows({"w": got}, L, S, V)["w"]
    np.testing.assert_array_equal(back.numpy(), rows["w"])


@pytest.mark.parametrize("kw,schedule,M,V", [
    (dict(n_layers=4), "1f1b", 3, 2),           # M % S under V > 1
    (dict(n_layers=6), "1f1b", 2, 2),           # n_layers % (V S)
    (dict(n_layers=4), "gpipe", 2, 2),          # V > 1 under gpipe
    (dict(n_layers=4), "pipedream", 2, 1),      # unknown schedule
])
def test_schedule_errors_in_jax_words(kw, schedule, M, V):
    shape = dict(SHAPES["mha"], **kw)
    jcfg, tcfg = jtfm.TransformerConfig(**shape), ttfm.TransformerConfig(
        **shape)
    spec = make_mesh(jconfig.MeshConfig(stage=2))
    import optax

    with pytest.raises(ValueError) as jerr:
        jsp.make_spmd_train_step(jcfg, spec, optax.sgd(0.1), M,
                                 schedule=schedule, virtual_stages=V)
    with pytest.raises(ValueError) as terr:
        tsp.check_pipeline_config(tcfg, 2, M, schedule, V)
    assert str(terr.value) == str(jerr.value)


def test_local_batch_error_in_jax_words():
    """A local batch M does not divide: JAX's trace-time error, raised by
    the port's trainer when it is configured."""
    jcfg = jtfm.TransformerConfig(**_shape("mha"))
    spec = make_mesh(jconfig.MeshConfig(stage=2))
    params = jsp.shard_params(jtfm.init_params(jax.random.key(0), jcfg),
                              jcfg, spec)
    toks = jnp.zeros((8, T), jnp.int32)
    with pytest.raises(ValueError) as jerr:
        jsp._make_loss_fn(jcfg, spec, 3)(params, toks, toks)
    with pytest.raises(ValueError) as terr:
        tlm.LMTrainer(tlm.LMTrainConfig(
            model=ttfm.TransformerConfig(**_shape("mha")), batch_size=8,
            seq_len=T, num_microbatches=3, device="cpu", n_tokens=500))
    assert str(terr.value) == str(jerr.value)
