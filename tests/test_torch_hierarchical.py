"""The two-level data axis of the port (``MeshConfig(data=4, dcn_data=2)``,
``mesh.py``), its collectives (``ops/collectives.hierarchical_psum`` and
``hierarchical_psum_tree``) and ddp's ``allreduce="hierarchical"``
against the JAX package at 4 gloo ranks and 4 CPU devices: the psum of
every rank's rows and of a scaled tree (sum and mean, rtol 1e-6), the
hops each counts; the host-major layout of the inner and outer groups;
``Trainer`` fits of ddp hierarchical and gspmd at ``dcn_data=2`` == the
JAX trainer's at the same mesh (1e-4); and the JAX package's refusals,
in its words."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.ops import collectives as jcoll
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.parallel import ddp as tddp
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close, _close_trees

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N, DCN = 4, 2
MESH = dict(data=N, dcn_data=DCN)
DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 6, 3)).astype(np.float32)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    return x, tree


@pytest.fixture(scope="module")
def jax_side():
    """JAX's hierarchical psums over (data, dcn) of a data=4, dcn_data=2
    mesh: per data index, the sums of the rows and of the scaled tree."""
    spec = jmesh.make_mesh(jconfig.MeshConfig(**MESH))
    x, tree = _inputs()
    axes = spec.data_axis                 # ("dcn", "data")
    inner, outer = spec.ici_data_axis, spec.dcn_axis

    def smap(fn, in_specs, out_specs):
        return jax.jit(jax.shard_map(fn, mesh=spec.mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    out = {}
    for mean in (False, True):
        out["mean" if mean else "sum"] = np.asarray(smap(
            lambda xs, m=mean: jcoll.hierarchical_psum(xs, inner, outer,
                                                       mean=m),
            P(axes), P(axes))(jnp.asarray(x)))

    def scaled(t):
        i = (jax.lax.axis_index(outer) * (N // DCN)
             + jax.lax.axis_index(inner))
        return jax.tree.map(
            lambda v: v * (1.0 + i.astype(jnp.float32)), t)

    for mean in (False, True):
        out["tree_mean" if mean else "tree"] = jax.tree.map(
            np.asarray, smap(lambda t, m=mean: jcoll.hierarchical_psum_tree(
                scaled(t), inner, outer, mean=m), P(), P())(
                jax.tree.map(jnp.asarray, tree)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, tree = _inputs()
    return tmesh.spawn(workers.hierarchical_cases, N, x, tree, device="cpu",
                       timeout_s=300, threads=1,
                       config=tconfig.MeshConfig(**MESH),
                       store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("case", ["sum", "mean"])
def test_hierarchical_psum_matches_jax(jax_side, ranks, case):
    """Each rank's rows summed (or averaged) over both levels == JAX's
    rows of the same data index."""
    want = jax_side[case].reshape(N, -1, *jax_side[case].shape[1:])
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[case], want[r], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["tree", "tree_mean"])
def test_hierarchical_psum_tree_matches_jax(jax_side, ranks, case):
    """A tree scaled by 1 + data index, flattened, padded to the inner
    size, reduced over both levels and split back == JAX's, on every
    rank."""
    for rank in ranks:
        for k in ("a", "b"):
            np.testing.assert_allclose(rank[case][k], jax_side[case][k],
                                       rtol=1e-6, atol=1e-6)


def test_groups_are_host_major_and_hops_counted(ranks):
    """Ranks {0, 1} and {2, 3} are the dcn rows (inner groups); {0, 2} and
    {1, 3} the outer groups; one psum counts a reduce-scatter, a psum and
    an all-gather, as the JAX package's record_collective names them."""
    for r, rank in enumerate(ranks):
        assert rank["inner"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert rank["outer"] == [r % 2, r % 2 + 2]
        assert rank["calls"] == {"reduce_scatter": 1, "psum": 1,
                                 "all_gather": 1}
    assert tmesh.dcn_groups(4, 1, 2) == ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
    # With a stage axis the groups hold one stage's ranks each.
    inner, outer = tmesh.dcn_groups(4, 2, 2)
    assert inner[0] == [0, 2] and outer[0] == [0, 4]


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX trainer's 2-epoch tinycnn runs at data=4, dcn_data=2: ddp
    with the hierarchical transport and gspmd."""
    out = {}
    for strategy, allreduce in (("ddp", "hierarchical"), ("gspmd", "psum")):
        cfg = tiny_train_config(
            tmp_path_factory.mktemp(strategy),
            mesh=jconfig.MeshConfig(**MESH), strategy=strategy,
            ddp_allreduce=allreduce, data=jconfig.DataConfig(**DATA),
            epochs=2)
        t = jtrainer.Trainer(cfg)
        params = jax.tree.map(np.asarray, t.state.params)
        state = jax.tree.map(np.asarray, t.state.model_state)
        out[strategy] = dict(params0=params, state0=state, history=t.fit(),
                             params=jax.tree.map(np.asarray,
                                                 t.state.params))
    return out


def _config(**kw):
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**DATA),
             optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                               warmup_steps=2),
             mesh=tconfig.MeshConfig(**MESH), epochs=2,
             log_every_n_steps=1000, device="cpu")
    d.update(kw)
    return tconfig.TrainConfig(**d)


@pytest.fixture(scope="module")
def fits(jax_fits, tmp_path_factory):
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    g, d = jax_fits["gspmd"], jax_fits["ddp"]
    runs = {"ddp": dict(config=_config(strategy="ddp",
                                       ddp_allreduce="hierarchical"),
                        params=d["params0"], state=d["state0"]),
            "ddp_fused": dict(config=_config(
                strategy="ddp", ddp_allreduce="hierarchical",
                optimizer=tconfig.OptimizerConfig(
                    learning_rate=0.1, warmup_steps=2, fused=True)),
                params=d["params0"], state=d["state0"]),
            "gspmd": dict(config=_config(), params=g["params0"],
                          state=g["state0"])}
    root = tmp_path_factory.mktemp("runs")
    for name, run in runs.items():
        run["config"] = run["config"].replace(**run_dirs(root, name))
    return tmesh.spawn(workers.trainer_runs, N, runs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), device="cpu",
                       timeout_s=300, threads=1,
                       config=tconfig.MeshConfig(**MESH),
                       store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("run,strategy", [("ddp", "ddp"),
                                          ("ddp_fused", "ddp"),
                                          ("gspmd", "gspmd")])
def test_fit_at_dcn_data_2_matches_jax(jax_fits, fits, run, strategy):
    """2 epochs at data=4, dcn_data=2 from the JAX run's weights: train
    and eval loss (1e-4) and accuracy (exact) per epoch on every rank,
    and gspmd's final parameters (1e-4 of scale); ddp's replicas stay
    bitwise equal (checked in the worker)."""
    want = jax_fits[strategy]["history"]
    for r in fits:
        got = r[run]["history"]
        assert len(got) == len(want) == 2
        for gh, wh in zip(got, want):
            for k in ("loss_train", "loss_val"):
                _close(gh[k], wh[k], k)
            for k in ("acc1_train", "acc1_val"):
                assert abs(gh[k] - wh[k]) < 1e-6, (k, gh[k], wh[k])
    if strategy == "gspmd":
        for r in fits:
            _close_trees(r[run]["params"], jax_fits["gspmd"]["params"],
                         "gspmd params")


@pytest.mark.parametrize("call,match", [
    (lambda: tddp.resolve_allreduce("hierarchical"),
     "needs a two-level data axis; set MeshConfig.dcn_data > 1"),
    (lambda: tddp.resolve_allreduce("ring", dcn_data=2),
     "permutes over a flat data axis"),
    (lambda: tddp.resolve_allreduce("hierarchical", grad_bucket_mb=1.0,
                                    dcn_data=2),
     "grad_bucket_mb has no effect on the hierarchical transport"),
    (lambda: tmesh.check_mesh_config(tconfig.MeshConfig(data=4,
                                                        dcn_data=3)),
     "dcn_data=3 must divide data=4"),
    (lambda: tmesh.check_mesh_config(tconfig.MeshConfig(dcn_data=0)),
     "dcn_data must be >= 1"),
    (lambda: ttrainer.Trainer(_config(strategy="ddp",
                                      ddp_allreduce="ring")),
     "permutes over a flat data axis"),
])
def test_refusals_in_jax_words(call, match):
    """ddp.py's transport refusals, the trainer's grad_bucket_mb one and
    make_mesh's dcn_data checks, as the JAX package words them."""
    with pytest.raises(ValueError, match=match):
        call()


def test_jax_refuses_the_same(tmp_path):
    """The JAX package raises on the same transports (the wording the
    port's refusals copy)."""
    with pytest.raises(ValueError, match="needs a two-level data axis"):
        jtrainer.Trainer(tiny_train_config(
            tmp_path, strategy="ddp", ddp_allreduce="hierarchical",
            mesh=jconfig.MeshConfig(data=2)))
    cfg = dataclasses.replace(tiny_train_config(tmp_path),
                              mesh=jconfig.MeshConfig(data=4, dcn_data=3))
    with pytest.raises(ValueError, match="must divide"):
        jmesh.make_mesh(cfg.mesh)
