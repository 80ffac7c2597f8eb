"""The CNN trainer over the model, seq and expert axes, and a two-level
data axis beside a model axis, against the JAX package on the same mesh
(f32, augment off, the CPU):

* the group layout, with no spawn: every rank's coordinates and every
  inner, outer, data and model group of ``MeshConfig(data=2, dcn_data=2,
  model=2)`` and ``(data=4, dcn_data=2, seq=2)`` are the rank layout of
  JAX's device grid for the same config;
* one spawn of 4 gloo ranks (``parallel/workers.on_meshes``): tinycnn
  under ``Trainer`` (gspmd) on ``(data 2, model 2)``, ``(data 2, seq 2)``
  and ``(data 2, expert 2)``, and ddp on ``(data 2, model 2)``, one epoch
  of 3 steps each, against the JAX ``Trainer`` on the same mesh — losses
  and parameters within 1e-4, the copies along the non-data axis bitwise
  equal on every rank; and the tiny LM under ``LMTrainer`` on ``(data 2,
  dcn_data 2, model 2)`` against JAX's sharded step on the same mesh,
  within 1e-4, the replicas' slices bitwise;
* the refusals the port keeps, in JAX's words, and the elastic refit and
  the plan's mesh keep the dcn factor and the other axes as JAX does.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_port_util import SHAPES, numpy_params
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.autotune import plan as jplan
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel.spmd_pipeline import (
    make_spmd_train_step,
    shard_params,
)
from distributed_model_parallel_tpu.train import elastic as jelastic
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.autotune import plan as tplan
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import elastic as telastic
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import both_sides, run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close, _close_trees

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)
# case -> (mesh, strategy)
CNN = {
    "data2_model2": (dict(data=2, model=2), "gspmd"),
    "data2_seq2": (dict(data=2, seq=2), "gspmd"),
    "data2_expert2": (dict(data=2, expert=2), "gspmd"),
    "data2_model2_ddp": (dict(data=2, model=2), "ddp"),
}
LM_MESH = dict(data=2, dcn_data=2, model=2)
B, T = 4, 32
ATOL = 1e-4


# -- the layout ---------------------------------------------------------------

def _jax_layout(config: dict):
    """Per device id of JAX's grid: its (data, stage, model, seq, expert)
    index (data = dcn row x inner + inner index), and the sets of ids that
    vary along each named group."""
    spec = jmesh.make_mesh(jconfig.MeshConfig(**config), jax.devices())
    names = spec.mesh.axis_names
    grid = np.vectorize(lambda d: d.id)(np.asarray(spec.mesh.devices))
    inner = config["data"] // config.get("dcn_data", 1)
    coords = {}
    for idx in itertools.product(*(range(n) for n in grid.shape)):
        at = dict(zip(names, idx))
        coords[int(grid[idx])] = (
            at.get("dcn", 0) * inner + at["data"], at["stage"],
            at["model"], at["seq"], at["expert"])

    def groups(axes):
        keep = [names.index(a) for a in axes]
        moved = np.moveaxis(grid, keep, list(range(len(keep))))
        flat = moved.reshape(int(np.prod([grid.shape[k] for k in keep])),
                             -1)
        return {frozenset(int(i) for i in col) for col in flat.T}

    return coords, {"inner": groups(["data"]), "outer": groups(["dcn"]),
                    "data": groups(["dcn", "data"]),
                    "model": groups(["model"]), "seq": groups(["seq"])}


@pytest.mark.parametrize("config", [dict(data=2, dcn_data=2, model=2),
                                    dict(data=4, dcn_data=2, seq=2)],
                         ids=["data2_dcn2_model2", "data4_dcn2_seq2"])
def test_group_layout_is_jax_grid(config):
    coords, want = _jax_layout(config)
    cfg = tconfig.MeshConfig(**config)
    assert {r: tmesh.rank_coords(r, cfg)
            for r in range(cfg.num_devices)} == coords
    rest = cfg.model * cfg.seq * cfg.expert
    inner, outer = tmesh.dcn_groups(cfg.data, cfg.stage, cfg.dcn_data, rest)
    got = {"inner": inner, "outer": outer,
           "data": tmesh.axis_groups(cfg, (0,)),
           "model": tmesh.axis_groups(cfg, (2,)),
           "seq": tmesh.axis_groups(cfg, (3,))}
    assert {k: {frozenset(g) for g in v} for k, v in got.items()} == want


# -- one spawn of four ranks --------------------------------------------------

def _tcfg(root, name, mesh, strategy):
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(**DATA),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2),
        mesh=tconfig.MeshConfig(**mesh), strategy=strategy, epochs=1,
        log_every_n_steps=1, device="cpu", **run_dirs(root, name))


def _lm_config(root):
    cfg = ttfm.TransformerConfig(**SHAPES["mha"], tp_axis="model")
    return tlm.LMTrainConfig(
        model=cfg, mesh=tconfig.MeshConfig(**LM_MESH),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.05, momentum=0.9,
                                          weight_decay=1e-2),
        batch_size=B, seq_len=T, steps_per_epoch=2, n_tokens=500,
        eval_batches=0, device="cpu", log_dir=f"{root}/lm",
        checkpoint_dir=f"{root}/lm/ckpt")


def _batches(seed=3, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tk = rng.integers(0, 64, (B, T + 1)).astype(np.int32)
        out.append((tk[:, :-1], tk[:, 1:]))
    return out


def _jax_fits(root):
    """The JAX trainer's epoch on each case's mesh: history and final
    parameters; and the LM's sharded steps on ``LM_MESH`` (``"lm"``)."""
    out = {}
    for name, (mesh, strategy) in CNN.items():
        t = jtrainer.Trainer(tiny_train_config(
            root / name, mesh=jconfig.MeshConfig(**mesh),
            strategy=strategy, data=jconfig.DataConfig(**DATA), epochs=1))
        out[name] = dict(history=t.fit(),
                         params=jax.tree.map(np.asarray, t.state.params))
    out["lm"] = _jax_lm_steps()
    return out


def _jax_lm_steps():
    """JAX's sharded LM step on ``LM_MESH`` from the same weights and
    batches: the losses and the parameters after."""
    jcfg = jtfm.TransformerConfig(**SHAPES["mha"], tp_axis="model")
    tree = numpy_params(ttfm.TransformerConfig(**SHAPES["mha"]))
    spec = jmesh.make_mesh(jconfig.MeshConfig(**LM_MESH))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(
        learning_rate=0.05, momentum=0.9, weight_decay=1e-2), 2, 1)
    host = jax.tree.map(jnp.asarray, tree)
    opt_state = jax.device_put(tx.init(host), NamedSharding(spec.mesh, P()))
    params = shard_params(host, jcfg, spec)
    step = make_spmd_train_step(jcfg, spec, tx)
    losses = []
    for toks, tgts in _batches():
        params, opt_state, metrics = step(params, opt_state,
                                          jnp.asarray(toks),
                                          jnp.asarray(tgts))
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX fits, and beside them (``both_sides``) one spawn of 4 gloo
    ranks running every case from JAX's initial weights (the JAX
    trainer's init from the config's seed; ddp's statistics stacked per
    replica, as the JAX ddp trainer holds them)."""
    from distributed_model_parallel_tpu.parallel.ddp import (
        replicate_model_state,
    )

    root = tmp_path_factory.mktemp("runs")
    t = jtrainer.Trainer(tiny_train_config(
        root / "init", mesh=jconfig.MeshConfig(data=1),
        data=jconfig.DataConfig(**DATA), epochs=1))
    params = jax.tree.map(np.asarray, t.state.params)
    state = jax.tree.map(np.asarray, t.state.model_state)
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    cases = []
    for name, (mesh, strategy) in CNN.items():
        st = (jax.tree.map(np.asarray, replicate_model_state(
            state, mesh["data"])) if strategy == "ddp" else state)
        runs = {name: dict(config=_tcfg(str(root), name, mesh, strategy),
                           params=params, state=st)}
        cases.append((tconfig.MeshConfig(**mesh), "trainer_runs",
                      (runs, (train.images, train.labels),
                       (evals.images, evals.labels))))
    config = _lm_config(str(root))
    cases.append((config.mesh, "lm_steps",
                  (config, numpy_params(config.model), _batches())))
    pipe = _tcfg(str(root), "pipe", dict(stage=2, model=2),
                 "spmd_pipeline").replace(num_microbatches=2)
    cases.append((pipe.mesh, "spmd_trainer_fit",
                  (pipe, params, state, (train.images, train.labels),
                   (evals.images, evals.labels))))
    sub = _tcfg(str(root), "sub", dict(data=2), "gspmd")
    cases.append((tconfig.MeshConfig(data=4), "subgroup_fit",
                  (sub, (train.images, train.labels),
                   (evals.images, evals.labels))))
    store = str(tmp_path_factory.mktemp("store"))
    want, out = both_sides(
        lambda: _jax_fits(root),
        lambda: tmesh.spawn(workers.on_meshes, 4, cases, device="cpu",
                            threads=1, timeout_s=300, store_dir=store))
    return want, ({name: [r[i][name] for r in out]
                   for i, name in enumerate(CNN)},
                  [r[len(CNN)] for r in out],
                  dict(ranks=[r[len(CNN) + 1] for r in out],
                       config=pipe.replace(mesh=tconfig.MeshConfig(stage=2)),
                       init=(params, state)),
                  [r[len(CNN) + 2] for r in out])


@pytest.fixture(scope="module")
def jax_cnn(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


@pytest.mark.parametrize("name", sorted(CNN))
def test_cnn_over_other_axes_matches_jax(name, ranks, jax_cnn):
    got, want = ranks[0][name], jax_cnn[name]
    for rank in got:
        for g, w in zip(rank["history"], want["history"], strict=True):
            for k in ("loss_train", "acc1_train", "loss_val"):
                _close(g[k], w[k], f"{name} {k}")
        _close_trees(rank["params"], want["params"], name)


@pytest.mark.parametrize("name", sorted(CNN))
def test_cnn_copies_are_bitwise(name, ranks):
    """Every rank ends with the same parameters bit for bit: the copies
    along the model, seq or expert axis and the data replicas."""
    got = ranks[0][name]
    first = jax.tree.leaves(got[0]["params"])
    for rank in got[1:]:
        for a, b in zip(jax.tree.leaves(rank["params"]), first, strict=True):
            np.testing.assert_array_equal(a, b)


def test_lm_over_dcn_and_model_matches_jax(ranks, jax_cnn):
    lm = ranks[1]
    losses, want = jax_cnn["lm"]
    for rank in lm:
        np.testing.assert_allclose(rank["losses"], losses, atol=ATOL,
                                   rtol=0)
        for a, b in zip(jax.tree.leaves(rank["params"]),
                        jax.tree.leaves(want), strict=True):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    # The ranks at one model index hold the same slices, bit for bit,
    # across both levels of the data axis.
    for m in range(2):
        at = [r for r in lm if r["grid"][2] == m]
        assert len(at) == 2
        for a, b in zip(jax.tree.leaves(at[0]["local"]),
                        jax.tree.leaves(at[1]["local"]), strict=True):
            np.testing.assert_array_equal(a, b)


def test_spmd_pipeline_gpipe_over_a_model_axis(ranks, tmp_path):
    """``strategy="spmd_pipeline"`` (gpipe, M 2) on ``(stage 2, model 2)``
    replicates over the model axis, as JAX's shard_map does: every rank's
    history is the runner's ``PipelineTrainer`` at 2 stages from the same
    weights, each stage's parameters too, and the two copies of a stage
    are bitwise equal."""
    from distributed_model_parallel_tpu_torch.train import (
        pipeline_trainer as tpipeline_trainer,
    )

    pipe = ranks[2]
    params, state = pipe["init"]
    runner = tpipeline_trainer.PipelineTrainer(
        pipe["config"].replace(strategy="gspmd", **run_dirs(tmp_path)),
        params=params, state=state)
    history = runner.fit()
    merged = runner.runner.merged_params()
    by_stage = {}
    for r in pipe["ranks"]:
        for g, w in zip(r["history"], history, strict=True):
            for k in ("loss_train", "acc1_train", "loss_val"):
                _close(g[k], w[k], k)
        for a, b in zip(r["params"], merged[r["lo"]:r["hi"]], strict=True):
            _close_trees(a, b, "stage")
        by_stage.setdefault(r["lo"], []).append(r["params"])
    assert len(by_stage) == 2
    for copies in by_stage.values():
        assert len(copies) == 2
        for a, b in zip(jax.tree.leaves(copies[0]), jax.tree.leaves(
                copies[1]), strict=True):
            np.testing.assert_array_equal(a, b)


def test_a_sub_group_mesh_waits_at_its_own_barrier(ranks):
    """A trainer on a mesh laid over a sub-group of the world (ranks 0-1 of
    4) waits for its writes at that mesh's barrier, not the world's: the
    other two ranks meet it only at the world barrier that follows. (With
    a world barrier inside the fit, ranks 0-1's extra collectives find no
    peer and the spawn fails.)"""
    got = ranks[3]
    assert [bool(r) for r in got] == [True, True, False, False]
    keys = ("epoch", "loss_train", "acc1_train", "loss_val", "acc1_val")
    h0, h1 = ([{k: h[k] for k in keys} for h in r["history"]]
              for r in got[:2])
    assert h0 == h1 and len(h0) == 1


# -- refusals and the elastic refit -------------------------------------------

def test_1f1b_with_a_model_axis_refused_in_jax_words(tmp_path):
    from distributed_model_parallel_tpu.models import get_model
    from distributed_model_parallel_tpu.parallel.spmd_cnn_pipeline import (
        make_cnn_1f1b_fwd_bwd,
    )

    spec = jmesh.make_mesh(jconfig.MeshConfig(stage=2, model=2))
    model = get_model(jconfig.ModelConfig(name="tinycnn"))
    with pytest.raises(ValueError) as want:
        make_cnn_1f1b_fwd_bwd(model, spec, sample_shape=(4, 32, 32, 3),
                              num_microbatches=2)
    cfg = _tcfg(str(tmp_path), "pp", dict(stage=2, model=2),
                "spmd_pipeline").replace(pipeline_schedule="1f1b",
                                         num_microbatches=2)
    with pytest.raises(ValueError) as got:
        ttrainer.check_train_config(cfg)
    assert str(got.value) == str(want.value)
    # gpipe replicates over the model axis, as JAX's shard_map does.
    ttrainer.check_train_config(cfg.replace(pipeline_schedule="gpipe"))


@pytest.mark.parametrize("mesh,n,batch", [
    (dict(data=4, dcn_data=2, model=2), 8, 32),
    (dict(data=4, dcn_data=2, model=2), 4, 32),
    (dict(data=4, dcn_data=2, seq=2), 6, 32),
    (dict(data=8, dcn_data=4, expert=2), 16, 24),
    (dict(data=2, dcn_data=2, model=2, seq=2), 3, 32),
])
def test_elastic_refit_and_plan_mesh_match_jax(mesh, n, batch):
    """``fit_mesh_to_devices`` and ``mesh_from_plan`` keep the dcn factor
    (where it divides the new degree) and the non-data axes, as JAX's."""
    def run(config_mod, elastic, plan):
        cfg = config_mod.MeshConfig(**mesh)
        try:
            got, dec = elastic.fit_mesh_to_devices(cfg, n, batch_size=batch)
        except ValueError as e:
            return str(e)
        p = plan.ParallelPlan(strategy="gspmd", dp=got.data, pp=got.stage,
                              tp=got.model, sp=got.seq, ep=got.expert)
        planned = plan.mesh_from_plan(p, cfg)
        if config_mod is tconfig:
            # The port lays out what the planner gives it (a two-level data
            # axis beside the others was refused before A9).
            tmesh.check_mesh_config(planned)
        return (got.axis_sizes(), got.dcn_data, dec.changed,
                dec.describe(), planned.axis_sizes(), planned.dcn_data)

    assert run(tconfig, telastic, tplan) == run(jconfig, jelastic, jplan)
