"""The port's SPMD CNN pipeline (``parallel/spmd_cnn_pipeline.py``, one
gloo rank per stage on the CPU) against the port's runner and the JAX
package, from tinycnn's JAX init (key 0) and one global batch of 32
(augment off; SGD lr 0.1, momentum 0.9, wd 1e-4): stage 2 M=1 == one
device; GPipe and 1F1B M=4 == the runner bit for bit; GPipe M=4 == JAX's
``make_spmd_cnn_train_step``; data 2 x stage 2 (4 ranks) == one device
(no BN) and == JAX's data x stage step with BN pooled over data;
``grad_clip_norm`` clips by the norm over every stage, as JAX's spmd step
does; the hops counted; ``ppermute_shift`` src -> dst; rank -> (data,
stage) == JAX's device grid; the trainer's refusals with JAX's messages.
Tolerance: 1e-4 of each tensor's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.parallel import spmd_cnn_pipeline as jsp
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu_torch.models import get_model
from distributed_model_parallel_tpu_torch.models.staged import stage_slices
from distributed_model_parallel_tpu_torch.parallel import (
    spmd_cnn_pipeline as tsp,
)
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close, _close_trees
from tests.test_torch_pipeline import (
    _bitwise,
    _init,
    _jax_single,
    _port,
    batch,  # noqa: F401  (a fixture)
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TWO = {"m1": dict(M=1), "gpipe4": dict(M=4, fused=True),
       "1f1b4": dict(M=4, schedule="1f1b", fused=True),
       "clip": dict(M=2, clip=0.05)}
FOUR = {"none": dict(bn="none"), "local": dict(M=2), "sync": dict(bn="sync")}


def _merge(ranks, case, row=0, stages=2):
    """The whole model's parameters (or state) from data row ``row``'s
    stages."""
    parts = [ranks[row * stages + s][case] for s in range(stages)]
    assert [(p["lo"], p["hi"]) for p in parts] == [(0, 3), (3, 6)]
    return (sum((tuple(p["params"]) for p in parts), ()),
            sum((tuple(p["state"]) for p in parts), ()))


@pytest.fixture(scope="module")
def ranks(batch, tmp_path_factory):
    """Two spawns: 2 ranks (stage 2) and 4 ranks (data 2 x stage 2)."""
    images, labels = batch
    data = (images, labels, CIFAR10_MEAN, CIFAR10_STD)
    kw = dict(device="cpu", timeout_s=300, threads=1,
              store_dir=str(tmp_path_factory.mktemp("store")))
    steps = "spmd_pipeline_steps"
    shifts = [("ring_shifts", ([1, -1, 3],))]
    two, shifts2 = zip(*tmesh.spawn(
        workers.several, 2, [(steps, (TWO, *_init(), *data)), *shifts],
        config=tconfig.MeshConfig(stage=2), **kw))
    four = tmesh.spawn(
        workers.several, 4,
        [(steps, ({k: FOUR[k] for k in ("local", "sync")}, *_init(),
                  *data)),
         (steps, ({"none": FOUR["none"]}, *_init("none"), *data)),
         *shifts, ("mesh_coords", ())],
        config=tconfig.MeshConfig(data=2, stage=2), **kw)
    return dict(two=list(two),
                four=[{**bn, **none} for bn, none, _, _ in four],
                shifts={2: list(shifts2), 4: [r[2] for r in four]},
                coords=[r[3] for r in four])


def _jax_spmd(data, stage, M, *, clip=None, bn="local"):
    from distributed_model_parallel_tpu.models import get_model

    images, labels = _synthetic_batch()
    model = get_model(jconfig.ModelConfig(name="tinycnn", batchnorm=bn))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(
        learning_rate=0.1, warmup_steps=0, grad_clip_norm=clip), 10, 10)
    params, state = _init(bn)
    ts = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                             params=jax.tree.map(jnp.asarray, params),
                             model_state=jax.tree.map(jnp.asarray, state),
                             opt_state=tx.init(params))
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=data, stage=stage))
    step = jax.jit(jsp.make_spmd_cnn_train_step(
        model, spec, tx, sample_shape=(2, 32, 32, 3), mean=CIFAR10_MEAN,
        std=CIFAR10_STD, num_microbatches=M, augment=False,
        stage_dispatch="masked"))
    new, metrics = step(ts, jax.random.key(9), jnp.asarray(images),
                        jnp.asarray(labels))
    return (jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, new.model_state),
            {k: float(v) for k, v in metrics.items()})


def _synthetic_batch():
    from distributed_model_parallel_tpu.data.registry import _synthetic

    ds = _synthetic(32, 32, 10, seed=3)
    return ds.images, ds.labels


@pytest.fixture(scope="module")
def jax_runs():
    return {"gpipe4": _jax_spmd(1, 2, 4), "clip": _jax_spmd(1, 2, 2,
                                                            clip=0.05),
            "dp_local": _jax_spmd(2, 2, 2)}


def test_stage2_m1_matches_single_device(batch, ranks):
    """Stage 2, M=1 (the reference's schedule over two processes) == JAX's
    one-device step; the loss and top-k are the global batch's on every
    rank."""
    images, labels = batch
    params, state = _init()
    from distributed_model_parallel_tpu.models import get_model

    model = get_model(jconfig.ModelConfig(name="tinycnn"))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(
        learning_rate=0.1, warmup_steps=0), 10, 10)
    jp, js, jm = _jax_single(model, tx, params, state, images, labels)
    p, s = _merge(ranks["two"], "m1")
    _close_trees(p, jp, "params")
    _close_trees(s, js, "state")
    for r in ranks["two"]:
        _close(r["m1"]["metrics"][0]["loss"], float(jm["loss"]), "loss")
        assert r["m1"]["metrics"][0]["batch"] == len(labels)
        assert r["m1"]["metrics"][0]["correct@1"] == float(jm["correct@1"])


@pytest.mark.parametrize("case", ["m1", "gpipe4", "1f1b4"])
def test_matches_the_runner_bitwise(batch, ranks, case):
    """Each rank's parameters, momentum and BN statistics == the port's
    runner at S=2 with the same cut and M, bit for bit (the hop copies
    bits; the per-chunk functions are the runner's)."""
    images, labels = batch
    params, state = _init()
    c = TWO[case]
    runner = _port(2, params, state, M=c["M"],
                   schedule=c.get("schedule", "gpipe"),
                   fused=c.get("fused", False))
    want = runner.train_step(None, images, labels)
    p, s = _merge(ranks["two"], case)
    _bitwise(p, runner.merged_params())
    _bitwise(s, runner.merged_model_state())
    for r, st in zip(ranks["two"], runner.stages):
        moms = [st.optimizer.momentum_buffer(i).numpy()
                for i in range(len(st.optimizer.params))]
        for a, b in zip(r[case]["momentum"], moms):
            np.testing.assert_array_equal(a, b)
        assert r[case]["metrics"][0]["loss"] == pytest.approx(
            want["loss"], rel=1e-6)


def test_gpipe_matches_jax_spmd_step(ranks, jax_runs):
    """GPipe M=4 at stage 2 == JAX's make_spmd_cnn_train_step (shard_map
    over 2 devices): parameters, pooled BN statistics, loss."""
    jp, js, jm = jax_runs["gpipe4"]
    p, s = _merge(ranks["two"], "gpipe4")
    _close_trees(p, jp, "params")
    _close_trees(s, js, "state")
    _close(ranks["two"][0]["gpipe4"]["metrics"][0]["loss"], jm["loss"],
           "loss")


def test_hops_are_counted_at_their_true_shapes(ranks):
    """M=4 GPipe over 2 stages: stage 0 sends 4 activations and 4
    d(logits) and receives 4 logits and 4 gradients; stage 1 the mirror;
    the bytes are the boundary tensors', unpadded."""
    r0, r1 = (r["gpipe4"] for r in ranks["two"])
    assert r0["calls"]["p2p_send"] == 4 + 4          # acts, dlogits
    assert r0["calls"]["p2p_recv"] == 4 + 4          # logits, grads
    assert r1["calls"]["p2p_send"] == 4 + 4          # logits, grads
    act = 8 * 32 * 32 * 16 * 4                       # [8,32,32,16] f32
    logits = 8 * 10 * 4
    assert r0["bytes"]["p2p_send"] == 4 * act + 4 * logits
    assert r1["bytes"]["p2p_send"] == 4 * logits + 4 * act


def test_grad_clip_is_the_global_norm(batch, ranks, jax_runs):
    """JAX's spmd step applies one optimizer to the whole tuple, so
    grad_clip_norm clips by the norm over every stage: the port's ranks
    all-reduce the squared norm over the stage ring and match it; the
    runner, which clips each chunk by its own norm, does not."""
    images, labels = batch
    jp, _, _ = jax_runs["clip"]
    p, _ = _merge(ranks["two"], "clip")
    _close_trees(p, jp, "params")
    params, state = _init()
    runner = _port(2, params, state, M=2)
    for st in runner.stages:
        st.optimizer.clip = 0.05
    runner.train_step(None, images, labels)
    # Per-chunk clipping moves some leaf's update by O(1) of itself.
    gaps = [float(np.abs(a - b).max() / np.abs(b - p0).max())
            for a, b, p0 in zip(jax.tree.leaves(runner.merged_params()),
                                jax.tree.leaves(jp), jax.tree.leaves(params))]
    assert max(gaps) > 0.1


def test_data2_stage2_matches_single_device_without_bn(batch, ranks):
    """4 ranks, data 2 x stage 2, no BN: the data rows' gradients are
    averaged over each stage's data sub-group — == JAX's one-device step,
    and both data rows hold the same parameters."""
    images, labels = batch
    params, state = _init("none")
    from distributed_model_parallel_tpu.models import get_model

    model = get_model(jconfig.ModelConfig(name="tinycnn", batchnorm="none"))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(
        learning_rate=0.1, warmup_steps=0), 10, 10)
    jp, _, jm = _jax_single(model, tx, params, state, images, labels)
    p0, _ = _merge(ranks["four"], "none", 0)
    p1, _ = _merge(ranks["four"], "none", 1)
    _bitwise(p0, p1)
    _close_trees(p0, jp, "params")
    _close(ranks["four"][3]["none"]["metrics"][0]["loss"], float(jm["loss"]),
           "loss")


def test_data2_stage2_pools_bn_like_jax(ranks, jax_runs):
    """4 ranks, BN per data row's microbatch, M=2: parameters and the BN
    statistics pooled over microbatches, then over data == JAX's data x
    stage step; both data rows hold the same (pooled) state."""
    jp, js, jm = jax_runs["dp_local"]
    p0, s0 = _merge(ranks["four"], "local", 0)
    p1, s1 = _merge(ranks["four"], "local", 1)
    _bitwise(p0, p1)
    _bitwise(s0, s1)
    _close_trees(p0, jp, "params")
    _close_trees(s0, js, "state")
    _close(ranks["four"][0]["local"]["metrics"][0]["loss"], jm["loss"],
           "loss")
    assert ranks["four"][0]["local"]["eval"]["batch"] == 32


def test_data2_stage2_sync_bn_matches_the_full_batch(batch, ranks):
    """Synchronized BN over the data sub-group: each data row normalizes
    by the global batch's statistics, so data 2 x stage 2 == the runner on
    the whole batch at S=2 (1e-4: the group's E[x²] − E[x]² against the
    one-device BatchNorm), and the pooled statistics are the same on both
    rows."""
    images, labels = batch
    runner = _port(2, *_init())
    runner.train_step(None, images, labels)
    p0, s0 = _merge(ranks["four"], "sync", 0)
    p1, s1 = _merge(ranks["four"], "sync", 1)
    _bitwise(s0, s1)
    _close_trees(p0, runner.merged_params(), "params")
    _close_trees(s0, runner.merged_model_state(), "state")


@pytest.mark.parametrize("n", [2, 4])
def test_ppermute_shift_src_to_dst(ranks, n):
    """Rank i's value lands on (i + shift) % n: around each data row's
    stage ring, and around the world; send_to/recv_from move one hop."""
    for rank, out in enumerate(ranks["shifts"][n]):
        d, s = divmod(rank, 2)
        for k in (1, -1, 3):
            assert out["stage"][k] == d * 2 + (s - k) % 2
            assert out["world"][k] == (rank - k) % n
        if s == 1:
            np.testing.assert_array_equal(out["hop"],
                                          np.full(3, 10.0 * d * 2))


def test_rank_coords_match_jax_device_grid(ranks):
    """JAX's mesh puts device r at (data, stage) = divmod(r, S) (row-major
    over (data, stage)); the port's ranks and sub-groups follow it."""
    grid = jmesh.make_mesh(jconfig.MeshConfig(data=2, stage=2)).mesh.devices
    ids = np.vectorize(lambda d: d.id)(grid).reshape(2, 2)
    for c in ranks["coords"]:
        d, s = c["coords"]
        assert ids[d, s] == c["rank"]
        assert c["data_group"] == sorted(ids[:, s].tolist())
        assert c["stage_group"] == ids[d, :].tolist()


@pytest.mark.parametrize("bad,match", [
    (dict(mesh=dict(data=8)), "mesh.stage"),
    (dict(mesh=dict(data=2, stage=4), device_resident_data=True),
     "device_resident_data"),
    (dict(mesh=dict(stage=2), pipeline_schedule="interleaved"),
     "gpipe and 1f1b"),
    (dict(mesh=dict(stage=2), virtual_stages=2), "only under"),
    (dict(mesh=dict(stage=2), stage_boundaries=(0, 3, 5, 6)), "cut points"),
])
def test_trainer_refusals_match_jax(tmp_path, bad, match):
    """The JAX trainer's refusals for strategy='spmd_pipeline', word for
    word."""
    bad = dict(bad)
    mesh = bad.pop("mesh")
    with pytest.raises(ValueError, match=match) as jerr:
        jtrainer.Trainer(tiny_train_config(
            tmp_path, strategy="spmd_pipeline",
            mesh=jconfig.MeshConfig(**mesh), **bad))
    cfg = tconfig.TrainConfig(model=tconfig.ModelConfig(name="tinycnn"),
                              strategy="spmd_pipeline", device="cpu",
                              mesh=tconfig.MeshConfig(**mesh), **bad)
    with pytest.raises(ValueError) as terr:
        ttrainer.Trainer(cfg)
    assert str(terr.value) == str(jerr.value)


def test_interleaved_over_ranks_config_checks_as_jax():
    """Interleaved 1F1B over ranks passes the trainer's checks (the
    mesh, not the option, is what a lone process lacks); gpipe with
    virtual stages and a cut of the wrong length are refused as JAX
    refuses them."""
    cfg = tconfig.TrainConfig(model=tconfig.ModelConfig(name="tinycnn"),
                              strategy="spmd_pipeline", device="cpu",
                              mesh=tconfig.MeshConfig(stage=2),
                              pipeline_schedule="1f1b", virtual_stages=2)
    ttrainer.check_train_config(cfg)
    with pytest.raises(ValueError, match="needs a process group of 2"):
        ttrainer.Trainer(cfg)
    with pytest.raises(ValueError, match="only under pipeline_schedule"):
        ttrainer.check_train_config(cfg.replace(pipeline_schedule="gpipe"))
    with pytest.raises(ValueError, match="provide 5"):
        ttrainer.check_train_config(cfg.replace(stage_boundaries=(0, 3, 6)))


@pytest.mark.parametrize("name,mbs,cut", [("tinycnn", 8, None),
                                          ("mobilenetv2", 128, [0, 11, 19])])
def test_boundary_shapes_match_jax(name, mbs, cut):
    """The static shape entering each stage and the output's, as JAX's
    eval_shape gives them (the port sends these, unpadded)."""
    from distributed_model_parallel_tpu.models import get_model as jget

    jmodel = jget(jconfig.ModelConfig(name=name))
    params, state = jmodel.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    tmodel = get_model(tconfig.ModelConfig(name=name), device="cpu")
    slices = stage_slices(tmodel.num_units, 2, cut)
    want = jsp.boundary_shapes(jmodel, params, state, mbs, (32, 32, 3),
                               slices)
    assert tsp.boundary_shapes(tmodel, mbs, (32, 32, 3), slices) == [
        tuple(w) for w in want]
