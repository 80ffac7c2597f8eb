"""The port's FSDP (``parallel/fsdp.py``, ``strategy="fsdp"``) against the
JAX package: ``leaf_spec`` == JAX's over a set of shapes and rank counts;
``shard_pytree``'s slices == JAX's addressable shards at
``MeshConfig(data=4)``; a 1-epoch tinycnn ``fit`` at 4 gloo ranks from the
JAX run's initial weights == the port's gspmd (losses rel 2e-4, accuracy
within 0.5, gathered parameters rtol 2e-4 / atol 2e-5: tests/test_fsdp.py's
bounds for fsdp against gspmd in one package) and == JAX's fsdp ``fit`` at
data=4 (the same losses; parameters within 1e-4 of each tensor's scale,
the port's bound across the two packages, tests/test_torch_cnn.py: after
6 steps at lr 0.1 the stem's kernel differs from JAX's by up to 6e-5,
convolutions summing in another order; 3 steps here), each rank's slices at rest ==
JAX's shards of its final parameters (the same bound), each rank's resident
parameter and momentum bytes == the sharded layout's, the device-resident
path, the global-norm clip over slices, the refusals, and the CLI with
``--strategy fsdp`` and with ``--allreduce ring``."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.parallel import fsdp as jfsdp
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.parallel import fsdp as tfsdp
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import train_cnn
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import cli_dirs, run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N = 4
DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)


def _jspec_dim(p):
    """A JAX PartitionSpec as the port's spec: the sharded dim or None."""
    dims = [d for d, a in enumerate(p) if a is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("shape,n,min_size", [
    ((1024, 64), 8, 1024), ((64, 1024), 8, 1024), ((512, 512), 8, 1024),
    ((7, 1023), 8, 1024), ((8,), 8, 1024), ((16, 16), 8, 1024),
    ((3, 3, 64, 128), 4, 1024), ((3, 3, 3, 64), 4, 1024),
    ((3, 3, 16, 16), 4, 1024), ((2048,), 4, 1024), ((1000,), 4, 1024),
    ((4,), 4, 1), ((3,), 4, 1), ((64, 10), 4, 512), ((6, 6), 3, 1)])
def test_leaf_spec_matches_jax(shape, n, min_size):
    want = _jspec_dim(jfsdp.leaf_spec(shape, n, "data", min_size))
    assert tfsdp.leaf_spec(shape, n, min_size) == want


def test_shard_pytree_matches_jax_shards():
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=N))
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(1024, 32)).astype(np.float32),
            "k": rng.normal(size=(3, 3, 32, 64)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}
    sharded = jfsdp.shard_pytree(jax.tree.map(np.asarray, tree), spec)
    specs = tfsdp.tree_shardings(tree, N)
    assert specs == {"w": 0, "k": 3, "b": None}
    for r, dev in enumerate(spec.mesh.devices.flat):
        got = tfsdp.shard_pytree(tree, N, r)
        for k, leaf in sharded.items():
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))


def _config(**kw):
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**DATA),
             optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                               warmup_steps=2),
             mesh=tconfig.MeshConfig(data=N), epochs=1, device="cpu",
             strategy="fsdp")
    d.update(kw)
    return tconfig.TrainConfig(**d)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX trainer's 1-epoch tinycnn fsdp run at data=4: its initial
    weights, history and final parameters (gathered, and per device)."""
    cfg = tiny_train_config(
        tmp_path_factory.mktemp("fsdp"), mesh=jconfig.MeshConfig(data=N),
        strategy="fsdp", data=jconfig.DataConfig(**DATA), epochs=1)
    t = jtrainer.Trainer(cfg)
    params0 = jax.tree.map(np.asarray, t.state.params)
    state0 = jax.tree.map(np.asarray, t.state.model_state)
    history = t.fit()
    devices = list(t.spec.mesh.devices.flat)
    shards = [jax.tree.map(lambda a, d=d: np.asarray(next(
        s.data for s in a.addressable_shards if s.device == d)),
        t.state.params) for d in devices]
    return dict(params0=params0, state0=state0, history=history,
                params=jax.tree.map(np.asarray, t.state.params),
                shards=shards)


@pytest.fixture(scope="module")
def ranks(jax_fit, tmp_path_factory):
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    w = dict(params=jax_fit["params0"], state=jax_fit["state0"])
    clip = tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2,
                                   grad_clip_norm=0.05)
    runs = {"fsdp": dict(config=_config(), **w),
            "gspmd": dict(config=_config(strategy="gspmd"), **w),
            "fsdp_resident": dict(config=_config(
                device_resident_data=True, steps_per_dispatch=2), **w),
            "fsdp_clip": dict(config=_config(optimizer=clip), **w),
            "gspmd_clip": dict(config=_config(strategy="gspmd",
                                              optimizer=clip), **w)}
    root = tmp_path_factory.mktemp("runs")
    for name, run in runs.items():
        run["config"] = run["config"].replace(**run_dirs(root, name))
    return tmesh.spawn(workers.trainer_runs, N, runs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), device="cpu",
                       timeout_s=300, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


def _close_params(got, want, rtol=2e-4, atol=2e-5):
    for ug, uw in zip(got, want):
        assert set(ug) == set(uw)
        for m in ug:
            for k in ug[m]:
                np.testing.assert_allclose(ug[m][k], uw[m][k], rtol=rtol,
                                           atol=atol, err_msg=f"{m}.{k}")


def _close_across(got, want):
    """Across the packages: each tensor within 1e-4 of its scale."""
    for ug, uw in zip(got, want):
        assert set(ug) == set(uw)
        for m in ug:
            for k in ug[m]:
                _close(ug[m][k], uw[m][k], f"{m}.{k}")


def _close_history(got, want):
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        for k in ("loss_train", "loss_val"):
            assert g[k] == pytest.approx(w[k], rel=2e-4), k
        for k in ("acc1_train", "acc1_val"):
            assert g[k] == pytest.approx(w[k], abs=0.5), k


@pytest.mark.parametrize("run", ["fsdp", "fsdp_resident"])
def test_fsdp_fit_matches_jax_fsdp(jax_fit, ranks, run):
    """An epoch at 4 ranks from the JAX run's initial weights: per-epoch
    losses and accuracies and the gathered final parameters == the JAX
    package's fsdp run at data=4, the same on every rank; the
    device-resident path takes the same batches."""
    for r in ranks:
        _close_history(r[run]["history"], jax_fit["history"])
        _close_across(r[run]["params"], jax_fit["params"])
        keys = ("loss_train", "acc1_train", "loss_val", "acc1_val")
        assert [[h[k] for k in keys] for h in r[run]["history"]] == [
            [h[k] for k in keys] for h in ranks[0][run]["history"]]


@pytest.mark.parametrize("run,ref", [("fsdp", "gspmd"),
                                     ("fsdp_clip", "gspmd_clip")])
def test_fsdp_fit_matches_port_gspmd(ranks, run, ref):
    """The sharding changes where the collectives run, not the math: the
    port's fsdp == its gspmd (with and without the global-norm clip, whose
    norm spans every rank's slices)."""
    for r in ranks:
        _close_history(r[run]["history"], r[ref]["history"])
        _close_params(r[run]["params"], r[ref]["params"])


WIDE = tconfig.ModelConfig(name="tinycnn", extra={"width": 128})
# The optimizers whose update reads whole-leaf reductions, which a slice
# must take over its group: the trust ratio (lars; lamb runs the same
# code after adam's elementwise step, which normalises each element by
# its own gradient, so an element whose gradient sits at rounding level
# flips sign between two reduction orders and no fit-level bound holds
# for it), the factored means (adafactor) and the global-norm clip.
ADAPTIVE = {"lars": dict(name="lars", learning_rate=0.5),
            "adafactor": dict(name="adafactor", learning_rate=0.01),
            "lars_clip": dict(name="lars", learning_rate=0.5,
                              grad_clip_norm=0.05)}


@pytest.fixture(scope="module")
def adaptive_ranks(tmp_path_factory):
    """fsdp and gspmd fits of tinycnn at width 128 (3x3 kernels of 128 x
    128: adafactor factors them, fsdp shards them) under lars, adafactor
    and lars with the clip, from the same weights."""
    from distributed_model_parallel_tpu_torch.models import (
        get_model,
        params_to_jax,
    )

    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    params, state = params_to_jax(get_model(WIDE, device="cpu"))
    root = tmp_path_factory.mktemp("adaptive")
    runs = {}
    for name, opt in ADAPTIVE.items():
        for strategy in ("fsdp", "gspmd"):
            runs[f"{strategy}_{name}"] = dict(
                config=_config(model=WIDE, strategy=strategy,
                               optimizer=tconfig.OptimizerConfig(
                                   warmup_steps=2, **opt)).replace(
                    **run_dirs(root, f"{strategy}_{name}")),
                params=params, state=state)
    return tmesh.spawn(workers.trainer_runs, N, runs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), device="cpu",
                       timeout_s=600, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_fsdp_adaptive_optimizers_match_gspmd(adaptive_ranks, name):
    """On slices, the trust ratio and the clip take each whole leaf's
    norm (squared norms summed over the ranks), and
    adafactor factors by the whole leaf's shape (row and column means
    summed over the ranks where the shard dim is reduced): fsdp == gspmd
    within tests/test_fsdp.py's bounds."""
    for r in adaptive_ranks:
        _close_history(r[f"fsdp_{name}"]["history"],
                       r[f"gspmd_{name}"]["history"])
        _close_params(r[f"fsdp_{name}"]["params"],
                      r[f"gspmd_{name}"]["params"])


def test_slices_at_rest_are_jax_shards(jax_fit, ranks):
    """Rank r keeps, of every parameter, the JAX package's shard on device
    r of its final parameters (the whole leaf where it stays
    replicated)."""
    for r, rank in enumerate(ranks):
        _close_across(rank["fsdp"]["slices"], jax_fit["shards"][r])


def test_resident_bytes_are_the_sharded_layout(jax_fit, ranks):
    """Each rank holds 4 bytes per element of its slices and replicated
    leaves, for parameters and momentum alike — less than the full
    model's, which gspmd holds."""
    specs = tfsdp.tree_shardings(jax_fit["params"], N)
    sizes = [np.size(a) // (1 if s is None else N) for a, s in zip(
        jax.tree.leaves(jax_fit["params"]), jax.tree.leaves(
            specs, is_leaf=lambda x: x is None))]
    full = sum(np.size(a) for a in jax.tree.leaves(jax_fit["params"])) * 4
    want = sum(sizes) * 4
    assert want < full
    for r in ranks:
        assert r["fsdp"]["resident"] == {"params": want, "momentum": want}


@pytest.mark.parametrize("bad,match", [
    (dict(optimizer=tconfig.OptimizerConfig(fused=True)),
     "OptimizerConfig.fused runs the update over flat"),
    (dict(grad_bucket_mb=1.0), "grad_bucket_mb"),
    (dict(consistency_every=1), "consistency_every needs state"),
])
def test_fsdp_refusals(bad, match):
    cfg = dataclasses.replace(_config(mesh=tconfig.MeshConfig()), **bad)
    with pytest.raises(ValueError, match=match):
        ttrainer.check_train_config(cfg)


def test_fsdp_at_one_rank_is_gspmd(tmp_path):
    """Without a process group nothing is sharded and the step is the
    one-device step."""
    cfg = dataclasses.replace(_config(mesh=tconfig.MeshConfig()), epochs=1)
    keys = ("loss_train", "acc1_train", "loss_val", "acc1_val")
    a = ttrainer.Trainer(cfg.replace(**run_dirs(tmp_path, "fsdp"))).fit()
    b = ttrainer.Trainer(cfg.replace(strategy="gspmd",
                                     **run_dirs(tmp_path, "gspmd"))).fit()
    assert [[h[k] for k in keys] for h in a] == [[h[k] for k in keys]
                                                 for h in b]


@pytest.mark.parametrize("extra", [["--strategy", "fsdp"],
                                   ["--strategy", "ddp",
                                    "--allreduce", "ring"]])
def test_cli_fsdp_and_ring(capsys, extra, tmp_path):
    """``train_cnn --device cpu --model tinycnn --nproc 2`` with
    ``--strategy fsdp`` and with ddp over ``--allreduce ring``: one JSON
    record per epoch from rank 0, finite losses."""
    train_cnn.main(["--device", "cpu", "--model", "tinycnn", "--epochs",
                    "2", "--batch-size", "16", "--synthetic-train-size",
                    "48", "--synthetic-eval-size", "16", "--nproc", "2",
                    *cli_dirs(tmp_path), *extra])
    records = [json.loads(x) for x in
               capsys.readouterr().out.strip().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss_train"]) for r in records)


@pytest.fixture(scope="module", params=["tinycnn", "tinycnn_w128"])
def gathered(request, tmp_path_factory):
    """One FSDP step per rank with the whole weights counted; width 128
    shards the head's Dense kernel too (autograd saves its transpose, a
    view of the gathered weight)."""
    train, _ = load_dataset(tconfig.DataConfig(**DATA))
    model = (tconfig.ModelConfig(name="tinycnn", extra={"width": 128})
             if request.param == "tinycnn_w128"
             else tconfig.ModelConfig(name="tinycnn"))
    cfg = _config(model=model).replace(
        **run_dirs(tmp_path_factory.mktemp("g"), "g"))
    return tmesh.spawn(workers.fsdp_gathered, N, cfg,
                       (train.images, train.labels), device="cpu",
                       timeout_s=300, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


def test_only_one_unit_holds_whole_weights(gathered):
    """The forward frees each unit's gathered weights when the unit is
    done (autograd keeps a note of the slice instead), and the backward
    gathers them again when it needs them: at most one unit's whole
    weights are alive in either pass (count and bytes), none between
    them or after, and every parameter got its gradient."""
    for r in gathered:
        most = max(r["per_unit"].values())
        assert r["n_sharded"] > most          # more than one unit shards
        assert 0 < r["fwd_peak"] <= most
        assert 0 < r["bwd_peak"] <= most
        assert r["bwd_peak_bytes"] <= r["max_unit_bytes"]
        assert r["between"] == 0 and r["after"] == 0
        assert all(r["grads"])
