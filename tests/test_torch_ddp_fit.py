"""The port's data-parallel Trainer, MobileNetV2 with cross-rank BN and
the CLI, at gloo ranks against the JAX package: ``fit`` histories of
tinycnn at 4 ranks (ddp with per-replica BN, gspmd per batch and
device-resident, zero) == the JAX trainer's at ``MeshConfig(data=4)`` from
the same initial weights, and the final parameters of gspmd and zero ==
JAX's gspmd fit's; ddp == gspmd without BN; the bucketed strategy;
one MobileNetV2 step at 2 ranks in float64 (gradients of the global
batch's loss, BN statistics over both ranks) == JAX's on one device over
the same 4 rows; ``train_cnn --device cpu --nproc 2``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.data import loader as jloader
from distributed_model_parallel_tpu.models import mobilenetv2 as jmnv2
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    load_dataset,
)
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import train_cnn
from tests._torch_port_util import cli_dirs, run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import RTOL, _close, _close_trees, _step_inputs

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N = 4
DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)
LOG_EVERY = 2


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX trainer's 2-epoch tinycnn runs at data=4, ddp and gspmd:
    initial weights (the gspmd run's; the ddp run draws the same from the
    same seed), histories, the ddp run's per-replica BN state."""
    out = {}
    for strategy in ("ddp", "gspmd"):
        cfg = tiny_train_config(
            tmp_path_factory.mktemp(strategy),
            mesh=jconfig.MeshConfig(data=N), strategy=strategy,
            data=jconfig.DataConfig(**DATA), epochs=2,
            log_every_n_steps=LOG_EVERY)
        t = jtrainer.Trainer(cfg)
        params = jax.tree.map(np.asarray, t.state.params)
        state = jax.tree.map(np.asarray, t.state.model_state)
        steps = []
        log_step = t.logger.log_step

        def record(epoch, step, log_step=log_step, steps=steps, **m):
            steps.append(dict(epoch=epoch, step=step, **m))
            log_step(epoch, step, **m)

        t.logger.log_step = record
        out[strategy] = dict(params0=params, state0=state, history=t.fit(),
                             step_log=steps,
                             state=jax.tree.map(np.asarray,
                                                t.state.model_state),
                             params=jax.tree.map(np.asarray,
                                                 t.state.params))
    return out


def _config(**kw):
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**DATA),
             optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                               warmup_steps=2),
             mesh=tconfig.MeshConfig(data=N), epochs=2,
             log_every_n_steps=LOG_EVERY, device="cpu")
    d.update(kw)
    return tconfig.TrainConfig(**d)


@pytest.fixture(scope="module")
def ranks(jax_fits, tmp_path_factory):
    """One spawn of 4 gloo ranks: the fits, and one step each of ddp and
    gspmd without BN."""
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    g, d = jax_fits["gspmd"], jax_fits["ddp"]
    nobn = tconfig.ModelConfig(name="tinycnn", batchnorm="none")
    images, labels = train.images[:32], train.labels[:32]
    runs = {
        "ddp": dict(config=_config(strategy="ddp"), params=d["params0"],
                    state=d["state0"]),
        "ddp_bucketed": dict(config=_config(strategy="ddp",
                                            ddp_bucket_bytes=1 << 16),
                             params=d["params0"], state=d["state0"]),
        "ddp_grad_bucket_mb_fused": dict(
            config=_config(strategy="ddp", grad_bucket_mb=0.0625,
                           optimizer=tconfig.OptimizerConfig(
                               learning_rate=0.1, warmup_steps=2,
                               fused=True)),
            params=d["params0"], state=d["state0"]),
        "gspmd": dict(config=_config(), params=g["params0"],
                      state=g["state0"]),
        "gspmd_resident": dict(config=_config(device_resident_data=True,
                                              steps_per_dispatch=2),
                               params=g["params0"], state=g["state0"]),
        "zero": dict(config=_config(strategy="zero"), params=g["params0"],
                     state=g["state0"]),
        "zero_fused": dict(
            config=_config(strategy="zero", optimizer=tconfig.OptimizerConfig(
                learning_rate=0.1, warmup_steps=2, fused=True)),
            params=g["params0"], state=g["state0"]),
    }
    for strategy in ("ddp", "gspmd"):
        runs[f"{strategy}_nobn_step"] = dict(
            config=_config(strategy=strategy, model=nobn),
            params=None, state=None, step=(images, labels))
    root = tmp_path_factory.mktemp("runs")
    for name, run in runs.items():
        run["config"] = run["config"].replace(**run_dirs(root, name))
    return tmesh.spawn(workers.trainer_runs, N, runs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), device="cpu",
                       timeout_s=300, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("run,strategy", [
    ("ddp", "ddp"), ("ddp_bucketed", "ddp"),
    ("ddp_grad_bucket_mb_fused", "ddp"), ("gspmd", "gspmd"),
    ("gspmd_resident", "gspmd"), ("zero", "gspmd"), ("zero_fused", "gspmd")])
def test_fit_matches_jax_trainer(jax_fits, ranks, run, strategy):
    """2 epochs at 4 ranks from the JAX run's initial weights: train and
    eval loss (1e-4) and accuracy (exact) per epoch, the same history on
    every rank; the device-resident path has the per-batch path's batch
    order."""
    want = jax_fits[strategy]["history"]
    keys = ("loss_train", "acc1_train", "loss_val", "acc1_val")
    for r in ranks:
        got = r[run]["history"]
        assert [[h[k] for k in keys] for h in got] == [
            [h[k] for k in keys] for h in ranks[0][run]["history"]]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in ("loss_train", "loss_val"):
                _close(g[k], w[k], k)
            for k in ("acc1_train", "acc1_val"):
                assert abs(g[k] - w[k]) < 1e-6, (k, g[k], w[k])


@pytest.mark.parametrize("run,strategy", [
    ("ddp", "ddp"), ("ddp_bucketed", "ddp"), ("gspmd", "gspmd")])
def test_step_log_matches_jax_trainer(jax_fits, ranks, run, strategy):
    """The per-window records at log_every_n_steps=2 (the per-batch path;
    the device-resident one logs per dispatch): the same epochs and steps
    as the JAX trainer's, running loss (1e-4) and top-1 (exact) of the
    window, samples/s over the global batch."""
    want = jax_fits[strategy]["step_log"]
    got = ranks[0][run]["step_log"]
    assert [(g["epoch"], g["step"]) for g in got] == [
        (w["epoch"], w["step"]) for w in want]
    assert len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"epoch", "step"}
        _close(g["loss"], w["loss"], "loss")
        assert abs(g["acc1"] - w["acc1"]) < 1e-6
        assert g["samples_per_s"] > 0


@pytest.mark.parametrize("run", ["gspmd", "zero", "zero_fused"])
def test_fit_params_match_jax_gspmd(jax_fits, ranks, run):
    """The final parameters of the 2-epoch fit at 4 ranks == the JAX
    trainer's gspmd fit from the same weights (1e-4 of scale), on every
    rank. strategy='zero' is gspmd's SGD with the momentum sharded: each
    rank updates its quarter of the flat padded vector (its momentum
    slice, the mean gradient's reduce-scattered slice, weight decay and
    the schedule's rate) and the slices are gathered back, so a wrong
    slice offset, scatter order, mean, decay or rate shows here."""
    want = jax_fits["gspmd"]["params"]
    for r in ranks:
        _close_trees(r[run]["params"], want, f"{run} params")


def test_ddp_fit_keeps_per_replica_bn_state(jax_fits, ranks):
    """After the ddp fit the BN state has a leading axis of 4 replicas, as
    the JAX trainer's, and replica r's statistics are JAX's replica r
    (1e-4 of scale)."""
    got = ranks[0]["ddp"]["replica_state"]
    want = jax_fits["ddp"]["state"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.shape[0] == N
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= RTOL * scale
    assert jax.tree.structure(got) == jax.tree.structure(want)


def test_ddp_matches_gspmd_without_bn(ranks):
    """With no BatchNorm the ddp and gspmd steps are the same math:
    parameters (rtol 2e-4, atol 1e-5, the JAX package's own tolerance)
    and loss (1e-5)."""
    for r in ranks:
        a, b = r["ddp_nobn_step"], r["gspmd_nobn_step"]
        assert a["metrics"]["loss"] == pytest.approx(b["metrics"]["loss"],
                                                     rel=1e-5)
        for x, y in zip(jax.tree.leaves(a["params"]),
                        jax.tree.leaves(b["params"])):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def mobilenet_2_ranks(tmp_path_factory):
    _, params, state, images, labels = _step_inputs()
    got = tmesh.spawn(workers.mobilenet_grads_f64, 2, params, state, images,
                      labels, CIFAR10_MEAN, CIFAR10_STD, device="cpu",
                      timeout_s=300, threads=1,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    return params, state, images, labels, got


def test_mobilenetv2_two_ranks_match_jax_in_float64(mobilenet_2_ranks):
    """One MobileNetV2 step at 2 ranks of 2 rows, in float64 (f32
    gradients of a random MobileNetV2 are ill-conditioned, see
    tests/test_torch_cnn.py's STEP_SEED): BN statistics over both ranks
    in the forward, their gradients all-reduced in the backward, the
    Reducer's mean == the JAX model's gradients of the loss over all 4
    rows on one device (1e-4), and the new BN statistics too; both ranks
    hold the same gradients and statistics."""
    params, state, images, labels, got = mobilenet_2_ranks
    with jax.enable_x64(True):
        jm = jmnv2.build_mobilenetv2(dtype=jnp.float64)
        xj = jloader.normalize(jnp.asarray(images), CIFAR10_MEAN,
                               CIFAR10_STD)

        def loss(p):
            y, new = jm.apply(p, jax.tree.map(jnp.asarray, state), xj,
                              train=True)
            return jtrainer.cross_entropy(y, jnp.asarray(labels)), new

        jgrads, jstate = jax.jit(jax.grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
        jgrads, jstate = jax.tree.map(np.asarray, (jgrads, jstate))
    for grads, new_state in got:
        _close_trees(grads, jgrads, "grad")
        _close_trees(new_state, jstate, "bn")
    for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(got[1])):
        np.testing.assert_array_equal(a, b)


def test_cli_spawns_ranks_and_prints_rank_0(capsys, tmp_path):
    """``train_cnn --device cpu --nproc 2``: two gloo ranks, one JSON
    record per epoch from rank 0; a ddp + sync BN + bucketed run too."""
    base = ["--device", "cpu", "--model", "tinycnn", "--epochs", "2",
            "--batch-size", "16", "--synthetic-train-size", "48",
            "--synthetic-eval-size", "16", "--fused", "--nproc", "2",
            *cli_dirs(tmp_path)]
    for extra in ([], ["--strategy", "ddp", "--bn-mode", "sync",
                       "--allreduce", "bucketed", "--bucket-mb", "1"]):
        train_cnn.main(base + extra)
        records = [json.loads(x) for x in
                   capsys.readouterr().out.strip().splitlines()]
        assert [r["epoch"] for r in records] == [0, 1]
        assert all(np.isfinite(r["loss_train"]) for r in records)


@pytest.mark.parametrize("bad,match", [
    (dict(strategy="ddp", device_resident_data=True),
     "only supported with strategy='gspmd'"),
    (dict(grad_bucket_mb=25.0), "grad_bucket_mb"),
    (dict(strategy="fsdp", optimizer=tconfig.OptimizerConfig(fused=True)),
     "OptimizerConfig.fused runs the update over flat"),
    (dict(strategy="ddp", ddp_allreduce="hierarchical"),
     "allreduce='hierarchical' needs a two-level data axis"),
    (dict(strategy="fsdp", consistency_every=1),
     "consistency_every needs state replicated"),
    (dict(mesh=tconfig.MeshConfig(data=2, dcn_data=2)),
     "process group of 2"),
    (dict(mesh=tconfig.MeshConfig(data=2)), "process group of 2"),
])
def test_trainer_refusals(bad, match):
    """What the JAX trainer refuses and what is not ported, by name; a
    mesh of 2 ranks in a process with no process group."""
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(_config(mesh=tconfig.MeshConfig()), **bad)
    with pytest.raises(ValueError, match=match):
        Trainer(cfg)


def test_indivisible_global_batch_raises():
    """A global batch the ranks cannot split evenly raises (static
    shapes, as the JAX package's local_batch_slice)."""
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    spec = tmesh.MeshSpec(tconfig.MeshConfig(data=3), rank=0)
    with pytest.raises(ValueError, match="not divisible by data=3"):
        Trainer(_config(mesh=tconfig.MeshConfig(data=3)), spec=spec)
