"""The port's pipeline trainer (``train/pipeline_trainer.py``), the SPMD
engine through ``Trainer(strategy="spmd_pipeline")`` and the CLI
(``train/train_model_parallel.py``): ``fit`` histories == the JAX
``PipelineTrainer``'s on tinycnn/synthetic from the same weights (augment
off), the SPMD trainer over 2 gloo ranks == the runner trainer, the
refusals by name, and CLI runs on the CPU. Tolerance: 1e-4 of each
value's scale."""

import json

import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.train import (
    pipeline_trainer as jpipeline_trainer,
)
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import (
    pipeline_trainer as tpipeline_trainer,
)
from distributed_model_parallel_tpu_torch.train import train_model_parallel
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)
RUN = dict(num_microbatches=2, epochs=2, log_every_n_steps=2)


def _port_config(**kw):
    return tconfig.TrainConfig(**{
        "model": tconfig.ModelConfig(name="tinycnn"),
        "data": tconfig.DataConfig(**DATA),
        "optimizer": tconfig.OptimizerConfig(learning_rate=0.1,
                                             warmup_steps=2),
        "mesh": tconfig.MeshConfig(stage=2), "device": "cpu", **RUN, **kw})


def _check_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
        for k in ("acc1_train", "acc1_val"):
            assert abs(g[k] - w[k]) < 1e-6, (k, g[k], w[k])


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX PipelineTrainer over 2 stages, M=2, per schedule: its
    initial weights and its history."""
    out = {}
    for schedule in ("gpipe", "1f1b"):
        cfg = tiny_train_config(
            tmp_path_factory.mktemp(schedule),
            data=jconfig.DataConfig(**DATA),
            mesh=jconfig.MeshConfig(stage=2), pipeline_schedule=schedule,
            **RUN)
        t = jpipeline_trainer.PipelineTrainer(cfg)
        params = t.runner.merged_params()
        state = t.runner.merged_model_state()
        out[schedule] = dict(params=params, state=state, history=t.fit())
    return out


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("fused", [False, True])
def test_fit_matches_jax_pipeline_trainer(jax_fit, schedule, fused):
    """Two epochs (3 steps each, eval after each) from the JAX trainer's
    own initial weights: the same history."""
    want = jax_fit[schedule]
    cfg = _port_config(pipeline_schedule=schedule)
    cfg = cfg.replace(optimizer=tconfig.OptimizerConfig(
        learning_rate=0.1, warmup_steps=2, fused=fused))
    t = tpipeline_trainer.PipelineTrainer(cfg, params=want["params"],
                                          state=want["state"])
    assert [(st.lo, st.hi) for st in t.runner.stages] == [(0, 3), (3, 6)]
    _check_history(t.fit(), want["history"])
    assert t.step_log and t.step_log[0]["step"] == 0


def test_spmd_trainer_matches_runner_trainer(jax_fit, tmp_path):
    """Trainer(strategy='spmd_pipeline') over 2 gloo ranks == the runner's
    PipelineTrainer from the same weights: the history on every rank and
    each rank's stage parameters."""
    want = jax_fit["gpipe"]
    runner = tpipeline_trainer.PipelineTrainer(
        _port_config(), params=want["params"], state=want["state"])
    history = runner.fit()
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    ranks = tmesh.spawn(
        workers.spmd_trainer_fit, 2,
        _port_config(strategy="spmd_pipeline"), want["params"],
        want["state"], (train.images, train.labels),
        (evals.images, evals.labels), device="cpu", timeout_s=300,
        threads=1, store_dir=str(tmp_path),
        config=tconfig.MeshConfig(stage=2))
    merged = sum((tuple(r["params"]) for r in ranks), ())
    for r in ranks:
        _check_history(r["history"], history)
    for a, b in zip(merged, runner.runner.merged_params()):
        for m in a:
            for k in a[m]:
                _close(a[m][k], b[m][k], f"{m}.{k}")


@pytest.mark.parametrize("bad", [
    dict(resume=True), dict(emergency_every=5), dict(check_finite_every=1),
    dict(consistency_every=1), dict(statusz_port=0), dict(elastic=True),
    dict(recovery=tconfig.RecoveryConfig(faults=("nan_loss@1",))),
    dict(recovery=tconfig.RecoveryConfig(max_retries=1)),
    dict(strategy="auto"),
])
def test_unported_options_are_refused_by_name(bad):
    with pytest.raises(ValueError, match="ROADMAP A"):
        tpipeline_trainer.PipelineTrainer(_port_config(**bad))


def test_ema_and_too_few_devices_refused_as_jax_does(tmp_path):
    cfg = _port_config().replace(optimizer=tconfig.OptimizerConfig(
        ema_decay=0.99))
    with pytest.raises(ValueError) as terr:
        tpipeline_trainer.PipelineTrainer(cfg)
    jcfg = tiny_train_config(tmp_path, mesh=jconfig.MeshConfig(stage=2),
                             optimizer=jconfig.OptimizerConfig(
                                 ema_decay=0.99))
    with pytest.raises(ValueError) as jerr:
        jpipeline_trainer.PipelineTrainer(jcfg)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="pipeline depth 4 needs"):
        tpipeline_trainer.PipelineTrainer(
            _port_config(mesh=tconfig.MeshConfig(stage=4)), devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipeline_trainer.PipelineTrainer(_port_config(device="cuda"))


_CLI = ["--device", "cpu", "--model", "tinycnn", "--epochs", "1",
        "--batch-size", "16", "--synthetic-train-size", "48",
        "--synthetic-eval-size", "16", "--stages", "2",
        "--microbatches", "2"]


@pytest.mark.parametrize("extra", [
    ["--fused"], ["--schedule", "1f1b", "--virtual-stages", "2"],
    ["--auto-partition"], ["--boundaries", "0,2,6"],
    ["--engine", "spmd", "--schedule", "1f1b"],
])
def test_cli_runs_on_the_cpu(capsys, extra):
    train_model_parallel.main(_CLI + extra)
    records = [json.loads(x) for x in
               capsys.readouterr().out.strip().splitlines()]
    assert [r["epoch"] for r in records] == [0]
    assert np.isfinite(records[0]["loss_train"])
    assert np.isfinite(records[0]["loss_val"])


@pytest.mark.parametrize("extra,match", [
    (["--dp", "2"], "--dp is an --engine spmd knob"),
    (["--engine", "spmd", "--virtual-stages", "2"], "ROADMAP A7"),
    (["--resume"], "ROADMAP A5"),
])
def test_cli_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        train_model_parallel.main(_CLI + extra)
