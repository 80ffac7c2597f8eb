"""The trainers' input path against the JAX package (the 224 px step is
tests/test_torch_resize_224.py): ``Trainer`` (per batch and
device-resident), ``PipelineTrainer`` and 2 SPMD ranks at a non-native
``image_size`` == the JAX trainers within 1e-4; the host and device
prefetch stages and the native gather change nothing (bitwise), and a
run preempted under prefetch resumes bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.train import (
    pipeline_trainer as jpipeline_trainer,
)
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.models import params_to_jax
from distributed_model_parallel_tpu_torch.ops.collectives import tree_flatten
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import (
    pipeline_trainer as tpipeline_trainer,
)
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_pipeline_trainer import _check_history

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# 32 px synthetic rows trained at 48 px.
DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False,
            image_size=48, synthetic_native_size=32)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX Trainer (one device) and PipelineTrainer (2 stages, M=2)
    at image_size 48 on 32 px rows: initial weights and histories."""
    out = {}
    root = tmp_path_factory.mktemp("jax")
    t = jtrainer.Trainer(tiny_train_config(
        root / "dp", mesh=jconfig.MeshConfig(data=1),
        data=jconfig.DataConfig(**DATA), epochs=2))
    out["dp"] = (jax.tree.map(np.asarray, t.state.params),
                 jax.tree.map(np.asarray, t.state.model_state), t.fit())
    p = jpipeline_trainer.PipelineTrainer(tiny_train_config(
        root / "pp", mesh=jconfig.MeshConfig(stage=2),
        data=jconfig.DataConfig(**DATA), epochs=2, num_microbatches=2))
    out["pp"] = (p.runner.merged_params(), p.runner.merged_model_state(),
                 p.fit())
    return out


def _config(tmp_path, name="run", data=DATA, **kw):
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(**data),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2,
                                          fused=kw.pop("fused", False)),
        epochs=2, log_every_n_steps=1000, device="cpu",
        **run_dirs(tmp_path, name), **kw)


@pytest.mark.parametrize("resident", [False, True])
def test_trainer_at_image_size_matches_jax(jax_runs, tmp_path, resident):
    """Trainer.fit at image_size 48 over 32 px rows (resized in every
    train and eval step, per batch or device-resident 2 steps a
    dispatch) == the JAX trainer's history."""
    params, state, want = jax_runs["dp"]
    t = ttrainer.Trainer(_config(tmp_path, device_resident_data=resident,
                                 steps_per_dispatch=2, fused=True),
                         params=params, state=state)
    _check_history(t.fit(), want)


def test_pipeline_trainer_at_image_size_matches_jax(jax_runs, tmp_path):
    params, state, want = jax_runs["pp"]
    t = tpipeline_trainer.PipelineTrainer(
        _config(tmp_path, mesh=tconfig.MeshConfig(stage=2),
                num_microbatches=2), params=params, state=state)
    assert t.runner.resize_to == 48
    _check_history(t.fit(), want)


def test_spmd_ranks_at_image_size_match_jax(jax_runs, tmp_path):
    """Two SPMD ranks (stage 0 resizes its rows before the augmentation
    and in evaluation; the boundary shapes are the 48 px model's) == the
    JAX PipelineTrainer's history."""
    params, state, want = jax_runs["pp"]
    cfg = _config(tmp_path, mesh=tconfig.MeshConfig(stage=2),
                  num_microbatches=2, strategy="spmd_pipeline")
    train, evals = load_dataset(cfg.data)
    assert train.images.shape[1] == 32
    ranks = tmesh.spawn(
        workers.spmd_trainer_fit, 2, cfg, params, state,
        (train.images, train.labels), (evals.images, evals.labels),
        device="cpu", timeout_s=300, threads=1, store_dir=str(tmp_path),
        config=tconfig.MeshConfig(stage=2))
    for r in ranks:
        _check_history(r["history"], want)


def _fit_state(t) -> list:
    with torch.no_grad():
        trees = (params_to_jax(t.model), t._momentum_tree())
    return tree_flatten(trees)[0] + [t.optimizer.count, t.global_step]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


AUG = {**DATA, "augment": True, "image_size": 32}


@pytest.mark.parametrize("prefetch,device_prefetch,native", [
    (2, 2, False), (3, 0, False), (0, 3, False), (2, 2, True)])
def test_prefetch_and_native_change_nothing(tmp_path, prefetch,
                                            device_prefetch, native):
    """fit(2) with the host and device prefetch stages (and the native
    gather) == fit(2) with neither, bit for bit."""
    plain = ttrainer.Trainer(_config(tmp_path, "plain", data={
        **AUG, "prefetch": 0, "device_prefetch": 0}))
    h0 = plain.fit()
    t = ttrainer.Trainer(_config(tmp_path, "pre", data={
        **AUG, "prefetch": prefetch, "device_prefetch": device_prefetch,
        "use_native": native}))
    h1 = t.fit()
    _same(_fit_state(plain), _fit_state(t))
    assert [h["loss_val"] for h in h0] == [h["loss_val"] for h in h1]


@pytest.mark.parametrize("pipeline", [False, True])
def test_kill_resume_under_prefetch_is_bitwise(tmp_path, pipeline):
    """With both prefetch stages running ahead (depth 3 and 2), a run
    preempted at step 4 and resumed == the uninterrupted run without
    prefetch, bit for bit: run-ahead batches are never counted as
    consumed."""
    kw = (dict(mesh=tconfig.MeshConfig(stage=2), num_microbatches=2)
          if pipeline else {})
    cls = (tpipeline_trainer.PipelineTrainer if pipeline
           else ttrainer.Trainer)
    base = cls(_config(tmp_path, "base", data={
        **AUG, "prefetch": 0, "device_prefetch": 0}, **kw))
    base.fit()
    cfg = _config(tmp_path, "kill", data={**AUG, "prefetch": 3,
                                          "device_prefetch": 2}, **kw)
    killed = cls(cfg)

    def hook(t):
        if t.global_step == 4:
            t.preemption.request()

    killed.step_hook = hook
    killed.fit()
    assert killed.train_loader.state_dict() == {"epoch": 1,
                                                "batch_cursor": 1}
    resumed = cls(dataclasses.replace(cfg, resume=True))
    assert resumed.global_step == 4 and resumed.train_loader.cursor == 1
    resumed.fit()
    state = (lambda t: tree_flatten(t._ckpt_tree()["params"])[0]
             + [t.global_step])
    _same(state(base), state(resumed))
