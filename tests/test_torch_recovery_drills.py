"""Recovery drills of the port's three trainers held against the JAX
package's on the same weights (augment off, f32, the CPU): an injected
NaN (``nan_loss`` in the CNN trainer and the pipeline, ``nan_params`` in
the LM) is detected by the guards, the good slot is restored and the
epoch retried at half the learning rate. The ordered ``failure`` and
``recovery`` records are equal (kind, what, epoch, ``retries_left``,
``lr_scale``), the histories and final parameters within 1e-4 (relative
to max(1, |want|)); the parameters stay views of the fused optimizer's
buckets through the restore; a torn save falls back; a stall escalates
to a checkpoint-and-exit whose resume equals the uninterrupted run bit
for bit."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.train import lm_trainer as jlm
from distributed_model_parallel_tpu.train import (
    pipeline_trainer as jpipeline_trainer,
)
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.models import params_to_jax
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm
from distributed_model_parallel_tpu_torch.train import (
    pipeline_trainer as tpipeline_trainer,
)
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import SHAPES, run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]
torch.set_num_threads(1)

DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)
RECORD_KEYS = ("kind", "error", "action", "epoch", "retries_left",
               "lr_scale")


def _records(path) -> list[tuple]:
    """The ordered failure/recovery records, by RECORD_KEYS."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [tuple(r.get(k) for k in RECORD_KEYS) for r in recs
            if r.get("kind") in ("failure", "recovery")]


def _recovery(**kw):
    return dict(check_finite_every=1,
                recovery=dict(max_retries=1, lr_shrink=0.5, **kw))


def _tconfig(tmp_path, name, **kw):
    rec = kw.pop("recovery", None)
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**DATA),
             optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                               warmup_steps=2,
                                               fused=kw.pop("fused", False)),
             epochs=1, log_every_n_steps=1000, device="cpu",
             **run_dirs(tmp_path, name))
    if rec is not None:
        d["recovery"] = tconfig.RecoveryConfig(**rec)
    d.update(kw)
    return tconfig.TrainConfig(**d)


def _jconfig(tmp_path, name, **kw):
    rec = kw.pop("recovery", None)
    if rec is not None:
        kw["recovery"] = jconfig.RecoveryConfig(**rec)
    return tiny_train_config(tmp_path / name, data=jconfig.DataConfig(**DATA),
                             epochs=1, log_name=name, **kw)


def test_cnn_nan_recovery_matches_jax(tmp_path):
    jt = jtrainer.Trainer(_jconfig(tmp_path, "jax", mesh=jconfig.MeshConfig(
        data=1), **_recovery(faults=("nan_loss@1",))))
    params = jax.tree.map(np.asarray, jt.state.params)
    state = jax.tree.map(np.asarray, jt.state.model_state)
    want = jt.fit()
    t = ttrainer.Trainer(_tconfig(tmp_path, "port", fused=True,
                                  **_recovery(faults=("nan_loss@1",))),
                         params=params, state=state)
    views = [p.data_ptr() for p in t.model.parameters()]
    got = t.fit()
    # The restore wrote into the fused buckets: the parameters are still
    # their slots (FusedSGD checks it at every step too).
    assert [p.data_ptr() for p in t.model.parameters()] == views
    assert _records(t.logger.jsonl_path) == _records(jt.logger.jsonl_path)
    assert _records(t.logger.jsonl_path) == [
        ("failure", "non-finite", None, 0, 1, None),
        ("recovery", None, "restored", 0, 0, 0.5)]
    assert t.config.optimizer.learning_rate == 0.05
    for g, w in zip(got, want, strict=True):
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
    with torch.no_grad():
        mine, _ = params_to_jax(t.model)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(
            jax.tree.map(np.asarray, jt.state.params)), strict=True):
        _close(a, b, "params")


def test_pipeline_nan_recovery_matches_jax(tmp_path):
    kw = dict(mesh=dict(stage=2), num_microbatches=1,
              **_recovery(faults=("nan_loss@1",)))
    jt = jpipeline_trainer.PipelineTrainer(_jconfig(
        tmp_path, "jax", **{**kw, "mesh": jconfig.MeshConfig(stage=2)}))
    params = jax.tree.map(np.asarray, jt.runner.merged_params())
    state = jax.tree.map(np.asarray, jt.runner.merged_model_state())
    want = jt.fit()
    t = tpipeline_trainer.PipelineTrainer(
        _tconfig(tmp_path, "port", **{**kw, "mesh": tconfig.MeshConfig(
            stage=2)}), params=params, state=state)
    got = t.fit()
    assert _records(t.logger.jsonl_path) == _records(jt.logger.jsonl_path)
    assert [r[:2] for r in _records(t.logger.jsonl_path)] == [
        ("failure", "non-finite"), ("recovery", None)]
    for g, w in zip(got, want, strict=True):
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
    with torch.no_grad():
        mine, _ = params_to_jax(t.runner.model)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jax.tree.map(
            np.asarray, jt.runner.merged_params())), strict=True):
        _close(a, b, "params")


def test_lm_nan_recovery_matches_jax(tmp_path):
    common = dict(batch_size=4, seq_len=16, steps_per_epoch=3, epochs=1,
                  n_tokens=2000, eval_batches=2, check_finite_every=1)
    jt = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**SHAPES["mha"]),
        recovery=jconfig.RecoveryConfig(max_retries=1, lr_shrink=0.5,
                                        faults=("nan_params@2",)),
        **run_dirs(tmp_path, "jax"), **common))
    tree = jax.tree.map(np.asarray, jt.params)
    want = jt.fit()
    cfg = ttfm.TransformerConfig(**SHAPES["mha"])
    t = tlm.LMTrainer(tlm.LMTrainConfig(
        model=cfg, device="cpu",
        recovery=tconfig.RecoveryConfig(max_retries=1, lr_shrink=0.5,
                                        faults=("nan_params@2",)),
        **run_dirs(tmp_path, "port"), **common),
        params=ttfm.params_from_jax(tree, cfg, "cpu"))
    got = t.fit()
    assert _records(t.logger.jsonl_path) == _records(jt.logger.jsonl_path)
    assert [r[:3] for r in _records(t.logger.jsonl_path)] == [
        ("failure", "non-finite", None), ("recovery", None, "restored")]
    for g, w in zip(got, want, strict=True):
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
    whole = t.whole_params()
    for k in ("embed", "head"):
        _close(whole[k].detach().numpy(), np.asarray(jt.params[k]), k)


def test_torn_and_failed_saves_fall_back(tmp_path):
    """``save_fail`` on the good slot's first save (at ``fit``'s start):
    recorded and retried; ``tear_save`` on the save after epoch 1 (the
    save site's 4th poll): the recovery restore of epoch 2's NaN skips
    the torn version for the one before (a ``checkpoint-torn`` record)."""
    t = ttrainer.Trainer(_tconfig(
        tmp_path, "saves", fused=True, epochs=3, check_finite_every=1,
        eval_every=10,              # no best-accuracy save before epoch 2
        recovery=dict(max_retries=1, faults=(
            "save_fail@0", "tear_save@3", "nan_loss@7"))))
    views = [p.data_ptr() for p in t.model.parameters()]
    history = t.fit()
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert [p.data_ptr() for p in t.model.parameters()] == views
    got = [r[:3] for r in _records(t.logger.jsonl_path)]
    assert got == [("failure", "checkpoint-save-failed", None),
                   ("recovery", None, "save-retried"),
                   ("failure", "non-finite", None),
                   ("failure", "checkpoint-torn", None),
                   ("recovery", None, "checkpoint-fallback"),
                   ("recovery", None, "restored")]


def test_stall_exit_then_resume_equals_uninterrupted(tmp_path):
    """A ``stall`` past the budget with ``stall_exit``: a checkpoint-and-
    exit at the next step boundary; the resumed run ends bit for bit where
    the uninterrupted one does."""
    kw = dict(fused=True, max_inflight_steps=1, epochs=2)
    a = ttrainer.Trainer(_tconfig(tmp_path, "a", **kw))
    a.fit()
    cfg = _tconfig(tmp_path, "b", stall_budget_s=0.05,
                   recovery=dict(max_retries=1, stall_exit=True,
                                 faults=("stall@1:0.3",)), **kw)
    b = ttrainer.Trainer(cfg)
    assert b.fit() == []
    assert b.ckpt.exists("preempt") and b.global_step == 2
    assert [r[:2] for r in _records(b.logger.jsonl_path)] == [
        ("failure", "stall")]
    r = ttrainer.Trainer(dataclasses.replace(cfg, resume=True,
                                             recovery=tconfig.RecoveryConfig()))
    r.fit()
    assert r.global_step == a.global_step
    for x, y in zip(a.model.parameters(), r.model.parameters(), strict=True):
        assert torch.equal(x, y)
