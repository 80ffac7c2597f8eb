"""Checkpoint/resume, preemption and run logs on the port's CNN
``Trainer``: tinycnn ``fit(2)`` == ``fit`` preempted mid-epoch by
``step_hook`` and resumed by a new ``Trainer(resume=True)``, bit for bit
(parameters, momentum, BN statistics, update count, global step, the
histories), per batch and device-resident; the best-accuracy slot, the
slot precedence and the torn-version fallback; ``PreemptionGuard``;
``RunLogger``'s lines == the JAX ``RunLogger``'s; the resumed history ==
the JAX trainer's on the same weights within 1e-4 (f32, augment off);
``ddp``, ``zero`` and ``fsdp`` at 2 gloo ranks resumed bit for bit;
the pipeline CLI's spmd engine resuming; the CLI's ``--resume``."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.train import logging_util as jlog
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.models import params_to_jax
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import logging_util as tlog
from distributed_model_parallel_tpu_torch.train import train_cnn
from distributed_model_parallel_tpu_torch.train import train_model_parallel
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    PAYLOAD_FILENAME,
)
from distributed_model_parallel_tpu_torch.train.preemption import (
    PreemptionGuard,
)
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DATA = dict(name="synthetic", batch_size=16, eval_batch_size=16,
            synthetic_train_size=64, synthetic_eval_size=16)
STEPS = 4                                   # per epoch
PREEMPT_AT = STEPS + 2                      # step 2 of epoch 1
TIME_KEYS = ("time_per_batch", "time_load_per_batch")


def _config(tmp_path, name, **kw):
    opt = dict(learning_rate=0.1, warmup_steps=2, fused=kw.pop("fused",
                                                               False))
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**{**DATA, **kw.pop("data", {})}),
             optimizer=tconfig.OptimizerConfig(**opt), epochs=2,
             log_every_n_steps=1000, device="cpu",
             log_dir=str(tmp_path / "log"), log_name=name,
             checkpoint_dir=str(tmp_path / f"ckpt_{name}"))
    d.update(kw)
    return tconfig.TrainConfig(**d)


def _preempt_at(step):
    def hook(t):
        if t.global_step == step:
            t.preemption.request()
    return hook


def _run_preempted(cfg):
    """fit() preempted at PREEMPT_AT, then a new Trainer(resume=True)
    finishing it: (both histories, the resumed trainer)."""
    t = ttrainer.Trainer(cfg)
    t.step_hook = _preempt_at(PREEMPT_AT)
    first = t.fit()
    assert t.global_step == PREEMPT_AT and t.start_epoch == 1
    assert t.ckpt.exists("preempt")
    resumed = ttrainer.Trainer(cfg.replace(resume=True))
    assert resumed.global_step == PREEMPT_AT
    assert resumed.train_loader.state_dict() == {
        "epoch": 1, "batch_cursor": PREEMPT_AT - STEPS}
    return first, resumed.fit(), resumed


def _state(t) -> list:
    """Every array of a trainer's state, in the JAX layout."""
    with torch.no_grad():
        params, stats = params_to_jax(t.model)
    return jax.tree.leaves((params, stats, t._momentum_tree()))


def _assert_same_run(a, a_hist, b, b_hist):
    """b (preempted, then resumed) == a (uninterrupted), bit for bit."""
    for x, y in zip(_state(a), _state(b), strict=True):
        np.testing.assert_array_equal(x, y)
    assert (a.optimizer.count, a.global_step) == (b.optimizer.count,
                                                  b.global_step)
    assert [h["epoch"] for h in b_hist] == [0, 1]
    strip = [{k: v for k, v in h[0].items() if k not in TIME_KEYS}
             for h in (a_hist, b_hist)]
    # Epoch 0 ran whole in both; epoch 1's train averages cover only the
    # steps its trainer ran (as in the JAX trainer), its eval all of it.
    assert strip[0] == strip[1]
    for k in ("loss_val", "acc1_val"):
        assert a_hist[1][k] == b_hist[1][k]


@pytest.mark.parametrize("fused,resident", [(False, False), (True, False),
                                            (True, True)])
def test_preempted_and_resumed_fit_equals_uninterrupted(tmp_path, fused,
                                                        resident):
    kw = dict(fused=fused, device_resident_data=resident,
              steps_per_dispatch=2)
    a = ttrainer.Trainer(_config(tmp_path, "a", **kw))
    a_hist = a.fit()
    first, second, b = _run_preempted(_config(tmp_path, "b", **kw))
    assert [h["epoch"] for h in first] == [0]
    assert [h["epoch"] for h in second] == [1]
    _assert_same_run(a, a_hist, b, first + second)
    lines = open(tmp_path / "log" / "b.txt").read().splitlines()
    assert [x.split()[0] for x in lines if x.startswith("epoch:")] == [
        "epoch:0", "epoch:1"]
    assert f"preempted: checkpoint saved at epoch 1, global step " \
           f"{PREEMPT_AT}" in lines
    assert any(x.startswith("resume: slot 'preempt' -> epoch 1 batch 2")
               for x in lines)


def test_best_acc_slot_precedence_and_fallback(tmp_path):
    cfg = _config(tmp_path, "p")
    t = ttrainer.Trainer(cfg)
    t.fit(1)
    assert t.ckpt.exists("ckpt") and not t.ckpt.exists("preempt")
    tmpl = t._ckpt_tree()
    saved = t.ckpt.restore(tmpl, "ckpt")
    assert float(saved["best_acc"]) == np.float32(t.best_acc) > 0
    assert int(saved["epoch"]) == 1
    # The newer preempt slot wins over the best-accuracy slot.
    t.step_hook = _preempt_at(STEPS + 1)
    t.fit(2)
    r = ttrainer.Trainer(cfg.replace(resume=True))
    assert r.global_step == STEPS + 1 and r.start_epoch == 1
    # A torn preempt slot (its only version) falls back to "ckpt".
    path = r.ckpt._latest_path("preempt")
    p = os.path.join(path, PAYLOAD_FILENAME)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    r2 = ttrainer.Trainer(cfg.replace(resume=True))
    assert r2.global_step == STEPS and r2.start_epoch == 1
    assert r2.best_acc == float(np.float32(t.best_acc))
    log = open(tmp_path / "log" / "p.txt").read()
    assert "checkpoint fallback: preempt-0 rejected (size mismatch" in log
    assert "resume: slot 'ckpt' -> epoch 1 batch 0" in log


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    t = ttrainer.Trainer(_config(tmp_path, "fresh", resume=True))
    assert (t.start_epoch, t.global_step) == (0, 0)


def test_guard_flag_and_reset():
    g = PreemptionGuard()
    assert not g.requested()
    g.request()
    assert g.requested()
    g.reset()
    assert not g.requested()


def test_guard_installs_and_restores_handlers():
    g = PreemptionGuard(signals=(signal.SIGTERM,))
    before = signal.getsignal(signal.SIGTERM)
    with g.installed():
        assert signal.getsignal(signal.SIGTERM) != before
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested()
    assert signal.getsignal(signal.SIGTERM) == before


def test_guard_second_sigint_chains_to_previous_handler():
    seen = []
    before = signal.signal(signal.SIGINT, lambda s, f: seen.append(s))
    try:
        g = PreemptionGuard(signals=(signal.SIGINT,))
        with g.installed():
            os.kill(os.getpid(), signal.SIGINT)
            assert g.requested() and seen == []
            os.kill(os.getpid(), signal.SIGINT)
            assert seen == [signal.SIGINT]
    finally:
        signal.signal(signal.SIGINT, before)


def test_run_logger_lines_equal_jax(tmp_path):
    """The same records through both loggers: the .txt files are equal
    character for character; the port's .jsonl holds them as records."""
    records = [dict(epoch=0, loss_train=2.3025851249694824,
                    acc1_train=9.375, loss_val=None, acc1_val=None,
                    time_per_batch=0.012345678, time_load_per_batch=1e-05),
               dict(epoch=1, loss_train=1.5, acc1_train=50.0,
                    loss_val=1.25, acc1_val=62.5, time_per_batch=3,
                    time_load_per_batch=0.0)]
    j = jlog.RunLogger(str(tmp_path / "j"), "run", echo=False)
    t = tlog.RunLogger(str(tmp_path / "t"), "run", echo=False)
    for logger in (j, t):
        for r in records:
            logger.log_epoch(**r)
        logger.log_line("preempted: checkpoint saved at epoch 1")
        logger.log_step(1, 30, loss=1.0, acc1=50.0)
    assert open(t.txt_path).read() == open(j.txt_path).read()
    kinds = [json.loads(x)["kind"] for x in open(t.jsonl_path)]
    assert kinds == ["run_start", "epoch", "epoch", "event", "step"]


def test_resumed_history_matches_jax_trainer(tmp_path):
    """tinycnn at one rank, augment off, from the JAX run's weights: the
    preempted fit's and the resumed fit's records == the JAX trainer's
    (preempted by its own step_hook at the same step) within 1e-4."""
    data = dict(DATA, augment=False)
    jcfg = tiny_train_config(tmp_path / "jax", mesh=jconfig.MeshConfig(
        data=1), data=jconfig.DataConfig(**data), epochs=2)
    jt = jtrainer.Trainer(jcfg)
    params = jax.tree.map(np.asarray, jt.state.params)
    state = jax.tree.map(np.asarray, jt.state.model_state)
    jt.step_hook = (lambda tr: tr.preemption.request()
                    if tr._global_step == PREEMPT_AT else None)
    want = jt.fit()
    want += jtrainer.Trainer(jcfg.replace(resume=True)).fit()
    cfg = _config(tmp_path, "vs_jax", data=dict(augment=False))
    t = ttrainer.Trainer(cfg, params=params, state=state)
    t.step_hook = _preempt_at(PREEMPT_AT)
    got = t.fit()
    got += ttrainer.Trainer(cfg.replace(resume=True), params=params,
                            state=state).fit()
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [0, 1]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
        for k in ("acc1_train", "acc1_val"):
            assert abs(g[k] - w[k]) < 1e-6, (k, g[k], w[k])


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One spawn of 2 gloo ranks: per strategy an uninterrupted fit and a
    preempted-then-resumed one."""
    tmp = tmp_path_factory.mktemp("ranks")
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    configs = {s: _config(tmp, s, strategy=s,
                          mesh=tconfig.MeshConfig(data=2),
                          fused=s == "zero")
               for s in ("ddp", "zero", "fsdp")}
    return tmesh.spawn(workers.preempt_resume, 2, configs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), PREEMPT_AT,
                       device="cpu", timeout_s=300, threads=1,
                       store_dir=str(tmp), config=tconfig.MeshConfig(data=2))


@pytest.mark.parametrize("strategy", ["ddp", "zero", "fsdp"])
def test_two_ranks_resume_bit_for_bit(rank_runs, strategy):
    """Each rank's resumed run == its uninterrupted run bit for bit
    (parameters, momentum, every rank's BN statistics, update count,
    global step, eval history), and the ranks agree."""
    for r in rank_runs:
        a, b = r[strategy]["a"], r[strategy]["b"]
        for x, y in zip(jax.tree.leaves((a["params"], a["momentum"],
                                         a["state"])),
                        jax.tree.leaves((b["params"], b["momentum"],
                                         b["state"])), strict=True):
            np.testing.assert_array_equal(x, y)
        assert (a["count"], a["step"]) == (b["count"], b["step"]) == (
            2 * STEPS, 2 * STEPS)
        assert [h["acc1_val"] for h in a["history"]] == [
            h["acc1_val"] for h in b["history"]]
    for x, y in zip(jax.tree.leaves(rank_runs[0][strategy]["b"]["params"]),
                    jax.tree.leaves(rank_runs[1][strategy]["b"]["params"])):
        np.testing.assert_array_equal(x, y)


def test_spmd_pipeline_cli_resumes(tmp_path, capsys):
    """The pipeline CLI's spmd engine at 2 gloo ranks: a one-epoch run,
    then ``--resume`` to two, continuing from the best-accuracy
    checkpoint rank 0 wrote after gathering both stages."""
    args = ["--device", "cpu", "--model", "tinycnn", "--engine", "spmd",
            "--stages", "2", "--microbatches", "2", "--batch-size", "16",
            "--synthetic-train-size", "48", "--synthetic-eval-size", "16",
            "--log-dir", str(tmp_path / "log"),
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    train_model_parallel.main(args + ["--epochs", "1"])
    train_model_parallel.main(args + ["--epochs", "2", "--resume"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1]
    log = open(tmp_path / "log" / "16.txt").read()
    assert "resume: slot 'ckpt' -> epoch 1 batch 0 (global step 3)" in log


def test_cli_resume(tmp_path, capsys):
    args = ["--device", "cpu", "--model", "tinycnn", "--batch-size", "16",
            "--synthetic-train-size", "48", "--synthetic-eval-size", "16",
            "--log-dir", str(tmp_path / "log"), "--checkpoint-dir",
            str(tmp_path / "ckpt")]
    train_cnn.main(args + ["--epochs", "1"])
    train_cnn.main(args + ["--epochs", "2", "--resume"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1]
    log = open(tmp_path / "log" / "data_para_16.txt").read()
    assert "resume: slot 'ckpt' -> epoch 1 batch 0 (global step 3)" in log
