"""The CNN ``Trainer``'s weight average (``ema_decay``, ``trainer.Ema``)
and its checkpointed optimizer state against the JAX package: the update
rule against a host recurrence (1e-6), with its step size 0 between
accumulation boundaries; tinycnn fits with EMA (alone and under
``accum_steps``) at one rank and under fsdp at 2 gloo ranks == the JAX
trainer's history and ``ema_params``/``ema_model_state`` (1e-4); a fit
with adamw, ``accum_steps=2`` and ``ema_decay=0.99`` preempted
mid-accumulation and resumed == the uninterrupted fit, every array of the
checkpoint bit for bit, at one rank and at 2 gloo ranks (gspmd, fsdp); a
resume with EMA toggled behaves as the JAX trainer's; and the refusals,
in the JAX package's words."""

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    flatten_tree,
)
from tests._torch_port_util import run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close, _close_trees

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DATA = dict(name="synthetic", batch_size=16, eval_batch_size=16,
            synthetic_train_size=64, synthetic_eval_size=16, augment=False)
CASES = {"ema": dict(learning_rate=0.1, ema_decay=0.9),
         "ema_accum": dict(learning_rate=0.1, ema_decay=0.9, accum_steps=2)}
RESUME_OPT = dict(name="adamw", learning_rate=0.01, accum_steps=2,
                  ema_decay=0.99)
STEPS = 4                                    # per epoch
PREEMPT_AT = STEPS + 1                       # mid-accumulation


def _jax_fit(tmp, data: int, strategy: str, opt: dict):
    cfg = tiny_train_config(tmp, mesh=jconfig.MeshConfig(data=data),
                            strategy=strategy,
                            data=jconfig.DataConfig(**DATA), epochs=2,
                            optimizer=jconfig.OptimizerConfig(
                                warmup_steps=2, **opt))
    t = jtrainer.Trainer(cfg)
    out = dict(params0=jax.tree.map(np.asarray, t.state.params),
               state0=jax.tree.map(np.asarray, t.state.model_state))
    out["history"] = t.fit()
    out["ema_params"] = jax.tree.map(np.asarray, t.state.ema_params)
    out["ema_batch_stats"] = jax.tree.map(np.asarray,
                                          t.state.ema_model_state)
    return out


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    out = {(case, "gspmd"): _jax_fit(tmp_path_factory.mktemp(case), 1,
                                     "gspmd", opt)
           for case, opt in CASES.items()}
    out[("ema", "fsdp")] = _jax_fit(tmp_path_factory.mktemp("fsdp"), 2,
                                    "fsdp", CASES["ema"])
    return out


def _config(tmp, name, opt, **kw):
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**DATA),
             optimizer=tconfig.OptimizerConfig(warmup_steps=2, **opt),
             epochs=2, log_every_n_steps=1000, device="cpu",
             **run_dirs(tmp, name))
    d.update(kw)
    return tconfig.TrainConfig(**d)


def _check(got_hist, got_ema, want):
    assert len(got_hist) == len(want["history"]) == 2
    for g, w in zip(got_hist, want["history"]):
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
        for k in ("acc1_train", "acc1_val"):
            assert abs(g[k] - w[k]) < 1e-6, (k, g[k], w[k])
    for k in ("ema_params", "ema_batch_stats"):
        _close_trees(got_ema[k], want[k], k)


@pytest.mark.parametrize("case", list(CASES))
def test_ema_fit_matches_jax(jax_fits, case, tmp_path):
    """2 epochs at one rank from the JAX run's weights: the history (its
    eval reads the average) and the averaged weights and statistics."""
    want = jax_fits[(case, "gspmd")]
    t = ttrainer.Trainer(_config(tmp_path, case, CASES[case]),
                         params=want["params0"], state=want["state0"])
    hist = t.fit()
    _check(hist, t._ema_tree(), want)


@pytest.fixture(scope="module")
def fsdp_runs(jax_fits, tmp_path_factory):
    want = jax_fits[("ema", "fsdp")]
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    root = tmp_path_factory.mktemp("runs")
    runs = {"fsdp": dict(config=_config(
        root, "fsdp", CASES["ema"], strategy="fsdp",
        mesh=tconfig.MeshConfig(data=2)), params=want["params0"],
        state=want["state0"])}
    return tmesh.spawn(workers.trainer_runs, 2, runs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), device="cpu",
                       timeout_s=300, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


def test_fsdp_ema_matches_jax(jax_fits, fsdp_runs):
    """fsdp at 2 gloo ranks keeps each rank's slice of the average; the
    gathered averages and the history == the JAX trainer's fsdp fit at
    data=2, on both ranks."""
    for r in fsdp_runs:
        _check(r["fsdp"]["history"], r["fsdp"]["ema"],
               jax_fits[("ema", "fsdp")])


@pytest.mark.parametrize("accum", [False, True])
def test_ema_update_matches_host_recurrence(accum):
    """``Ema.update``: avg = (1 - d)·new + d·avg after each boundary, the
    average held off a boundary (1e-6 against float64 on the host)."""
    from distributed_model_parallel_tpu_torch.models import get_model

    model = get_model(tconfig.ModelConfig(name="tinycnn"), device="cpu")
    d = 0.8
    ema = ttrainer.Ema(model, d, accum)
    rng = np.random.default_rng(0)
    host = [t.detach().double().numpy().copy() for t in ema.live]
    for step in range(6):
        boundary = not accum or step % 2 == 1
        with torch.no_grad():
            for t in ema.live:
                t.add_(torch.from_numpy(rng.normal(
                    size=tuple(t.shape)).astype(np.float32)))
        ema.update(boundary)
        if boundary:
            host = [(1 - d) * t.detach().double().numpy() + d * h
                    for t, h in zip(ema.live, host)]
        for a, h in zip(ema.avg, host):
            np.testing.assert_allclose(a.numpy(), h, rtol=1e-6, atol=1e-6)


def _preempted(cfg):
    t = ttrainer.Trainer(cfg)
    t.step_hook = (lambda tr: tr.preemption.request()
                   if tr.global_step == PREEMPT_AT else None)
    first = t.fit()
    assert t.optimizer.accum.mini_step == 1         # mid-accumulation
    resumed = ttrainer.Trainer(cfg.replace(resume=True))
    return t, first + resumed.fit(), resumed


def _same_trees(a: dict, b: dict) -> int:
    """Arrays that differ between two checkpoint trees (same keys)."""
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert set(fa) == set(fb)
    return sum(not np.array_equal(fa[k], fb[k]) for k in fa)


def test_resume_mid_accumulation_is_bit_for_bit(tmp_path):
    """adamw, accum_steps 2, ema_decay 0.99: fit() preempted at an odd
    step and resumed == the uninterrupted fit, every checkpoint array
    (parameters, statistics, adam's mu/nu, the accumulated mean and its
    counters, the averages) and the eval history."""
    a = ttrainer.Trainer(_config(tmp_path, "a", RESUME_OPT))
    a_hist = a.fit()
    _, b_hist, b = _preempted(_config(tmp_path, "b", RESUME_OPT))
    ta, tb = a._ckpt_tree(), b._ckpt_tree()
    assert {"opt_state", "accum", "ema_params"} <= set(ta)
    assert sorted(ta["opt_state"]) == ["acc_grads", "mu", "nu"]
    assert _same_trees(ta, tb) == 0
    assert [h["acc1_val"] for h in a_hist] == [h["acc1_val"]
                                               for h in b_hist[-2:]]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    configs = {s: _config(tmp, s, RESUME_OPT, strategy=s,
                          mesh=tconfig.MeshConfig(data=2))
               for s in ("gspmd", "fsdp")}
    # ZeRO takes no accumulation or EMA: adamw alone, its mu/nu slices.
    configs["zero"] = _config(tmp, "zero", dict(name="adamw",
                                                learning_rate=0.01),
                              strategy="zero",
                              mesh=tconfig.MeshConfig(data=2))
    return tmesh.spawn(workers.preempt_resume, 2, configs,
                       (train.images, train.labels),
                       (evals.images, evals.labels), PREEMPT_AT,
                       device="cpu", timeout_s=300, threads=1,
                       store_dir=str(tmp), config=tconfig.MeshConfig(data=2))


@pytest.mark.parametrize("strategy", ["gspmd", "fsdp"])
def test_two_ranks_resume_mid_accumulation(rank_runs, strategy):
    """At 2 gloo ranks, each rank's resumed run's checkpoint tree == its
    uninterrupted run's, every array bit for bit, and the ranks agree."""
    for r in rank_runs:
        a, b = r[strategy]["a"], r[strategy]["b"]
        assert _same_trees(a["tree"], b["tree"]) == 0
        assert a["step"] == b["step"] == 2 * STEPS
    assert _same_trees(rank_runs[0][strategy]["b"]["tree"],
                       rank_runs[1][strategy]["b"]["tree"]) == 0


def test_two_ranks_zero_adamw_resumes_bit_for_bit(rank_runs):
    """ZeRO with adamw at 2 gloo ranks: the checkpoint holds every leaf's
    whole mu and nu, gathered from the ranks' slices, and the resumed run
    restores each rank's slice: every array bit for bit."""
    for r in rank_runs:
        a, b = r["zero"]["a"], r["zero"]["b"]
        assert sorted(a["tree"]["opt_state"]) == ["mu", "nu"]
        assert _same_trees(a["tree"], b["tree"]) == 0
    assert _same_trees(rank_runs[0]["zero"]["b"]["tree"],
                       rank_runs[1]["zero"]["b"]["tree"]) == 0


@pytest.mark.parametrize("first,second", [(0.9, None), (None, 0.9)])
def test_resume_with_ema_toggled(tmp_path, first, second):
    """As the JAX trainer's _resume: a checkpoint without averages resumed
    with ema_decay starts the average at the restored weights and
    statistics; one with averages resumed without it drops them."""
    opt = dict(learning_rate=0.1)
    cfg = _config(tmp_path, "t", dict(opt, ema_decay=first))
    t = ttrainer.Trainer(cfg)
    t.step_hook = (lambda tr: tr.preemption.request()
                   if tr.global_step == PREEMPT_AT else None)
    t.fit()
    cfg2 = _config(tmp_path, "t", dict(opt, ema_decay=second))
    r = ttrainer.Trainer(cfg2.replace(resume=True))
    assert r.global_step == PREEMPT_AT
    if second is None:
        assert r.ema is None and "ema_params" not in r._ckpt_tree()
    else:
        for live, avg in zip(r.ema.live, r.ema.avg):
            torch.testing.assert_close(avg, live.detach(), rtol=0, atol=0)
    assert len(r.fit()) == 1


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="spmd_pipeline", mesh=tconfig.MeshConfig(stage=2)),
     "ema_decay is supported on the gspmd/fsdp strategies"),
    (dict(strategy="ddp"),
     "ema_decay is supported on the gspmd/fsdp strategies"),
    (dict(strategy="zero"), "takes no grad_clip_norm, accum_steps or "
                            "ema_decay"),
])
def test_ema_refusals(tmp_path, kw, match):
    """EMA is gspmd's and fsdp's, as in the JAX trainer; ZeRO's step
    takes none."""
    with pytest.raises(ValueError, match=match):
        ttrainer.Trainer(_config(tmp_path, "x", dict(ema_decay=0.9), **kw))


def test_pipeline_trainer_refuses_ema(tmp_path):
    from distributed_model_parallel_tpu_torch.train import pipeline_trainer

    cfg = _config(tmp_path, "p", dict(ema_decay=0.9),
                  mesh=tconfig.MeshConfig(stage=2))
    with pytest.raises(ValueError, match="not the pipeline trainer"):
        pipeline_trainer.PipelineTrainer(cfg)


@pytest.mark.parametrize("kw", [dict(grad_clip_norm=1.0),
                                dict(accum_steps=2)])
def test_zero_refuses_clip_and_accumulation(tmp_path, kw):
    with pytest.raises(ValueError, match="takes no grad_clip_norm"):
        ttrainer.Trainer(_config(tmp_path, "z", kw, strategy="zero"))
