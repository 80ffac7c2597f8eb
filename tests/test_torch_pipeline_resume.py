"""The pipeline's harness (``train/pipeline_trainer.py`` and
``Trainer(strategy="spmd_pipeline")``): tinycnn ``fit(2)`` == a ``fit``
preempted mid-epoch by ``step_hook`` and finished by a new trainer with
``resume=True``, bit for bit (parameters, momentum, BN statistics, the
update counts, the global step, the histories) on the runner (gpipe,
1f1b with the fused buckets, interleaved) and at 2 gloo SPMD ranks
(gpipe, 1f1b with an asynchronous checkpoint, interleaved over ranks);
the checkpoint tree's keys == the data-parallel Trainer's; a restore
writes into the chunks' tensors in place (fused bucket views kept); the
best-accuracy slot; the resumed history == the JAX ``PipelineTrainer``'s
within 1e-4 (f32, augment off) and the text log's lines == the JAX
``RunLogger``'s."""

import os

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
from distributed_model_parallel_tpu_torch.ops.collectives import tree_flatten
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import (
    pipeline_trainer as tpipeline_trainer,
)
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    unflatten_like,
)
from tests._torch_port_util import run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close
from tests.test_torch_pipeline_trainer import DATA, _check_history

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

STEPS = 3                                   # per epoch (96 rows, batch 32)
PREEMPT_AT = STEPS + 1                      # step 1 of epoch 1
TIME_KEYS = ("time_per_batch", "time_load_per_batch")
RUNS = {"gpipe": dict(),
        "1f1b_fused": dict(pipeline_schedule="1f1b", fused=True),
        "interleaved": dict(pipeline_schedule="1f1b", virtual_stages=2,
                            fused=True)}


def _config(tmp_path, name, *, fused=False, **kw):
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(**{**DATA, "augment": True}),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2,
                                          fused=fused),
        mesh=tconfig.MeshConfig(stage=2), device="cpu", epochs=2,
        num_microbatches=2, log_every_n_steps=2,
        **run_dirs(tmp_path, name), **kw)


def _preempt_at(step):
    def hook(t):
        if t.global_step == step:
            t.preemption.request()
    return hook


def _state(t) -> list:
    """Parameters, BN statistics and momentum (JAX layout), then the
    update count and the global step."""
    tree = t._ckpt_tree()
    leaves, _ = tree_flatten((tree["params"], tree["batch_stats"],
                              tree["momentum"]))
    return leaves + [int(tree["opt_count"]), t.global_step]


def _same_run(a, ha, b, hb):
    sa, sb = _state(a), _state(b)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)
    assert sb[-2:] == [2 * STEPS, 2 * STEPS]
    # The interrupted epoch's train averages cover the steps its trainer
    # ran, as in the JAX trainer; its eval is the whole run's.
    strip = lambda r: {k: v for k, v in r.items() if k not in TIME_KEYS}
    assert [r["epoch"] for r in hb] == [0, 1]
    assert strip(hb[0]) == strip(ha[0])
    assert (hb[1]["loss_val"], hb[1]["acc1_val"]) == (ha[1]["loss_val"],
                                                      ha[1]["acc1_val"])


def _preempted_and_resumed(cfg):
    b = tpipeline_trainer.PipelineTrainer(cfg)
    b.step_hook = _preempt_at(PREEMPT_AT)
    hb = b.fit()
    assert b.global_step == PREEMPT_AT and len(hb) == 1
    assert b.ckpt.exists("pipeline-preempt")
    r = tpipeline_trainer.PipelineTrainer(cfg.replace(resume=True))
    assert (r.global_step, r.start_epoch, r.train_loader.cursor) == (
        PREEMPT_AT, 1, PREEMPT_AT - STEPS)
    return r, hb + r.fit()


@pytest.mark.parametrize("run", list(RUNS))
def test_runner_preempted_and_resumed_equals_uninterrupted(tmp_path, run):
    a = tpipeline_trainer.PipelineTrainer(_config(tmp_path, "a",
                                                  **RUNS[run]))
    ha = a.fit()
    r, hb = _preempted_and_resumed(_config(tmp_path, "b", **RUNS[run]))
    _same_run(a, ha, r, hb)
    log = open(os.path.join(tmp_path, "b", "log", "b.txt")).read()
    assert (f"preempted: checkpoint saved at epoch 1, global step "
            f"{PREEMPT_AT}") in log
    assert (f"resume: slot 'pipeline-preempt' -> epoch 1 batch 1 (global "
            f"step {PREEMPT_AT})") in log
    assert sum(x.startswith("epoch:") for x in log.splitlines()) == 2


def test_restore_writes_in_place_and_keeps_the_bucket_views(tmp_path):
    """A resume copies into the chunks' existing tensors: every parameter
    and BN buffer keeps its storage, each FusedSGD's parameters, gradients
    and momentum stay its buckets' slots (16-byte aligned) and its view
    check passes; the tree has the data-parallel Trainer's keys, and the
    'pipeline' slot holds the best accuracy."""
    cfg = _config(tmp_path, "run", **RUNS["interleaved"])
    t = tpipeline_trainer.PipelineTrainer(cfg)
    t.fit()
    r = tpipeline_trainer.PipelineTrainer(cfg.replace(resume=True, epochs=3))
    ptrs = [p.data_ptr() for p in r.runner.model.parameters()]
    bufs = [b.data_ptr() for b in r.runner.model.buffers()]
    moms = [st.optimizer.momentum_buffer(i).data_ptr()
            for st in r.runner.stages for i in range(
                len(st.optimizer.params))]
    r._load_tree(t._ckpt_tree())
    assert ptrs == [p.data_ptr() for p in r.runner.model.parameters()]
    assert bufs == [b.data_ptr() for b in r.runner.model.buffers()]
    assert moms == [st.optimizer.momentum_buffer(i).data_ptr()
                    for st in r.runner.stages for i in range(
                        len(st.optimizer.params))]
    for st in r.runner.stages:
        st.optimizer._check_views()
        assert all(p.data_ptr() % 16 == 0 for p in st.optimizer.params)
    for x, y in zip(_state(t)[:-1], _state(r)[:-1]):
        np.testing.assert_array_equal(x, y)
    assert set(r._ckpt_tree()) == {"params", "batch_stats", "momentum",
                                   "opt_count", "best_acc", "epoch",
                                   "resume"}
    best = r.ckpt.restore(r._ckpt_tree(), "pipeline")
    assert float(best["best_acc"]) == np.float32(t.best_acc) > 0
    r.fit()
    assert r.global_step == 3 * STEPS


def test_tree_keys_match_the_trainer_and_counts_must_agree(tmp_path):
    """The runner's checkpoint tree has the data-parallel Trainer's keys
    and per-unit layout; chunks whose update counts differ refuse to
    checkpoint."""
    t = tpipeline_trainer.PipelineTrainer(_config(tmp_path, "run"))
    d = ttrainer.Trainer(_config(tmp_path, "dp").replace(
        strategy="gspmd", mesh=tconfig.MeshConfig()))
    pt, dt = t._ckpt_tree(), d._ckpt_tree()
    assert set(pt) == set(dt)
    flat_p = {k: np.shape(v) for k, v in
              zip(*_flat_keys(pt))}
    flat_d = {k: np.shape(v) for k, v in zip(*_flat_keys(dt))}
    assert flat_p == flat_d
    t.runner.stages[1].optimizer.count += 1
    with pytest.raises(RuntimeError, match="disagree on the update count"):
        t._ckpt_tree()


def _flat_keys(tree):
    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        flatten_tree,
    )

    flat = flatten_tree(tree)
    return list(flat), list(flat.values())


@pytest.fixture(scope="module")
def jax_resumed(tmp_path_factory):
    """The JAX PipelineTrainer over 2 stages, M=2, augment off, preempted
    by a step_hook at PREEMPT_AT and resumed: its initial weights, its
    history and its text log."""
    root = tmp_path_factory.mktemp("jax")
    cfg = tiny_train_config(
        root, data=jconfig.DataConfig(**DATA),
        mesh=jconfig.MeshConfig(stage=2), epochs=2, num_microbatches=2,
        log_every_n_steps=2, log_name="jax")
    t = jpipeline_trainer.PipelineTrainer(cfg)
    params = t.runner.merged_params()
    state = t.runner.merged_model_state()

    def hook(tr):
        if tr._global_step == PREEMPT_AT:
            tr.preemption.request()

    t.step_hook = hook
    history = t.fit()
    r = jpipeline_trainer.PipelineTrainer(cfg.replace(resume=True))
    history += r.fit()
    log = open(os.path.join(cfg.log_dir, "jax.txt")).read()
    return dict(params=params, state=state, history=history, log=log)


def test_resumed_history_and_log_match_jax(jax_resumed, tmp_path):
    """From the JAX trainer's initial weights, the port's preempted and
    resumed run: the same history within 1e-4 (f32), and its text log
    line for line the JAX RunLogger's — the preemption and resume lines
    character for character, each epoch line with the same keys in the
    same order and its values within 1e-4."""
    cfg = _config(tmp_path, "port").replace(
        data=tconfig.DataConfig(**DATA))
    t = tpipeline_trainer.PipelineTrainer(cfg, params=jax_resumed["params"],
                                          state=jax_resumed["state"])
    t.step_hook = _preempt_at(PREEMPT_AT)
    history = t.fit()
    r = tpipeline_trainer.PipelineTrainer(cfg.replace(resume=True))
    history += r.fit()
    _check_history(history, jax_resumed["history"])
    got = open(os.path.join(tmp_path, "port", "log", "port.txt")).read()
    want = jax_resumed["log"]
    assert len(got.splitlines()) == len(want.splitlines())
    for g, w in zip(got.splitlines(), want.splitlines()):
        if not w.startswith("epoch:"):
            assert g == w
            continue
        gk, wk = [[tok.split(":", 1) for tok in x.split()] for x in (g, w)]
        assert [k for k, _ in gk] == [k for k, _ in wk]
        for (k, gv), (_, wv) in zip(gk, wk):
            if k not in TIME_KEYS and gv != "None":
                _close(float(gv), float(wv), k)


# -- the SPMD engine at 2 ranks ---------------------------------------------------

SPMD = {"gpipe": dict(),
        "1f1b_async": dict(pipeline_schedule="1f1b", async_checkpoint=True,
                           fused=True),
        "interleaved": dict(pipeline_schedule="1f1b", virtual_stages=2,
                            fused=True)}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd")
    configs = {name: _config(root, name, **kw).replace(
        strategy="spmd_pipeline") for name, kw in SPMD.items()}
    train, evals = load_dataset(configs["gpipe"].data)
    ranks = tmesh.spawn(
        workers.preempt_resume, 2, configs, (train.images, train.labels),
        (evals.images, evals.labels), PREEMPT_AT, device="cpu",
        timeout_s=300, threads=1, store_dir=str(root),
        config=tconfig.MeshConfig(stage=2))
    return dict(root=root, configs=configs, ranks=ranks)


@pytest.mark.parametrize("name", list(SPMD))
def test_spmd_preempted_and_resumed_equals_uninterrupted(rank_runs, name):
    """Each rank's resumed run == its uninterrupted one bit for bit (its
    units' parameters, momentum and BN statistics, the update count, the
    global step, the history), and the two ranks' histories agree."""
    ranks = rank_runs["ranks"]
    for r in ranks:
        a, b = r[name]["a"], r[name]["b"]
        for x, y in zip(tree_flatten((a["params"], a["momentum"],
                                      a["state"]))[0],
                        tree_flatten((b["params"], b["momentum"],
                                      b["state"]))[0], strict=True):
            np.testing.assert_array_equal(x, y)
        assert (a["count"], a["step"]) == (b["count"], b["step"]) == (
            2 * STEPS, 2 * STEPS)
        assert [h["acc1_val"] for h in a["history"]] == [
            h["acc1_val"] for h in b["history"]]
        assert a["units"] == b["units"]
    assert (ranks[0][name]["b"]["history"][1]["loss_val"]
            == ranks[1][name]["b"]["history"][1]["loss_val"])
    assert sorted(ranks[0][name]["a"]["units"]
                  + ranks[1][name]["a"]["units"]) == list(range(6))


@pytest.mark.parametrize("name", list(SPMD))
def test_spmd_checkpoint_holds_every_stage(rank_runs, name):
    """The preemption checkpoint rank 0 wrote holds the whole model in
    the JAX layout (every stage's leaves and momentum, gathered over the
    stage ring) with the Trainer's keys, at the preempted step."""
    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        Checkpointer,
        _read_payload,
    )

    cfg = rank_runs["configs"][name]
    ck = Checkpointer(os.path.join(cfg.checkpoint_dir, "b"))
    flat = _read_payload(ck._latest_path("preempt"))
    assert int(flat["resume/global_step"]) == PREEMPT_AT
    assert int(flat["opt_count"]) == PREEMPT_AT
    units = {int(k.split("/")[1]) for k in flat if k.startswith("params/")}
    assert units == set(range(6))
    tmpl = ttrainer.Trainer(cfg.replace(
        strategy="gspmd", mesh=tconfig.MeshConfig(),
        checkpoint_dir=str(rank_runs["root"] / "tmpl")))._ckpt_tree()
    unflatten_like(tmpl, flat)          # every key and shape of the model


def test_spmd_resume_at_two_data_rows(tmp_path):
    """A (data 2, stage 2) mesh of 4 gloo ranks: data row 0's stage ring
    gathers and rank 0 writes, row 1 sends nothing; every rank restores
    its stage; each rank's resumed run == its uninterrupted one bit for
    bit, and the two rows hold the same stage bit for bit."""
    cfg = _config(tmp_path, "dp2", fused=True).replace(
        strategy="spmd_pipeline", mesh=tconfig.MeshConfig(data=2, stage=2))
    train, evals = load_dataset(cfg.data)
    ranks = tmesh.spawn(
        workers.preempt_resume, 4, {"run": cfg},
        (train.images, train.labels), (evals.images, evals.labels),
        PREEMPT_AT, device="cpu", timeout_s=300, threads=1,
        store_dir=str(tmp_path), config=tconfig.MeshConfig(data=2, stage=2))
    leaves = [[tree_flatten((r["run"][k]["params"], r["run"][k]["momentum"],
                             r["run"][k]["state"]))[0] for k in "ab"]
              for r in ranks]
    for (a, b), r in zip(leaves, ranks):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
        assert r["run"]["b"]["step"] == 2 * STEPS
    for s in range(2):                       # rank d·S + s, data rows 0, 1
        for x, y in zip(leaves[s][1], leaves[2 + s][1], strict=True):
            np.testing.assert_array_equal(x, y)
