"""Checkpoint/resume of the port's LM trainer: a fit preempted by a
``step_hook`` at step 3 of epoch 0 and finished by ``LMTrainer(resume=
True)`` equals the uninterrupted fit bit for bit — per-step losses,
parameters, optimizer state, the global step and the history (less its
times, and the interrupted epoch's train average, which covers only the
steps its trainer ran, as in the JAX trainer) — on one device and at 4
ranks (``(model 2, seq 2)`` ring under ``remat="dots"``, adamw). At
``(data 2, model 2)`` the uninterrupted history is held against the JAX
``LMTrainer``'s fit from the same weights (1e-4), and the text log's
lines against the JAX ``RunLogger``'s (the same lines, numbers within
1e-4, times aside). A resume under another split, and everything A9 and
A11 leave for later, raise by name; so do the schedules and MoE configs
the JAX trainer refuses, in its words."""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest

from _torch_port_util import SHAPES, numpy_params, run_dirs
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.train import lm_trainer as jlm
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm

pytestmark = pytest.mark.torch_port

ATOL = 1e-4
PREEMPT_AT = (0, 3)
COMMON = dict(batch_size=4, seq_len=16, steps_per_epoch=4, epochs=2,
              n_tokens=2000, eval_batches=2)
ADAMW = dict(name="adamw", learning_rate=0.01, weight_decay=1e-2)


def _configs(root, tcfg, mesh, opt=None, **kw):
    opt = tconfig.OptimizerConfig(**(opt or dict(learning_rate=0.1,
                                                 weight_decay=0.0)))
    make = lambda name: tlm.LMTrainConfig(
        model=tcfg, mesh=mesh, optimizer=opt, device="cpu",
        **run_dirs(root, name), **COMMON, **kw)
    return {"full": make("full"), "cut": make("cut")}


def _jax_trainer(root, name, **kw):
    jcfg = jtfm.TransformerConfig(**SHAPES["mha"], tp_axis="model")
    return jlm.LMTrainer(jlm.LMTrainConfig(
        model=jcfg, mesh=jconfig.MeshConfig(data=2, model=2),
        **run_dirs(root, name), **COMMON, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank cases in one spawn, and the JAX trainer's runs."""
    root = str(tmp_path_factory.mktemp("runs"))
    jt = _jax_trainer(root, "jax_full")
    tree = jax.tree.map(np.asarray, jt.params)          # before the fit
    ring = ttfm.TransformerConfig(**SHAPES["mha"], tp_axis="model",
                                  sp_axis="seq", remat=True,
                                  remat_policy="dots")
    ring_mesh = tconfig.MeshConfig(model=2, seq=2)
    ring_cfgs = _configs(os.path.join(root, "ring"), ring, ring_mesh,
                         opt=ADAMW)
    ring_cfgs["other_model"] = dataclasses.replace(ring, sp_axis=None)
    tp = ttfm.TransformerConfig(**SHAPES["mha"], tp_axis="model")
    tp_mesh = tconfig.MeshConfig(data=2, model=2)
    tp_cfgs = _configs(os.path.join(root, "tp"), tp, tp_mesh)
    cases = [(ring_mesh, "lm_preempt_resume",
              (ring_cfgs, numpy_params(ring), PREEMPT_AT,
               tconfig.MeshConfig(data=2, model=2))),
             (tp_mesh, "lm_preempt_resume", (tp_cfgs, tree, PREEMPT_AT)),
             (ring_mesh, "lm_barrier_wait", (ring_cfgs["full"], 1.0))]
    out = tmesh.spawn(workers.on_meshes, 4, cases, device="cpu", threads=1,
                      timeout_s=300,
                      store_dir=str(tmp_path_factory.mktemp("store")))
    jhist = jt.fit()
    cut = _jax_trainer(root, "jax_cut")

    def hook(t):
        if (t._pos_epoch, t._pos_step) == PREEMPT_AT:
            t.preemption.request()

    cut.step_hook = hook
    cut.fit()
    resumed = _jax_trainer(root, "jax_cut", resume=True)
    resumed.fit()
    with open(resumed.logger.txt_path) as f:
        jlog = f.read().splitlines()
    return dict(ring=[r[0] for r in out], tp=[r[1] for r in out],
                barrier=[r[2] for r in out], jax_history=jhist, jax_log=jlog)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_resume_bitwise(full, cut):
    assert cut["steps"] == full["steps"]
    assert cut["global_step"] == full["global_step"]
    for a, b in ((full["params"], cut["params"]),
                 (full["opt_state"], cut["opt_state"])):
        got = dict(_leaves(b))
        assert set(got) == set(dict(_leaves(a)))
        for key, leaf in _leaves(a):
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)
    fh, ch = full["history"], cut["history"]
    assert [h["epoch"] for h in ch] == [h["epoch"] for h in fh] == [0, 1]
    assert [h["loss_val"] for h in ch] == [h["loss_val"] for h in fh]
    assert ch[1]["loss_train"] == fh[1]["loss_train"]


def test_resume_is_bitwise_on_one_device(tmp_path):
    tcfg = ttfm.TransformerConfig(**SHAPES["mha"], remat=True,
                                  remat_policy="dots", loss_chunk=8)
    cfgs = _configs(tmp_path, tcfg, tconfig.MeshConfig(), opt=ADAMW)
    out = {}
    for name in ("full", "cut"):
        tr = tlm.LMTrainer(cfgs[name], params=ttfm.params_from_jax(
            numpy_params(tcfg), tcfg, "cpu"))
        if name == "cut":
            tr.step_hook = lambda t: (t.preemption.request()
                                      if (t._pos_epoch, t._pos_step)
                                      == PREEMPT_AT else None)
            first = tr.fit()
            assert first == [] and tr.ckpt.exists("lm-preempt")
            steps = [r["loss"] for r in tr.step_log]
            tr = tlm.LMTrainer(dataclasses.replace(cfgs[name], resume=True))
            assert (tr._pos_epoch, tr._pos_step) == PREEMPT_AT
            history = tr.fit()
            steps += [r["loss"] for r in tr.step_log]
        else:
            history = tr.fit()
            steps = [r["loss"] for r in tr.step_log]
        out[name] = dict(history=history, steps=steps,
                         params=workers._np(tr.whole_params()),
                         opt_state=tr.opt_state_tree(),
                         global_step=tr.global_step)
    _assert_resume_bitwise(out["full"], out["cut"])


@pytest.mark.parametrize("case", ["ring", "tp"])
def test_resume_is_bitwise_at_four_ranks(runs, case):
    for rank in runs[case]:
        assert rank["preempted_after"] == 0
        _assert_resume_bitwise(rank["full"], rank["cut"])


def test_barrier_holds_every_rank_of_the_mesh(runs):
    """On a (model 2, seq 2) mesh, whose data axis is one rank, the
    trainer's barrier still holds every rank until the last arrives (rank
    0, the writer, 1 s late)."""
    assert all(w >= 0.5 for w in runs["barrier"][1:]), runs["barrier"]


def test_history_matches_jax_trainer(runs):
    port = runs["tp"][0]["full"]["history"]
    jax_h = runs["jax_history"]
    assert [h["epoch"] for h in port] == [h["epoch"] for h in jax_h]
    for a, b in zip(port, jax_h):
        np.testing.assert_allclose([a["loss_train"], a["loss_val"]],
                                   [b["loss_train"], b["loss_val"]],
                                   atol=ATOL, rtol=0)


_NUM = re.compile(r"(\w+):([-0-9.e+]+|None)")


def test_text_log_lines_match_jax(runs):
    """The preempted-and-resumed run's text log, line for line: the
    preemption and resume lines equal; each epoch line has the JAX line's
    keys in its order and its losses within 1e-4."""
    port_log = runs["tp"][0]["cut"]["log"]
    jax_log = runs["jax_log"]
    assert len(port_log) == len(jax_log)
    for a, b in zip(port_log, jax_log):
        if not a.startswith("epoch:"):
            assert a == b
            continue
        pa, pb = dict(_NUM.findall(a)), dict(_NUM.findall(b))
        assert list(pa) == list(pb)
        for key in ("epoch", "loss_train", "loss_val"):
            np.testing.assert_allclose(float(pa[key]), float(pb[key]),
                                       atol=ATOL, rtol=0, err_msg=key)


def test_resume_under_another_split_raises(runs):
    for rank in runs["ring"]:
        assert "ROADMAP A11: resharded restore" in rank["other_mesh"]


@pytest.mark.parametrize("kw,match", [
    # The pipeline and MoE run now; what they refuse raises in JAX's words.
    (dict(mesh=tconfig.MeshConfig(stage=3)), "does not split over 3"),
    (dict(num_microbatches=3), "local batch 8 not divisible by M=3"),
    (dict(pipeline_schedule="zb"), "unknown spmd pipeline schedule"),
    (dict(virtual_stages=2), "1f1b schedule feature"),
    (dict(model=ttfm.TransformerConfig(**SHAPES["mha"], moe_experts=4,
                                       moe_top_k=5)),
     r"top_k=5 must be in \[1, num_experts=4\]"),
    (dict(mesh=tconfig.MeshConfig(data=2, model=2, dcn_data=2)),
     "A9: dcn_data with the model, seq and expert axes"),
    (dict(mesh=tconfig.MeshConfig(data=2, expert=2, dcn_data=2)),
     "A9: dcn_data with the model, seq and expert axes"),
    (dict(strategy="auto"), "A11: autotune"),
    (dict(emergency_every=2), "A11: emergency checkpoints"),
    (dict(elastic=True), "A11: elastic restarts"),
    (dict(check_finite_every=1), "A11: guards"),
    (dict(stall_budget_s=1.0), "A11: guards"),
    (dict(consistency_every=1), "A11: consistency sentinel"),
    (dict(recovery=tconfig.RecoveryConfig(max_retries=1)), "A11: recovery"),
    (dict(recovery=tconfig.RecoveryConfig(faults=("nan_loss@1",))),
     "A11: fault injection"),
    (dict(statusz_port=0), "A11: status exporter"),
])
def test_unported_options_raise_by_name(tmp_path, kw, match):
    config = tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPES["mha"]), device="cpu",
        n_tokens=500, eval_batches=0, **run_dirs(tmp_path))
    with pytest.raises((ValueError, NotImplementedError), match=match):
        tlm.LMTrainer(dataclasses.replace(config, **kw))


def test_plane_slots_refused_on_resume(tmp_path):
    """A newest checkpoint in the emergency slot (written by the JAX
    package's plane, which the port does not run) is refused by name."""
    config = tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPES["mha"]), device="cpu",
        n_tokens=500, eval_batches=0, steps_per_epoch=1,
        **run_dirs(tmp_path))
    tr = tlm.LMTrainer(config)
    tr.fit()
    tr.ckpt.save(tr._ckpt_tree(), "lm-emergency")
    with pytest.raises(ValueError, match="ROADMAP A11: emergency"):
        tlm.LMTrainer(dataclasses.replace(config, resume=True))


def test_fused_refused_in_jax_words(tmp_path):
    config = tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**SHAPES["mha"]), device="cpu",
        optimizer=tconfig.OptimizerConfig(fused=True), **run_dirs(tmp_path))
    with pytest.raises(ValueError, match="OptimizerConfig.fused runs the "
                                         "update over flat"):
        tlm.LMTrainer(config)
