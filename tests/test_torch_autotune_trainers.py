"""``strategy="auto"`` in the port's three trainers, their status
provider, the elastic re-plan and the plan CLI's measured validation,
held against the JAX package where it decides the same thing: each
trainer runs end to end on the CPU with one ``plan`` record whose
decision equals the JAX planner's on the same workload, coefficients and
HBM (``tests/test_autotune.py``'s test_strategy_auto_* cases); an
explicit mesh is refused in JAX's words; ``GET /statusz`` during an LM
fit serves the trainer's provider with the planned layout and
``/healthz`` 200; an auto+elastic LM run at world 2 (two gloo ranks)
preempted and restarted at world 1 re-plans with reason
``"elastic-replan"`` at the exact global step (test_elastic_replan_on_
shrunk_mesh); and ``--measure 2 --measure-steps 1`` times each candidate
with the plan CLI's rank function at two gloo ranks. The world-2 work
shares one spawn."""

import contextlib
import dataclasses
import io
import json
import math
import urllib.request

import pytest
import torch

from _torch_port_util import run_dirs
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.autotune import cost_model as jcost
from distributed_model_parallel_tpu.autotune import memory as jmemory
from distributed_model_parallel_tpu.autotune import planner as jplanner
from distributed_model_parallel_tpu.autotune import search as jsearch
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.train import lm_trainer as jlm
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.autotune import cost_model as tcost
from distributed_model_parallel_tpu_torch.autotune import search as tsearch
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm
from distributed_model_parallel_tpu_torch.train import (
    pipeline_trainer as tpipe,
)
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from distributed_model_parallel_tpu_torch.utils import statusz

pytestmark = [pytest.mark.torch_port, pytest.mark.autotune]
torch.set_num_threads(1)

COEFFS = dict(alpha_s=2e-6, wire_bytes_per_s=1e11, peak_flops_per_s=5e14,
              overlap_fraction=0.5)
DATA = dict(batch_size=16, synthetic_train_size=48, synthetic_eval_size=16,
            augment=False, prefetch=0, device_prefetch=0)
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=32, pos_embedding="rope")


@pytest.fixture
def same_coeffs(monkeypatch):
    """Both packages plan with COEFFS and no HBM filter."""
    monkeypatch.setattr(jcost, "default_coefficients",
                        lambda *a, **k: jcost.CostCoefficients(**COEFFS))
    monkeypatch.setattr(jmemory, "device_hbm_bytes", lambda *a, **k: None)
    monkeypatch.setattr(tcost, "default_coefficients",
                        lambda *a, **k: tcost.CostCoefficients(**COEFFS))


def plan_records(logger_or_path):
    path = getattr(logger_or_path, "jsonl_path", logger_or_path)
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "plan"]


def cnn_configs(tmp_path, **kw):
    """(JAX, port) TrainConfig of tinycnn under auto, one epoch."""
    common = dict(strategy="auto", epochs=1, log_every_n_steps=2, **kw)
    return (jconfig.TrainConfig(model=jconfig.ModelConfig(name="tinycnn"),
                                data=jconfig.DataConfig(**DATA), **common),
            tconfig.TrainConfig(model=tconfig.ModelConfig(name="tinycnn"),
                                data=tconfig.DataConfig(**DATA),
                                device="cpu", **common, **run_dirs(tmp_path)))


def test_cnn_and_pipeline_trainers_run_auto_as_jax_plans(tmp_path,
                                                         monkeypatch,
                                                         same_coeffs):
    """Trainer(strategy="auto") and PipelineTrainer(strategy="auto") on
    the CPU: the decision equals the JAX planner's on the port's probe
    of the same model (plan_for_cnn at world 1, plan_for_stage_pipeline
    at the device list's 2 stages), one ``plan`` record stamped at step
    0 with reason "startup", the planned config runs an epoch; an
    explicit mesh with auto is refused in JAX's words."""
    jcfg, tcfg = cnn_configs(tmp_path)
    probe = tsearch.cnn_workload(tcfg.model, tcfg.data)
    monkeypatch.setattr(jsearch, "cnn_workload", lambda *a, **k:
                        jsearch.WorkloadSpec(**dataclasses.asdict(probe)))
    t = ttrainer.Trainer(tcfg)
    jnew, jd = jplanner.plan_for_cnn(jcfg, 1)
    assert t.plan_decision.telemetry_payload() == jd.telemetry_payload()
    assert (t.config.strategy, t.config.mesh.data) == (jnew.strategy, 1)
    history = t.fit()
    assert len(history) == 1 and math.isfinite(history[0]["loss_train"])
    (rec,) = plan_records(t.logger)
    assert (rec["reason"], rec["global_step"]) == ("startup", 0)
    assert rec["strategy"] == jnew.strategy
    with pytest.raises(ValueError, match="cannot honor an explicit "
                                         "MeshSpec"):
        ttrainer.Trainer(tcfg, spec=t.spec)

    pcfg = tcfg.replace(**run_dirs(tmp_path, "pipe"))
    p = tpipe.PipelineTrainer(pcfg, devices=["cpu", "cpu"])
    jnew, jd = jplanner.plan_for_stage_pipeline(jcfg, 2)
    assert p.plan_decision.telemetry_payload() == jd.telemetry_payload()
    assert (p.config.mesh.stage, p.config.num_microbatches,
            p.config.auto_partition) == (2, jnew.num_microbatches, True)
    assert math.isfinite(p.fit()[0]["loss_train"])
    (rec,) = plan_records(p.logger)
    assert rec["reason"] == "startup" and rec["strategy"] == "pipeline"


def test_lm_trainer_auto_serves_its_status(tmp_path, same_coeffs):
    """LMTrainer(strategy="auto", statusz_port=0): JAX's plan_for_lm
    decision and rewritten mesh, one plan record; during the fit /statusz
    serves the trainer's provider — its plan the decision's payload, its
    global step the live one — and /healthz answers 200."""
    common = dict(strategy="auto", batch_size=4, seq_len=16,
                  steps_per_epoch=3, eval_batches=0)
    tcfg = tlm.LMTrainConfig(model=ttfm.TransformerConfig(**LM),
                             n_tokens=600, device="cpu", statusz_port=0,
                             **common, **run_dirs(tmp_path))
    seen = []
    try:
        t = tlm.LMTrainer(tcfg)
        url = statusz.active().url

        def hook(tr):
            with urllib.request.urlopen(url + "/statusz", timeout=5) as r:
                doc = json.loads(r.read())
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                seen.append((doc["providers"][tcfg.log_name], r.status,
                             tr.global_step))

        t.step_hook = hook
        t.fit()
    finally:
        statusz.shutdown()
    jnew, jd = jplanner.plan_for_lm(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**LM), **common), 1)
    assert t.plan_decision.telemetry_payload() == jd.telemetry_payload()
    assert dataclasses.astuple(t.config.mesh)[:6] == \
        dataclasses.astuple(jnew.mesh)[:6]
    assert len(seen) == 3
    for step, (provider, code, global_step) in enumerate(seen):
        assert code == 200 and provider["healthy"] is True
        assert provider["plan"] == t.plan_decision.chosen.plan.payload()
        assert provider["global_step"] == global_step == step
        assert (provider["workload"], provider["run"]) == ("lm",
                                                           tcfg.log_name)
    (rec,) = plan_records(t.logger)
    assert rec["reason"] == "startup"
    with pytest.raises(ValueError, match="cannot honor an explicit "
                                         "MeshSpec"):
        tlm.LMTrainer(dataclasses.replace(tcfg, statusz_port=None),
                      spec=t.spec)


CLI_ARGS = ["--workload", "lm", "--devices", "2", "--batch", "4", "--seq",
            "16", "--d-model", "32", "--heads", "2", "--layers", "2",
            "--vocab", "64", "--d-ff", "64", "--device", "cpu"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of two gloo ranks for the module's world-2 work (every
    spawn pays each rank's process start): the auto + elastic LM run
    preempted at global step 3, then the plan CLI's rank function
    (``measure_rank``, one timed step) on each of the CLI's analytic top
    2 candidates at ``CLI_ARGS``, each on its own mesh of the two ranks.
    Returns the elastic run's config, its ranks' records, and per
    candidate (the plan, the model config, every rank's seconds)."""
    from distributed_model_parallel_tpu_torch.autotune import (
        cost_model,
        dmp_plan,
        memory,
        mesh_from_plan,
        planner,
    )

    root = tmp_path_factory.mktemp("world2")
    config = tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**LM), strategy="auto", batch_size=4,
        seq_len=16, steps_per_epoch=4, epochs=2, n_tokens=600,
        eval_batches=0, elastic=True, resume=True, device="cpu",
        **run_dirs(root))
    args = dmp_plan.parse_args(CLI_ARGS)
    workload, model_cfg = dmp_plan._build_workload(args)
    top = [r.plan for r in planner.plan_parallelism(
        workload, 2, coeffs=cost_model.default_coefficients("cpu"),
        hbm_bytes=memory.device_hbm_bytes(device="cpu")).ranked[:2]]
    cases = [(mesh_from_plan(p), "measure_rank",
              (model_cfg, p, args.batch, args.seq, 1, str(root)))
             for p in top]
    ranks = tmesh.spawn(workers.several, 2, [
        ("lm_auto_preempt", (config, 3)), ("on_meshes", (cases,))],
        device="cpu", timeout_s=300, threads=1, store_dir=str(root))
    return dict(config=config, ranks=[r[0] for r in ranks],
                measured=[(p, model_cfg, [r[1][i] for r in ranks])
                          for i, p in enumerate(top)])


def test_lm_auto_elastic_replan_at_the_exact_step(world2):
    """Mirrors test_elastic_replan_on_shrunk_mesh: an auto + elastic LM
    run planned at world 2 (two gloo ranks) is preempted at global step
    3; restarted at world 1 it re-plans (reason "elastic-replan", one
    device) and resumes at step 3, where its plan record is stamped."""
    config, ranks = world2["config"], world2["ranks"]
    assert ranks[0]["plan"] == ranks[1]["plan"]
    assert ranks[0]["plan"]["n_devices"] == 2
    assert [r["global_step"] for r in ranks] == [3, 3]
    t = tlm.LMTrainer(config)
    assert t.plan_decision.reason == "elastic-replan"
    assert t.plan_decision.n_devices == 1 and t.global_step == 3
    assert t.config.mesh.num_devices == 1
    recs = plan_records(t.logger)
    assert [(r["reason"], r["global_step"], r["n_devices"])
            for r in recs] == [("startup", 0, 2), ("elastic-replan", 3, 1)]
    t.fit()
    assert t.global_step == 8


def test_plan_cli_measures_candidates_on_gloo_ranks(world2, monkeypatch):
    """``--measure 2 --measure-steps 1`` at 2 ranks on the CPU: the CLI
    asks for a fresh spawn of two gloo ranks running ``measure_rank`` on
    each of its analytic top 2, on the plan's mesh, and chooses the
    measured-best. The spawns are answered with what ``world2``'s two
    gloo ranks measured for the same candidates (the CLI's call is
    checked argument for argument), so the module starts one spawn."""
    from distributed_model_parallel_tpu_torch.autotune import (
        dmp_plan,
        mesh_from_plan,
    )

    asked = []

    def replay(fn, nproc, *args, **kw):
        (plan, model_cfg, seconds), = [
            m for m in world2["measured"] if m[0] == args[1]]
        assert fn is dmp_plan.measure_rank and nproc == 2
        assert args[0] == model_cfg and args[2:5] == (4, 16, 1)
        assert (kw["device"], kw["backend"], kw["config"]) == (
            "cpu", "gloo", mesh_from_plan(plan))
        asked.append(plan)
        return seconds

    monkeypatch.setattr(tmesh, "spawn", replay)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dmp_plan.main(CLI_ARGS + ["--measure", "2", "--measure-steps", "1"])
    out = json.loads(buf.getvalue())
    assert asked == [m[0] for m in world2["measured"]]
    rows = out["measured"]
    assert len(rows) == 2 and all(r["measured_s"] > 0 for r in rows)
    assert [r["measured_s"] for r in rows] == [max(m[2])
                                               for m in world2["measured"]]
    best = min(rows, key=lambda r: (r["measured_s"], r["predicted_s"]))
    assert (out["axes"], out["num_microbatches"]) == (
        best["axes"], best["num_microbatches"])
