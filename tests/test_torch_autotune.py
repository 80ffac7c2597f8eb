"""The port's autotuner core (``distributed_model_parallel_tpu_torch/
autotune/``) held against the JAX package's (``tests/test_autotune.py``
is the list it mirrors): plan lists equal in order for LM and CNN
workloads over 1-16 devices (primes, MoE, a window, tp x sp head
interplay), ranked lists and rejection reasons equal, ``plan_cost`` and
``estimate_plan_memory`` within 1e-12 relative, ``InfeasiblePlanError``
where JAX raises it, measurement failures giving JAX's decisions, the
LM probe field for field (the CNN probe is held against JAX's live one
in test_torch_auto_partition.py), the trainers' rewritten configs, the
plan CLI's ``--dry-run`` JSON and rc 2, and the port's default
coefficients, which are the card's and none of the JAX package's TPU
figures. Both packages get the same explicit ``CostCoefficients`` and
``hbm_bytes``, so no case depends on either package's defaults. Pure
Python; no probe compiles anything in JAX."""

import contextlib
import dataclasses
import io
import json
import math

import jax.numpy as jnp
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.autotune import cost_model as jcost
from distributed_model_parallel_tpu.autotune import memory as jmemory
from distributed_model_parallel_tpu.autotune import planner as jplanner
from distributed_model_parallel_tpu.autotune import search as jsearch
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.autotune import cost_model as tcost
from distributed_model_parallel_tpu_torch.autotune import memory as tmemory
from distributed_model_parallel_tpu_torch.autotune import planner as tplanner
from distributed_model_parallel_tpu_torch.autotune import search as tsearch
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.utils import profiling

pytestmark = [pytest.mark.torch_port, pytest.mark.autotune]

# One set of coefficients for both packages (neither's defaults).
COEFFS = dict(alpha_s=2e-6, wire_bytes_per_s=1e11, peak_flops_per_s=5e14,
              overlap_fraction=0.5)
RTOL = 1e-12

LM_BASE = dict(vocab_size=512, d_model=64, n_heads=8, n_layers=8, d_ff=256,
               max_seq_len=128, pos_embedding="rope")
# name -> (model overrides, batch, seq): dense, MoE (the expert axis), a
# window (sp pinned at 1), 12 heads (tp x sp local-head interplay), 3
# heads (tp/sp closed), 6 layers (pp in {1, 2, 3, 6}), a small batch.
LM_CASES = {
    "dense": (dict(), 16, 128),
    "moe": (dict(moe_experts=4, moe_top_k=2), 16, 128),
    "window": (dict(attn_window=32), 16, 128),
    "heads12": (dict(n_heads=12, d_model=96, d_ff=384), 16, 96),
    "heads3": (dict(n_heads=3, d_model=48, d_ff=384), 8, 64),
    "layers6": (dict(n_layers=6), 4, 128),
}
# name -> hand-built CNN workload fields (both packages' WorkloadSpec).
CNN_CASES = {
    "mobilenet_like": dict(kind="cnn", batch_size=512,
                           flops_per_step=3.0e11, param_count=2_296_922,
                           param_bytes=9_187_688, n_units=19,
                           boundary_act_bytes_per_sample=131072),
    "big": dict(kind="cnn", batch_size=512, flops_per_step=1e12,
                param_count=2_000_000_000, param_bytes=8_000_000_000,
                n_units=8, boundary_act_bytes_per_sample=4096),
    "odd_batch": dict(kind="cnn", batch_size=96, flops_per_step=2e10,
                      param_count=10_000, param_bytes=40_000, n_units=6,
                      boundary_act_bytes_per_sample=65536),
}
STRATEGIES = (None, ("ddp",), ("gspmd", "fsdp"), ("gspmd", "ddp", "fsdp",
                                                   "spmd_pipeline"))
DEVICES = range(1, 17)


def lm_pair(name, dtype="float32"):
    """(JAX WorkloadSpec, port WorkloadSpec) of an LM case, each probed
    by its own package."""
    kw, batch, seq = LM_CASES[name]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return (jsearch.lm_workload(
                jtfm.TransformerConfig(**{**LM_BASE, **kw}, dtype=jdt),
                batch, seq),
            tsearch.lm_workload(
                ttfm.TransformerConfig(**{**LM_BASE, **kw}, dtype=tdt),
                batch, seq))


def cnn_pair(name):
    return (jsearch.WorkloadSpec(**CNN_CASES[name]),
            tsearch.WorkloadSpec(**CNN_CASES[name]))


def coeff_pair():
    return jcost.CostCoefficients(**COEFFS), tcost.CostCoefficients(**COEFFS)


def plans(ps):
    return [dataclasses.astuple(p) for p in ps]


def close(a, b, what):
    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (what, a, b)


def decide(pkg, w, n, **kw):
    """``(payload of the decision, None)`` or ``(None, error text)``."""
    try:
        return pkg.plan_parallelism(w, n, **kw), None
    except pkg.InfeasiblePlanError as e:
        return None, str(e)


# ---------------------------------------------------------------- probes

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_workload_matches_jax_field_for_field(dtype):
    """Mirrors test_enumeration_deterministic_and_counts' probe: the
    parameter counts from the port's tree layout equal JAX's eval_shape
    walk (and the rest of the spec), MoE and GQA included."""
    for name in LM_CASES:
        jw, tw = lm_pair(name, dtype)
        assert dataclasses.asdict(tw) == dataclasses.asdict(jw), name
    gqa = dict(LM_BASE, n_kv_heads=2)
    assert dataclasses.asdict(tsearch.lm_workload(
        ttfm.TransformerConfig(**gqa), 8, 64)) == dataclasses.asdict(
        jsearch.lm_workload(jtfm.TransformerConfig(**gqa), 8, 64))


# ----------------------------------------------------------- enumeration

def test_enumeration_matches_jax_in_order():
    """Every LM and CNN case over 1-16 devices (primes included), every
    strategy subset: the same plans in the same order (sorted tuples)."""
    for name in LM_CASES:
        jw, tw = lm_pair(name)
        for n in DEVICES:
            assert plans(tsearch.enumerate_plans(tw, n)) == plans(
                jsearch.enumerate_plans(jw, n)), (name, n)
    for name in CNN_CASES:
        jw, tw = cnn_pair(name)
        for s in STRATEGIES:
            for n in DEVICES:
                assert plans(tsearch.enumerate_plans(
                    tw, n, strategies=s)) == plans(jsearch.enumerate_plans(
                        jw, n, strategies=s)), (name, s, n)
        for n in DEVICES:
            assert plans(tsearch.enumerate_stage_pipeline_plans(
                tw, n)) == plans(jsearch.enumerate_stage_pipeline_plans(
                    jw, n))
    for local in range(1, 70):
        for pp in (1, 2, 3, 4, 8):
            assert tsearch.pick_microbatches(local, pp) == \
                jsearch.pick_microbatches(local, pp)


# ------------------------------------------------------ ranking and costs

def _check_decisions(jd, td):
    """Ranked lists, costs, memory and rejections of two decisions."""
    assert plans(r.plan for r in td.ranked) == plans(
        r.plan for r in jd.ranked)
    assert [(dataclasses.astuple(p), why) for p, why in td.rejected] == [
        (dataclasses.astuple(p), why) for p, why in jd.rejected]
    for jr, tr in zip(jd.ranked, td.ranked):
        for f in ("compute_s", "comm_s", "comm_hidden_s", "bubble",
                  "total_s"):
            close(getattr(tr.cost, f), getattr(jr.cost, f), f)
        assert set(tr.memory) == set(jr.memory)
        for k in jr.memory:
            close(tr.memory[k], jr.memory[k], k)
    assert td.telemetry_payload() == jd.telemetry_payload()


@pytest.mark.parametrize("hbm", [None, 16e9, 1e6])
def test_ranking_costs_and_memory_match_jax(hbm):
    """plan_parallelism over every case and device count, unfiltered, on
    16 GB and on a filter that rejects: the same ranked plans (ties
    broken on the plan tuple), costs and footprints within 1e-12, the
    same rejection reasons, the same payload; InfeasiblePlanError with
    JAX's message where JAX raises it."""
    jc, tc = coeff_pair()
    pairs = [lm_pair(n) for n in LM_CASES] + [cnn_pair(n)
                                                for n in CNN_CASES]
    for jw, tw in pairs:
        for n in DEVICES:
            jd, jerr = decide(jplanner, jw, n, coeffs=jc, hbm_bytes=hbm)
            td, terr = decide(tplanner, tw, n, coeffs=tc, hbm_bytes=hbm)
            assert terr == jerr, (jw.kind, n)
            if jd is not None:
                _check_decisions(jd, td)
            for p in (jsearch.enumerate_plans(jw, n) if jw.kind == "lm"
                      else []):
                tp = tsearch.ParallelPlan(*dataclasses.astuple(p))
                assert [dataclasses.asdict(c) for c in
                        tcost.plan_collectives(tw, tp)] == [
                    dataclasses.asdict(c)
                    for c in jcost.plan_collectives(jw, p)]


def test_observed_comm_table_and_undersubscribe_match_jax():
    """Mirrors test_observed_comm_table_seeds_cost and
    test_undersubscribe_on_prime_device_count: the same per-axis table
    from the same counters, the same re-ranked costs, and the same
    shrink to a smaller device count on a prime."""
    counters = {"collective_wire_bytes_est{axis=data,kind=psum}": 4e9,
                "collective_ops_est{axis=data,kind=psum}": 14.0,
                "collective_wire_bytes_est{axis=stage,kind=ppermute}": 1e6,
                "collective_ops_est{axis=stage,kind=ppermute}": 30.0,
                "collective_traces{axis=data,kind=psum}": 1.0,
                "other_counter": 3.0}
    obs = tcost.observed_comm_table(counters)
    assert obs == jcost.observed_comm_table(counters)
    jc, tc = coeff_pair()
    for name in ("dense", "mobilenet_like"):
        jw, tw = (lm_pair(name) if name in LM_CASES else cnn_pair(name))
        _check_decisions(jplanner.plan_parallelism(jw, 8, coeffs=jc,
                                                   observed=obs),
                         tplanner.plan_parallelism(tw, 8, coeffs=tc,
                                                   observed=obs))
    jw, tw = cnn_pair("odd_batch")
    for n in (7, 11, 13):
        with pytest.raises(tplanner.InfeasiblePlanError) as e:
            tplanner.plan_parallelism(tw, n, coeffs=tc)
        with pytest.raises(jplanner.InfeasiblePlanError) as je:
            jplanner.plan_parallelism(jw, n, coeffs=jc)
        assert str(e.value) == str(je.value)
        _check_decisions(
            jplanner.plan_parallelism(jw, n, coeffs=jc,
                                      allow_undersubscribe=True),
            tplanner.plan_parallelism(tw, n, coeffs=tc,
                                      allow_undersubscribe=True))


def test_measure_failures_give_jax_decisions():
    """Mirrors test_measure_failure_does_not_kill_planning and
    test_all_measurements_failed_reports_analytic: a measure_fn that
    fails on one candidate, one that always fails, and one that reverses
    the analytic order give JAX's decisions and measured rows."""
    jc, tc = coeff_pair()
    jw, tw = lm_pair("dense")

    def fail_on_first(first):
        def measure(plan):
            if dataclasses.astuple(plan) == first:
                raise RuntimeError("compile failed")
            return 1.0 / plan.dp
        return measure

    def always(plan):
        raise MemoryError("out of memory")

    first = dataclasses.astuple(jplanner.plan_parallelism(
        jw, 8, coeffs=jc).chosen.plan)
    for fn in (fail_on_first(first), always, lambda p: 1.0 / p.dp):
        jd = jplanner.plan_parallelism(jw, 8, coeffs=jc, measure_fn=fn,
                                       measure_top=4)
        td = tplanner.plan_parallelism(tw, 8, coeffs=tc, measure_fn=fn,
                                       measure_top=4)
        _check_decisions(jd, td)
        assert td.measured == jd.measured
        assert td.measurement_won == jd.measurement_won
        assert td.describe() == jd.describe()


def test_measure_plans_times_and_records_errors():
    """measure_plans on the CPU: a timed row per plan, an error row for a
    build that fails (the sweep goes on), the payload keys of JAX's rows."""
    from distributed_model_parallel_tpu_torch.autotune import measure

    ps = [tsearch.ParallelPlan("spmd", dp=2), tsearch.ParallelPlan("spmd",
                                                                   tp=2)]

    def build(plan):
        if plan.tp > 1:
            raise ValueError("no such layout")
        x = torch.ones(64, 64)
        return lambda: x @ x

    rows = measure.measure_plans(ps, build, device="cpu")
    assert rows[0]["measured_s"] > 0 and "error" not in rows[0]
    assert rows[1]["error"] == "ValueError: no such layout"
    assert {k for k in rows[1] if k != "error"} == set(ps[1].payload())


# ------------------------------------------------- the rewritten configs

def _same_spec(monkeypatch, tw=None):
    """Both packages take COEFFS and no HBM filter, and (given ``tw``)
    both CNN probes return the port's probe: the rewrite is what is
    held."""
    if tw is not None:
        jw = jsearch.WorkloadSpec(**dataclasses.asdict(tw))
        monkeypatch.setattr(jsearch, "cnn_workload", lambda *a, **k: jw)
        monkeypatch.setattr(tsearch, "cnn_workload", lambda *a, **k: tw)
    monkeypatch.setattr(jcost, "default_coefficients",
                        lambda *a, **k: jcost.CostCoefficients(**COEFFS))
    monkeypatch.setattr(jmemory, "device_hbm_bytes", lambda *a, **k: None)
    monkeypatch.setattr(tcost, "default_coefficients",
                        lambda *a, **k: tcost.CostCoefficients(**COEFFS))


@pytest.fixture(scope="module")
def tinycnn_probe():
    """The port's probe of tinycnn at batch 64, taken once: both
    packages' planners read it, so the cases hold the rewrite alone."""
    return tsearch.cnn_workload(tconfig.ModelConfig(name="tinycnn"),
                                tconfig.DataConfig(batch_size=64))


def _mesh(m):
    return dataclasses.astuple(m)[:6]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", [
    dict(), dict(fused=True), dict(ema_decay=0.9), dict(grad_bucket_mb=1.0),
    dict(device_resident_data=True), dict(consistency_every=2),
])
def test_plan_for_cnn_and_stage_pipeline_rewrite_as_jax(monkeypatch, n, kw,
                                                        tinycnn_probe):
    """plan_for_cnn's strategy, mesh (the dcn factor kept where it
    divides the planned dp), microbatches and auto_partition; the same
    pruning per option; plan_for_stage_pipeline's stage count,
    microbatches and cut switch."""
    _same_spec(monkeypatch, tinycnn_probe)
    opt = {k: v for k, v in kw.items() if k in ("fused", "ema_decay")}
    top = {k: v for k, v in kw.items() if k not in opt}
    mesh = dict(data=n, dcn_data=2 if n % 2 == 0 else 1)
    jc = jconfig.TrainConfig(
        model=jconfig.ModelConfig(name="tinycnn"),
        data=jconfig.DataConfig(batch_size=64), strategy="auto",
        optimizer=jconfig.OptimizerConfig(**opt),
        mesh=jconfig.MeshConfig(**mesh), **top)
    tc = tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(batch_size=64), strategy="auto",
        optimizer=tconfig.OptimizerConfig(**opt),
        mesh=tconfig.MeshConfig(**mesh), device="cpu", **top)
    for jfn, tfn in ((jplanner.plan_for_cnn, tplanner.plan_for_cnn),
                     (jplanner.plan_for_stage_pipeline,
                      tplanner.plan_for_stage_pipeline)):
        (jnew, jd), (tnew, td) = jfn(jc, n), tfn(tc, n)
        assert td.telemetry_payload() == jd.telemetry_payload()
        for f in ("strategy", "num_microbatches", "auto_partition"):
            assert getattr(tnew, f) == getattr(jnew, f), f
        assert _mesh(tnew.mesh) == _mesh(jnew.mesh)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["dense", "moe", "heads12", "window"])
def test_plan_for_lm_rewrites_as_jax(monkeypatch, n, case):
    """plan_for_lm's strategy, mesh, microbatches and the model's
    tp/sp/ep axes (lm_model_for_plan), from an already-set axis too."""
    _same_spec(monkeypatch)
    kw, batch, seq = LM_CASES[case]
    jm = jtfm.TransformerConfig(**{**LM_BASE, **kw}, sp_axis="seq")
    tm = ttfm.TransformerConfig(**{**LM_BASE, **kw}, sp_axis="seq")
    from distributed_model_parallel_tpu.train import lm_trainer as jlm
    from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm

    jnew, jd = jplanner.plan_for_lm(jlm.LMTrainConfig(
        model=jm, strategy="auto", batch_size=batch, seq_len=seq,
        mesh=jconfig.MeshConfig(dcn_data=2)), n)
    tnew, td = tplanner.plan_for_lm(tlm.LMTrainConfig(
        model=tm, strategy="auto", batch_size=batch, seq_len=seq,
        mesh=tconfig.MeshConfig(dcn_data=2), device="cpu"), n)
    assert td.telemetry_payload() == jd.telemetry_payload()
    assert (tnew.strategy, tnew.num_microbatches) == ("spmd",
                                                      jnew.num_microbatches)
    assert _mesh(tnew.mesh) == _mesh(jnew.mesh)
    for f in ("tp_axis", "sp_axis", "ep_axis"):
        assert getattr(tnew.model, f) == getattr(jnew.model, f), f


def test_reason_for_matches_jax(tmp_path):
    """Mirrors test_reason_startup_without_checkpoint."""
    cfg = tconfig.TrainConfig(elastic=True, resume=True,
                              checkpoint_dir=str(tmp_path / "none"))
    jcfg = jconfig.TrainConfig(elastic=True, resume=True,
                               checkpoint_dir=str(tmp_path / "none"))
    assert tplanner._reason_for(cfg) == jplanner._reason_for(jcfg) == \
        "startup"
    (tmp_path / "none").mkdir()
    (tmp_path / "none" / "slot").mkdir()
    assert tplanner._reason_for(cfg) == jplanner._reason_for(jcfg) == \
        "elastic-replan"


# --------------------------------------------------------------- the CLI

def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


def test_plan_cli_dry_run_matches_jax(monkeypatch):
    """``--dry-run`` prints JAX's JSON with the same coefficients and HBM
    (the LM in f32 under ``--device cpu``, as the JAX script's); rc 2 and
    ``{"error": "no-feasible-plan"}`` where nothing is feasible;
    ``--measure`` with ``--dry-run`` refused, as JAX refuses it."""
    from distributed_model_parallel_tpu_torch.autotune import dmp_plan
    from scripts import dmp_plan as jdmp_plan

    _same_spec(monkeypatch)
    for argv in (["--workload", "lm", "--devices", "8", "--batch", "16",
                  "--seq", "128", "--d-model", "64", "--d-ff", "256",
                  "--vocab", "512", "--hbm-gb", "16", "--dry-run"],
                 ["--workload", "lm", "--devices", "12", "--batch", "24",
                  "--moe-experts", "4", "--hbm-gb", "0.5", "--top", "5",
                  "--dry-run"]):
        got = _cli(dmp_plan.main, argv + ["--device", "cpu"])
        assert got == _cli(jdmp_plan.main, argv)
    bad = ["--workload", "lm", "--devices", "7", "--batch", "4",
           "--dry-run"]
    for main in (dmp_plan.main, jdmp_plan.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                pytest.raises(SystemExit) as e:
            main(bad + (["--device", "cpu"] if main is dmp_plan.main
                        else []))
        assert e.value.code == 2
        assert json.loads(buf.getvalue())["error"] == "no-feasible-plan"
    with pytest.raises(SystemExit, match="dry-run"):
        dmp_plan.main(["--dry-run", "--measure", "2", "--device", "cpu"])
    cnn = _cli(dmp_plan.main, ["--workload", "cnn", "--devices", "4",
                               "--batch", "64", "--device", "cpu",
                               "--dry-run"])
    assert math.prod(cnn["axes"].values()) == 4


# ------------------------------------------------ the card's coefficients

def test_default_coefficients_are_the_cards_not_the_tpus():
    """The port's peak, wire, alpha and HBM are the H100's (data sheet,
    and PERF.md's NCCL figure), never the JAX package's TPU figures; the
    profiling tables are keyed by GPU names only; on the CPU the
    coefficients are the same H100 fallback and no HBM is assumed."""
    from distributed_model_parallel_tpu.utils import profiling as jprof

    c = tcost.default_coefficients("cpu")
    assert c.peak_flops_per_s == tcost.FALLBACK_PEAK_FLOPS == 989e12
    assert c.wire_bytes_per_s == tcost.FALLBACK_WIRE_BYTES_PER_S
    assert c.alpha_s == tcost.DEFAULT_ALPHA_S
    tpu = (set(jprof.TPU_PEAK_FLOPS.values())
           | set(jprof.TPU_PEAK_HBM_BYTES.values())
           | set(jmemory.TPU_HBM_CAPACITY_BYTES.values())
           | {jcost.FALLBACK_PEAK_FLOPS, jcost.FALLBACK_WIRE_BYTES_PER_S,
              jcost.DEFAULT_ALPHA_S})
    for v in (c.peak_flops_per_s, c.wire_bytes_per_s, c.alpha_s,
              *profiling.GPU_PEAK_FLOPS.values(),
              *profiling.GPU_PEAK_HBM_BYTES.values()):
        assert v not in tpu, v
    assert all(k.startswith("NVIDIA ") for k in (
        *profiling.GPU_PEAK_FLOPS, *profiling.GPU_PEAK_HBM_BYTES))
    assert profiling.match_device_kind(
        profiling.GPU_PEAK_FLOPS, kind="NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.peak_flops_per_chip("cpu") is None
    assert profiling.peak_hbm_bytes_per_chip("cpu") is None
    assert tmemory.device_hbm_bytes(device="cpu") is None
    assert tmemory.device_hbm_bytes(7.0, device="cpu") == 7.0
