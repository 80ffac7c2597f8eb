"""The port's multi-tenant orchestrator (``orchestrator/``) against the JAX
package's on the same campaigns: tinycnn tenants (augment off, f32, the
CPU) from the same weights (``TenantSpec.init``, the JAX init), on a pool
of 3 CPU slots in the port and ``jax.devices()[:3]`` in JAX.

* The pool and the scheduler, no trainer: grants, revokes, the corruption
  rule, the pipeline's fixed slice and victims with out-of-service slots
  give JAX's answers.
* The priority campaign (``tests/test_orchestrator.py``'s shape at one
  slot a tenant, quantum 1, a priority arrival at round 1): assignments,
  the ``fleet.jsonl`` records (less wall-clock fields, span ids and each
  framework's own fields), preemptions and exact resumes equal JAX's;
  every tenant's weights within 1e-4; the preempted tenant ends bit for
  bit equal to a port solo ``Trainer.fit``.
* The health drill (``tests/test_health.py``'s, on one-process tenants):
  scripted outliers quarantine the victim's slot, it migrates to the free
  slot through its preempt checkpoint, and the slot is reinstated after
  probation; the ``health`` and ``tenant`` records equal JAX's. A
  one-slot tenant has nothing to grow back to: grow-back is held in the
  rank-group campaign.
* A rank-group tenant (dp 2, two gloo ranks): ``shrink(1)`` migrates it
  to one slot at the exact step, ``grow()`` and grow-back return it to dp
  2 at the exact step; its records and weights match JAX's same campaign,
  and its two ranks end bitwise equal. A rank that raises ends the tenant
  ``FAILED`` with its traceback and a flight-recorder bundle.
* Heterogeneous tenants (cnn + lm + pipeline) never overlap, and
  ``submit`` refuses a shared ``checkpoint_dir`` in JAX's words.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import orchestrator as jorch
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu.utils import health as jhealth
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import orchestrator as torch_orch
from distributed_model_parallel_tpu_torch.models import params_to_jax
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from distributed_model_parallel_tpu_torch.utils import flightrec
from distributed_model_parallel_tpu_torch.utils import health as thealth
from distributed_model_parallel_tpu_torch.utils.telemetry import read_records
from tests._torch_port_util import both_sides, jax_compile_cache
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)
# Fields a record may differ in between two runs of the same campaign:
# wall clocks, process-wide span ids, the name of the thread the control
# loop ran on (the port's campaign runs beside JAX's, on a thread of its
# own), and what each framework stamps on its stream's first and last
# records.
WALL = {"ts", "t0", "dur_s", "wall_s", "sid", "parent", "thread"}


def _jcfg(root, name, dp=1, epochs=2, **kw):
    return tiny_train_config(
        root / name, data=jconfig.DataConfig(**DATA),
        mesh=kw.pop("mesh", jconfig.MeshConfig(data=dp)), epochs=epochs,
        log_dir=str(root / name / "log"),
        checkpoint_dir=str(root / name / "ckpt"), log_name=name,
        eval_every=100, **kw)


def _tcfg(root, name, dp=1, epochs=2, **kw):
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(**DATA),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2),
        mesh=kw.pop("mesh", tconfig.MeshConfig(data=dp)), epochs=epochs,
        log_every_n_steps=1000, device="cpu",
        log_dir=str(root / name / "log"),
        checkpoint_dir=str(root / name / "ckpt"), log_name=name,
        eval_every=100, **kw)


class _Side:
    """One package's campaign builders: its Orchestrator over ``n`` slots
    (devices), and tenant specs (the port's from the JAX init)."""

    def __init__(self, pkg, root, init):
        self.pkg, self.root, self.init = pkg, root / pkg, init

    def orch(self, n, **kw):
        if self.pkg == "jax":
            return jorch.Orchestrator(jax.devices()[:n],
                                      workdir=str(self.root / "fleet"), **kw)
        return torch_orch.Orchestrator(["cpu"] * n,
                                       workdir=str(self.root / "fleet"),
                                       **kw)

    def spec(self, name, priority=0, **kw):
        if self.pkg == "jax":
            return jorch.TenantSpec(name=name, workload="cnn",
                                    priority=priority,
                                    config=_jcfg(self.root, name, **kw))
        return torch_orch.TenantSpec(name=name, workload="cnn",
                                     priority=priority,
                                     config=_tcfg(self.root, name, **kw),
                                     init=self.init)

    def records(self):
        return _normal(read_records(str(self.root / "fleet" /
                                        "fleet.jsonl")))


def _normal(recs):
    """Records less WALL; the JAX grow-back record names its devices as
    strings (``TFRT_CPU_0``), the port's by slot id: both as ids."""
    ids = {str(d): d.id for d in jax.devices()}
    out = []
    for r in recs:
        if r["kind"] == "metrics":
            continue
        if r["kind"] == "run_start":
            r = {"kind": "run_start", "run": r["run"], "meta": r["meta"]}
        if r.get("event") == "grow-back":
            r = dict(r, devices=[ids.get(d, d) for d in r["devices"]])
        out.append({k: v for k, v in r.items() if k not in WALL})
    return out


def _weights(tenant):
    """A tenant's final parameters in the JAX layout (numpy leaves)."""
    if isinstance(tenant, jorch.Tenant):
        return jax.tree.leaves(jax.tree.map(np.asarray,
                                            tenant.trainer.state.params))
    return jax.tree.leaves(tenant.weights[0])


def _summary_view(s):
    keep = ("state", "attempts", "preemptions", "grow_backs",
            "resumed_exact_step", "resume_fallbacks", "global_step",
            "requested_devices", "granted_sizes")
    return dict(
        tenants={n: {k: t[k] for k in keep} for n, t in s["tenants"].items()},
        assignments=[(a["round"], a["tenant"], tuple(a["devices"]),
                      a["attempt"]) for a in s["assignments"]],
        all_resumes_exact=s["all_resumes_exact"],
        unrecovered=sorted(s["unrecovered"]))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("orch")


@pytest.fixture(scope="module", autouse=True)
def _compile_cache(tmp_path_factory):
    with jax_compile_cache(tmp_path_factory.mktemp("jax_cache")):
        yield


@pytest.fixture(scope="module")
def init(root):
    """The JAX tinycnn init every tenant starts from."""
    t = jtrainer.Trainer(_jcfg(root, "init", epochs=1))
    return (jax.tree.map(np.asarray, t.state.params),
            jax.tree.map(np.asarray, t.state.model_state))


def _priority_campaign(side):
    o = side.orch(3, quantum=1)
    for name, prio in (("low_a", 1), ("low_b", 0), ("low_c", 0)):
        o.submit(side.spec(name, prio))

    def on_round(o, r):
        if r == 1 and "hi" not in o.tenants:
            o.submit(side.spec("hi", 5, epochs=1))

    summary = o.run(on_round=on_round, max_rounds=200)
    o.close()
    return o, summary


@pytest.fixture(scope="module")
def runs(root, init):
    """Every campaign of this module: JAX's on this thread, the port's
    beside them on another (``both_sides``), the port's failing-rank and
    heterogeneous campaigns among them. ``{pkg: {name: (orchestrator,
    summary, side)}}``."""

    def side_runs(pkg):
        out = {}
        for name, campaign in CAMPAIGNS.items():
            side = _Side(pkg, root / name, init)
            out[name] = (*campaign(side), side)
        if pkg == "port":
            for name, campaign in (("failing", _failing_campaign),
                                   ("hetero", _hetero_campaign)):
                side = _Side(pkg, root / name, init)
                out[name] = (*campaign(side), side)
        return out

    want, got = both_sides(lambda: side_runs("jax"),
                           lambda: side_runs("port"))
    return {"jax": want, "port": got}


@pytest.fixture(scope="module")
def priority(runs):
    return {pkg: runs[pkg]["priority"] for pkg in runs}


def test_priority_campaign_matches_jax(priority):
    (_, want, jside), (_, got, tside) = priority["jax"], priority["port"]
    assert _summary_view(got) == _summary_view(want)
    # The newest lowest-priority tenant is the victim; the arrival takes
    # its slot and it resumes at the exact step.
    assert [(a["tenant"], tuple(a["devices"])) for a in got["assignments"]
            ][2:4] == [("low_c", (2,)), ("hi", (2,))]
    assert got["tenants"]["low_c"]["resumed_exact_step"] == [True]
    assert got["all_resumes_exact"]
    assert tside.records() == jside.records()
    _replay_no_overlap(tside.root / "fleet" / "fleet.jsonl")


def test_priority_campaign_weights_match_jax(priority):
    (jo, _, _), (to, _, _) = priority["jax"], priority["port"]
    for name in ("low_a", "low_b", "low_c", "hi"):
        for a, b in zip(_weights(to.tenants[name]),
                        _weights(jo.tenants[name]), strict=True):
            _close(a, b, name)


def test_preempted_tenant_resumes_bitwise_solo(priority, root, init):
    """The preempted and resumed tenant ends bit for bit where a solo
    ``Trainer.fit`` of the same config ends."""
    to, _, _ = priority["port"]
    solo = ttrainer.Trainer(_tcfg(root / "solo", "low_c"),
                            params=init[0], state=init[1])
    solo.fit()
    with torch.no_grad():
        want = jax.tree.leaves(params_to_jax(solo.model)[0])
    got = _weights(to.tenants["low_c"])
    assert to.tenants["low_c"].preemptions == 1
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def _replay_no_overlap(path):
    """Replay a fleet stream: no slot is ever held by two tenants."""
    held = {}
    for r in read_records(str(path)):
        if r.get("kind") != "tenant":
            continue
        name, event = r["name"], r["event"]
        if event == "admitted":
            ids = set(r["devices"])
            for other, other_ids in held.items():
                assert not ids & other_ids, (name, other, ids & other_ids)
            held[name] = ids
        elif event in ("preempted", "completed", "failed", "cancelled"):
            held.pop(name, None)
    return held


# -- the pool and the scheduler -----------------------------------------------

def _pool_story(pool):
    out = [pool.assign("a", 2), pool.assign("b", 1)]
    out.append(pool.revoke(2))
    out.append(pool.holders_of_revoked())
    out.append(pool.release("a"))
    out.append(pool.quarantine([1]))
    out.append(pool.holders_of_quarantined())
    out.append(pool.restore())
    out.append(pool.reinstate())
    out.append((pool.free_ids, pool.revoked_ids, pool.quarantined_ids,
                pool.n_free))
    return [tuple(getattr(d, "id", d) for d in x)
            if isinstance(x, (tuple, list)) else x for x in out]


def test_device_pool_story_matches_jax():
    assert _pool_story(torch_orch.DevicePool(["cpu"] * 4)) == _pool_story(
        jorch.DevicePool(jax.devices()[:4]))


SLICE_CASES = {
    "corruption": (dict(dp=4, recovery=dict(max_retries=1,
                                            faults=("bitflip@1",)),
                        consistency_every=1), "cnn", (1, 2, 3, 8)),
    "plain": (dict(dp=4), "cnn", (1, 3, 8)),
    "model_axis": (dict(mesh=dict(data=4, model=2)), "cnn", (1, 2, 5, 8)),
    "pipeline": (dict(mesh=dict(data=1, stage=2), num_microbatches=2),
                 "pipeline", (1, 2, 8)),
}


def _spec(pkg, root, name, workload, kw):
    kw = dict(kw)
    cfg_mod = jconfig if pkg == "jax" else tconfig
    if "mesh" in kw:
        kw["mesh"] = cfg_mod.MeshConfig(**kw["mesh"])
    if "recovery" in kw:
        kw["recovery"] = cfg_mod.RecoveryConfig(**kw["recovery"])
    if pkg == "jax":
        return jorch.TenantSpec(name=name, workload=workload,
                                config=_jcfg(root, name, **kw))
    return torch_orch.TenantSpec(name=name, workload=workload,
                                 config=_tcfg(root, name, **kw))


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_resolve_slice_matches_jax(case, tmp_path):
    kw, workload, frees = SLICE_CASES[case]
    got, want = [], []
    for pkg, out in (("jax", want), ("port", got)):
        spec = _spec(pkg, tmp_path / pkg, case, workload, kw)
        pool = (jorch.DevicePool(jax.devices()) if pkg == "jax"
                else torch_orch.DevicePool(["cpu"] * 8))
        sched = (jorch.Scheduler if pkg == "jax"
                 else torch_orch.Scheduler)(pool)
        out.append(spec.min_devices())
        out.append(spec.requested_devices())
        out += [sched.resolve_slice(spec, n) for n in frees]
    assert got == want


def test_pick_victims_matches_jax(tmp_path):
    """Victims lowest priority first, newest admission first, and held
    slots that are revoked or quarantined not counted."""

    def story(pkg):
        pool = (jorch.DevicePool(jax.devices()[:6]) if pkg == "jax"
                else torch_orch.DevicePool(["cpu"] * 6))
        mod = jorch if pkg == "jax" else torch_orch
        sched = mod.Scheduler(pool)
        running = []
        for i, (name, prio, n) in enumerate((("a", 0, 2), ("b", 0, 2),
                                             ("c", 1, 2))):
            t = mod.Tenant(dataclasses.replace(_spec(
                pkg, tmp_path / pkg, name, "cnn", dict(dp=2)),
                priority=prio), i)
            t.devices, t.admit_seq = pool.assign(name, n), i
            t.state = mod.TenantState.RUNNING
            running.append(t)
        waiter = mod.Tenant(dataclasses.replace(_spec(
            pkg, tmp_path / pkg, "w", "cnn", dict(dp=4)), priority=5), 9)
        out = [[v.name for v in sched.pick_victims(waiter, running) or []]]
        pool.quarantine([pool.assigned_ids("b")[0]])
        out.append([v.name for v in
                    sched.pick_victims(waiter, running) or []])
        pool.revoke(1)
        v = sched.pick_victims(waiter, running)
        out.append(v if v is None else [t.name for t in v])
        return out

    assert story("port") == story("jax")


def test_default_pool_is_the_cards(tmp_path):
    """With no device list the pool is every visible card, one slot each:
    on a host with no card that is an error, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(ValueError, match="at least one device"):
        torch_orch.Orchestrator(workdir=str(tmp_path))


def test_submit_rejects_shared_checkpoint_dir_in_jax_words(tmp_path):
    msgs = []
    for pkg in ("jax", "port"):
        side = _Side(pkg, tmp_path, None)
        o = side.orch(2)
        cfg_spec = side.spec("x", dp=2)
        o.submit(cfg_spec)
        with pytest.raises(ValueError, match="checkpoint_dir") as e:
            o.submit(dataclasses.replace(cfg_spec, name="y"))
        o.close()
        msgs.append(str(e.value).replace(str(side.root), "<root>"))
    assert msgs[0] == msgs[1]


# -- the health drill ---------------------------------------------------------

def _health_campaign(side):
    mod = jhealth if side.pkg == "jax" else thealth
    monitor = mod.DeviceHealthMonitor(mod.HealthPolicy(
        warmup=1, outlier_factor=3.0, min_outlier_s=5.0, outlier_penalty=0.5,
        stall_penalty=0.5, recovery_credit=0.05, idle_credit=0.5,
        quarantine_below=0.35, reinstate_above=0.8, min_probation_ticks=2))
    o = side.orch(3, quantum=1, health=monitor)
    o.submit(side.spec("victim", epochs=4))
    o.submit(side.spec("steady", epochs=4))
    probes = {"n": 0, "stop": False}

    def on_round(o, r):
        if probes["stop"] or monitor.quarantined_ids:
            probes["stop"] = True
            return
        v = o.tenants["victim"]
        if (v.state.value == "running"
                and {d.id for d in v.devices} == {0}):
            probes["n"] += 1
            monitor.observe("probe", [0], 0.01 if probes["n"] == 1 else 10.0)

    summary = o.run(on_round=on_round, max_rounds=300)
    o.close()
    return o, summary


@pytest.fixture(scope="module")
def health(runs):
    return {pkg: runs[pkg]["health"] for pkg in runs}


def test_health_drill_matches_jax(health):
    (_, want, jside), (_, got, tside) = health["jax"], health["port"]
    assert _summary_view(got) == _summary_view(want)
    grants = [a["devices"] for a in got["assignments"]
              if a["tenant"] == "victim"]
    assert grants[0] == (0,) and grants[1] == (2,)
    assert got["tenants"]["victim"]["resumed_exact_step"] == [True]
    assert got["tenants"]["steady"]["preemptions"] == 0
    recs = tside.records()
    kinds = lambda rs, k: [r for r in rs if r["kind"] == k]
    assert {r["event"] for r in kinds(recs, "health")} >= {
        "degrading", "quarantine", "reinstate"}
    assert "device-degraded" in {r.get("reason")
                                 for r in kinds(recs, "tenant")}
    jrecs = jside.records()
    for k in ("health", "tenant", "event"):
        assert kinds(recs, k) == kinds(jrecs, k), k


# -- a rank-group tenant ------------------------------------------------------

def _rank_group_campaign(side):
    o = side.orch(2, quantum=1)
    o.submit(side.spec("rg", dp=2))

    def on_round(o, r):
        t = o.tenants["rg"]
        if r == 1:
            o.shrink(1)
        if r > 1 and len(t.devices) == 1 and o.pool.revoked_ids:
            o.grow()

    summary = o.run(on_round=on_round, max_rounds=100)
    o.close()
    return o, summary


@pytest.fixture(scope="module")
def rank_group(runs):
    return {pkg: runs[pkg]["rank_group"] for pkg in runs}


def test_rank_group_migrates_and_grows_back(rank_group):
    (jo, want, jside), (to, got, tside) = rank_group["jax"], \
        rank_group["port"]
    assert _summary_view(got) == _summary_view(want)
    rg = got["tenants"]["rg"]
    assert rg["granted_sizes"] == [2, 1, 2]
    assert rg["grow_backs"] == 1
    assert rg["resumed_exact_step"] == [True, True]
    assert tside.records() == jside.records()
    t = to.tenants["rg"]
    # The last admission ran as two ranks, bitwise equal replicas; the
    # step grants crossed the process boundary.
    assert len(t.replica_digests) == 2
    assert len(set(t.replica_digests)) == 1
    assert t.grant_s and all(s > 0 for s in t.grant_s)
    for a, b in zip(_weights(t), _weights(jo.tenants["rg"]), strict=True):
        _close(a, b, "rg")


def _failing_campaign(side):
    """A dp-2 tenant whose ranks raise: a weight tree of the wrong shape."""
    rec = flightrec.FlightRecorder(str(side.root / "pm"))
    o = side.orch(2, quantum=1, flight_recorder=rec)
    bad = (side.init[0][::-1], side.init[1])
    o.submit(dataclasses.replace(side.spec("bad", dp=2), init=bad))
    summary = o.run(max_rounds=20)
    o.close()
    return o, summary


def test_failing_rank_fails_the_tenant(runs):
    """A rank that raises ends the tenant FAILED with the rank's traceback
    and a flight-recorder bundle; the orchestrator goes on."""
    o, summary, side = runs["port"]["failing"]
    t = o.tenants["bad"]
    assert summary["tenants"]["bad"]["state"] == "failed"
    assert isinstance(t.error, torch_orch.RankGroupError)
    assert "Traceback" in str(t.error) and "rank" in str(t.error)
    assert o.pool.n_free == 2
    assert len(summary["postmortems"]) == 1
    bundle = summary["postmortems"][0]
    assert os.path.basename(bundle).split("-", 3)[-1].startswith(
        "tenant-failed-bad")
    assert os.path.exists(os.path.join(bundle, "manifest.json"))
    failed = [r for r in read_records(str(side.root / "fleet" /
                                          "fleet.jsonl"))
              if r.get("event") == "failed"]
    assert failed and failed[0]["error"].startswith("RankGroupError")


# -- heterogeneous tenants ----------------------------------------------------

def _hetero_campaign(side):
    """cnn + lm + pipeline on a pool of 4 slots."""
    from distributed_model_parallel_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    from distributed_model_parallel_tpu_torch.train.lm_trainer import (
        LMTrainConfig,
    )

    init = side.init
    o = side.orch(4, quantum=2)
    o.submit(side.spec("cnn", epochs=1))
    o.submit(torch_orch.TenantSpec(
        name="lm", workload="lm", config=LMTrainConfig(
            model=TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                    n_layers=2, d_ff=64, max_seq_len=16),
            mesh=tconfig.MeshConfig(data=1), batch_size=4, seq_len=16,
            steps_per_epoch=3, epochs=1, n_tokens=2000, eval_batches=0,
            device="cpu", log_dir=str(side.root / "lm" / "log"),
            checkpoint_dir=str(side.root / "lm" / "ckpt"), log_name="lm")))
    o.submit(torch_orch.TenantSpec(
        name="pipe", workload="pipeline", init=init,
        config=_tcfg(side.root, "pipe", epochs=1,
                     mesh=tconfig.MeshConfig(data=1, stage=2),
                     num_microbatches=2)))
    summary = o.run(max_rounds=200)
    o.close()
    return o, summary


def test_heterogeneous_tenants_never_overlap(runs):
    """cnn + lm + pipeline: disjoint slices throughout, everyone
    completes, everything released at the end."""
    o, summary, side = runs["port"]["hetero"]
    assert all(t["state"] == "completed"
               for t in summary["tenants"].values()), summary
    assert sorted(len(a["devices"]) for a in summary["assignments"]) == [
        1, 1, 2]
    assert _replay_no_overlap(side.root / "fleet" / "fleet.jsonl") == {}
    assert o.pool.n_free == 4


CAMPAIGNS = {"priority": _priority_campaign, "health": _health_campaign,
             "rank_group": _rank_group_campaign}
