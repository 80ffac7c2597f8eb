"""The port's fault-plan parser and serve-side injector held against the
JAX package's, and the fleet's fault-driven overload paths on a
``SimClock``: ``parse_faults`` gives the same specs (and the same
refusals) for every kind string, ``FaultInjector`` polls fire the same
specs and hold the same degradation state poll for poll, the fleet
refuses every train-site kind in JAX's words, the bounded fleet queue
sheds typed as JAX's does, ``admission_fail`` cycles the circuit breaker,
``slow_replica`` sleeps at the serve site, and a ``crash_replica`` /
``slow_cell`` plan runs the fleet to the JAX fleet's tokens and counts.

Mirrors ``tests/test_overload.py`` (:245, :336, :379) and the fault
taxonomy of ``distributed_model_parallel_tpu/utils/faults.py``."""

import time

import pytest
import torch

from _torch_serve_util import fleet, fleet_records, model as _model
from distributed_model_parallel_tpu.utils import faults as jfaults
from distributed_model_parallel_tpu_torch.utils import faults

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

MODULES = (jfaults, faults)


@pytest.fixture(scope="module")
def model():
    return _model()


def _specs(plan) -> list:
    return [(s.kind, s.at, s.param, s.site) for s in plan]


# ---------------------------------------------------------------------------
# the parser and the injector
# ---------------------------------------------------------------------------

def test_fault_tables_match():
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert faults.CORRUPTION_KINDS == jfaults.CORRUPTION_KINDS
    assert faults.DEGRADATION_KINDS == jfaults.DEGRADATION_KINDS
    for name in ("SLOW_DEVICE_RAMP_CAP", "FLAKY_SYNC_PERIOD",
                 "ADMISSION_FAIL_POLLS", "SLOW_CELL_PERIOD",
                 "PARTITION_POLLS"):
        assert getattr(faults, name) == getattr(jfaults, name), name


@pytest.mark.parametrize("kind", sorted(jfaults.FAULT_SITES))
def test_parse_faults_every_kind(kind):
    for text in (f"{kind}@0", f"{kind}@3:0.5", f" {kind} @ 2 ,",
                 f"{kind}@7:2"):
        want = _specs(jfaults.parse_faults(text))
        assert _specs(faults.parse_faults(text)) == want, text


@pytest.mark.parametrize("text", [
    "nope@1", "nan_loss", "nan_loss@-1", "nan_loss@x", "stall@1:fast",
    "kill_cell@2,", ",,", ""])
def test_parse_faults_refusals_match(text):
    got = []
    for mod in MODULES:
        try:
            got.append(("ok", _specs(mod.parse_faults(text))))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]


def _poll_trace(mod, plan, sites) -> list:
    """Poll ``sites`` in order; after each poll, what fired and the
    degradation queries."""
    inj = mod.FaultInjector(plan)
    out = []
    for site in sites:
        fired = inj.poll(site)
        out.append((site, _specs(fired), inj.admission_blocked(),
                    inj.cell_slow_period(), inj.partition_active(),
                    sorted(s.kind for s in inj.active_degradations)))
    return out + [_specs(inj.fired), inj.enabled]


def test_injector_polls_match_every_kind():
    # Sleeping kinds carry param 0 (no wall-clock sleep in the test).
    plan = ("nan_loss@1", "nan_params@2", "preempt@4", "stall@0:0",
            "save_fail@1", "tear_save@2", "bitflip@3:5", "desync@0",
            "grad_skew@5:0.01", "slow_device@1:0", "flaky_sync@2:0",
            "slow_replica@1:0", "crash_replica@3", "admission_fail@1:3",
            "kill_cell@2", "slow_cell@1:3", "partition@4:2")
    sites = (["step", "sync", "save", "serve", "admit", "cell"] * 8
             + ["admit"] * 5 + ["cell"] * 5)
    assert (_poll_trace(faults, plan, sites)
            == _poll_trace(jfaults, plan, sites))
    for mod in MODULES:
        assert not mod.FaultInjector(()).enabled
        assert mod.FaultInjector(()).poll("serve") == []


def test_slow_cell_period_refusal_matches():
    msgs = []
    for mod in MODULES:
        inj = mod.FaultInjector(("slow_cell@0:1",))
        inj.poll("cell")
        with pytest.raises(ValueError) as e:
            inj.cell_slow_period()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_maybe_stall_and_on_fire():
    seen = {mod: [] for mod in MODULES}
    for mod in MODULES:
        inj = mod.FaultInjector(("stall@1:0",), on_fire=lambda s, site, i,
                                mod=mod: seen[mod].append((s.kind, site, i)))
        inj.maybe_stall()
        inj.maybe_stall()
    assert seen[faults] == seen[jfaults] == [("stall", "sync", 1)]


def test_slow_replica_served_at_serve_site():
    """test_overload.py:379."""
    inj = faults.FaultInjector(("slow_replica@1:0.05",))
    t0 = time.monotonic()
    inj.poll("serve")                          # occurrence 0: not yet
    assert time.monotonic() - t0 < 0.04
    t0 = time.monotonic()
    inj.poll("serve")                          # fires + sleeps
    inj.poll("serve")                          # keeps sleeping
    assert time.monotonic() - t0 >= 0.1


@pytest.mark.parametrize("kind", sorted(
    k for k, site in jfaults.FAULT_SITES.items()
    if site not in ("serve", "admit", "cell")))
def test_fleet_rejects_train_site_fault_plans(model, kind):
    """test_overload.py's refusal, for every train-site kind."""
    msgs = []
    for tag in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            fleet(tag, model, faults=(f"{kind}@0",))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "serve/admit" in msgs[1] and repr(kind) in msgs[1]


# ---------------------------------------------------------------------------
# fault-driven fleet runs, each against the JAX fleet
# ---------------------------------------------------------------------------

def _outcomes(reqs) -> list:
    return [(r.rid, r.state.value, r.shed_reason, r.error, list(r.generated),
             r.migrations) for r in reqs]


def bounded_pending(tag, model, tmp_path):
    """test_overload.py:245 — a batch submission on a full arrived fleet
    queue is rejected; an interactive one displaces the newest batch."""
    f = fleet(tag, model, serve_kw=dict(max_queue=1))
    f._now = 1.0
    b = [f.submit([1 + i, 2], 3, rid=f"b{i}", arrival_s=0.5,
                  priority="batch") for i in range(2)]
    i1 = f.submit([7, 8], 3, rid="i1", arrival_s=0.5)
    b9 = f.submit([9, 9], 3, rid="b9", arrival_s=0.5, priority="batch")
    i2 = f.submit([8, 8], 3, rid="i2", arrival_s=0.5)
    i3 = f.submit([6, 6], 3, rid="i3", arrival_s=0.5)
    status = f._status()
    f.close()
    return {"out": _outcomes(b + [i1, b9, i2, i3]),
            "pending": status["pending"], "bound": status["pending_bound"],
            "shed": status["requests_shed"],
            "rejected": status["requests_rejected"]}


def admission_chaos(tag, model, tmp_path):
    """test_overload.py:336 — admission_fail opens r1's breaker, the
    half-open probe closes it, every request completes."""
    prompts = [[1 + i, 2, 3] for i in range(8)]
    clean = fleet(tag, model, serve_kw=dict(max_queue=4))
    refs = [clean.submit(p, 6, rid=f"q{i}", seed=i)
            for i, p in enumerate(prompts)]
    clean.run(record_summary=False)
    clean.close()
    f = fleet(tag, model, tmp_path=tmp_path, name="admission",
              serve_kw=dict(max_queue=4),
              faults=("admission_fail@0:4",), fault_replica="r1")
    reqs = [f.submit(p, 6, rid=f"q{i}", seed=i) for i, p in enumerate(prompts)]
    f.run(record_summary=False)
    wave = [f.submit(p, 6, rid=f"w{i}", seed=i) for i, p in enumerate(prompts)]
    s = f.run()
    f.close()
    return {"clean": _outcomes(refs), "out": _outcomes(reqs + wave),
            "breaker": s["breaker"], "failed": s["requests_failed"],
            "router": s["router"], "rounds": s["rounds"],
            "records": fleet_records(f, ("breaker",))}


def crash_plan(tag, model, tmp_path):
    """``crash_replica`` fired by a serve-site plan on the victim."""
    f = fleet(tag, model, faults=("crash_replica@3",), fault_replica="r0",
              revive_after=4,
              journal=str(tmp_path / f"{tag}-plan.journal.jsonl"))
    reqs = [f.submit(p, 8, rid=f"c{i}", seed=i)
            for i, p in enumerate([[1, 2, 3], [4, 5], [6, 7, 8, 9],
                                   [2, 2]])]
    s = f.run()
    f.close()
    return {"out": _outcomes(reqs), "crashes": s["replica_crashes"],
            "recovered": s["crash_recovered"], "router": s["router"],
            "states": {r.name: r.state for r in f.replicas},
            "terminals": dict(f.journal.state().terminals)}


def slow_cell(tag, model, tmp_path):
    """``slow_cell`` steps the victim cell every third round."""
    f = fleet(tag, model, 4, n_devices=4, cells=2,
              faults=("slow_cell@2:3",))
    reqs = [f.submit([3 + i, 1, 4], 10, rid=f"s{i}", seed=i)
            for i in range(6)]
    s = f.run()
    f.close()
    return {"out": _outcomes(reqs), "rounds": s["rounds"],
            "router": s["router"]}


SCENARIOS = {fn.__name__: fn for fn in (bounded_pending, admission_chaos,
                                        crash_plan, slow_cell)}


@pytest.fixture(scope="module")
def jax_runs(model, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-faults")
    return {name: fn("jax", model, root) for name, fn in SCENARIOS.items()}


def test_fleet_full_queue_interactive_displaces_newest_batch(model, jax_runs,
                                                             tmp_path):
    got = bounded_pending("port", model, tmp_path)
    assert got == jax_runs["bounded_pending"]
    shed = {rid: reason for rid, _, reason, *_ in got["out"]}
    assert shed == {"b0": "queue-full", "b1": "queue-full", "i1": None,
                    "b9": "queue-full", "i2": None, "i3": "queue-full"}
    assert got["bound"] == 2 and got["pending"] == 2


def test_admission_fail_chaos_cycles_breaker(model, jax_runs, tmp_path):
    got = admission_chaos("port", model, tmp_path)
    assert got == jax_runs["admission_chaos"]
    assert all(o[1] == "completed" for o in got["out"])
    assert [o[4] for o in got["out"][:8]] == [o[4] for o in got["clean"]]
    assert any(r["replica"] == "r1" and r["state"] == "open"
               for r in got["records"])
    assert got["breaker"]["states"]["r1"] == "closed"
    assert got["breaker"]["opens"] >= 1 and got["failed"] == 0


def test_crash_replica_fault_plan(model, jax_runs, tmp_path):
    got = crash_plan("port", model, tmp_path)
    assert got == jax_runs["crash_plan"]
    assert got["crashes"] == 1 and got["recovered"] > 0
    assert all(o[1] == "completed" for o in got["out"])
    assert set(got["terminals"].values()) == {"completed"}


def test_slow_cell_fault_plan(model, jax_runs, tmp_path):
    got = slow_cell("port", model, tmp_path)
    assert got == jax_runs["slow_cell"]
    assert all(o[1] == "completed" for o in got["out"])
