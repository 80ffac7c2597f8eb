"""The port's serving fleet held against the JAX package's: the same
weights, the same requests and a ``SimClock`` in both, so their schedules
are deterministic and compare one to one.

Held equal to the JAX fleet: the router's assignment sequence and
``router.assignments``, prefix affinity, the replica-kill drill (greedy
tokens per request, migrations, kills, grow-back, the typed ``router``
and ``migration`` records), health quarantine and probation, idle rounds,
an operator kill on a health-wired fleet, a kill with no peer and an
all-quarantined fleet (typed failure reasons), ``crash_replica`` and its
refusal without a journal, the fleet restart from a journal
(``ServeFleet.recover``), the summary and statusz provider, the engine
gauges, the ``DevicePool`` ledger, and the constructor's refusals.

Each JAX fleet runs once, in a module fixture; each case mirrors the
named case of ``tests/test_fleet.py`` or ``tests/test_journal.py``."""

import pytest
import torch

from _torch_serve_util import (
    GENS,
    GEOMETRY,
    PROMPTS,
    _fleet_modules,
    fleet,
    fleet_records,
    model as _model,
)
from distributed_model_parallel_tpu.utils import health as jhealth
from distributed_model_parallel_tpu.utils import statusz as jstatusz
from distributed_model_parallel_tpu.utils import telemetry as jtelemetry
from distributed_model_parallel_tpu_torch.utils import health as thealth
from distributed_model_parallel_tpu_torch.utils import statusz as tstatusz
from distributed_model_parallel_tpu_torch.utils import telemetry as ttelemetry

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

HEALTH = {"jax": jhealth, "port": thealth}
STATUSZ = {"jax": jstatusz, "port": tstatusz}
TELEMETRY = {"jax": jtelemetry, "port": ttelemetry}


@pytest.fixture(scope="module")
def model():
    return _model()


def _submit(f, prefix="req"):
    return [f.submit(p, g, seed=i, rid=f"{prefix}-{i}")
            for i, (p, g) in enumerate(zip(PROMPTS, GENS))]


def _outcomes(reqs) -> list:
    return [(r.rid, r.state.value, r.shed_reason, r.error, list(r.generated),
             r.migrations) for r in reqs]


def _fleet_view(f, summary) -> dict:
    """What a case compares of a fleet after its run, timing-free."""
    keep = ("requests_completed", "requests_failed", "requests_shed",
            "requests_rejected", "shed_by_reason", "live_replicas",
            "replicas", "requests_migrated", "migrations", "replica_kills",
            "replica_crashes", "crash_recovered", "tokens_generated",
            "rounds", "router", "cells")
    return {**{k: summary[k] for k in keep},
            "states": {r.name: r.state for r in f.replicas},
            "kills": {r.name: r.kills for r in f.replicas},
            "pool": (f.pool.free_ids, f.pool.quarantined_ids,
                     f.pool.assignments())}


# ---------------------------------------------------------------------------
# the scenarios, each run by both packages
# ---------------------------------------------------------------------------

def router_sequence(tag, model, tmp_path):
    """test_fleet.py:175 — the (request, replica, reason) sequence."""
    out = []
    for i in range(2):
        f = fleet(tag, model, tmp_path=tmp_path, name=f"router{i}",
                  router_seed=0)
        _submit(f)
        f.run()
        f.close()
        out.append([(r["request"], r["replica"], r["reason"], r["round"],
                     r["loads"])
                    for r in fleet_records(f, ("router",))])
        out.append(dict(f.router.assignments))
    return out


def affinity(tag, model, tmp_path):
    """test_fleet.py:200 — a warm prefix routes to its replica."""
    f = fleet(tag, model, tmp_path=tmp_path, name="affinity",
              router_seed=0,
              serve_kw=dict(page_size=4, n_pages=64, prefix_cache=True))
    base = [5] * 16
    first = f.submit(base + [1, 2], 6, seed=0, rid="first")
    f.run()
    follow = f.submit(base + [9, 8], 6, seed=1, rid="follow")
    f.run()
    f.close()
    routed = {r["request"]: (r["replica"], r["reason"])
              for r in fleet_records(f, ("router",))}
    return {"routed": routed, "out": _outcomes([first, follow]),
            "affinity_hits": f.router.affinity_hits}


def statusz_summary(tag, model, tmp_path):
    """test_fleet.py:224 — providers, the status table, the summary."""
    sz = STATUSZ[tag]
    f = fleet(tag, model, router_seed=0, serve_kw=dict(statusz_port=0))
    try:
        registered = sorted(set(sz.registered())
                            & {"serve-r0", "serve-r1", "serve-fleet"})
        _submit(f)
        summary = f.run()
        status = f._status()
        status.pop("utilization")
    finally:
        f.close()
    gone = set(sz.registered()) & {"serve-r0", "serve-r1", "serve-fleet"}
    return {"registered": registered, "status": status, "gone": sorted(gone),
            "summary": _fleet_view(f, summary)}


def gauges(tag, model, tmp_path):
    """test_fleet.py:260 — the fleet writes every engine gauge."""
    reg = TELEMETRY[tag].registry()
    names = ("serve_page_occupancy", "serve_cache_hit_rate",
             "serve_shared_pages", "serve_draft_accept_rate")
    for g in names:
        reg.gauge(g).value = None
    f = fleet(tag, model, router_seed=0,
              serve_kw=dict(prefix_cache=True, spec_k=2))
    shared = [1, 2, 3, 4, 5, 6, 7, 8]
    reqs = [f.submit(shared + [20 + i], 16, seed=i) for i in range(4)]
    f.run()
    f.close()
    proposed = any(r.engine._draft_proposed for r in f.replicas)
    return {"values": {g: reg.gauge(g).value for g in names},
            "proposed": proposed, "out": _outcomes(reqs)}


def kill_drill(tag, model, tmp_path):
    """test_fleet.py:341 — kill r0 at round 4, grow back, wave 2."""
    f = fleet(tag, model, tmp_path=tmp_path, name="drill", router_seed=0,
              revive_after=3)
    migrated = {}

    def hook(rnd):
        if rnd == 4:
            migrated["n"] = f.kill_replica("r0")

    f.step_hook = hook
    reqs = _submit(f)
    summary = f.run()
    view = _fleet_view(f, summary)
    free = [(r.engine.cache.pool.free_pages, r.engine.cache.pool.n_pages)
            for r in f.replicas]
    before = f.router.assignments.get("r0", 0)
    wave2 = _submit(f, prefix="wave2")
    f.run()
    f.close()
    return {"migrated": migrated["n"], "summary": view, "free": free,
            "out": _outcomes(reqs + wave2), "r0_before_wave2": before,
            "assignments": dict(f.router.assignments),
            "kill_times": dict(f.kill_times),
            "revive_times": dict(f.revive_times),
            "records": fleet_records(f, ("router", "migration"))}


def health_quarantine(tag, model, tmp_path):
    """test_fleet.py:399 — scripted serve-signal outliers quarantine r0;
    probation heals it back."""
    h = HEALTH[tag]
    mon = h.DeviceHealthMonitor(h.HealthPolicy(warmup=2,
                                               min_probation_ticks=2))
    f = fleet(tag, model, health=mon, router_seed=0)
    victim = f.replicas[0]

    def hook(rnd):
        if rnd < 4:
            mon.observe("serve", victim.device_ids, 0.01)
        elif rnd < 8:
            mon.observe("serve", victim.device_ids, 5.0)

    f.step_hook = hook
    reqs = _submit(f)
    summary = f.run()
    f.close()
    return {"out": _outcomes(reqs), "failed": summary["requests_failed"],
            "kills": summary["replica_kills"],
            "migrated": summary["migrations"] > 0, "victim": victim.state}


def idle_rounds(tag, model, tmp_path):
    """test_fleet.py:430 — idle rounds never feed the health baseline."""
    h = HEALTH[tag]
    mon = h.DeviceHealthMonitor(h.HealthPolicy(warmup=2))
    f = fleet(tag, model, health=mon, router_seed=0)
    reqs = [f.submit(p, g, seed=i, arrival_s=0.3, rid=f"req-{i}")
            for i, (p, g) in enumerate(zip(PROMPTS, GENS))]
    summary = f.run()
    f.close()
    return {"out": _outcomes(reqs), "failed": summary["requests_failed"],
            "kills": summary["replica_kills"], "rounds": summary["rounds"]}


def operator_kill_health(tag, model, tmp_path):
    """test_fleet.py:450 — an operator kill on a health-wired fleet
    still revives."""
    h = HEALTH[tag]
    f = fleet(tag, model, health=h.DeviceHealthMonitor(h.HealthPolicy()),
              router_seed=0, revive_after=3)
    f.step_hook = (lambda rnd: f.kill_replica("r1") if rnd == 3 else None)
    reqs = _submit(f)
    summary = f.run()
    f.close()
    return {"out": _outcomes(reqs), "summary": _fleet_view(f, summary)}


def no_peer(tag, model, tmp_path):
    """test_fleet.py:471 — the double kill fails its requests typed."""
    f = fleet(tag, model, router_seed=0)

    def hook(rnd):
        if rnd == 3:
            f.kill_replica("r0")
            f.kill_replica("r1")

    f.step_hook = hook
    reqs = _submit(f)
    f.run(max_rounds=10)
    f.close()
    return {"out": _outcomes(reqs),
            "held": [r.rid for r in reqs if not r.done and r.slot is not None]}


def all_quarantined(tag, model, tmp_path):
    """test_fleet.py:496 — a pending request with no revive path fails
    typed and run() returns."""
    f = fleet(tag, model, router_seed=0)

    def hook(rnd):
        if rnd == 2:
            f.kill_replica("r0")
            f.kill_replica("r1")

    f.step_hook = hook
    reqs = _submit(f)
    late = f.submit([1, 2, 3], 4, seed=9, arrival_s=3600.0, rid="late")
    summary = f.run()
    f.close()
    return {"out": _outcomes(reqs + [late]),
            "failed": summary["requests_failed"]}


def crash(tag, model, tmp_path):
    """test_journal.py:244 — hard-crash r0 at round 4; the journal
    re-admits its requests on r1; r0 grows back."""
    path = str(tmp_path / f"{tag}-crash.journal.jsonl")
    f = fleet(tag, model, tmp_path=tmp_path, name="crash", router_seed=0,
              revive_after=3, journal=path)
    recovered = {}

    def hook(rnd):
        if rnd == 4:
            recovered["n"] = f.crash_replica("r0")

    f.step_hook = hook
    reqs = _submit(f)
    summary = f.run()
    f.close()
    st = f.journal.state()
    recs = fleet_records(f, ("rtrace", "recovery", "failure"),
                         drop=("ts", "trace", "seq", "journal"))
    return {"recovered": recovered["n"], "summary": _fleet_view(f, summary),
            "recovery_time": summary["recovery_time_s"] > 0,
            "out": _outcomes(reqs), "pending": st.pending(),
            "terminals": dict(st.terminals),
            "r0": (f.replicas[0].state, f.replicas[0].crashes),
            "recovered_rtraces": [
                r for r in recs if r["kind"] == "rtrace"
                and r["event"] == "recovered"],
            "recovery": [r for r in recs if r["kind"] == "recovery"],
            "failure": [r for r in recs if r["kind"] == "failure"]}


def crash_without_journal(tag, model, tmp_path):
    """test_journal.py:298."""
    f = fleet(tag, model, router_seed=0)
    with pytest.raises(ValueError, match="journal") as e:
        f.crash_replica("r0")
    f.close()
    return str(e.value)


def recover(tag, model, tmp_path):
    """test_journal.py:307 — abandon a journaled fleet mid-stream and
    restart from the journal alone."""
    path = str(tmp_path / f"{tag}-recover.journal.jsonl")
    f1 = fleet(tag, model, router_seed=0, journal=path)
    _submit(f1)
    f1.run(max_rounds=4)
    f1.close()
    before = _outcomes(f1.results())
    jcfg, tcfg, jp, tp = model
    cfg, params, kw = ((jcfg, jp, {}) if tag == "jax" else
                       (tcfg, tp, {"devices": [torch.device("cpu")] * 8}))
    F, _, clk, _, jr = _fleet_modules(tag)
    j2 = jr.RequestJournal(path)
    f2 = F.recover(params, cfg, f1.serve, 2, journal=j2, router_seed=0,
                   clock=clk.SimClock(0.02), **kw)
    summary = f2.run()
    f2.close()
    st = j2.state()
    return {"before": before, "after": _outcomes(f2.results()),
            "summary": _fleet_view(f2, summary), "pending": st.pending(),
            "terminals": dict(st.terminals)}


SCENARIOS = {fn.__name__: fn for fn in (
    router_sequence, affinity, statusz_summary, gauges, kill_drill,
    health_quarantine, idle_rounds, operator_kill_health, no_peer,
    all_quarantined, crash, crash_without_journal, recover)}


@pytest.fixture(scope="module")
def jax_runs(model, tmp_path_factory):
    """Every scenario through the JAX fleet, once for the module."""
    root = tmp_path_factory.mktemp("jax-fleet")
    return {name: fn("jax", model, root) for name, fn in SCENARIOS.items()}


@pytest.fixture(scope="module")
def refs(model):
    """Solo port-engine tokens per request (test_fleet.py's reference)."""
    from _torch_serve_util import engines, run_sim

    _, eng = engines(model)
    reqs = _submit(eng)
    run_sim(eng)
    return {r.rid: list(r.generated) for r in reqs}


def _done_tokens(out):
    return {rid: toks for rid, state, _, _, toks, _ in out
            if state == "completed"}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_router_assignment_sequence_deterministic(model, jax_runs, tmp_path):
    got = router_sequence("port", model, tmp_path)
    assert got == jax_runs["router_sequence"]
    seq_a, _, seq_b, _ = got
    assert seq_a == seq_b and len(seq_a) == len(PROMPTS)
    assert {r for _, r, *_ in seq_a} <= {"r0", "r1"}


def test_router_prefix_affinity_routes_to_warm_replica(model, jax_runs,
                                                       tmp_path):
    got = affinity("port", model, tmp_path)
    assert got == jax_runs["affinity"]
    assert got["routed"]["follow"] == (got["routed"]["first"][0], "affinity")


def test_fleet_statusz_provider_and_summary(model, jax_runs, tmp_path):
    try:
        got = statusz_summary("port", model, tmp_path)
    finally:
        tstatusz.shutdown()
    assert got == jax_runs["statusz_summary"]
    assert got["registered"] == ["serve-fleet", "serve-r0", "serve-r1"]
    assert got["gone"] == []
    s = got["summary"]
    assert s["requests_completed"] == len(PROMPTS)
    assert s["requests_failed"] == 0 and s["migrations"] == 0


def test_fleet_writes_all_engine_gauges(model, jax_runs, tmp_path):
    got = gauges("port", model, tmp_path)
    want = jax_runs["gauges"]
    assert got["out"] == want["out"]
    assert got["proposed"] == want["proposed"]
    for name, v in want["values"].items():
        assert (got["values"][name] is None) == (v is None), name
        if v is not None:
            assert got["values"][name] == pytest.approx(v, abs=1e-9), name
    assert (got["values"]["serve_draft_accept_rate"]
            is not None) == got["proposed"]


def test_replica_kill_drill_migrates_and_grows_back(model, jax_runs, refs,
                                                    tmp_path):
    got = kill_drill("port", model, tmp_path)
    assert got == jax_runs["kill_drill"]
    s = got["summary"]
    assert got["migrated"] > 0 and s["migrations"] == got["migrated"]
    assert s["requests_failed"] == 0
    assert _done_tokens(got["out"][:len(PROMPTS)]) == refs
    assert s["states"] == {"r0": "live", "r1": "live"}
    assert s["kills"]["r0"] == 1
    assert all(f == n for f, n in got["free"])
    assert s["pool"][1] == () and set(s["pool"][2]) == {"serve-r0",
                                                         "serve-r1"}
    assert got["assignments"]["r0"] > got["r0_before_wave2"]
    migs = [r for r in got["records"] if r["kind"] == "migration"]
    assert len(migs) == got["migrated"]
    assert all(m["from_replica"] == "r0" and m["to_replica"] == "r1"
               for m in migs)


def test_health_sentinel_quarantines_degrading_replica(model, jax_runs,
                                                       refs, tmp_path):
    got = health_quarantine("port", model, tmp_path)
    assert got == jax_runs["health_quarantine"]
    assert got["failed"] == 0 and got["kills"] == 1 and got["migrated"]
    assert _done_tokens(got["out"]) == refs
    assert got["victim"] == "live"


def test_idle_rounds_never_feed_health_baseline(model, jax_runs, tmp_path):
    got = idle_rounds("port", model, tmp_path)
    assert got == jax_runs["idle_rounds"]
    assert got["failed"] == 0 and got["kills"] == 0


def test_operator_kill_on_health_wired_fleet_still_revives(model, jax_runs,
                                                           tmp_path):
    got = operator_kill_health("port", model, tmp_path)
    assert got == jax_runs["operator_kill_health"]
    assert got["summary"]["requests_failed"] == 0
    assert got["summary"]["states"]["r1"] == "live"


def test_kill_with_no_peer_fails_typed(model, jax_runs, tmp_path):
    got = no_peer("port", model, tmp_path)
    assert got == jax_runs["no_peer"]
    assert got["held"] == []
    failed = [o for o in got["out"] if o[1] == "failed"]
    assert failed
    assert all("no reachable live peer" in o[3] for o in failed)


def test_all_quarantined_fails_pending_typed(model, jax_runs, tmp_path):
    got = all_quarantined("port", model, tmp_path)
    assert got == jax_runs["all_quarantined"]
    late = got["out"][-1]
    assert late[1] == "failed" and "no revive path" in late[3]
    assert got["failed"] >= 1


def test_crash_replica_replays_bitwise_on_peer(model, jax_runs, refs,
                                               tmp_path):
    got = crash("port", model, tmp_path)
    assert got == jax_runs["crash"]
    s = got["summary"]
    assert got["recovered"] > 0 and s["crash_recovered"] == got["recovered"]
    assert s["replica_crashes"] == 1 and s["requests_failed"] == 0
    assert got["recovery_time"]
    assert _done_tokens(got["out"]) == refs
    assert got["pending"] == [] and len(got["terminals"]) == len(PROMPTS)
    assert set(got["terminals"].values()) == {"completed"}
    assert got["r0"] == ("live", 1)
    assert len(got["recovered_rtraces"]) == got["recovered"]
    assert all(r["from_replica"] == "r0" for r in got["recovered_rtraces"])
    assert got["recovery"]
    assert [r["error"] for r in got["failure"]] == ["replica-crashed"]


def test_crash_replica_without_journal_raises(model, jax_runs, tmp_path):
    assert (crash_without_journal("port", model, tmp_path)
            == jax_runs["crash_without_journal"])


def test_fleet_recover_restarts_from_journal(model, jax_runs, refs, tmp_path):
    got = recover("port", model, tmp_path)
    assert got == jax_runs["recover"]
    done = _done_tokens(got["before"])
    assert len(done) < len(PROMPTS), "the restart must have work to recover"
    after = _done_tokens(got["after"])
    assert not set(after) & set(done), "recover() re-served a terminal rid"
    assert {**done, **after} == refs
    assert got["pending"] == [] and len(got["terminals"]) == len(PROMPTS)
    assert got["summary"]["requests_failed"] == 0


# ---------------------------------------------------------------------------
# the device pool and the constructor's refusals
# ---------------------------------------------------------------------------

def _pool_sequence(pool) -> list:
    """test_fleet.py:290's calls, then revoke/restore and holder views,
    over 8 ids: each step's ledger or error message."""
    out = []

    def step(fn, *a):
        try:
            got = fn(*a)
            out.append(("ok", tuple(d.id for d in got)
                        if isinstance(got, tuple) and got
                        and hasattr(got[0], "id") else got))
        except (RuntimeError, KeyError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
        out.append((pool.free_ids, pool.quarantined_ids, pool.revoked_ids,
                    pool.assignments()))

    step(pool.assign_ids, "serve-r0", [2, 3])
    step(pool.assign_ids, "serve-r0", [4])
    step(pool.assign_ids, "serve-r1", [3, 4])
    step(pool.assign_ids, "serve-r1", [99])
    step(pool.quarantine, [2, 3])
    step(pool.release, "serve-r0")
    step(pool.assign_ids, "serve-r0", [2, 3])
    step(pool.reinstate, [2, 3])
    step(pool.assign_ids, "serve-r0", [2, 3])
    step(pool.assign, "serve-r1", 3)
    step(pool.assign, "serve-r2", 9)
    step(pool.revoke, 2)
    step(pool.holders_of_revoked)
    step(pool.quarantine, [7])
    step(pool.quarantine, [0])
    step(pool.holders_of_quarantined)
    step(pool.restore, None)
    step(pool.release, "serve-r1")
    step(pool.reinstate, None)
    return out


def test_device_pool_ledger_matches_jax():
    from _torch_serve_util import _Dev
    from distributed_model_parallel_tpu.orchestrator.scheduler import (
        DevicePool as JPool,
    )
    from distributed_model_parallel_tpu_torch.orchestrator import (
        DevicePool,
        DeviceSlot,
    )

    port = DevicePool([torch.device("cpu")] * 8)
    assert port.devices[5] == DeviceSlot(5, torch.device("cpu"))
    assert _pool_sequence(port) == _pool_sequence(JPool(
        [_Dev(i) for i in range(8)]))
    with pytest.raises(ValueError, match="at least one device"):
        DevicePool([])


def test_fleet_rejects_bad_geometry(model):
    import jax

    jcfg, tcfg, jp, tp = model
    msgs = []
    for tag, cfg, p, one, pool in (
            ("jax", jcfg, jp, jax.devices()[:1], jax.devices()),
            ("port", tcfg, tp, [torch.device("cpu")],
             [torch.device("cpu")] * 8)):
        F, S, *_ = _fleet_modules(tag)
        row = []
        for args in ((S(**GEOMETRY, policy="static"), 2, {}),
                     (S(**GEOMETRY), 0, {}), (S(**GEOMETRY), 2,
                                              {"devices": one}),
                     (S(**GEOMETRY), 2, {"faults": ("nan_loss@0",)})):
            with pytest.raises(ValueError) as e:
                F(p, cfg, args[0], args[1], **{"devices": pool, **args[2]})
            row.append(str(e.value))
        msgs.append(row)
    assert msgs[0] == msgs[1]
    assert "continuous" in msgs[1][0] and "n_replicas" in msgs[1][1]
    assert "free device" in msgs[1][2] and "serve/admit" in msgs[1][3]
    with pytest.raises(ValueError, match="not both"):
        fleet("port", model, device="cpu")
