"""The port's cell topology and cell-aware routing held against the JAX
package's: ``CellDirectory`` and ``home_cell`` (the same cell for every
prompt and seed), the (cell, prefix, load) router's assignment sequence
across a quarantine and reinstate, and the correlated-failure drills on a
``SimClock`` — ``kill_cell``, ``partition``, the cell-sick sweep, and the
cell rollup of the summary and statusz — each with the same requests,
tokens, typed ``cell``/``router`` records and counts as the JAX fleet.

Each JAX fleet runs once, in a module fixture; each case mirrors the
named case of ``tests/test_cells.py``."""

import pytest
import torch

from _torch_serve_util import fleet, fleet_records, model as _model
from distributed_model_parallel_tpu.serve import Router as JRouter
from distributed_model_parallel_tpu.serve import cells as jcells
from distributed_model_parallel_tpu.serve import traffic as jtraffic
from distributed_model_parallel_tpu_torch.serve import Router, cells
from distributed_model_parallel_tpu_torch.serve import traffic as ttraffic

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    return _model()


# ---------------------------------------------------------------------------
# CellDirectory + home_cell (test_cells.py:89-127)
# ---------------------------------------------------------------------------

def test_partition_contiguous_blocks_remainder_first():
    for n, k in ((7, 3), (6, 3), (8, 4), (5, 1), (4, 4)):
        names = [f"r{i}" for i in range(n)]
        d = cells.CellDirectory.partition(names, k)
        assert d.as_dict() == jcells.CellDirectory.partition(names,
                                                             k).as_dict()
    d = cells.CellDirectory.partition([f"r{i}" for i in range(7)], 3)
    assert d.cells == ("c0", "c1", "c2")
    assert d.cell_of("r4") == "c1" and d.members("c2") == ("r5", "r6")
    assert "c1" in d and "c9" not in d and len(d) == 3


def test_directory_rejects_bad_membership():
    cases = [
        (lambda m: m.CellDirectory({}), ValueError),
        (lambda m: m.CellDirectory({"c0": []}), ValueError),
        (lambda m: m.CellDirectory({"c0": ["r0"], "c1": ["r0"]}),
         ValueError),
        (lambda m: m.CellDirectory.partition(["r0"], 2), ValueError),
        (lambda m: m.CellDirectory.partition(["r0"], 0), ValueError),
        (lambda m: m.CellDirectory({"c0": ["r0"]}).cell_of("r9"), KeyError),
        (lambda m: m.CellDirectory({"c0": ["r0"]}).members("c9"), KeyError),
        (lambda m: m.home_cell([1, 2], ()), ValueError),
    ]
    for fn, exc in cases:
        msgs = []
        for mod in (jcells, cells):
            with pytest.raises(exc) as e:
                fn(mod)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_home_cell_hashes_as_jax_does():
    """Both packages send every prompt to the same cell, for every seed
    and cell count (prompts past 32 tokens, tokens past 255 and negative
    seeds included)."""
    import random

    rng = random.Random(3)
    prompts = [[rng.randrange(0, 70_000) for _ in range(rng.randrange(1, 50))]
               for _ in range(200)]
    for n in (1, 2, 3, 4, 7):
        names = tuple(f"c{i}" for i in range(n))
        for seed in (0, 7, 8, 2 ** 33 + 5, -1):
            want = [jcells.home_cell(p, names, seed) for p in prompts]
            assert [cells.home_cell(p, names, seed)
                    for p in prompts] == want
    homes = [cells.home_cell(p, ("c0", "c1", "c2", "c3"), 7)
             for p in prompts]
    assert len(set(homes)) > 1
    assert homes != [cells.home_cell(p, ("c0", "c1", "c2", "c3"), 8)
                     for p in prompts]


# ---------------------------------------------------------------------------
# the (cell, prefix, load) router (test_cells.py:206-280)
# ---------------------------------------------------------------------------

class _Cache:
    def __init__(self, cached=0):
        self.occupancy, self.cached = 0.0, cached

    def cached_prefix_tokens(self, prompt):
        return self.cached if prompt[0] % 5 == 0 else 0


class _Sched:
    def __init__(self):
        self.queue, self.slots = [], [None, None]


class _Engine:
    def __init__(self, cached=0):
        self.sched, self.cache = _Sched(), _Cache(cached)


class _Replica:
    def __init__(self, name, cached=0):
        self.name, self.engine = name, _Engine(cached)


def _route_trace(R, mod, seed, n, n_cells, down, loads):
    """The assignment sequence over a synthetic trace with ``down``'s
    members out of the candidate set for the middle third; each pick
    adds to its replica's queue (a stand-in for the live load), and
    replica 1 holds a cached prefix of prompts starting at a multiple
    of 5."""
    directory = mod.CellDirectory.partition([f"r{i}" for i in range(n)],
                                            n_cells)
    reps = [_Replica(f"r{i}", cached=4 if i == 1 else 0) for i in range(n)]
    router = R(seed, cells=directory)
    out = []
    prompts = [[(7 * i + j) % 64 for j in range(6)] for i in range(60)]
    for i, p in enumerate(prompts):
        cands = (reps if not 20 <= i < 40 else
                 [r for r in reps if directory.cell_of(r.name) != down])
        migrate = loads and i % 11 == 10
        rep, reason, seen = router.pick(p, cands, migrate=migrate)
        out.append((rep.name, reason, seen))
        if loads:
            rep.engine.sched.queue.append(p)
            rep.engine.cache.occupancy += 0.01
    return out, (dict(router.assignments), router.affinity_hits,
                 router.failovers)


@pytest.mark.parametrize("n,n_cells,down,loads", [
    (6, 3, "c1", False), (6, 3, "c1", True), (8, 4, "c3", True),
    (4, 1, None, True)])
def test_router_deterministic_across_quarantine_reinstate(n, n_cells, down,
                                                          loads):
    runs = [_route_trace(R, mod, 5, n, n_cells, down, loads)
            for R, mod in ((JRouter, jcells), (Router, cells),
                           (Router, cells))]
    assert runs[1] == runs[0] == runs[2]
    seq = runs[1][0]
    if not loads:
        assert all(reason in ("cell-local", "affinity")
                   for _, reason, _ in seq[:20])
        assert any(reason == "failover" for _, reason, _ in seq[20:40])


def test_router_home_cell_confines_p2c():
    directory = cells.CellDirectory.partition([f"r{i}" for i in range(8)], 4)
    reps = [_Replica(f"r{i}") for i in range(8)]
    router = Router(0, cells=directory)
    jrouter = JRouter(0, cells=jcells.CellDirectory(directory.as_dict()))
    for i in range(40):
        p = [(3 * i + j) % 64 for j in range(5)]
        rep, reason, _ = router.pick(p, reps)
        jrep, jreason, _ = jrouter.pick(p, reps)
        assert (rep.name, reason) == (jrep.name, jreason)
        assert reason == "cell-local"
        assert directory.cell_of(rep.name) == directory.home(p, 0)
    assert router.failovers == 0
    assert router.assignments == jrouter.assignments


# ---------------------------------------------------------------------------
# correlated-failure drills (test_cells.py:287-445)
# ---------------------------------------------------------------------------

def _outcomes(reqs) -> list:
    return [(r.rid, r.state.value, r.shed_reason, r.error, list(r.generated),
             r.migrations) for r in reqs]


def _cell_view(f, s) -> dict:
    return {"cells": s["cells"], "failed": s["requests_failed"],
            "migrations": s["migrations"], "kills": s["replica_kills"],
            "router": s["router"], "rounds": s["rounds"],
            "states": {r.name: r.state for r in f.replicas},
            "pool": (f.pool.free_ids, f.pool.quarantined_ids,
                     f.pool.assignments())}


def _submit_trace(f, trace):
    return [f.submit(r["prompt"], r["max_new"], rid=r["rid"],
                     arrival_s=r["arrival_s"], seed=r["seed"],
                     priority=r["priority"]) for r in trace]


def kill_cell(tag, model, tmp_path, trace):
    f = fleet(tag, model, 6, n_devices=6, cells=3, tmp_path=tmp_path,
              name="killcell", faults=["kill_cell@12"], fault_cell="c1",
              revive_after=30)
    reqs = _submit_trace(f, trace)
    s = f.run()
    f.close()
    return {"out": _outcomes(reqs), "view": _cell_view(f, s),
            "records": fleet_records(f, ("cell", "migration"))}


def partition(tag, model, tmp_path, trace):
    f = fleet(tag, model, 4, n_devices=4, cells=2, tmp_path=tmp_path,
              name="partition", faults=["partition@8:10"], fault_cell="c1")
    reqs = [f.submit(r["prompt"], r["max_new"], rid=r["rid"],
                     arrival_s=r["arrival_s"], seed=r["seed"])
            for r in trace]
    s = f.run()
    f.close()
    return {"out": _outcomes(reqs), "view": _cell_view(f, s),
            "records": fleet_records(f, ("cell", "router"))}


def cell_sick(tag, model, tmp_path, trace):
    f = fleet(tag, model, 6, n_devices=6, cells=2, tmp_path=tmp_path,
              name="sick")
    reqs = [f.submit([1 + i, 2, 3, 4], 8, arrival_s=0.0, seed=i,
                     rid=f"s{i}") for i in range(8)]
    fired = []

    def hook(rnd):
        if rnd == 6:
            f.kill_replica("r0")
            f.kill_replica("r1")
            fired.append(rnd)

    f.step_hook = hook
    s = f.run()
    f.close()
    return {"fired": fired, "out": _outcomes(reqs), "view": _cell_view(f, s),
            "records": fleet_records(f, ("cell", "event"))}


def rollup(tag, model, tmp_path, trace):
    f = fleet(tag, model, 4, n_devices=4,
              cells={"east": ["r0", "r1"], "west": ["r2", "r3"]})
    f.submit([1, 2, 3], 6, seed=0, rid="one")
    s = f.run()
    st = f._status()["cells"]
    for c in st.values():
        c.pop("utilization")
    f.kill_cell("west")
    after = f._status()["cells"]
    for c in after.values():
        c.pop("utilization")
    out = {"summary": s["cells"], "status": st, "after": after,
           "summary_after": f.summary(record=False)["cells"]}
    f.close()
    return out


def bad_config(tag, model, tmp_path, trace):
    msgs = []
    for kw in ({"cells": {"c0": ["r0", "r9"], "c1": ["r1", "r2", "r3"]}},
               {"cells": 2, "fault_cell": "nope"},
               {"faults": ["kill_cell@5"]},
               {"fault_cell": "c0"},
               {"cells": 2, "cell_sick_threshold": 0.0}):
        with pytest.raises(ValueError) as e:
            fleet(tag, model, 4, n_devices=4, **kw)
        msgs.append(str(e.value))
    f = fleet(tag, model, 4, n_devices=4, cells=2)
    for name in ("c9",):
        with pytest.raises(KeyError) as e:
            f.kill_cell(name)
        msgs.append(str(e.value))
    f.close()
    flat = fleet(tag, model, 2)
    with pytest.raises(ValueError) as e:
        flat.kill_cell("c0")
    msgs.append(str(e.value))
    flat.close()
    return msgs


SCENARIOS = {fn.__name__: fn for fn in (kill_cell, partition, cell_sick,
                                        rollup, bad_config)}


def _traces(traffic):
    return {
        "kill_cell": traffic.mixed_tenants(9, horizon_s=1.2, tenants={
            "web": {"rate": 24.0, "priority": "interactive"},
            "etl": {"rate": 10.0, "priority": "batch"}}),
        "partition": traffic.mixed_tenants(4, horizon_s=1.5, tenants={
            "web": {"rate": 26.0, "priority": "interactive"}}),
    }


@pytest.fixture(scope="module")
def jax_runs(model, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-cells")
    traces = _traces(jtraffic)
    return {name: fn("jax", model, root, traces.get(name))
            for name, fn in SCENARIOS.items()}


def _port(name, model, tmp_path):
    traces = _traces(ttraffic)
    assert traces == _traces(jtraffic)     # the same seeded programs
    return SCENARIOS[name]("port", model, tmp_path, traces.get(name))


def test_kill_cell_drill_drains_migrates_grows_back(model, jax_runs,
                                                    tmp_path):
    from _torch_serve_util import engines, run_sim

    got = _port("kill_cell", model, tmp_path)
    assert got == jax_runs["kill_cell"]
    _, ref_eng = engines(model)
    for r in _traces(ttraffic)["kill_cell"]:
        ref_eng.submit(r["prompt"], r["max_new"], rid=r["rid"],
                       seed=r["seed"])
    run_sim(ref_eng)
    refs = {q.rid: q.generated for q in ref_eng.results()}
    v = got["view"]
    assert v["failed"] == 0
    assert [o[0] for o in got["out"] if o[1] != "completed"
            and not o[2]] == []
    assert all(o[4] == refs[o[0]] for o in got["out"] if o[1] == "completed")
    assert v["cells"]["cell_kills"] == 1
    cell_recs = [r for r in got["records"] if r["kind"] == "cell"]
    kill = next(r for r in cell_recs if r["event"] == "kill")
    assert kill["cell"] == "c1" and sorted(kill["replicas"]) == ["r2", "r3"]
    grow = [r for r in cell_recs if r["event"] == "grow-back"]
    assert grow and grow[0]["cell"] == "c1"
    assert set(v["states"].values()) == {"live"}
    assert v["cells"]["live"] == ["c0", "c1", "c2"]
    # The cell grew back onto exactly its slots.
    assert (v["pool"][2]["serve-r2"], v["pool"][2]["serve-r3"]) == ((2,), (3,))


def test_partition_drill_residents_drain_on_heal(model, jax_runs, tmp_path):
    got = _port("partition", model, tmp_path)
    assert got == jax_runs["partition"]
    assert got["view"]["failed"] == 0
    assert [o[0] for o in got["out"] if o[1] != "completed"
            and not o[2]] == []
    recs = got["records"]
    part = [r for r in recs if r["kind"] == "cell"
            and r["event"] == "partition"]
    heal = [r for r in recs if r["kind"] == "cell" and r["event"] == "heal"]
    assert len(part) == 1 and len(heal) == 1 and part[0]["cell"] == "c1"
    assert heal[0]["drained"] <= heal[0]["residents"]
    lo, hi = part[0]["round"], heal[0]["round"]
    assert [r for r in recs if r["kind"] == "router"
            and lo <= r["round"] < hi
            and r["replica"] in ("r2", "r3")] == []
    assert got["view"]["cells"]["partitioned"] == []


def test_cell_sick_sweep_quarantines_remainder(model, jax_runs, tmp_path):
    got = _port("cell_sick", model, tmp_path)
    assert got == jax_runs["cell_sick"]
    assert got["fired"]
    sick = [r for r in got["records"] if r["kind"] == "cell"
            and r["event"] == "sick"]
    assert len(sick) == 1 and sick[0]["cell"] == "c0"
    assert sick[0]["swept"] == ["r2"]
    assert got["view"]["states"]["r2"] == "quarantined"
    assert any(r["kind"] == "event"
               and "replica r2 (cell-sick)" in r["message"]
               for r in got["records"])
    assert got["view"]["failed"] == 0


def test_fleet_summary_and_statusz_cell_rollup(model, jax_runs, tmp_path):
    got = _port("rollup", model, tmp_path)
    assert got == jax_runs["rollup"]
    assert got["summary"]["layout"] == {"east": ["r0", "r1"],
                                        "west": ["r2", "r3"]}
    assert got["summary"]["live"] == ["east", "west"]
    assert all(len(c["live"]) == 2 and c["breaker"] == "closed"
               and not c["partitioned"] for c in got["status"].values())
    assert got["after"]["west"]["live"] == []
    assert got["summary_after"]["live"] == ["east"]


def test_fleet_rejects_bad_cell_config(model, jax_runs, tmp_path):
    got = _port("bad_config", model, tmp_path)
    assert got == jax_runs["bad_config"]
    assert "unknown replicas" in got[0] and "unknown fault_cell" in got[1]
    assert "no cell topology" in got[2] and "unknown cell" in got[5]
