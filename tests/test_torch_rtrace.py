"""The port's request-tracing plane held against the JAX package's: the
``rtrace`` emitter (a no-op without a trace id or a sink, one sequence
number per record), the timeline joiner on the same synthetic records,
complete timelines from an engine run (the same events in the same
causal order as the JAX engine's), typed terminals for sheds, expiries
and a killed engine, and a drain between two engines on one stream
linked as a migration hop.

Each case mirrors the named case of ``tests/test_rtrace.py`` (:93-253,
:286-307)."""

import os
import types

import pytest
import torch

from _torch_serve_util import (
    GENS,
    PROMPTS,
    engines,
    model as _model,
    run_sim,
)
from distributed_model_parallel_tpu.utils import telemetry as jtelemetry
from distributed_model_parallel_tpu_torch.serve import Engine, ServeConfig
from distributed_model_parallel_tpu_torch.utils import tracing
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    RTRACE_TERMINAL_EVENTS,
    TelemetryRun,
    join_request_traces,
    read_records,
    registry,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    return _model()


def _timelines(engine) -> dict:
    """The engine stream's joined timelines, keyed by request id."""
    engine.telemetry.finish()
    return {tl["request"]: tl
            for tl in join_request_traces(
                read_records(engine.telemetry.path)).values()}


def _shape(tl) -> list:
    """A timeline as (seq, event, reason) — what must match JAX's."""
    return [(r["seq"], r["event"], r.get("reason")) for r in tl["events"]]


# ---------------------------------------------------------------------------
# the emitter (test_rtrace.py :93-133)
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.records = []

    def record(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


def _req(trace_id="t-1"):
    return types.SimpleNamespace(rid="r0", trace_id=trace_id, trace_seq=0)


def test_rtrace_noop_without_trace_id_or_sink():
    """Mirrors test_rtrace_noop_without_trace_id_or_sink."""
    sink = _Sink()
    req = _req(trace_id=None)
    tracing.rtrace(req, "submitted", sink=sink)
    assert not sink.records and req.trace_seq == 0
    req = _req()
    prev = tracing.installed()
    tracing.uninstall()
    try:
        tracing.rtrace(req, "submitted", sink=None)
        assert req.trace_seq == 0
    finally:
        if prev is not None:
            tracing.install(prev)


def test_rtrace_increments_seq_and_carries_fields():
    """Mirrors test_rtrace_increments_seq_and_carries_fields."""
    sink = _Sink()
    req = _req()
    tracing.rtrace(req, "submitted", sink=sink, prompt_tokens=5)
    tracing.rtrace(req, "completed", sink=sink, replica="r1")
    assert req.trace_seq == 2
    assert sink.records[0] == {"kind": "rtrace", "trace": "t-1", "seq": 1,
                               "request": "r0", "event": "submitted",
                               "prompt_tokens": 5}
    assert sink.records[1]["replica"] == "r1"


def test_new_trace_ids_are_process_unique():
    """Mirrors test_new_trace_ids_are_process_unique."""
    ids = {tracing.new_trace_id() for _ in range(100)}
    assert len(ids) == 100
    assert all(f"{os.getpid():x}-" in i for i in ids)


# ---------------------------------------------------------------------------
# the joiner on synthetic records (test_rtrace.py :136-195)
# ---------------------------------------------------------------------------

def _ev(trace, seq, event, ts, **fields):
    return {"kind": "rtrace", "trace": trace, "seq": seq, "request": "rq",
            "event": event, "ts": ts, **fields}


SYNTHETIC = {
    "orphans": (
        [_ev("ok", 1, "submitted", 1.0), _ev("ok", 2, "completed", 2.0)]
        + [_ev("gap", 1, "submitted", 1.0), _ev("gap", 3, "completed", 3.0)]
        + [_ev("open", 1, "submitted", 1.0), _ev("open", 2, "decode", 2.0)]
        + [_ev("dup", 1, "submitted", 1.0), _ev("dup", 2, "shed", 2.0),
           _ev("dup", 3, "completed", 3.0)]),
    "hops": [
        _ev("m", 3, "export", 3.0, replica="r0"),
        _ev("m", 1, "submitted", 1.0),
        _ev("m", 5, "import", 2.5, replica="r1"),
        _ev("m", 2, "admitted", 1.5, replica="r0"),
        _ev("m", 4, "route", 3.1, replica="r1"),
        _ev("m", 6, "completed", 4.0, replica="r1")],
    "phases": [
        _ev("p", 1, "submitted", 0.0), _ev("p", 2, "admitted", 1.0),
        _ev("p", 3, "prefill", 1.5), _ev("p", 4, "decode", 1.7),
        _ev("p", 5, "completed", 2.0)],
    "recovered": [
        _ev("c", 1, "submitted", 0.0, replica="r0"),
        _ev("c", 2, "admitted", 0.5, replica="r0"),
        _ev("c", 1, "recovered", 2.0, from_replica="r0"),
        _ev("c", 2, "admitted", 2.5, replica="r1"),
        _ev("c", 3, "completed", 3.0, replica="r1")],
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_joiner_matches_jax_on_synthetic_records(name):
    """Mirrors test_joiner_flags_the_three_orphan_shapes,
    test_joiner_orders_by_seq_not_ts_and_links_hops and
    test_joiner_phases_partition_wall_time: the port's joiner returns the
    JAX joiner's timelines on the same records."""
    got = join_request_traces(SYNTHETIC[name])
    assert got == jtelemetry.join_request_traces(SYNTHETIC[name])
    if name == "orphans":
        assert not got["ok"]["orphan"]
        assert got["gap"]["orphan_reasons"] == ["seq-gap"]
        assert got["open"]["orphan_reasons"] == ["no-terminal"]
        assert got["dup"]["orphan_reasons"] == ["multiple-terminals"]
    elif name == "hops":
        assert [r["seq"] for r in got["m"]["events"]] == [1, 2, 3, 4, 5, 6]
        assert got["m"]["hops"] == [{"seq": 3, "from": "r0", "to": "r1"}]
    elif name == "phases":
        tl = got["p"]
        assert sum(tl["phases"].values()) == pytest.approx(tl["wall_s"])
        assert tl["phases"]["queue"] == pytest.approx(1.0)
        assert tl["phases"]["prefill"] == pytest.approx(0.5)
    else:
        assert got["c"]["hops"][0]["recovered"] is True
        assert not got["c"]["orphan"]


# ---------------------------------------------------------------------------
# engine end to end (test_rtrace.py :198-253, :286-307)
# ---------------------------------------------------------------------------

def test_engine_run_reconstructs_complete_timelines(model, tmp_path):
    """Mirrors test_engine_run_reconstructs_complete_timelines; every
    request's timeline has the JAX engine's events in the same order."""
    pair = engines(model, tmp_path=tmp_path, sim=False)
    reqs = [[e.submit(p, g) for p, g in zip(PROMPTS[:3], GENS[:3])]
            for e in pair]
    for e in pair:
        e.run()
    jtl, ttl = (_timelines(e) for e in pair)
    assert len(ttl) == 3
    for rid, tl in ttl.items():
        assert not tl["orphan"], tl["orphan_reasons"]
        assert tl["terminal"] == "completed"
        assert sum(tl["phases"].values()) == pytest.approx(tl["wall_s"])
        decodes = [r for r in tl["events"] if r["event"] == "decode"]
        assert decodes
        for d in decodes:
            for gauge in ("occupancy", "free_pages", "used_pages",
                          "prefix_pages", "free_watermark"):
                assert gauge in d
        assert _shape(tl) == _shape(jtl[rid])
    hist = registry().histogram("serve_ttft_s")
    assert {ex[0] for ex in hist.exemplars.values()} & \
        {r.trace_id for r in reqs[1]}


def test_shed_and_expired_requests_get_terminal_traces(model, tmp_path):
    """Mirrors test_shed_and_expired_requests_get_terminal_traces."""
    pair = engines(model, tmp_path=tmp_path, max_queue=1,
                   queue_budget_s=0.01)
    reqs = [[e.submit(p, 4) for p in PROMPTS[:3]] for e in pair]
    for e in pair:
        run_sim(e, dt=0.02)
    jtl, ttl = (_timelines(e) for e in pair)
    assert len(ttl) == 3
    for rid, tl in ttl.items():
        assert not tl["orphan"], tl["orphan_reasons"]
        assert tl["terminal"] in RTRACE_TERMINAL_EVENTS
        assert _shape(tl) == _shape(jtl[rid])
    assert ttl[reqs[1][-1].rid]["terminal"] == "shed"
    assert {tl["terminal"] for tl in ttl.values()} >= {"shed", "expired"}


def test_killed_engine_traces_terminate_as_failed(model, tmp_path):
    """Mirrors test_killed_engine_traces_terminate_as_failed."""

    def bomb(i):
        if i == 2:
            raise RuntimeError("boom")

    pair = engines(model, tmp_path=tmp_path, sim=False, step_hook=bomb)
    for e in pair:
        for p, g in zip(PROMPTS[:3], GENS[:3]):
            e.submit(p, g)
        with pytest.raises(Exception):
            e.run()
    jtl, ttl = (_timelines(e) for e in pair)
    assert ttl
    for rid, tl in ttl.items():
        assert not tl["orphan"], tl["orphan_reasons"]
        assert tl["terminal"] == "failed"
        assert _shape(tl) == _shape(jtl[rid])


def test_drain_between_engines_links_hops(model, tmp_path):
    """The single-engine half of test_fleet_kill_links_migration_hops:
    two port engines on one stream (replicas "a" and "b"); requests
    drained off "a" mid-run and enqueued on "b" complete with one linked
    hop each and no orphan."""
    _, tcfg, _, tp = model
    tel = TelemetryRun(str(tmp_path / "hop.jsonl"), run="hop",
                       track_compiles=False, device={"platform": "cpu"})
    serve = ServeConfig(n_slots=2, page_size=8, n_pages=32, max_seq_len=64,
                        prefill_chunk=4)
    src = Engine(tp, tcfg, serve, device="cpu", telemetry=tel, replica="a")
    dst = Engine(tp, tcfg, serve, device="cpu", telemetry=tel, replica="b")
    for i, (p, g) in enumerate(zip(PROMPTS[:3], GENS[:3])):
        src.submit(p, g, seed=i, rid=f"req-{i}")
    for it in range(4):
        src.step_once(0.01 * it, 0.0)
    moved = src.drain()
    src.clear_cache()
    for r in moved:
        dst.enqueue(r, force=True)
    dst.run()
    tel.finish()
    traces = join_request_traces(read_records(tel.path))
    assert len(traces) == 3
    resident = 0
    for tl in traces.values():
        assert not tl["orphan"], tl["orphan_reasons"]
        assert tl["terminal"] == "completed"
        exports = [r for r in tl["events"] if r["event"] == "export"]
        assert len(exports) == len(tl["hops"])
        assert all(h == {"seq": h["seq"], "from": "a", "to": "b"}
                   for h in tl["hops"])
        resident += len(exports)
    assert resident == 2                    # both slots were mid-flight
