"""The port's resource metering and capacity analysis held against the
JAX package's: one terminal bill per request on the rtrace id, the duty
ledger partitioning iteration wall exactly, zero-cost bills for typed
sheds, the metering gate's violation lists on the same synthetic
streams, the capacity fold, ``what_if`` pricing launches with the
caller's coefficients or the cost model's, and ``meter=False`` switching
the plane off.

Each case mirrors the named case of ``tests/test_metering.py``; where
both engines run, the bills' identity fields (request, tenant, event,
hop, tokens, prefill chunks, decode rounds) must be equal — their
seconds are each host's own."""

import types

import pytest
import torch

from _torch_serve_util import (
    GENS,
    PROMPTS,
    engines,
    model as _model,
)
from distributed_model_parallel_tpu.serve import capacity as jcapacity
from distributed_model_parallel_tpu_torch.serve import capacity as tcapacity
from distributed_model_parallel_tpu_torch.utils.metering import (
    LEDGER_BUCKETS,
)
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    read_records,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

IDENTITY = ("request", "tenant", "replica", "event", "hop", "tokens",
            "prefill_chunks", "decode_rounds", "cached_tokens")


@pytest.fixture(scope="module")
def model():
    return _model()


def _meter_records(recs, event=None):
    out = [r for r in recs if r.get("kind") == "meter"]
    if event is not None:
        out = [r for r in out if r.get("event") == event]
    return out


def _stream(engine) -> list:
    engine.telemetry.finish()
    return read_records(engine.telemetry.path)


def _identity(recs) -> list:
    return sorted((tuple(r.get(k) for k in IDENTITY)
                   for r in _meter_records(recs)), key=str)


# ---------------------------------------------------------------------------
# one engine (test_metering.py :76-150)
# ---------------------------------------------------------------------------

def test_engine_bills_every_request_exactly_once(model, tmp_path):
    """Mirrors test_engine_bills_every_request_exactly_once."""
    pair = engines(model, tmp_path=tmp_path, sim=False)
    streams = []
    for e in pair:
        reqs = [e.submit(p, g, seed=i, rid=f"req-{i}", tenant="team-a")
                for i, (p, g) in enumerate(zip(PROMPTS, GENS))]
        e.run()
        assert all(r.state.value == "completed" for r in reqs)
        streams.append(_stream(e))
    recs = streams[1]
    terminals = _meter_records(recs, "completed")
    assert sorted(t["request"] for t in terminals) == \
        sorted(f"req-{i}" for i in range(len(PROMPTS)))
    for t in terminals:
        assert t["tenant"] == "team-a"
        assert t["chip_s"] > 0 and t["page_s"] > 0 and t["resident_s"] > 0
        assert t["prefill_chunks"] >= 1 and t["decode_rounds"] >= 1
        assert t["trace"]
    assert tcapacity.check_invariants(recs) == []
    row = pair[1].meter.by_tenant["team-a"]
    assert row["requests"] == len(PROMPTS)
    assert row["tokens"] == sum(GENS) == row["good_tokens"]
    assert row["sheds"] == 0
    assert _identity(recs) == _identity(streams[0])


def test_ledger_partitions_iteration_wall(model):
    """Mirrors test_ledger_partitions_iteration_wall (the port's engine
    on the real clock: a late arrival forces idle iterations)."""
    eng = engines(model, sim=False)[1]
    reqs = [eng.submit(p, g, seed=i, arrival_s=0.05)
            for i, (p, g) in enumerate(zip(PROMPTS[:2], GENS[:2]))]
    eng.run()
    assert all(r.state.value == "completed" for r in reqs)
    m = eng.meter
    u = m.utilization()
    assert u["iterations"] == m.iterations > 0
    assert abs(sum(u[f"{b}_s"] for b in LEDGER_BUCKETS) - u["wall_s"]) \
        < 1e-9
    assert u["busy_s"] > 0 and u["idle_s"] > 0
    assert u["quarantined_s"] == 0
    assert 0 < m.chip_s_total() <= u["busy_s"]


def test_shed_request_gets_zero_cost_terminal(model, tmp_path):
    """Mirrors test_shed_request_gets_zero_cost_terminal."""
    pair = engines(model, tmp_path=tmp_path, sim=False, n_slots=1,
                   max_queue=1)
    streams = []
    for e in pair:
        for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
            e.submit(p, g, seed=i, rid=f"req-{i}", tenant="bursty")
        e.run()
        streams.append(_stream(e))
    sheds = _meter_records(streams[1], "shed")
    assert sheds
    assert all(s["chip_s"] == 0 and s["page_s"] == 0 for s in sheds)
    assert tcapacity.check_invariants(streams[1]) == []
    assert pair[1].meter.by_tenant["bursty"]["sheds"] == len(sheds)
    assert _identity(streams[1]) == _identity(streams[0])


def test_metering_off_engine_emits_nothing(model, tmp_path):
    """Mirrors test_metering_off_engine_emits_nothing on one engine."""
    pair = engines(model, tmp_path=tmp_path, sim=False, meter=False)
    for e in pair:
        reqs = [e.submit(p, g, seed=i)
                for i, (p, g) in enumerate(zip(PROMPTS, GENS))]
        summary = e.run()
        assert all(r.state.value == "completed" for r in reqs)
        assert summary["metering"] is None and e.meter is None
        recs = _stream(e)
        assert _meter_records(recs) == []
        assert not [r for r in recs if r.get("kind") == "utilization"]


# ---------------------------------------------------------------------------
# the metering gate on synthetic streams (test_metering.py :244-287)
# ---------------------------------------------------------------------------

def _clean_records():
    return [
        {"kind": "rtrace", "trace": "t1", "request": "a",
         "event": "admitted"},
        {"kind": "rtrace", "trace": "t1", "request": "a",
         "event": "completed"},
        {"kind": "meter", "trace": "t1", "request": "a", "tenant": "x",
         "replica": "r0", "event": "completed", "hop": 0,
         "chip_s": 0.5, "page_s": 1.0, "resident_s": 1.0, "tokens": 8},
        {"kind": "utilization", "replica": "r0", "busy_s": 0.6,
         "stalled_s": 0.1, "brownout_s": 0.0, "idle_s": 0.3,
         "quarantined_s": 0.0, "wall_s": 1.0, "iterations": 10},
    ]


def _partition(recs):
    recs[-1]["idle_s"] = 0.9
    return recs


def _overbilled(recs):
    recs[2]["chip_s"] = 5.0
    return recs


def _unmetered(recs):
    return [r for r in recs if r["kind"] != "meter"]


def _double_billed(recs):
    return recs + [dict(recs[2])]


def _no_ledger(recs):
    return recs[:3]


@pytest.mark.parametrize("mutate,needle", [
    (lambda r: r, None),
    (_partition, "partition"),
    (_overbilled, "chip"),
    (_unmetered, "meter"),
    (_double_billed, "t1"),
    (_no_ledger, "cannot bound"),
])
def test_gate_violation_lists_match_jax(mutate, needle):
    """Mirrors the test_gate_* cases: the port's check_invariants returns
    the JAX package's violation list on each synthetic stream."""
    got = tcapacity.check_invariants(mutate(_clean_records()))
    assert got == jcapacity.check_invariants(mutate(_clean_records()))
    if needle is None:
        assert got == []
    else:
        assert any(needle in f for f in got), got


def test_capacity_report_folds_stream(model, tmp_path):
    """Mirrors test_capacity_report_folds_stream on one engine: the
    capacity fold of the port's stream has the JAX fold's shape and its
    token and tenant figures; ``what_if`` prices launches with the cost
    model's coefficients by default, and with the caller's agrees with
    JAX's."""
    pair = engines(model, tmp_path=tmp_path, sim=False)
    caps = []
    for e in pair:
        for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
            e.submit(p, g, seed=i, rid=f"req-{i}",
                     tenant="a" if i % 2 else "b")
        e.run()
        caps.append(jcapacity.build_capacity(_stream(e)) if e is pair[0]
                    else tcapacity.build_capacity(_stream(e)))
    jcap, cap = caps
    assert set(cap) == set(jcap)
    assert cap["meter_records"] == jcap["meter_records"] == len(PROMPTS)
    assert set(cap["tenants"]) == {"a", "b"}
    assert cap["tokens"] == jcap["tokens"] == sum(GENS)
    assert cap["billed_chip_s"] > 0
    for row in cap["replicas"].values():
        assert abs(sum(row["duty"].values()) - 1.0) < 1e-3
    assert cap["sustainable_tokens_per_s"] >= cap["tokens_per_s"] > 0
    from distributed_model_parallel_tpu_torch.autotune.cost_model import (
        default_coefficients,
    )

    assert tcapacity.what_if(cap, -1) == \
        tcapacity.what_if(cap, -1, default_coefficients())
    coeffs = types.SimpleNamespace(alpha_s=2e-5)
    assert tcapacity.what_if(cap, 1, coeffs) == \
        jcapacity.what_if(cap, 1, coeffs)
