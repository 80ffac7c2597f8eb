"""The port's overload controls held against the JAX package's: deadlines
and typed shedding (mid-prefill and mid-decode aborts return every page),
deadlines across a drain, the bounded arrived backlog and its batch-first
trim, the two priority classes, the circuit breaker, and the brownout
ladder (a clamped stream is a prefix of the unclamped one).

Each case mirrors the named case of ``tests/test_overload.py``: the JAX
engine and the port's run the same requests at the same open-loop clocks
(each on its own package's ``SimClock``), and every request's state,
shed reason and greedy tokens, and the ``shed``/``brownout`` records'
kind, request, reason, state and level, must be equal."""

import pytest
import torch

from _torch_serve_util import (
    drive,
    engines,
    model as _model,
    outcomes,
    run_sim,
    typed_records,
)
from distributed_model_parallel_tpu.serve import (
    BrownoutController as JBrownout,
)
from distributed_model_parallel_tpu.serve import CircuitBreaker as JBreaker
from distributed_model_parallel_tpu.serve import ServeConfig as JServe
from distributed_model_parallel_tpu.serve.scheduler import (
    Request as JRequest,
)
from distributed_model_parallel_tpu.serve.scheduler import (
    expiry_reason as jexpiry_reason,
)
from distributed_model_parallel_tpu_torch.serve import (
    BrownoutController,
    CircuitBreaker,
    RequestState,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve.scheduler import (
    Request,
    expiry_reason,
)
from distributed_model_parallel_tpu_torch.utils.telemetry import registry

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    return _model()


def _both(pair, fn):
    """``fn(engine)`` on the JAX and the port engine: the two results."""
    return tuple(fn(e) for e in pair)


# ---------------------------------------------------------------------------
# deadlines + shedding (test_overload.py :82-147)
# ---------------------------------------------------------------------------

def test_expiry_reason_precedence():
    """Mirrors test_expiry_reason_precedence."""
    for R, expiry in ((Request, expiry_reason), (JRequest, jexpiry_reason)):
        req = R(rid="r", prompt=[1], max_new_tokens=4, deadline_s=2.0,
                queue_budget_s=1.0)
        assert expiry(req, 0.5) is None
        assert expiry(req, 1.5) == "queue-deadline"
        assert expiry(req, 2.5) == "total-deadline"
        bare = R(rid="b", prompt=[1], max_new_tokens=4)
        assert expiry(bare, 9.0) is None
        assert expiry(bare, 9.0, queue_budget_s=1.0) == "queue-deadline"


def test_expiry_while_queued_sheds_typed(model, tmp_path):
    """Mirrors test_expiry_while_queued_sheds_typed: a request queued
    behind a full pool past its queue budget sheds typed; the resident
    one is untouched."""
    pair = engines(model, tmp_path=tmp_path, n_pages=2, max_seq_len=16,
                   queue_budget_s=1.0)
    reqs = _both(pair, lambda e: [e.submit([1, 2, 3], 10, rid="hog"),
                                  e.submit([4, 5, 6], 8, rid="starved")])
    for e in pair:
        drive(e, [0.0, 0.1, 5.0])
    (jhog, jst), (hog, starved) = reqs
    assert starved.state is RequestState.FAILED
    assert starved.shed_reason == "queue-deadline"
    assert starved.error == "shed: queue-deadline"
    assert hog.state is not RequestState.FAILED
    assert outcomes([hog, starved]) == outcomes([jhog, jst])
    jrec, trec = _both(pair, typed_records)
    assert trec == jrec == [{"kind": "shed", "request": "starved",
                             "reason": "queue-deadline",
                             "state": "queued"}]


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_expiry_in_flight_aborts_and_returns_pages(model, phase):
    """Mirrors test_expiry_in_flight_aborts_and_returns_pages."""
    pair = engines(model, n_slots=1, n_pages=4, max_seq_len=32,
                   deadline_s=2.0)
    reqs = _both(pair, lambda e: [
        e.submit(list(range(1, 17)), 12, rid="victim"),
        e.submit([7, 8, 9], 4, rid="heir", deadline_s=100.0)])
    warm = [0.0, 0.1] if phase == "prefill" else 7 * [0.1]
    for e, (victim, heir) in zip(pair, reqs):
        drive(e, warm)
        assert victim.state.value == phase
        drive(e, [9.0])
        assert victim.state.value == "failed"
        assert victim.shed_reason == "total-deadline"
        assert victim.slot is None
        drive(e, [9.0 + 0.01 * i for i in range(1, 30)])
        assert heir.state.value == "completed"
        assert e.cache.pool.free_pages == e.cache.pool.n_pages
        s = e.summary(record=False)
        assert s["requests_shed"] == 1
        assert s["shed_by_reason"] == {"total-deadline": 1}
        assert s["requests_failed"] == 0
    assert outcomes(reqs[1]) == outcomes(reqs[0])


def test_deadline_survives_migration(model):
    """Mirrors test_deadline_survives_migration: a drained request keeps
    its arrival clock and budgets on the destination."""
    solo = engines(model)
    refs = _both(solo, lambda e: e.submit([1, 2, 3, 4, 5], 12, rid="keep",
                                          seed=3))
    for e in solo:
        run_sim(e)
    src = engines(model, replica="a")
    dst = engines(model, replica="b")
    got = []
    for s, d in zip(src, dst):
        keep = s.submit([1, 2, 3, 4, 5], 12, rid="keep", seed=3,
                        deadline_s=50.0)
        doomed = s.submit([9, 9, 9], 12, rid="doomed", deadline_s=5.0)
        drive(s, [0.0, 0.1, 0.2, 0.3])
        assert keep.generated and doomed.generated
        moved = s.drain()
        assert {r.rid for r in moved} == {"keep", "doomed"}
        s.clear_cache()
        for r in moved:
            d.enqueue(r, force=True)
        drive(d, [6.0 + 0.01 * i for i in range(40)])
        assert doomed.shed_reason == "total-deadline"
        assert keep.state.value == "completed" and keep.migrations == 1
        assert d.cache.pool.free_pages == d.cache.pool.n_pages
        got.append(outcomes([keep, doomed]))
    assert got[1] == got[0]
    assert got[1][0][3] == refs[1].generated == refs[0].generated


# ---------------------------------------------------------------------------
# bounded admission + priority (test_overload.py :187-238, :297-335)
# ---------------------------------------------------------------------------

def test_arrived_submission_rejected_when_queue_full(model):
    """Mirrors test_arrived_submission_rejected_when_queue_full."""
    shed0 = registry().counter("serve_rejected_total").value
    jeng, eng = engines(model, max_queue=2)
    jreqs = [jeng.submit([1 + i, 2], 4, rid=f"r{i}") for i in range(4)]
    reqs = [eng.submit([1 + i, 2], 4, rid=f"r{i}") for i in range(4)]
    rejected = [r for r in reqs if r.shed_reason == "queue-full"]
    assert len(rejected) == 2
    assert all(r.error == "rejected: queue-full" for r in rejected)
    assert registry().counter("serve_rejected_total").value == shed0 + 2
    run_sim(jeng)
    run_sim(eng)
    assert sum(r.state is RequestState.COMPLETED for r in reqs) == 2
    assert outcomes(reqs) == outcomes(jreqs)


def test_overflow_trim_sheds_batch_newest_first(model, tmp_path):
    """Mirrors test_overflow_trim_sheds_batch_newest_first."""
    pair = engines(model, tmp_path=tmp_path, n_slots=1, max_queue=2)
    reqs = _both(pair, lambda e: [
        e.submit([1 + i, 2], 4, rid=f"r{i}", arrival_s=1.0,
                 priority="batch" if i >= 2 else "interactive")
        for i in range(5)])
    assert all(r.shed_reason is None for r in reqs[1])
    for e in pair:
        drive(e, [2.0])
    shed = {r.rid: r.shed_reason for r in reqs[1] if r.shed_reason}
    assert shed == {"r4": "queue-full", "r3": "queue-full"}
    assert outcomes(reqs[1]) == outcomes(reqs[0])
    jrec, trec = _both(pair, typed_records)
    assert trec == jrec and [r["request"] for r in trec] == ["r4", "r3"]


def test_interactive_jumps_queued_batch_at_admission(model):
    """Mirrors test_interactive_jumps_queued_batch_at_admission."""
    orders = []
    for e in engines(model, n_slots=1):
        reqs = [e.submit([1, 2], 3, rid="b1", priority="batch"),
                e.submit([2, 3], 3, rid="b2", priority="batch"),
                e.submit([3, 4], 3, rid="i1")]
        order = []
        while not e.sched.idle():
            drive(e, [0.0])
            order += [r.rid for r in reqs
                      if r.slot is not None and r.rid not in order]
        orders.append(order)
    assert orders[1] == orders[0] == ["i1", "b1", "b2"]


def test_migrated_request_exempt_from_queue_bound(model):
    """Mirrors test_migrated_request_exempt_from_queue_bound: a
    force-enqueued migrated request is never trimmed by the
    destination's bound and decodes the solo run's tokens."""
    solo = engines(model)
    refs = _both(solo, lambda e: e.submit([1, 2, 3, 4, 5], 10, rid="mig",
                                          seed=5))
    for e in solo:
        run_sim(e)
    src = engines(model, replica="a")
    dst = engines(model, n_slots=1, max_queue=1, replica="b")
    got = []
    for s, d, ref in zip(src, dst, refs):
        mig = s.submit([1, 2, 3, 4, 5], 10, rid="mig", seed=5)
        drive(s, [0.0, 0.1, 0.2])
        s.drain()
        s.clear_cache()
        resident = d.submit([9, 8, 7], 20, rid="res")
        local = d.submit([6, 6], 4, rid="loc", arrival_s=0.05)
        d.enqueue(mig, force=True)
        drive(d, [0.3 + 0.01 * i for i in range(80)])
        assert mig.shed_reason is None
        assert mig.generated == ref.generated
        got.append(outcomes([mig, resident, local]))
    assert all(o[1] == "completed" for o in got[1])
    assert got[1] == got[0]


def test_priority_validation(model):
    """Mirrors test_priority_validation."""
    for e in engines(model):
        with pytest.raises(ValueError, match="priority"):
            e.submit([1, 2], 4, priority="urgent")
        with pytest.raises(ValueError, match="queue_budget_s"):
            e.submit([1, 2], 4, queue_budget_s=0.0)


# ---------------------------------------------------------------------------
# circuit breaker and brownout (test_overload.py :238-268, :399-496)
# ---------------------------------------------------------------------------

def test_circuit_breaker_cycle():
    """Mirrors test_circuit_breaker_cycle; the transitions equal JAX's."""
    trails = []
    for B in (JBreaker, CircuitBreaker):
        brk = B(threshold=3, cooldown_rounds=5)
        for rnd in range(2):
            brk.note("r1", False, rnd)
            assert brk.state("r1") == "closed"
        brk.note("r1", False, 2)
        assert brk.state("r1") == "open" and brk.opens == 1
        assert not brk.allows("r1", 3)
        assert brk.allows("r1", 7) and brk.state("r1") == "half-open"
        brk.note("r1", False, 7)
        assert brk.state("r1") == "open" and brk.opens == 2
        assert brk.allows("r1", 12)
        brk.note("r1", True, 12)
        assert brk.state("r1") == "closed"
        trails.append(brk.drain_transitions())
        assert brk.drain_transitions() == []
    assert [t["state"] for t in trails[1]] == [
        "open", "half-open", "open", "half-open", "closed"]
    assert trails[1] == trails[0]


def test_brownout_ladder_walks_up_and_back():
    """Mirrors test_brownout_ladder_walks_up_and_back."""
    trails = []
    for B, S in ((JBrownout, JServe), (BrownoutController, ServeConfig)):
        bo = B(S(brownout=True, brownout_ttft_target_s=0.1,
                 brownout_budget=0.25, brownout_window_s=1.0,
                 brownout_hold_iters=1))
        for i in range(8):
            bo.observe_completed(1.0, 0.1 * i)
        moves = [bo.tick(0.8 + 0.01 * i) for i in range(5)]
        assert not bo.spec_enabled and not bo.prefill_full_share
        assert bo.max_new_cap == 32
        moves += [bo.tick(30.0 + i) for i in range(6)]
        assert bo.level == 0 and bo.max_level_seen == 3
        trails.append([m for m in moves if m])
    assert [(t["direction"], t["level"]) for t in trails[1]] == [
        ("degrade", 1), ("degrade", 2), ("degrade", 3),
        ("recover", 2), ("recover", 1), ("recover", 0)]
    assert trails[1] == trails[0]


def test_brownout_clamp_is_bitwise_prefix(model, tmp_path):
    """Mirrors test_brownout_clamp_is_bitwise_prefix: level 3 held for
    the run, every admission clamped to a prefix of its unclamped
    stream."""
    plain = engines(model)
    refs = _both(plain, lambda e: [e.submit([1 + i, 2, 3], 12, rid=f"r{i}",
                                            seed=i) for i in range(4)])
    for e in plain:
        run_sim(e)
    pair = engines(model, tmp_path=tmp_path, brownout=True,
                   brownout_ttft_target_s=1e-4, brownout_window_s=0.5,
                   brownout_hold_iters=1, brownout_max_new=4)
    got = []
    for e, ref in zip(pair, refs):
        e.brownout.level = e.brownout.max_level_seen = 3
        e.brownout._last_move = 10 ** 9
        reqs = [e.submit([1 + i, 2, 3], 12, rid=f"r{i}", seed=i)
                for i in range(4)]
        run_sim(e)
        for r, rr in zip(reqs, ref):
            assert r.state.value == "completed"
            assert r.max_new_requested == 12 and len(r.generated) <= 4
            assert r.generated == rr.generated[:len(r.generated)]
        assert e.summary(record=False)["brownout"]["max_level_seen"] == 3
        got.append(outcomes(reqs))
    assert got[1] == got[0]
    assert outcomes(refs[1]) == outcomes(refs[0])


def test_brownout_fires_on_engine_and_records(model, tmp_path):
    """Mirrors test_brownout_fires_on_engine_and_records: a burst against
    an unreachable TTFT target fires the ladder (spec turned off on the
    way) without changing a token; the ladder's records equal JAX's."""
    plain = engines(model, n_slots=2)
    refs = _both(plain, lambda e: [e.submit([1 + i, 3], 10, rid=f"r{i}",
                                            seed=i) for i in range(8)])
    for e in plain:
        run_sim(e)
    pair = engines(model, tmp_path=tmp_path, n_slots=2, spec_k=4,
                   brownout=True, brownout_ttft_target_s=1e-4,
                   brownout_window_s=2.0, brownout_hold_iters=1)
    reqs = _both(pair, lambda e: [e.submit([1 + i, 3], 10, rid=f"r{i}",
                                           seed=i) for i in range(8)])
    for e in pair:
        run_sim(e)
    jrec, trec = _both(pair, typed_records)
    assert trec and max(r["level"] for r in trec) >= 1
    assert pair[1].brownout.max_level_seen >= 1
    assert trec == jrec
    for r, ref in zip(reqs[1], refs[1]):
        assert r.generated == ref.generated
    assert outcomes(reqs[1]) == outcomes(reqs[0])


def test_statusz_provider_carries_overload_fields(model):
    """Mirrors test_statusz_provider_carries_overload_fields."""
    for e in engines(model, max_queue=1, brownout=True):
        e.submit([1, 2], 4, rid="a")
        e.submit([2, 3], 4, rid="b")
        status = e._status()
        assert status["requests_rejected"] == 1
        assert status["requests_shed"] == 1
        assert status["shed_by_reason"] == {"queue-full": 1}
        assert status["brownout_level"] == 0
        assert status["max_queue"] == 1


def test_warmup_is_inert(model):
    """``warmup`` runs every step once (the spec ladder's widths too) and
    leaves nothing behind: the pool is free, the tables are zero, no stat
    moved, and the engine then decodes the JAX engine's tokens."""
    jeng, eng = engines(model, spec_k=3)
    eng.warmup()
    assert eng.cache.pool.free_pages == eng.cache.pool.n_pages
    assert not eng._tables_np.any()
    assert eng._iterations == eng._decode_steps == 0
    reqs = _both((jeng, eng), lambda e: [
        e.submit(p, g, seed=i, rid=f"r{i}")
        for i, (p, g) in enumerate(zip([[1, 2, 3] * 4, [7] * 6],
                                       [16, 12]))])
    for e in (jeng, eng):
        run_sim(e)
    assert outcomes(reqs[1]) == outcomes(reqs[0])
