"""The port's write-ahead request journal held against the JAX package's:
the same event sequence through both journals writes the same records
(apart from ``ts``), folds alike, skips and truncates a torn tail alike,
and rotates and resumes alike; with speculative decoding on, no
watermark passes what the model committed; and a hard kill, a fold of
the journal and replay re-admission on a fresh engine give the
uninterrupted run's greedy tokens, which are the JAX engine's.

Each case mirrors the named case of ``tests/test_journal.py``."""

import json

import pytest
import torch

from _torch_serve_util import (
    GENS,
    PROMPTS,
    engines,
    model as _model,
)
from distributed_model_parallel_tpu.serve import journal as jjournal
from distributed_model_parallel_tpu_torch.serve import journal as tjournal
from distributed_model_parallel_tpu_torch.serve.engine import (
    Engine,
    ServeConfig,
)
from distributed_model_parallel_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
)
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    read_records,
    registry,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

MODULES = (jjournal, tjournal)


@pytest.fixture(scope="module")
def model():
    return _model()


class _Req:
    """Minimal intent-shaped stand-in (test_journal.py's)."""

    def __init__(self, rid, prompt=(1, 2, 3), seed=0):
        self.rid = rid
        self.trace_id = f"t-{rid}"
        self.prompt = list(prompt)
        self.seed = seed
        self.max_new_tokens = 8
        self.priority = "interactive"
        self.queue_budget_s = None
        self.deadline_s = None
        self.arrival_s = 0.0


def _records(path) -> list:
    """Every record of a journal (all parts), ``ts`` removed."""
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in read_records(path)]


def _paths(tmp_path, name="j.jsonl"):
    return [str(tmp_path / tag / name) for tag in ("jax", "port")]


# ---------------------------------------------------------------------------
# record round-trip + exactly-once accounting (test_journal.py :101-143)
# ---------------------------------------------------------------------------

def test_intent_watermark_terminal_roundtrip(tmp_path):
    """Mirrors test_intent_watermark_terminal_roundtrip."""
    for mod, path in zip(MODULES, _paths(tmp_path)):
        j = mod.RequestJournal(path, watermark_every=4)
        assert j.intent(_Req("a", prompt=[5, 6], seed=7))
        assert j.intent(_Req("b"))
        assert not j.intent(_Req("a"))
        j.commit("a", [1, 2, 3])
        assert j.state().tokens["a"] == []
        j.commit("a", [4])
        assert j.state().tokens["a"] == [1, 2, 3, 4]
        j.commit("a", [9, 9])
        assert j.terminal("a", "completed")
        st = mod.fold(path)
        assert st.tokens["a"] == [1, 2, 3, 4, 9, 9]
        assert st.intents["a"]["prompt"] == [5, 6]
        assert st.intents["a"]["seed"] == 7
        assert st.intents["a"]["trace"] == "t-a"
        assert st.terminals == {"a": "completed"}
        assert st.pending() == ["b"]
        j.close()
    jrec, trec = map(_records, _paths(tmp_path))
    assert [r["kind"] for r in trec] == [
        "intent", "intent", "watermark", "watermark", "terminal"]
    assert trec == jrec


def test_terminal_exactly_once_and_unknown_rid(tmp_path):
    """Mirrors test_terminal_exactly_once_and_unknown_rid."""
    for mod, path in zip(MODULES, _paths(tmp_path)):
        j = mod.RequestJournal(path)
        j.intent(_Req("a"))
        assert j.terminal("a", "completed")
        assert not j.terminal("a", "failed")
        assert not j.terminal("ghost", "completed")
        assert j.is_terminal("a") and not j.is_terminal("ghost")
        with pytest.raises(ValueError):
            j.terminal("a", "evaporated")
        assert mod.fold(path).terminals == {"a": "completed"}
        j.commit("a", list(range(1, 10)))
        assert mod.fold(path).tokens["a"] == []
        j.close()
    jrec, trec = map(_records, _paths(tmp_path))
    assert trec == jrec


# ---------------------------------------------------------------------------
# torn tail, rotation (test_journal.py :145-200)
# ---------------------------------------------------------------------------

def test_torn_tail_skipped_counted_and_truncated(tmp_path):
    """Mirrors test_torn_tail_skipped_counted_and_truncated."""
    whole = json.dumps({"ts": 0.0, "kind": "terminal", "rid": "b",
                        "outcome": "completed"})
    for mod, path in zip(MODULES, _paths(tmp_path)):
        j = mod.RequestJournal(path, watermark_every=2)
        j.intent(_Req("a"))
        j.commit("a", [1, 2])
        j.terminal("a", "completed")
        j.intent(_Req("b"))
        j.close()
        with open(path, "a") as f:
            f.write(whole[:len(whole) // 2])
    jpath, tpath = _paths(tmp_path)
    # The port counts the tear on its own registry.
    before = registry().counter("telemetry_torn_lines").value
    j2 = tjournal.RequestJournal(tpath)
    assert registry().counter("telemetry_torn_lines").value > before
    jj2 = jjournal.RequestJournal(jpath)
    for j in (jj2, j2):
        st = j.state()
        assert st.tokens["a"] == [1, 2]
        assert st.terminals == {"a": "completed"}
        assert st.pending() == ["b"]
        assert j.terminal("b", "failed")
    assert tjournal.fold(tpath).terminals == {"a": "completed",
                                              "b": "failed"}
    with open(tpath) as f:
        for line in f:
            json.loads(line)
    assert _records(tpath) == _records(jpath)


def test_rotation_folds_across_parts_and_reopen_resumes(tmp_path):
    """Mirrors test_rotation_folds_across_parts_and_reopen_resumes; the
    parts hold the same records as JAX's."""
    rids = [f"r{i}" for i in range(8)]
    positions = []
    for mod, path in zip(MODULES, _paths(tmp_path)):
        j = mod.RequestJournal(path, watermark_every=1, max_bytes=256)
        for i, rid in enumerate(rids):
            j.intent(_Req(rid, seed=i))
            j.commit(rid, [i, i + 1])
        for rid in rids[:4]:
            j.terminal(rid, "completed")
        positions.append(j.position()["parts"])
        st = mod.fold(path)
        assert set(st.intents) == set(rids)
        assert all(st.tokens[r] == [i, i + 1] for i, r in enumerate(rids))
        assert st.pending() == rids[4:]
        j2 = mod.RequestJournal(path)
        assert not j2.intent(_Req("r0"))
        assert not j2.terminal("r0", "failed")
        assert j2.terminal("r5", "shed")
        assert mod.fold(path).terminals["r5"] == "shed"
        j2.close()
    assert positions[1] == positions[0] > 1
    jpath, tpath = _paths(tmp_path)
    assert ([_records(p) for p in tjournal.stream_parts(tpath)]
            == [_records(p) for p in jjournal.stream_parts(jpath)])


# ---------------------------------------------------------------------------
# the engine's watermarks, spec decoding on (test_journal.py :206-242)
# ---------------------------------------------------------------------------

def test_watermark_never_passes_committed_with_spec_decoding(model,
                                                             tmp_path):
    """Mirrors test_watermark_never_passes_committed_with_spec_decoding:
    every journaled watermark is a prefix of what the model finally
    committed, and both engines journal the same records."""
    pair = engines(model, tmp_path=tmp_path, journal_every=2, sim=False,
                   spec_k=3)
    for e in pair:
        reqs = [e.submit([1, 2, 3] * 4, 24, seed=0, rid="loop"),
                e.submit([7] * 6, 20, seed=1, rid="flat")]
        for r in reqs:
            e.journal.intent(r)
        e.run()
        assert all(r.state.value == "completed" for r in reqs)
        assert e._draft_proposed > 0
        final = {r.rid: list(r.generated) for r in reqs}
        seen = {r.rid: [] for r in reqs}
        n = 0
        for rec in read_records(e.journal.path):
            if rec["kind"] != "watermark":
                continue
            n += 1
            cum = seen[rec["rid"]]
            cum.extend(rec["tokens"])
            assert rec["committed"] == len(cum)
            assert cum == final[rec["rid"]][:len(cum)]
        assert n > 0
        assert tjournal.fold(e.journal.path).tokens == final
    jrec, trec = (_records(e.journal.path) for e in pair)
    strip = [{k: v for k, v in r.items() if k != "trace"} for r in trec]
    assert strip == [{k: v for k, v in r.items() if k != "trace"}
                     for r in jrec]


# ---------------------------------------------------------------------------
# kill, fold, replay (the fleet's crash recovery, by hand)
# ---------------------------------------------------------------------------

def replay_requests(state) -> list:
    """A fresh :class:`Request` per pending intent of a folded journal:
    its committed tokens are the journal's watermarks, and a request with
    any replays them (prefill over prompt + tokens, the last re-sampled
    and checked)."""
    out = []
    for rid in state.pending():
        it = state.intents[rid]
        req = Request(rid=rid, prompt=list(it["prompt"]),
                      max_new_tokens=int(it["max_new_tokens"]),
                      arrival_s=0.0, seed=int(it["seed"]),
                      priority=it["priority"],
                      queue_budget_s=it["queue_budget_s"],
                      deadline_s=it["deadline_s"], tenant=it["tenant"])
        req.trace_id = it.get("trace")
        req.generated = list(state.tokens.get(rid, []))
        req.replay = bool(req.generated)
        out.append(req)
    return out


@pytest.mark.parametrize("spec_k", [0, 3])
def test_kill_fold_replay_matches_uninterrupted_run(model, tmp_path,
                                                    spec_k):
    """A journaled engine killed mid-run (no drain, no terminal), its
    journal folded and every pending intent re-admitted as a replay on a
    fresh engine: no accepted request is lost, each intent gets exactly
    one terminal, and every token equals the uninterrupted run's — which
    equals the JAX engine's."""
    _, tcfg, _, tp = model
    ref = engines(model, sim=False, spec_k=spec_k)
    refs = []
    for e in ref:
        refs.append([e.submit(p, g, seed=i, rid=f"req-{i}")
                     for i, (p, g) in enumerate(zip(PROMPTS, GENS))])
        e.run()
    want = {r.rid: r.generated for r in refs[1]}
    assert want == {r.rid: r.generated for r in refs[0]}

    path = str(tmp_path / "j.jsonl")
    serve = ServeConfig(n_slots=2, page_size=8, n_pages=32, max_seq_len=64,
                        prefill_chunk=4, spec_k=spec_k)
    j = tjournal.RequestJournal(path, watermark_every=3)
    eng = Engine(tp, tcfg, serve, device="cpu", journal=j)
    for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
        j.intent(eng.submit(p, g, seed=i, rid=f"req-{i}"))
    eng.run(max_iterations=9)
    eng.kill()
    done_before = {r.rid for r in eng.results() if r.done}
    assert len(done_before) < len(PROMPTS), "the kill must land mid-run"

    st = tjournal.fold(path)
    assert set(st.intents) == {f"req-{i}" for i in range(len(PROMPTS))}
    assert set(st.terminals) == done_before
    lost = replay_requests(st)
    assert any(r.replay for r in lost), "no request had a watermark"
    fresh = Engine(tp, tcfg, serve, device="cpu",
                   journal=tjournal.RequestJournal(path, watermark_every=3))
    for r in lost:
        fresh.enqueue(r, force=True)
    fresh.run()
    fresh.journal.close()
    assert all(r.state is RequestState.COMPLETED for r in lost)
    got = {r.rid: r.generated for r in eng.results() if r.done}
    got.update({r.rid: r.generated for r in lost})
    assert got == want
    final = tjournal.fold(path)
    assert final.pending() == []
    terminals = [r["rid"] for r in read_records(path)
                 if r["kind"] == "terminal"]
    assert sorted(terminals) == sorted(want)
    assert final.tokens == want
