"""The port's crash flight recorder held against the JAX package's: the
record tee into a bounded ring, no tee and no dump without a recorder,
the bundle's files and keys, the serving journal's tail in the bundle,
the unhandled-exception hook, the environment opt-in, and the triggers —
a killed port engine (``"replica-crashed"``), a port engine whose loop
dies (``"engine-killed"``) and a port fleet whose loop dies
(``"fleet-killed"``) each leave a bundle with the same top-level files and
manifest keys as the JAX one's.

Each case mirrors the named case of ``tests/test_flightrec.py`` or
``tests/test_journal.py:350``."""

import json
import os
import sys

import pytest
import torch

from _torch_serve_util import engines, fleet, model as _model
from distributed_model_parallel_tpu.serve import journal as jjournal
from distributed_model_parallel_tpu.utils import flightrec as jflightrec
from distributed_model_parallel_tpu.utils import telemetry as jtelemetry
from distributed_model_parallel_tpu_torch.serve import journal as tjournal
from distributed_model_parallel_tpu_torch.serve.engine import EngineKilled
from distributed_model_parallel_tpu_torch.utils import flightrec, telemetry

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

PAIRS = ((jflightrec, jtelemetry, jjournal), (flightrec, telemetry, tjournal))


@pytest.fixture(autouse=True)
def _clean_recorders():
    for mod, *_ in PAIRS:
        mod.uninstall()
    yield
    for mod, *_ in PAIRS:
        mod.uninstall()
        mod.uninstall_excepthook()


@pytest.fixture(scope="module")
def model():
    return _model()


def _bundle(path) -> dict:
    return {name: open(os.path.join(path, name)).read()
            for name in sorted(os.listdir(path))}


def _run(tel, path):
    return tel.TelemetryRun(str(path), run="t", track_compiles=False,
                            device={"platform": "cpu"})


def _shape(path) -> dict:
    """A bundle's comparable shape: its files, the manifest's keys and
    reason, each JSON file's null-or-type, the records' kinds."""
    files = _bundle(path)
    manifest = json.loads(files["manifest.json"])
    return {
        "files": sorted(files),
        "manifest_keys": sorted(manifest),
        "reason": manifest["reason"],
        "listed": manifest["files"],
        "health": json.loads(files["health.json"]) is None,
        "journal": (None if json.loads(files["journal.json"]) is None
                    else sorted(json.loads(files["journal.json"]))),
        "kinds": [json.loads(ln)["kind"]
                  for ln in files["records.jsonl"].splitlines()],
    }


# ---------------------------------------------------------------------------
# the ring tee, the no-op contract (test_flightrec.py:33-55)
# ---------------------------------------------------------------------------

def test_telemetry_records_tee_into_bounded_ring(tmp_path):
    rec = flightrec.install(flightrec.FlightRecorder(
        dir=str(tmp_path / "pm"), capacity=4))
    run = _run(telemetry, tmp_path / "r.jsonl")
    for i in range(10):
        run.record("event", message=f"m{i}")
    assert len(rec) == 4
    assert [r["message"] for r in rec.records()] == ["m6", "m7", "m8", "m9"]
    with pytest.raises(ValueError, match="capacity"):
        flightrec.FlightRecorder(capacity=0)


def test_no_recorder_means_no_tee_and_no_dump():
    assert flightrec.installed() is None
    assert telemetry.record_tap() is None
    assert flightrec.dump("anything") is None


# ---------------------------------------------------------------------------
# bundle contents (test_flightrec.py:62-107, test_journal.py:350)
# ---------------------------------------------------------------------------

def _dump_with_error(fr, tel, tmp_path, tag):
    fr.install(fr.FlightRecorder(dir=str(tmp_path / tag / "pm"),
                                 capacity=8))
    run = _run(tel, tmp_path / tag / "r.jsonl")
    run.failure("pre-crash", detail="context")
    try:
        raise ValueError("the failing thing")
    except ValueError as e:
        path = fr.dump("test-crash", telemetry_run=run, error=e)
    return path, run


def test_dump_postmortem_bundle_contents(tmp_path):
    shapes = []
    for (fr, tel, _), tag in zip(PAIRS, ("jax", "port")):
        path, run = _dump_with_error(fr, tel, tmp_path, tag)
        shapes.append(_shape(path))
        fr.uninstall()
    assert shapes[1] == shapes[0]
    files = _bundle(path)
    assert json.loads(files["journal.json"]) is None
    manifest = json.loads(files["manifest.json"])
    assert "ValueError: the failing thing" in manifest["error"]
    assert "ValueError: the failing thing" in files["stacks.txt"]
    assert "MainThread" in files["stacks.txt"]
    assert json.loads(files["memory.json"]) is None   # no card here
    pm = [r for r in telemetry.read_records(run.path)
          if r["kind"] == "postmortem"]
    assert len(pm) == 1 and pm[0]["bundle"] == path
    assert pm[0]["reason"] == "test-crash"


def test_dump_uses_installed_recorder_dir(tmp_path):
    flightrec.install(flightrec.FlightRecorder(dir=str(tmp_path / "pm")))
    path = flightrec.dump("r1")
    assert path is not None and path.startswith(str(tmp_path / "pm"))
    path2 = flightrec.dump("r1")
    assert path2 is not None and path2 != path
    assert flightrec.installed().dumps == [path, path2]


class _Req:
    def __init__(self, rid):
        self.rid, self.trace_id, self.prompt, self.seed = rid, None, [1], 0
        self.max_new_tokens, self.priority = 4, "interactive"
        self.queue_budget_s = self.deadline_s = None
        self.arrival_s = 0.0


def test_postmortem_bundle_carries_journal_tail(tmp_path):
    payloads = []
    for (fr, _, jr), tag in zip(PAIRS, ("jax", "port")):
        j = jr.RequestJournal(str(tmp_path / tag / "j.jsonl"))
        j.intent(_Req("a"))
        j.terminal("a", "completed")
        jr.install(j)
        try:
            bundle = fr.dump_postmortem(str(tmp_path / tag / "pm"), "drill",
                                        records=[])
        finally:
            jr.install(None)
        payload = json.loads(open(f"{bundle}/journal.json").read())
        assert payload["path"] == j.path
        payload.pop("path")
        payload["position"].pop("bytes")      # the lines' ts widths differ
        payload["tail"] = [{k: v for k, v in json.loads(ln).items()
                            if k != "ts"} for ln in payload["tail"]]
        payloads.append(payload)
        manifest = json.loads(open(f"{bundle}/manifest.json").read())
        assert "journal.json" in manifest["files"]
    assert payloads[1] == payloads[0]
    assert payloads[1]["position"]["records"] == 2
    assert payloads[1]["tail"][-1]["kind"] == "terminal"


# ---------------------------------------------------------------------------
# the serving triggers (test_flightrec.py:141, the fleet's "fleet-killed")
# ---------------------------------------------------------------------------

def _dies(iteration):
    if iteration >= 2:
        raise RuntimeError("chaos kill")


def test_engine_killed_dumps_postmortem(model, tmp_path):
    """A port engine whose loop dies leaves an ``engine-killed`` bundle
    shaped as the JAX engine's."""
    shapes = []
    for (fr, tel, _), eng in zip(PAIRS, engines(model, tmp_path=tmp_path,
                                                name="killed",
                                                step_hook=_dies)):
        rec = fr.install(fr.FlightRecorder(dir=str(tmp_path / "pm")))
        eng.submit([1, 2, 3], 8)
        eng.submit([4, 5], 8)
        with pytest.raises(Exception) as e:
            eng.run()
        assert type(e.value).__name__ == "EngineKilled"
        assert len(rec.dumps) == 1
        shape = _shape(rec.dumps[0])
        assert "chaos kill" in json.loads(
            _bundle(rec.dumps[0])["manifest.json"])["error"]
        assert any(r["kind"] == "postmortem"
                   for r in tel.read_records(eng.telemetry.path))
        shapes.append(shape)
        fr.uninstall()
    assert isinstance(e.value, EngineKilled)
    assert shapes[1] == shapes[0]
    assert shapes[1]["reason"] == "engine-killed"


def test_engine_kill_dumps_replica_crashed(model, tmp_path):
    """``Engine.kill`` (the hard crash) leaves a ``replica-crashed``
    bundle with the journal's tail, shaped as the JAX engine's."""
    shapes = []
    pair = engines(model, tmp_path=tmp_path, name="crash", journal_every=4,
                   replica="r0")
    for (fr, tel, jr), eng in zip(PAIRS, pair):
        rec = fr.install(fr.FlightRecorder(dir=str(tmp_path / "pm")))
        jr.install(eng.journal)
        try:
            eng.journal.intent(eng.submit([1, 2, 3], 8, rid="a"))
            eng.run(max_iterations=3)
            eng.kill()
        finally:
            jr.install(None)
        [path] = rec.dumps
        shapes.append(_shape(path))
        recs = tel.read_records(eng.telemetry.path)
        assert [r["error"] for r in recs
                if r["kind"] == "failure"] == ["replica-crashed"]
        fr.uninstall()
    assert shapes[1] == shapes[0]
    assert shapes[1]["reason"] == "replica-crashed"
    assert shapes[1]["journal"] == ["path", "position", "tail"]


def test_fleet_killed_dumps_postmortem(model, tmp_path):
    """A port fleet whose loop dies fails its requests typed and leaves a
    ``fleet-killed`` bundle shaped as the JAX fleet's."""
    shapes, errors = [], []
    for (fr, tel, _), tag in zip(PAIRS, ("jax", "port")):
        rec = fr.install(fr.FlightRecorder(dir=str(tmp_path / tag / "pm")))
        f = fleet(tag, model, tmp_path=tmp_path, name="dies",
                  step_hook=_dies)
        reqs = [f.submit([1 + i, 2, 3], 8, rid=f"d{i}") for i in range(3)]
        with pytest.raises(Exception) as e:
            f.run()
        f.close()
        assert type(e.value).__name__ == "EngineKilled"
        [path] = rec.dumps
        shapes.append(_shape(path))
        errors.append([(r.state.value, r.error) for r in reqs])
        fr.uninstall()
    assert shapes[1] == shapes[0] and errors[1] == errors[0]
    assert shapes[1]["reason"] == "fleet-killed"
    assert all(s == "failed" and "chaos kill" in err for s, err in errors[1])


# ---------------------------------------------------------------------------
# the entry points' hook and the opt-in (test_flightrec.py:169-222)
# ---------------------------------------------------------------------------

def test_excepthook_writes_failure_closes_streams_and_dumps(tmp_path):
    flightrec.install(flightrec.FlightRecorder(dir=str(tmp_path / "pm")))
    run = _run(telemetry, tmp_path / "r.jsonl")
    chained = []
    prev = sys.excepthook
    sys.excepthook = lambda *a: chained.append(a)
    try:
        flightrec.install_excepthook()
        flightrec.install_excepthook()           # idempotent
        try:
            raise RuntimeError("entry point died")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
    finally:
        flightrec.uninstall_excepthook()
        sys.excepthook = prev
    assert len(chained) == 1
    kinds = [r["kind"] for r in telemetry.read_records(run.path)]
    assert "failure" in kinds and "postmortem" in kinds
    assert kinds[-1] == "run_end"
    fail = next(r for r in telemetry.read_records(run.path)
                if r["kind"] == "failure")
    assert fail["error"] == "unhandled-exception"
    assert "entry point died" in fail["detail"]


def test_install_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("DMP_FLIGHT_RECORDER", raising=False)
    assert flightrec.install_from_env() is None
    assert flightrec.installed() is None
    monkeypatch.setenv("DMP_FLIGHT_RECORDER", str(tmp_path / "bundles"))
    monkeypatch.setenv("DMP_FLIGHT_RECORDER_CAPACITY", "16")
    rec = flightrec.install_from_env()
    assert rec is flightrec.installed() and rec.capacity == 16
    assert rec.dir == str(tmp_path / "bundles")
    monkeypatch.setenv("DMP_FLIGHT_RECORDER", "1")
    assert flightrec.install_from_env().dir == flightrec.DEFAULT_DIR
