"""The port's telemetry layer held against the JAX package's: the metrics
registry's snapshot and its Prometheus text after the same sequence of
counter, gauge and histogram calls; the event stream's records, rotation
parts and torn-tail handling; the stream merge; the live follower across
rotation; the collective byte model; and the torch-side device probes
(``torch`` in the ``run_start`` header where JAX writes ``jax``; no
compile listener in eager PyTorch).

The registry cases mirror ``tests/test_telemetry.py`` :40-100, the
stream cases :205-300 and :455-569."""

import os

import pytest

from distributed_model_parallel_tpu.utils import statusz as jstatusz
from distributed_model_parallel_tpu.utils import telemetry as jtel
from distributed_model_parallel_tpu_torch.utils import statusz as tstatusz
from distributed_model_parallel_tpu_torch.utils import telemetry as ttel

pytestmark = pytest.mark.torch_port

BOTH = (jtel, ttel)


@pytest.fixture
def fresh_registries(monkeypatch):
    """Each package's process registry swapped for an empty one for the
    test (the renderers read ``registry()``)."""
    for mod in BOTH:
        monkeypatch.setattr(mod, "_default_registry", mod.MetricsRegistry())


def _calls(tel):
    """One sequence of registry calls, against ``tel``'s registry."""
    reg = tel.registry()
    c = reg.counter("serve_shed_total")
    c.inc()
    c.inc(2.5)
    reg.counter("bytes", axis="data").inc(10)
    reg.counter("bytes", axis="stage").inc(20)
    with tel.tenant_scope("ten0"):
        reg.counter("bytes", axis="data").inc(3)
    reg.gauge("serve_page_occupancy").set(0.4)
    reg.gauge("unset_gauge")
    h = reg.histogram("serve_ttft_s")
    for v, ex in ((0.05, "t-1"), (0.5, None), (0.5, "t-2"), (5.0, None)):
        h.observe(v, exemplar=ex)
    b = reg.histogram("bucketed", bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 99.0):
        b.observe(v, exemplar='tr"ace\\')
    reg.counter("labels", path='he said "hi"\nx').inc()
    tel.record_collective("psum", "data", 800, 8)
    tel.record_collective("ppermute", ("data", "seq"), 64, 4)


# ---------------------------------------------------------------------------
# the registry (test_telemetry.py :40-100)
# ---------------------------------------------------------------------------

def test_registry_snapshot_and_prometheus_text_match_jax(fresh_registries):
    """The same calls through both registries: equal snapshots (with and
    without a tenant) and byte-equal Prometheus text."""
    for tel in BOTH:
        _calls(tel)
    for tenant in (None, "ten0"):
        assert ttel.registry().snapshot(tenant=tenant) == \
            jtel.registry().snapshot(tenant=tenant)
    text = tstatusz.prometheus_text()
    assert text == jstatusz.prometheus_text()
    assert 'bytes{axis="data",tenant="ten0"} 3' in text
    assert 'serve_ttft_s_bucket{le="+Inf"} 4' in text


def test_counter_gauge_histogram_basics():
    """Mirrors test_counter_gauge_histogram_basics and
    test_histogram_single_sample_reports_sample."""
    for tel in BOTH:
        reg = tel.MetricsRegistry()
        c = reg.counter("steps")
        c.inc()
        c.inc(2.5)
        assert reg.counter("steps").value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        h = reg.histogram("t", bounds=[0.1, 1.0, 10.0])
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
        assert 0.1 <= h.snapshot()["p50"] <= 1.0
        with pytest.raises(tel.AlreadyRegisteredError):
            reg.gauge("steps")
        one = tel.Histogram(bounds=[1.0, 10.0])
        one.observe(3.0)
        assert one.percentile(50) == pytest.approx(3.0)


def test_wire_bytes_and_ops_estimates_match_jax():
    """Mirrors test_wire_bytes_estimates and
    test_record_collective_never_raises_on_tracers."""
    for kind in ("psum", "bucketed_psum", "reduce_scatter", "all_gather",
                 "all_to_all", "ppermute", "unknown"):
        for n in (1, 2, 8):
            assert ttel.wire_bytes_estimate(kind, 800, n) == \
                jtel.wire_bytes_estimate(kind, 800, n)
            assert ttel.wire_ops_estimate(kind, n) == \
                jtel.wire_ops_estimate(kind, n)

    class NotAnInt:
        def __int__(self):
            raise TypeError("not a size")

    ttel.record_collective("psum", "data", 100, NotAnInt())


# ---------------------------------------------------------------------------
# the stream (test_telemetry.py :205-300)
# ---------------------------------------------------------------------------

def _strip(records) -> list:
    """Records without their clock readings (``ts``, run_end's
    ``wall_s``); the run_start header without the framework version and
    device keys (the one listed difference)."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ts", "wall_s")}
        if r["kind"] == "run_start":
            for k in ("jax", "torch", "device"):
                r.pop(k, None)
        out.append(r)
    return out


def _long_run(tel, path):
    run = tel.TelemetryRun(path, run="long", track_compiles=False,
                           max_bytes=4096, registry_=tel.MetricsRegistry(),
                           device={"platform": "cpu"})
    for i in range(60):
        run.step(step=i, step_time_s=0.01, note="x—" * 40)
    run.failure("boom", detail="d")
    run.finish()
    return run


def test_rotation_parts_and_records_match_jax(tmp_path):
    """Mirrors test_stream_rotation_and_globbed_readback: both streams
    rotate into the same parts holding the same records."""
    paths = [str(tmp_path / tag / "run.jsonl") for tag in ("jax", "port")]
    for tel, path in zip(BOTH, paths):
        _long_run(tel, path)
    jparts, tparts = (tel.stream_parts(p) for tel, p in zip(BOTH, paths))
    assert len(tparts) == len(jparts) > 1
    assert all(os.path.getsize(p) <= 4096 for p in tparts[:-1])
    for jp, tp in zip(jparts, tparts):
        assert os.path.basename(jp) == os.path.basename(tp)
        assert _strip(ttel.read_records(tp)) == _strip(jtel.read_records(jp))
    records = ttel.read_records(paths[1])
    assert [r["step"] for r in records if r["kind"] == "step"] == \
        list(range(60))
    assert len(ttel.merge_streams(sorted(tparts))) == len(records)
    with pytest.raises(ValueError):
        ttel.TelemetryRun(str(tmp_path / "r.jsonl"), run="r",
                          track_compiles=False, max_bytes=100)


def test_torn_tail_matches_jax(tmp_path, capsys):
    """Mirrors test_read_records_skips_truncated_tail and
    test_torn_tail_counts_and_never_poisons_a_fleet_merge."""
    good = tmp_path / "good.jsonl"
    good.write_text('{"ts": 1, "kind": "run_start", "run": "a"}\n'
                    '{"ts": 2, "kind": "step", "step_time_s": 0.1}\n')
    torn = tmp_path / "torn.jsonl"
    torn.write_text('{"ts": 1, "kind": "run_start", "run": "b"}\n'
                    '{"ts": 3, "kind": "step", "step_time_s"')
    before = ttel.registry().counter("telemetry_torn_lines").value
    merged = ttel.merge_streams([str(good), str(torn)])
    assert len(merged) == 3
    assert ttel.registry().counter("telemetry_torn_lines").value == \
        before + 1
    assert "torn" in capsys.readouterr().err
    assert merged == jtel.merge_streams([str(good), str(torn)])
    assert ttel.read_records(str(torn)) == jtel.read_records(str(torn))


def test_follower_survives_rotation_mid_tail(tmp_path):
    """Mirrors test_follower_survives_rotation_mid_tail and
    test_follower_buffers_partial_line_until_complete."""
    path = str(tmp_path / "rot.jsonl")
    run = ttel.TelemetryRun(path, run="t", track_compiles=False,
                            device={"platform": "cpu"}, max_bytes=4096)
    f = ttel.StreamFollower(path)
    seen = []
    for i in range(60):
        run.record("event", message="x" * 120 + f"-{i}")
        if i % 5 == 0:
            seen += f.poll()
    seen += f.poll()
    nums = [int(r["message"].rsplit("-", 1)[1]) for r in seen
            if r["kind"] == "event"]
    assert nums == list(range(60))
    assert len(ttel.stream_parts(path)) >= 2
    part = str(tmp_path / "partial.jsonl")
    with open(part, "w") as fh:
        fh.write('{"kind": "event", "message": "whole"}\n'
                 '{"kind": "event", "mess')
    f = ttel.StreamFollower(part)
    assert [r["message"] for r in f.poll()] == ["whole"]
    with open(part, "a") as fh:
        fh.write('age": "late"}\n')
    assert [r["message"] for r in f.poll()] == ["late"]


# ---------------------------------------------------------------------------
# the torch-side probes
# ---------------------------------------------------------------------------

def test_device_probes_and_run_start_header(tmp_path, monkeypatch):
    """On the CPU: platform "cpu", one process, no memory snapshot, no
    compile listener; the header carries the torch version. A card
    reports platform "gpu", its name and the count."""
    import torch

    info = ttel.device_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    if not torch.cuda.is_available():
        assert info["platform"] == "cpu"
        assert ttel.device_memory_snapshot() is None
    assert ttel.install_compile_tracking() is False
    run = ttel.TelemetryRun(str(tmp_path / "h.jsonl"), run="h")
    run.finish()
    head = ttel.read_records(run.path)[0]
    assert head["torch"] == torch.__version__ and "jax" not in head
    assert head["device"] == info
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ttel.device_info() == {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "n_devices": 1, "process_index": 0, "process_count": 1}
