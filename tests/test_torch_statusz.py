"""The port's live status exporter: the one-exporter-per-process and
no-op-when-unset contracts, ``/metrics`` Prometheus text (tenant labels,
cumulative buckets, exemplars, escaping), ``/statusz`` (providers, the
health sentinel, open spans; a dying provider), ``/healthz`` 200/503,
the trainers' provider against the JAX trainers', and the serving
engine's provider, whose keys equal the JAX engine's.

The server cases mirror ``tests/test_statusz.py`` on port 0 of
127.0.0.1."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from _torch_serve_util import engines, model as _model
from distributed_model_parallel_tpu.utils import statusz as jstatusz
from distributed_model_parallel_tpu_torch.utils import (
    health,
    statusz,
    tracing,
)
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    TelemetryRun,
    registry,
    tenant_scope,
)

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _clean_exporter():
    statusz.shutdown()
    yield
    statusz.shutdown()
    jstatusz.shutdown()
    health.uninstall()


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


def test_maybe_serve_is_noop_without_port(monkeypatch):
    """Mirrors test_maybe_serve_is_noop_without_port."""
    monkeypatch.delenv("DMP_STATUSZ_PORT", raising=False)
    assert statusz.maybe_serve(None) is None
    assert statusz.active() is None
    assert statusz.register("x", dict) is False
    assert statusz.registered() == ()


def test_one_exporter_per_process_and_env_port(monkeypatch):
    """Mirrors test_one_exporter_per_process and
    test_env_port_starts_exporter."""
    monkeypatch.delenv("DMP_STATUSZ_PORT", raising=False)
    s1 = statusz.maybe_serve(0)
    assert s1 is statusz.maybe_serve(0) is statusz.maybe_serve(None)
    assert s1.port > 0
    statusz.shutdown()
    monkeypatch.setenv("DMP_STATUSZ_PORT", "0")
    s = statusz.maybe_serve(None)
    assert s is not None and s.port > 0


def test_metrics_exposition_labels_buckets_exemplars():
    """Mirrors test_metrics_prometheus_exposition_with_tenant_labels,
    test_metrics_cumulative_buckets_and_exemplars and
    test_metrics_label_escaping_quotes_backslashes_newlines."""
    s = statusz.maybe_serve(0)
    c = registry().counter("tstatusz_ctr", kind="x")
    c.inc(2)
    with tenant_scope("ten0"):
        c.inc(3)
    registry().gauge("tstatusz_gauge").set(0.5)
    h = registry().histogram("tstatusz_buckets", bounds=(0.1, 1.0, 10.0))
    h.observe(0.05, exemplar="trace-a")
    h.observe(0.5)
    h.observe(0.6, exemplar='tr"ace\\id\nx')
    h.observe(99.0)
    registry().counter("tstatusz_esc", path='he said "hi"\\there\nl2').inc()
    code, body = _get(s.url + "/metrics")
    assert code == 200
    assert '# TYPE tstatusz_ctr counter' in body
    assert 'tstatusz_ctr{kind="x"} 5' in body
    assert 'tstatusz_ctr{kind="x",tenant="ten0"} 3' in body
    assert 'tstatusz_gauge 0.5' in body
    assert ('tstatusz_buckets_bucket{le="0.1"} 1 '
            '# {trace_id="trace-a"} 0.05') in body
    assert 'tstatusz_buckets_bucket{le="1"} 3' in body
    assert 'tstatusz_buckets_bucket{le="+Inf"} 4' in body
    assert 'tstatusz_buckets_count 4' in body
    assert '# {trace_id="tr\\"ace\\\\id\\nx"} 0.6' in body
    assert ('tstatusz_esc{path="he said \\"hi\\"\\\\there\\nl2"} 1'
            in body)
    assert not any(line.startswith("l2") for line in body.splitlines())
    assert body == statusz.prometheus_text()


def test_statusz_renders_providers_health_and_spans(tmp_path):
    """Mirrors test_statusz_renders_providers_health_and_spans and
    test_statusz_survives_dying_provider."""
    s = statusz.maybe_serve(0)
    statusz.register("demo", lambda: {"workload": "demo", "step": 7})

    def _boom():
        raise RuntimeError("provider died")

    statusz.register("bad", _boom)
    monitor = health.install(health.DeviceHealthMonitor())
    monitor.observe_stall([3], 9.0)
    run = TelemetryRun(str(tmp_path / "t.jsonl"), run="t",
                       track_compiles=False, device={"platform": "cpu"})
    opened, release = threading.Event(), threading.Event()

    def _worker():
        tracing.install(run)
        with tracing.span("outer"), tracing.span("inner"):
            opened.set()
            release.wait(10)

    t = threading.Thread(target=_worker, name="spanner", daemon=True)
    t.start()
    assert opened.wait(10)
    try:
        code, body = _get(s.url + "/statusz")
        payload = json.loads(body)
        assert code == 200
        assert payload["providers"]["demo"] == {"workload": "demo",
                                                "step": 7}
        assert "RuntimeError" in payload["providers"]["bad"]["error"]
        assert payload["health"]["scores"]["3"] < 1.0
        assert payload["spans"]["spanner"] == ["outer", "inner"]
    finally:
        release.set()
        t.join()
        tracing.uninstall()
    statusz.register("demo", lambda: {"v": 2})
    assert statusz.status_payload()["providers"]["demo"] == {"v": 2}


def test_healthz_200_when_healthy_503_on_quarantine_or_provider():
    """Mirrors test_healthz_200_when_healthy_503_on_quarantine_or_provider."""
    s = statusz.maybe_serve(0)
    code, body = _get(s.url + "/healthz")
    assert code == 200 and json.loads(body)["ok"] is True
    statusz.register("sick", lambda: {"healthy": False})
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(s.url + "/healthz")
    assert e.value.code == 503
    assert any("sick" in r for r in json.load(e.value)["reasons"])
    statusz.unregister("sick")
    monitor = health.install(health.DeviceHealthMonitor())
    monitor.observe_stall([0], 9.0)
    monitor.observe_stall([0], 9.0)
    assert monitor.quarantined_ids == (0,)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(s.url + "/healthz")
    assert e.value.code == 503


def test_register_trainer_is_refused_by_name():
    """Refused until the autotuner was ported; now a no-op without an
    exporter and, with one, a provider under the run's name whose
    payload equals the JAX trainers' provider's for the same config and
    state, less the devices (the port's are the rank's)."""
    import types

    from distributed_model_parallel_tpu import config as jconfig
    from distributed_model_parallel_tpu_torch import config as tconfig

    def trainer(config, stalled):
        guards = types.SimpleNamespace(
            stall=types.SimpleNamespace(stalled=stalled))
        return types.SimpleNamespace(config=config, global_step=7,
                                     _global_step=7, start_epoch=2,
                                     _device_ids=(0,), guards=guards)

    kw = dict(strategy="spmd_pipeline", num_microbatches=4,
              log_name="probe")
    port = trainer(tconfig.TrainConfig(
        mesh=tconfig.MeshConfig(data=2, stage=2), **kw), True)
    ref = trainer(jconfig.TrainConfig(
        mesh=jconfig.MeshConfig(data=2, stage=2), **kw), True)
    assert statusz.register_trainer(port, "cnn") is False
    statusz.maybe_serve(0)
    jstatusz.maybe_serve(0)
    assert statusz.register_trainer(port, "cnn") is True
    assert jstatusz.register_trainer(ref, "cnn") is True
    assert statusz.registered() == ("probe",)
    got = statusz.status_payload()["providers"]["probe"]
    want = jstatusz.status_payload()["providers"]["probe"]
    got.pop("devices")
    want.pop("devices")
    assert got == want
    assert got["healthy"] is False
    assert got["plan"]["axes"] == {"dp": 2, "pp": 2, "tp": 1, "sp": 1,
                                   "ep": 1}


def test_engine_provider_keys_match_jax():
    """An engine built while an exporter runs registers its provider;
    the payload's keys equal the JAX engine's, and /statusz and /metrics
    serve it live."""
    s = statusz.maybe_serve(0)
    jstatusz.maybe_serve(0)
    jeng, eng = engines(_model(), max_queue=4, brownout=True)
    assert "serve-continuous" in statusz.registered()
    for e in (jeng, eng):
        e.submit([1, 2, 3], 4, rid="a")
        e.run()
    code, body = _get(s.url + "/statusz")
    payload = json.loads(body)["providers"]["serve-continuous"]
    assert code == 200
    assert set(payload) == set(jstatusz.status_payload()["providers"][
        "serve-continuous"])
    assert payload["queue_depth"] == 0 and payload["brownout_level"] == 0
    assert 0.0 <= payload["page_occupancy"] <= 1.0
    code, body = _get(s.url + "/metrics")
    assert code == 200 and "serve_ttft_s_count" in body
