"""In-process status/metrics exporter: ``/metrics``, ``/statusz``,
``/healthz`` over stdlib ``http.server`` on a daemon thread.

Counterpart of ``distributed_model_parallel_tpu/utils/statusz.py`` (no
framework code; the port's own copy). One HTTP exporter per process
(``DMP_STATUSZ_PORT``, ``ServeConfig.statusz_port`` or a trainer's
``statusz_port``; port 0 picks an ephemeral port) that any component of
the process registers a **status provider** with, so an operator can ask
a running engine or trainer what it is doing *now*:

* ``GET /metrics`` — Prometheus text exposition rendered from the live
  :class:`~.telemetry.MetricsRegistry`: counters (with per-tenant
  label series), gauges, and histograms as summary quantiles + ``_count``/``_sum``.
* ``GET /statusz`` — one JSON document: every registered provider's
  payload (the serving engine: queue depth / page occupancy / slot
  state / brownout level; a trainer: :func:`register_trainer`), plus
  built-ins — the
  device-health sentinel's scores and quarantine set
  (:func:`~.health.installed`) and the open span stack of every thread
  (:func:`~.tracing.live_spans`).
* ``GET /healthz`` — 200 when healthy, 503 when any device is
  health-quarantined or any provider reports ``healthy: false`` — the
  liveness/readiness contract a fleet scheduler probes.

Opt-in and one-per-process: ``maybe_serve(port)`` starts the server the
first time a port is configured (explicit argument or the env var) and
afterwards returns the running server regardless of the argument. With
neither configured everything here is a no-op: no thread, no socket, no
provider registry growth (``register`` drops registrations when no
server runs).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from distributed_model_parallel_tpu_torch.utils import health as _health
from distributed_model_parallel_tpu_torch.utils import tracing as _tracing
from distributed_model_parallel_tpu_torch.utils.telemetry import (
    Counter,
    Gauge,
    Histogram,
    registry,
)

__all__ = [
    "StatuszServer",
    "active",
    "maybe_serve",
    "prometheus_text",
    "register",
    "register_trainer",
    "registered",
    "shutdown",
    "status_payload",
    "unregister",
]

_lock = threading.Lock()
_server: "StatuszServer | None" = None
_providers: dict[str, Callable[[], dict]] = {}


# ---------------------------------------------------------------------------
# Provider registry (process-wide, like the metrics registry)
# ---------------------------------------------------------------------------

def register(name: str, fn: Callable[[], dict]) -> bool:
    """Register (or replace — a later engine of the same name) a status
    provider: ``fn()`` returns a JSON-ready dict rendered under
    ``providers[name]`` in ``/statusz``. A payload carrying
    ``healthy: false`` flips ``/healthz`` to 503. No-op (returns False)
    when no exporter is running — an unexported process must not
    accumulate provider closures."""
    with _lock:
        if _server is None:
            return False
        _providers[str(name)] = fn
        return True


def unregister(name: str) -> None:
    with _lock:
        _providers.pop(str(name), None)


def registered() -> tuple[str, ...]:
    with _lock:
        return tuple(sorted(_providers))


def register_trainer(trainer, workload: str) -> bool:
    """One wiring call shared by the three trainers: register a
    ``/statusz`` provider reading the trainer's live state — run name,
    global step, start epoch, the rank's devices, the plan payload of its
    config (``autotune.plan_payload``) and the stall watchdog's health —
    named after the tenant when constructed inside a ``tenant_scope``,
    else after the run. No-op without a running exporter."""
    from distributed_model_parallel_tpu_torch.autotune.plan import (
        plan_payload,
    )
    from distributed_model_parallel_tpu_torch.utils.telemetry import (
        current_tenant,
    )

    name = current_tenant() or trainer.config.log_name

    def _status() -> dict:
        cfg = trainer.config
        watchdog = getattr(getattr(trainer, "guards", None), "stall", None)
        return {
            "workload": workload,
            "run": cfg.log_name,
            # Read while the trainer may still be constructing.
            "global_step": int(getattr(trainer, "global_step", 0)),
            "start_epoch": int(getattr(trainer, "start_epoch", 0)),
            "devices": list(getattr(trainer, "_device_ids", ())),
            "plan": plan_payload(
                cfg.mesh, getattr(cfg, "strategy", workload),
                num_microbatches=getattr(cfg, "num_microbatches", 1)),
            "healthy": not bool(getattr(watchdog, "stalled", False)),
        }

    return register(name, _status)


# ---------------------------------------------------------------------------
# Renderers (also used headless by tests)
# ---------------------------------------------------------------------------

def _esc(v: object) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(tags: dict, **extra: str) -> str:
    items = {**tags, **extra}
    if not items:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


def prometheus_text() -> str:
    """The live registry in Prometheus text exposition format (0.0.4).

    Counters render their fleet total plus one series per tenant bucket
    (label ``tenant``); gauges render when set; histograms render as
    summaries — ``{quantile="0.5|0.9|0.99"}`` series plus ``_count`` and
    ``_sum`` — matching the interpolated bucket quantiles the telemetry
    snapshot reports, PLUS true cumulative ``_bucket{le="..."}`` series
    (ending at ``le="+Inf"`` == ``_count``) so an external scraper can
    compute its own quantiles. Buckets that captured an exemplar (e.g. a
    request ``trace_id`` — the serving engine passes them on the TTFT /
    queue-wait / token-latency observations) carry an OpenMetrics-style
    exemplar suffix: ``... # {trace_id="..."} <value>``."""
    lines: list[str] = []
    seen_types: set[str] = set()
    for name, tags, metric in registry().items():
        if isinstance(metric, Counter):
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_labels(tags)} {metric.value:g}")
            for tenant, v in sorted(metric.by_tenant.items()):
                lines.append(f"{name}{_labels(tags, tenant=tenant)} {v:g}")
        elif isinstance(metric, Gauge):
            if metric.value is None:
                continue
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_labels(tags)} {metric.value:g}")
        elif isinstance(metric, Histogram):
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} summary")
            for q in (50, 90, 99):
                v = metric.percentile(q)
                if v is not None:
                    lines.append(
                        f"{name}{_labels(tags, quantile=str(q / 100))} "
                        f"{v:g}")
            lines.append(f"{name}_count{_labels(tags)} {metric.count}")
            lines.append(f"{name}_sum{_labels(tags)} {metric.sum:g}")
            # Cumulative buckets: counts[i] is the per-bucket tally for
            # le=bounds[i] (the trailing slot is the +Inf overflow), so
            # the running sum is the Prometheus-native cumulative form.
            cum = 0
            for i, bound in enumerate(metric.bounds):
                cum += metric.counts[i]
                line = (f"{name}_bucket"
                        f"{_labels(tags, le=f'{bound:g}')} {cum}")
                ex = metric.exemplars.get(i)
                if ex is not None:
                    line += f' # {{trace_id="{_esc(ex[0])}"}} {ex[1]:g}'
                lines.append(line)
            line = f"{name}_bucket{_labels(tags, le='+Inf')} {metric.count}"
            ex = metric.exemplars.get(len(metric.bounds))
            if ex is not None:
                line += f' # {{trace_id="{_esc(ex[0])}"}} {ex[1]:g}'
            lines.append(line)
    return "\n".join(lines) + "\n"


def status_payload() -> dict:
    """The ``/statusz`` JSON document: provider payloads + the health
    and span built-ins."""
    import time

    with _lock:
        providers = dict(_providers)
    out: dict = {"ts": time.time(), "pid": os.getpid(),
                 "providers": {}}
    for name, fn in sorted(providers.items()):
        try:
            out["providers"][name] = fn()
        except Exception as e:   # a dying provider must not kill the page
            out["providers"][name] = {"error": f"{type(e).__name__}: {e}"}
    monitor = _health.installed()
    out["health"] = monitor.snapshot() if monitor is not None else None
    out["spans"] = _tracing.live_spans()
    return out


def health_verdict() -> tuple[bool, list[str]]:
    """(ok, reasons): unhealthy when the health sentinel has quarantined
    devices or any provider payload says ``healthy: false``."""
    reasons: list[str] = []
    monitor = _health.installed()
    if monitor is not None:
        quarantined = monitor.quarantined_ids
        if quarantined:
            reasons.append(f"devices {list(quarantined)} quarantined")
    with _lock:
        providers = dict(_providers)
    for name, fn in sorted(providers.items()):
        try:
            payload = fn()
        except Exception as e:
            reasons.append(f"provider {name} failed: {type(e).__name__}")
            continue
        if payload.get("healthy") is False:
            reasons.append(f"provider {name} unhealthy")
    return (not reasons), reasons


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):      # no stderr per scrape
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                        # noqa: N802 - stdlib API
        try:
            path = self.path.split("?")[0].rstrip("/") or "/"
            if path == "/metrics":
                self._send(200, prometheus_text().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/statusz":
                self._send(200, json.dumps(
                    status_payload(), default=str).encode("utf-8"),
                    "application/json")
            elif path in ("/healthz", "/"):
                ok, reasons = health_verdict()
                self._send(200 if ok else 503, json.dumps(
                    {"ok": ok, "reasons": reasons}).encode("utf-8"),
                    "application/json")
            else:
                self._send(404, b'{"error": "not found"}',
                           "application/json")
        except Exception:
            # A scrape must never take the process down; the socket may
            # already be half-closed (client timeout) — just drop it.
            try:
                self._send(500, b'{"error": "internal"}',
                           "application/json")
            except Exception:
                pass


class StatuszServer:
    """One exporter: a ThreadingHTTPServer on a daemon thread, bound to
    127.0.0.1 (observability is not an ingress surface)."""

    def __init__(self, port: int):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="dmp-statusz")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def maybe_serve(port: int | None = None) -> StatuszServer | None:
    """Start (or return) the process's exporter.

    Resolution: a server already running always wins (one exporter per
    process);
    otherwise an explicit ``port`` (0 = ephemeral), otherwise
    ``DMP_STATUSZ_PORT``; with neither, return None and touch nothing —
    the true no-op contract."""
    global _server
    with _lock:
        if _server is not None:
            return _server
        if port is None:
            env = os.environ.get("DMP_STATUSZ_PORT")
            if env is None or env == "":
                return None
            port = int(env)
        _server = StatuszServer(port)
        # Announce once — with port 0 (ephemeral) this line is the only
        # way an operator learns where to point the scrape/cockpit.
        import sys

        print(f"[statusz] exporter on {_server.url} "
              f"(/metrics /statusz /healthz)", file=sys.stderr)
        return _server


def active() -> StatuszServer | None:
    return _server


def shutdown() -> None:
    """Stop the exporter and clear the provider registry (tests; a
    process normally keeps its exporter for life)."""
    global _server
    with _lock:
        server, _server = _server, None
        _providers.clear()
    if server is not None:
        server.close()
