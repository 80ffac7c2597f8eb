"""Unified run telemetry: metrics registry + structured JSONL event stream.

Counterpart of ``distributed_model_parallel_tpu/utils/telemetry.py``. The
registry, the stream, rotation, the torn-tail reader, the live follower,
the stream merge and the request-trace joiner are the JAX package's code
(none of it touches a framework); the device probes read ``torch.cuda``
and ``torch.distributed``, and the ``run_start`` header carries the torch
version under ``torch`` where the JAX package writes ``jax``.

* a process-wide :class:`MetricsRegistry` (counters, gauges, fixed-bucket
  histograms) — host-side only: metrics record Python floats between
  device calls, never tensors;
* a :class:`TelemetryRun` event stream — one JSONL file per run holding
  typed records;
* collective communication-volume accounting
  (:func:`record_collective`), a ring-model estimate per call.

Record schema (all records carry ``ts`` (unix seconds) and ``kind``; runs
opened inside a :func:`tenant_scope` additionally stamp ``tenant`` on
every record, and :func:`merge_streams` joins several streams into one
ts-ordered view). The kinds the serving engine writes:

========== ==========================================================
kind       payload keys
========== ==========================================================
run_start  run, torch, device {platform, device_kind, n_devices,
           process_index, process_count}, meta
metrics    counters, gauges, histograms (registry snapshot)
run_end    wall_s, plus caller extras
failure    error, detail, plus context — a detected failure (a killed
           engine, a hard crash with its journal position)
serve      event (completed | failed | summary) plus the per-request
           SLO payload (prompt_tokens, new_tokens, queue_wait_s,
           ttft_s, token_latency_s) or the engine-run aggregate
shed       request, reason, priority, state, waited_s — one typed
           overload shed or submission rejection
brownout   level, previous, direction, applied, plus the signals —
           one brownout ladder transition (serve/overload.py)
meter      event, request, tenant, chip_s, page_s, ... — one closed
           residency bill (utils/metering.py)
utilization the engine's duty-cycle ledger (utils/metering.py)
rtrace     trace, seq, request, event, plus per-event fields — one
           request-scoped event (utils/tracing.py)
span       name, t0 (wall-clock start), dur_s (monotonic duration),
           sid, parent, depth, thread, plus site attrs
========== ==========================================================

Two live surfaces sit on top of this stream: the statusz exporter
(utils/statusz.py — /metrics Prometheus text, /statusz JSON, /healthz)
and the live-tail reader (:class:`StreamFollower` /
:func:`follow_records` — rotation-safe incremental reads).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "AlreadyRegisteredError",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RTRACE_TERMINAL_EVENTS",
    "StreamFollower",
    "TelemetryRun",
    "current_tenant",
    "device_info",
    "device_memory_snapshot",
    "follow_records",
    "install_compile_tracking",
    "join_request_traces",
    "live_runs",
    "merge_streams",
    "read_records",
    "record_collective",
    "record_tap",
    "registry",
    "set_record_tap",
    "stream_parts",
    "tenant_scope",
    "wire_bytes_estimate",
    "wire_ops_estimate",
]


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic float counter.

    Increments made on a thread bound to a :func:`tenant_scope` are
    *additionally* attributed to that tenant's bucket, so a co-resident
    tenant's counters are separable from fleet totals
    (``MetricsRegistry.snapshot(tenant=...)``)."""

    __slots__ = ("value", "by_tenant")

    def __init__(self):
        self.value = 0.0
        self.by_tenant: dict[str, float] = {}

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += float(n)
        tenant = current_tenant()
        if tenant is not None:
            self.by_tenant[tenant] = self.by_tenant.get(tenant, 0.0) + float(n)


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)


# Default histogram buckets: log-spaced, 5 per decade, 10us..100s.
# Quantiles interpolate within a bucket, so the estimate error is
# bounded by the bucket ratio (10^0.2 ~ 1.58x worst case).
DEFAULT_TIME_BUCKETS: tuple[float, ...] = tuple(
    10 ** (-5 + i / 5) for i in range(36))


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    Exact ``count``/``sum``/``min``/``max``; quantiles come from the bucket
    cumulative counts with linear interpolation inside the crossing bucket.
    ``observe(v, exemplar=...)`` keeps the last exemplar label (a request
    trace id) per bucket, so the /metrics exposition can attach an
    OpenMetrics-style exemplar to each ``_bucket`` series — the hook that
    lets "p99 TTFT regressed" link straight to a traceable request.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "exemplars")

    def __init__(self, bounds: Iterable[float] | None = None):
        self.bounds = tuple(sorted(bounds or DEFAULT_TIME_BUCKETS))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # bucket index -> (exemplar label, observed value); last wins.
        self.exemplars: dict[int, tuple[str, float]] = {}

    def observe(self, v: float, exemplar: str | None = None) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        # First bound >= v (linear scan: bucket counts are small and this
        # is host-side bookkeeping, not a hot loop).
        idx = len(self.counts) - 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        self.counts[idx] += 1
        if exemplar is not None:
            self.exemplars[idx] = (str(exemplar), v)

    def percentile(self, q: float) -> float | None:
        """Interpolated q-th percentile (q in [0, 100]); None when empty."""
        if self.count == 0:
            return None
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                # Bucket i spans (lo, hi]; clamp to observed min/max so a
                # single-sample histogram reports the sample, not a bound.
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo, hi = max(lo, self.min), min(hi, self.max)
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class AlreadyRegisteredError(ValueError):
    """A metric name+tags was reused with a different metric type."""


def _fmt_key(name: str, tags: tuple[tuple[str, str], ...]) -> str:
    if not tags:
        return name
    inner = ",".join(f"{k}={v}" for k, v in tags)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Process-wide named metrics, keyed by (name, sorted tags)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, Any] = {}

    def _get(self, cls, name: str, tags: Mapping[str, Any], **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in tags.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(**kw)
            elif not isinstance(m, cls):
                raise AlreadyRegisteredError(
                    f"{_fmt_key(*key)} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **tags) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, bounds: Iterable[float] | None = None,
                  **tags) -> Histogram:
        return self._get(Histogram, name, tags, bounds=bounds)

    def items(self) -> list[tuple[str, dict[str, str], Any]]:
        """A consistent view of every registered metric:
        ``(name, {tag: value}, metric_object)`` rows, name-sorted. The
        statusz exporter's ``/metrics`` renderer walks this (it needs the
        live objects — e.g. a Counter's per-tenant buckets — not the
        JSON snapshot)."""
        with self._lock:
            rows = list(self._metrics.items())
        return [(name, dict(tags), m)
                for (name, tags), m in sorted(rows, key=lambda kv: kv[0])]

    def snapshot(self, tenant: str | None = None) -> dict:
        """JSON-ready dump: {"counters": {...}, "gauges": {...},
        "histograms": {...}} with ``name{k=v,...}`` keys.

        With ``tenant``, counters report only the increments made inside
        that tenant's :func:`tenant_scope` (per-tenant attribution);
        gauges and histograms have no per-tenant buckets and stay
        process-global."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._metrics.items())
        for (name, tags), m in sorted(items, key=lambda kv: kv[0]):
            key = _fmt_key(name, tags)
            if isinstance(m, Counter):
                out["counters"][key] = (m.value if tenant is None
                                        else m.by_tenant.get(tenant, 0.0))
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.snapshot()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_default_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry (collectives accounting, compile counts)."""
    return _default_registry


# ---------------------------------------------------------------------------
# Recompilation tracking
# ---------------------------------------------------------------------------

def install_compile_tracking() -> bool:
    """The JAX package counts XLA backend compilations here through
    ``jax.monitoring``. PyTorch runs eagerly: there is no per-program
    compile event to listen to (the port's hand-written kernels are
    built once by ``ops/_build.py``, outside any step), so nothing is
    installed and this returns False."""
    return False


# ---------------------------------------------------------------------------
# Collective communication-volume accounting (called at trace time)
# ---------------------------------------------------------------------------

# Per-device wire bytes moved by one execution of a collective over an
# n-way axis, as a fraction of the logical payload — the standard ring
# algorithm costs. ppermute sends the whole shard once; all-reduce is
# reduce-scatter + all-gather.
_WIRE_FACTORS = {
    "psum": lambda n: 2 * (n - 1) / n,
    "bucketed_psum": lambda n: 2 * (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


def wire_bytes_estimate(kind: str, payload_bytes: int, n_shards: int) -> float:
    """Estimated per-device wire bytes for one execution of a collective.

    ``payload_bytes`` is the LOGICAL payload: the full reduced tree for
    psum/reduce_scatter, the full gathered result for all_gather, the
    per-device shard for ppermute. Ring-algorithm cost model; the
    actual traffic depends on the algorithm the backend picks, so treat
    it as an estimate.
    """
    n = max(1, int(n_shards))
    factor = _WIRE_FACTORS.get(kind)
    if factor is None:
        factor = lambda n: 1.0  # noqa: E731 - unknown kinds count payload
    return float(payload_bytes) * factor(n)


# Per-device sequential message count of one execution under the same
# ring algorithms — the ALPHA term of an alpha-beta cost model (each
# message pays a launch/latency cost regardless of size, which is what
# makes many small collectives slower than one big one even at equal
# bytes). All-reduce = reduce-scatter (n-1 steps) + all-gather (n-1).
_OP_FACTORS = {
    "psum": lambda n: 2 * (n - 1),
    "bucketed_psum": lambda n: 2 * (n - 1),
    "reduce_scatter": lambda n: n - 1,
    "all_gather": lambda n: n - 1,
    "all_to_all": lambda n: n - 1,
    "ppermute": lambda n: 1,
}


def wire_ops_estimate(kind: str, n_shards: int) -> float:
    """Per-device message count for one execution of a collective over an
    n-way axis (ring model; unknown kinds count one message). The
    companion of :func:`wire_bytes_estimate`: together they are the
    (alpha, beta) pair of an alpha-beta collective cost model."""
    n = max(1, int(n_shards))
    factor = _OP_FACTORS.get(kind)
    if factor is None:
        factor = lambda n: 1.0  # noqa: E731 - unknown kinds count one op
    return float(factor(n))


def record_collective(kind: str, axis: Any, payload_bytes: Any,
                      n_shards: Any) -> None:
    """Account one collective call into the registry, tagged by mesh axis.

    Never raises: any surprise in the arguments silently skips the
    sample rather than breaking the caller. Counters written:

    * ``collective_traces{kind,axis}`` — times this collective traced;
    * ``collective_payload_bytes{kind,axis}`` — logical payload bytes;
    * ``collective_wire_bytes_est{kind,axis}`` — ring-model wire bytes;
    * ``collective_ops_est{kind,axis}`` — ring-model per-device message
      count (the alpha term of an alpha-beta cost model needs message
      counts, not just bytes).
    """
    try:
        n = int(n_shards)
        b = int(payload_bytes)
        axis_s = axis if isinstance(axis, str) else ",".join(map(str, axis))
        reg = registry()
        tags = dict(kind=kind, axis=axis_s)
        reg.counter("collective_traces", **tags).inc()
        reg.counter("collective_payload_bytes", **tags).inc(b)
        reg.counter("collective_wire_bytes_est", **tags).inc(
            wire_bytes_estimate(kind, b, n))
        reg.counter("collective_ops_est", **tags).inc(
            wire_ops_estimate(kind, n))
    except Exception:
        return


# ---------------------------------------------------------------------------
# Device probes (host-side, guarded: must never take a run down)
# ---------------------------------------------------------------------------

def device_info() -> dict:
    """Backend identity for the run_start record: ``platform`` "gpu" with
    the card's name and the visible card count when CUDA is available,
    else "cpu"; process index and count from ``torch.distributed`` when a
    group is initialised (0 and 1 otherwise). ``{"error": ...}`` when the
    probe itself fails (a failure record still needs a header)."""
    try:
        import torch

        if torch.cuda.is_available():
            info = {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(0),
                    "n_devices": torch.cuda.device_count()}
        else:
            info = {"platform": "cpu", "device_kind": "cpu",
                    "n_devices": 1}
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        info["process_index"] = dist.get_rank() if up else 0
        info["process_count"] = dist.get_world_size() if up else 1
        return info
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def device_memory_snapshot() -> list[dict] | None:
    """Per-card memory watermarks from ``torch.cuda.memory_stats`` (the
    caching allocator's view); None on the CPU, where no device
    reports."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        out = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            rec = {"id": i, "platform": "gpu",
                   "bytes_in_use": int(stats.get(
                       "allocated_bytes.all.current", 0)),
                   "peak_bytes_in_use": int(stats.get(
                       "allocated_bytes.all.peak", 0)),
                   "bytes_reserved": int(stats.get(
                       "reserved_bytes.all.current", 0))}
            out.append(rec)
        return out or None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Tenant tagging
# ---------------------------------------------------------------------------

# Thread-local "who is writing telemetry right now": every TelemetryRun
# opened inside ``tenant_scope(name)`` tags its records with the name.
_tenant_local = threading.local()


def current_tenant() -> str | None:
    """The tenant name bound to this thread (None outside any scope)."""
    return getattr(_tenant_local, "name", None)


@contextlib.contextmanager
def tenant_scope(name: str):
    """Bind a tenant name to the current thread: every
    :class:`TelemetryRun` constructed inside the scope stamps ``tenant``
    onto all of its records (the fleet report groups by it). Scopes nest;
    the previous binding is restored on exit."""
    prev = current_tenant()
    _tenant_local.name = str(name)
    try:
        yield
    finally:
        _tenant_local.name = prev


def merge_streams(paths: Iterable[str]) -> list[dict]:
    """Merge several telemetry JSONL streams into one ts-ordered record
    list (the fleet view of a multi-tenant or multi-replica run).
    Records keep their per-stream ``tenant`` tags; untagged records from
    a stream whose ``run_start`` carries one inherit it. Missing files
    are skipped (a tenant killed before its header wrote nothing)."""
    merged: list[tuple[float, int, dict]] = []
    order = 0
    paths = list(paths)
    # A shell glob over a rotated stream lists run.jsonl AND its
    # run.N.jsonl parts; read_records(run.jsonl) already folds the parts
    # in, so a listed path that is some other listed path's rotation
    # part must be skipped or its records would merge twice.
    absorbed = {os.path.abspath(part)
                for p in paths for part in stream_parts(p)
                if os.path.abspath(part) != os.path.abspath(p)}
    for path in paths:
        if os.path.abspath(path) in absorbed:
            continue
        try:
            records = read_records(path)
        except FileNotFoundError:
            continue
        tenant = next((r.get("tenant") for r in records
                       if r.get("kind") == "run_start"), None)
        for r in records:
            if tenant is not None and "tenant" not in r:
                r = {**r, "tenant": tenant}
            ts = r.get("ts")
            merged.append((ts if isinstance(ts, (int, float)) else 0.0,
                           order, r))
            order += 1
    merged.sort(key=lambda t: (t[0], t[1]))
    return [r for _, _, r in merged]


# ---------------------------------------------------------------------------
# Request-trace joining (the serving tier's per-request X-ray)
# ---------------------------------------------------------------------------

# Events that END a request's timeline — every admitted request must
# terminate in exactly one of these, or the trace is an orphan (the
# serving gates enforce it).
RTRACE_TERMINAL_EVENTS = frozenset({"completed", "shed", "expired",
                                    "failed"})

# Events a request emits while it is still waiting (before any prefill
# work) — the interval LEADING INTO one of these is queue time.
_RTRACE_QUEUE_EVENTS = frozenset({"submitted", "route", "admitted",
                                  "clamp", "memory_stall", "shed",
                                  "expired", "failed"})


def _rtrace_origin(rec: dict) -> str:
    """Which emitter a record came from — the ``replica`` field in fleet
    mode (the fleet and its replica engines share one stream), falling
    back to the physical-stream tag dmp_xray stamps when joining several
    files. Migration hops link where this changes across an
    export/import pair."""
    v = rec.get("replica")
    if v is None:
        v = rec.get("stream")
    return str(v) if v is not None else ""


def _rtrace_phase(prev: dict, nxt: dict, clamped: bool,
                  prefilled: bool) -> str:
    """Attribute the interval between two consecutive (by seq) rtrace
    events to one phase. The rules partition a trace's whole ts span, so
    per-phase seconds sum exactly to the timeline's wall time."""
    pe, ne = prev.get("event"), nxt.get("event")
    if pe == "export" or ne in ("import", "recovered"):
        # The interval INTO a ``recovered`` event is crash downtime —
        # the request sat in a dead replica's abandoned state (or a
        # downed fleet's journal) until recovery re-admitted it; same
        # bucket as a graceful migration's pause.
        return "migration-pause"
    if pe == "memory_stall":
        return "memory-stall"
    if ne == "prefill":
        return "prefill"
    if ne in _RTRACE_QUEUE_EVENTS and not prefilled:
        return "queue"
    if ne in ("decode", "completed") or (ne in RTRACE_TERMINAL_EVENTS
                                         and prefilled):
        return "brownout-clamp" if clamped else "decode"
    return "other"


def join_request_traces(records: Iterable[dict]) -> dict[str, dict]:
    """Fold ``rtrace`` records (one or more merged streams) into causally
    ordered per-request timelines, keyed by trace id.

    Ordering is by the per-request ``seq`` stamped at emission — NOT by
    ``ts`` — so two events inside one engine iteration (identical wall
    stamps) and events split across replica streams by a migration still
    reconstruct in their true causal order. Each timeline carries:

    * ``events`` — the records, causally ordered by (epoch, seq): a
      full fleet restart resets a request's seq counter to 1, so a seq
      DROP in record order starts a new epoch — the restart's
      ``recovered`` event must open it, or the trace is an orphan;
    * ``terminal`` — the single terminal event name (completed / shed /
      expired / failed), or None;
    * ``hops`` — migration hops, linked wherever an ``export`` is
      followed (by seq; the migration re-route record may intervene)
      by an ``import`` whose emitting replica/stream differs, PLUS one
      export-less hop per ``recovered`` event (a crash moves the
      request with no export — the journal is the carrier):
      ``{seq, from, to}`` (``recovered: True`` on crash hops);
    * ``orphan`` / ``orphan_reasons`` — a seq gap (a lost span, or a
      restart that skipped the ``recovered`` wiring — its duplicate
      seqs collapse into one), zero terminals (a silently dropped
      request) or more than one (a double-accounted one);
    * ``phases`` — seconds per phase (queue / prefill / decode /
      brownout-clamp / migration-pause / memory-stall / other) from an
      interval partition of the event timestamps: phases sum exactly to
      ``wall_s`` (= last ts - first ts) by construction. Crash downtime
      (the interval into a ``recovered`` event) lands in
      ``migration-pause``.
    """
    by_trace: dict[str, list[dict]] = {}
    for r in records:
        if r.get("kind") != "rtrace" or r.get("trace") is None:
            continue
        by_trace.setdefault(str(r["trace"]), []).append(r)
    out: dict[str, dict] = {}
    for trace, raw in by_trace.items():
        # Epoch split FIRST, in record order: a request's seq counter
        # restarts at 1 when a fleet restart rebuilds the Request object
        # from the journal, and the restart's ``recovered`` event is the
        # first record the new process emits for it — so a non-
        # increasing seq ON a ``recovered`` event marks the process
        # boundary. A seq drop WITHOUT one (interleaved multi-stream
        # input) stays in the same epoch, where the per-epoch sort
        # recovers causal order — and a restart that skipped the
        # ``recovered`` wiring collapses into duplicate seqs, flagged as
        # a seq-gap orphan below (an unlinked restart is an orphan, not
        # a hop).
        epochs: list[list[dict]] = [[]]
        last_seq = None
        for r in raw:
            s = int(r.get("seq") or 0)
            if (last_seq is not None and s <= last_seq
                    and r.get("event") == "recovered"):
                epochs.append([])
            epochs[-1].append(r)
            last_seq = s
        for ep in epochs:
            ep.sort(key=lambda r: (r.get("seq") or 0))
        evs = [r for ep in epochs for r in ep]
        reasons: list[str] = []
        for ep in epochs:
            seqs = [int(r.get("seq") or 0) for r in ep]
            if seqs != list(range(1, len(ep) + 1)):
                reasons.append("seq-gap")
                break
        terminals = [r for r in evs
                     if r.get("event") in RTRACE_TERMINAL_EVENTS]
        if not terminals:
            reasons.append("no-terminal")
        elif len(terminals) > 1:
            reasons.append("multiple-terminals")
        # Pair each export with the NEXT import (the migration re-route
        # emits a ``route`` record between them, so strict adjacency
        # would miss the hop). A ``recovered`` event is an export-LESS
        # hop: the source died without draining, the journal carried
        # the request — ``from`` is the dead replica, ``to`` the next
        # event's origin (the post-recovery route decision).
        hops = []
        pending_export = None
        for j, r in enumerate(evs):
            if r.get("event") == "export":
                pending_export = r
            elif r.get("event") == "import" and pending_export is not None:
                if _rtrace_origin(pending_export) != _rtrace_origin(r):
                    hops.append({"seq": pending_export.get("seq"),
                                 "from": _rtrace_origin(pending_export),
                                 "to": _rtrace_origin(r)})
                pending_export = None
            elif r.get("event") == "recovered":
                src = r.get("from_replica")
                if src is None and j > 0:
                    src = _rtrace_origin(evs[j - 1])
                dst = (_rtrace_origin(evs[j + 1]) if j + 1 < len(evs)
                       else _rtrace_origin(r))
                hops.append({"seq": r.get("seq"),
                             "from": str(src) if src is not None else "",
                             "to": dst, "recovered": True})
        phases: dict[str, float] = {}
        clamped = prefilled = False
        for a, b in zip(evs, evs[1:]):
            phase = _rtrace_phase(a, b, clamped, prefilled)
            ta, tb = a.get("ts"), b.get("ts")
            dt = (max(0.0, tb - ta)
                  if isinstance(ta, (int, float))
                  and isinstance(tb, (int, float)) else 0.0)
            phases[phase] = phases.get(phase, 0.0) + dt
            if a.get("event") == "clamp":
                clamped = True
            if a.get("event") == "prefill":
                prefilled = True
        ts = [r["ts"] for r in evs
              if isinstance(r.get("ts"), (int, float))]
        out[trace] = {
            "trace": trace,
            "request": evs[0].get("request"),
            "events": evs,
            "terminal": (terminals[0].get("event") if len(terminals) == 1
                         else None),
            "hops": hops,
            "orphan": bool(reasons),
            "orphan_reasons": reasons,
            "phases": phases,
            "t0": min(ts) if ts else None,
            "t1": max(ts) if ts else None,
            "wall_s": (max(ts) - min(ts)) if ts else 0.0,
        }
    return out


# ---------------------------------------------------------------------------
# The run event stream
# ---------------------------------------------------------------------------

# Process-wide record tap: when set, every record ANY TelemetryRun writes
# is also handed (as its final dict) to this callable — a crash flight
# recorder's free tee. One None-check per record when unset; tap errors
# never break the write.
_record_tap: Callable[[dict], None] | None = None


def set_record_tap(fn: Callable[[dict], None] | None) -> None:
    """Install (or clear, with None) the process-wide record tap."""
    global _record_tap
    _record_tap = fn


def record_tap() -> Callable[[dict], None] | None:
    return _record_tap


# Live (not-yet-finished) runs, weakly held: an unhandled-exception hook
# can close these so a crash still gets its final metrics/run_end
# records.
_live_runs: "weakref.WeakSet[TelemetryRun]" = weakref.WeakSet()


def live_runs() -> list["TelemetryRun"]:
    """Every TelemetryRun constructed in this process that has not yet
    ``finish()``-ed (weakly tracked; GC'd runs drop out)."""
    return [r for r in list(_live_runs) if not r._finished]


# Record kinds that must survive the very crash they describe: the write
# is fsync'd before the stream lock releases, so a process dying right
# after (the common failure->abort path) cannot leave them torn in the
# page cache.
_DURABLE_KINDS = frozenset({"failure", "postmortem", "alert"})


def _coerce(v: Any) -> Any:
    """JSON-safe coercion: device/numpy scalars to float, containers
    element-wise; anything else through str() as a last resort."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, Mapping):
        return {str(k): _coerce(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_coerce(x) for x in v]
    if hasattr(v, "__float__"):
        try:
            return float(v)
        except Exception:
            pass
    return str(v)


class TelemetryRun:
    """Append-only JSONL event stream for one run.

    Opens (and creates directories for) ``path``, writes a ``run_start``
    header, then takes typed records. Thread-safe appends; every record is
    one line, flushed, so a killed run still leaves a parseable stream.
    """

    def __init__(self, path: str, *, run: str = "run",
                 meta: Mapping[str, Any] | None = None,
                 registry_: MetricsRegistry | None = None,
                 track_compiles: bool = True,
                 device: Mapping[str, Any] | None = None,
                 tenant: str | None = None,
                 max_bytes: int | None = None):
        self.path = path
        # Stream rotation for long runs: once the live file would exceed
        # ``max_bytes`` it is renamed to the next ``{stem}.N.jsonl`` part
        # and appends continue on a fresh file, so a long-mode soak
        # campaign cannot grow one unbounded stream. read_records /
        # merge_streams / the report glob the parts back in order
        # (stream_parts). Default: env DMP_TELEMETRY_MAX_BYTES, else off.
        if max_bytes is None:
            env = os.environ.get("DMP_TELEMETRY_MAX_BYTES")
            max_bytes = int(env) if env else None
        if max_bytes is not None and max_bytes < 4096:
            raise ValueError(
                f"max_bytes={max_bytes} would rotate on nearly every "
                f"record (one run_start header is hundreds of bytes); "
                f"use >= 4096 or None")
        self.max_bytes = max_bytes
        try:
            self._bytes = os.path.getsize(path)   # resumed stream appends
        except OSError:
            self._bytes = 0
        # Tenant tag: explicit, or inherited from the thread's
        # tenant_scope. Stamped on every record.
        self.tenant = tenant if tenant is not None else current_tenant()
        self.registry = registry_ if registry_ is not None else registry()
        self._lock = threading.Lock()
        self._finished = False
        # Monotonic pair for the run_end wall_s duration: an NTP step
        # mid-run must not skew it (record ``ts`` stamps stay wall-clock
        # for cross-stream correlation).
        self._t0 = time.monotonic()
        # Counter baseline at stream open: the registry is process-global,
        # so a second run in the same process must not inherit the first
        # run's collective-volume / compile counts in its metrics record.
        # Tenant-tagged streams baseline (and later report) the TENANT's
        # own counter bucket, so a co-resident tenant's metrics record
        # carries per-tenant deltas, not fleet totals.
        self._counter_baseline = dict(
            self.registry.snapshot(tenant=self.tenant)
            .get("counters", {}))
        # Step-time histogram is RUN-LOCAL (histograms have no delta
        # semantics, so sharing the global registry would merge runs).
        self._step_hist = Histogram()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        if track_compiles:
            install_compile_tracking()
        import torch

        # ``device`` override: callers reporting a DEAD backend must not
        # re-dial it just to write the header.
        self.record("run_start", run=run, torch=torch.__version__,
                    device=dict(device) if device is not None
                    else device_info(),
                    meta=_coerce(dict(meta or {})))
        _live_runs.add(self)

    def record(self, kind: str, **fields) -> None:
        head = {"ts": time.time(), "kind": kind}
        if self.tenant is not None:
            head["tenant"] = self.tenant
        rec = {**head, **{k: _coerce(v) for k, v in fields.items()}}
        tap = _record_tap
        if tap is not None:
            # The record tap (a crash flight recorder's tee): the
            # ring gets the record BEFORE the disk write, so even a
            # write that dies mid-line reaches the postmortem bundle.
            try:
                tap(rec)
            except Exception:
                pass
        line = json.dumps(rec, default=str)
        with self._lock:
            n = len(line.encode("utf-8")) + 1    # bytes written, not chars
            if (self.max_bytes is not None and self._bytes > 0
                    and self._bytes + n > self.max_bytes):
                self._rotate()
            with open(self.path, "a") as f:
                f.write(line + "\n")
                if kind in _DURABLE_KINDS:
                    # Crash hygiene: a failure/postmortem/alert record is
                    # exactly the record a crashing process must not lose
                    # — flush + fsync before the lock releases, so the
                    # line is on disk even if the process dies next.
                    f.flush()
                    try:
                        os.fsync(f.fileno())
                    except OSError:
                        pass
            self._bytes += n

    def _rotate(self) -> None:
        """Rename the live file to the next ``{stem}.N.jsonl`` part
        (called under the record lock)."""
        stem, ext = os.path.splitext(self.path)
        existing = _part_indices(self.path)
        nxt = (max(existing) + 1) if existing else 1
        try:
            os.replace(self.path, f"{stem}.{nxt}{ext}")
        except OSError:
            return          # rotation is best-effort; keep appending
        self._bytes = 0

    def step(self, **fields) -> None:
        """One step (or drain window) worth of timings.
        Conventional keys: epoch, step, step_time_s, data_time_s, loss,
        samples_per_s or tokens_per_s. Step times also feed a run-local
        ``step_time_s`` histogram, so the final metrics record carries
        bucket-quantile estimates next to the raw records."""
        t = fields.get("step_time_s")
        if isinstance(t, (int, float)) and not isinstance(t, bool):
            self._step_hist.observe(t)
        self.record("step", **fields)

    def epoch(self, **fields) -> None:
        self.record("epoch", **fields)

    def event(self, message: str) -> None:
        self.record("event", message=message)

    def failure(self, error: str, **fields) -> None:
        self.record("failure", error=error, **fields)

    def recovery(self, action: str, **fields) -> None:
        """One recovery action (restore, fallback, checkpoint-and-exit,
        save retry) — the matching half of a ``failure`` record."""
        self.record("recovery", action=action, **fields)

    def consistency(self, status: str, **fields) -> None:
        """One cross-replica consistency-sentinel event
        (train/consistency.py): ``divergence`` when replicas disagree,
        ``repaired`` after an in-place re-broadcast, ``no-quorum`` when no
        majority-good replica exists and the supervisor's good-slot
        restore takes over, ``non-finite`` when replicas agree on a
        non-finite state (routed to the NonFiniteError recovery path)."""
        self.record("consistency", status=status, **fields)

    def resume(self, slot: str, **fields) -> None:
        """One elastic-resume event (train/elastic.py): which checkpoint
        slot a restarted run picked up, the exact position it continues
        from (epoch, batch cursor, global step) and the saving vs current
        mesh when the topology changed — so a restart is auditable on the
        resilience timeline, not inferred from step numbering."""
        self.record("resume", slot=slot, **fields)

    def memory(self) -> list[dict] | None:
        """Record device memory watermarks (no-op record skipped when the
        backend reports none, e.g. CPU)."""
        snap = device_memory_snapshot()
        if snap:
            self.record("memory", devices=snap)
        return snap

    def metrics(self) -> None:
        """Snapshot the registry into the stream.

        Counters are reported as DELTAS since this stream opened (the
        registry is process-global; without the baseline a second run in
        the same process would re-report the first run's comm volume and
        compile counts). A tenant-tagged stream reports the tenant's own
        counter bucket — increments made inside its ``tenant_scope`` —
        so co-resident tenants' deltas are per-tenant, not fleet totals.
        The ``step_time_s`` histogram is run-local, so its quantiles
        describe only this run; gauges and any caller-made registry
        histograms are absolute."""
        snap = self.registry.snapshot(tenant=self.tenant)
        base = self._counter_baseline
        snap["counters"] = {k: v - base.get(k, 0)
                            for k, v in snap.get("counters", {}).items()}
        if self._step_hist.count:
            snap.setdefault("histograms", {})["step_time_s"] = \
                self._step_hist.snapshot()
        self.record("metrics", **snap)

    def finish(self, **fields) -> None:
        """Write the final ``metrics`` + ``run_end`` records (idempotent)."""
        if self._finished:
            return
        self._finished = True
        self.metrics()
        self.record("run_end", wall_s=time.monotonic() - self._t0, **fields)


def _part_indices(path: str) -> list[int]:
    """Existing rotation-part indices for a logical stream path."""
    import re

    stem, ext = os.path.splitext(os.path.basename(path))
    parent = os.path.dirname(os.path.abspath(path))
    pat = re.compile(re.escape(stem) + r"\.(\d+)" + re.escape(ext) + r"$")
    try:
        entries = os.listdir(parent)
    except OSError:
        return []
    return sorted(int(m.group(1)) for e in entries
                  for m in [pat.match(e)] if m)


def stream_parts(path: str) -> list[str]:
    """Every on-disk file of a logical stream, oldest first: the rotated
    ``{stem}.N.jsonl`` parts in numeric order, then the live file. A
    never-rotated stream is just ``[path]``."""
    stem, ext = os.path.splitext(path)
    out = [f"{stem}.{i}{ext}" for i in _part_indices(path)]
    if os.path.exists(path):
        out.append(path)
    return out


def read_records(path: str) -> list[dict]:
    """Parse a telemetry JSONL stream — all rotated parts in order, then
    the live file — skipping any truncated/corrupt line (a run killed
    mid-write leaves a partial final record; it must cost a warning, not
    poison a whole fleet merge). Every skipped line increments the
    ``telemetry_torn_lines`` counter and one stderr warning names the
    file. FileNotFoundError when no part of the stream exists."""
    import sys

    parts = stream_parts(path)
    if not parts:
        raise FileNotFoundError(path)
    out = []
    for part in parts:
        torn = 0
        with open(part) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    torn += 1
        if torn:
            registry().counter("telemetry_torn_lines").inc(torn)
            print(f"[telemetry] {part}: skipped {torn} unparseable "
                  f"line(s) (torn tail from a killed run?)",
                  file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# Live tail: follow a (possibly rotating) stream without drops or dups
# ---------------------------------------------------------------------------

class StreamFollower:
    """Incremental reader of a logical telemetry stream — the cockpit's
    and alert engine's ingest path.

    :meth:`poll` returns every record appended since the last poll, in
    order, across :class:`TelemetryRun` rotations: when the live file is
    renamed to ``{stem}.N.jsonl`` mid-tail, the follower finishes the
    rotated part from its remembered byte offset (same inode, so nothing
    is re-read) before moving to the new live file — no record is
    dropped and none is delivered twice. A partially-written final line
    stays buffered until its newline arrives (a mid-write poll must not
    mis-parse a half record); an unparseable *complete* line is skipped,
    matching :func:`read_records`.
    """

    def __init__(self, path: str):
        self.path = path
        # Lowest rotation-part index not yet fully consumed; parts below
        # it are done. 0 = consume every existing part from the start.
        self._part_cursor = 0
        self._ino: int | None = None     # inode of the file mid-read
        self._off = 0                    # bytes of it consumed
        self._buf = b""                  # partial trailing line

    def _reset_file(self) -> None:
        self._ino, self._off, self._buf = None, 0, b""

    def _drain(self, path: str, out: list[dict], *, final: bool) -> bool:
        """Read ``path`` from the remembered offset (reset when it is a
        different file than last time), appending parsed records.
        ``final``: the file can never grow again (a rotated part), so a
        buffered partial line is parse-attempted and then discarded.
        Returns False when the file vanished between listing and open."""
        try:
            with open(path, "rb") as f:
                ino = os.fstat(f.fileno()).st_ino
                if ino != self._ino:
                    self._ino, self._off, self._buf = ino, 0, b""
                f.seek(self._off)
                data = f.read()
        except OSError:
            return False
        self._off += len(data)
        buf = self._buf + data
        lines = buf.split(b"\n")
        self._buf = lines.pop()          # incomplete tail stays buffered
        if final and self._buf:
            lines.append(self._buf)      # a rotated part never grows —
            self._buf = b""              # parse-or-drop its last line
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                registry().counter("telemetry_torn_lines").inc()
        return True

    def poll(self) -> list[dict]:
        """Every record appended (to any part) since the last poll."""
        out: list[dict] = []
        stem, ext = os.path.splitext(self.path)
        for _ in range(10_000):          # re-list bound (rotation races)
            pending = [i for i in _part_indices(self.path)
                       if i >= self._part_cursor]
            if pending:
                # Oldest unconsumed part first. If it is the file we were
                # mid-reading as the live stream (rotation renamed it out
                # from under us), _drain continues at the same inode +
                # offset; otherwise it starts from byte 0.
                idx = pending[0]
                self._drain(f"{stem}.{idx}{ext}", out, final=True)
                self._part_cursor = idx + 1
                self._reset_file()
                continue
            # The live file. A rotation between the part listing above
            # and this read shows up as a changed inode — loop so the
            # now-rotated part is drained first.
            try:
                if (self._ino is not None
                        and os.stat(self.path).st_ino != self._ino):
                    continue
            except OSError:
                break                    # no live file (yet)
            self._drain(self.path, out, final=False)
            break
        return out


def follow_records(path: str, *, poll_s: float = 0.2,
                   stop: Callable[[], bool] | None = None):
    """Generator live-tailing a telemetry stream across rotations: yields
    each record once, in order, sleeping ``poll_s`` between empty polls.
    Runs forever unless ``stop()`` returns True — after which one final
    drain still yields everything written before the stop."""
    follower = StreamFollower(path)
    while True:
        recs = follower.poll()
        yield from recs
        if stop is not None and stop():
            yield from follower.poll()
            return
        if not recs:
            time.sleep(poll_s)
