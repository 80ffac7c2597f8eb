"""Crash flight recorder: a telemetry ring buffer + postmortem bundles.

Counterpart of ``distributed_model_parallel_tpu/utils/flightrec.py`` (no
framework code; the port's own copy). A crashed run's most valuable
telemetry is the state at the moment of death: the records just before
it, what every thread was blocked on, which spans were open, how full
the cards' memory was, which devices the health sentinel distrusted, and
where the serving journal stood. This module captures it:

* :class:`FlightRecorder` — a bounded in-memory ring that
  :meth:`~.telemetry.TelemetryRun.record` tees every record into (one
  None-check when no recorder is installed; the tee happens before the
  disk write, so even the record a crash tears reaches the ring);
* :func:`dump_postmortem` — writes a timestamped bundle directory:

  ======================= =================================================
  file                    contents
  ======================= =================================================
  ``manifest.json``       reason, wall-clock ts, error, pid, file list
  ``records.jsonl``       the last-N telemetry records from the ring
  ``stacks.txt``          every live thread's stack, plus the failing
                          exception's own traceback when one is passed
  ``spans.json``          every thread's open span stack
                          (:func:`~.tracing.live_spans`)
  ``memory.json``         :func:`~.telemetry.device_memory_snapshot`
                          (null on the CPU)
  ``health.json``         the installed device-health sentinel's scores
                          and quarantine, or null
  ``journal.json``        the installed write-ahead request journal's
                          position + last-N raw lines
                          (``serve.journal.installed``), or null
  ======================= =================================================

  and emits one typed ``postmortem`` telemetry record pointing at the
  bundle (fsync'd, like every ``failure`` record).

Triggers: a hard-crashed serving engine (``Engine.kill``,
``"replica-crashed"``), a serving engine's loop dying (``"engine-killed"``),
the serving fleet's loop dying (``"fleet-killed"``), and the entry
points' unhandled-exception hook (:func:`install_excepthook`). Every
trigger is a no-op unless a recorder is installed; ``install_from_env()``
makes ``DMP_FLIGHT_RECORDER=<bundle dir>`` (or ``1`` for
``./postmortem``) the opt-in.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import traceback

from distributed_model_parallel_tpu_torch.utils import health as _health
from distributed_model_parallel_tpu_torch.utils import telemetry, tracing

__all__ = [
    "FlightRecorder",
    "dump",
    "dump_postmortem",
    "install",
    "install_excepthook",
    "install_from_env",
    "installed",
    "uninstall",
    "uninstall_excepthook",
]

DEFAULT_CAPACITY = 512
DEFAULT_DIR = "./postmortem"
BUNDLE_FILES = ("manifest.json", "records.jsonl", "stacks.txt", "spans.json",
                "memory.json", "health.json", "journal.json")


class FlightRecorder:
    """Bounded ring of the last ``capacity`` telemetry records.

    ``deque(maxlen=...)`` appends are atomic under the GIL, so the tee
    adds no locking to the record path; :meth:`records` snapshots under a
    lock only on the dump path."""

    def __init__(self, dir: str = DEFAULT_DIR,          # noqa: A002
                 capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.dir = dir
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dumps: list[str] = []        # bundle paths written

    def observe(self, rec: dict) -> None:
        self._ring.append(rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


_recorder: FlightRecorder | None = None


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Install ``recorder`` process-wide and tee every TelemetryRun record
    into its ring (``telemetry.set_record_tap``)."""
    global _recorder
    _recorder = recorder
    telemetry.set_record_tap(recorder.observe)
    return recorder


def installed() -> FlightRecorder | None:
    return _recorder


def uninstall() -> None:
    global _recorder
    _recorder = None
    telemetry.set_record_tap(None)


def install_from_env() -> FlightRecorder | None:
    """Entry-point opt-in: ``DMP_FLIGHT_RECORDER=<dir>`` (or ``1``/``true``
    for ``./postmortem``) installs a recorder and the unhandled-exception
    hook. Returns the recorder, or None when the variable is unset (and
    touches nothing)."""
    env = os.environ.get("DMP_FLIGHT_RECORDER")
    if not env:
        return None
    dir_ = DEFAULT_DIR if env.lower() in ("1", "true", "yes") else env
    cap = int(os.environ.get("DMP_FLIGHT_RECORDER_CAPACITY",
                             DEFAULT_CAPACITY))
    rec = install(FlightRecorder(dir=dir_, capacity=cap))
    install_excepthook()
    return rec


# ---------------------------------------------------------------------------
# Postmortem bundles
# ---------------------------------------------------------------------------

def _thread_stacks(error: BaseException | None) -> str:
    """Every live thread's stack with thread names, plus the failing
    exception's traceback (its thread may already have unwound)."""
    out: list[str] = []
    if error is not None:
        out.append("=== failing exception ===")
        out.append("".join(traceback.format_exception(
            type(error), error, error.__traceback__)).rstrip())
        out.append("")
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sorted(sys._current_frames().items()):
        out.append(f"=== thread {names.get(ident, '?')} (ident {ident}) ===")
        out.append("".join(traceback.format_stack(frame)).rstrip())
        out.append("")
    return "\n".join(out)


def _journal_tail() -> dict | None:
    """The installed serving journal's position and tail, or None. The
    serve package is imported lazily and defensively: the recorder also
    runs in processes that never load it."""
    try:
        from distributed_model_parallel_tpu_torch.serve import (
            journal as _journal,
        )

        jr = _journal.installed()
    except Exception:
        jr = None
    if jr is None:
        return None
    return {"path": jr.path, "position": jr.position(), "tail": jr.tail()}


_dump_lock = threading.Lock()
_dumping = False


def dump_postmortem(dir: str, reason: str, *,                # noqa: A002
                    telemetry_run=None,
                    error: BaseException | None = None,
                    records: list[dict] | None = None) -> str | None:
    """Write one postmortem bundle under ``dir`` and return its path.

    Never raises (a postmortem is observability, not control flow) and
    never recurses: a second dump racing the first is skipped, not
    interleaved. ``records`` defaults to the installed recorder's ring
    (empty without one). The typed ``postmortem`` record lands on
    ``telemetry_run`` when given."""
    global _dumping
    with _dump_lock:
        if _dumping:
            return None
        _dumping = True
    try:
        rec = _recorder
        if records is None:
            records = rec.records() if rec is not None else []
        slug = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:60]
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.join(dir, f"postmortem-{stamp}-{slug}")
        path = base
        i = 1
        while os.path.exists(path):
            path = f"{base}.{i}"
            i += 1
        os.makedirs(path, exist_ok=True)

        def _write(name: str, data: str) -> None:
            with open(os.path.join(path, name), "w") as f:
                f.write(data)

        err = (f"{type(error).__name__}: {error}"
               if error is not None else None)
        _write("records.jsonl", "".join(
            json.dumps(r, default=str) + "\n" for r in records))
        _write("stacks.txt", _thread_stacks(error))
        _write("spans.json", json.dumps(tracing.live_spans(), indent=2,
                                        default=str))
        _write("memory.json", json.dumps(
            telemetry.device_memory_snapshot(), indent=2))
        monitor = _health.installed()
        _write("health.json", json.dumps(
            monitor.snapshot() if monitor is not None else None, indent=2))
        _write("journal.json", json.dumps(_journal_tail(), indent=2,
                                          default=str))
        _write("manifest.json", json.dumps({
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "error": err[:500] if err is not None else None,
            "n_records": len(records),
            "files": list(BUNDLE_FILES),
        }, indent=2))
        telemetry.registry().counter("postmortem_dumps").inc()
        if rec is not None:
            rec.dumps.append(path)
        if telemetry_run is not None:
            try:
                telemetry_run.record(
                    "postmortem", reason=reason, bundle=path,
                    n_records=len(records),
                    error=err[:300] if err is not None else None)
            except Exception:
                pass
        print(f"[flightrec] postmortem bundle written: {path}",
              file=sys.stderr)
        return path
    except Exception as e:       # pragma: no cover - best-effort path
        print(f"[flightrec] postmortem dump failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return None
    finally:
        with _dump_lock:
            _dumping = False


def dump(reason: str, *, telemetry_run=None,
         error: BaseException | None = None) -> str | None:
    """Trigger-site entry point: dump a bundle into the installed
    recorder's directory. None (and nothing written) when no recorder is
    installed."""
    rec = _recorder
    if rec is None:
        return None
    return dump_postmortem(rec.dir, reason, telemetry_run=telemetry_run,
                           error=error)


# ---------------------------------------------------------------------------
# The entry points' unhandled-exception hook
# ---------------------------------------------------------------------------

_prev_excepthook = None


def install_excepthook() -> None:
    """Wrap ``sys.excepthook``: an unhandled exception first writes a
    fsync'd ``failure`` record to every live telemetry stream, dumps a
    postmortem bundle, points every stream at it, closes the streams
    (``finish()``), then chains to the previous hook. Idempotent."""
    global _prev_excepthook
    if _prev_excepthook is not None:
        return
    _prev_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            runs = telemetry.live_runs()
            for run in runs:
                try:
                    run.failure("unhandled-exception",
                                detail=f"{exc_type.__name__}: {exc}"[:300])
                except Exception:
                    pass
            path = dump("unhandled-exception", error=exc)
            for run in runs:
                try:
                    if path is not None:
                        run.record("postmortem",
                                   reason="unhandled-exception",
                                   bundle=path,
                                   error=f"{exc_type.__name__}: "
                                         f"{exc}"[:300])
                    run.finish(error=f"{exc_type.__name__}"[:100])
                except Exception:
                    pass
        except Exception:
            pass
        _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _hook


def uninstall_excepthook() -> None:
    global _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
