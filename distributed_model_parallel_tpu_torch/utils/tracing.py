"""Span tracing: causal host timelines on the telemetry stream.

Counterpart of ``distributed_model_parallel_tpu/utils/tracing.py`` (the
module has no framework code; this is the port's own copy).

* :func:`span` — a ``with``-statement context manager (usable as a
  decorator) that measures one named interval with ``time.monotonic()``
  (the record's wall-clock ``t0``/``ts`` stay on ``time.time()`` for
  cross-stream correlation) and writes one typed ``span`` record onto
  the thread's bound :class:`~.telemetry.TelemetryRun`;
* a **thread-local span stack**: spans opened inside spans record their
  parent id and depth;
* :func:`install` / :func:`sink_scope` — per-thread sink binding; the
  serving engine binds its stream for the scope of a run;
* :func:`rtrace` / :func:`new_trace_id` — per-request ``rtrace`` records,
  causally ordered by a per-request sequence number.

Spans time the host clock and never synchronize the device: on the card
a span around a step measures the host's enqueue plus whatever the step
itself waits for (the engine's token read-back), exactly what the loop
sees. With no sink bound (or ``DMP_TRACING=0`` / :func:`set_enabled`) a
span is a no-op — two attribute reads, no allocation, no clock call.

Record schema: ``{kind: "span", name, t0, dur_s, sid, parent, depth,
thread, **attrs}`` where ``t0`` is the wall-clock start (unix seconds),
``ts`` (stamped by TelemetryRun at write) the wall-clock end, and
``dur_s`` the monotonic-clock duration.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from typing import Any

__all__ = [
    "enabled",
    "install",
    "installed",
    "live_spans",
    "new_trace_id",
    "record_span",
    "rtrace",
    "set_enabled",
    "sink_scope",
    "span",
    "uninstall",
]

_state = threading.local()
_ids = itertools.count(1)       # process-unique span ids (GIL-atomic)
_enabled = os.environ.get("DMP_TRACING", "1") != "0"

# Every thread's live span stack, by thread ident — the statusz
# exporter's "what is each thread doing right now" view and the crash
# flight recorder's span context. The stack LISTS are shared with the
# thread-locals (mutated in place by span enter/exit), so reads here see
# the live state; registration happens once per thread.
_live_lock = threading.Lock()
_live_stacks: dict[int, tuple[str, list]] = {}


def live_spans() -> dict[str, list[str]]:
    """The open span stack of every live thread, outermost first:
    ``{thread_name: [span names]}``. Threads with no open span are
    omitted; stacks of dead threads are pruned. Snapshot semantics — the
    lists are copied, concurrent span exits cannot mutate the result."""
    alive = {t.ident: t for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    with _live_lock:
        for ident in list(_live_stacks):
            if ident not in alive:
                del _live_stacks[ident]
                continue
            name, stack = _live_stacks[ident]
            if stack:
                out[name] = [s[1] for s in list(stack)]
    return out


def enabled() -> bool:
    """Is span recording globally enabled (``DMP_TRACING``, default on)?
    A disabled process still *runs* every instrumented site — spans just
    skip the stack push and the record write."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip span recording process-wide."""
    global _enabled
    _enabled = bool(on)


def install(sink) -> None:
    """Bind ``sink`` (a :class:`~.telemetry.TelemetryRun`, or anything
    with ``.record(kind, **fields)``) as THIS thread's span sink; a later
    install on the same thread replaces the binding."""
    _state.sink = sink


def installed():
    """This thread's bound span sink (None when spans are dropped)."""
    return getattr(_state, "sink", None)


def uninstall() -> None:
    _state.sink = None


class sink_scope:
    """Bind a sink for a scope, restoring the previous binding on exit:
    ``with tracing.sink_scope(run): ...``. A ``None`` sink leaves the
    current binding in place (the serving engine runs with or without a
    telemetry stream attached)."""

    def __init__(self, sink):
        self.sink = sink
        self._prev = None

    def __enter__(self):
        if self.sink is not None:
            self._prev = installed()
            install(self.sink)
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            install(self._prev)
        return False


def _stack() -> list:
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = []
        t = threading.current_thread()
        with _live_lock:
            _live_stacks[t.ident] = (t.name, st)
    return st


def record_span(name: str, dur_s: float, *, t0: float | None = None,
                sink=None, **attrs: Any) -> None:
    """Imperative form: write one ``span`` record for an interval timed
    by the caller (sites where the interval already exists as a number
    and wrapping the work in a context manager would restructure it).
    Parent/depth come from the thread's live span stack, so imperative
    spans nest under whatever ``with span(...)`` is open."""
    sink = sink if sink is not None else installed()
    if sink is None or not _enabled:
        return
    st = _stack()
    parent = st[-1][0] if st else None
    try:
        sink.record("span", name=name,
                    t0=t0 if t0 is not None else time.time() - dur_s,
                    dur_s=dur_s, sid=next(_ids), parent=parent,
                    depth=len(st),
                    thread=threading.current_thread().name, **attrs)
    except Exception:
        # A stale/unwritable sink must not take down the recording site:
        # spans are observability, not control flow.
        pass


_trace_ids = itertools.count(1)   # per-process request trace ids


def new_trace_id() -> str:
    """A process-unique request trace id (``rtrace`` records carry it as
    ``trace``). Stamped once per request at admission into the serving
    tier — the identity that survives queueing, migration between
    replicas, and brownout clamps."""
    return f"{os.getpid():x}-{next(_trace_ids):x}"


def rtrace(req, event: str, *, sink=None, **fields: Any) -> None:
    """Write one typed ``rtrace`` record for a request-scoped event.

    ``req`` is any object carrying ``trace_id`` (str | None), ``trace_seq``
    (int) and ``rid`` — in practice serve/scheduler.py's ``Request``. The
    per-request sequence number is incremented HERE, under the emitting
    thread, so a request's records are causally ordered by ``seq`` even
    when wall-clock ``ts`` ties (two events inside one engine iteration)
    or skews across streams. Because the Request OBJECT migrates between
    replicas (export/import moves KV pages by value, not the request),
    ``seq`` stays monotonic across the hop — the joiner links the two
    stream segments by ``(trace, seq)`` adjacency.

    No-op when the request was never stamped (``trace_id`` is None — an
    engine without telemetry) or no sink resolves; never raises (tracing
    is observability, not control flow)."""
    trace = getattr(req, "trace_id", None)
    if trace is None:
        return
    sink = sink if sink is not None else installed()
    if sink is None:
        return
    req.trace_seq += 1
    try:
        sink.record("rtrace", trace=trace, seq=req.trace_seq,
                    request=req.rid, event=event, **fields)
    except Exception:
        pass


class span:
    """``with span("drain", n=3): ...`` — or ``@span("evaluate")`` as a
    decorator (each call gets its own span). Attributes land on the
    record; :meth:`annotate` adds more from inside the body. An
    exception inside the span still writes the record, with
    ``error=<ExceptionType>`` — a timeline that loses its crashing span
    hides exactly the interval being debugged."""

    __slots__ = ("name", "attrs", "_sink", "_sid", "_parent", "_depth",
                 "_t0m", "_t0w")

    def __init__(self, name: str, **attrs: Any):
        self.name = name
        self.attrs = attrs
        self._sink = None

    def __enter__(self):
        sink = installed()
        if sink is None or not _enabled:
            self._sink = None
            return self
        self._sink = sink
        st = _stack()
        self._parent = st[-1][0] if st else None
        self._depth = len(st)
        self._sid = next(_ids)
        st.append((self._sid, self.name))
        self._t0w = time.time()
        self._t0m = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sink is None:
            return False
        dur = time.monotonic() - self._t0m
        st = _stack()
        # Pop our own frame; a mispaired stack (a site that leaked spans
        # across threads) must not corrupt later spans' parents.
        while st and st[-1][0] != self._sid:
            st.pop()
        if st:
            st.pop()
        fields = dict(self.attrs)
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        try:
            self._sink.record("span", name=self.name, t0=self._t0w,
                              dur_s=dur, sid=self._sid, parent=self._parent,
                              depth=self._depth,
                              thread=threading.current_thread().name,
                              **fields)
        except Exception:
            # A full disk / closed stream must not take down the traced
            # run: spans are observability, not control flow.
            pass
        self._sink = None
        return False

    def annotate(self, **attrs: Any) -> None:
        """Add attributes from inside the body (values computed by the
        spanned work itself, e.g. how many batches a drain folded)."""
        self.attrs.update(attrs)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(self.name, **self.attrs):
                return fn(*args, **kwargs)
        return wrapped
