"""Write-ahead request journal: crash-consistent serving state.

Counterpart of ``distributed_model_parallel_tpu/serve/journal.py`` (no
framework code; the port's own copy). A graceful drain carries exported
K/V pages to a peer; a hard crash (process gone, device memory gone)
has nothing to carry. The determinism contract (tokens = f(prompt,
seed), which the engine asserts) makes durability nearly free: durable
*intent* plus a committed-token watermark reconstructs any request —
no K/V export needed, the pages are recomputed by re-prefilling prompt
+ committed tokens.

One JSONL journal per fleet, three record kinds (all carry ``ts``):

==========  ==========================================================
kind        payload keys
==========  ==========================================================
intent      rid, trace, prompt (token list), seed, max_new_tokens,
            priority, queue_budget_s, deadline_s, arrival_s — one per
            ACCEPTED request, written before the engine touches it
            and fsync'd (the durability boundary: an accepted request
            survives any later crash)
watermark   rid, tokens (committed token VALUES since the previous
            watermark), committed (running total) — flushed, not
            fsync'd: a lost tail only widens the deterministic replay,
            never loses a request
terminal    rid, outcome (completed | shed | failed) — exactly one per
            journaled request; recovery never re-serves a terminaled
            rid (exactly-once accounting, dedup by rid). Flushed at
            write, fsync'd in groups (``terminal_sync_every``, plus
            every intent fsync — fdatasync covers the whole file — and
            :meth:`~RequestJournal.close`)
==========  ==========================================================

Why terminals group-sync while intents fsync one by one: a flushed
record survives PROCESS death (it is in the page cache); only a host
crash can tear it off, and a terminal lost to a host crash is
reconstructed by the replay itself — the request re-completes with
bitwise-identical tokens and re-journals its terminal. The worst case
is duplicate delivery of an identical payload, never divergent
accounting, which is the standard group-commit trade (Postgres
``synchronous_commit=off``) made strictly safer by the determinism
contract. A lost INTENT, by contrast, silently cancels an accepted
request — that is why the admission path pays a per-record fsync and
the serve loop does not. Set
``terminal_sync_every=1`` for strict per-terminal fsync.

Rotation mirrors :class:`~..utils.telemetry.TelemetryRun` (live file
renamed to ``{stem}.N{ext}``); readers fold all parts through
``telemetry.read_records``, which skips a torn trailing line (a crash
mid-write) and counts it on ``telemetry_torn_lines`` — recovery
proceeds on the surviving prefix.

Reopening an existing journal path resumes its state (known intents,
terminals, committed counts) so dedup holds across a full fleet
restart, and :func:`fold` turns the on-disk records into the
:class:`JournalState` a recovery path replays from (re-admitting each
pending intent as a ``replay`` request).

A module-level :func:`install` registry (mirroring ``utils.health``)
lets a crash flight recorder grab the installed journal's tail without
plumbing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from distributed_model_parallel_tpu_torch.utils.telemetry import (
    read_records,
    registry,
    stream_parts,
)

__all__ = [
    "JournalState",
    "RequestJournal",
    "TERMINAL_OUTCOMES",
    "fold",
    "install",
    "installed",
]

TERMINAL_OUTCOMES = ("completed", "shed", "failed")

# fsync-now boundary: an intent's loss silently cancels an accepted
# request, so it is the one kind that always pays a per-record fsync.
# Terminals group-sync (see the module docstring's trade-off note);
# watermarks are a replay optimization and may tear freely.
_DURABLE_KINDS = frozenset({"intent"})

# Intent fields copied verbatim from the Request at admission and back
# onto the reconstructed Request at recovery — the request identity,
# not its runtime state.
_INTENT_FIELDS = ("prompt", "seed", "max_new_tokens", "priority",
                  "queue_budget_s", "deadline_s", "arrival_s", "tenant")


@dataclasses.dataclass
class JournalState:
    """Folded view of a journal's records (:func:`fold`)."""

    intents: dict[str, dict]             # rid -> intent payload
    tokens: dict[str, list[int]]         # rid -> committed token values
    terminals: dict[str, str]            # rid -> outcome

    def pending(self) -> list[str]:
        """Rids recovery owes: journaled intent, no journaled terminal,
        in intent (acceptance) order — the deterministic replay order."""
        return [rid for rid in self.intents if rid not in self.terminals]


def fold(path: str) -> JournalState:
    """Fold a journal stream (all rotated parts, torn tail skipped via
    ``telemetry.read_records``) into a :class:`JournalState`."""
    state = JournalState(intents={}, tokens={}, terminals={})
    for rec in read_records(path):
        kind, rid = rec.get("kind"), rec.get("rid")
        if rid is None:
            continue
        if kind == "intent":
            state.intents.setdefault(rid, rec)
            state.tokens.setdefault(rid, [])
        elif kind == "watermark":
            toks = state.tokens.setdefault(rid, [])
            toks.extend(int(t) for t in rec.get("tokens", ()))
            want = rec.get("committed")
            if want is not None and len(toks) != int(want):
                raise ValueError(
                    f"journal {path}: watermark total for {rid!r} claims "
                    f"{want} committed tokens but the folded deltas give "
                    f"{len(toks)} — the stream is out of order or a "
                    f"NON-trailing record was lost")
        elif kind == "terminal":
            state.terminals.setdefault(rid, rec.get("outcome", "completed"))
    return state


class RequestJournal:
    """Append-only write-ahead journal for one serving fleet.

    ``watermark_every`` batches committed tokens: a request's watermark
    record is written once that many tokens accumulate since its last
    watermark (and on :meth:`flush_watermarks`). ``terminal_sync_every``
    group-commits terminal fsyncs (1 = strict per-terminal fsync; see
    the module docstring for why the default lag is safe). ``max_bytes``
    enables telemetry-style rotation. Reopening an existing path
    resumes its dedup state from disk.
    """

    def __init__(self, path: str, *, watermark_every: int = 8,
                 terminal_sync_every: int = 8,
                 max_bytes: int | None = None):
        if watermark_every < 1:
            raise ValueError(f"watermark_every must be >= 1, got "
                             f"{watermark_every}")
        if terminal_sync_every < 1:
            raise ValueError(f"terminal_sync_every must be >= 1, got "
                             f"{terminal_sync_every}")
        self.path = path
        self.watermark_every = int(watermark_every)
        self.terminal_sync_every = int(terminal_sync_every)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._fh = None                 # persistent append handle
        self._intents: set[str] = set()
        self._terminals: set[str] = set()
        self._committed: dict[str, int] = {}    # rid -> journaled total
        self._pending: dict[str, list[int]] = {}  # rid -> unjournaled toks
        self._records = 0
        self._fsyncs = 0
        self._unsynced_terminals = 0
        # Cached metric handles: a registry lookup per record is
        # measurable on the serve loop's overhead budget.
        self._m_records = registry().counter("journal_records")
        self._m_fsyncs = registry().counter("journal_fsyncs")
        # Monotonic seconds spent inside record() — the journal's
        # overhead on the serve loop.
        self.write_s = 0.0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if stream_parts(path):
            # fold FIRST (read_records counts a torn tail on
            # telemetry_torn_lines), then drop the torn partial line so
            # post-recovery appends start on a record boundary instead
            # of concatenating onto it.
            prior = fold(path)
            self._truncate_torn_tail()
            self._intents = set(prior.intents)
            self._terminals = set(prior.terminals)
            self._committed = {r: len(t) for r, t in prior.tokens.items()}

    def _truncate_torn_tail(self) -> None:
        """Truncate the live file back to its last complete line. Only
        the live file can tear mid-append (rotated parts are closed
        whole), and the torn record was never durable — dropping it is
        exactly what fold() already pretended happened."""
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                f.seek(size - 1)
                if f.read(1) == b"\n":
                    return
                keep, pos, chunk = 0, size, 1 << 16
                while pos > 0:
                    step = min(chunk, pos)
                    f.seek(pos - step)
                    cut = f.read(step).rfind(b"\n")
                    if cut != -1:
                        keep = pos - step + cut + 1
                        break
                    pos -= step
                f.truncate(keep)
        except OSError:
            pass

    # -- writer -------------------------------------------------------------

    def record(self, kind: str, **payload) -> None:
        """Append one typed record; fsync-now for intents, group-sync
        for terminals, flush-only for watermarks."""
        t0 = time.monotonic()
        rec = {"ts": time.time(), "kind": kind, **payload}
        line = json.dumps(rec)
        synced = False
        with self._lock:
            self._maybe_rotate(len(line) + 1)
            # One persistent append handle (reopened across rotation):
            # an open() per record would cost more than the record.
            if self._fh is None:
                self._fh = open(self.path, "a")
            f = self._fh
            f.write(line + "\n")
            f.flush()
            if kind == "terminal":
                self._unsynced_terminals += 1
            if kind in _DURABLE_KINDS or (
                    self._unsynced_terminals >= self.terminal_sync_every):
                try:
                    # fdatasync: the data must be durable; the inode
                    # mtime may tear (cheaper on ext4, same recovery).
                    # One sync covers every earlier flushed record, so
                    # intent fsyncs retire pending terminals for free.
                    getattr(os, "fdatasync", os.fsync)(f.fileno())
                    self._fsyncs += 1
                    self._unsynced_terminals = 0
                    synced = True
                except OSError:
                    pass
            self._records += 1
        self._m_records.inc()
        if synced:
            self._m_fsyncs.inc()
        self.write_s += time.monotonic() - t0

    def _maybe_rotate(self, incoming: int) -> None:
        if self.max_bytes is None or not os.path.exists(self.path):
            return
        if os.path.getsize(self.path) + incoming <= self.max_bytes:
            return
        stem, ext = os.path.splitext(self.path)
        idx = len(stream_parts(self.path))   # live file -> next part index
        if self._fh is not None:
            # POSIX rename leaves an open fd pointing at the ROTATED
            # file; later appends must land in a fresh live file.
            self._fh.close()
            self._fh = None
        os.replace(self.path, f"{stem}.{idx}{ext}")

    def intent(self, req) -> bool:
        """Journal an accepted request's admission intent (durable).
        Dedups by rid — a recovery resubmission is a no-op — and
        returns whether a record was written."""
        if req.rid in self._intents:
            return False
        self._intents.add(req.rid)
        self._committed.setdefault(req.rid, 0)
        self.record("intent", rid=req.rid, trace=req.trace_id,
                    **{f: getattr(req, f, None) for f in _INTENT_FIELDS})
        return True

    def commit(self, rid: str, tokens) -> None:
        """Buffer committed token values for ``rid``; a watermark record
        is written once ``watermark_every`` accumulate. Only MODEL-
        COMMITTED tokens belong here (the engine calls this exactly
        where tokens enter ``req.generated`` — a speculative draft's
        rejected tail never reaches the journal)."""
        if rid not in self._intents or rid in self._terminals:
            return
        buf = self._pending.setdefault(rid, [])
        buf.extend(int(t) for t in tokens)
        if len(buf) >= self.watermark_every:
            self._flush_one(rid)

    def _flush_one(self, rid: str) -> None:
        buf = self._pending.pop(rid, None)
        if not buf:
            return
        total = self._committed.get(rid, 0) + len(buf)
        self._committed[rid] = total
        self.record("watermark", rid=rid, tokens=buf, committed=total)

    def flush_watermarks(self) -> None:
        """Write every buffered watermark (end-of-run / pre-restart
        tightening; never required for correctness — a lost buffer only
        widens the deterministic replay)."""
        for rid in list(self._pending):
            self._flush_one(rid)

    def sync(self) -> None:
        """fdatasync the live file now — retires any group-pending
        terminal syncs (a graceful-shutdown tightening; crash paths by
        definition never reach it)."""
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.flush()
                getattr(os, "fdatasync", os.fsync)(self._fh.fileno())
                self._fsyncs += 1
                self._unsynced_terminals = 0
            except OSError:
                return
        self._m_fsyncs.inc()

    def close(self) -> None:
        """Flush buffered watermarks (tightening, not required), sync,
        and release the append handle. The journal stays usable — the
        next record reopens the live file."""
        self.flush_watermarks()
        self.sync()
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def discard_pending(self, rid: str) -> None:
        """Drop ``rid``'s buffered (not-yet-journaled) tokens. Crash
        recovery truncates a request to its DISK watermark before
        replaying; the replayed decode re-commits the same token values,
        and without this reset the surviving in-process buffer would
        double-count them (fold's committed-total check would then
        fail). The journaled total (``_committed``) already matches the
        disk — only the buffer is stale."""
        self._pending.pop(rid, None)

    def terminal(self, rid: str, outcome: str) -> bool:
        """Journal a request's single terminal (durable). Silently drops
        rids with no journaled intent (never-accepted requests owe no
        terminal) and dedups by rid — exactly-once accounting even when
        a recovered request re-completes. Returns whether written."""
        if outcome not in TERMINAL_OUTCOMES:
            raise ValueError(f"unknown terminal outcome {outcome!r}; "
                             f"known: {TERMINAL_OUTCOMES}")
        if rid not in self._intents or rid in self._terminals:
            return False
        self._terminals.add(rid)
        self._flush_one(rid)        # terminal supersedes buffered tokens
        self.record("terminal", rid=rid, outcome=outcome)
        return True

    # -- introspection ------------------------------------------------------

    def is_terminal(self, rid: str) -> bool:
        return rid in self._terminals

    def position(self) -> dict:
        """Where the journal stands — stamped on crash-path failure
        records so a postmortem names the exact replay point."""
        try:
            nbytes = os.path.getsize(self.path)
        except OSError:
            nbytes = 0
        return {"records": self._records, "bytes": nbytes,
                "parts": len(stream_parts(self.path)),
                "fsyncs": self._fsyncs}

    def tail(self, n: int = 50) -> list[str]:
        """The last ``n`` raw journal lines (across rotation), torn tail
        included verbatim — what a postmortem bundle carries."""
        lines: list[str] = []
        for part in stream_parts(self.path):
            try:
                with open(part) as f:
                    lines.extend(ln.rstrip("\n") for ln in f)
            except OSError:
                continue
        return lines[-n:]

    def state(self) -> JournalState:
        """Fold the on-disk records (plus nothing in-memory: buffered
        watermarks are by definition not yet journaled)."""
        return fold(self.path)

    def summary(self) -> dict:
        return {"records": self._records, "fsyncs": self._fsyncs,
                "intents": len(self._intents),
                "terminals": len(self._terminals),
                "write_s": self.write_s}


# ---------------------------------------------------------------------------
# Process-wide registry (flight-recorder integration)
# ---------------------------------------------------------------------------

_installed: RequestJournal | None = None


def install(journal: RequestJournal | None) -> None:
    """Register the process's live journal (``None`` uninstalls) so the
    crash flight recorder can bundle its tail without plumbing."""
    global _installed
    _installed = journal


def installed() -> RequestJournal | None:
    return _installed
