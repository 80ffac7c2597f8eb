"""Run logging — the port of ``distributed_model_parallel_tpu/train/
logging_util.py``: the reference's per-epoch text line
(``data_parallel.py:167-171``) in ``{name}.txt``, character for
character the JAX ``RunLogger``'s, and plain JSON records in
``{name}.jsonl``: ``run_start``, ``epoch``, ``step``, ``event`` and
``run_end``, one object a line with a ``kind`` key.

The JAX package's ``.jsonl`` is the typed telemetry stream of
``utils/telemetry.py`` (spans, memory watermarks, failure/recovery
records) that its report script renders; that stream is not ported yet
(ROADMAP A11): these records carry the same keys for ``epoch`` and
``step`` and no more. Echoed lines go to standard error: standard output
carries the CLIs' JSON records.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Mapping


def _plain(v: Any) -> Any:
    """A JSON-able copy of a metric (numpy scalars to Python)."""
    return v.item() if hasattr(v, "item") else v


class RunLogger:
    def __init__(self, log_dir: str, name: str, *, echo: bool = True,
                 meta: Mapping[str, Any] | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self.txt_path = os.path.join(log_dir, f"{name}.txt")
        self.jsonl_path = os.path.join(log_dir, f"{name}.jsonl")
        self.echo = echo
        self.run = name
        self._record("run_start", meta=dict(meta or {}))

    def _record(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "run": self.run, "time": time.time(),
               **{k: _plain(v) for k, v in fields.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _echo(self, line: str) -> None:
        if self.echo:
            print(line, file=sys.stderr, flush=True)

    def log_epoch(self, epoch: int, **metrics: Any) -> None:
        # The reference's epoch record (data_parallel.py:167-171).
        parts = [f"epoch:{epoch}"] + [
            f"{k}:{v:.6g}" if isinstance(v, float) else f"{k}:{v}"
            for k, v in metrics.items()
        ]
        line = " ".join(parts)
        with open(self.txt_path, "a") as f:
            f.write(line + "\n")
        self._record("epoch", epoch=epoch, **metrics)
        self._echo(line)

    def log_line(self, message: str) -> None:
        """Free-form event line (preemption, resume) to both files."""
        with open(self.txt_path, "a") as f:
            f.write(message + "\n")
        self._record("event", message=message)
        self._echo(message)

    def log_step(self, epoch: int, step: int, **metrics: Any) -> None:
        """Per-step record (at the trainer's ``log_every_n_steps``):
        persisted, and echoed in the reference's ``[epoch:step]`` form."""
        self._record("step", epoch=epoch, step=step, **metrics)
        self._echo(" ".join([f"[{epoch}:{step}]"] + [
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()]))

    def finish(self, **fields: Any) -> None:
        """Close out the run (a ``run_end`` record)."""
        self._record("run_end", **fields)
