"""Preemption-safe training — the port of ``distributed_model_parallel_
tpu/train/preemption.py``: SIGTERM/SIGINT (a cluster's eviction notice,
Ctrl-C) set a cooperative stop flag; the epoch loops poll it at each
train-step boundary, write a checkpoint to its own ``"preempt"`` slot
and return, so ``resume=True`` continues at the interrupted step.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading

logger = logging.getLogger(__name__)

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def checkpoint_on_preempt(guard: "PreemptionGuard", ckpt, tree, name: str,
                          logger, epoch: int, *,
                          global_step: int | None = None) -> None:
    """Honor a preemption: a durable save of ``tree`` (the trainer's full
    checkpoint, exact-continuation subtree included) under slot
    ``name``, one event line, and the request consumed (a later ``fit``
    trains normally). ``ckpt`` is None on the ranks that do not write."""
    if ckpt is not None:
        ckpt.save(tree, name, wait=True)
    if logger is not None:
        logger.log_line(f"preempted: checkpoint saved at epoch {epoch}"
                        + (f", global step {global_step}"
                           if global_step is not None else ""))
    guard.reset()


class PreemptionGuard:
    """SIGTERM/SIGINT → a thread-safe "stop requested" flag.

    A second SIGINT while the flag is set chains to the handler installed
    before (or raises KeyboardInterrupt): the first Ctrl-C asks for a
    checkpointed stop, the second aborts. Installing is a no-op off the
    main thread; :meth:`request` works from anywhere."""

    def __init__(self, signals=DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict[int, object] = {}

    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Request a graceful stop (tests, cluster-API callbacks)."""
        self._event.set()

    def reset(self) -> None:
        self._event.clear()

    def _handler(self, signum, frame):
        if self._event.is_set() and signum == signal.SIGINT:
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            raise KeyboardInterrupt
        logger.warning("signal %s: requesting graceful checkpointed stop "
                       "(repeat SIGINT to abort hard)", signum)
        self._event.set()

    @contextlib.contextmanager
    def installed(self):
        """Install the handlers for the scope of a ``fit``, restoring the
        earlier ones on exit."""
        installed = []
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
                installed.append(s)
            except ValueError:      # not the main thread
                logger.debug("cannot install handler for %s off the main "
                             "thread", s)
        try:
            yield self
        finally:
            for s in installed:
                signal.signal(s, self._prev.pop(s))
