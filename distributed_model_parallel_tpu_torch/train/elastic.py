"""Elastic restart: topology-change-resilient resume.

Counterpart of ``distributed_model_parallel_tpu/train/elastic.py``. A
preempted job often gets back fewer devices than it lost. Three pieces
make its restart exact:

* **exact mid-epoch resume** — the loader position, the global step and
  the recovery budgets ride in every checkpoint
  (:func:`build_resume_tree`, kept in ``train/checkpoint.py`` and
  re-exported here), and the step-cadence **emergency slot**
  (:class:`EmergencyCheckpointer`, ``emergency_every``) bounds what a
  kill loses;
* **resharded restore** — every leaf is whole in the file, so
  ``Checkpointer.restore_resharded`` restores a checkpoint of any mesh
  split onto this one, and raises ``TopologyMismatchError`` where the
  global shapes conflict;
* **restart supervision** — :func:`fit_mesh_to_devices` shrinks the data
  axis to what the live world supports (``elastic=True``), and
  :func:`elastic_restore` takes the newest valid of the trainer's slots,
  walking past torn versions and fully torn slots.

Every resume writes a ``resume`` record into the run's ``.jsonl``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from distributed_model_parallel_tpu_torch.config import MeshConfig
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    Checkpointer,
    CheckpointIntegrityError,
    TopologyMismatchError,
    build_resume_tree,
    unpack_resume_tree,
)
from distributed_model_parallel_tpu_torch.utils import tracing

__all__ = [
    "ElasticDecision",
    "EmergencyCheckpointer",
    "TopologyMismatchError",
    "build_resume_tree",
    "elastic_restore",
    "fit_mesh_to_devices",
    "live_device_count",
    "unpack_resume_tree",
]


def live_device_count() -> int:
    """The devices this restart has: the process group's world size (one
    rank a device), or 1 for a lone process."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class ElasticDecision:
    """What :func:`fit_mesh_to_devices` decided and why (logged)."""

    n_devices: int
    requested: dict
    resolved: dict
    changed: bool

    def describe(self) -> str:
        if not self.changed:
            return (f"elastic: mesh {self.resolved} fits the "
                    f"{self.n_devices} live devices unchanged")
        return (f"elastic: rebuilt mesh for {self.n_devices} live devices: "
                f"{self.requested} -> {self.resolved}")


def fit_mesh_to_devices(mesh: MeshConfig, n_devices: int, *,
                        batch_size: int | None = None
                        ) -> tuple[MeshConfig, ElasticDecision]:
    """Shrink the data axis to the largest degree the live device count
    (and the global batch's divisibility) supports. Only data parallelism
    is elastic: the other axes partition the model, so too few devices for
    ``stage*model*seq*expert`` raises. The dcn factor is kept when it
    divides the new degree, else dropped to 1."""
    if n_devices < 1:
        raise ValueError(f"need at least one live device, got {n_devices}")
    other = mesh.stage * mesh.model * mesh.seq * mesh.expert
    if other > n_devices:
        raise ValueError(
            f"non-data mesh axes need {other} devices "
            f"(stage={mesh.stage}, model={mesh.model}, seq={mesh.seq}, "
            f"expert={mesh.expert}) but only {n_devices} are live — "
            f"model-partitioning axes are not elastic")
    dp = min(mesh.data, n_devices // other)
    while dp > 1 and batch_size is not None and batch_size % dp:
        dp -= 1
    dcn = mesh.dcn_data if mesh.dcn_data > 1 and dp % mesh.dcn_data == 0 \
        else 1
    resolved = dataclasses.replace(mesh, data=dp, dcn_data=dcn)
    requested_sizes = {**mesh.axis_sizes(), "dcn_data": mesh.dcn_data}
    resolved_sizes = {**resolved.axis_sizes(), "dcn_data": resolved.dcn_data}
    return resolved, ElasticDecision(
        n_devices=n_devices, requested=requested_sizes,
        resolved=resolved_sizes, changed=resolved_sizes != requested_sizes)


def elastic_restore(ckpt: Checkpointer, templates: Sequence[Any],
                    names: Sequence[str], *,
                    on_fallback: Callable[[str, str], None] | None = None
                    ) -> tuple[str, Any]:
    """Newest-valid-slot restore: walk ``names`` newest first, trying each
    template layout on each slot through ``restore_resharded``. A torn
    version falls back to the one before; a slot where every template hit
    ``CheckpointIntegrityError`` falls back to the next slot; a slot that
    matches no template raises (resuming a stale slot is worse); a
    ``TopologyMismatchError`` propagates at once. Manifest checks are
    memoized across templates and ``on_fallback`` fires once per rejected
    version. Returns ``(slot, tree)``; FileNotFoundError when no slot
    exists."""
    ordered = ckpt.names_by_recency(tuple(names))
    if not ordered:
        raise FileNotFoundError(
            f"no checkpoint under any of {tuple(names)} in {ckpt.directory}")
    with tracing.span("elastic_restore", slots=",".join(ordered)):
        return _elastic_restore_ladder(ckpt, templates, ordered,
                                       on_fallback=on_fallback)


def _elastic_restore_ladder(ckpt: Checkpointer, templates: Sequence[Any],
                            ordered: Sequence[str], *,
                            on_fallback: Callable[[str, str], None] | None
                            ) -> tuple[str, Any]:
    verify_memo: dict = {}
    seen_fallbacks: set[str] = set()

    def _on_fallback(path: str, reason: str) -> None:
        if path in seen_fallbacks:
            return
        seen_fallbacks.add(path)
        if on_fallback is not None:
            on_fallback(path, reason)

    slot_errors: list[tuple[str, BaseException]] = []
    for name in ordered:
        last: BaseException | None = None
        integrity: BaseException | None = None
        for tmpl in templates:
            try:
                return name, ckpt.restore_resharded(
                    tmpl, name, allow_fallback=True,
                    on_fallback=_on_fallback, verify_memo=verify_memo)
            except TopologyMismatchError:
                raise
            except CheckpointIntegrityError as e:
                integrity = e
                continue
            except (ValueError, KeyError, TypeError) as e:
                last = e
        if last is not None:
            raise ValueError(
                f"checkpoint slot {name!r} does not match any of the "
                f"{len(templates)} resume template layouts — resuming "
                f"requires the same model and optimizer as the saving run"
            ) from last
        slot_errors.append((name, integrity))
    raise CheckpointIntegrityError(
        "no restorable slot among "
        + ", ".join(f"{n} ({type(e).__name__})" for n, e in slot_errors))


class EmergencyCheckpointer:
    """Step-cadence writer of the emergency slot: every ``every`` consumed
    steps it saves the trainer's full resume tree under ``slot`` (keeping
    its own ``keep`` newest versions). ``writer`` saves; every rank builds
    the tree (its gathers are collectives) and meets at ``barrier``.
    Disabled (``every=0``) it costs one integer compare a call."""

    def __init__(self, ckpt: Checkpointer, slot: str, every: int, *,
                 logger=None, wait: bool = True, keep: int = 2,
                 writer: bool = True,
                 barrier: Callable[[], None] | None = None):
        if every < 0:
            raise ValueError(f"emergency_every must be >= 0, got {every}")
        self.ckpt = ckpt
        self.slot = slot
        self.every = int(every)
        self.logger = logger
        self.wait = wait
        self.keep = keep
        self.writer = writer
        self.barrier = barrier
        self.saves = 0
        self._since = 0

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def after_step(self, n_steps: int, tree_fn: Callable[[], Any]) -> bool:
        """Advance by ``n_steps`` consumed steps; save when the cadence
        elapses (the overshoot of a multi-step dispatch carries, modulo
        the cadence). Returns whether a save was written."""
        if not self.enabled or n_steps <= 0:
            return False
        self._since += int(n_steps)
        if self._since < self.every:
            return False
        self._since %= self.every
        tree = tree_fn()
        if self.writer:
            self.ckpt.save(tree, self.slot, wait=self.wait, keep=self.keep)
        if self.barrier is not None:
            self.barrier()
        self.saves += 1
        if self.logger is not None:
            from distributed_model_parallel_tpu_torch.utils.telemetry import (
                registry,
            )

            registry().counter("emergency_saves").inc()
            self.logger.telemetry.record(
                "event", message=f"emergency checkpoint #{self.saves} -> "
                                 f"{self.slot}")
        return True
