"""Device-pool admission control and priority preemption.

The counterpart of ``distributed_model_parallel_tpu/orchestrator/
scheduler.py``: the same ledger, placement rules and messages, pure
deterministic bookkeeping (no threads, no processes), so a fixed
submission order replays the same schedule.

* :class:`DevicePool` is the ownership ledger. The JAX pool keys JAX
  devices by their ``.id``; a ``torch.device`` has no id (only
  ``.index``, and several slots may share a card), so this pool holds
  :class:`DeviceSlot` records, each an ``id`` and the ``torch.device`` it
  stands for. A plain list of ``torch.device`` s (or device strings)
  becomes slots numbered by position; the default is one slot per card.
* :class:`Scheduler` is the placement policy over it, in the pool's slot
  ids: a tenant's slice is exactly what its resolved mesh needs (the
  data axis shrinks to the free slots and the batch, the other axes and
  a pipeline's stage count do not), queued tenants are served in
  (priority desc, submission order) with head-of-line blocking, and
  victims are chosen lowest priority first, newest admission first
  within a priority, only when the slots they free (out-of-service ones
  not counted) make the waiter placeable.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from distributed_model_parallel_tpu_torch.utils.health import (
    DeviceDegradedError,
)

__all__ = ["DevicePool", "DeviceSlot", "Scheduler"]


@dataclasses.dataclass(frozen=True)
class DeviceSlot:
    """One schedulable unit of the pool: ``id`` keys the ledger,
    ``device`` is where work placed on the slot runs."""

    id: int
    device: torch.device


def _slots(devices) -> tuple[DeviceSlot, ...]:
    out = []
    for i, d in enumerate(devices):
        if isinstance(d, DeviceSlot):
            out.append(d)
        else:
            out.append(DeviceSlot(id=i, device=torch.device(d)))
    ids = [s.id for s in out]
    if len(set(ids)) != len(ids):
        raise ValueError(f"device pool slot ids repeat: {ids}")
    return tuple(out)


class DevicePool:
    """Ownership ledger for the fleet's device slots.

    ``revoke``/``restore`` model topology shrink/grow (a maintenance
    event taking a sub-slice away and giving it back): revoked slots
    exist but are not schedulable. ``quarantine``/``reinstate`` are the
    health-driven counterpart (utils/health.py): the same
    not-schedulable effect, but reversed by the health sentinel after
    probation. The two sets are disjoint. ``devices`` defaults to one
    slot per card (``range(torch.cuda.device_count())``).
    """

    def __init__(self, devices: Sequence | None = None):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = _slots(devices)
        if not self.devices:
            raise ValueError("device pool needs at least one device")
        self._free = [d.id for d in self.devices]
        self._revoked: list[int] = []
        self._quarantined: list[int] = []
        self._assigned: dict[str, tuple[int, ...]] = {}
        self._by_id = {d.id: d for d in self.devices}

    # -- views ---------------------------------------------------------------
    @property
    def free_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self._free))

    @property
    def revoked_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self._revoked))

    @property
    def quarantined_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self._quarantined))

    def assigned_ids(self, tenant: str) -> tuple[int, ...]:
        return self._assigned.get(tenant, ())

    def assignments(self) -> dict[str, tuple[int, ...]]:
        return dict(self._assigned)

    @property
    def n_free(self) -> int:
        return len(self._free)

    # -- transitions ---------------------------------------------------------
    def assign(self, tenant: str, n: int) -> tuple[DeviceSlot, ...]:
        """Grant ``n`` free slots (lowest ids first) to ``tenant``. Raises
        when the pool cannot satisfy the request or the tenant already
        holds a slice."""
        if tenant in self._assigned:
            raise RuntimeError(f"tenant {tenant!r} already holds devices "
                               f"{self._assigned[tenant]}")
        if n > len(self._free):
            raise RuntimeError(
                f"cannot grant {n} devices to {tenant!r}: only "
                f"{len(self._free)} free")
        grant = sorted(self._free)[:n]
        if set(grant) & set(self._quarantined):
            # Quarantined ids never sit in the free list: reaching this
            # means the ledger itself is corrupt.
            raise DeviceDegradedError(
                f"grant for {tenant!r} includes quarantined devices "
                f"{sorted(set(grant) & set(self._quarantined))}")
        self._free = [i for i in self._free if i not in grant]
        self._assigned[tenant] = tuple(grant)
        return tuple(self._by_id[i] for i in grant)

    def assign_ids(self, tenant: str,
                   ids: Sequence[int]) -> tuple[DeviceSlot, ...]:
        """Grant a specific free id set to ``tenant`` — the serving
        fleet's grow-back path: a reinstated replica re-claims its exact
        pre-quarantine slice."""
        want = sorted(int(i) for i in ids)
        if tenant in self._assigned:
            raise RuntimeError(f"tenant {tenant!r} already holds devices "
                               f"{self._assigned[tenant]}")
        unknown = [i for i in want if i not in self._by_id]
        if unknown:
            raise KeyError(f"unknown device ids {unknown}")
        missing = [i for i in want if i not in self._free]
        if missing:
            raise RuntimeError(
                f"cannot grant {missing} to {tenant!r}: not free "
                f"(revoked {self.revoked_ids}, quarantined "
                f"{self.quarantined_ids})")
        self._free = [i for i in self._free if i not in want]
        self._assigned[tenant] = tuple(want)
        return tuple(self._by_id[i] for i in want)

    def release(self, tenant: str) -> tuple[int, ...]:
        """Return a tenant's slice to the pool. Slots revoked or
        quarantined while held go to their out-of-service set."""
        ids = self._assigned.pop(tenant, ())
        for i in ids:
            if i in self._revoked or i in self._quarantined:
                continue
            self._free.append(i)
        return ids

    def revoke(self, n: int) -> tuple[int, ...]:
        """Take ``n`` slots out of service (topology shrink): free slots
        first (highest ids first), then held ones marked in place."""
        out: list[int] = []
        free_take = sorted(self._free, reverse=True)[:n]
        self._free = [i for i in self._free if i not in free_take]
        out += free_take
        if len(out) < n:
            held = sorted((i for ids in self._assigned.values() for i in ids
                           if i not in self._revoked
                           and i not in self._quarantined), reverse=True)
            out += held[:n - len(out)]
        if len(out) < n:
            live = (len(self.devices) - len(self._revoked)
                    - len(self._quarantined))
            raise ValueError(
                f"cannot revoke {n} devices: pool has {live} in service")
        self._revoked += out
        return tuple(sorted(out))

    def restore(self, n: int | None = None) -> tuple[int, ...]:
        """Return revoked slots to service; ids still held are un-revoked
        in place. ``None`` restores all."""
        n = len(self._revoked) if n is None else min(n, len(self._revoked))
        back = sorted(self._revoked)[:n]
        self._revoked = [i for i in self._revoked if i not in back]
        held = {i for ids in self._assigned.values() for i in ids}
        for i in back:
            if i not in held:
                self._free.append(i)
        return tuple(back)

    def holders_of_revoked(self) -> list[str]:
        rev = set(self._revoked)
        return sorted(t for t, ids in self._assigned.items()
                      if rev & set(ids))

    # -- health-driven transitions (utils/health.py) -------------------------
    def quarantine(self, ids: Sequence[int]) -> tuple[int, ...]:
        """Take degrading slots out of service. Free ids leave the free
        list; held ids are marked in place. Already-quarantined ids are
        no-ops; a revoked id raises."""
        out: list[int] = []
        for i in ids:
            i = int(i)
            if i not in self._by_id:
                raise KeyError(f"unknown device id {i}")
            if i in self._quarantined:
                continue
            if i in self._revoked:
                raise ValueError(
                    f"device {i} is revoked (maintenance) — it cannot "
                    f"also be health-quarantined; restore it first")
            self._quarantined.append(i)
            if i in self._free:
                self._free.remove(i)
            out.append(i)
        return tuple(sorted(out))

    def reinstate(self, ids: Sequence[int] | None = None) -> tuple[int, ...]:
        """Return quarantined slots to service; ids still held are
        un-quarantined in place. ``None`` reinstates all."""
        take = (sorted(self._quarantined) if ids is None
                else [int(i) for i in ids if int(i) in self._quarantined])
        self._quarantined = [i for i in self._quarantined if i not in take]
        held = {i for a in self._assigned.values() for i in a}
        for i in take:
            if i not in held:
                self._free.append(i)
        return tuple(sorted(take))

    def holders_of_quarantined(self) -> list[str]:
        bad = set(self._quarantined)
        return sorted(t for t, ids in self._assigned.items()
                      if bad & set(ids))


class Scheduler:
    """Deterministic placement policy over a :class:`DevicePool`."""

    def __init__(self, pool: DevicePool):
        self.pool = pool

    # -- placement -----------------------------------------------------------
    def resolve_slice(self, spec, n_free: int) -> int | None:
        """How many slots ``spec`` (a ``TenantSpec``) would take from an
        ``n_free`` pool: the resolved mesh size after shrinking the data
        axis to fit (and to divide the batch), or None when the tenant
        cannot run on ``n_free`` at all (non-data axes too wide, a
        pipeline short of stages, or a corruption drill squeezed below two
        replicas)."""
        need = spec.min_devices()
        if n_free < need:
            return None
        if spec.workload == "pipeline":
            return spec.config.mesh.stage
        from distributed_model_parallel_tpu_torch.train.elastic import (
            fit_mesh_to_devices,
        )

        try:
            mesh_cfg, _ = fit_mesh_to_devices(spec.config.mesh, n_free,
                                              batch_size=spec.batch_size)
        except ValueError:
            return None
        n = mesh_cfg.num_devices
        return n if n >= need else None

    def pick_victims(self, waiter, running: Sequence) -> list | None:
        """Choose the strictly-lower-priority victims whose slices, added
        to the free pool (and to slices already draining), make ``waiter``
        placeable. Lowest priority first; newest admission first within a
        priority. None when no such set exists. Held slots that are
        revoked or quarantined do not return to the free pool when their
        holder drains, so they are not counted."""
        from distributed_model_parallel_tpu_torch.orchestrator.tenants import (
            TenantState,
        )

        out_of_service = (set(self.pool.revoked_ids)
                          | set(self.pool.quarantined_ids))

        def reclaimable(t) -> int:
            return sum(1 for d in t.devices if d.id not in out_of_service)

        draining = sum(reclaimable(t) for t in running
                       if t.state is TenantState.PREEMPTING)
        avail = self.pool.n_free + draining
        if self.resolve_slice(waiter.spec, avail) is not None:
            return []               # already satisfiable once drains land
        candidates = sorted(
            (t for t in running if t.state is TenantState.RUNNING
             and t.priority < waiter.priority),
            key=lambda t: (t.priority, -t.admit_seq))
        chosen: list = []
        for v in candidates:
            chosen.append(v)
            avail += reclaimable(v)
            if self.resolve_slice(waiter.spec, avail) is not None:
                return chosen
        return None
