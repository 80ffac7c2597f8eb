"""Cross-replica consistency sentinel: detect and repair silent corruption.

Counterpart of ``distributed_model_parallel_tpu/train/consistency.py``.
The recovery supervisor (``train/resilience.py``) catches faults that
announce themselves; the sentinel catches the one that dominates at
fleet scale — *silent* data corruption and replica drift, where one
data-parallel replica's parameters or optimizer state quietly diverge and
poison every later gradient all-reduce. On a step cadence
(``consistency_every``):

1. **fingerprint** — per leaf of the replicated state, four numbers
   (:data:`FINGERPRINT_STATS`): non-finite count, sum of squares, sum, and
   an **exact** wrap-around (mod 2^32) sum of the elements' bit patterns,
   which any single flipped bit changes. Each rank computes its rows on
   its device; a leaf replicated over non-data axes (tensor parallelism)
   contributes its bitsum rotated left by the rank's copy index over those
   axes (:func:`rows_stats`), so a flip that hits every copy the same way
   cannot cancel when the copies are summed. One all-gather of the
   ``[L, 4]`` rows over the world (a CUDA tensor under NCCL, a CPU tensor
   under gloo), summed on the host per data replica into the JAX
   package's ``[n_replicas, L, 4]`` fingerprint. The parameters never
   leave the device.
2. **compare** — :func:`analyze_fingerprints` groups replicas by bitwise
   equality: one group and finite → consistent. The fetch runs under the
   stall watchdog, and ``mesh.barrier_with_timeout`` bounds the
   rendezvous before it (a missing rank becomes a ``straggler`` failure
   record and ``StragglerTimeoutError``).
3. **repair** — with a quorum (a strict majority, or the one all-finite
   group) the outliers are repaired IN PLACE: every leaf is broadcast
   from the good replica's rank of each data group (a broadcast is
   bit-exact, where the JAX package uses a masked integer psum), written
   back with ``copy_`` into the existing tensors (a fused optimizer's
   bucket views stay its views), and the fingerprint is recomputed to
   verify. No quorum raises :class:`~.guards.ReplicaDivergenceError`,
   which the trainers route to the supervisor's good-slot restore.

Leaves sharded over the data axis (ddp's per-replica BN statistics,
ZeRO's optimizer slices) differ across replicas by design and are left
out; FSDP, which replicates nothing, is refused. With one data replica
(the pipeline trainer, ``dp=1`` LM runs) the sentinel checks finiteness
only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.train.guards import (
    NonFiniteError,
    ReplicaDivergenceError,
)

__all__ = [
    "ConsistencySentinel",
    "FINGERPRINT_STATS",
    "FingerprintVerdict",
    "StateLeaf",
    "analyze_fingerprints",
    "leaf_bitsum",
    "rows_stats",
]

FINGERPRINT_STATS = ("nonfinite", "l2", "sum", "bitsum")
_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FingerprintVerdict:
    """Host-side analysis of one ``[n_replicas, n_leaves, 4]`` fingerprint:
    who agrees, who lies, whether a repair quorum exists."""

    consistent: bool
    finite: bool
    good_replica: int | None
    outliers: tuple[int, ...]
    n_groups: int

    @property
    def has_quorum(self) -> bool:
        return self.good_replica is not None


def analyze_fingerprints(fp: np.ndarray) -> FingerprintVerdict:
    """Group replicas by bitwise fingerprint equality and pick the quorum:
    one group → consistent (finite iff its non-finite counts are 0); a
    finite strict majority → the quorum; else exactly one all-finite group
    wins; otherwise no quorum (``good_replica=None``)."""
    fp = np.asarray(fp)
    n = fp.shape[0]
    groups: dict[bytes, list[int]] = {}
    for i in range(n):
        groups.setdefault(fp[i].tobytes(), []).append(i)
    finite_of = {key: bool(fp[members[0], :, 0].sum() == 0)
                 for key, members in groups.items()}
    if len(groups) == 1:
        key = next(iter(groups))
        return FingerprintVerdict(consistent=True, finite=finite_of[key],
                                  good_replica=None, outliers=(),
                                  n_groups=1)
    majority = max(groups.values(), key=len)
    good: list[int] | None = None
    if len(majority) * 2 > n and finite_of[fp[majority[0]].tobytes()]:
        good = majority
    else:
        finite_groups = [m for k, m in groups.items() if finite_of[k]]
        if len(finite_groups) == 1:
            good = finite_groups[0]
    if good is None:
        return FingerprintVerdict(consistent=False, finite=False,
                                  good_replica=None,
                                  outliers=tuple(range(n)),
                                  n_groups=len(groups))
    outliers = tuple(sorted(set(range(n)) - set(good)))
    return FingerprintVerdict(consistent=False,
                              finite=finite_of[fp[good[0]].tobytes()],
                              good_replica=good[0], outliers=outliers,
                              n_groups=len(groups))


# -- per-leaf statistics --------------------------------------------------------

def _words(flat: torch.Tensor) -> torch.Tensor:
    """Each element's bit pattern as an int64 in ``[0, 2^32)``. torch has
    no uint32 sum, so each word is widened to int64 and masked; 64-bit
    elements fold both 32-bit halves in, as the JAX package's uint32 sum
    does."""
    size = flat.element_size()
    if flat.dtype == torch.bool:
        return flat.to(torch.int64)
    if size == 1:
        return flat.view(torch.uint8).to(torch.int64)
    if size == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 4:
        return flat.view(torch.int32).to(torch.int64) & _MASK
    w = flat.view(torch.int64)
    return (w & _MASK) + ((w >> 32) & _MASK)


def leaf_bitsum(x: torch.Tensor) -> torch.Tensor:
    """Exact mod-2^32 sum of ``x``'s element bit patterns, as a 0-d int64
    in ``[0, 2^32)`` on ``x``'s device."""
    return _words(x.detach().reshape(-1)).sum() & _MASK


# rows_stats' chunk: every leaf is zero-padded to a multiple of it, so a
# chunk belongs to one leaf.
_CHUNK = 1024


def rows_stats(tensors: Sequence[torch.Tensor],
               copy_index: Sequence[int]) -> np.ndarray:
    """``[L, 4]`` float32 on the host, one row a tensor (one device), as
    JAX's ``_leaf_stats`` gives it: the non-finite count, the sum of
    squares, the sum, and the bitsum rotated left by the tensor's
    ``copy_index`` within 32 bits, carried in the float32 slot by its bit
    pattern (rows are compared as bytes; only column 0 is read as a
    number). A few kernels a dtype rather than a few a leaf: each
    dtype's leaves are zero-padded to whole chunks and concatenated; every
    statistic is summed per chunk on the device (a fixed reduction order:
    the rows must be the same bits on every replica), and the chunk sums
    are summed per leaf on the host. The bitsum and the non-finite count
    are exact; the sum of squares and the sum run in float64, rounded to
    float32 (within float32 rounding of the per-leaf sums)."""
    dev = tensors[0].device
    out = np.empty((len(tensors), 4), np.float32)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idxs in groups.values():
        flat = [tensors[i].detach().reshape(-1) for i in idxs]
        chunks = [-(-x.numel() // _CHUNK) for x in flat]
        flat = torch.cat([torch.nn.functional.pad(
            x, (0, n * _CHUNK - x.numel())) for x, n in zip(flat, chunks)]
            + [flat[0].new_zeros(0)]).view(-1, _CHUNK)
        words = _words(flat.reshape(-1)).view(-1, _CHUNK)
        xd = flat.double()
        bad = ((~torch.isfinite(flat)).sum(1) if flat.is_floating_point()
               else torch.zeros(len(flat), dtype=torch.int64, device=dev))
        ints = torch.stack([bad.to(torch.int64), words.sum(1)], 1).cpu()
        floats = torch.stack([(xd * xd).sum(1), xd.sum(1)], 1).cpu()
        starts = np.concatenate([[0], np.cumsum(chunks)[:-1]])
        nonempty = np.asarray(chunks) > 0
        seg_i = np.zeros((len(idxs), 2), np.int64)
        seg_f = np.zeros((len(idxs), 2), np.float64)
        if nonempty.any():
            seg_i[nonempty] = np.add.reduceat(ints.numpy(),
                                              starts[nonempty], axis=0)
            seg_f[nonempty] = np.add.reduceat(floats.numpy(),
                                              starts[nonempty], axis=0)
        bits = seg_i[:, 1] & _MASK
        rot = np.array([copy_index[i] % 32 for i in idxs], np.int64)
        bits = ((bits << rot) | (bits >> (32 - rot))) & _MASK
        out[idxs, 0] = seg_i[:, 0]
        out[idxs, 1:3] = seg_f
        out[idxs, 3] = bits.astype(np.uint32).view(np.float32)
    return out


@dataclasses.dataclass
class StateLeaf:
    """One leaf of the state the sentinel watches: ``tensor`` (this rank's
    copy or slice, written in place on repair), ``data_sharded`` (differs
    across replicas by design: left out), ``copy_index`` (this rank's
    row-major index over the non-data axes the leaf is NOT cut along)."""

    label: str
    tensor: torch.Tensor
    data_sharded: bool = False
    copy_index: int = 0


def combine_rows(rows: np.ndarray, counts: Sequence[int],
                 data_index: Sequence[int], part: Sequence[int],
                 n_replicas: int) -> np.ndarray:
    """Every rank's ``[L, 4]`` rows (``rows[rank]``, padded) → the
    ``[n_replicas, L_total, 4]`` fingerprint: within a replica the ranks of
    one ``part`` (the same leaves: copies or slices) are summed — float
    columns in float32 in rank order, the bitsum mod 2^32 — and the parts
    (a pipeline's stages: other leaves) are concatenated in part order.
    ``counts[rank]``: the rank's rows before the padding."""
    out = []
    for d in range(n_replicas):
        parts = []
        for p in sorted(set(part)):
            ranks = [r for r in range(len(rows))
                     if data_index[r] == d and part[r] == p]
            n = int(counts[ranks[0]])
            stats = np.zeros((n, 3), np.float32)
            bits = np.zeros(n, np.int64)
            for r in ranks:
                stats = stats + rows[r, :n, :3]
                bits = (bits + rows[r, :n, 3].view(np.uint32)) & _MASK
            parts.append(np.concatenate(
                [stats, bits.astype(np.uint32).view(np.float32)[:, None]],
                axis=1))
        out.append(np.concatenate(parts))
    return np.stack(out)


class ConsistencySentinel:
    """Cadence-driven cross-replica state verification and in-place repair.

    ``spec``: the run's ``MeshSpec`` (None, or one data replica: the
    finiteness fingerprint only). ``part``: which leaves this rank holds
    within its replica (a CNN pipeline's stage index; 0 where every rank
    of a replica holds the same leaves, whole or cut). ``guards`` (a
    ``GuardRunner``) arms the stall watchdog around the fetch;
    ``barrier_timeout_s`` bounds the rendezvous before it. ``logger``:
    rank 0's ``RunLogger`` (a ``NullLogger`` elsewhere)."""

    def __init__(self, every: int, spec=None, *, logger, guards=None,
                 barrier_timeout_s: float | None = None,
                 name: str = "state", part: int = 0):
        if every < 0:
            raise ValueError(f"consistency_every must be >= 0, got {every}")
        self.every = every
        self.spec = spec
        self.logger = logger
        self.guards = guards
        self.barrier_timeout_s = barrier_timeout_s
        self.name = name
        self.part = part
        self.checks = 0
        self.repairs = 0
        self._seen = 0
        self._next = every
        self._checked_at = 0
        self._skip_noted = False
        self.n_replicas = spec.num_data if spec is not None else 1

    # ------------------------------------------------------------- cadence
    @property
    def enabled(self) -> bool:
        return self.every > 0

    def after_sync(self, n_steps: int,
                   leaves_fn: Callable[[], list]) -> bool:
        """Advance by ``n_steps``; when the cadence is due, check
        ``leaves_fn()`` (a list of :class:`StateLeaf`). Returns whether an
        in-place repair happened; raises ``ReplicaDivergenceError`` on
        no-quorum divergence and ``NonFiniteError`` on a consensus
        non-finite state."""
        if not self.enabled:
            return False
        self._seen += n_steps
        if self._seen < self._next:
            return False
        self._next = self._seen + self.every
        self._checked_at = self._seen
        return self.check(leaves_fn())

    def flush(self, leaves_fn: Callable[[], list]) -> bool:
        """Check the steps the cadence has not covered yet (the trainers
        call this at every epoch end, before the good slot is stamped), so
        an epoch shorter than the cadence is checked too."""
        if not self.enabled or self._seen == self._checked_at:
            return False
        self._next = self._seen + self.every
        self._checked_at = self._seen
        return self.check(leaves_fn())

    # ------------------------------------------------------------ plumbing
    @property
    def _telemetry(self):
        return self.logger.telemetry

    def _log(self, msg: str) -> None:
        self.logger.log_line(msg)

    @property
    def _mesh_mode(self) -> bool:
        return (self.spec is not None and self.n_replicas > 1
                and self.spec.backend is not None)

    def _included(self, leaves: list) -> list:
        mine = [leaf for leaf in leaves if not (self._mesh_mode
                                                and leaf.data_sharded)]
        skipped = [leaf.label for leaf in leaves if leaf not in mine]
        if skipped and not self._skip_noted:
            self._skip_noted = True
            self._log(f"consistency: {len(skipped)} data-sharded "
                      f"(per-replica) leaves excluded from the replicated "
                      f"fingerprint, e.g. {self.name}{skipped[0]}")
        if not mine:
            raise ValueError(
                "consistency sentinel: no replicated leaves to compare — "
                "every leaf is sharded over the data axis (FSDP/ZeRO "
                "shards state instead of replicating it; cross-replica "
                "consistency checking requires redundancy)")
        return mine

    def _rows(self, leaves: list, rotate: bool) -> torch.Tensor:
        """This rank's ``[L, 4]`` rows (:func:`rows_stats` per device: a
        pipeline's stages may sit on several), on the first leaf's device
        (where the all-gather wants them)."""
        out = np.empty((len(leaves), 4), np.float32)
        by_dev: dict = {}
        for i, leaf in enumerate(leaves):
            by_dev.setdefault(leaf.tensor.device, []).append(i)
        for idxs in by_dev.values():
            out[idxs] = rows_stats(
                [leaves[i].tensor for i in idxs],
                [leaves[i].copy_index if rotate else 0 for i in idxs])
        return torch.from_numpy(out).to(leaves[0].tensor.device)

    def _gathered(self, leaves: list) -> np.ndarray:
        """The ``[n_replicas, L, 4]`` fingerprint: every rank's row count
        and part, then its rows (padded to the widest), in two
        all-gathers over the world, summed per replica on the host."""
        import torch.distributed as dist

        from distributed_model_parallel_tpu_torch import mesh
        from distributed_model_parallel_tpu_torch.ops import collectives

        spec = self.spec
        group = spec.mesh_group
        rows = self._rows(leaves, rotate=True)
        world = dist.get_world_size(group)
        head = torch.tensor([len(leaves), self.part], device=rows.device)
        if dist.get_backend(group) == "gloo":
            rows, head = rows.cpu(), head.cpu()
        heads = [torch.empty_like(head) for _ in range(world)]
        dist.all_gather(heads, head, group=group)
        heads = [h.tolist() for h in heads]
        padded = rows.new_zeros((max(n for n, _ in heads), 4))
        padded[:len(leaves)] = rows
        parts = [torch.empty_like(padded) for _ in range(world)]
        collectives.calls["consistency"] += 1
        collectives.wire_bytes["consistency"] += padded.numel() * 4
        dist.all_gather(parts, padded, group=group)
        gathered = torch.stack(parts).cpu().numpy()
        data = [mesh.rank_coords(r, spec.config)[0] for r in range(world)]
        return combine_rows(gathered, [n for n, _ in heads], data,
                            [p for _, p in heads], self.n_replicas)

    def _local(self, leaves: list) -> np.ndarray:
        """Single-replica fingerprint ``[1, L, 4]`` (no rotation)."""
        return self._rows(leaves, rotate=False).cpu().numpy()[None]

    def _budget(self) -> float | None:
        """The straggler bound of the next blocking wait, with a 10x grace
        on the first check (one-time costs, peers still starting)."""
        if self.barrier_timeout_s is None:
            return None
        return self.barrier_timeout_s * (10.0 if self.checks == 0 else 1.0)

    def _on_straggler(self, what: str, budget: float) -> None:
        self._telemetry.failure(
            "straggler", detail=f"{what} incomplete after {budget:.1f}s "
            f"— a participant is wedged or missing")
        self._log(f"consistency: {what} timed out after {budget:.1f}s "
                  f"— straggler")

    def _guarded_fetch(self, fetch: Callable[[], np.ndarray]) -> np.ndarray:
        """The blocking fingerprint fetch under the stall watchdog and,
        with ``barrier_timeout_s``, a hard bound."""

        def bounded() -> np.ndarray:
            budget = self._budget()
            if budget is None:
                return fetch()
            from distributed_model_parallel_tpu_torch.mesh import (
                barrier_with_timeout,
            )

            return barrier_with_timeout(fetch, budget,
                                        what="consistency-fingerprint",
                                        on_timeout=self._on_straggler)

        if self.guards is not None and getattr(self.guards, "stall",
                                               None) is not None:
            with self.guards.watch(what="consistency-fingerprint"):
                return bounded()
        return bounded()

    def _pre_barrier(self) -> None:
        if self.barrier_timeout_s is None or not self._mesh_mode:
            return
        from distributed_model_parallel_tpu_torch.mesh import (
            barrier_with_timeout,
        )
        from distributed_model_parallel_tpu_torch.ops.collectives import (
            mesh_barrier,
        )

        barrier_with_timeout(lambda: mesh_barrier(self.spec), self._budget(),
                             what="consistency-barrier",
                             on_timeout=self._on_straggler)

    def _fingerprint(self, leaves: list) -> np.ndarray:
        if self._mesh_mode:
            return self._guarded_fetch(lambda: self._gathered(leaves))
        return self._guarded_fetch(lambda: self._local(leaves))

    @torch.no_grad()
    def _repair(self, leaves: list, good: int) -> None:
        """Every leaf := the good replica's, in place: one broadcast per
        dtype over this rank's data group (its ranks in data order) from
        the one at data index ``good`` (staged through the host under
        gloo)."""
        import torch.distributed as dist

        from distributed_model_parallel_tpu_torch.ops import collectives

        spec = self.spec
        src = dist.get_process_group_ranks(spec.group)[good]
        gloo = dist.get_backend(spec.group) == "gloo"
        by_dtype: dict = {}
        for leaf in leaves:
            by_dtype.setdefault(leaf.tensor.dtype, []).append(leaf.tensor)
        for tensors in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            if gloo:
                flat = flat.cpu()
            collectives.calls["consistency_repair"] += 1
            collectives.wire_bytes["consistency_repair"] += (
                flat.numel() * flat.element_size())
            dist.broadcast(flat, src, group=spec.group)
            off = 0
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()

    # ----------------------------------------------------------- the check
    def check(self, leaves: list) -> bool:
        """Fingerprint ``leaves`` now (ignoring the cadence); True after an
        in-place repair. See :meth:`after_sync` for what it raises."""
        from distributed_model_parallel_tpu_torch.utils.telemetry import (
            registry,
        )

        t0 = time.perf_counter()
        leaves = self._included(leaves)
        labels = [leaf.label for leaf in leaves]
        self._pre_barrier()
        fp = self._fingerprint(leaves)
        self.checks += 1
        reg = registry()
        reg.counter("consistency_checks").inc()
        reg.histogram("consistency_check_s").observe(
            time.perf_counter() - t0)
        if fp.shape[1] != len(labels):
            labels = [f"[{i}]" for i in range(fp.shape[1])]

        verdict = analyze_fingerprints(fp)
        if verdict.consistent:
            if not verdict.finite:
                bad = [labels[i] for i in range(len(labels))
                       if fp[0, i, 0] > 0]
                self._telemetry.consistency(
                    "non-finite", replicas=self.n_replicas,
                    leaves=len(bad), check=self.checks)
                raise NonFiniteError(
                    f"consistency fingerprint: non-finite values in "
                    f"{len(bad)} leaves (first: {self.name}{bad[0]})")
            return False

        reg.counter("consistency_divergences").inc()
        good_row = (fp[verdict.good_replica] if verdict.has_quorum
                    else fp[0])
        diverged = [labels[i] for i in range(len(labels))
                    if any(fp[r, i].tobytes() != good_row[i].tobytes()
                           for r in verdict.outliers)]
        detail = (f"{len(verdict.outliers)}/{self.n_replicas} replica(s) "
                  f"diverged on {len(diverged)} leaves "
                  f"(first: {self.name}{diverged[0] if diverged else '?'})")
        self._telemetry.consistency(
            "divergence", replicas=self.n_replicas,
            outliers=list(verdict.outliers), leaves=len(diverged),
            check=self.checks)
        self._telemetry.failure("replica-divergence", detail=detail)
        self._log(f"consistency: {detail}")

        if not verdict.has_quorum:
            self._telemetry.consistency(
                "no-quorum", replicas=self.n_replicas,
                groups=verdict.n_groups, check=self.checks)
            self._log("consistency: no majority-good quorum "
                      f"({verdict.n_groups} distinct states over "
                      f"{self.n_replicas} replicas) — falling back to the "
                      "good-slot restore")
            raise ReplicaDivergenceError(
                f"no repair quorum: {verdict.n_groups} distinct replica "
                f"states over {self.n_replicas} replicas ({detail})")

        self._repair(leaves, verdict.good_replica)
        after = analyze_fingerprints(self._fingerprint(leaves))
        if not after.consistent:
            self._telemetry.failure(
                "replica-divergence",
                detail="re-broadcast repair did not restore consistency")
            raise ReplicaDivergenceError(
                "re-broadcast repair did not restore bitwise consistency "
                "— corruption is live, not transient")
        self.repairs += 1
        reg.counter("consistency_repairs").inc()
        self._telemetry.consistency(
            "repaired", replicas=self.n_replicas,
            outliers=list(verdict.outliers), leaves=len(diverged),
            check=self.checks)
        self._telemetry.recovery(
            action="replica-rebroadcast",
            detail=f"from replica {verdict.good_replica}: {detail}")
        self._log(f"consistency: repaired in place — re-broadcast from "
                  f"replica {verdict.good_replica} "
                  f"(outliers {list(verdict.outliers)})")
        if not after.finite:
            raise NonFiniteError(
                "consistency fingerprint: replicas agree after repair but "
                "the consensus state is non-finite")
        return True
