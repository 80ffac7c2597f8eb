"""Cell topology for the serving fleet: named groups of replicas.

Counterpart of ``distributed_model_parallel_tpu/serve/cells.py`` (no
framework code; the port's own copy). Replicas share racks, power
domains and rollout waves, and they fail in correlated groups.
``CellDirectory`` partitions a fleet's replicas into named cells
(contiguous blocks, so each cell's pool slice is a contiguous id range);
the router keys its decisions on (cell, prefix, load) — a deterministic
home-cell hash with cell-local power-of-two-choices and cross-cell
failover — and the correlated fault kinds (``kill_cell``, ``slow_cell``,
``partition``, utils/faults.py) target a cell as a unit.

The directory is immutable: a quarantined replica stays a member of its
cell (the fleet tracks liveness), so the home-cell hash is stable across
quarantine and grow-back. :func:`home_cell` hashes exactly as the JAX
package does, so both packages send a prompt to the same cell.
"""

from __future__ import annotations

import zlib

__all__ = ["CellDirectory", "home_cell"]


def home_cell(prompt: list[int], cells: tuple[str, ...],
              seed: int = 0) -> str:
    """Deterministic home cell for a prompt: a seeded crc32 over the
    prompt's leading tokens, mod the FULL configured cell list — never
    the live subset, so a cell going down does not reshuffle every other
    prompt's home (only the victims fail over)."""
    if not cells:
        raise ValueError("home_cell needs at least one cell")
    head = bytes(t % 256 for t in prompt[:32])
    h = zlib.crc32(head, seed & 0xFFFFFFFF)
    return cells[h % len(cells)]


class CellDirectory:
    """Immutable replica-name -> cell mapping (module docstring).

    Build either from an explicit ``{cell: [replica names]}`` mapping or
    via :meth:`partition` (``n_replicas`` into ``n_cells`` contiguous
    blocks).
    """

    def __init__(self, members_by_cell: dict[str, list[str] | tuple]):
        if not members_by_cell:
            raise ValueError("CellDirectory needs at least one cell")
        self._members: dict[str, tuple[str, ...]] = {}
        self._cell_of: dict[str, str] = {}
        for cell, members in members_by_cell.items():
            members = tuple(members)
            if not members:
                raise ValueError(f"cell {cell!r} has no members")
            self._members[cell] = members
            for name in members:
                if name in self._cell_of:
                    raise ValueError(
                        f"replica {name!r} assigned to both "
                        f"{self._cell_of[name]!r} and {cell!r}")
                self._cell_of[name] = cell
        # Declaration order IS the hash order: stable, explicit.
        self.cells: tuple[str, ...] = tuple(self._members)

    @classmethod
    def partition(cls, names: list[str], n_cells: int) -> "CellDirectory":
        """Split ``names`` into ``n_cells`` contiguous blocks (the first
        cells take the remainder)."""
        if n_cells < 1:
            raise ValueError(f"n_cells must be >= 1, got {n_cells}")
        if n_cells > len(names):
            raise ValueError(
                f"{n_cells} cells need >= 1 replica each; got "
                f"{len(names)} replicas")
        base, extra = divmod(len(names), n_cells)
        out, i = {}, 0
        for c in range(n_cells):
            take = base + (1 if c < extra else 0)
            out[f"c{c}"] = names[i:i + take]
            i += take
        return cls(out)

    def cell_of(self, name: str) -> str:
        try:
            return self._cell_of[name]
        except KeyError:
            raise KeyError(f"replica {name!r} is in no cell") from None

    def members(self, cell: str) -> tuple[str, ...]:
        try:
            return self._members[cell]
        except KeyError:
            raise KeyError(f"unknown cell {cell!r}; known: "
                           f"{list(self.cells)}") from None

    def home(self, prompt: list[int], seed: int = 0) -> str:
        return home_cell(prompt, self.cells, seed)

    def as_dict(self) -> dict[str, list[str]]:
        """JSON-ready membership view (statusz and summary payloads)."""
        return {c: list(m) for c, m in self._members.items()}

    def __contains__(self, cell: str) -> bool:
        return cell in self._members

    def __len__(self) -> int:
        return len(self._members)
