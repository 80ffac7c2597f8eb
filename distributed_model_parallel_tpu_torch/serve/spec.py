"""Self-drafting (n-gram lookup) proposer for speculative decoding.

Counterpart of ``distributed_model_parallel_tpu/serve/spec.py`` (pure
host code: the same committed stream gives the same proposals in both
packages).

No second model: the draft for the next ``k`` tokens is the continuation
of the most recent earlier occurrence of the sequence's current suffix
n-gram — "prompt lookup decoding". Real traffic (and small models run
greedily) is repetitive enough that this is free accuracy: templated
spans, quoted context, and decode loops all re-emit spans the sequence
has already seen.

Correctness never depends on the proposal: the engine's verify step
(serve/model.make_verify_step) computes the model's own token at every
drafted position and commits exactly the tokens the sequential decode
path would have produced — a bad draft only costs wasted verify width,
never a wrong token.

The proposer is deterministic and incremental: a pure function of the
committed token stream, indexed as tokens arrive (O(orders) per token),
so replays — and the engine's pinned-determinism contract — hold with
drafting on.
"""

from __future__ import annotations


class NGramProposer:
    """Longest-suffix n-gram lookup over one sequence's committed tokens.

    ``orders`` n-gram sizes are tried longest-first; for each, the index
    maps the gram to its most recent end position. The draft is the
    ``k`` tokens that followed the match. ``propose`` returns ``[]``
    when no suffix recurs — the engine then runs an undrafted verify
    step (pad tokens can only be committed if the model itself picks
    them, so an empty draft degrades to plain decode).
    """

    def __init__(self, k: int, max_order: int = 3):
        if k < 1:
            raise ValueError(f"draft length k must be >= 1, got {k}")
        if max_order < 1:
            raise ValueError(f"max_order must be >= 1, got {max_order}")
        self.k = k
        self.orders = list(range(max_order, 0, -1))
        self.tokens: list[int] = []
        # per order: gram -> (latest end index, previous end index)
        self._index: dict[int, dict[tuple[int, ...], tuple[int, int]]] = {
            n: {} for n in self.orders}

    def extend(self, tokens: list[int]) -> None:
        """Commit tokens (prompt at admission, accepted tokens per
        verify round) and index every new suffix gram."""
        for t in tokens:
            self.tokens.append(int(t))
            i = len(self.tokens) - 1
            for n in self.orders:
                if i + 1 < n:
                    continue
                gram = tuple(self.tokens[i - n + 1:i + 1])
                idx = self._index[n]
                prev = idx.get(gram)
                idx[gram] = (i, prev[0] if prev else -1)

    def propose(self) -> list[int]:
        """Up to ``k`` draft tokens continuing the best suffix match —
        deterministic (most recent occurrence, longest order first)."""
        last = len(self.tokens) - 1
        for n in self.orders:
            if len(self.tokens) < n + 1:
                continue
            gram = tuple(self.tokens[-n:])
            hit = self._index[n].get(gram)
            if hit is None:
                continue
            j = hit[0] if hit[0] != last else hit[1]
            if j < 0 or j == last:
                continue
            return self.tokens[j + 1:j + 1 + self.k]
        return []

    def predict_next(self) -> int | None:
        """The proposer's single-token prediction — what the engine's
        SHADOW gate scores against each committed token on cheap rounds
        before risking verify width on this sequence (serve/engine.py)."""
        out = self.propose()
        return out[0] if out else None
