"""The static tick tables of the SPMD pipelines — shared by the CNN engine
(``parallel/spmd_cnn_pipeline.py``) and the Transformer LM's
(``parallel/spmd_pipeline.py``).

Each rank of a stage ring runs the same table: at each tick a stage runs
at most one operation ``(kind, microbatch, chunk)`` — ``F`` (a chunk's
forward), ``L`` (the loss, on stage 0, chunk None) or ``B`` (a chunk's
backward) — as soon as the message it needs was delivered at the end of
an earlier tick; then every hop made at that tick is posted together.
Chunk ``c`` runs on stage ``c % S``. ``gpipe`` lists all forwards then
all backwards per stage; ``1f1b`` lets stage ``s`` run ``min(S - s, M)``
forwards before its first backward; interleaved 1F1B (``virtual_stages
> 1``) is Megatron's order over ``D = V·S`` chunks, each rank holding at
most :func:`stash_slots` chunk forwards awaiting their backward.

Where the loss runs (``head``): ``"first"`` — the CNN engine's: the
logits hop from the last chunk to stage 0, which runs ``L`` and sends
d(logits) back; ``"last"`` — the LM's: the last chunk's stage runs the
head and loss inside that chunk's forward, and the chunk's backward
needs only that forward's ``("loss", m)``, kept on its own stage (no
``L`` operations, no hop of the head).
"""

from __future__ import annotations

from distributed_model_parallel_tpu_torch.parallel.pipeline import SCHEDULES

HEADS = ("first", "last")


def _stage_ops(s: int, S: int, M: int, schedule: str, train: bool,
               head: str = "first") -> list[tuple]:
    """Stage s's operations in order at one chunk a stage."""
    losses = ([("L", m, None) for m in range(M)]
              if s == 0 and head == "first" else [])
    if not train:
        return [("F", m, s) for m in range(M)] + losses
    if schedule == "gpipe" or M == 1:
        return ([("F", m, s) for m in range(M)] + losses
                + [("B", m, s) for m in range(M)])
    warm = min(S - s, M)
    ops = [("F", m, s) for m in range(warm)]
    for m in range(M):
        if losses:
            ops.append(losses[m])
        ops.append(("B", m, s))
        if m + warm < M:
            ops.append(("F", m + warm, s))
    return ops


def _needs(op, D: int, head: str = "first"):
    kind, m, c = op
    if kind == "F":
        return ("act", m, c) if c else None
    if kind == "L":
        return ("logits", m)
    if c == D - 1:
        return ("dlogits", m) if head == "first" else ("loss", m)
    return ("grad", m, c)


def _makes(op, S: int, D: int, train: bool, head: str = "first"):
    """(message key, destination stage) an operation produces, or None."""
    kind, m, c = op
    if kind == "F":
        if c < D - 1:
            return ("act", m, c + 1), (c + 1) % S
        if head == "first":
            return ("logits", m), 0
        return (("loss", m), (D - 1) % S) if train else None
    if kind == "L":
        return (("dlogits", m), (D - 1) % S) if train else None
    return (("grad", m, c - 1), (c - 1) % S) if c else None


def stash_slots(S: int, V: int, M: int) -> int:
    """The most chunk forwards a rank holds awaiting their backward under
    interleaved 1F1B: JAX's stash ring, ``min(2D - 1, M·V + D - 1)``."""
    D = S * V
    return min(2 * D - 1, M * V + D - 1)


def _interleaved_ticks(S: int, V: int, M: int, train: bool,
                       head: str = "first") -> list[list]:
    """The interleaved table: at each tick stage 0 runs a loss whose
    logits arrived, else each stage the next backward of its order whose
    gradient arrived, else the next forward of its order whose input
    arrived (training: while fewer than :func:`stash_slots` forwards
    await their backward)."""
    D = S * V
    if train and M % S:
        raise ValueError(
            f"interleaved schedule needs num_microbatches divisible by "
            f"the stage count: M={M}, S={S} (Megatron constraint)")
    if train:
        group = lambda k: (k // D) * S + k % S
        fwd = [[("F", group(k), ((k // S) % V) * S + s)
                for k in range(M * V)] for s in range(S)]
        bwd = [[("B", group(k), (V - 1 - (k // S) % V) * S + s)
                for k in range(M * V)] for s in range(S)]
    else:
        fwd = [[("F", m, v * S + s) for m in range(M) for v in range(V)]
               for s in range(S)]
        bwd = [[] for _ in range(S)]
    loss = [("L", m, None) for m in range(M)] if head == "first" else []
    cap = stash_slots(S, V, M) if train else M * V
    fi, bi, li = [0] * S, [0] * S, 0
    held, have, ticks = [0] * S, set(), []
    while li < len(loss) or any(fi[s] < len(fwd[s]) or bi[s] < len(bwd[s])
                                for s in range(S)):
        row, made = [None] * S, []
        for s in range(S):
            op = None
            if s == 0 and li < len(loss) and _needs(loss[li], D) in have:
                op, li = loss[li], li + 1
            elif (bi[s] < len(bwd[s])
                  and _needs(bwd[s][bi[s]], D, head) in have):
                op = bwd[s][bi[s]]
                bi[s] += 1
                held[s] -= 1
            elif (fi[s] < len(fwd[s]) and held[s] < cap
                  and _needs(fwd[s][fi[s]], D, head) in (have | {None})):
                op = fwd[s][fi[s]]
                fi[s] += 1
                held[s] += train
            if op is not None:
                row[s] = op
                out = _makes(op, S, D, train, head)
                if out is not None:
                    made.append(out[0])
        if not any(row):
            raise RuntimeError(f"interleaved schedule deadlocks at S={S}, "
                               f"V={V}, M={M}")
        have.update(made)
        ticks.append(row)
    return ticks


def spmd_ticks(S: int, M: int, schedule: str = "gpipe", *,
               train: bool = True, virtual_stages: int = 1,
               head: str = "first") -> list[list]:
    """The static schedule: ``ticks[t][s]`` is stage s's operation at tick
    t, ``(kind, microbatch, chunk)`` or None. Each stage runs its
    operations in order, one a tick, as soon as the message it needs was
    delivered at the end of an earlier tick. The same table on every
    rank. ``virtual_stages > 1``: interleaved 1F1B (1f1b only).
    ``head``: where the loss runs (the module docstring)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown spmd cnn pipeline schedule {schedule!r};"
                         f" known: {', '.join(SCHEDULES)}")
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}; known: first, last")
    if virtual_stages > 1:
        if train and schedule != "1f1b":
            raise ValueError("interleaved virtual stages are a 1f1b "
                             "schedule feature (gpipe's whole-program AD "
                             "would gain nothing — no silent ignores)")
        return _interleaved_ticks(S, virtual_stages, M, train, head)
    lists = [_stage_ops(s, S, M, schedule, train, head) for s in range(S)]
    ptr, have, ticks = [0] * S, set(), []
    while any(p < len(ops) for p, ops in zip(ptr, lists)):
        row, made = [None] * S, []
        for s in range(S):
            if ptr[s] == len(lists[s]):
                continue
            op = lists[s][ptr[s]]
            need = _needs(op, S, head)
            if need is None or need in have:
                row[s] = op
                ptr[s] += 1
                out = _makes(op, S, S, train, head)
                if out is not None:
                    made.append(out[0])
        if not any(row):
            raise RuntimeError(f"{schedule} schedule deadlocks at S={S}, "
                               f"M={M}")
        have.update(made)
        ticks.append(row)
    return ticks
