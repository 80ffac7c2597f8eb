"""The SPMD CNN pipeline as one process per rank — the port of
``distributed_model_parallel_tpu/parallel/spmd_cnn_pipeline.py``.

The JAX engine is one ``shard_map`` program over a ``(data, stage)``
mesh: every device holds the whole (replicated) parameter tuple, picks
its stage with ``lax.switch``, and activations hop between stages with
``ppermute`` in a buffer padded to the largest boundary. Here each rank
(``mesh.py``: rank ``r`` at ``data = r // S``, ``stage = r % S``) is a
process that holds **only its own stage's units** and steps its own
optimizer over them; activations and gradients hop between the stages
of its data row over ``torch.distributed`` point-to-point
(``ops/collectives.exchange``) at the true shape of each boundary
(:func:`boundary_shapes`), so nothing is padded and nothing of a shape
negotiation is sent. A rank runs only its stage, so JAX's
``stage_dispatch`` has no counterpart.

The step runs on a static tick table (:func:`spmd_ticks`), the same on
every rank: at each tick a stage runs at most one operation — the
forward of a microbatch (``F``), on stage 0 its loss (``L``: logits come
last → 0, d(logits) go 0 → last, the labels never move, as in the
runner), or a backward (``B``) — and then every hop produced at that
tick is posted in one ``batch_isend_irecv`` by sender and receiver
alike, so no order of hops between two ranks can deadlock. ``gpipe``
lists all forwards then all backwards per stage; ``1f1b`` lets stage
``s`` run ``min(S - s, M)`` forwards before its first backward. Both
run every stage's backwards in microbatch order, and each operation is
the runner's per-chunk function (``parallel/pipeline.py``), so a rank's
parameters, momentum and BN statistics are bit for bit the runner's at
the same cut and M.

A step (:func:`make_spmd_cnn_train_step`): stage 0 of each data row
draws the augmentation for the global batch and takes its rows (as the
gspmd strategy does), normalizes and splits them into M microbatches;
the schedule accumulates gradients, the data sub-group averages them
(``GradReducer``, launched during the last microbatch's backward), they
are divided by M; BN states are pooled over the microbatches and then
over the data rows (:func:`_pool_bn_over_axis`, the same law-of-total-
variance correction); the optimizer steps. JAX applies one optimizer to
the whole parameter tuple, so ``grad_clip_norm`` clips by the norm over
every stage: the squared norm is all-reduced over the stage ring
(``clip_group``). Metrics are the global batch's on every rank.

Interleaved 1F1B (``virtual_stages = V > 1``, JAX's Megatron placement):
the model splits into ``D = V·S`` chunks and rank ``s`` owns chunks ``s,
S + s, …``; a microbatch runs chunks ``0 .. D - 1`` in turn, each hop one
step round the stage ring (the ``(S-1) → 0`` wraparound between a
rank's chunks rides the same ring), so the logits' hop to stage 0 is the
ring's too. Each rank runs its forwards in Megatron's order (groups of S
microbatches through one chunk, then the next chunk; ``M % S == 0``) and
its backwards in the reverse chunk order, each chunk's in microbatch
order, so gradients and BN states accumulate as the runner's do; a rank
keeps at most ``K = min(2D - 1, M·V + D - 1)`` chunk forwards awaiting
their backward (JAX's stash ring), which bounds the activations it
holds. BN is pooled per chunk over its microbatches, then over data.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Sequence

import torch

from distributed_model_parallel_tpu_torch.data.loader import (
    augment_batch,
    normalize,
    resize_batch,
)
from distributed_model_parallel_tpu_torch.mesh import MeshSpec
from distributed_model_parallel_tpu_torch.models.staged import (
    StagedModel,
    stage_slices,
)
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    exchange,
    world_size,
)
from distributed_model_parallel_tpu_torch.parallel.auto_partition import (
    meta_copy,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    SCHEDULES,
    MicrobatchBN,
    chunk_backward,
    chunk_forward,
    divide_grads_,
    eval_metrics,
    loss_and_grad,
)
from distributed_model_parallel_tpu_torch.train.trainer import METRIC_KEYS


def boundary_specs(model: StagedModel, mbs: int, feat_shape: Sequence[int],
                   slices: Sequence[tuple[int, int]]) -> list:
    """``(shape, dtype)`` of the NHWC activation entering each stage
    (index s) and of the output (index S), for one microbatch of ``mbs``
    rows; shapes only, on the ``meta`` device."""
    meta = meta_copy(model)
    x = torch.empty((mbs, *feat_shape), dtype=torch.float32, device="meta")
    specs = []
    for lo, hi in slices:
        specs.append((tuple(x.shape), x.dtype))
        x, _ = meta.apply_range(x, lo, hi, train=False)
    specs.append((tuple(x.shape), x.dtype))
    return specs


def boundary_shapes(model: StagedModel, mbs: int, feat_shape: Sequence[int],
                    slices: Sequence[tuple[int, int]]) -> list[tuple]:
    """The static activation shape entering each stage (index s) plus the
    output's (index S) for one microbatch of ``mbs`` rows."""
    return [shape for shape, _ in boundary_specs(model, mbs, feat_shape,
                                                 slices)]


def _pool_bn_over_axis(state, group, momentum: float):
    """Pool per-data-row BN states over ``group`` into the statistics of
    the pooled batch (law of total variance over equal rows; the same
    derivation as ``merge_microbatch_bn_states`` with the mean over the
    group in place of the mean over microbatches): one all-reduce of
    every mean, variance and squared mean. Trees of dicts, tuples and
    lists of tensors; at ``momentum == 1`` the correction is skipped."""
    n = world_size(group)
    if n == 1:
        return state
    one_minus = 1.0 - momentum
    parts: list = []

    def collect(node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k == "var" and "mean" in node:
                    parts.extend([node["var"], node["mean"] * node["mean"]])
                else:
                    collect(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                collect(v)
        else:
            parts.append(node)

    collect(state)
    flat = torch.cat([p.reshape(-1).float() for p in parts])
    all_reduce_(flat, group, kind="bn_pool")
    flat /= n
    pooled, off = [], 0
    for p in parts:
        pooled.append(flat[off:off + p.numel()].view(p.shape).to(p.dtype))
        off += p.numel()
    it = iter(pooled)

    def rebuild(node):
        if isinstance(node, Mapping):
            out = {}
            for k, v in node.items():
                if k == "var" and "mean" in node:
                    var, sq = next(it), next(it)
                    out[k] = var
                    out["_sq"] = sq
                else:
                    out[k] = rebuild(v)
            if "_sq" in out:
                sq = out.pop("_sq")
                if one_minus != 0.0:
                    out["var"] = out["var"] + (
                        sq - out["mean"] * out["mean"]) / one_minus
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(state)


# -- the tick table ------------------------------------------------------------
#
# An operation is ``(kind, microbatch, chunk)``: F (the chunk's forward), L
# (stage 0: the loss, or the eval metrics; chunk None) or B (the chunk's
# backward). Chunk c runs on stage c % S.

def _stage_ops(s: int, S: int, M: int, schedule: str,
               train: bool) -> list[tuple]:
    """Stage s's operations in order at one chunk a stage."""
    if not train:
        return [("F", m, s) for m in range(M)] + (
            [("L", m, None) for m in range(M)] if s == 0 else [])
    if schedule == "gpipe" or M == 1:
        ops = [("F", m, s) for m in range(M)]
        if s == 0:
            ops += [("L", m, None) for m in range(M)]
        return ops + [("B", m, s) for m in range(M)]
    warm = min(S - s, M)
    ops = [("F", m, s) for m in range(warm)]
    for m in range(M):
        if s == 0:
            ops.append(("L", m, None))
        ops.append(("B", m, s))
        if m + warm < M:
            ops.append(("F", m + warm, s))
    return ops


def _needs(op, D: int):
    kind, m, c = op
    if kind == "F":
        return ("act", m, c) if c else None
    if kind == "L":
        return ("logits", m)
    return ("dlogits", m) if c == D - 1 else ("grad", m, c)


def _makes(op, S: int, D: int, train: bool):
    """(message key, destination stage) an operation produces, or None."""
    kind, m, c = op
    if kind == "F":
        return (("act", m, c + 1), (c + 1) % S) if c < D - 1 else \
            (("logits", m), 0)
    if kind == "L":
        return (("dlogits", m), (D - 1) % S) if train else None
    return (("grad", m, c - 1), (c - 1) % S) if c else None


def stash_slots(S: int, V: int, M: int) -> int:
    """The most chunk forwards a rank holds awaiting their backward under
    interleaved 1F1B: JAX's stash ring, ``min(2D - 1, M·V + D - 1)``."""
    D = S * V
    return min(2 * D - 1, M * V + D - 1)


def _interleaved_ticks(S: int, V: int, M: int, train: bool) -> list[list]:
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
    loss = [("L", m, None) for m in range(M)]
    cap = stash_slots(S, V, M) if train else M * V
    fi, bi, li = [0] * S, [0] * S, 0
    held, have, ticks = [0] * S, set(), []
    while li < M or any(fi[s] < len(fwd[s]) or bi[s] < len(bwd[s])
                        for s in range(S)):
        row, made = [None] * S, []
        for s in range(S):
            op = None
            if s == 0 and li < M and _needs(loss[li], D) in have:
                op, li = loss[li], li + 1
            elif bi[s] < len(bwd[s]) and _needs(bwd[s][bi[s]], D) in have:
                op = bwd[s][bi[s]]
                bi[s] += 1
                held[s] -= 1
            elif (fi[s] < len(fwd[s]) and held[s] < cap
                  and _needs(fwd[s][fi[s]], D) in (have | {None})):
                op = fwd[s][fi[s]]
                fi[s] += 1
                held[s] += train
            if op is not None:
                row[s] = op
                out = _makes(op, S, D, train)
                if out is not None:
                    made.append(out[0])
        if not any(row):
            raise RuntimeError(f"interleaved schedule deadlocks at S={S}, "
                               f"V={V}, M={M}")
        have.update(made)
        ticks.append(row)
    return ticks


def spmd_ticks(S: int, M: int, schedule: str = "gpipe", *,
               train: bool = True, virtual_stages: int = 1) -> list[list]:
    """The static schedule: ``ticks[t][s]`` is stage s's operation at tick
    t, ``(kind, microbatch, chunk)`` or None. Each stage runs its
    operations in order, one a tick, as soon as the message it needs was
    delivered at the end of an earlier tick. The same table on every
    rank. ``virtual_stages > 1``: interleaved 1F1B (1f1b only)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown spmd cnn pipeline schedule {schedule!r};"
                         f" known: {', '.join(SCHEDULES)}")
    if virtual_stages > 1:
        if train and schedule != "1f1b":
            raise ValueError("interleaved virtual stages are a 1f1b "
                             "schedule feature (gpipe's whole-program AD "
                             "would gain nothing — no silent ignores)")
        return _interleaved_ticks(S, virtual_stages, M, train)
    lists = [_stage_ops(s, S, M, schedule, train) for s in range(S)]
    ptr, have, ticks = [0] * S, set(), []
    while any(p < len(ops) for p, ops in zip(ptr, lists)):
        row, made = [None] * S, []
        for s in range(S):
            if ptr[s] == len(lists[s]):
                continue
            op = lists[s][ptr[s]]
            need = _needs(op, S)
            if need is None or need in have:
                row[s] = op
                ptr[s] += 1
                out = _makes(op, S, S, train)
                if out is not None:
                    made.append(out[0])
        if not any(row):
            raise RuntimeError(f"{schedule} schedule deadlocks at S={S}, "
                               f"M={M}")
        have.update(made)
        ticks.append(row)
    return ticks


# -- one rank's stage ------------------------------------------------------------

class CnnPipelineStage:
    """This rank's stage of the pipeline: its chunks' units of ``model``
    (the full staged model, e.g. built from a seed or loaded from JAX
    weights on the CPU; only the units of chunks ``s, S + s, …`` of the
    ``S·virtual_stages`` chunks are kept, on ``spec.device``, as one
    ``StagedModel``), the peers of its stage ring and the boundary
    shapes. ``sample_shape``: one image's NHWC shape, or a batch shape
    whose leading dim is ignored. ``units``: the global indices of the
    kept units; ``lo, hi``: the first chunk's range (the stage's, at one
    chunk a stage)."""

    def __init__(self, model: StagedModel, spec: MeshSpec, *,
                 sample_shape: Sequence[int],
                 boundaries: Sequence[int] | None = None,
                 bn_momentum: float = 0.9, virtual_stages: int = 1):
        if virtual_stages < 1:
            raise ValueError(f"virtual_stages must be >= 1, got "
                             f"{virtual_stages}")
        self.spec = spec
        self.S = spec.num_stages
        self.s = spec.stage_index
        self.V = virtual_stages
        self.D = self.S * self.V
        self.slices = stage_slices(model.num_units, self.D, boundaries)
        self.chunks = list(range(self.s, self.D, self.S))
        ranges = [self.slices[c] for c in self.chunks]
        self.lo, self.hi = ranges[0]
        self.units = [i for lo, hi in ranges for i in range(lo, hi)]
        # Chunk c's units [a, b) of the local model.
        self.local: dict[int, tuple[int, int]] = {}
        off = 0
        for c, (lo, hi) in zip(self.chunks, ranges):
            self.local[c] = (off, off + hi - lo)
            off += hi - lo
        self.feat_shape = tuple(sample_shape[-3:])
        self._meta = meta_copy(model)
        self._specs: dict[int, list] = {}
        self.model = StagedModel(
            [model.units[i] for i in self.units],
            name=f"{model.name}" + "".join(f"[{lo}:{hi}]"
                                           for lo, hi in ranges))
        self.model.to(spec.device)
        self.bn_momentum = bn_momentum
        self.chunk_bn = {c: MicrobatchBN([m for u in self.model.units[a:b]
                                          for m in u.modules()])
                         for c, (a, b) in self.local.items()}
        self.n_local = len(self.units)
        if spec.stage_group is not None:
            # The ring's communicator is made by a call every rank joins.
            all_reduce_(torch.zeros((), device=spec.device),
                        spec.stage_group, kind="barrier")

    @property
    def bns(self) -> list:
        """Every BatchNorm of the stage, chunk by chunk."""
        return [bn for c in self.chunks for bn in self.chunk_bn[c].bns]

    def finish_bn(self) -> None:
        """Pool each chunk's microbatch BN states into its statistics."""
        for c in self.chunks:
            self.chunk_bn[c].finish(self.bn_momentum)

    def specs(self, mbs: int) -> list:
        if mbs not in self._specs:
            self._specs[mbs] = boundary_specs(self._meta, mbs,
                                              self.feat_shape, self.slices)
        return self._specs[mbs]

    def _key_spec(self, key, mbs: int):
        specs = self.specs(mbs)
        if key[0] == "act":
            return specs[key[2]]
        if key[0] == "grad":
            return specs[key[2] + 1]
        return specs[self.D]                        # logits, dlogits

    def run(self, ticks, M: int, mbs: int, *, x=None, labels=None,
            train: bool = True, reducer=None) -> list:
        """Run this stage's column of ``ticks`` over M microbatches of
        ``mbs`` rows: ``x`` (normalized NHWC, M·mbs rows) and ``labels``
        on stage 0 only. Returns stage 0's per-microbatch metrics ([]
        elsewhere). Training accumulates the parameters' gradients and
        leaves the microbatch BN states in ``chunk_bn``."""
        s, S, D = self.s, self.S, self.D
        inbox: dict = {}
        acts: dict = {}
        metrics: list = [None] * M
        multi = train and M > 1
        for row in ticks:
            sends = []
            op = row[s]
            if op is not None:
                kind, m, c = op
                need = _needs(op, D)
                got = inbox.pop(need) if need is not None else None
                out = None
                if kind == "F":
                    xin = got if c else x[m * mbs:(m + 1) * mbs]
                    a, b = self.local[c]
                    if multi:
                        self.chunk_bn[c].begin()
                    if train:
                        acts[m, c] = chunk_forward(self.model, a, b, xin,
                                                   leaf=c > 0)
                        out = acts[m, c][1].detach()
                    else:
                        out = chunk_forward(self.model, a, b, xin,
                                            train=False)[1]
                    if multi:
                        self.chunk_bn[c].end(m)
                elif kind == "L":
                    lab = labels[m * mbs:(m + 1) * mbs]
                    if train:
                        out, metrics[m] = loss_and_grad(got, lab)
                    else:
                        metrics[m] = eval_metrics(got, lab)
                else:
                    x_in, y = acts.pop((m, c))
                    ctx = (reducer.no_sync() if reducer is not None
                           and m < M - 1 else contextlib.nullcontext())
                    with ctx:
                        out = chunk_backward(x_in, y, got)
                made = _makes(op, S, D, train)
                if made is not None:
                    key, dst = made
                    if dst == s:
                        inbox[key] = out
                    else:
                        sends.append((out, self.spec.stage_rank(dst)))
            recvs, keys = [], []
            for s2, op2 in enumerate(row):
                if op2 is None or s2 == s:
                    continue
                made = _makes(op2, S, D, train)
                if made is not None and made[1] == s:
                    shape, dtype = self._key_spec(made[0], mbs)
                    buf = torch.empty(shape, dtype=dtype,
                                      device=self.spec.device)
                    recvs.append((buf, self.spec.stage_rank(s2)))
                    keys.append(made[0])
            if sends or recvs:
                exchange(sends, recvs, self.spec.stage_group)
                for key, (buf, _) in zip(keys, recvs):
                    inbox[key] = buf
        return [mm for mm in metrics if mm is not None]


def _fwd_bwd(stage: CnnPipelineStage, num_microbatches: int, schedule: str):
    M = num_microbatches
    ticks = spmd_ticks(stage.S, M, schedule, virtual_stages=stage.V)

    def fwd_bwd(x, labels, b_local: int, reducer=None) -> list:
        if b_local % M:
            raise ValueError(f"per-shard batch {b_local} not divisible by "
                             f"num_microbatches={M}")
        return stage.run(ticks, M, b_local // M, x=x, labels=labels,
                         reducer=reducer)

    return fwd_bwd


def make_cnn_pipeline_apply(stage: CnnPipelineStage, *,
                            num_microbatches: int = 1):
    """GPipe over the stage ring: ``fwd_bwd(x, labels, b_local,
    reducer=None) -> stage 0's per-microbatch metrics``; every stage runs
    all its forwards, then all its backwards."""
    return _fwd_bwd(stage, num_microbatches, "gpipe")


def make_cnn_1f1b_fwd_bwd(stage: CnnPipelineStage, *,
                          num_microbatches: int = 1,
                          virtual_stages: int = 1):
    """1F1B over the stage ring: at ``virtual_stages == 1`` stage s runs
    ``min(S - s, M)`` forwards, then a backward before each forward;
    above it, interleaved 1F1B over the stage's ``virtual_stages`` chunks
    (the stage must have been built with as many, and ``M % S == 0``)."""
    if virtual_stages != stage.V:
        raise ValueError(f"virtual_stages={virtual_stages}, but the stage "
                         f"was cut into {stage.V} chunk(s) a rank")
    return _fwd_bwd(stage, num_microbatches, "1f1b")


@torch.no_grad()
def pool_stage_bn_(stage: CnnPipelineStage, group, momentum: float) -> None:
    """The stage's BN running statistics pooled over the data rows, in
    place."""
    bns = stage.bns
    if not bns:
        return
    tree = [{"mean": bn.running_mean, "var": bn.running_var} for bn in bns]
    for bn, st in zip(bns, _pool_bn_over_axis(tree, group, momentum)):
        bn.running_mean.copy_(st["mean"])
        bn.running_var.copy_(st["var"])


def global_metrics(micro: list, spec: MeshSpec, b_local: int,
                   device) -> dict:
    """Stage 0's per-microbatch metrics of every data row → the global
    batch's on every rank: one all-reduce over the world (the other
    stages add zeros); loss = the mean over rows of the rows' means."""
    row = torch.zeros(len(METRIC_KEYS), dtype=torch.float32, device=device)
    if micro:
        losses = torch.stack([m["loss"].float() for m in micro])
        row[0] = losses.mean() / spec.num_data
        row[1] = float(b_local)
        row[2] = sum(m["correct@1"].float() for m in micro)
        row[3] = sum(m["correct@5"].float() for m in micro)
    if spec.backend is not None:
        all_reduce_(row, None, kind="metrics")
    return {k: row[i] for i, k in enumerate(METRIC_KEYS)}


def make_spmd_cnn_train_step(stage: CnnPipelineStage, optimizer, *, mean,
                             std, num_microbatches: int = 1,
                             augment: bool = True, schedule: str = "gpipe",
                             virtual_stages: int = 1,
                             dtype=torch.float32, reducer=None,
                             resize_to: int | None = None):
    """One SPMD training step of this rank's stage:
    ``step(images_u8, labels, generator=None) -> global metrics``, where
    stage 0 passes its data row's rows of the global batch (uint8 NHWC,
    on the device) and the global batch's augmentation generator, and
    the other stages pass None. ``optimizer`` steps this stage's
    parameters (``stage.model``); ``reducer`` (a ``GradReducer`` over the
    data sub-group, or None at one data row) averages the gradients over
    the data rows; clipping (``grad_clip_norm``) takes the norm over the
    whole pipeline. ``resize_to``: stage 0 resizes its rows to that many px
    before the augmentation."""
    if schedule == "1f1b":
        fwd_bwd = make_cnn_1f1b_fwd_bwd(stage,
                                        num_microbatches=num_microbatches,
                                        virtual_stages=virtual_stages)
    elif schedule == "gpipe":
        if virtual_stages != 1:
            raise ValueError(
                "interleaved virtual stages are a 1f1b schedule feature "
                "(gpipe's whole-program AD would gain nothing — no silent "
                "ignores)")
        fwd_bwd = make_cnn_pipeline_apply(stage,
                                          num_microbatches=num_microbatches)
    else:
        raise ValueError(f"unknown spmd cnn pipeline schedule {schedule!r}; "
                         f"known: gpipe, 1f1b")
    spec, M = stage.spec, num_microbatches
    dev = spec.device
    if getattr(optimizer, "clip", None) is not None and stage.S > 1:
        optimizer.clip_group = spec.stage_group
    mean = torch.as_tensor(mean, dtype=dtype, device=dev)
    std = torch.as_tensor(std, dtype=dtype, device=dev)
    params = list(stage.model.parameters())

    def step(images_u8=None, labels=None, generator=None,
             b_local: int | None = None) -> dict:
        x = None
        if stage.s == 0:
            b_local = labels.shape[0]
            if resize_to is not None:
                images_u8 = resize_batch(images_u8, resize_to)
            if augment:
                rows = spec.rows(b_local * spec.num_data)
                images_u8 = augment_batch(generator, images_u8,
                                          rows=(rows.start,
                                                b_local * spec.num_data))
            x = normalize(images_u8, mean, std, dtype)
        elif b_local is None:
            raise ValueError("a stage > 0 rank passes b_local, its data "
                             "row's rows of the global batch")
        optimizer.zero_grad()
        micro = fwd_bwd(x, labels, b_local, reducer)
        if reducer is not None:
            reducer.finish()
        divide_grads_(optimizer, params, M)
        stage.finish_bn()
        if spec.num_data > 1:
            pool_stage_bn_(stage, spec.group, stage.bn_momentum)
        optimizer.step()
        return global_metrics(micro, spec, b_local, dev)

    return step


def make_spmd_cnn_eval_step(stage: CnnPipelineStage, *, mean, std,
                            dtype=torch.float32,
                            resize_to: int | None = None):
    """Forward-only through the stage ring with the BN running statistics
    (a rank holds one stage, so evaluation is pipelined too):
    ``step(images_u8, labels, b_local=None) -> global metrics``, stage 0
    passing its data row's rows, the others ``b_local``."""
    spec, dev = stage.spec, stage.spec.device
    mean = torch.as_tensor(mean, dtype=dtype, device=dev)
    std = torch.as_tensor(std, dtype=dtype, device=dev)
    ticks = spmd_ticks(stage.S, 1, train=False, virtual_stages=stage.V)

    @torch.no_grad()
    def step(images_u8=None, labels=None, b_local: int | None = None):
        x = None
        if stage.s == 0:
            b_local = labels.shape[0]
            if resize_to is not None:
                images_u8 = resize_batch(images_u8, resize_to)
            x = normalize(images_u8, mean, std, dtype)
        micro = stage.run(ticks, 1, b_local, x=x, labels=labels,
                          train=False)
        return global_metrics(micro, spec, b_local, dev)

    return step
