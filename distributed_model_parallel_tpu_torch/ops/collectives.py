"""Collectives over the data axis and point-to-point hops over the stage
ring — the port of ``distributed_model_parallel_tpu/ops/collectives.py``.

The JAX functions run inside ``shard_map`` over a named axis; these run
on every rank of a ``torch.distributed`` process group (``group=None``:
the default group). Without a process group the world is one rank and
each function returns its input's value without a collective.

* :func:`psum_mean`, :func:`all_gather_concat`, :func:`reduce_scatter_mean`
  — gradient averaging, DataParallel's gather, the ZeRO building block;
* :func:`flatten_padded` and :func:`unflatten_like` — a tree as one flat
  vector padded to a multiple of the shard count (ZeRO's pre-shape), and
  back;
* :func:`plan_buckets` and :func:`bucketed_psum` — the DDP Reducer's
  trick: size-capped flat buckets in reverse leaf order, one all-reduce
  per bucket (or ``reduce_fn``, e.g. the explicit ring of
  ``ops/ring_reduce.py``), each bucket on the wire in its promoted leaf
  dtype (or ``accum_dtype``, reduced there and cast back);
* :func:`exchange`, :func:`send_to`, :func:`recv_from` and
  :func:`ppermute_shift` — the pipeline's hops: one batch of
  ``batch_isend_irecv`` (NCCL groups it, so the order of the hops inside
  a batch cannot deadlock), tensors of static shape on the wire, nothing
  of a shape negotiation;
* :func:`hierarchical_psum` and :func:`hierarchical_psum_tree` — the
  two-level all-reduce over a ``(dcn, data)`` axis (``MeshConfig.dcn_data
  > 1``): reduce-scatter within a dcn row, all-reduce across the rows,
  all-gather within the row;
* :func:`all_to_all_tiled` — ``jax.lax.all_to_all(..., tiled=True)``,
  the re-shard of Ulysses attention and the expert exchange of MoE
  (counted apart, under ``kind="moe"``), differentiable (its transpose is
  the reverse all-to-all);
* :func:`copy_to_group` and :func:`reduce_from_group` — Megatron's two
  operators over the model axis: identity forward and all-reduce backward
  at the input of a column-parallel product, all-reduce forward and
  identity backward after a row-parallel one (JAX's shard_map writes the
  first as the transpose of a replicated input, the second as ``psum``);
* :func:`unused_param_mask`, :func:`mesh_barrier`.

Trees are tensors, lists, tuples and dicts; dict leaves are taken in
sorted key order, as ``jax.tree.leaves`` takes them, so bucket plans
agree with the JAX package's. Every collective is counted, per call, in
:data:`calls` and :data:`wire_bytes` under its ``kind`` (the bytes this
rank hands to it), as the kernel wrappers count their launches. Inside
:func:`timed`, every counted collective also waits for the device before
and after it and adds its wall time to :data:`seconds` under its kind
(instrumentation for a measured step only: it serializes the device).
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

# Collectives issued, and bytes handed to them, per kind (reset by the
# caller, e.g. to 0 before the run it counts).
calls: Counter = Counter()
wire_bytes: Counter = Counter()
# Seconds spent in each kind while :func:`timed` is on.
seconds: Counter = Counter()
_timing = {"on": False}


def reset_counts() -> None:
    calls.clear()
    wire_bytes.clear()
    seconds.clear()


@contextlib.contextmanager
def timed():
    """Time every counted collective issued inside (see the module
    docstring)."""
    _timing["on"] = True
    try:
        yield seconds
    finally:
        _timing["on"] = False


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def _clock(kind: str):
    """Add the wall time of the block to ``seconds[kind]`` when timing is
    on (the device drained on both sides)."""
    if not _timing["on"]:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        seconds[kind] += time.perf_counter() - t0


def world_size(group=None) -> int:
    """Ranks of ``group`` (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):               # torch.Tensor
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)                         # numpy array


def all_reduce_(t: torch.Tensor, group=None, *, kind: str = "all_reduce",
                async_op: bool = False):
    """Sum ``t`` over ``group`` in place, counted under ``kind``; returns
    the work handle under ``async_op``. Without a process group: nothing
    to do (None)."""
    if not dist.is_initialized():
        return None
    calls[kind] += 1
    wire_bytes[kind] += _nbytes(t)
    with _clock(kind):
        return dist.all_reduce(t, group=group, async_op=async_op)


def broadcast_(t: torch.Tensor, group=None, *, src: int = 0,
               kind: str = "broadcast") -> None:
    """Overwrite ``t`` with rank ``src``'s value, in place, counted."""
    if not dist.is_initialized():
        return
    calls[kind] += 1
    wire_bytes[kind] += _nbytes(t)
    dist.broadcast(t, src, group=group)


# -- trees ---------------------------------------------------------------------

def tree_flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """(leaves, rebuild): tensors (and None) are leaves; dicts are walked
    in sorted key order, lists and tuples in order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    leaves = [leaf for p, _ in parts for leaf in p]
    sizes = [len(p) for p, _ in parts]

    def rebuild(new: list):
        out, off = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(new[off:off + n]))
            off += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def tree_map(fn: Callable, tree: Any) -> Any:
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(x) for x in leaves])


# -- the collectives -----------------------------------------------------------

def psum_mean(tree: Any, group=None) -> Any:
    """Gradient averaging over the data axis — DDP's all-reduce-mean, one
    collective per leaf."""
    n = world_size(group)

    def mean(x):
        out = x.clone()
        all_reduce_(out, group, kind="psum")
        return out / n

    return tree_map(mean, tree)


def flatten_padded(tree: Any, n_shards: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Every leaf cast to ``dtype`` (f32 by default), concatenated in leaf
    order into one flat vector, zero-padded to a multiple of ``n_shards``:
    shard r of it is the JAX package's row r."""
    leaves = tree_flatten(tree)[0]
    flat = torch.cat([x.detach().to(dtype).reshape(-1) for x in leaves])
    pad = (-flat.numel()) % n_shards
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def unflatten_like(flat: torch.Tensor, tree: Any) -> Any:
    """The inverse of :func:`flatten_padded`: the padding dropped, each
    leaf a view of ``flat`` in its shape (in ``flat``'s dtype when it is
    the leaf's, else a cast copy)."""
    leaves, rebuild = tree_flatten(tree)
    out, off = [], 0
    for x in leaves:
        out.append(flat[off:off + x.numel()].view(x.shape).to(x.dtype))
        off += x.numel()
    return rebuild(out)


def _gloo_cuda(x: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: staged through host memory for the
    collectives gloo runs on the CPU only (reduce-scatter), as
    :func:`_host_staged` stages the point-to-point hops."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_concat(x: torch.Tensor, group=None, *,
                      axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order
    (DataParallel's output ``gather``)."""
    n = world_size(group)
    if n == 1 or not dist.is_initialized():
        return x.clone()
    calls["all_gather"] += 1
    wire_bytes["all_gather"] += _nbytes(x)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, axis)


def reduce_scatter_mean(x: torch.Tensor, group=None, *,
                        axis: int = 0) -> torch.Tensor:
    """psum_scatter-mean: rank r gets slice r (of ``axis``, split into
    world equal parts) of the mean over ranks."""
    return reduce_scatter_sum(x, group, axis=axis) / world_size(group)


def reduce_scatter_sum(x: torch.Tensor, group=None, *, axis: int = 0,
                       kind: str = "reduce_scatter") -> torch.Tensor:
    """psum_scatter: rank r gets slice r (of ``axis``, split into world
    equal parts) of the sum over ranks, counted under ``kind``."""
    n = world_size(group)
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of size {x.shape[axis]} does not "
                         f"split over {n} ranks")
    if n == 1 or not dist.is_initialized():
        return x.clone()
    calls[kind] += 1
    wire_bytes[kind] += _nbytes(x)
    staged = _gloo_cuda(x, group)
    src = x.cpu() if staged else x
    parts = [c.contiguous() for c in src.movedim(axis, 0).chunk(n)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    if staged:
        out = out.to(x.device)
    return out.movedim(0, axis)


# -- bucketed all-reduce: the DDP Reducer's coalescing -----------------------

def plan_buckets(leaves: Sequence, bucket_bytes: int = 25 * 1024 * 1024
                 ) -> list[list[int]]:
    """Group leaf indices into size-capped buckets, in reverse leaf order
    (the DDP Reducer's order: the last parameters' gradients are ready
    first in the backward). A leaf larger than the cap gets a bucket of
    its own. ``leaves`` may be a tree (its leaves are taken)."""
    if not isinstance(leaves, (list, tuple)):
        leaves = tree_flatten(leaves)[0]
    buckets: list[list[int]] = [[]]
    used = 0
    for idx in reversed(range(len(leaves))):
        nbytes = _nbytes(leaves[idx])
        if buckets[-1] and used + nbytes > bucket_bytes:
            buckets.append([])
            used = 0
        buckets[-1].append(idx)
        used += nbytes
    return buckets


def _all_reduce_sum(flat: torch.Tensor, group=None) -> torch.Tensor:
    all_reduce_(flat, group, kind="bucketed_psum")
    return flat


def bucketed_psum(tree: Any, group=None, *,
                  bucket_bytes: int = 25 * 1024 * 1024, mean: bool = True,
                  reduce_fn: Callable | None = None,
                  accum_dtype: torch.dtype | None = None) -> Any:
    """All-reduce a gradient tree in flat coalesced buckets: each bucket
    of :func:`plan_buckets` concatenated into one vector, reduced by one
    collective, split back. The wire dtype of a bucket is its promoted
    leaf dtype (bf16 gradients reduce in bf16, as torch DDP's do; a stray
    f32 leaf upcasts only its bucket), or ``accum_dtype``: reduce and
    mean-divide there, cast back to each leaf's dtype after.
    ``mean=False`` sums. ``reduce_fn(flat, group) -> summed flat`` swaps
    the transport (default: one all-reduce, counted as
    ``bucketed_psum``; ``ops/ring_reduce.ring_psum_tree`` passes the
    explicit ring)."""
    leaves, rebuild = tree_flatten(tree)
    n = world_size(group) if mean else 1
    reduce_fn = reduce_fn or _all_reduce_sum
    out: list = [None] * len(leaves)
    for bucket in plan_buckets(leaves, bucket_bytes):
        wire = accum_dtype
        if wire is None:
            wire = leaves[bucket[0]].dtype
            for i in bucket[1:]:
                wire = torch.promote_types(wire, leaves[i].dtype)
        flat = torch.cat([leaves[i].to(wire).reshape(-1) for i in bucket])
        flat = reduce_fn(flat, group)
        if mean:
            flat = flat / n
        off = 0
        for i in bucket:
            size = leaves[i].numel()
            out[i] = (flat[off:off + size].view(leaves[i].shape)
                      .to(leaves[i].dtype))
            off += size
    return rebuild(out)


def hierarchical_psum(x: torch.Tensor, inner_group, outer_group, *,
                      mean: bool = False, pad: bool = False) -> torch.Tensor:
    """Two-level all-reduce over a ``(dcn, data)`` axis
    (``mesh.MeshSpec.inner_group`` / ``outer_group``): reduce-scatter over
    the inner group, all-reduce over the outer group, all-gather over the
    inner group — the sum over every rank of both, each hop counted as the
    JAX package's ``record_collective`` names it (``reduce_scatter``,
    ``psum``, ``all_gather``). ``mean`` divides by both sizes. The leading
    dim must split over the inner group, or ``pad`` pads it with zeros
    there and cuts the result back."""
    n_in, n_out = world_size(inner_group), world_size(outer_group)
    rows = x.shape[0]
    if pad and rows % n_in:
        x = torch.nn.functional.pad(x, [0, 0] * (x.ndim - 1)
                                    + [0, (-rows) % n_in])
    shard = reduce_scatter_sum(x, inner_group)
    if dist.is_initialized() and n_out > 1:
        all_reduce_(shard, outer_group, kind="psum")
    out = all_gather_concat(shard, inner_group)
    if mean:
        out = out / (n_in * n_out)
    return out[:rows]


def hierarchical_psum_tree(tree: Any, inner_group, outer_group, *,
                           mean: bool = False) -> Any:
    """:func:`hierarchical_psum` of a gradient tree: every leaf flattened
    in leaf order into one vector of the promoted leaf dtype, padded to a
    multiple of the inner group's size, reduced, split back. Sums unless
    ``mean``."""
    leaves = tree_flatten(tree)[0]
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    flat = flatten_padded(tree, world_size(inner_group), dtype=dtype)
    return unflatten_like(hierarchical_psum(flat, inner_group, outer_group,
                                            mean=mean), tree)


# -- point to point: the pipeline's hops --------------------------------------

def _host_staged(group) -> bool:
    """gloo's send/recv take a tensor's pointer as host memory: on an H100
    a raw gloo send of a CUDA tensor fails (``writev ... Bad address``),
    so a CUDA tensor crosses a gloo group through a pinned host copy. A
    gloo group on the card exists only where the caller asked for gloo
    (``mesh.py`` never switches a backend), so the copy is never a silent
    fallback."""
    return dist.get_backend(group) == "gloo"


def exchange(sends: Sequence[tuple[torch.Tensor, int]] = (),
             recvs: Sequence[tuple[torch.Tensor, int]] = (), group=None, *,
             kind: str = "p2p") -> None:
    """One batch of point-to-point hops: every ``(tensor, dst)`` of
    ``sends`` is sent to global rank ``dst`` and every ``(buffer, src)``
    of ``recvs`` is filled from global rank ``src``, all posted together
    (``batch_isend_irecv`` over ``group``); returns when all completed.
    The peers post the matching batch; the order of hops inside a batch
    does not matter. Each hop is counted under ``{kind}_send`` /
    ``{kind}_recv``, bytes under the same names. A hop of a rank to itself
    raises (the callers keep such values where they are). Over a gloo
    group a CUDA tensor is staged through pinned host memory
    (:func:`_host_staged`)."""
    me = dist.get_rank() if dist.is_initialized() else 0
    if any(peer == me for _, peer in (*sends, *recvs)):
        raise ValueError(f"rank {me} cannot send a hop to itself")
    ops, unstage = [], []
    staged = None
    for t, dst in sends:
        calls[f"{kind}_send"] += 1
        wire_bytes[f"{kind}_send"] += _nbytes(t)
        if staged is None:
            staged = _host_staged(group)
        if staged and t.is_cuda:
            t = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
    for buf, src in recvs:
        calls[f"{kind}_recv"] += 1
        wire_bytes[f"{kind}_recv"] += _nbytes(buf)
        if staged is None:
            staged = _host_staged(group)
        target = buf
        if staged and buf.is_cuda:
            target = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            unstage.append((buf, target))
        ops.append(dist.P2POp(dist.irecv, target, src, group))
    with _clock(kind):
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for buf, host in unstage:
            buf.copy_(host)


def send_to(x: torch.Tensor, dst: int, group=None) -> None:
    """One hop: ``x`` to global rank ``dst`` (which calls
    :func:`recv_from`), counted as ``p2p_send``."""
    exchange([(x, dst)], (), group)


def recv_from(src: int, shape, dtype: torch.dtype, device,
              group=None) -> torch.Tensor:
    """One hop: a tensor of ``shape``/``dtype`` from global rank ``src``
    (which calls :func:`send_to`), counted as ``p2p_recv``."""
    buf = torch.empty(tuple(shape), dtype=dtype, device=device)
    exchange((), [(buf, src)], group)
    return buf


def ppermute_shift(x: torch.Tensor, shift: int = 1, group=None
                   ) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``group``'s ranks (in group-rank
    order): group rank ``i`` sends to ``(i + shift) % n`` and receives
    from ``(i - shift) % n``, as ``jax.lax.ppermute`` with that
    permutation does; every rank of the group must call. Without a
    process group (or at n 1) the value comes back as is (a copy)."""
    n = world_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    i = dist.get_rank(group)
    peer = lambda j: dist.get_global_rank(group, j % n) if group is not None \
        else j % n
    out = torch.empty_like(x)
    exchange([(x, peer(i + shift))], [(out, peer(i - shift))], group,
             kind="ppermute")
    return out


# -- the model and seq axes: Megatron's operators, Ulysses' re-shard ----------

def _group_size(group) -> int:
    """Ranks of ``group``; 1 for None (an axis of size 1: no group)."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group, kind=ctx.kind)
        return g, None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        out = x.contiguous().clone()
        all_reduce_(out, group, kind=kind)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_group(x: torch.Tensor, group, *,
                  kind: str = "tp_all_reduce") -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is in the forward, its cotangent
    summed over ``group`` in the backward (counted under ``kind``). At the
    input of a column-parallel product it completes the gradient of
    everything upstream, which each rank computed from its own columns
    only. ``group`` None (an axis of size 1): ``x`` itself."""
    if _group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group, kind)


def reduce_from_group(x: torch.Tensor, group, *,
                      kind: str = "tp_all_reduce") -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over ``group`` in the forward
    (``jax.lax.psum``, counted under ``kind``), its cotangent passed
    through in the backward. ``group`` None: ``x`` itself."""
    if _group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group, kind)


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group,
                kind: str) -> torch.Tensor:
    n = _group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {n} ranks")
    calls[kind] += 1
    wire_bytes[kind] += _nbytes(x)
    staged = _gloo_cuda(x, group)
    src = x.cpu() if staged else x
    # One all_to_all_single over the split axis moved to the front: chunk
    # j of it goes to group rank j, and chunk i of what comes back is
    # group rank i's (gloo runs no list all_to_all).
    front = src.movedim(split_axis, 0).contiguous()
    got = torch.empty_like(front)
    with _clock(kind):
        dist.all_to_all_single(got, front, group=group)
    out = torch.cat([c.movedim(0, split_axis) for c in got.chunk(n, 0)],
                    concat_axis)
    return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group, kind, grad_scale):
        ctx.args = (split_axis, concat_axis, group, kind, grad_scale)
        return _all_to_all(x, split_axis, concat_axis, group, kind)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group, kind, grad_scale = ctx.args
        if grad_scale != 1.0:
            g = g * grad_scale
        return (_all_to_all(g, concat_axis, split_axis, group, kind),
                None, None, None, None, None)


def all_to_all_tiled(x: torch.Tensor, split_axis: int, concat_axis: int,
                     group, *, kind: str = "all_to_all",
                     grad_scale: float = 1.0) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``: ``x`` cut into n equal chunks along ``split_axis``,
    chunk j sent to group rank j, the n chunks received concatenated
    along ``concat_axis`` in group-rank order. Differentiable: the
    backward is the all-to-all with the two axes swapped, of the
    cotangent times ``grad_scale`` (the expert exchange's, see
    ``ops/moe.moe_ffn``). Over gloo a CUDA tensor is staged through host
    memory. ``group`` None: ``x`` itself."""
    if _group_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_axis, concat_axis, group, kind,
                           float(grad_scale))


def mesh_barrier(spec) -> float:
    """Rendezvous of every rank of ``spec``'s mesh (``MeshSpec.mesh_group``:
    its data group, or the world where the mesh has other axes): an
    all-reduce of one that cannot complete until all ranks take part;
    blocks until it does. Returns the mesh's size (the reduced value)."""
    one = torch.ones((), dtype=torch.float32, device=spec.device)
    all_reduce_(one, spec.mesh_group, kind="barrier")
    return float(one)


def unused_param_mask(grads: Any) -> Any:
    """Per leaf, a 0-d bool tensor: True where the gradient is None (never
    produced) or identically zero — DDP's ``find_unused_parameters`` as a
    report. A value test: a used parameter whose gradient is exactly zero
    this step is flagged too."""
    def unused(g):
        if g is None:
            return torch.tensor(True)
        return (g == 0).all()

    return tree_map(unused, grads)
