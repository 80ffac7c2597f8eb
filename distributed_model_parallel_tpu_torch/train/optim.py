"""Optimizers — the port of
``distributed_model_parallel_tpu/train/optim.py``: SGD with momentum and
weight decay (with and without ``fused``), adam, adamw, lamb, lars and
adafactor, linear warmup then cosine annealing, the global-norm clip and
gradient accumulation.

The JAX package chains ``clip_by_global_norm`` (optional) and the named
optimizer, wrapped in ``optax.MultiSteps`` when ``accum_steps > 1``.
``sgd`` chains ``add_decayed_weights`` and ``optax.sgd``:
:class:`torch.optim.SGD` keeps the same order — weight decay added to the
raw gradient before the momentum buffer, the buffer starting at the first
gradient (optax's trace), nesterov as ``g + μ·buf``. ``fused=True`` runs
the same math as :class:`FusedSGD`: one pass per flat parameter bucket
through the fused SGD kernel (``ops/fused_sgd.py``), the counterpart of
``ops/pallas_optim.fused_sgd``. The other names run
:class:`AdaptiveOptimizer` over ``train/adaptive.py``'s chains, built as
optax composes them (no kernel: the JAX package runs them as XLA
elementwise work). The learning rate of update n is ``schedule(n)``,
counted before the increment, as optax's count is.

``accum_steps = k > 1`` (:class:`Accumulator`, ``optax.MultiSteps``):
every ``step()`` folds the gradient into a running mean, ``acc + (g -
acc) / (n + 1)``; the k-th applies one update from the mean (clipped
there, once) and zeroes it, and the calls between apply nothing. The
schedule counts updates: :func:`update_schedule` converts the warmup,
decay and total lengths, which count gradient computations, to update
units. Under ``fused`` the mean accumulates into an f32 copy of each
bucket, and the kernel launches only at a boundary.

:class:`GradReducer` is DDP's Reducer over a process group: autograd
hooks launch one asynchronous all-reduce per bucket as its gradients are
ready (or, over the explicit ring or the two-level data axis,
:meth:`GradReducer.finish` sends each bucket round it), and
:meth:`GradReducer.finish` completes and averages them before clipping and
the update. Under ``fused`` its buckets are the optimizer's own flat
gradient buffers, reduced in place.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Callable

import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig
from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    calls,
    hierarchical_psum,
    plan_buckets,
    wire_bytes,
    world_size,
)
from distributed_model_parallel_tpu_torch.ops.ring_reduce import (
    ring_all_reduce,
)
from distributed_model_parallel_tpu_torch.train import adaptive

# fused_sgd's bucket cap (ops/pallas_optim.py): MobileNetV2's 9.2 MB of
# f32 parameters make one bucket.
FUSED_BUCKET_BYTES = 64 * 1024 * 1024
# bucketed_psum's default cap (ops/collectives.py), for gradients that are
# not the fused optimizer's buckets.
DDP_BUCKET_BYTES = 25 * 1024 * 1024
# Floats a parameter's slot in a flat f32 bucket is aligned to (16 bytes):
# cuDNN's f32 kernels load a BatchNorm scale or a conv weight with vector
# loads, and a slot 8 bytes into its buffer (after a 10-float head bias)
# fails them with CUDNN_STATUS_EXECUTION_FAILED_CUDART. The gaps stay 0.
SLOT_ALIGN = 4


def make_schedule(config: OptimizerConfig, steps_per_epoch: int,
                  epochs: int) -> Callable[[int], float]:
    """Linear warmup then cosine annealing to 0, per step: optax's
    ``warmup_cosine_decay_schedule`` with ``decay_steps = warmup + decay``,
    or ``cosine_decay_schedule`` when warmup is 0."""
    decay = config.cosine_decay_steps
    if decay is None:
        decay = max(1, steps_per_epoch * epochs)
    warmup = max(0, config.warmup_steps)
    peak = config.learning_rate

    def cosine(count: int) -> float:
        count = min(count, decay)
        return peak * 0.5 * (1 + math.cos(math.pi * count / decay))

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        return cosine(count - warmup)

    return schedule


def update_schedule(config: OptimizerConfig, steps_per_epoch: int,
                    epochs: int) -> Callable[[int], float]:
    """The schedule in update units, as the JAX ``make_optimizer`` builds
    it: under ``accum_steps = k`` the warmup becomes ``warmup // k``, the
    decay ``max(1, decay // k)`` and the run ``(steps_per_epoch · epochs)
    // k`` updates (totals divided over the whole run: accumulation
    carries over epoch boundaries)."""
    accum = max(1, config.accum_steps)
    if accum > 1:
        config = dataclasses.replace(
            config, warmup_steps=config.warmup_steps // accum,
            cosine_decay_steps=(None if config.cosine_decay_steps is None
                                else max(1, config.cosine_decay_steps
                                         // accum)))
    return make_schedule(config, max(1, (steps_per_epoch * epochs) // accum),
                         1)


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float, group=None,
                         layouts: list | None = None) -> None:
    """optax's ``clip_by_global_norm`` in place: t where ||g|| < max_norm,
    else (t / ||g||) · max_norm — on the device, no host sync. ``group``:
    ``grads`` are this rank's part of a tree spread over the group's ranks
    (a pipeline's stages), and the norm is the whole tree's: the squared
    sums are all-reduced before the root. ``layouts``
    (``adaptive.LeafLayout`` per gradient): the squared sums of the slices
    (FSDP's; the LM's over the stage, model and expert axes) are
    all-reduced over the groups they are cut over, the whole leaves'
    added once."""
    if layouts is not None and any(lay.cuts for lay in layouts):
        from distributed_model_parallel_tpu_torch.train.adaptive import (
            _sums,
        )

        parts = [g.float().pow(2).sum() for g in grads]
        sharded = [bool(lay.cuts) for lay in layouts]
        # One partial sum per distinct set of cut groups, completed over
        # each of them: a slice is counted once, a replica never twice.
        keys: dict = {}
        for p, lay, s in zip(parts, layouts, sharded):
            if s:
                key = tuple(id(g) for _, g in lay.cuts)
                part, _ = keys.get(key, (0.0, lay))
                keys[key] = (part + p, lay)
        done = _sums([v[0] for v in keys.values()],
                     [v[1] for v in keys.values()], [True] * len(keys),
                     kind="clip_norm")
        dev = grads[0].device
        sq = sum(done, torch.zeros((), device=dev))
        sq = sq + sum((p for p, s in zip(parts, sharded) if not s),
                      torch.zeros((), device=dev))
    else:
        sq = sum(g.float().pow(2).sum() for g in grads)
        if group is not None:
            sq = torch.as_tensor(sq, dtype=torch.float32,
                                 device=grads[0].device if grads else None)
            all_reduce_(sq, group, kind="clip_norm")
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class Accumulator:
    """``optax.MultiSteps``' running mean over ``k`` calls: ``acc[i]``
    mirrors ``like[i]`` (its dtype and shape; a fused bucket's flat f32
    gradient buffer, or a leaf). :meth:`add` folds one call's gradients
    in and says whether this call is a boundary (the k-th), where the
    mean is applied; :meth:`advance` then moves the counters
    (``mini_step`` cycles through ``0..k-1``, ``gradient_step`` counts the
    updates) and zeroes the mean after a boundary."""

    def __init__(self, k: int, like: list[torch.Tensor]):
        self.k = k
        self.acc = [torch.zeros_like(t) for t in like]
        self.mini_step = 0
        self.gradient_step = 0

    @torch.no_grad()
    def add(self, grads: list[torch.Tensor]) -> bool:
        n = self.mini_step + 1
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / n)
        return self.mini_step == self.k - 1

    @torch.no_grad()
    def advance(self, emitted: bool) -> None:
        if emitted:
            for a in self.acc:
                a.zero_()
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.k


class _Optimizer:
    """What every optimizer of the port shares: the schedule and update
    count, the clip (``clip``, over ``clip_group``'s ranks or per
    ``layouts``), the accumulator, and the checkpoint's view of the
    state. A subclass supplies ``_grads()`` (this call's gradients, in the
    accumulator's layout) and ``_apply(grads)`` (one update)."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float], layouts=None):
        self.params = list(params)
        self.schedule = schedule
        self.clip = config.grad_clip_norm
        self.clip_group = None
        self.layouts = layouts
        self.count = 0
        self.accum_steps = max(1, config.accum_steps)
        self.accum: Accumulator | None = None

    @property
    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

    @property
    def boundary(self) -> bool:
        """The last :meth:`step` applied an update (``MultiSteps``'
        ``mini_step == 0``; every step without accumulation)."""
        return self.accum is None or self.accum.mini_step == 0

    def _accumulator(self, like: list[torch.Tensor]) -> None:
        if self.accum_steps > 1:
            self.accum = Accumulator(self.accum_steps, like)

    def _clip(self, grads: list) -> None:
        if self.clip is not None:
            clip_by_global_norm_(grads, self.clip, self.clip_group,
                                 self.layouts)

    @torch.no_grad()
    def step(self) -> None:
        grads = self._grads()
        if self.accum is not None:
            emit = self.accum.add(grads)
            if not emit:
                self.accum.advance(False)
                return
            grads = self.accum.acc
        self._clip(grads)
        self._apply(grads)
        self.count += 1
        if self.accum is not None:
            self.accum.advance(True)

    # -- the checkpoint's view ------------------------------------------------
    def leaf_state(self) -> dict[str, list]:
        """Per-leaf state tensors by name (None where a leaf has none) —
        what the checkpoint stores besides the momentum: the accumulated
        mean under ``acc_grads`` (views of the fused buckets' slots)."""
        return ({"acc_grads": self._leaf_acc()}
                if self.accum is not None else {})

    def _leaf_acc(self) -> list:
        return list(self.accum.acc)

    def state_shard_axes(self, name: str) -> list:
        """Per leaf, the dim of ``leaf_state()[name]`` cut along the
        leaf's FSDP shard dim (None: whole)."""
        if self.layouts is None:
            return [None] * len(self.params)
        return [lay.cuts[0][0] if lay.cuts else None for lay in self.layouts]

    def state_cut_dims(self, name: str) -> list:
        """Per leaf, the dim of ``leaf_state()[name]`` along each of the
        leaf's cuts (a tuple, one entry a cut; None where the state
        reduced it away)."""
        if self.layouts is None:
            return [()] * len(self.params)
        return [tuple(d for d, _ in lay.cuts) for lay in self.layouts]

    def counters(self) -> dict[str, int]:
        """The integer state: the update count, and the accumulator's
        ``mini_step``/``gradient_step``."""
        out = {"count": self.count}
        if self.accum is not None:
            out.update(mini_step=self.accum.mini_step,
                       gradient_step=self.accum.gradient_step)
        return out

    @torch.no_grad()
    def load_state(self, counters: dict, leaf_state: dict) -> None:
        """Adopt a checkpoint's :meth:`counters` and :meth:`leaf_state`
        (each tensor this rank's part, in place)."""
        self.count = int(counters["count"])
        if self.accum is not None:
            self.accum.mini_step = int(counters["mini_step"])
            self.accum.gradient_step = int(counters["gradient_step"])
        for name, mine in self.leaf_state().items():
            for t, v in zip(mine, leaf_state[name]):
                if t is not None:
                    t.copy_(v)


class SGD(_Optimizer):
    """``torch.optim.SGD`` driven by the schedule, with optax's
    ``clip_by_global_norm`` in front when ``grad_clip_norm`` is set (the
    norm over ``clip_group``'s ranks when it is set). ``step()`` updates
    the parameters in place."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float], layouts=None):
        super().__init__(params, config, schedule, layouts)
        momentum = config.momentum or 0.0
        self.opt = torch.optim.SGD(
            self.params, lr=schedule(0), momentum=momentum,
            weight_decay=config.weight_decay,
            # optax ignores nesterov without a momentum trace
            nesterov=bool(config.nesterov and momentum))
        self._accumulator(self.params)

    def momentum_buffer(self, i: int) -> torch.Tensor | None:
        """Parameter i's momentum trace (None before its first update)."""
        return self.opt.state.get(self.params[i], {}).get("momentum_buffer")

    def set_momentum_buffer(self, i: int, value: torch.Tensor) -> None:
        """Parameter i's momentum trace := ``value`` (a restore; nothing
        without momentum)."""
        if self.opt.defaults["momentum"]:
            p = self.params[i]
            self.opt.state[p]["momentum_buffer"] = value.to(
                p.device, p.dtype).clone()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def _grads(self) -> list:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def _apply(self, grads) -> None:
        for p, g in zip(self.params, grads):
            if g is not p.grad:
                p.grad.copy_(g)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()


def _dense(t: torch.Tensor) -> bool:
    """Non-overlapping and dense (any dim order): a slot of a flat buffer
    can carry it with the same strides."""
    expected = 1
    for stride, size in sorted(zip(t.stride(), t.shape)):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


class FusedSGD(_Optimizer):
    """SGD as one fused update per flat parameter bucket
    (``plan_buckets`` of the parameters, ``bucket_bytes`` cap).

    Float32 leaves: each bucket owns three contiguous f32 buffers —
    parameters, gradients and (momentum > 0) the trace — with every slot
    starting on a 16-byte boundary (:data:`SLOT_ALIGN`; the gaps between
    slots stay zero). At construction every parameter is rebound to a
    view of its slot, with its own strides (channels-last conv weights
    stay channels-last), and its ``.grad`` is set once to a view of the
    gradient slot: autograd accumulates into it in place and
    :meth:`zero_grad` zeroes the buckets (DDP's
    ``gradient_as_bucket_view``). So a step is one launch per bucket, with
    no pointer table and no concatenation. :meth:`step` checks on the host
    (no sync) that every parameter and gradient still is its slot, and
    raises if one was replaced (autograd replaces a ``.grad`` whose
    layout it cannot accumulate into; ``.to()`` rebinds parameters).
    Under accumulation each bucket has an f32 mean buffer too, and the
    launch at a boundary reads it in place of the gradients.

    Buckets on the card launch the kernel (``fused_sgd`` with a trace,
    ``plain_sgd`` without), or raise; their buffers are checked once, here
    (``fs.BucketLauncher``: device, type, shape, length, alignment), and a
    step launches with the kept pointers. On the CPU the plain version
    runs.

    Leaves that are not float32 (the JAX package's f32-master
    convention, ``ops/pallas_optim.py``): each step stages a bucket's
    leaves and gradients into f32 buffers, folds the weight decay into
    the staged gradient, and launches the same kernel on a zeroed delta
    buffer in the parameters' place, so the kernel writes ``-lr·d``; the
    delta is cast to each leaf's type and added in that type, as
    ``optax.apply_updates`` adds it (each bucket's last delta stays in
    ``last_deltas``). The momentum stays f32.
    ``clip_group``, as :class:`SGD`'s.
    """

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float],
                 bucket_bytes: int = FUSED_BUCKET_BYTES, layouts=None):
        super().__init__(params, config, schedule, layouts)
        self.momentum = float(config.momentum or 0.0)
        self.weight_decay = float(config.weight_decay)
        self.nesterov = bool(config.nesterov and self.momentum)
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise ValueError(f"FusedSGD takes parameters on one device, got "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self.flat = all(p.dtype == torch.float32 for p in self.params)
        self.buckets = plan_buckets(self.params, bucket_bytes)
        self._p, self._g, self._m = [], [], []
        self._m_views: list = [None] * len(self.params)
        self._slot_views: list = []
        align = SLOT_ALIGN if self.flat else 1
        for bucket in self.buckets:
            offsets, n = [], 0
            for i in bucket:
                offsets.append(n)
                n += -(-self.params[i].numel() // align) * align
            mk = lambda: torch.zeros(n, dtype=torch.float32,
                                     device=self.device)
            m = mk() if self.momentum else None
            self._m.append(m)
            pbuf, gbuf = (mk(), mk()) if self.flat else (None, None)
            self._p.append(pbuf)
            self._g.append(gbuf)
            slots = []
            for i, off in zip(bucket, offsets):
                p = self.params[i]
                if not _dense(p):
                    raise ValueError(f"parameter {i} of shape "
                                     f"{tuple(p.shape)} is not dense; it "
                                     f"cannot be a bucket view")
                view = (lambda buf, p=p, off=off:
                        buf.as_strided(p.shape, p.stride(), off))
                slots.append((i, view))
                if m is not None:
                    self._m_views[i] = view(m)
                if self.flat:
                    pv = view(pbuf)
                    pv.copy_(p.detach())
                    p.data = pv
                    p.grad = view(gbuf)
            self._slot_views.append(slots)
        self._slots = ([(p.data_ptr(), p.grad.data_ptr())
                        for p in self.params] if self.flat else None)
        self.last_deltas: list = [None] * len(self.buckets)
        cuda = self.device.type == "cuda"
        self._accumulator(self._g if self.flat else self.params)
        self._launchers = ([fs.BucketLauncher(*b) for b in
                            self.flat_buckets()]
                           if self.flat and cuda else None)
        self._acc_launchers = (
            [fs.BucketLauncher(p, m, a) for p, m, a in
             zip(self._p, self._m, self.accum.acc)]
            if self.flat and cuda and self.accum is not None else None)

    def flat_buckets(self) -> list[tuple]:
        """(params, momentum or None, grads) flat f32 buffers per bucket
        (flat mode)."""
        return list(zip(self._p, self._m, self._g))

    def momentum_buffer(self, i: int) -> torch.Tensor | None:
        """Parameter i's momentum trace (a view of its bucket slot)."""
        return self._m_views[i]

    @torch.no_grad()
    def set_momentum_buffer(self, i: int, value: torch.Tensor) -> None:
        """Parameter i's momentum slot := ``value`` (a restore; nothing
        without momentum)."""
        if self._m_views[i] is not None:
            self._m_views[i].copy_(value)

    def _leaf_acc(self) -> list:
        if not self.flat:
            return list(self.accum.acc)
        out: list = [None] * len(self.params)
        for b, slots in enumerate(self._slot_views):
            for i, view in slots:
                out[i] = view(self.accum.acc[b])
        return out

    def zero_grad(self) -> None:
        if self.flat:
            for g in self._g:
                g.zero_()
        else:
            for p in self.params:
                p.grad = None

    def _check_views(self) -> None:
        for i, (p, (pp, gp)) in enumerate(zip(self.params, self._slots)):
            if (p.data_ptr() != pp or p.grad is None
                    or p.grad.data_ptr() != gp):
                raise RuntimeError(
                    f"parameter {i} {tuple(p.shape)} or its .grad is no "
                    f"longer its bucket slot (a gradient replaced by "
                    f"autograd or set to None, or the parameter rebound); "
                    f"the fused update would miss it")

    def _grads(self) -> list:
        if self.flat:
            self._check_views()
            return self._g
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def _apply(self, grads) -> None:
        lr, mu, wd = self.lr, self.momentum, self.weight_decay
        launchers = (self._launchers if grads is self._g
                     else self._acc_launchers)
        for b, bucket in enumerate(self.buckets):
            m = self._m[b]
            if not self.flat:
                self.last_deltas[b] = self._step_staged(bucket, grads, m, lr)
            elif launchers is not None:
                launchers[b](lr, mu, wd, self.nesterov)
            elif m is None:
                fs.plain_sgd_kernel(self._p[b], grads[b], lr, wd)
            else:
                fs.fused_sgd_kernel(self._p[b], m, grads[b], lr, mu, wd,
                                    self.nesterov)

    def _step_staged(self, bucket, grads, m, lr) -> torch.Tensor:
        """One bucket of non-f32 leaves: staged in f32, the kernel's delta
        cast back and added in each leaf's type; returns the delta."""
        leaves = [self.params[i] for i in bucket]
        p = torch.cat([x.detach().float().reshape(-1) for x in leaves])
        g = torch.cat([grads[i].float().reshape(-1) for i in bucket])
        if self.weight_decay:
            g = g + self.weight_decay * p
        delta = torch.zeros_like(p)
        if m is None:
            fs.plain_sgd_kernel(delta, g, lr, 0.0)
        else:
            fs.fused_sgd_kernel(delta, m, g, lr, self.momentum, 0.0,
                                self.nesterov)
        off = 0
        for x in leaves:
            x.add_(delta[off:off + x.numel()].view(x.shape).to(x.dtype))
            off += x.numel()
        return delta


class AdaptiveOptimizer(_Optimizer):
    """adam, adamw, lamb, lars or adafactor (``train/adaptive.py``'s
    chain of ``config.name``) over ``params``: ``step()`` clips (when
    ``grad_clip_norm`` is set), computes the updates at ``lr`` and adds
    them to the parameters in place. ``layouts``: an
    ``adaptive.LeafLayout`` per parameter (default: each a whole leaf in
    the JAX layout)."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float], layouts=None):
        super().__init__(params, config, schedule, layouts)
        self.name = config.name
        self.tx = adaptive.make_transform(
            config, [p.detach() for p in self.params], layouts)
        self._accumulator(self.params)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def momentum_buffer(self, i: int) -> None:
        """No SGD momentum: the state is :meth:`leaf_state`'s."""
        return None

    def set_momentum_buffer(self, i: int, value) -> None:
        """No SGD momentum to restore (see :meth:`load_state`)."""

    def _grads(self) -> list:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def _apply(self, grads) -> None:
        params = [p.detach() for p in self.params]
        for p, u in zip(params, self.tx.update(grads, params, self.lr,
                                               self.count)):
            p.add_(u)

    def leaf_state(self) -> dict[str, list]:
        return {**self.tx.state, **super().leaf_state()}

    def state_shard_axes(self, name: str) -> list:
        if name in self.tx.cut_dims:
            return [dims[0] if dims else None
                    for dims in self.tx.cut_dims[name]]
        return super().state_shard_axes(name)

    def state_cut_dims(self, name: str) -> list:
        if name in self.tx.cut_dims:
            return self.tx.cut_dims[name]
        return super().state_cut_dims(name)


class GradReducer:
    """DDP's Reducer: the gradient all-reduce-mean over ``group``, launched
    from autograd as the backward produces the gradients.

    A ``register_post_accumulate_grad_hook`` per parameter counts the
    ready leaves of its bucket; a full bucket launches one asynchronous
    all-reduce. :meth:`finish` (before clipping and the update) launches,
    in bucket order, each bucket no hook completed (a parameter off the
    loss path would otherwise hang every rank), waits on every handle and
    divides by the world size. Every rank issues its collectives in the
    same order: the hooks follow the graph, which is the same on every
    rank, and :meth:`finish` goes in bucket order.

    Buckets: ``allreduce="bucketed"`` over a :class:`FusedSGD` with flat
    buffers reduces the optimizer's own gradient buckets in place (its
    ``.grad`` views stay bound); otherwise :func:`plan_buckets` of the
    parameters at ``bucket_bytes``, each bucket concatenated into a flat
    copy and split back. ``"psum"``: one all-reduce per parameter, on its
    ``.grad`` in place. ``"ring"``: the buckets of ``"bucketed"``, each
    summed by ``ops/ring_reduce.ring_all_reduce``; ``"hierarchical"``
    (``hierarchy = (inner group, outer group)`` of a two-level data axis):
    the whole gradient tree as one flat vector in leaf order (the fused
    optimizer's buckets, one by one, over a flat :class:`FusedSGD`), each
    reduced by ``ops/collectives.hierarchical_psum``, as the JAX
    package's ``hierarchical_psum_tree``. Ring and hierarchical hops
    block, so :meth:`finish` runs them, in bucket order on every rank,
    and the overlap with the backward is lost on these transports. A
    gradient never produced is taken as zeros. Each bucket's reduction
    counts one ``reducer`` call.

    Under :meth:`no_sync` (a pipeline's microbatches but the last) the
    hooks launch nothing and the gradients accumulate, as under torch
    DDP's ``no_sync``.

    The time from the first launch to the end of :meth:`finish` is kept
    per step (CUDA events on the card, the host clock on the CPU) and read
    by :meth:`take_times_us`.
    """

    def __init__(self, params, group, optimizer=None, *,
                 allreduce: str = "bucketed",
                 bucket_bytes: int = DDP_BUCKET_BYTES,
                 hierarchy: tuple | None = None):
        if allreduce not in ("psum", "bucketed", "ring", "hierarchical"):
            raise KeyError(f"unknown allreduce {allreduce!r}")
        if (allreduce == "hierarchical") != (hierarchy is not None):
            raise ValueError("allreduce='hierarchical' takes the two-level "
                             "axis' (inner, outer) groups, and only it")
        self.params = list(params)
        self.group = group
        self.world = world_size(group)
        self.hierarchy = hierarchy
        # Transports whose hops block: run from finish(), in bucket order.
        self.ring = allreduce in ("ring", "hierarchical")
        self.buffers = None
        if allreduce == "psum":
            self.buckets = [[i] for i in reversed(range(len(self.params)))]
        elif isinstance(optimizer, FusedSGD) and optimizer.flat:
            self.buckets = optimizer.buckets
            self.buffers = [g for _, _, g in optimizer.flat_buckets()]
        elif hierarchy is not None:
            self.buckets = [list(range(len(self.params)))]
        else:
            self.buckets = plan_buckets(self.params, bucket_bytes)
        self._bucket_of = {i: b for b, idx in enumerate(self.buckets)
                           for i in idx}
        self._cuda = self.params[0].device.type == "cuda"
        self.times = collections.deque(maxlen=4096)
        self._sync = True
        self._reset()
        for i, p in enumerate(self.params):
            p.register_post_accumulate_grad_hook(self._hook(i))

    def _reset(self) -> None:
        self._pending = [len(idx) for idx in self.buckets]
        self._work: list = [None] * len(self.buckets)
        self._flat: list = [None] * len(self.buckets)
        self._start = None

    @contextlib.contextmanager
    def no_sync(self):
        """Backward passes inside accumulate without launching."""
        self._sync = False
        try:
            yield
        finally:
            self._sync = True

    def _hook(self, i: int):
        def hook(_param):
            if not self._sync:
                return
            b = self._bucket_of[i]
            self._pending[b] -= 1
            if self._pending[b] == 0 and not self.ring:
                self._launch(b)
        return hook

    def _grad(self, i: int) -> torch.Tensor:
        p = self.params[i]
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        return p.grad

    def _launch(self, b: int) -> None:
        if self._start is None:
            if self._cuda:
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
            else:
                self._start = time.perf_counter()
        idx = self.buckets[b]
        if self.buffers is not None:
            flat = self.buffers[b]
        elif len(idx) == 1:
            flat = self._grad(idx[0])
        else:
            flat = torch.cat([self._grad(i).reshape(-1) for i in idx])
        self._flat[b] = flat
        if self.hierarchy is not None:
            calls["reducer"] += 1
            wire_bytes["reducer"] += flat.numel() * flat.element_size()
            flat.copy_(hierarchical_psum(flat, *self.hierarchy, pad=True))
            return
        if self.ring:
            calls["reducer"] += 1
            wire_bytes["reducer"] += flat.numel() * flat.element_size()
            flat.copy_(ring_all_reduce(flat, self.group))
            return
        self._work[b] = all_reduce_(flat, self.group, kind="reducer",
                                    async_op=True)

    @torch.no_grad()
    def finish(self) -> None:
        """Complete the step's reduction: every gradient is the mean over
        the ranks when this returns."""
        for b in range(len(self.buckets)):
            if self._flat[b] is None:
                self._launch(b)
        for b, idx in enumerate(self.buckets):
            if self._work[b] is not None:
                self._work[b].wait()
            flat = self._flat[b].div_(self.world)
            if self.buffers is None and len(idx) > 1:
                off = 0
                for i in idx:
                    g = self.params[i].grad
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.times.append((self._start, end))
        else:
            self.times.append(time.perf_counter() - self._start)
        self._reset()

    def take_times_us(self) -> list[float]:
        """µs of each step's reduction since the last call (waits for the
        card)."""
        if self._cuda:
            out = [start.elapsed_time(end) * 1e3 for start, end in self.times]
        else:
            out = [s * 1e6 for s in self.times]
        self.times.clear()
        return out


def make_optimizer(config: OptimizerConfig, steps_per_epoch: int,
                   epochs: int, params, *,
                   bucket_bytes: int | None = None, zero=None,
                   layouts: list | None = None):
    """The JAX package's optimizer chain over ``params``: ``sgd``
    (:class:`FusedSGD` under ``fused``, with buckets of ``bucket_bytes``,
    default :data:`FUSED_BUCKET_BYTES`; :class:`SGD` otherwise), or adam,
    adamw, lamb, lars and adafactor (:class:`AdaptiveOptimizer`);
    ``parallel/zero.ZeroOptimizer`` over the ranks of ``zero``, a
    MeshSpec. ``accum_steps > 1`` accumulates (:class:`Accumulator`) with
    the schedule in update units (:func:`update_schedule`). ``layouts``:
    an ``adaptive.LeafLayout`` per parameter (FSDP's slices, the JAX
    shapes adafactor factors by). ``fused`` with another name raises, as
    in the JAX package; ``ema_decay`` is the trainer's."""
    if config.fused and config.name != "sgd":
        raise ValueError(
            f"OptimizerConfig.fused implements the sgd recipe "
            f"(ops/fused_sgd.py, the port of ops/pallas_optim.fused_sgd), "
            f"got name={config.name!r} — no silent ignores")
    if config.name != "sgd" and config.name not in adaptive.NAMES:
        raise KeyError(f"unknown optimizer {config.name!r}; known: sgd, "
                       f"adam, adamw, adafactor, lamb, lars")
    schedule = update_schedule(config, steps_per_epoch, epochs)
    if zero is not None:
        from distributed_model_parallel_tpu_torch.parallel.zero import (
            ZeroOptimizer,
        )

        return ZeroOptimizer(params, config, schedule, zero)
    if config.name != "sgd":
        return AdaptiveOptimizer(params, config, schedule, layouts)
    if config.fused:
        return FusedSGD(params, config, schedule,
                        bucket_bytes or FUSED_BUCKET_BYTES, layouts)
    return SGD(params, config, schedule, layouts)
