"""Optimizer: SGD with momentum and weight decay, linear warmup then cosine
annealing — the port of ``distributed_model_parallel_tpu/train/optim.py``
for ``name="sgd"``, with and without ``fused``.

The JAX package chains ``clip_by_global_norm`` (optional),
``add_decayed_weights`` and ``optax.sgd``; :class:`torch.optim.SGD` keeps
the same order — weight decay added to the raw gradient before the
momentum buffer, the buffer starting at the first gradient (optax's
trace), nesterov as ``g + μ·buf``. ``fused=True`` runs the same math as
:class:`FusedSGD`: one pass per flat parameter bucket through the fused
SGD kernel (``ops/fused_sgd.py``), the counterpart of
``ops/pallas_optim.fused_sgd``. The learning rate of update n is
``schedule(n)``, counted before the increment, as optax's count is.

:class:`GradReducer` is DDP's Reducer over a process group: autograd
hooks launch one asynchronous all-reduce per bucket as its gradients are
ready (or, over the explicit ring, :meth:`GradReducer.finish` sends each
bucket round it), and :meth:`GradReducer.finish` completes and averages
them before clipping and the update. Under ``fused`` its buckets are the
optimizer's own flat gradient buffers, reduced in place.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Callable

import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig
from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_reduce_,
    calls,
    plan_buckets,
    wire_bytes,
    world_size,
)
from distributed_model_parallel_tpu_torch.ops.ring_reduce import (
    ring_all_reduce,
)

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


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float, group=None) -> None:
    """optax's ``clip_by_global_norm`` in place: t where ||g|| < max_norm,
    else (t / ||g||) · max_norm — on the device, no host sync. ``group``:
    ``grads`` are this rank's part of a tree spread over the group's ranks
    (a pipeline's stages), and the norm is the whole tree's: the squared
    sums are all-reduced before the root."""
    sq = sum(g.float().pow(2).sum() for g in grads)
    if group is not None:
        sq = torch.as_tensor(sq, dtype=torch.float32,
                             device=grads[0].device if grads else None)
        all_reduce_(sq, group, kind="clip_norm")
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class SGD:
    """``torch.optim.SGD`` driven by the schedule, with optax's
    ``clip_by_global_norm`` in front when ``grad_clip_norm`` is set (the
    norm over ``clip_group``'s ranks when it is set). ``step()`` updates
    the parameters in place."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.clip = config.grad_clip_norm
        self.clip_group = None
        self.count = 0
        momentum = config.momentum or 0.0
        self.opt = torch.optim.SGD(
            self.params, lr=schedule(0), momentum=momentum,
            weight_decay=config.weight_decay,
            # optax ignores nesterov without a momentum trace
            nesterov=bool(config.nesterov and momentum))

    @property
    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

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

    def step(self) -> None:
        if self.clip is not None:
            clip_by_global_norm_([p.grad for p in self.params
                                  if p.grad is not None], self.clip,
                                 self.clip_group)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()
        self.count += 1


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


class FusedSGD:
    """SGD as one fused update per flat parameter bucket
    (``plan_buckets`` of the parameters, ``bucket_bytes`` cap).

    Each bucket owns three contiguous f32 buffers — parameters, gradients
    and (momentum > 0) the trace — with every slot starting on a 16-byte
    boundary (:data:`SLOT_ALIGN`; the gaps between slots stay zero). At
    construction every parameter is rebound to a view of its slot, with
    its own strides (channels-last
    conv weights stay channels-last), and its ``.grad`` is set once to a
    view of the gradient slot: autograd accumulates into it in place and
    :meth:`zero_grad` zeroes the buckets (DDP's
    ``gradient_as_bucket_view``). So a step is one launch per bucket, with
    no pointer table and no concatenation. :meth:`step` checks on the host
    (no sync) that every parameter and gradient still is its slot, and
    raises if one was replaced (autograd replaces a ``.grad`` whose
    layout it cannot accumulate into; ``.to()`` rebinds parameters).

    Buckets on the card launch the kernel (``fused_sgd`` with a trace,
    ``plain_sgd`` without), or raise; their buffers are checked once, here
    (``fs.BucketLauncher``: device, type, shape, length, alignment), and a
    step launches with the kept pointers. On the CPU the plain version
    runs.
    Leaves that are not float32 are taken only on the CPU, where each
    step concatenates them in f32 and casts the delta back, as the JAX
    f32-master path does; on the card they raise (ROADMAP A4).
    ``clip_group``, as :class:`SGD`'s.
    """

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float],
                 bucket_bytes: int = FUSED_BUCKET_BYTES):
        self.params = list(params)
        self.schedule = schedule
        self.clip = config.grad_clip_norm
        self.clip_group = None
        self.count = 0
        self.momentum = float(config.momentum or 0.0)
        self.weight_decay = float(config.weight_decay)
        self.nesterov = bool(config.nesterov and self.momentum)
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise ValueError(f"FusedSGD takes parameters on one device, got "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self.flat = all(p.dtype == torch.float32 for p in self.params)
        if not self.flat and self.device.type != "cpu":
            raise TypeError("the fused SGD kernel takes float32 parameters; "
                            "f32 master weights for other leaf types are not "
                            "ported to the card yet (ROADMAP A4)")
        self.buckets = plan_buckets(self.params, bucket_bytes)
        self._p, self._g, self._m = [], [], []
        self._m_views: list = [None] * len(self.params)
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
            for i, off in zip(bucket, offsets):
                p = self.params[i]
                if not _dense(p):
                    raise ValueError(f"parameter {i} of shape "
                                     f"{tuple(p.shape)} is not dense; it "
                                     f"cannot be a bucket view")
                view = (lambda buf: buf.as_strided(p.shape, p.stride(), off))
                if m is not None:
                    self._m_views[i] = view(m)
                if self.flat:
                    pv = view(pbuf)
                    pv.copy_(p.detach())
                    p.data = pv
                    p.grad = view(gbuf)
        self._slots = ([(p.data_ptr(), p.grad.data_ptr())
                        for p in self.params] if self.flat else None)
        self._launchers = ([fs.BucketLauncher(*b) for b in
                            self.flat_buckets()]
                           if self.flat and self.device.type == "cuda"
                           else None)

    @property
    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

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

    @torch.no_grad()
    def step(self) -> None:
        if self.flat:
            self._check_views()
        grads = (self._g if self.flat else
                 [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in self.params])
        if self.clip is not None:
            clip_by_global_norm_(grads, self.clip, self.clip_group)
        lr, mu, wd = self.lr, self.momentum, self.weight_decay
        for b, bucket in enumerate(self.buckets):
            m = self._m[b]
            if self._launchers is not None:
                self._launchers[b](lr, mu, wd, self.nesterov)
            elif not self.flat:
                self._step_cast_back(bucket, grads, m, lr)
            elif m is None:
                fs.plain_sgd_kernel(self._p[b], self._g[b], lr, wd)
            else:
                fs.fused_sgd_kernel(self._p[b], m, self._g[b], lr, mu, wd,
                                    self.nesterov)
        self.count += 1

    def _step_cast_back(self, bucket, grads, m, lr) -> None:
        leaves = [self.params[i] for i in bucket]
        p = torch.cat([x.detach().float().reshape(-1) for x in leaves])
        g = torch.cat([grads[i].float().reshape(-1) for i in bucket])
        delta = fs.sgd_delta_plain(p, m, g, lr, self.momentum,
                                   self.weight_decay, self.nesterov)
        off = 0
        for x in leaves:
            x.add_(delta[off:off + x.numel()].view(x.shape).to(x.dtype))
            off += x.numel()


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
    summed by ``ops/ring_reduce.ring_all_reduce``; its hops block, so
    :meth:`finish` runs them, in bucket order on every rank, and the
    overlap with the backward is lost on this transport. A gradient never
    produced is taken as zeros. Each bucket's reduction counts one
    ``reducer`` call.

    Under :meth:`no_sync` (a pipeline's microbatches but the last) the
    hooks launch nothing and the gradients accumulate, as under torch
    DDP's ``no_sync``.

    The time from the first launch to the end of :meth:`finish` is kept
    per step (CUDA events on the card, the host clock on the CPU) and read
    by :meth:`take_times_us`.
    """

    def __init__(self, params, group, optimizer=None, *,
                 allreduce: str = "bucketed",
                 bucket_bytes: int = DDP_BUCKET_BYTES):
        if allreduce not in ("psum", "bucketed", "ring"):
            raise KeyError(f"unknown allreduce {allreduce!r}")
        self.params = list(params)
        self.group = group
        self.world = world_size(group)
        self.ring = allreduce == "ring"
        self.buffers = None
        if allreduce == "psum":
            self.buckets = [[i] for i in reversed(range(len(self.params)))]
        elif isinstance(optimizer, FusedSGD) and optimizer.flat:
            self.buckets = optimizer.buckets
            self.buffers = [g for _, _, g in optimizer.flat_buckets()]
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
                   bucket_bytes: int | None = None, zero=None):
    """The SGD chain over ``params`` (:class:`FusedSGD` under ``fused``,
    with buckets of ``bucket_bytes``, default :data:`FUSED_BUCKET_BYTES`;
    ``parallel/zero.ZeroSGD`` over the ranks of ``zero``, a MeshSpec).
    Other names, ``accum_steps > 1`` and ``ema_decay`` are not ported yet
    (ROADMAP A4) and raise; ``fused`` with another name raises, as in the
    JAX package."""
    if config.fused and config.name != "sgd":
        raise ValueError(f"OptimizerConfig.fused implements the sgd recipe "
                         f"(ops/fused_sgd.py), got name={config.name!r}; "
                         f"other optimizers are not ported yet (ROADMAP A4)")
    if config.name != "sgd":
        raise ValueError(f"optimizer {config.name!r} is not ported yet; the "
                         f"port runs 'sgd' (ROADMAP A4)")
    if config.accum_steps != 1:
        raise ValueError("accum_steps > 1 is not ported yet (ROADMAP A4)")
    if config.ema_decay is not None:
        raise ValueError("ema_decay is not ported yet (ROADMAP A4)")
    schedule = make_schedule(config, max(1, steps_per_epoch * epochs), 1)
    if zero is not None:
        from distributed_model_parallel_tpu_torch.parallel.zero import (
            ZeroSGD,
        )

        return ZeroSGD(params, config, schedule, zero)
    if config.fused:
        return FusedSGD(params, config, schedule,
                        bucket_bytes or FUSED_BUCKET_BYTES)
    return SGD(params, config, schedule)
