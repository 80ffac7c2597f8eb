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
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig
from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
from distributed_model_parallel_tpu_torch.ops.collectives import plan_buckets

# fused_sgd's bucket cap (ops/pallas_optim.py): MobileNetV2's 9.2 MB of
# f32 parameters make one bucket.
FUSED_BUCKET_BYTES = 64 * 1024 * 1024


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
def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: t where ||g|| < max_norm,
    else (t / ||g||) · max_norm — on the device, no host sync."""
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class SGD:
    """``torch.optim.SGD`` driven by the schedule, with optax's
    ``clip_by_global_norm`` in front when ``grad_clip_norm`` is set.
    ``step()`` updates the parameters in place."""

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.clip = config.grad_clip_norm
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

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip is not None:
            clip_by_global_norm_([p.grad for p in self.params
                                  if p.grad is not None], self.clip)
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
    and (momentum > 0) the trace. At construction every parameter is
    rebound to a view of its slot, with its own strides (channels-last
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
    """

    def __init__(self, params, config: OptimizerConfig,
                 schedule: Callable[[int], float],
                 bucket_bytes: int = FUSED_BUCKET_BYTES):
        self.params = list(params)
        self.schedule = schedule
        self.clip = config.grad_clip_norm
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
        for bucket in self.buckets:
            n = sum(self.params[i].numel() for i in bucket)
            mk = lambda: torch.zeros(n, dtype=torch.float32,
                                     device=self.device)
            m = mk() if self.momentum else None
            self._m.append(m)
            pbuf, gbuf = (mk(), mk()) if self.flat else (None, None)
            self._p.append(pbuf)
            self._g.append(gbuf)
            off = 0
            for i in bucket:
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
                off += p.numel()
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
            clip_by_global_norm_(grads, self.clip)
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


def make_optimizer(config: OptimizerConfig, steps_per_epoch: int,
                   epochs: int, params) -> SGD | FusedSGD:
    """The SGD chain over ``params`` (:class:`FusedSGD` under ``fused``).
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
    if config.fused:
        return FusedSGD(params, config, schedule)
    return SGD(params, config, schedule)
