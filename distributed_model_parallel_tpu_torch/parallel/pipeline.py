"""Pipeline (model) parallelism over an explicit device list — the port of
``distributed_model_parallel_tpu/parallel/pipeline.py``.

A :class:`~..models.staged.StagedModel` is cut at unit boundaries into
chunks; chunk ``c`` lives on ``devices[c % S]`` (``virtual_stages = V >
1`` gives Megatron's interleaved placement: ``V·S`` chunks, device ``s``
owning chunks ``s, s + S, …``). One process drives every chunk, in the
order of a schedule over ``M`` microbatches: ``naive`` (``M == 1``, one
batch in flight, the reference's schedule), ``gpipe`` (all forwards,
then all backwards) or ``1f1b`` (after ``min(S, M)`` forwards, one
backward per forward). The reference's semantics hold: the loss is
computed on stage 0's device, where the labels live — logits travel
last → 0 and d(logits) 0 → last, the labels never move — and every chunk
steps its own optimizer (``make_optimizer`` over the chunk's parameters:
under ``fused`` each chunk has its own ``FusedSGD`` buckets on its
device).

Design: the JAX runner recomputes each chunk's forward inside its VJP
(activation rematerialization). Here each chunk keeps its autograd graph
from its forward to its backward instead: a chunk's input is detached
into a leaf that requires grad (:func:`chunk_forward`), and its backward
is ``torch.autograd.backward(y, g)`` from the gradient received from the
next chunk (:func:`chunk_backward`), which leaves the gradient to send
upstream in the input's ``.grad``. The numerics are the same, every
convolution runs once per pass and BatchNorm's statistics update once.
The price is memory: a microbatch in flight keeps its chunks' whole
activations (the JAX runner keeps only each chunk's input), so under
``gpipe`` a step holds all M microbatches' activations — what one
full-batch step holds — and under ``1f1b`` at most ``min(S, M)``.

Every microbatch's forward sees the step's starting BatchNorm running
statistics (:class:`MicrobatchBN`); the M per-microbatch states are
pooled after the schedule by :func:`merge_microbatch_bn_states`, so the
update is the one a big-batch forward would make. Gradients accumulate
over the microbatches in microbatch order (in every schedule) and are
divided by M: the gradient of the global batch's mean loss.

The JAX runner's single-device fused program exists only to save XLA
dispatches; the port runs its one schedule at any S. The SPMD engine
(``parallel/spmd_cnn_pipeline.py``) runs the same per-chunk functions in
one process per stage.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Sequence

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig
from distributed_model_parallel_tpu_torch.data.loader import (
    apply_crop_flip,
    draw_crop_flip,
    normalize,
    resize_batch,
)
from distributed_model_parallel_tpu_torch.models.layers import BatchNorm
from distributed_model_parallel_tpu_torch.models.staged import (
    StagedModel,
    params_to_jax,
    stage_slices,
)
from distributed_model_parallel_tpu_torch.train.metrics import topk_correct
from distributed_model_parallel_tpu_torch.train.optim import (
    FusedSGD,
    make_optimizer,
)
from distributed_model_parallel_tpu_torch.train.trainer import (
    cross_entropy,
    model_layouts,
)

SCHEDULES = ("gpipe", "1f1b")


# -- BatchNorm over microbatches ----------------------------------------------

def merge_microbatch_bn_states(micro_states, *, momentum: float):
    """Pool per-microbatch BN states into the one update a big-batch
    forward would make. Every microbatch starts from the same running
    statistics ``o`` and ends at ``μ·o + (1 - μ)·stat_m``; the pooled mean
    is the average, the pooled variance the average plus the variance of
    the microbatch means (law of total variance, equal microbatches):

        merged_mean = avg_m(new_mean_m)
        merged_var  = avg_m(new_var_m) + Var_m(new_mean_m) / (1 - μ)

    Trees of dicts, tuples and lists of tensors; leaves that are not a
    mean/var pair are averaged. ``momentum == 1`` freezes the statistics,
    so every state equals the old one and the correction (0/0) is
    skipped."""
    one_minus = 1.0 - momentum

    def rec(nodes):
        n0 = nodes[0]
        if isinstance(n0, Mapping):
            out = {}
            for k in n0:
                if k == "var" and "mean" in n0:
                    varz = torch.stack([n["var"] for n in nodes])
                    if one_minus == 0.0:
                        out[k] = varz.mean(0)
                        continue
                    means = torch.stack([n["mean"] for n in nodes])
                    out[k] = varz.mean(0) + torch.var(
                        means, 0, unbiased=False) / one_minus
                else:
                    out[k] = rec([n[k] for n in nodes])
            return out
        if isinstance(n0, (tuple, list)):
            return type(n0)(rec([n[i] for n in nodes])
                            for i in range(len(n0)))
        return torch.stack(nodes).mean(0)

    return rec(list(micro_states))


class MicrobatchBN:
    """The BatchNorms of one chunk across a step's microbatches: before
    a microbatch's forward (:meth:`begin`) each gets fresh copies of the
    step's starting running statistics, which its forward updates; after
    it (:meth:`end`) they are kept as microbatch m's state; :meth:`finish`
    pools them into the original buffers. Each microbatch's graph thus
    holds tensors no later forward writes to."""

    def __init__(self, modules):
        self.bns = [m for m in modules if isinstance(m, BatchNorm)]
        self.old = None
        self.states: dict[int, list] = {}

    def begin(self) -> None:
        if self.old is None:
            self.old = [(bn.running_mean, bn.running_var) for bn in self.bns]
        for bn, (mean, var) in zip(self.bns, self.old):
            bn.running_mean, bn.running_var = mean.clone(), var.clone()

    def end(self, m: int) -> None:
        self.states[m] = [{"mean": bn.running_mean, "var": bn.running_var}
                          for bn in self.bns]

    @torch.no_grad()
    def finish(self, momentum: float) -> None:
        if self.old is None:
            return
        merged = merge_microbatch_bn_states(
            [self.states[m] for m in sorted(self.states)], momentum=momentum)
        for bn, (mean, var), st in zip(self.bns, self.old, merged):
            mean.copy_(st["mean"])
            var.copy_(st["var"])
            bn.running_mean, bn.running_var = mean, var
        self.old, self.states = None, {}


# -- the per-chunk functions both engines run ----------------------------------

def chunk_forward(model: StagedModel, lo: int, hi: int, x: torch.Tensor, *,
                  train: bool = True, leaf: bool = True):
    """Units ``[lo, hi)`` of ``model`` on NHWC ``x``; returns ``(x_in,
    y)``. In training with ``leaf`` (every chunk but the first) ``x_in``
    is ``x`` detached into a leaf that requires grad, so the chunk's
    autograd graph ends there and :func:`chunk_backward` leaves the
    gradient to send upstream in ``x_in.grad``."""
    if train and leaf:
        x = x.detach().requires_grad_(True)
    y, _ = model.apply_range(x, lo, hi, train=train)
    return x, y


def chunk_backward(x_in: torch.Tensor, y: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor | None:
    """Backpropagate ``g`` = dL/dy, as received from the next chunk,
    through the chunk's kept graph: the parameters' gradients accumulate
    into their ``.grad``; returns dL/dx_in to send upstream (None for the
    first chunk, whose input needs no gradient)."""
    torch.autograd.backward(y, g)
    return x_in.grad if x_in.requires_grad else None


def loss_and_grad(logits: torch.Tensor, labels: torch.Tensor):
    """The loss where the labels live (stage 0): ``(dlogits, metrics)``
    with the microbatch's mean cross-entropy and top-k counts as 0-d
    device tensors."""
    lg = logits.detach().requires_grad_(True)
    loss = cross_entropy(lg, labels)
    (dlogits,) = torch.autograd.grad(loss, lg)
    return dlogits, {"loss": loss.detach(),
                     **topk_correct(logits.detach(), labels)}


def eval_metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    return {"loss": cross_entropy(logits, labels),
            **topk_correct(logits, labels)}


def augment_micro(generator, images_u8: torch.Tensor) -> torch.Tensor:
    """One microbatch's crop offsets and flips, drawn from ``generator``
    (in microbatch order), applied."""
    offsets, flips = draw_crop_flip(generator, images_u8.shape[0],
                                    device=images_u8.device)
    return apply_crop_flip(images_u8, offsets, flips)


@torch.no_grad()
def divide_grads_(optimizer, params, m: int) -> None:
    """Gradients summed over ``m`` microbatches → their mean, in place (the
    fused optimizer's flat gradient buckets, or each ``.grad``)."""
    if m == 1:
        return
    if isinstance(optimizer, FusedSGD) and optimizer.flat:
        for _, _, g in optimizer.flat_buckets():
            g.div_(m)
        return
    for p in params:
        if p.grad is not None:
            p.grad.div_(m)


def resolve_devices(devices) -> list[torch.device]:
    """An explicit device list, checked: all CUDA or all CPU (no CPU
    fallback), CUDA only with a card."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a pipeline needs at least one device")
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"pipeline devices must be all CUDA or all CPU, got "
                         f"{[str(d) for d in devs]}")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        devs = [torch.device("cuda", d.index if d.index is not None
                             else torch.cuda.current_device()) for d in devs]
    return devs


@dataclasses.dataclass
class StageState:
    """Everything one chunk owns: its unit range ``[lo, hi)``, its device,
    its optimizer and its microbatch BN bookkeeping. Its parameters and BN
    statistics live in the model's units ``lo .. hi - 1``."""

    lo: int
    hi: int
    device: torch.device
    optimizer: Any
    bn: MicrobatchBN

    def params(self, model: StagedModel) -> list:
        return [p for i in range(self.lo, self.hi)
                for p in model.units[i].parameters()]


class PipelineRunner:
    """Drives a StagedModel cut into chunks over ``devices``, the schedule
    expressed in Python; the card runs each chunk's work asynchronously.

    ``optimizer``: the chunks' ``OptimizerConfig`` (``steps_per_epoch`` and
    ``epochs`` set its schedule, as ``make_optimizer``'s). ``mean``/``std``
    normalize the uint8 batches on stage 0's device, after the resize to
    ``resize_to`` px (when set) and the augmentation. ``boundaries``: unit
    boundaries of the ``S·V`` chunks (default: equal counts)."""

    def __init__(self, model: StagedModel, devices: Sequence, *,
                 optimizer: OptimizerConfig, mean, std,
                 steps_per_epoch: int = 1, epochs: int = 1,
                 boundaries: Sequence[int] | None = None,
                 num_microbatches: int = 1, augment: bool = True,
                 schedule: str = "gpipe", virtual_stages: int = 1,
                 bn_momentum: float = 0.9, dtype=torch.float32,
                 resize_to: int | None = None):
        if schedule not in SCHEDULES:
            raise KeyError(f"unknown schedule {schedule!r}; known: "
                           f"{', '.join(SCHEDULES)}")
        if virtual_stages < 1 or num_microbatches < 1:
            raise ValueError(f"virtual_stages {virtual_stages} and "
                             f"num_microbatches {num_microbatches} must be "
                             f">= 1")
        self.model = model
        self.devices = resolve_devices(devices)
        self.num_stages = len(self.devices)
        self.virtual_stages = virtual_stages
        self.num_chunks = self.num_stages * virtual_stages
        self.slices = stage_slices(model.num_units, self.num_chunks,
                                   boundaries)
        self.num_microbatches = num_microbatches
        self.augment = augment
        self.schedule = schedule
        self.bn_momentum = bn_momentum
        self.dtype = dtype
        self.resize_to = resize_to
        dev0 = self.devices[0]
        self.mean = torch.as_tensor(mean, dtype=dtype, device=dev0)
        self.std = torch.as_tensor(std, dtype=dtype, device=dev0)
        self.stages: list[StageState] = []
        for c, (lo, hi) in enumerate(self.slices):
            dev = self.devices[c % self.num_stages]
            units = [model.units[i].to(dev) for i in range(lo, hi)]
            params = [p for u in units for p in u.parameters()]
            opt = make_optimizer(optimizer, steps_per_epoch, epochs, params,
                                 layouts=model_layouts(model, params))
            self.stages.append(StageState(
                lo, hi, dev, opt,
                MicrobatchBN([m for u in units for m in u.modules()])))

    # ---------------------------------------------------------------- steps
    def _schedule(self) -> list[tuple[str, int]]:
        """Order of (op, microbatch) pairs: ``gpipe`` all forwards then all
        backwards (M microbatches live); ``1f1b`` a warm-up of ``min(S,
        M)`` forwards, then a backward before each forward (at most S
        live). Both run the backwards in microbatch order."""
        S, M = self.num_stages, self.num_microbatches
        if self.schedule == "gpipe" or M == 1:
            return ([("F", m) for m in range(M)]
                    + [("B", m) for m in range(M)])
        ops: list[tuple[str, int]] = []
        warm = min(S, M)
        ops += [("F", m) for m in range(warm)]
        for m in range(warm, M):
            ops += [("B", m - warm), ("F", m)]
        ops += [("B", m) for m in range(M - warm, M)]
        return ops

    def _forward_micro(self, m, images, labels, generator, acts, dlogits,
                       metrics) -> None:
        """Microbatch m through every chunk, then its loss on stage 0."""
        multi = self.num_microbatches > 1
        x = images
        if self.augment:
            x = augment_micro(generator, x)
        x = normalize(x, self.mean, self.std, self.dtype)
        for c, st in enumerate(self.stages):
            if c:
                x = x.detach().to(st.device)
            if multi:
                st.bn.begin()
            acts[m][c] = chunk_forward(self.model, st.lo, st.hi, x,
                                       leaf=c > 0)
            if multi:
                st.bn.end(m)
            x = acts[m][c][1]
        # logits -> stage 0 for the loss (the last -> 0 hop).
        dlogits[m], metrics[m] = loss_and_grad(
            x.detach().to(self.devices[0]), labels)

    def _backward_micro(self, m, acts, dlogits) -> None:
        """d(logits) 0 -> last, then each chunk's backward, last to 0."""
        g = dlogits[m]
        for c in reversed(range(self.num_chunks)):
            st = self.stages[c]
            x_in, y = acts[m][c]
            g = chunk_backward(x_in, y, g.to(st.device))
        acts[m] = None

    def train_step_device(self, generator, images_u8, labels) -> list:
        """One optimizer step over the global batch (M microbatches);
        ``generator`` gives the augmentation draws (one set per microbatch,
        in microbatch order; None with augment off). Returns the
        per-microbatch metric dicts as device tensors (no host sync)."""
        C, M = self.num_chunks, self.num_microbatches
        dev0 = self.devices[0]
        images = torch.as_tensor(images_u8).to(dev0)
        labels = torch.as_tensor(labels).to(dev0)
        if self.resize_to is not None:
            images = resize_batch(images, self.resize_to)
        b = labels.shape[0]
        if b % M:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        mb = b // M
        for st in self.stages:
            st.optimizer.zero_grad()
        acts: list = [[None] * C for _ in range(M)]
        dlogits: list = [None] * M
        metrics: list = [None] * M
        for op, m in self._schedule():
            if op == "F":
                sl = slice(m * mb, (m + 1) * mb)
                self._forward_micro(m, images[sl], labels[sl], generator,
                                    acts, dlogits, metrics)
            else:
                self._backward_micro(m, acts, dlogits)
        # Each chunk steps its own optimizer on the mean over microbatches.
        for st in self.stages:
            divide_grads_(st.optimizer, st.params(self.model), M)
            st.bn.finish(self.bn_momentum)
            st.optimizer.step()
        return metrics

    @staticmethod
    def finalize_metrics(micro_metrics, batch: float) -> dict[str, float]:
        """One step's per-microbatch device metrics -> host floats (one
        read): the mean of the microbatch losses, top-k counts summed."""
        rows = torch.stack([torch.stack([m[k].float() for k in (
            "loss", "correct@1", "correct@5")]) for m in micro_metrics])
        loss, c1, c5 = rows.cpu().numpy().astype(np.float64).T
        return {"loss": float(loss.mean()), "batch": float(batch),
                "correct@1": float(c1.sum()), "correct@5": float(c5.sum())}

    def train_step(self, generator, images_u8, labels) -> dict[str, float]:
        """One optimizer step; blocks to return host metrics."""
        return self.finalize_metrics(
            self.train_step_device(generator, images_u8, labels),
            float(np.shape(labels)[0]))

    @torch.no_grad()
    def eval_step(self, images_u8, labels) -> dict[str, float]:
        """Forward through every chunk with the BN running statistics;
        metrics on stage 0, as host floats."""
        dev0 = self.devices[0]
        images = torch.as_tensor(images_u8).to(dev0)
        if self.resize_to is not None:
            images = resize_batch(images, self.resize_to)
        x = normalize(images, self.mean, self.std, self.dtype)
        for st in self.stages:
            x = chunk_forward(self.model, st.lo, st.hi, x.to(st.device),
                              train=False)[1]
        lab = torch.as_tensor(labels).to(dev0)
        mets = eval_metrics(x.to(dev0), lab)
        return {"loss": float(mets["loss"]), "batch": float(lab.shape[0]),
                "correct@1": float(mets["correct@1"]),
                "correct@5": float(mets["correct@5"])}

    # ------------------------------------------------------------- utilities
    def merged_params(self) -> tuple:
        """The full per-unit parameter tuple in the JAX package's layout,
        as numpy."""
        return params_to_jax(self.model)[0]

    def merged_model_state(self) -> tuple:
        """The full per-unit BN state tuple in the JAX layout, as numpy."""
        return params_to_jax(self.model)[1]
