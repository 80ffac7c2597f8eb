"""Epoch loop of pipeline-parallel training — the port of
``distributed_model_parallel_tpu/train/pipeline_trainer.py``.

One process drives every stage through a
:class:`~..parallel.pipeline.PipelineRunner` over an explicit device
list. Loss and accuracy are computed where the data lives (stage 0);
metrics stay device tensors until a drain at ``max_inflight_steps`` or
the log cadence (one host read per drain); the step time is the window's
wall time less the loader's, per step; the history records carry the JAX
trainer's keys. Stage boundaries come from ``stage_boundaries``, from
``auto_partition`` (the cost-balanced cut at the microbatch rows,
``parallel/auto_partition.py``) or from equal unit counts. The
augmentation draws of global step s come from ``(seed + 1, s)``.

Not ported yet, and refused by name where a config field asks for them
(ROADMAP A5/A11): checkpoint/resume, fault injection, recovery, the
guards, the consistency sentinel, emergency checkpoints, elastic
restarts, the status exporter and ``strategy="auto"``; ``ema_decay`` is
refused as the JAX trainer refuses it. Absent without a field to refuse
(ROADMAP A5): the best-accuracy checkpoint (``best_acc`` is tracked),
preemption handling, log files and ``step_hook``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.config import TrainConfig
from distributed_model_parallel_tpu_torch.data.loader import (
    BatchLoader,
    resolve_input_size,
    step_generator,
)
from distributed_model_parallel_tpu_torch.data.registry import (
    ArrayDataset,
    load_dataset,
)
from distributed_model_parallel_tpu_torch.models import (
    DTYPES,
    get_model,
    params_from_jax,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineRunner,
)
from distributed_model_parallel_tpu_torch.train.metrics import AverageMeter
from distributed_model_parallel_tpu_torch.train.trainer import (
    _UNPORTED,
    EpochResult,
    eval_now,
)


def check_pipeline_config(config: TrainConfig) -> None:
    """Raise for what the pipeline trainer does not run: by ROADMAP item,
    and ``ema_decay`` as the JAX trainer refuses it."""
    if config.strategy == "auto":
        raise ValueError("strategy='auto' (the pipeline autotuner) is not "
                         "ported yet (ROADMAP A11: autotune)")
    bad = [f"{name} (ROADMAP {item})" for name, refused, item in _UNPORTED
           if refused(config)]
    if bad:
        raise ValueError(f"not ported yet: {', '.join(bad)}")
    if config.optimizer.ema_decay is not None:
        raise ValueError(
            "ema_decay is implemented by the data-parallel Trainer "
            "(gspmd/fsdp), not the pipeline trainer — no silent ignores")


def default_devices(config: TrainConfig) -> list:
    """``mesh.stage`` devices: the CPU ``stage`` times under
    ``device="cpu"``, else the first ``stage`` cards (as many as
    visible)."""
    n = max(config.mesh.stage, 1)
    if torch.device(config.device).type == "cpu":
        return ["cpu"] * n
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return [f"cuda:{i}" for i in range(min(n, torch.cuda.device_count()))]


class PipelineTrainer:
    """``PipelineTrainer(config, devices=None)``: with no device list it
    takes ``mesh.stage`` cards and raises when fewer are visible; an
    explicit list (e.g. four entries of ``cuda:0``) is the caller's
    choice and is honoured. ``train_ds``/``eval_ds`` and ``params``/
    ``state`` (the JAX package's staged trees, together) are optional, as
    for :class:`~.trainer.Trainer`."""

    def __init__(self, config: TrainConfig, devices=None, *,
                 train_ds: ArrayDataset | None = None,
                 eval_ds: ArrayDataset | None = None,
                 params=None, state=None):
        check_pipeline_config(config)
        self.config = config
        if devices is None:
            devices = default_devices(config)
        if len(devices) < config.mesh.stage:
            raise ValueError(
                f"pipeline depth {config.mesh.stage} needs that many "
                f"devices, but only {len(devices)} are available; pass an "
                f"explicit device list (several entries may name one card)")
        self.devices = list(devices)
        if train_ds is None or eval_ds is None:
            train_ds, eval_ds = load_dataset(config.data)
        self.train_ds, self.eval_ds = train_ds, eval_ds
        self.train_loader = BatchLoader(train_ds, config.data.batch_size,
                                        shuffle=config.data.shuffle,
                                        seed=config.data.seed,
                                        use_native=config.data.use_native)
        self.eval_loader = BatchLoader(
            eval_ds, min(config.data.eval_batch_size, len(eval_ds)),
            shuffle=False)
        resize_to, in_hw = resolve_input_size(train_ds.images.shape,
                                              config.data.image_size)
        if resize_to is not None:
            raise ValueError(f"image_size {config.data.image_size} differs "
                             f"from the data's {train_ds.images.shape[1]} "
                             f"px: the on-device resize is not ported yet "
                             f"(ROADMAP A3)")
        in_shape = (in_hw, in_hw, train_ds.images.shape[3])
        model = get_model(config.model, seed=config.seed, device="cpu")
        if (params is None) != (state is None):
            raise ValueError("pass params and state together")
        if params is not None:
            params_from_jax(model, params, state, "cpu")
        boundaries = config.stage_boundaries
        if boundaries is None and config.auto_partition:
            from distributed_model_parallel_tpu_torch.parallel.auto_partition import (  # noqa: E501
                auto_boundaries,
                microbatch_rows,
            )

            micro = microbatch_rows(config.data.batch_size,
                                    config.num_microbatches)
            boundaries = auto_boundaries(
                model, (micro,) + in_shape,
                len(self.devices) * max(1, config.virtual_stages))
        self.runner = PipelineRunner(
            model, self.devices, optimizer=config.optimizer,
            steps_per_epoch=len(self.train_loader), epochs=config.epochs,
            mean=train_ds.mean, std=train_ds.std, boundaries=boundaries,
            num_microbatches=config.num_microbatches,
            augment=config.data.augment, schedule=config.pipeline_schedule,
            virtual_stages=config.virtual_stages,
            bn_momentum=config.model.bn_momentum,
            dtype=DTYPES[config.model.dtype])
        self.device = self.runner.devices[0]
        self.best_acc = 0.0
        self.global_step = 0
        self.step_log: list[dict] = []

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _run_epoch(self, epoch: int, train: bool) -> EpochResult:
        meters = {k: AverageMeter(k) for k in ("loss", "acc1", "acc5")}
        base = 0
        if train:
            self.train_loader.set_epoch(epoch)
            base = self.train_loader.cursor
        loader = self.train_loader if train else self.eval_loader
        pending: list = []

        def update(m, b):
            meters["loss"].update(m["loss"], int(b))
            meters["acc1"].update(m["correct@1"] / b * 100, int(b))
            meters["acc5"].update(m["correct@5"] / b * 100, int(b))

        def drain():
            for mm, b in pending:
                update(self.runner.finalize_metrics(mm, b), b)
            pending.clear()

        max_inflight = max(1, self.config.max_inflight_steps)
        t_epoch = time.perf_counter()
        data_s, n_steps = 0.0, 0
        win_wall, win_data, win_steps = t_epoch, 0.0, 0
        t_mark = t_epoch
        for i, (images, labels) in enumerate(loader):
            images = self._to_device(images)
            labels = self._to_device(labels)
            now = time.perf_counter()
            data_s += now - t_mark
            n_steps += 1
            if train:
                gi = base + i
                gen = (step_generator(self.config.seed + 1, self.global_step,
                                      self.device)
                       if self.config.data.augment else None)
                pending.append((self.runner.train_step_device(
                    gen, images, labels), float(labels.shape[0])))
                self.global_step += 1
                log_now = gi % self.config.log_every_n_steps == 0
                if log_now or len(pending) >= max_inflight:
                    drain()
                if log_now:
                    now = time.perf_counter()
                    d_steps = max(1, n_steps - win_steps)
                    step_s = max(0.0, now - win_wall
                                 - (data_s - win_data)) / d_steps
                    win_wall, win_data, win_steps = now, data_s, n_steps
                    self.step_log.append(dict(
                        epoch=epoch, step=gi, loss=meters["loss"].avg,
                        acc1=meters["acc1"].avg, step_time_s=step_s,
                        samples_per_s=self.config.data.batch_size
                        / max(step_s, 1e-9)))
            else:
                m = self.runner.eval_step(images, labels)
                update(m, m["batch"])
            t_mark = time.perf_counter()
        drain()
        wall = time.perf_counter() - t_epoch
        return EpochResult(meters["loss"].avg, meters["acc1"].avg,
                           meters["acc5"].avg,
                           max(0.0, wall - data_s) / max(1, n_steps),
                           data_s / max(1, n_steps))

    def evaluate(self) -> EpochResult:
        return self._run_epoch(0, train=False)

    def fit(self, epochs: int | None = None) -> list[dict]:
        """Train epochs ``0 .. epochs - 1`` (default ``config.epochs``)
        with eval at the ``eval_every`` cadence; one history record per
        epoch with the JAX trainer's keys."""
        epochs = epochs if epochs is not None else self.config.epochs
        history = []
        for epoch in range(epochs):
            tr = self._run_epoch(epoch, train=True)
            ev = (self._run_epoch(epoch, train=False)
                  if eval_now(epoch, epochs, self.config.eval_every)
                  else None)
            history.append(dict(
                epoch=epoch, loss_train=tr.loss, acc1_train=tr.acc1,
                loss_val=ev.loss if ev else None,
                acc1_val=ev.acc1 if ev else None,
                time_per_batch=tr.step_time,
                time_load_per_batch=tr.data_time))
            if ev is not None and ev.acc1 > self.best_acc:
                self.best_acc = ev.acc1
        return history
