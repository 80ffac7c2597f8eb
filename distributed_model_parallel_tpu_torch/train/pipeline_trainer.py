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
augmentation draws of global step s come from ``(seed + 1, s)``. Batches
come through the host and device prefetch stages
(``data/loader.input_stream``) and are resized on stage 0's device when
``image_size`` differs from the data's.

The harness the JAX trainer adds to the reference's pipeline (which has
none): a ``RunLogger`` (``workload="cnn-pipeline"``, the stage count,
microbatches and schedule in its ``run_start`` record), a
``Checkpointer`` in ``checkpoint_dir`` that takes the whole model's tree
— the data-parallel ``Trainer``'s keys, built from every chunk's leaves
in the JAX layout and each chunk's momentum — to the ``"pipeline"`` slot
whenever eval top-1 improves and to ``"pipeline-preempt"`` when a
preemption (SIGTERM/SIGINT or ``preemption.request()``, polled at every
train-step boundary right after ``step_hook(self)``) stops ``fit``;
``resume=True`` restores the newest valid of the two into the chunks'
tensors in place and continues mid-epoch at the saved step.

Not ported yet, and refused by name where a config field asks for them
(ROADMAP A11): fault injection, recovery, the guards, the consistency
sentinel, emergency checkpoints, elastic restarts, the status exporter
and ``strategy="auto"``; ``ema_decay`` is refused as the JAX trainer
refuses it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.config import TrainConfig
from distributed_model_parallel_tpu_torch.data.loader import (
    BatchLoader,
    input_stream,
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
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineRunner,
)
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    Checkpointer,
    manifest_stamp,
    restore_newest,
    resume_position,
    resume_subtree,
)
from distributed_model_parallel_tpu_torch.train.logging_util import (
    RunLogger,
)
from distributed_model_parallel_tpu_torch.train.metrics import AverageMeter
from distributed_model_parallel_tpu_torch.train.preemption import (
    PreemptionGuard,
    checkpoint_on_preempt,
)
from distributed_model_parallel_tpu_torch.models.staged import load_leaves
from distributed_model_parallel_tpu_torch.train.trainer import (
    _UNPORTED,
    EpochResult,
    eval_now,
    load_momentum,
    momentum_tree,
)

# Slots a resume considers, newest valid first.
RESUME_SLOTS = ("pipeline", "pipeline-preempt")


def check_pipeline_config(config: TrainConfig) -> None:
    """Raise for what the pipeline trainer does not run: by ROADMAP item,
    and ``ema_decay`` as the JAX trainer refuses it."""
    if config.strategy == "auto":
        raise ValueError("strategy='auto' (the pipeline autotuner) is not "
                         "ported yet (ROADMAP A11: autotune)")
    bad = [f"{name} (ROADMAP {item})" for name, refused, item
           in _UNPORTED if refused(config)]
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
    for :class:`~.trainer.Trainer`. ``step_hook`` (None) is called with
    the trainer at every train-step boundary, before the preemption
    poll."""

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
        host = dict(use_native=config.data.use_native,
                    num_workers=config.data.num_workers)
        self.train_loader = BatchLoader(train_ds, config.data.batch_size,
                                        shuffle=config.data.shuffle,
                                        seed=config.data.seed, **host)
        self.eval_loader = BatchLoader(
            eval_ds, min(config.data.eval_batch_size, len(eval_ds)),
            shuffle=False, **host)
        # The on-device resize when image_size differs from the data's
        # native resolution (the DP Trainer's rule).
        resize_to, in_hw = resolve_input_size(train_ds.images.shape,
                                              config.data.image_size)
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
            dtype=DTYPES[config.model.dtype], resize_to=resize_to)
        self.device = self.runner.devices[0]
        self.best_acc = 0.0
        self.start_epoch = 0
        self.global_step = 0
        # (epoch, batches consumed): the trainer's position, which a
        # prefetch worker running ahead cannot move.
        self._loader_pos = (0, 0)
        self.step_log: list[dict] = []
        self.step_hook = None
        self.preemption = PreemptionGuard()
        self.logger = RunLogger(
            config.log_dir, config.log_name,
            meta=dict(workload="cnn-pipeline", model=config.model.name,
                      batch_size=config.data.batch_size,
                      n_stages=len(self.devices),
                      num_microbatches=config.num_microbatches,
                      pipeline_schedule=config.pipeline_schedule))
        self.ckpt = Checkpointer(config.checkpoint_dir,
                                 keep=config.recovery.keep_checkpoints,
                                 meta_fn=self._ckpt_meta)
        if config.resume and any(self.ckpt.exists(n) for n in RESUME_SLOTS):
            self._resume()

    # -- checkpointing -------------------------------------------------------
    def _ckpt_meta(self) -> dict:
        return manifest_stamp("cnn-pipeline", self.config.mesh,
                              len(self.devices), self.global_step)

    def _optimizers(self) -> list:
        return [st.optimizer for st in self.runner.stages]

    @torch.no_grad()
    def _ckpt_tree(self) -> dict:
        """The whole model's state in the JAX layout with the data-parallel
        ``Trainer``'s keys: every chunk's parameters and BN statistics,
        each chunk's momentum, their common update count."""
        counts = {opt.count for opt in self._optimizers()}
        if len(counts) != 1:
            raise RuntimeError(f"the chunks' optimizers disagree on the "
                               f"update count: {sorted(counts)}")
        params, state = params_to_jax(self.runner.model)
        return {"params": params, "batch_stats": state,
                "momentum": momentum_tree(self.runner.model,
                                          self._optimizers()),
                "opt_count": np.asarray(counts.pop(), np.int32),
                "best_acc": np.asarray(self.best_acc, np.float32),
                "epoch": np.asarray(self.start_epoch, np.int32),
                "resume": resume_subtree(self.train_loader, self._loader_pos,
                                         self.global_step)}

    @torch.no_grad()
    def _load_tree(self, tree: dict) -> None:
        """A restored tree into the chunks' parameters, BN statistics and
        momentum buckets, in place on each chunk's device."""
        load_leaves(self.runner.model, tree["params"], tree["batch_stats"])
        for opt in self._optimizers():
            opt.count = int(tree["opt_count"])
        load_momentum(self.runner.model, self._optimizers(),
                      tree["momentum"])

    def _resume(self) -> None:
        """Restore the newest valid of ``RESUME_SLOTS`` and continue where
        it was saved."""
        name, restored = restore_newest(self.ckpt, self._ckpt_tree(),
                                        RESUME_SLOTS, self.logger.log_line)
        self._load_tree(restored)
        self.best_acc = float(restored["best_acc"])
        self.start_epoch, self.global_step = resume_position(
            name, restored, self.train_loader, self.logger.log_line)
        self._loader_pos = (self.train_loader.epoch, self.train_loader.cursor)

    def _run_epoch(self, epoch: int, train: bool) -> EpochResult:
        meters = {k: AverageMeter(k) for k in ("loss", "acc1", "acc5")}
        base = 0
        if train:
            self.train_loader.set_epoch(epoch)
            base = self.train_loader.cursor
            self._loader_pos = (epoch, base)
        loader = input_stream(
            self.train_loader if train else self.eval_loader, self.device,
            self.config.data.prefetch, self.config.data.device_prefetch)
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
            if train and self.step_hook is not None:
                self.step_hook(self)
            if train and self.preemption.requested():
                break
            now = time.perf_counter()
            last_data_s = now - t_mark
            data_s += last_data_s
            n_steps += 1
            if train:
                gi = base + i
                gen = (step_generator(self.config.seed + 1, self.global_step,
                                      self.device)
                       if self.config.data.augment else None)
                pending.append((self.runner.train_step_device(
                    gen, images, labels), float(labels.shape[0])))
                self.global_step += 1
                self._loader_pos = (epoch, gi + 1)
                log_now = gi % self.config.log_every_n_steps == 0
                if log_now or len(pending) >= max_inflight:
                    drain()
                if log_now:
                    now = time.perf_counter()
                    d_steps = max(1, n_steps - win_steps)
                    step_s = max(0.0, now - win_wall
                                 - (data_s - win_data)) / d_steps
                    win_wall, win_data, win_steps = now, data_s, n_steps
                    rec = dict(loss=meters["loss"].avg,
                               acc1=meters["acc1"].avg, step_time_s=step_s,
                               data_time_s=last_data_s,
                               samples_per_s=self.config.data.batch_size
                               / max(step_s, 1e-9))
                    self.step_log.append(dict(epoch=epoch, step=gi, **rec))
                    self.logger.log_step(epoch, gi, **rec)
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
        """Train epochs ``start_epoch .. epochs - 1`` (default
        ``config.epochs``; ``start_epoch`` is 0, or where a resume or a
        preempted ``fit`` left off) with eval at the ``eval_every``
        cadence, one log line per epoch and a save to the ``"pipeline"``
        slot whenever eval top-1 improves; a preemption stops at the next
        step boundary, saves to ``"pipeline-preempt"`` and returns. One
        history record per epoch run, with the JAX trainer's keys."""
        epochs = epochs if epochs is not None else self.config.epochs
        history = []
        with self.preemption.installed():
            epoch = self.start_epoch
            while epoch < epochs:
                tr = self._run_epoch(epoch, train=True)
                if self.preemption.requested():
                    # Resume redoes the rest of this epoch.
                    self.start_epoch = epoch
                    checkpoint_on_preempt(
                        self.preemption, self.ckpt, self._ckpt_tree(),
                        "pipeline-preempt", self.logger, epoch,
                        global_step=self.global_step)
                    break
                ev = (self._run_epoch(epoch, train=False)
                      if eval_now(epoch, epochs, self.config.eval_every)
                      else None)
                record = dict(
                    epoch=epoch, loss_train=tr.loss, acc1_train=tr.acc1,
                    loss_val=ev.loss if ev else None,
                    acc1_val=ev.acc1 if ev else None,
                    time_per_batch=tr.step_time,
                    time_load_per_batch=tr.data_time)
                self.logger.log_epoch(**record)
                history.append(record)
                if ev is not None and ev.acc1 > self.best_acc:
                    self.best_acc = ev.acc1
                    self.start_epoch = epoch + 1
                    self.ckpt.save(self._ckpt_tree(), "pipeline",
                                   wait=not self.config.async_checkpoint)
                epoch += 1
        self.ckpt.wait_until_finished()
        self.logger.finish(epochs_run=len(history))
        return history
