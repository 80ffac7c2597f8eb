"""Typed configuration of the port — its own copy of the JAX package's
``config.py`` dataclasses that the ported slices read (the port imports
nothing of the JAX package): :class:`OptimizerConfig` for both trainers,
and :class:`MeshConfig`, :class:`ModelConfig`, :class:`DataConfig`,
:class:`RecoveryConfig` and :class:`TrainConfig` for the CNN trainer.

Fields and defaults are the JAX package's, field for field, so a config
written for one reads the same in the other. What the port does not run
yet is refused where it is read (``train/trainer.check_train_config``,
``models.get_model``, ``train/optim.make_optimizer``, ``mesh.py``), by
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh; axis sizes of 1 disable an axis. The port runs
    one rank per device of the ``(data, stage, model, seq, expert)`` grid
    over a process group (``mesh.py``): the data axis (two-level at
    ``dcn_data > 1``) and the ``stage`` axis on the CNN trainers; every
    axis on the Transformer LM — data, ``stage`` (the SPMD pipeline),
    ``model`` (Megatron tensor parallelism), ``seq`` (ring or Ulysses
    attention) and ``expert`` (the MoE experts)."""

    data: int = 1
    stage: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    dcn_data: int = 1
    data_axis: str = "data"
    stage_axis: str = "stage"
    model_axis: str = "model"
    seq_axis: str = "seq"
    expert_axis: str = "expert"

    @property
    def num_devices(self) -> int:
        return self.data * self.stage * self.model * self.seq * self.expert

    def axis_sizes(self) -> dict[str, int]:
        return {
            self.data_axis: self.data,
            self.stage_axis: self.stage,
            self.model_axis: self.model,
            self.seq_axis: self.seq,
            self.expert_axis: self.expert,
        }


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """SGD + cosine annealing + linear warmup, field for field the JAX
    package's ``OptimizerConfig``: ``name`` sgd (with or without
    ``fused``, the fused SGD kernel over flat buckets), adam, adamw,
    lamb, lars or adafactor (``train/optim.py``); ``accum_steps`` updates
    once per k gradients from their mean; ``ema_decay`` averages the
    weights for evaluation (the CNN ``Trainer``, gspmd and fsdp)."""

    name: str = "sgd"
    learning_rate: float = 0.4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    cosine_decay_steps: int | None = None   # if None: derived from epochs
    warmup_steps: int = 0
    grad_clip_norm: float | None = None
    accum_steps: int = 1
    ema_decay: float | None = None
    fused: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model selection + model-family knobs. ``dtype`` is the compute
    dtype ("bfloat16" on the card); parameters stay ``param_dtype``."""

    name: str = "mobilenetv2"
    num_classes: int = 10
    # "local" = per-replica batch statistics, "sync" = cross-replica
    # (over the data axis' process group), "none" = the no-BN variant.
    batchnorm: str = "local"
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    dtype: str = "float32"
    param_dtype: str = "float32"
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + loader settings (the reference's transforms: random crop
    32 pad 4, horizontal flip, normalize with CIFAR-10 statistics)."""

    name: str = "cifar10"
    root: str = "./data"
    batch_size: int = 512
    eval_batch_size: int = 1000
    image_size: int = 32
    num_workers: int = 2
    shuffle: bool = True
    augment: bool = True
    seed: int = 0
    synthetic_ok: bool = True
    synthetic_train_size: int = 2048
    synthetic_eval_size: int = 512
    synthetic_native_size: int | None = None
    # Host-thread and device prefetch depths (data/loader.PrefetchLoader,
    # DevicePrefetchLoader; 0 = off): the next batches are assembled on a
    # host thread and uploaded on a side stream while the step runs.
    # num_workers: the native gather's threads and the lazy decode's pool;
    # lazy_decode: stream a file-backed dataset per batch (None: when its
    # decoded pixels exceed data/registry.LAZY_AUTO_BYTES).
    prefetch: int = 2
    device_prefetch: int = 2
    use_native: bool = False
    lazy_decode: bool | None = None


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Automatic failure recovery; off by default. The port refuses
    ``max_retries > 0`` and fault plans (ROADMAP A5/A11)."""

    max_retries: int = 0
    lr_shrink: float = 1.0
    keep_checkpoints: int = 2
    stall_exit: bool = False
    watchdog_interval_s: float | None = None
    barrier_timeout_s: float | None = None
    faults: Sequence[Any] = ()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level CNN run configuration, plus ``device`` (the card unless
    the caller asks for the CPU)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    epochs: int = 100
    seed: int = 0
    strategy: str = "gspmd"
    ddp_bucket_bytes: int | None = None
    ddp_allreduce: str = "psum"
    grad_bucket_mb: float | None = None
    log_dir: str = "./log"
    log_name: str = "train"
    checkpoint_dir: str = "./checkpoint"
    resume: bool = False
    emergency_every: int = 0
    elastic: bool = False
    async_checkpoint: bool = False
    log_every_n_steps: int = 30
    eval_every: int = 1
    max_inflight_steps: int = 8
    check_finite_every: int = 0
    stall_budget_s: float | None = None
    consistency_every: int = 0
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)
    statusz_port: int | None = None
    device_resident_data: bool = False
    steps_per_dispatch: int = 1
    num_microbatches: int = 1
    stage_boundaries: Sequence[int] | None = None
    auto_partition: bool = False
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
    device: str = "cuda"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
