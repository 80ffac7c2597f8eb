"""Training of the port: the Transformer LM on one device, the CNNs on
one device, data-parallel over ranks or pipelined over stages.

* :mod:`.lm_trainer` — ``LMTrainConfig``, ``LMTrainer``, the token
  stream and the train step;
* :mod:`.trainer` — the CNN ``Trainer`` (gspmd, ddp, fsdp, zero,
  spmd_pipeline),
  its train, eval and device-resident multi-step functions;
* :mod:`.optim` — SGD with momentum, weight decay and the warmup/cosine
  schedule, per leaf or fused over flat buckets, and the gradient
  Reducer of data parallelism;
* :mod:`.metrics` — top-k sums and running meters;
* :mod:`.pipeline_trainer` — ``PipelineTrainer``, the runner's epoch
  loop with its checkpoint/resume, preemption and run logs;
* :mod:`.train_lm`, :mod:`.train_cnn`, :mod:`.train_model_parallel` — the
  command lines.
"""

from distributed_model_parallel_tpu_torch.train.lm_trainer import (
    LMTrainConfig,
    LMTrainer,
    make_token_stream,
    make_train_step,
)

__all__ = ["LMTrainConfig", "LMTrainer", "make_token_stream",
           "make_train_step"]
