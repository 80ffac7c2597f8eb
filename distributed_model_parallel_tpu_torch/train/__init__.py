"""Training of the port: the Transformer LM on one device.

* :mod:`.lm_trainer` — ``LMTrainConfig``, ``LMTrainer``, the token
  stream and the train step;
* :mod:`.optim` — SGD with momentum, weight decay and the warmup/cosine
  schedule;
* :mod:`.metrics` — running meters;
* :mod:`.train_lm` — the command line.
"""

from distributed_model_parallel_tpu_torch.train.lm_trainer import (
    LMTrainConfig,
    LMTrainer,
    make_token_stream,
    make_train_step,
)

__all__ = ["LMTrainConfig", "LMTrainer", "make_token_stream",
           "make_train_step"]
