"""Trainer for the Transformer LM on one device.

Counterpart of ``distributed_model_parallel_tpu/train/lm_trainer.py`` on
a one-device mesh (``MeshConfig(data=1)``, ``gpipe``, one microbatch):
the same synthetic token stream, the same stateless batch draws per
(seed, epoch, step), the same held-out evaluation rule and the same
history records. The step is :func:`make_train_step` — ``lm_loss``, its
gradient by autograd (the flash kernels' backward on the card), then the
optimizer's update in place (any of ``train/optim.make_optimizer``'s, with
``accum_steps``; ``ema_decay`` is refused, as the JAX LM trainer refuses
it). Not ported yet (ROADMAP A9): meshes beyond one
device, checkpoint/resume, faults, guards, the consistency sentinel,
emergency checkpoints, preemption, recovery and the status exporter.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.config import OptimizerConfig
from distributed_model_parallel_tpu_torch.models import transformer as tfm
from distributed_model_parallel_tpu_torch.train.metrics import (
    AverageMeter,
    StepTimer,
)
from distributed_model_parallel_tpu_torch.train.optim import make_optimizer
from distributed_model_parallel_tpu_torch.train.trainer import eval_now


def make_token_stream(vocab_size: int, n_tokens: int, seed: int = 0
                      ) -> np.ndarray:
    """Deterministic order-1 Markov token stream — learnable structure so
    loss visibly drops below the unigram entropy (numpy draws identical to
    the JAX package's)."""
    rng = np.random.default_rng(seed)
    # sparse transition matrix: each token prefers ~4 successors
    prefs = rng.integers(0, vocab_size, size=(vocab_size, 4))
    out = np.empty(n_tokens, np.int32)
    tok = 0
    for i in range(n_tokens):
        out[i] = tok
        if rng.random() < 0.8:
            tok = int(prefs[tok, rng.integers(0, 4)])
        else:
            tok = int(rng.integers(0, vocab_size))
    return out


@dataclasses.dataclass(frozen=True)
class LMTrainConfig:
    """The fields of the JAX ``LMTrainConfig`` the one-device slice runs,
    plus ``device`` (the card unless the caller asks for the CPU)."""

    model: tfm.TransformerConfig = tfm.TransformerConfig()
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(learning_rate=0.1,
                                                weight_decay=0.0))
    batch_size: int = 8
    seq_len: int = 128
    steps_per_epoch: int = 50
    epochs: int = 1
    n_tokens: int = 200_000
    seed: int = 0
    # Held-out evaluation: the stream's trailing ``eval_fraction`` never
    # appears in training batches; ``eval_batches`` fixed batches from it
    # are scored every ``eval_every`` epochs. None = auto: 8 when the tail
    # fits one seq_len window, else eval off with a warning.
    eval_fraction: float = 0.1
    eval_batches: int | None = None
    eval_every: int = 1
    device: str = "cuda"


def make_train_step(cfg: tfm.TransformerConfig, optimizer):
    """``step(params, tokens, targets) -> {"loss": 0-d tensor}``: the
    value and gradient of ``lm_loss``, then the optimizer update — the
    counterpart of ``make_spmd_train_step`` on a one-device mesh with
    ``gpipe`` and one microbatch (``_make_loss_fn``, then ``tx.update``).
    The parameters are updated in place; the JAX step donates them and
    returns new ones instead."""
    tfm.check_training_config(cfg)

    def step(params, tokens, targets):
        optimizer.zero_grad()
        loss = tfm.lm_loss(params, tokens, targets, cfg)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def _leaves(params: dict) -> list:
    return [v for k, v in params.items() if k != "blocks"] + list(
        params["blocks"].values())


class LMTrainer:
    """Epoch loop with held-out eval over the synthetic token stream.

    ``params`` (optional) is a parameter tree in the port's layout on the
    config's device, e.g. :func:`~..models.transformer.params_from_jax`
    of another run's weights; default :func:`init_params` from ``seed``.
    ``step_log`` holds one record per training step (the JAX trainer's
    per-step telemetry)."""

    def __init__(self, config: LMTrainConfig, params: dict | None = None):
        cfg = config.model
        tfm.check_training_config(cfg)
        if config.optimizer.ema_decay is not None:
            raise ValueError(
                "ema_decay is implemented by the data-parallel Trainer "
                "(gspmd/fsdp), not the LM trainer — no silent ignores")
        if cfg.max_seq_len < config.seq_len:
            raise ValueError("model max_seq_len < training seq_len")
        self.config = config
        self.cfg = cfg
        # Index resolved ("cuda" -> "cuda:0") so it compares equal to the
        # parameters' own device.
        self.device = torch.empty(
            0, device=tfm.resolve_device(config.device)).device
        if params is None:
            params = tfm.init_params(cfg, seed=config.seed,
                                     device=self.device)
        leaves = _leaves(params)
        if any(p.device != self.device for p in leaves):
            raise ValueError(f"params must lie on {self.device}")
        for p in leaves:
            p.requires_grad_(True)
        self.params = params
        self.optimizer = make_optimizer(config.optimizer,
                                        config.steps_per_epoch,
                                        config.epochs, leaves)
        self._step = make_train_step(cfg, self.optimizer)

        self.tokens = make_token_stream(cfg.vocab_size, config.n_tokens,
                                        config.seed)
        # Train/eval split: training samples only from the head of the
        # stream; eval scores fixed batches from the held-out tail.
        self._n_train = int(len(self.tokens) * (1.0 - config.eval_fraction))
        if not (0.0 <= config.eval_fraction < 1.0):
            raise ValueError(
                f"eval_fraction must be in [0, 1), got {config.eval_fraction}")
        if self._n_train < config.seq_len + 2:
            raise ValueError(
                f"eval_fraction={config.eval_fraction} leaves only "
                f"{self._n_train} training tokens (< seq_len + 2)")
        tail_fits = len(self.tokens) - config.seq_len - 1 > self._n_train
        if config.eval_batches is None:
            self._n_eval_batches = 8 if tail_fits else 0
            if not tail_fits and config.eval_fraction > 0.0:
                warnings.warn(
                    f"held-out tail ({len(self.tokens) - self._n_train} "
                    f"tokens, eval_fraction={config.eval_fraction}) cannot "
                    f"fit one seq_len={config.seq_len} eval window; "
                    f"disabling eval (set eval_batches explicitly to make "
                    f"this an error)", stacklevel=2)
                # Nothing reads the carved-out tail: give it back.
                self._n_train = len(self.tokens)
        else:
            self._n_eval_batches = config.eval_batches
        self.eval_enabled = False
        if self._n_eval_batches > 0 and config.eval_fraction > 0.0:
            if not tail_fits:
                raise ValueError(
                    f"eval tail ({len(self.tokens) - self._n_train} tokens, "
                    f"eval_fraction={config.eval_fraction}) cannot fit one "
                    f"seq_len={config.seq_len} eval window; raise "
                    f"eval_fraction/n_tokens or set eval_batches=0")
            self.eval_enabled = True
        self.step_log: list[dict] = []

    # ------------------------------------------------------------------ data
    def sample_batch(self, epoch: int,
                     step: int) -> tuple[np.ndarray, np.ndarray]:
        """One training batch, derived statelessly from (seed, epoch,
        step)."""
        b, t = self.config.batch_size, self.config.seq_len
        rng = np.random.default_rng(
            (self.config.seed + 1, int(epoch), int(step)))
        starts = rng.integers(0, self._n_train - t - 1, size=b)
        idx = starts[:, None] + np.arange(t + 1)[None]
        chunk = self.tokens[idx]
        return chunk[:, :-1], chunk[:, 1:]

    def eval_batches(self):
        """Deterministic held-out batches from the stream's tail (the same
        batches every epoch)."""
        b, t = self.config.batch_size, self.config.seq_len
        rng = np.random.default_rng(self.config.seed + 2)
        lo, hi = self._n_train, len(self.tokens) - t - 1
        for _ in range(self._n_eval_batches):
            starts = rng.integers(lo, hi, size=b)
            idx = starts[:, None] + np.arange(t + 1)[None]
            chunk = self.tokens[idx]
            yield chunk[:, :-1], chunk[:, 1:]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, torch.long)

    @torch.no_grad()
    def evaluate(self) -> float:
        """Mean held-out loss over the fixed eval batches, one host read
        at the end."""
        if not self.eval_enabled:
            raise ValueError("eval disabled (eval_batches=0 or "
                             "eval_fraction=0)")
        vals = [tfm.lm_loss(self.params, self._to_device(toks),
                            self._to_device(tgts), self.cfg)
                for toks, tgts in self.eval_batches()]
        if not vals:
            return 0.0
        return float(torch.stack(vals).double().mean().cpu())

    # ----------------------------------------------------------------- loop
    def train_step(self, toks: np.ndarray, tgts: np.ndarray) -> float:
        """One update on a host batch; returns the loss read back to the
        host, after the card has finished the step."""
        step_m = self._step(self.params, self._to_device(toks),
                            self._to_device(tgts))
        loss = float(step_m["loss"])
        if self.device.type == "cuda":
            # The JAX loop's float(loss) sync ends the step there; here
            # the optimizer's kernels run after the loss, so wait for them.
            torch.cuda.synchronize(self.device)
        return loss

    def _train_one_epoch(self, epoch: int, epochs: int) -> dict:
        meter = AverageMeter("loss")
        timer = StepTimer()
        tokens_per_step = self.config.batch_size * self.config.seq_len
        for step_i in range(self.config.steps_per_epoch):
            toks, tgts = self.sample_batch(epoch, step_i)
            timer.data_ready()
            loss = self.train_step(toks, tgts)
            meter.update(loss)
            timer.step_done()
            self.step_log.append(dict(
                epoch=epoch, step=step_i, loss=loss,
                step_time_s=timer.step.last, data_time_s=timer.data.last,
                tokens_per_s=tokens_per_step / max(timer.step.last, 1e-9)))
        if self.eval_enabled and eval_now(epoch, epochs,
                                          self.config.eval_every):
            loss_val = self.evaluate()
        else:
            loss_val = None
        return dict(epoch=epoch, loss_train=meter.avg, loss_val=loss_val,
                    time_per_batch=timer.step.avg,
                    time_load_per_batch=timer.data.avg,
                    tokens_per_s=tokens_per_step
                    / max(timer.step.avg, 1e-9))

    def fit(self, epochs: int | None = None) -> list[dict]:
        """Run epochs ``0 .. epochs - 1`` (default ``config.epochs``);
        returns one history record per epoch."""
        epochs = epochs if epochs is not None else self.config.epochs
        return [self._train_one_epoch(epoch, epochs)
                for epoch in range(epochs)]
