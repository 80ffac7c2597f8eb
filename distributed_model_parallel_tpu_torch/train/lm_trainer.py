"""Trainer for the Transformer LM over a ``(data, stage, model, seq,
expert)`` mesh.

Counterpart of ``distributed_model_parallel_tpu/train/lm_trainer.py``:
the same synthetic token stream, the same stateless batch draws per
(seed, epoch, step), the same held-out evaluation rule, history records
and run logs, and checkpoint/resume over the slots ``"lm"`` (every
epoch) and ``"lm-preempt"``. One trainer runs on each rank of the mesh's
process group (``mesh.spawn``, ``train_lm`` or torchrun), or alone at
world 1. The step is ``parallel/spmd_lm.make_spmd_train_step``: the
rank's loss on its shard of the batch (Megatron tensor parallelism over
the model axis, ring or Ulysses attention over the seq axis, the MoE
experts over the expert axis), through the SPMD pipeline over the stage
axis where the mesh or the schedule asks for it (``num_microbatches``,
``pipeline_schedule``, ``virtual_stages``), its gradient by autograd
(the flash kernels' backward on the card), completed over the mesh, then
the optimizer's update in place (any of ``train/optim.make_optimizer``'s,
whole-leaf norms over every axis a slice is cut along; ``fused`` and
``ema_decay`` are refused, as the JAX LM trainer refuses them). Under
``virtual_stages > 1`` the blocks and their optimizer state live in JAX's
interleaved storage order for the whole run; :meth:`whole_params`
exports the canonical order. MoE steps log ``moe_balance``, ``moe_z`` and
``moe_drop``, and each epoch's record ``moe_drop_rate``.

The checkpoint is the JAX trainer's tree: parameters and optimizer state
as whole leaves in the JAX layout and the storage order (gathered over
the stage, model and expert groups to the writer, global rank 0), the
epoch, ``virtual_stages`` (a resume with another count is refused, in
the JAX trainer's words) and the exact-continuation subtree; every rank
restores its own slices. Not ported yet, and refused by name:
``strategy="auto"``, a restore across another mesh split, the emergency
and "good" slots, elastic restarts, guards, the consistency sentinel,
recovery, fault injection and the status exporter (A11).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.config import (
    MeshConfig,
    OptimizerConfig,
    RecoveryConfig,
)
from distributed_model_parallel_tpu_torch.models import transformer as tfm
from distributed_model_parallel_tpu_torch.ops.collectives import all_reduce_
from distributed_model_parallel_tpu_torch.parallel import spmd_lm
from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline
from distributed_model_parallel_tpu_torch.parallel import (
    tensor_parallel as tp,
)
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    Checkpointer,
    build_resume_tree,
    manifest_stamp,
    read_manifest_meta,
    restore_newest,
    unpack_resume_tree,
)
from distributed_model_parallel_tpu_torch.train.logging_util import RunLogger
from distributed_model_parallel_tpu_torch.train.metrics import (
    AverageMeter,
    StepTimer,
)
from distributed_model_parallel_tpu_torch.train.optim import make_optimizer
from distributed_model_parallel_tpu_torch.train.preemption import (
    PreemptionGuard,
    checkpoint_on_preempt,
)
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
    """The JAX ``LMTrainConfig``, field for field, plus ``device`` (the
    card unless the caller asks for the CPU). The plane fields
    (``emergency_every`` … ``statusz_port``) are kept so they can be
    refused by name (ROADMAP A11)."""

    model: tfm.TransformerConfig = tfm.TransformerConfig()
    # "spmd" runs the configured mesh as is; "auto" (the autotuner) is
    # refused (ROADMAP A11).
    strategy: str = "spmd"
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(learning_rate=0.1,
                                                weight_decay=0.0))
    batch_size: int = 8
    seq_len: int = 128
    num_microbatches: int = 1
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
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
    log_dir: str = "./log"
    log_name: str = "lm"
    checkpoint_dir: str = "./checkpoint"
    resume: bool = False
    emergency_every: int = 0
    elastic: bool = False
    check_finite_every: int = 0
    stall_budget_s: float | None = None
    consistency_every: int = 0
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)
    statusz_port: int | None = None
    device: str = "cuda"


# Fields of the planes, refused by name until they are ported.
_UNPORTED = (
    ("emergency_every", lambda c: c.emergency_every != 0,
     "A11: emergency checkpoints"),
    ("elastic", lambda c: c.elastic, "A11: elastic restarts"),
    ("check_finite_every", lambda c: c.check_finite_every != 0,
     "A11: guards"),
    ("stall_budget_s", lambda c: c.stall_budget_s is not None,
     "A11: guards"),
    ("consistency_every", lambda c: c.consistency_every != 0,
     "A11: consistency sentinel"),
    ("recovery.max_retries", lambda c: c.recovery.max_retries > 0,
     "A11: recovery"),
    ("recovery.faults", lambda c: bool(c.recovery.faults),
     "A11: fault injection"),
    ("statusz_port", lambda c: c.statusz_port is not None,
     "A11: status exporter"),
)
# Slots a resume reads, and the planes' slots it refuses (A11).
RESUME_SLOTS = ("lm", "lm-preempt")
PLANE_SLOTS = ("lm-emergency", "lm-good")


def check_lm_config(config: LMTrainConfig) -> None:
    """Raise, naming the ROADMAP item, for what the port does not run, and
    in the JAX trainer's words for what it refuses."""
    if config.strategy == "auto":
        raise ValueError("strategy='auto' is not ported yet (ROADMAP A11: "
                         "autotune); pass strategy='spmd'")
    if config.strategy != "spmd":
        raise ValueError(
            f"LMTrainConfig.strategy must be 'spmd' or 'auto', got "
            f"{config.strategy!r} — no silent ignores")
    bad = [f"{name} (ROADMAP {item})" for name, refused, item in _UNPORTED
           if refused(config)]
    if bad:
        raise ValueError(f"not ported yet: {', '.join(bad)}")
    if config.model.max_seq_len < config.seq_len:
        raise ValueError("model max_seq_len < training seq_len")
    if config.optimizer.ema_decay is not None:
        raise ValueError(
            "ema_decay is implemented by the data-parallel Trainer "
            "(gspmd/fsdp), not the LM trainer — no silent ignores")
    if config.optimizer.fused:
        raise ValueError(
            "OptimizerConfig.fused runs the update over flat "
            "coalesced parameter buckets; the LM trainer's params are "
            "stage/tensor-sharded (spmd_pipeline.shard_params), so "
            "the flat concat would gather them to full size every "
            "step — use it on the replicated-param CNN trainer paths "
            "(gspmd/ddp) — no silent ignores")
    spmd_lm.check_spmd_config(config.model, config.mesh,
                              config.num_microbatches,
                              config.pipeline_schedule,
                              config.virtual_stages)
    # JAX raises this when it traces the step; the port at once.
    local, m = config.batch_size // config.mesh.data, config.num_microbatches
    if local % m:
        raise ValueError(f"local batch {local} not divisible by M={m}")


def _paths(params: dict) -> list[tuple]:
    """Leaf paths of a parameter tree, in the optimizer's order: the
    top-level leaves, then the blocks'."""
    return ([(k,) for k in params if k != "blocks"]
            + [("blocks", k) for k in params["blocks"]])


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _tree(paths: list, values: list) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A checkpoint array: float32 (bf16 values exactly), on the host."""
    return t.detach().float().cpu().numpy()


class LMTrainer:
    """Epoch loop with held-out eval over the synthetic token stream, one
    per rank of the mesh.

    ``spec``: this rank's :class:`~..mesh.MeshSpec` (default:
    ``make_mesh(config.mesh, config.device)`` — the process group this
    process joined, or a lone process at world 1). ``params`` (optional):
    a whole parameter tree in the JAX layout on the rank's device, e.g.
    :func:`~..models.transformer.params_from_jax` of another run's
    weights; default :func:`init_params` from ``seed``; in the canonical
    layer order (the trainer interleaves the blocks' rows under
    ``virtual_stages > 1``). The trainer keeps this rank's slices
    (``parallel/tensor_parallel.shard_tree``); :meth:`whole_params`
    gathers them back. ``step_log`` holds one record per training step
    (the JAX trainer's per-step telemetry, with the MoE router's stats
    for an MoE model)."""

    def __init__(self, config: LMTrainConfig, params: dict | None = None,
                 spec=None):
        from distributed_model_parallel_tpu_torch import mesh as mesh_mod

        check_lm_config(config)
        cfg = config.model
        self.config = config
        self.cfg = cfg
        self.spec = spec if spec is not None else mesh_mod.make_mesh(
            config.mesh, config.device)
        self.device = self.spec.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params is None:
            params = tfm.init_params(cfg, seed=config.seed,
                                     device=self.device)
        self._paths = _paths(params)
        if any(_at(params, p).device != self.device for p in self._paths):
            raise ValueError(f"params must lie on {self.device}")
        params = dict(params, blocks=spmd_pipeline.interleave_block_rows(
            params["blocks"], cfg.n_layers, self.spec.num_stages,
            config.virtual_stages))
        self.params = tp.shard_tree(params, cfg, self.spec)
        del params
        self.leaves = [_at(self.params, p) for p in self._paths]
        cuts = tp.param_cuts(cfg, self.spec)
        self._cuts = [_at(cuts, p) for p in self._paths]
        for p in self.leaves:
            p.requires_grad_(True)
        self.optimizer = make_optimizer(
            config.optimizer, config.steps_per_epoch, config.epochs,
            self.leaves, layouts=self._layouts())
        self._step = spmd_lm.make_spmd_train_step(
            cfg, self.spec, self.optimizer, self.leaves,
            num_microbatches=config.num_microbatches,
            schedule=config.pipeline_schedule,
            virtual_stages=config.virtual_stages, cuts=self._cuts)
        # The rank's LM pipeline (None on the plain path): its tables.
        self.pipeline = self._step.pipeline
        self._eval_loss = spmd_lm.make_spmd_eval_loss(
            cfg, self.spec, config.num_microbatches,
            schedule=config.pipeline_schedule,
            virtual_stages=config.virtual_stages)
        self.last_step_metrics: dict = {}

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
        self.preemption = PreemptionGuard()
        # Called with this trainer at every train-step boundary, before
        # the preemption poll (the JAX trainer's cooperative hook).
        self.step_hook = None
        self._writer = self.spec.rank == 0
        from distributed_model_parallel_tpu_torch.utils.profiling import (
            lm_model_flops,
        )

        self.logger = RunLogger(
            config.log_dir, config.log_name,
            meta=dict(workload="lm", batch_size=config.batch_size,
                      seq_len=config.seq_len,
                      tokens_per_step=config.batch_size * config.seq_len,
                      mesh=config.mesh.axis_sizes(),
                      pipeline_schedule=config.pipeline_schedule,
                      model_flops_per_step=lm_model_flops(
                          cfg, config.batch_size, config.seq_len))
        ) if self._writer else None
        self.ckpt = Checkpointer(config.checkpoint_dir,
                                 keep=config.recovery.keep_checkpoints,
                                 meta_fn=self._ckpt_meta)
        self.start_epoch = 0
        # The exact-continuation position: the next (epoch, step) the loop
        # samples; batches are stateless in (seed, epoch, step).
        self._pos_epoch = 0
        self._pos_step = 0
        self._global_step = 0
        if config.resume and any(self.ckpt.exists(n)
                                 for n in RESUME_SLOTS + PLANE_SLOTS):
            self._resume()

    @property
    def global_step(self) -> int:
        return self._global_step

    def _layouts(self) -> list:
        """An ``adaptive.LeafLayout`` per leaf: the whole JAX shape and
        every cut of the slice (its dim and group over the stage, model
        and expert axes)."""
        from distributed_model_parallel_tpu_torch.train.adaptive import (
            LeafLayout,
        )

        out = []
        for leaf, cuts in zip(self.leaves, self._cuts):
            shape = list(leaf.shape)
            groups = []
            for axis, dim in cuts:
                shape[dim] *= tp.axis_size(self.spec, axis)
                groups.append((dim, tp.axis_group(self.spec, axis)))
            out.append(LeafLayout(tuple(shape), tuple(range(leaf.ndim)),
                                  tuple(groups)))
        return out

    def _log_line(self, message: str) -> None:
        if self.logger is not None:
            self.logger.log_line(message)

    # ------------------------------------------------------------------ data
    def sample_batch(self, epoch: int,
                     step: int) -> tuple[np.ndarray, np.ndarray]:
        """One global training batch, derived statelessly from (seed,
        epoch, step)."""
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

    def _shard(self, toks: np.ndarray, tgts: np.ndarray):
        """This rank's part of a global host batch, on its device."""
        toks, tgts = spmd_lm.shard_batch(torch.from_numpy(toks),
                                         torch.from_numpy(tgts), self.cfg,
                                         self.spec)
        to = lambda a: a.contiguous().to(self.device, torch.long)
        return to(toks), to(tgts)

    def evaluate(self) -> float:
        """Mean held-out loss over the fixed eval batches (the same value on
        every rank), one host read at the end."""
        if not self.eval_enabled:
            raise ValueError("eval disabled (eval_batches=0 or "
                             "eval_fraction=0)")
        vals = [self._eval_loss(self.params, *self._shard(toks, tgts))
                for toks, tgts in self.eval_batches()]
        if not vals:
            return 0.0
        return float(torch.stack(vals).double().mean().cpu())

    # ----------------------------------------------------------------- loop
    def train_step(self, toks: np.ndarray, tgts: np.ndarray) -> float:
        """One update on a global host batch; returns the loss (the mean
        over every token) read back to the host, after the card has
        finished the step."""
        step_m = self._step(self.params, *self._shard(toks, tgts))
        self.last_step_metrics = {k: float(v) for k, v in step_m.items()}
        loss = self.last_step_metrics["loss"]
        if self.device.type == "cuda":
            # The JAX loop's float(loss) sync ends the step there; here
            # the optimizer's kernels run after the loss, so wait for them.
            torch.cuda.synchronize(self.device)
        return loss

    def _train_one_epoch(self, epoch: int, epochs: int) -> dict | None:
        """One training epoch + eval: the history record, or None when a
        preemption stopped the epoch (the checkpoint already written)."""
        meter = AverageMeter("loss")
        drop_meter = AverageMeter("moe_drop")
        timer = StepTimer()
        tokens_per_step = self.config.batch_size * self.config.seq_len
        if epoch != self._pos_epoch:
            self._pos_epoch, self._pos_step = epoch, 0
        for step_i in range(self._pos_step, self.config.steps_per_epoch):
            if self.step_hook is not None:
                self.step_hook(self)
            if self.preemption.requested():
                break
            toks, tgts = self.sample_batch(epoch, step_i)
            timer.data_ready()
            loss = self.train_step(toks, tgts)
            meter.update(loss)
            moe = {k: v for k, v in self.last_step_metrics.items()
                   if k.startswith("moe_")}
            if "moe_drop" in moe:
                drop_meter.update(moe["moe_drop"])
            self._pos_step = step_i + 1
            self._global_step += 1
            timer.step_done()
            self.step_log.append(dict(
                epoch=epoch, step=step_i, loss=loss,
                step_time_s=timer.step.last, data_time_s=timer.data.last,
                tokens_per_s=tokens_per_step / max(timer.step.last, 1e-9),
                **moe))
        if self.preemption.requested():
            # Partial epoch: save for resume at this epoch and stop.
            self.start_epoch = epoch
            tree = self._ckpt_tree()
            checkpoint_on_preempt(self.preemption,
                                  self.ckpt if self._writer else None, tree,
                                  "lm-preempt", self.logger, epoch,
                                  global_step=self._global_step)
            self._barrier()
            return None
        if self.eval_enabled and eval_now(epoch, epochs,
                                          self.config.eval_every):
            loss_val = self.evaluate()
        else:
            loss_val = None
        record = dict(epoch=epoch, loss_train=meter.avg, loss_val=loss_val,
                      time_per_batch=timer.step.avg,
                      time_load_per_batch=timer.data.avg,
                      tokens_per_s=tokens_per_step
                      / max(timer.step.avg, 1e-9))
        if drop_meter.count:
            # The share of token-choices dropped at capacity this epoch.
            record["moe_drop_rate"] = drop_meter.avg
        return record

    def fit(self, epochs: int | None = None) -> list[dict]:
        """Train epochs ``start_epoch .. epochs - 1`` (default
        ``config.epochs``) with eval at the ``eval_every`` cadence, one log
        line and a save to the ``"lm"`` slot per epoch. SIGTERM/SIGINT or
        ``preemption.request()`` stops at the next step boundary, saves to
        ``"lm-preempt"`` (resume continues at that step) and returns the
        epochs completed."""
        epochs = epochs if epochs is not None else self.config.epochs
        history = []
        with self.preemption.installed():
            epoch = self.start_epoch
            while epoch < epochs:
                record = self._train_one_epoch(epoch, epochs)
                if record is None:
                    break
                if self.logger is not None:
                    self.logger.log_epoch(**record)
                history.append(record)
                self.start_epoch = epoch + 1
                tree = self._ckpt_tree()
                if self._writer:
                    self.ckpt.save(tree, "lm")
                self._barrier()
                epoch += 1
        if self.logger is not None:
            self.logger.finish(epochs_run=len(history))
        return history

    # ----------------------------------------------------------- checkpoint
    def _barrier(self) -> None:
        """Rendezvous of every rank of the mesh (the writer's save must
        have committed before any rank may look for it). The host reads
        the reduced value: an NCCL all-reduce returns before it
        completes."""
        if self.spec.backend is not None:
            one = torch.ones((), device=self.device)
            all_reduce_(one, None, kind="barrier")
            one.item()

    def _ckpt_meta(self) -> dict:
        """Manifest stamp: the saving topology, the virtual stages (the
        blocks' storage order) and the exact position."""
        return manifest_stamp("lm", self.config.mesh,
                              self.config.mesh.num_devices,
                              self._global_step,
                              virtual_stages=self.config.virtual_stages)

    def _check_virtual_stages(self, ckpt_v: int) -> None:
        """Refuse, in the JAX trainer's words, a checkpoint whose blocks
        are in another interleaved storage order."""
        if ckpt_v != self.config.virtual_stages:
            raise ValueError(
                f"checkpoint was written with virtual_stages={ckpt_v} "
                f"(blocks+opt-state rows in that interleaved storage "
                f"order) but this run has virtual_stages="
                f"{self.config.virtual_stages}; convert the blocks with "
                f"parallel.spmd_pipeline.deinterleave_block_rows/"
                f"interleave_block_rows (optimizer state rows too) or "
                f"resume with the matching V")

    def _gather(self, t: torch.Tensor, cuts: tuple) -> torch.Tensor:
        """The whole leaf of a slice cut by ``cuts`` (dims of ``t``)."""
        return tp.gather_leaf(t, cuts, self.spec)

    @torch.no_grad()
    def storage_params(self) -> dict:
        """The parameters as whole leaves in the JAX layout and the run's
        storage order (gathered over the stage, model and expert groups;
        every rank calls)."""
        return _tree(self._paths, [self._gather(p, c) for p, c in
                                   zip(self.leaves, self._cuts)])

    @torch.no_grad()
    def whole_params(self) -> dict:
        """The parameters as whole leaves in the JAX layout and the
        canonical layer order (JAX's ``_canonical_params``; every rank
        calls)."""
        out = self.storage_params()
        out["blocks"] = spmd_pipeline.deinterleave_block_rows(
            out["blocks"], self.cfg.n_layers, self.spec.num_stages,
            self.config.virtual_stages)
        return out

    def _whole_host(self, t: torch.Tensor, cuts: tuple) -> np.ndarray:
        """The whole leaf of a slice as a checkpoint array (a gather: every
        rank calls)."""
        return _host(self._gather(t, cuts))

    def _whole_shape(self, t: torch.Tensor, cuts: tuple) -> np.ndarray:
        """A zero-cost stand-in with the whole leaf's shape (the restore's
        template reads keys and shapes only; no gather)."""
        shape = list(t.shape)
        for axis, dim in cuts:
            shape[dim] *= tp.axis_size(self.spec, axis)
        return np.broadcast_to(np.zeros((), np.float32), shape)

    @torch.no_grad()
    def opt_state_tree(self, fetch=None) -> dict:
        """The optimizer's state as whole leaves (numpy, the JAX layout):
        the update count, SGD's momentum, every ``leaf_state()`` tensor
        (adam's mu/nu, lars' trace, adafactor's statistics, the
        accumulated mean), the accumulation counters. Every rank calls.
        ``fetch(slice, cuts)`` makes each leaf (default: the gathered
        whole leaf)."""
        fetch = fetch or self._whole_host
        opt = self.optimizer
        counters = opt.counters()
        out = {"count": np.asarray(counters.pop("count"), np.int32)}
        if counters:
            out["accum"] = {k: np.asarray(v, np.int32)
                            for k, v in counters.items()}
        if hasattr(opt, "opt") and opt.opt.defaults.get("momentum"):
            moms = []
            for i, (p, cuts) in enumerate(zip(self.leaves, self._cuts)):
                m = opt.momentum_buffer(i)
                m = torch.zeros_like(p) if m is None else m
                moms.append(fetch(m, cuts))
            out["momentum"] = _tree(self._paths, moms)
        for name, tensors in sorted(opt.leaf_state().items()):
            out[name] = _tree(self._paths, [
                np.zeros((1,), np.float32) if t is None else fetch(t, cuts)
                for t, cuts in zip(tensors, self._state_cuts(name))])
        return out

    def _state_cuts(self, name: str) -> list:
        """Per leaf, the cuts of ``leaf_state()[name]``: the leaf's, each
        at the dim the state tensor keeps it (a reduced dim drops its
        cut)."""
        dims = self.optimizer.state_cut_dims(name)
        return [tuple((axis, d) for (axis, _), d in zip(cuts, ds)
                      if d is not None)
                for cuts, ds in zip(self._cuts, dims)]

    def _ckpt_tree(self, template: bool = False) -> dict:
        """The JAX trainer's checkpoint tree (``_ckpt_tree``): whole
        parameters (in storage order) and optimizer state, epoch,
        ``virtual_stages`` and the exact-continuation subtree. Every rank
        calls (the gathers are collectives); the writer saves it. With
        ``template`` the leaves are shape stand-ins, gathered from no
        one (a restore's template)."""
        fetch = self._whole_shape if template else self._whole_host
        params = _tree(self._paths, [fetch(p, c) for p, c in
                                     zip(self.leaves, self._cuts)])
        return {"params": params, "opt_state": self.opt_state_tree(fetch),
                "epoch": np.asarray(self.start_epoch, np.int32),
                "virtual_stages": np.asarray(self.config.virtual_stages,
                                             np.int32),
                "resume": build_resume_tree(
                    self._pos_epoch, self._pos_step,
                    self.config.steps_per_epoch, self._global_step,
                    {"retries_left": 0, "lr_scale": 1.0})}

    def _slice(self, a: np.ndarray, like: torch.Tensor,
               cuts: tuple) -> torch.Tensor:
        """This rank's part of a whole checkpoint array, as ``like``'s
        dtype on its device."""
        t = tp.cut_leaf(torch.from_numpy(np.asarray(a, np.float32).copy()),
                        cuts, self.spec)
        return t.to(device=like.device, dtype=like.dtype)

    @torch.no_grad()
    def _load_tree(self, tree: dict) -> None:
        """Adopt a restored checkpoint: this rank's slices of the
        parameters and of the optimizer's state, and its counters."""
        for p, path, cuts in zip(self.leaves, self._paths, self._cuts):
            p.copy_(self._slice(_at(tree["params"], path), p, cuts))
        opt = self.optimizer
        state = tree["opt_state"]
        counters = {"count": int(state["count"]),
                    **{k: int(v) for k, v in state.get("accum", {}).items()}}
        parts = {}
        for name, tensors in opt.leaf_state().items():
            parts[name] = [None if t is None else self._slice(
                _at(state[name], path), t, cuts)
                for t, path, cuts in zip(tensors, self._paths,
                                         self._state_cuts(name))]
        opt.load_state(counters, parts)
        if "momentum" in state and counters["count"] > 0:
            for i, (p, path, cuts) in enumerate(zip(
                    self.leaves, self._paths, self._cuts)):
                opt.set_momentum_buffer(i, self._slice(
                    _at(state["momentum"], path), p, cuts))

    def _resume(self) -> None:
        """Restore the newest valid of ``RESUME_SLOTS`` on every rank (each
        reads the file and keeps its slices) and continue where it was
        saved. A checkpoint written on another mesh split is refused."""
        newest = self.ckpt.newest_name(RESUME_SLOTS + PLANE_SLOTS)
        if newest in PLANE_SLOTS:
            raise ValueError(
                f"resume: the newest checkpoint is slot {newest!r}, which "
                f"the emergency/recovery planes write; restoring from it "
                f"is not ported yet (ROADMAP A11: emergency checkpoints)")
        # The newest version's stamp says its storage order before the
        # gathers and the read of a whole restore.
        stamped = read_manifest_meta(self.ckpt._latest_path(newest)).get(
            "virtual_stages")
        if stamped is not None:
            self._check_virtual_stages(int(stamped))
        name, restored = restore_newest(self.ckpt,
                                        self._ckpt_tree(template=True),
                                        RESUME_SLOTS, self._log_line)
        saved = read_manifest_meta(self.ckpt.last_restored_path).get("mesh")
        current = self._ckpt_meta()["mesh"]
        if saved is not None and saved != current:
            raise ValueError(
                f"resume: slot {name!r} was written on mesh {saved}, this "
                f"run's mesh is {current}; a restore onto another split is "
                f"not ported yet (ROADMAP A11: resharded restore)")
        self._check_virtual_stages(int(restored["virtual_stages"]))
        self._load_tree(restored)
        self.start_epoch = int(restored["epoch"])
        (self._pos_epoch, self._pos_step, self._global_step,
         _, _) = unpack_resume_tree(restored["resume"])
        self.start_epoch = max(self.start_epoch, self._pos_epoch)
        self._log_line(
            f"resume: slot {name!r} -> epoch {self.start_epoch} "
            f"step {self._pos_step} (global step {self._global_step})")
