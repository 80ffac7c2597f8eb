"""CNN trainer — the port of ``distributed_model_parallel_tpu/train/
trainer.py`` with ``strategy="gspmd"``, ``"ddp"``, ``"fsdp"`` and
``"zero"`` over the data axis, and ``"spmd_pipeline"`` over a ``(data,
stage)`` mesh.

One step (:func:`make_train_step`): on-device augmentation (random crop
with pad 4, horizontal flip) → normalize → forward with BatchNorm in
training mode → cross-entropy → backward (autograd; convolutions and
BatchNorm through cuDNN on the card) → the gradient all-reduce when there
is a process group (``optim.GradReducer``) → the optimizer update in place
(``OptimizerConfig(fused=True)``: the fused SGD kernel, one launch per
flat bucket) → top-1/top-5 sums. Parameters and BN statistics live in
the model and update in place; the JAX step returns new ones instead.

Data parallelism (``MeshConfig(data=N)``, one process per rank, see
``mesh.py``): every rank draws the same global batch order and runs its
rows ``[r·B/N, (r+1)·B/N)``; metrics are the global batch's. Under
``gspmd`` the program is the global batch's, as XLA partitions it for the
JAX package: BatchNorm statistics span the global batch whatever
``bn_mode`` says (``"local"`` runs as ``"sync"``), and each step's
augmentation draws are the global batch's, of which a rank takes its
rows. Under ``ddp`` each rank has its own BN state (``"local"``) or
cross-replica statistics (``"sync"``) and its own draws, from ``(seed +
1, step, rank)`` (``parallel/ddp.py``). Parameters start equal on every
rank: built from ``config.seed``, then broadcast from rank 0.

FSDP (``strategy="fsdp"``, ``parallel/fsdp.py``) runs gspmd's program
with the parameters sharded: at rest each rank keeps its slice of every
sharded leaf and of its momentum (1/N of both); each use all-gathers the
leaf, its gradient is reduce-scattered back, and the SGD update runs on
the slices. The JAX package's refusals hold: ``fused`` (the fused kernel
runs over flat buckets of full parameters), ``grad_bucket_mb`` and
``consistency_every`` (no replicated state to compare).

ZeRO (``strategy="zero"``, the port's own: the JAX package runs ZeRO
through ``parallel/zero.make_zero_train_step`` only) is gspmd's program
with the momentum sharded: ``parallel/zero.ZeroSGD`` reduce-scatters the
flat gradient, updates this rank's slice (one fused SGD launch under
``fused``) and all-gathers the parameters back.

The pipeline (``strategy="spmd_pipeline"``, ``MeshConfig(stage=S)``, S ≥
2; ``parallel/spmd_cnn_pipeline.py``): each rank holds its stage's units
only (its ``virtual_stages`` chunks under interleaved 1F1B) and steps its
own optimizer; stage 0 of each data row loads that row's rows of the
batch, draws the global batch's augmentation and takes its rows; BN
normalizes by each data row's microbatch moments and the running
statistics are pooled; evaluation runs forward-only through the
pipeline. Metrics are the global batch's on every rank.

The input: the host assembles batches (``use_native``: the C++ row
gather) behind a ``prefetch``-deep host thread and a ``device_prefetch``-
deep upload on a side stream (``data/loader.input_stream``); when
``image_size`` differs from the data's, every batch is resized on the
device before augmentation (``data/loader.resize_batch``, the 224 px
finetune path), on every path.

:class:`Trainer` keeps the JAX trainer's loop shape: metrics stay device
tensors until a drain at ``max_inflight_steps`` or the log cadence (one
host read per drain), the timer attributes each drained window's wall
time to its steps, and the history records carry the same keys. The
device-resident path (``gspmd`` and ``fsdp``, as in the JAX package)
keeps the training set on the device as flat uint8 on every rank, gathers
each step's rows by index, and runs ``steps_per_dispatch`` steps per call
as a Python loop with no host sync inside. The augmentation draws of global
step s come from a generator derived from ``(seed + 1, s)``: stateless
like the JAX trainer's, but the port's own bits.

The reference's harness (``data_parallel.py:80-87,143-171``), as the JAX
trainer runs it: ``log_dir``/``log_name`` name the run's text and JSON
logs (``train/logging_util.RunLogger``, one line per epoch, character for
character the JAX logger's); whenever eval top-1 improves the whole state
is saved to the ``"ckpt"`` slot of a ``train/checkpoint.Checkpointer`` in
``checkpoint_dir``: parameters, BN statistics and momentum in the JAX
package's layout (gathered from the ranks' slices under ``zero`` and
``fsdp``; the per-replica BN statistics with a leading replica axis under
``ddp``), the optimizer's update count, ``best_acc``, the epoch and the
exact-continuation subtree (loader epoch and cursor, global step); under
``spmd_pipeline`` the writer (data row 0, stage 0) gathers every stage's
leaves and momentum over its stage ring first, and on resume every rank
reads the whole tree and keeps its own units.
``step_hook`` is called at every train-step boundary of both loops and
the preemption flag (``train/preemption.py``: SIGTERM/SIGINT or
``trainer.preemption.request()``) polled right after; a requested stop
saves to the ``"preempt"`` slot and ``fit`` returns. ``resume=True``
restores the newest valid of ``("ckpt", "preempt")`` and continues
mid-epoch, so a resumed run equals an uninterrupted one bit for bit (the
augmentation draws are stateless). With a process group rank 0 writes and
logs, the others wait at a barrier; every rank restores. Every rank polls
its own flag: a preemption must reach every rank (a cluster signals every
process; a ``step_hook`` requests on every rank at the same step).

Not ported yet, and refused by :func:`check_train_config` where a config
field asks for them (ROADMAP A6/A11): the other strategies and mesh
axes, recovery, fault injection, the guards, the consistency sentinel,
emergency checkpoints, elastic restarts (resharded restore), the typed
telemetry stream and the status exporter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.config import TrainConfig
from distributed_model_parallel_tpu_torch.data.loader import (
    BatchLoader,
    augment_batch,
    input_stream,
    normalize,
    resize_batch,
    resolve_input_size,
    step_generator,
    to_device,
)
from distributed_model_parallel_tpu_torch.data.registry import (
    ArrayDataset,
    load_dataset,
)
from distributed_model_parallel_tpu_torch.mesh import (
    MeshSpec,
    check_mesh_config,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.models import (
    DTYPES,
    get_model,
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.models.staged import (
    StagedModel,
    leaf_tree,
    load_leaves,
    model_leaves,
    tree_at,
)
from distributed_model_parallel_tpu_torch.ops.collectives import (
    all_gather_concat,
    all_reduce_,
    mesh_barrier,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    replicate,
)
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    Checkpointer,
    build_resume_tree,
    manifest_stamp,
    restore_newest,
    resume_position,
    resume_subtree,
)
from distributed_model_parallel_tpu_torch.train.logging_util import (
    RunLogger,
)
from distributed_model_parallel_tpu_torch.train.metrics import (
    AverageMeter,
    StepTimer,
    topk_correct,
)
from distributed_model_parallel_tpu_torch.train.optim import (
    GradReducer,
    make_optimizer,
)
from distributed_model_parallel_tpu_torch.train.preemption import (
    PreemptionGuard,
    checkpoint_on_preempt,
)

METRIC_KEYS = ("loss", "batch", "correct@1", "correct@5")

# TrainConfig fields the port does not run yet: (name, refused when, item).
_UNPORTED = (
    ("recovery.max_retries", lambda c: c.recovery.max_retries > 0,
     "A11: recovery"),
    ("recovery.faults", lambda c: bool(c.recovery.faults),
     "A11: fault injection"),
    ("check_finite_every", lambda c: c.check_finite_every != 0,
     "A11: guards"),
    ("stall_budget_s", lambda c: c.stall_budget_s is not None,
     "A11: guards"),
    ("consistency_every", lambda c: c.consistency_every != 0,
     "A11: consistency sentinel"),
    ("emergency_every", lambda c: c.emergency_every != 0,
     "A11: emergency checkpoints"),
    ("elastic", lambda c: c.elastic, "A11: elastic restarts"),
    ("statusz_port", lambda c: c.statusz_port is not None,
     "A11: status exporter"),
)
_STRATEGIES = {"auto": "A11: autotune"}
# Slots a resume considers, newest valid first.
RESUME_SLOTS = ("ckpt", "preempt")


def check_train_config(config: TrainConfig) -> None:
    """Raise, naming the ROADMAP item, for what the port does not run, and
    as the JAX trainer does for what it refuses."""
    if config.strategy in _STRATEGIES:
        raise ValueError(f"strategy={config.strategy!r} is not ported yet "
                         f"(ROADMAP {_STRATEGIES[config.strategy]}); the "
                         f"port runs 'gspmd', 'ddp', 'fsdp', 'zero' and "
                         f"'spmd_pipeline'")
    if config.strategy not in ("gspmd", "ddp", "fsdp", "zero",
                               "spmd_pipeline"):
        raise KeyError(f"unknown strategy {config.strategy!r}")
    if config.optimizer.fused and config.strategy == "fsdp":
        raise ValueError(
            "OptimizerConfig.fused runs the update over flat coalesced "
            "parameter buckets, which would gather the ZeRO-sharded "
            "params/opt state back to full size on every step; use it with "
            "replicated-param strategies (gspmd/ddp) — no silent ignores")
    if config.consistency_every and config.strategy == "fsdp":
        raise ValueError(
            "consistency_every needs state replicated over the data axis to "
            "compare; strategy='fsdp' shards params + optimizer state over "
            "it — no redundancy, no cross-replica check. No silent ignores")
    check_mesh_config(config.mesh)
    if config.strategy == "spmd_pipeline":
        check_spmd_pipeline_config(config)
    elif config.mesh.stage != 1:
        raise ValueError(f"MeshConfig(stage={config.mesh.stage}) is the "
                         f"pipeline's axis: strategy='spmd_pipeline' runs it "
                         f"(or train/pipeline_trainer.PipelineTrainer); "
                         f"{config.strategy!r} runs the data axis only")
    if config.strategy == "ddp":
        from distributed_model_parallel_tpu_torch.parallel.ddp import (
            resolve_allreduce,
        )

        resolve_allreduce(config.ddp_allreduce, config.ddp_bucket_bytes,
                          config.grad_bucket_mb)
        if config.device_resident_data:
            raise ValueError("device_resident_data is only supported with "
                             "strategy='gspmd' (the ddp path materializes "
                             "per-replica batches on host)")
    elif config.grad_bucket_mb is not None:
        raise ValueError(f"grad_bucket_mb sets the buckets of the per-replica "
                         f"gradient all-reduce (strategy='ddp'); "
                         f"strategy={config.strategy!r} reduces over the "
                         f"optimizer's buckets — no silent ignores")
    bad = [f"{name} (ROADMAP {item})" for name, refused, item in _UNPORTED
           if refused(config)]
    if bad:
        raise ValueError(f"not ported yet: {', '.join(bad)}")


def check_spmd_pipeline_config(config: TrainConfig) -> None:
    """The JAX trainer's refusals for ``strategy="spmd_pipeline"``, with
    its wording."""
    if config.device_resident_data:
        raise ValueError("device_resident_data is only supported with "
                         "strategy='gspmd'")
    if config.mesh.stage < 2:
        raise ValueError("strategy='spmd_pipeline' needs mesh.stage >= 2 "
                         "(use 'gspmd' for pure data parallelism)")
    if config.pipeline_schedule not in ("gpipe", "1f1b"):
        raise ValueError(
            f"strategy='spmd_pipeline' implements the gpipe and 1f1b "
            f"schedules, got {config.pipeline_schedule!r} (interleaved is a "
            f"single-controller PipelineRunner schedule — no silent "
            f"ignores)")
    if config.virtual_stages != 1 and config.pipeline_schedule != "1f1b":
        raise ValueError(
            "strategy='spmd_pipeline' supports interleaved virtual stages "
            "only under pipeline_schedule='1f1b' "
            "(spmd_cnn_pipeline.make_cnn_1f1b_fwd_bwd); gpipe's "
            "whole-program AD would gain nothing — no silent ignores")
    n_chunks = config.mesh.stage * config.virtual_stages
    b = config.stage_boundaries
    if b is not None and len(b) != n_chunks + 1:
        raise ValueError(
            f"stage_boundaries has {len(b)} cut points but the pipeline "
            f"splits into {n_chunks} chunks ({config.mesh.stage} stages x "
            f"{config.virtual_stages} virtual) — provide {n_chunks + 1}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, in f32."""
    return F.cross_entropy(logits.float(), labels.long())


def eval_now(epoch: int, total_epochs: int, eval_every: int) -> bool:
    """Eval cadence: every Nth epoch, and always the final one."""
    return ((epoch + 1) % max(1, eval_every) == 0
            or epoch == total_epochs - 1)


def _metrics(loss: torch.Tensor, logits: torch.Tensor,
             labels: torch.Tensor) -> dict:
    return {"loss": loss.detach(),
            "batch": logits.new_full((), float(labels.shape[0])),
            **topk_correct(logits.detach(), labels)}


def reduce_metrics(metrics: dict, spec: MeshSpec) -> dict:
    """A rank's metrics (0-d, or stacked over steps) → the global batch's:
    one all-reduce of them all; the loss is the mean of the ranks' means
    (``psum(loss) / N``), the batch and top-k counts are sums. Unchanged
    without a process group."""
    if spec.group is None:
        return metrics
    rows = torch.stack([metrics[k].float() for k in METRIC_KEYS], -1)
    all_reduce_(rows, spec.group, kind="metrics")
    rows[..., 0] /= spec.num_data
    return {k: rows[..., i] for i, k in enumerate(METRIC_KEYS)}


def make_train_step(model: StagedModel, optimizer, *, mean, std,
                    augment: bool = True, dtype=torch.float32,
                    ema_decay: float | None = None,
                    resize_to: int | None = None,
                    reducer: GradReducer | None = None,
                    rows: tuple[int, int] | None = None):
    """``step(images_u8, labels, generator=None) -> metrics``: resize to
    ``resize_to`` px (when set) → augment
    (draws from ``generator``) → normalize → forward (``train=True``) →
    loss → backward (``reducer`` averaging the gradients over the ranks)
    → ``optimizer.step()``; metrics are this rank's, 0-d device tensors
    (sums, like the JAX step's). ``rows = (start, total)``: the images are
    rows ``start ..`` of a global batch of ``total`` whose augmentation
    draws the generator gives. ``mean``/``std`` may be numpy; they are put
    on the model's device once, here."""
    if ema_decay is not None:
        raise ValueError("ema_decay is not ported yet (ROADMAP A4)")
    dev = next(model.parameters()).device
    mean = torch.as_tensor(mean, dtype=dtype, device=dev)
    std = torch.as_tensor(std, dtype=dtype, device=dev)

    def step(images_u8, labels, generator=None):
        if resize_to is not None:
            images_u8 = resize_batch(images_u8, resize_to)
        if augment:
            images_u8 = augment_batch(generator, images_u8, rows=rows)
        images = normalize(images_u8, mean, std, dtype)
        optimizer.zero_grad()
        logits, _ = model.apply(images, train=True)
        loss = cross_entropy(logits, labels)
        loss.backward()
        if reducer is not None:
            reducer.finish()
        optimizer.step()
        return _metrics(loss, logits, labels)

    return step


def make_multi_step(model: StagedModel, optimizer, *, image_shape, mean,
                    std, augment: bool = True, dtype=torch.float32,
                    seed: int = 1, reducer: GradReducer | None = None,
                    rows: tuple[int, int] | None = None,
                    resize_to: int | None = None):
    """K train steps per call over a device-resident dataset:
    ``multi(images_flat, labels_all, idx[K, B], first_step) -> metrics``
    stacked over K. Each step gathers its batch from the on-device
    dataset by index and takes the augmentation generator of its global
    step (``first_step + k``, from ``seed``); the per-step math is
    :func:`make_train_step`'s (``reducer``, ``rows``: this rank's share
    of a global batch; ``resize_to``). Nothing in the loop waits for the
    card."""
    step = make_train_step(model, optimizer, mean=mean, std=std,
                           augment=augment, dtype=dtype, reducer=reducer,
                           rows=rows, resize_to=resize_to)
    h, w, c = image_shape

    def multi(images_flat, labels_all, idx, first_step: int):
        out = []
        for k in range(idx.shape[0]):
            ib = idx[k]
            im = images_flat.index_select(0, ib).view(ib.shape[0], h, w, c)
            gen = (step_generator(seed, first_step + k, images_flat.device)
                   if augment else None)
            out.append(step(im, labels_all.index_select(0, ib), gen))
        return {k: torch.stack([m[k] for m in out]) for k in METRIC_KEYS}

    return multi


def make_eval_step(model: StagedModel, *, mean, std, dtype=torch.float32,
                   resize_to: int | None = None):
    """``step(images_u8, labels) -> metrics`` with BN running statistics
    and no gradient (resized to ``resize_to`` px first, when set)."""
    dev = next(model.parameters()).device
    mean = torch.as_tensor(mean, dtype=dtype, device=dev)
    std = torch.as_tensor(std, dtype=dtype, device=dev)

    @torch.no_grad()
    def step(images_u8, labels):
        if resize_to is not None:
            images_u8 = resize_batch(images_u8, resize_to)
        logits, _ = model.apply(normalize(images_u8, mean, std, dtype),
                                train=False)
        return _metrics(cross_entropy(logits, labels), logits, labels)

    return step


def momentum_tree(model: StagedModel, optimizers, group=None) -> tuple:
    """Every leaf's momentum in the JAX layout, from whichever of
    ``optimizers`` steps it (zeros before the first update or without
    momentum): ZeroSGD's slices gathered, an FSDP slice gathered along
    its shard dim over ``group``."""
    where = {}
    for opt in optimizers:
        full = (opt.full_momentum() if hasattr(opt, "full_momentum")
                else None)
        for i, p in enumerate(opt.params):
            where[id(p)] = (opt, i, full)

    def one(leaf):
        p = leaf.stored
        opt, i, full = where[id(p)]
        mom = full[i] if full is not None else opt.momentum_buffer(i)
        if mom is None:
            mom = torch.zeros_like(p, dtype=torch.float32)
        if leaf.shard_dim is not None:
            mom = all_gather_concat(mom, group, axis=leaf.shard_dim)
        return leaf.to_jax(mom)

    return leaf_tree(model, one)


@torch.no_grad()
def load_momentum(model: StagedModel, optimizers, tree) -> None:
    """Each optimizer's momentum := ``tree``'s (a JAX-layout tree over
    ``model``'s units), written into the existing traces (a fused
    bucket's slots in place); an optimizer that has made no update has
    no trace to write."""
    index = {}
    moms = {}
    for opt in optimizers:
        moms[id(opt)] = [None] * len(opt.params)
        for i, p in enumerate(opt.params):
            index[id(p)] = (opt, i)
    for leaf in model_leaves(model):
        opt, i = index[id(leaf.stored)]
        moms[id(opt)][i] = leaf.local(leaf.from_jax(tree_at(tree, leaf)))
    for opt in optimizers:
        if opt.count == 0:
            continue
        if hasattr(opt, "load_full_momentum"):
            opt.load_full_momentum(moms[id(opt)])
        else:
            for i, m in enumerate(moms[id(opt)]):
                opt.set_momentum_buffer(i, m)


@dataclasses.dataclass
class EpochResult:
    loss: float
    acc1: float
    acc5: float
    step_time: float
    data_time: float


class Trainer:
    """Epoch loop (the JAX ``Trainer`` with ``strategy="gspmd"``,
    ``"ddp"`` or ``"spmd_pipeline"``), one per rank.

    ``spec``: this rank's :class:`~..mesh.MeshSpec` (default:
    ``make_mesh(config.mesh, config.device)`` — the process group this
    process joined, or a lone process at ``data=1``). ``params``/``state``
    (optional, together): the JAX package's staged trees as numpy arrays
    (``params_from_jax``), e.g. another run's weights; under ``ddp``
    ``state`` carries the leading per-replica axis
    (``parallel.ddp.replicate_model_state``) and rank r takes slice r.
    Default: :func:`~..models.get_model`'s init from ``config.seed``.
    Under ``spmd_pipeline`` ``model`` is this rank's stage (``stage``)
    and ``params``/``state`` are the whole model's trees.
    ``step_log`` holds the per-window records the JAX trainer logs at
    ``log_every_n_steps``; every rank keeps the same global numbers."""

    def __init__(self, config: TrainConfig, *,
                 train_ds: ArrayDataset | None = None,
                 eval_ds: ArrayDataset | None = None,
                 params=None, state=None, spec: MeshSpec | None = None):
        check_train_config(config)
        self.config = config
        self.spec = spec = spec or make_mesh(config.mesh, config.device)
        if spec.config.data != config.mesh.data:
            raise ValueError(f"spec has data={spec.num_data}, the config "
                             f"data={config.mesh.data}")
        self.device = spec.device
        ddp = None
        fsdp = config.strategy == "fsdp"
        zero = config.strategy == "zero"
        if config.strategy == "ddp":
            from distributed_model_parallel_tpu_torch.parallel import ddp
        if train_ds is None or eval_ds is None:
            train_ds, eval_ds = load_dataset(config.data)
        self.train_ds, self.eval_ds = train_ds, eval_ds
        # The on-device resize when image_size differs from the data's
        # native resolution: every step upsamples the uint8 batch before
        # augmentation.
        resize_to, self._in_hw = resolve_input_size(train_ds.images.shape,
                                                    config.data.image_size)
        # gspmd normalizes over the global batch whatever bn_mode says; with
        # one rank and no process group the statistics are the local ones.
        pipe = config.strategy == "spmd_pipeline"
        bn = config.model.batchnorm
        if not ddp and not pipe and bn == "local":
            bn = "sync"
        if spec.group is None and bn == "sync":
            bn = "local"
        model_config = dataclasses.replace(config.model, batchnorm=bn)
        if (params is None) != (state is None):
            raise ValueError("pass params and state together")
        if pipe:
            self.stage = self._pipeline_stage(model_config, params, state)
            self.model = self.stage.model
        else:
            self.model = get_model(model_config, seed=config.seed,
                                   device=self.device, axis=spec.group)
            if params is not None:
                if ddp:
                    state = ddp.replica_state(state, spec.rank)
                params_from_jax(self.model, params, state, self.device)
        self.dtype = DTYPES[config.model.dtype]

        bs = config.data.batch_size
        self._rows = spec.rows(bs)
        eval_bs = min(config.data.eval_batch_size, len(eval_ds))
        # A pipeline's stages past 0 take no rows (stage 0 holds the data).
        loads = not pipe or spec.stage_index == 0
        host = dict(use_native=config.data.use_native,
                    num_workers=config.data.num_workers)
        self.train_loader = BatchLoader(
            train_ds, bs, shuffle=config.data.shuffle,
            seed=config.data.seed, rows=self._rows if loads else slice(0, 0),
            **host)
        self.eval_loader = BatchLoader(
            eval_ds, eval_bs, shuffle=False,
            rows=spec.rows(eval_bs) if loads else slice(0, 0), **host)
        if ddp:
            allreduce, bucket_bytes = ddp.resolve_allreduce(
                config.ddp_allreduce, config.ddp_bucket_bytes,
                config.grad_bucket_mb)
        if fsdp:
            # Rank 0's weights everywhere, then each rank keeps its slices;
            # the optimizer (and its momentum) sees only those.
            from distributed_model_parallel_tpu_torch.parallel import (
                fsdp as fsdp_mod,
            )

            if spec.group is not None:
                replicate(list(self.model.parameters())
                          + list(self.model.buffers()), spec)
            fsdp_mod.shard_model(self.model, spec)
        self.optimizer = make_optimizer(
            config.optimizer, len(self.train_loader), config.epochs,
            self.model.parameters(),
            bucket_bytes=bucket_bytes if ddp else None,
            zero=spec if zero else None)
        if fsdp:
            self.reducer = fsdp_mod.FsdpReducer(self.model, spec.group,
                                                self.optimizer.clip)
            self.optimizer.clip = None          # the reducer clips
        if (spec.group is not None and not fsdp
                and (not pipe or spec.num_data > 1)):
            # Rank 0's parameters everywhere (and its BN state, unless each
            # replica was given its own); a pipeline's, over each stage's
            # data rows.
            replicate(list(self.model.parameters()) + (
                [] if ddp and state is not None
                else list(self.model.buffers())), spec)
        kw = dict(mean=train_ds.mean, std=train_ds.std, dtype=self.dtype,
                  resize_to=resize_to)
        self._aug_seed = config.seed + 1
        self._multi_step = None
        if pipe:
            self._pipeline_steps(bs // spec.num_data,
                                 eval_bs // spec.num_data, kw)
        elif ddp:
            self._train_step = ddp.make_ddp_train_step(
                self.model, self.optimizer, spec,
                augment=config.data.augment, bucket_bytes=bucket_bytes,
                allreduce=allreduce, **kw)
            self.reducer = self._train_step.reducer
            self._eval_step = ddp.make_ddp_eval_step(self.model, spec, **kw)
        else:
            if not fsdp:
                # ZeroSGD reduce-scatters the gradients itself.
                self.reducer = (GradReducer(self.model.parameters(),
                                            spec.group, self.optimizer)
                                if spec.group is not None and not zero
                                else None)
            share = dict(reducer=self.reducer, rows=(self._rows.start, bs))
            step = make_train_step(self.model, self.optimizer,
                                   augment=config.data.augment, **share,
                                   **kw)
            self._train_step = lambda *a: reduce_metrics(step(*a), spec)
            ev = make_eval_step(self.model, **kw)
            self._eval_step = lambda *a: reduce_metrics(ev(*a), spec)
            if config.device_resident_data:
                if getattr(train_ds, "is_lazy", False):
                    raise ValueError(
                        "device_resident_data requires materialized pixels "
                        "but the dataset streams lazily from disk (auto "
                        "when decoded size exceeds the in-memory cap); set "
                        "DataConfig.lazy_decode=False to decode eagerly, "
                        "or drop device_resident_data")
                n = len(train_ds)
                self.dev_images = self._to_device(
                    train_ds.images.reshape(n, -1))
                self.dev_labels = self._to_device(train_ds.labels).long()
                self._multi_step = make_multi_step(
                    self.model, self.optimizer,
                    image_shape=train_ds.images.shape[1:],
                    augment=config.data.augment, seed=self._aug_seed,
                    **share, **kw)
        self._max_inflight = max(1, config.max_inflight_steps)
        self.global_step = 0
        self.best_acc = 0.0
        self.step_log: list[dict] = []
        self.start_epoch = 0
        # (epoch, batches consumed): the position a checkpoint records.
        self._loader_pos = (0, 0)
        # Called with this trainer at every train-step boundary, before
        # the preemption poll (an external scheduler may block in it, or
        # request a stop that the next boundary honours).
        self.step_hook = None
        self.preemption = PreemptionGuard()
        self._writer = spec.rank == 0
        self.logger = (RunLogger(config.log_dir, config.log_name, meta=dict(
            workload="cnn", model=config.model.name,
            strategy=config.strategy, batch_size=bs,
            mesh=config.mesh.axis_sizes(),
            steps_per_dispatch=config.steps_per_dispatch
            if config.device_resident_data else 1))
            if self._writer else None)
        self.ckpt = Checkpointer(
            config.checkpoint_dir, keep=config.recovery.keep_checkpoints,
            meta_fn=self._ckpt_meta)
        if config.resume and any(self.ckpt.exists(n) for n in RESUME_SLOTS):
            self._resume()

    # -------------------------------------------------------------- pipeline
    def _pipeline_stage(self, model_config, params, state):
        """This rank's stage: the full model built (or loaded) on the CPU,
        cut at ``stage_boundaries`` (or ``auto_partition``'s cost-balanced
        cut at the microbatch rows), its stage's units moved to the
        device."""
        from distributed_model_parallel_tpu_torch.parallel import (
            auto_partition,
            spmd_cnn_pipeline,
        )

        config, spec = self.config, self.spec
        full = get_model(model_config, seed=config.seed, device="cpu",
                         axis=spec.group)
        if params is not None:
            params_from_jax(full, params, state, "cpu")
        image_shape = (self._in_hw, self._in_hw,
                       self.train_ds.images.shape[3])
        boundaries = config.stage_boundaries
        if boundaries is None and config.auto_partition:
            micro = auto_partition.microbatch_rows(
                config.data.batch_size, config.num_microbatches,
                spec.num_data)
            boundaries = auto_partition.auto_boundaries(
                full, (micro, *image_shape),
                spec.num_stages * config.virtual_stages)
        self.boundaries = boundaries
        return spmd_cnn_pipeline.CnnPipelineStage(
            full, spec, sample_shape=image_shape, boundaries=boundaries,
            bn_momentum=config.model.bn_momentum,
            virtual_stages=config.virtual_stages)

    def _pipeline_steps(self, b_local: int, eval_local: int, kw) -> None:
        """The pipeline's train and eval steps; the stages past 0 run
        theirs with no data."""
        from distributed_model_parallel_tpu_torch.parallel import (
            spmd_cnn_pipeline as sp,
        )

        config, spec = self.config, self.spec
        self.reducer = (GradReducer(self.model.parameters(), spec.group,
                                    self.optimizer)
                        if spec.num_data > 1 else None)
        step = sp.make_spmd_cnn_train_step(
            self.stage, self.optimizer,
            num_microbatches=config.num_microbatches,
            augment=config.data.augment, schedule=config.pipeline_schedule,
            virtual_stages=config.virtual_stages, reducer=self.reducer, **kw)
        ev = sp.make_spmd_cnn_eval_step(self.stage, **kw)
        if self.stage.s == 0:
            self._train_step = step
            self._eval_step = ev
        else:
            self._train_step = lambda *_: step(b_local=b_local)
            self._eval_step = lambda *_: ev(b_local=eval_local)

    # ------------------------------------------------------------------ data
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device: pinned and asynchronous on the card,
        so the upload does not wait for the steps already queued."""
        return to_device([a], self.device)[0]

    def _input_stream(self, loader):
        """``loader``'s batches on the device, behind the host and device
        prefetch stages of ``config.data``."""
        return input_stream(loader, self.device, self.config.data.prefetch,
                            self.config.data.device_prefetch)

    def _generator(self):
        """This step's augmentation draws: the global batch's under gspmd,
        this rank's own under ddp."""
        if not self.config.data.augment:
            return None
        rank = self.spec.rank if self.config.strategy == "ddp" else None
        return step_generator(self._aug_seed, self.global_step, self.device,
                              rank)

    def _drain(self, pending: list, meters: dict) -> None:
        """Fold the queued device metrics into the meters: one host read
        for the whole window. Entries may stack K steps."""
        if not pending:
            return
        rows = torch.cat([
            torch.stack([m[k].float() for k in METRIC_KEYS], -1)
            .reshape(-1, len(METRIC_KEYS)) for m in pending]).cpu().numpy()
        pending.clear()
        loss, batch, c1, c5 = rows.astype(np.float64).T
        b_tot = float(batch.sum())
        if b_tot > 0:
            meters["loss"].update(float((loss * batch).sum()) / b_tot,
                                  int(b_tot))
            meters["acc1"].update(float(c1.sum()) / b_tot * 100, int(b_tot))
            meters["acc5"].update(float(c5.sum()) / b_tot * 100, int(b_tot))

    def _log_step(self, epoch: int, step: int, meters: dict,
                  timer: StepTimer) -> None:
        rec = dict(loss=meters["loss"].avg, acc1=meters["acc1"].avg,
                   step_time_s=timer.step.last, data_time_s=timer.data.last,
                   samples_per_s=self.config.data.batch_size
                   / max(timer.step.last, 1e-9))
        self.step_log.append(dict(epoch=epoch, step=step, **rec))
        if self.logger is not None:
            self.logger.log_step(epoch, step, **rec)

    def _log_line(self, message: str) -> None:
        if self.logger is not None:
            self.logger.log_line(message)

    def _stop_requested(self) -> bool:
        """The train-step boundary: ``step_hook``, then the preemption
        poll."""
        if self.step_hook is not None:
            self.step_hook(self)
        return self.preemption.requested()

    # ----------------------------------------------------------------- steps
    def run_steps(self, idx: torch.Tensor) -> dict:
        """``idx.shape[0]`` device-resident steps over the global batches
        of indices ``idx [K, B]`` (on the device; this rank runs its
        columns); returns their stacked global metrics, still on the
        device."""
        if self._multi_step is None:
            raise ValueError("run_steps needs device_resident_data=True")
        metrics = self._multi_step(self.dev_images, self.dev_labels,
                                   idx[:, self._rows], self.global_step)
        self.global_step += idx.shape[0]
        return reduce_metrics(metrics, self.spec)

    # ----------------------------------------------------------------- loops
    def train_epoch(self, epoch: int) -> EpochResult:
        if self._multi_step is not None:
            return self._train_epoch_device_resident(epoch)
        meters = {k: AverageMeter(k) for k in ("loss", "acc1", "acc5")}
        timer = StepTimer()
        pending: list = []
        self.train_loader.set_epoch(epoch)
        base = self.train_loader.cursor
        self._loader_pos = (epoch, base)
        for i, (images, labels) in enumerate(
                self._input_stream(self.train_loader)):
            if self._stop_requested():
                break
            gi = base + i
            timer.data_ready()
            pending.append(self._train_step(images, labels,
                                            self._generator()))
            self.global_step += 1
            self._loader_pos = (epoch, gi + 1)
            log_now = gi % self.config.log_every_n_steps == 0
            if log_now or len(pending) >= self._max_inflight:
                n = len(pending)
                self._drain(pending, meters)
                timer.window_done(n)
            if log_now:
                self._log_step(epoch, gi, meters, timer)
        n = len(pending)
        self._drain(pending, meters)
        timer.window_done(n)
        return EpochResult(meters["loss"].avg, meters["acc1"].avg,
                           meters["acc5"].avg, timer.step.avg,
                           timer.data.avg)

    def _train_epoch_device_resident(self, epoch: int) -> EpochResult:
        """Epoch over the on-device dataset, ``steps_per_dispatch`` steps
        per call; batch composition is the per-batch path's
        (``BatchLoader.epoch_indices``)."""
        meters = {k: AverageMeter(k) for k in ("loss", "acc1", "acc5")}
        timer = StepTimer()
        pending: list = []
        bs = self.train_loader.batch_size
        k_steps = max(1, self.config.steps_per_dispatch)
        self.train_loader.set_epoch(epoch)
        # A resumed cursor is dispatch-aligned when the saving run had
        # this steps_per_dispatch (saves happen at dispatch boundaries).
        base = self.train_loader.cursor
        self._loader_pos = (epoch, base)
        idx = self.train_loader.epoch_indices(epoch)
        steps = len(idx) // bs
        idx = self._to_device(idx[:steps * bs].reshape(steps, bs))
        inflight = 0
        for i in range(base, steps, k_steps):
            if self._stop_requested():
                break
            chunk = idx[i:i + k_steps]
            timer.data_ready()
            pending.append(self.run_steps(chunk))
            self._loader_pos = (epoch, i + chunk.shape[0])
            inflight += chunk.shape[0]
            # Log when a multiple of log_every_n_steps falls in [i, i+K).
            log_now = (-i) % self.config.log_every_n_steps < chunk.shape[0]
            if log_now or len(pending) >= self._max_inflight:
                self._drain(pending, meters)
                timer.window_done(inflight)
                inflight = 0
            if log_now:
                self._log_step(epoch, i, meters, timer)
        self._drain(pending, meters)
        timer.window_done(inflight)
        return EpochResult(meters["loss"].avg, meters["acc1"].avg,
                           meters["acc5"].avg, timer.step.avg,
                           timer.data.avg)

    def evaluate(self) -> EpochResult:
        meters = {k: AverageMeter(k) for k in ("loss", "acc1", "acc5")}
        timer = StepTimer()
        pending: list = []
        for images, labels in self._input_stream(self.eval_loader):
            timer.data_ready()
            pending.append(self._eval_step(images, labels))
            if len(pending) >= self._max_inflight:
                n = len(pending)
                self._drain(pending, meters)
                timer.window_done(n)
        n = len(pending)
        self._drain(pending, meters)
        timer.window_done(n)
        return EpochResult(meters["loss"].avg, meters["acc1"].avg,
                           meters["acc5"].avg, timer.step.avg,
                           timer.data.avg)

    def fit(self, epochs: int | None = None) -> list[dict]:
        """Train epochs ``start_epoch .. epochs - 1`` (default
        ``config.epochs``; ``start_epoch`` is 0, or where a resume or an
        earlier preempted ``fit`` left off) with eval at the
        ``eval_every`` cadence, one log line per epoch, and a save of the
        whole state to the ``"ckpt"`` slot whenever eval top-1 improves
        (reference ``data_parallel.py:143-171``); returns one history
        record per epoch run, with the JAX trainer's keys. SIGTERM/SIGINT
        or ``preemption.request()`` stops the epoch at the next step
        boundary, saves to the ``"preempt"`` slot (resume continues at
        that step) and returns the epochs completed."""
        epochs = epochs if epochs is not None else self.config.epochs
        history = []
        with self.preemption.installed():
            epoch = self.start_epoch
            while epoch < epochs:
                tr = self.train_epoch(epoch)
                if self.preemption.requested():
                    # Resume redoes the rest of this epoch: the saved
                    # position is the step the stop came at.
                    self.start_epoch = epoch
                    checkpoint_on_preempt(
                        self.preemption, self.ckpt if self._writer else None,
                        self._ckpt_tree(), "preempt", self.logger, epoch,
                        global_step=self.global_step)
                    self._barrier()
                    break
                ev = (self.evaluate()
                      if eval_now(epoch, epochs, self.config.eval_every)
                      else None)
                record = dict(
                    epoch=epoch, loss_train=tr.loss, acc1_train=tr.acc1,
                    loss_val=ev.loss if ev else None,
                    acc1_val=ev.acc1 if ev else None,
                    time_per_batch=tr.step_time,
                    time_load_per_batch=tr.data_time)
                if self.logger is not None:
                    self.logger.log_epoch(**record)
                history.append(record)
                if ev is not None and ev.acc1 > self.best_acc:
                    self.best_acc = ev.acc1
                    self._save(epoch)
                epoch += 1
        self.ckpt.wait_until_finished()
        if self.logger is not None:
            self.logger.finish(epochs_run=len(history))
        return history

    # -- checkpointing (reference data_parallel.py:80-87,143-155) ----------
    def _barrier(self) -> None:
        if self.spec.group is not None:
            mesh_barrier(self.spec)

    def _save(self, epoch: int) -> None:
        """The best-accuracy save: rank 0 writes, the others wait."""
        self.start_epoch = epoch + 1
        tree = self._ckpt_tree()
        if self._writer:
            self.ckpt.save(tree, "ckpt",
                           wait=not self.config.async_checkpoint)
        self._barrier()

    def _ckpt_meta(self) -> dict:
        return manifest_stamp("cnn", self.config.mesh,
                              self.config.mesh.num_devices, self.global_step,
                              model=self.config.model.name,
                              strategy=self.config.strategy)

    @torch.no_grad()
    def _ckpt_tree(self) -> dict:
        """The whole state as one tree of numpy arrays in the JAX
        package's layout, the same whatever the strategy and bucket plan
        (collectives under ddp/zero/fsdp: every rank calls; under
        spmd_pipeline data row 0's ranks gather the stages to the writer,
        and every other rank's tree holds its own stage only, which is
        never written)."""
        params, state = params_to_jax(self.model)
        if self.config.strategy == "ddp":
            from distributed_model_parallel_tpu_torch.parallel.ddp import (
                gather_replica_state,
            )

            state = gather_replica_state(self.model, self.spec)
        momentum = self._momentum_tree()
        count = self.optimizer.count
        if self.config.strategy == "spmd_pipeline":
            params, state, momentum, count = self._gather_stages(
                params, state, momentum, count)
        return {"params": params, "batch_stats": state,
                "momentum": momentum,
                "opt_count": np.asarray(count, np.int32),
                "best_acc": np.asarray(self.best_acc, np.float32),
                "epoch": np.asarray(self.start_epoch, np.int32),
                "resume": resume_subtree(self.train_loader, self._loader_pos,
                                         self.global_step)}

    def _gather_stages(self, params, state, momentum, count):
        """This stage's per-unit trees → the whole model's on the writer
        (data row 0, stage 0), gathered over row 0's stage ring; the other
        rows hold copies and send nothing, and every rank but the writer
        keeps its own parts. The stages' update counts must agree."""
        if self.spec.data_index != 0:
            return params, state, momentum, count
        import torch.distributed as dist

        mine = (self.stage.units, params, state, momentum, count)
        parts = [None] * self.spec.num_stages if self._writer else None
        dist.gather_object(mine, parts, dst=self.spec.stage_rank(0),
                           group=self.spec.stage_group)
        if not self._writer:
            return params, state, momentum, count
        n = sum(len(units) for units, *_ in parts)
        trees = [[None] * n for _ in range(3)]
        for units, *local, _ in parts:
            for tree, part in zip(trees, local):
                for g, unit_tree in zip(units, part):
                    tree[g] = unit_tree
        counts = {c for *_, c in parts}
        if len(counts) != 1:
            raise RuntimeError(f"the pipeline's stages disagree on the "
                               f"update count: {sorted(counts)}")
        return (*(tuple(t) for t in trees), counts.pop())

    def _pipeline_template(self) -> dict:
        """A checkpoint template of the whole pipelined model (shapes
        only, from the stage's meta copy of it, no collective): what
        every rank restores."""
        meta = self.stage._meta
        zeros = lambda leaf: np.broadcast_to(np.float32(0), leaf.jax_shape)
        params = leaf_tree(meta, zeros)
        return {"params": params,
                "batch_stats": leaf_tree(meta, zeros, state=True),
                "momentum": params, "opt_count": np.int32(0),
                "best_acc": np.float32(0), "epoch": np.int32(0),
                "resume": build_resume_tree(0, 0, 1, 0, {"retries_left": 0,
                                                         "lr_scale": 1.0})}

    def _momentum_tree(self) -> tuple:
        """Every leaf's momentum in the JAX layout (:func:`momentum_tree`
        over this trainer's optimizer)."""
        return momentum_tree(self.model, [self.optimizer], self.spec.group)

    @torch.no_grad()
    def _load_tree(self, tree: dict) -> None:
        """Adopt a restored checkpoint: weights, BN statistics, momentum
        (this rank's slice under zero/fsdp, its replica's statistics under
        ddp, its stage's units under spmd_pipeline) and the update count."""
        params, state = tree["params"], tree["batch_stats"]
        momentum = tree["momentum"]
        if self.config.strategy == "spmd_pipeline":
            params, state, momentum = (tuple(t[g] for g in self.stage.units)
                                       for t in (params, state, momentum))
        elif self.config.strategy == "ddp":
            from distributed_model_parallel_tpu_torch.parallel.ddp import (
                replica_state,
            )

            state = replica_state(state, self.spec.rank)
        load_leaves(self.model, params, state)
        self.optimizer.count = int(tree["opt_count"])
        load_momentum(self.model, [self.optimizer], momentum)

    def _resume(self) -> None:
        """Restore the newest valid of ``RESUME_SLOTS`` and continue where
        it was saved (every rank reads the file)."""
        template = (self._pipeline_template()
                    if self.config.strategy == "spmd_pipeline"
                    else self._ckpt_tree())
        name, restored = restore_newest(self.ckpt, template, RESUME_SLOTS,
                                        self._log_line)
        self._load_tree(restored)
        self.best_acc = float(restored["best_acc"])
        self.start_epoch, self.global_step = resume_position(
            name, restored, self.train_loader, self._log_line)
        self._loader_pos = (self.train_loader.epoch, self.train_loader.cursor)
