"""Rank functions for :func:`~..mesh.spawn`: each runs one piece of the
data-parallel or pipeline path on every rank from numpy inputs and
returns numpy results, which the caller holds against a reference (the tests hold
them against the JAX package on the same inputs). They live in the
package so that a spawned rank imports nothing but the port.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.config import (
    ModelConfig,
    OptimizerConfig,
)
from distributed_model_parallel_tpu_torch.data.registry import ArrayDataset
from distributed_model_parallel_tpu_torch.mesh import (
    MeshSpec,
    barrier_with_timeout,
)
from distributed_model_parallel_tpu_torch.models import (
    get_model,
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.ops import collectives as C
from distributed_model_parallel_tpu_torch.parallel import data_parallel as dp
from distributed_model_parallel_tpu_torch.parallel import ddp, fsdp
from distributed_model_parallel_tpu_torch.parallel import (
    spmd_cnn_pipeline as sp,
)
from distributed_model_parallel_tpu_torch.train.optim import (
    GradReducer,
    make_optimizer,
)
from distributed_model_parallel_tpu_torch.train.trainer import (
    Trainer,
    cross_entropy,
)


def _np(tree):
    return C.tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def _t(tree):
    return C.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def collectives(spec: MeshSpec, x: np.ndarray, tree: dict, caps: list,
                params, state, images: np.ndarray) -> dict:
    """The collectives and DataParallel's four phases on this rank:
    ``x [N·k, ...]`` (rank r's rows for psum_mean and all-gather; the whole
    of it, scaled by r + 1, for reduce-scatter), the ragged ``tree`` (its
    ``head`` in bf16) scaled by r + 1 through ``bucketed_psum`` at each cap
    (and the calls each made) and ``psum_mean``, the f32 accumulation of
    the bf16 leaf,
    sum mode, the barrier, scatter/replicate/gather, and tinycnn's eval
    forward (``params``, ``state``) through ``data_parallel_apply``."""
    r, rows = spec.rank, spec.rows(x.shape[0])
    xt = torch.from_numpy(x)
    base = _t(tree)
    base["head"] = base["head"].to(torch.bfloat16)
    scaled = C.tree_map(lambda t: t * torch.tensor(1.0 + r, dtype=t.dtype),
                        base)
    out = {"psum_mean": _np(C.psum_mean(xt[rows], spec.group)),
           "all_gather": _np(C.all_gather_concat(xt[rows], spec.group)),
           "reduce_scatter": _np(C.reduce_scatter_mean(xt * (1.0 + r),
                                                       spec.group)),
           "psum_tree": _np(C.psum_mean(scaled, spec.group)),
           "bucketed": {}, "calls": {}}
    for cap in caps:
        C.reset_counts()
        out["bucketed"][cap] = _np(C.bucketed_psum(scaled, spec.group,
                                                   bucket_bytes=cap))
        out["calls"][cap] = C.calls["bucketed_psum"]
    bf = {"g": base["head"] * torch.tensor(1.0 + r, dtype=torch.bfloat16)}
    out["accum_f32"] = _np(C.bucketed_psum(bf, spec.group,
                                           accum_dtype=torch.float32))
    out["sum_mode"] = _np(C.bucketed_psum({"x": torch.ones(5)}, spec.group,
                                          mean=False))
    out["barrier"] = barrier_with_timeout(lambda: C.mesh_barrier(spec), 60.0)

    batch = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    shard = dp.scatter(batch, spec)
    own = {"w": torch.full((4, 2), float(r))}
    out["scatter"] = _np(shard)
    out["gather"] = _np(dp.gather(shard, spec))
    out["replicate"] = _np(dp.replicate(own, spec))

    model = get_model(ModelConfig(name="tinycnn"), device="cpu")
    params_from_jax(model, params, state, "cpu")
    with torch.no_grad():
        model.units[0].conv0.weight.add_(float(r))     # replicate undoes it
        out["dp_apply"] = _np(dp.data_parallel_apply(
            lambda m, b: m.apply(b, train=False)[0], model,
            torch.from_numpy(images), spec))
    return out


def ddp_steps(spec: MeshSpec, cases: dict, params, state,
              images: np.ndarray, labels: np.ndarray, mean, std) -> dict:
    """One DDP step of tinycnn per case (augment off; SGD lr 0.1, no
    warm-up) from the same weights, on this rank's rows of the global
    batch. A case sets ``bn`` ("local"/"sync"), ``allreduce``,
    ``bucket_bytes``, ``fused`` and ``clip`` (grad_clip_norm). Returns per
    case the parameters, this rank's BN state, the step's and an eval
    step's metrics and the Reducer's collectives; raises (failing the
    rank) if the replicas' parameters or momentum differ."""
    rows = spec.rows(len(labels))
    im, lb = torch.from_numpy(images[rows]), torch.from_numpy(labels[rows])
    out = {}
    for name, c in cases.items():
        model = get_model(ModelConfig(name="tinycnn", batchnorm=c["bn"]),
                          device="cpu", axis=spec.group)
        params_from_jax(model, params, state, "cpu")
        opt = make_optimizer(
            OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                            fused=c.get("fused", False),
                            grad_clip_norm=c.get("clip")), 2, 2,
            model.parameters(), bucket_bytes=c.get("bucket_bytes"))
        step = ddp.make_ddp_train_step(
            model, opt, spec, mean=mean, std=std, augment=False,
            bucket_bytes=c.get("bucket_bytes"),
            allreduce=c.get("allreduce", "psum"))
        C.reset_counts()
        metrics = step(im, lb)
        calls = C.calls["reducer"]
        ddp.assert_ddp_replicated(model, opt, spec)
        ev = ddp.make_ddp_eval_step(model, spec, mean=mean, std=std)(im, lb)
        p, s = params_to_jax(model)
        out[name] = dict(params=p, state=s, calls=calls,
                         replica_state=ddp.gather_replica_state(model, spec),
                         metrics={k: float(v) for k, v in metrics.items()},
                         eval={k: float(v) for k, v in ev.items()})
    return out


def unused_param(spec: MeshSpec, x: np.ndarray) -> dict:
    """A Reducer over ``[used, unused]`` where only ``used`` is on the
    loss path (``sum(used · x_r)``, x_r = rank r's row of ``x``): the
    unused bucket is launched by ``finish`` instead of hanging. Returns
    the averaged gradients, the mask and the collectives, per mode."""
    out = {}
    for mode in ("psum", "bucketed"):
        used = torch.nn.Parameter(torch.ones(3))
        unused = torch.nn.Parameter(torch.ones(3))
        reducer = GradReducer([used, unused], spec.group,
                              allreduce=mode, bucket_bytes=24)
        C.reset_counts()
        (used * torch.from_numpy(x[spec.rank])).sum().backward()
        mask = C.unused_param_mask({"used": used.grad,
                                    "unused": unused.grad})
        barrier_with_timeout(reducer.finish, 60.0, what="reducer.finish")
        out[mode] = dict(used=_np(used.grad), unused=_np(unused.grad),
                         mask={k: bool(v) for k, v in mask.items()},
                         calls=C.calls["reducer"])
    return out


def trainer_runs(spec: MeshSpec, runs: dict, train: tuple,
                 evals: tuple) -> dict:
    """Per run ``{"config", "params", "state", "step"}``: a Trainer on this
    rank from the given weights over ``train``/``evals`` ((images, labels)
    numpy pairs), then either one train step on this rank's rows of
    ``step`` (images, labels; no augmentation draws) or ``fit()``.
    Returns the metrics or history, the step log, the parameters and
    every rank's BN state (leading replica axis)."""
    tr, ev = ArrayDataset(*train, 10), ArrayDataset(*evals, 10)
    out = {}
    for name, run in runs.items():
        t = Trainer(run["config"], train_ds=tr, eval_ds=ev,
                    params=run["params"], state=run["state"], spec=spec)
        res = {}
        if run.get("step") is not None:
            images, labels = run["step"]
            rows = spec.rows(len(labels))
            m = t._train_step(torch.from_numpy(images[rows]),
                              torch.from_numpy(labels[rows]), None)
            res["metrics"] = {k: float(v) for k, v in m.items()}
        else:
            res["history"] = t.fit()
            res["step_log"] = t.step_log
        if run["config"].strategy != "fsdp":
            ddp.assert_ddp_replicated(
                t.model, None if run["config"].strategy == "zero"
                else t.optimizer, spec)
        else:
            res["resident"] = fsdp.resident_bytes(t.model, t.optimizer)
            res["slices"] = fsdp.local_params_to_jax(t.model)
        with torch.no_grad():
            res["params"] = params_to_jax(t.model)[0]
        res["replica_state"] = ddp.gather_replica_state(t.model, spec)
        out[name] = res
    return out


def mobilenet_grads_f64(spec: MeshSpec, params, state, images: np.ndarray,
                        labels: np.ndarray, mean, std) -> tuple:
    """One MobileNetV2 step's gradients in float64 (the head's Dense in
    f32, as the JAX package fixes it) with BatchNorm statistics over the
    group, on this rank's rows, averaged by the Reducer: the gradient of
    the global batch's mean loss. Returns (gradients, new BN state) in
    the JAX layout."""
    from distributed_model_parallel_tpu_torch.data.loader import normalize
    from distributed_model_parallel_tpu_torch.models import layers
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        build_mobilenetv2,
    )

    model = build_mobilenetv2(dtype=torch.float64, bn_mode="sync",
                              axis=spec.group)
    for m in model.modules():
        if isinstance(m, (layers.Conv, layers.BatchNorm)):
            m.double()
    params_from_jax(model, params, state, "cpu")
    reducer = GradReducer(model.parameters(), spec.group)
    rows = spec.rows(len(labels))
    x = normalize(torch.from_numpy(images[rows]), mean, std)
    logits, _ = model.apply(x, train=True)
    cross_entropy(logits, torch.from_numpy(labels[rows])).backward()
    reducer.finish()
    return params_to_jax(model, grads=True)[0], params_to_jax(model)[1]


# -- the pipeline ----------------------------------------------------------------

def several(spec: MeshSpec, calls: list) -> list:
    """Several rank functions of this module in one spawn: ``calls`` are
    ``(name, args)`` pairs; their results, in order."""
    return [globals()[name](spec, *args) for name, args in calls]


def mesh_coords(spec: MeshSpec) -> dict:
    """This rank's ``(data, stage)`` coordinates and the global ranks of
    its two sub-groups."""
    import torch.distributed as dist

    return dict(rank=spec.rank, coords=spec.coords,
                data_group=dist.get_process_group_ranks(spec.group),
                stage_group=dist.get_process_group_ranks(spec.stage_group))


def ring_shifts(spec: MeshSpec, shifts: list) -> dict:
    """``ppermute_shift`` of a tensor holding this rank's number, around
    the stage ring and around the whole world, per shift; and one
    ``send_to``/``recv_from`` hop from stage 0 to the last stage."""
    me = torch.full((3,), float(spec.rank))
    out = {"stage": {k: float(C.ppermute_shift(me, k, spec.stage_group)[0])
                     for k in shifts},
           "world": {k: float(C.ppermute_shift(me, k)[0]) for k in shifts}}
    last = spec.stage_rank(spec.num_stages - 1)
    if spec.stage_index == 0:
        C.send_to(me * 10, last, spec.stage_group)
    elif spec.rank == last:
        out["hop"] = _np(C.recv_from(spec.stage_rank(0), (3,),
                                     torch.float32, "cpu", spec.stage_group))
    return out


def spmd_pipeline_steps(spec: MeshSpec, cases: dict, params, state,
                        images: np.ndarray, labels: np.ndarray, mean,
                        std) -> dict:
    """Per case, ``steps`` SPMD pipeline steps of tinycnn (augment off;
    SGD lr 0.1, momentum 0.9, wd 1e-4, no warm-up, the JAX tests'
    ``make_optimizer(..., 10, 10)`` schedule) from the given whole-model
    weights on this rank's stage, over the global batch, then one eval
    step. A case sets ``M``, ``schedule``, ``V`` (virtual stages),
    ``bn``, ``fused``, ``clip``, ``boundaries`` and ``steps``. Returns
    this rank's stage range and units, its parameters and BN state (JAX
    layout), momentum traces, the global metrics per step, the eval
    metrics and the hops counted."""
    rows = spec.rows(len(labels))
    im, lb = torch.from_numpy(images[rows]), torch.from_numpy(labels[rows])
    b_local = len(lb)
    out = {}
    for name, c in cases.items():
        model = get_model(ModelConfig(name="tinycnn",
                                      batchnorm=c.get("bn", "local")),
                          device="cpu", axis=spec.group)
        params_from_jax(model, params, state, "cpu")
        stage = sp.CnnPipelineStage(model, spec, sample_shape=images.shape,
                                    boundaries=c.get("boundaries"),
                                    virtual_stages=c.get("V", 1))
        opt = make_optimizer(
            OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                            fused=c.get("fused", False),
                            grad_clip_norm=c.get("clip")), 10, 10,
            stage.model.parameters())
        reducer = (GradReducer(stage.model.parameters(), spec.group, opt)
                   if spec.num_data > 1 else None)
        kw = dict(mean=mean, std=std)
        step = sp.make_spmd_cnn_train_step(
            stage, opt, num_microbatches=c.get("M", 1), augment=False,
            schedule=c.get("schedule", "gpipe"),
            virtual_stages=c.get("V", 1), reducer=reducer, **kw)
        ev = sp.make_spmd_cnn_eval_step(stage, **kw)
        C.reset_counts()
        metrics = []
        for _ in range(c.get("steps", 1)):
            m = (step(im, lb) if stage.s == 0 else step(b_local=b_local))
            metrics.append({k: float(v) for k, v in m.items()})
        calls, nbytes = dict(C.calls), dict(C.wire_bytes)
        e = ev(im, lb) if stage.s == 0 else ev(b_local=b_local)
        p, st = params_to_jax(stage.model)
        n = len(list(stage.model.parameters()))
        out[name] = dict(
            lo=stage.lo, hi=stage.hi, units=stage.units, params=p, state=st,
            momentum=[_np(opt.momentum_buffer(i)) for i in range(n)],
            metrics=metrics, eval={k: float(v) for k, v in e.items()},
            calls=calls, bytes=nbytes)
    return out


def spmd_trainer_fit(spec: MeshSpec, config, params, state, train: tuple,
                     evals: tuple) -> dict:
    """``Trainer(strategy="spmd_pipeline").fit()`` on this rank from the
    given whole-model weights over ``train``/``evals`` ((images, labels)
    numpy pairs): the history and this rank's stage parameters."""
    t = Trainer(config, train_ds=ArrayDataset(*train, 10),
                eval_ds=ArrayDataset(*evals, 10), params=params,
                state=state, spec=spec)
    history = t.fit()
    return dict(history=history, lo=t.stage.lo, hi=t.stage.hi,
                params=params_to_jax(t.model)[0])


def sharded_batches(spec: MeshSpec, images: np.ndarray, labels: np.ndarray,
                    batch_size: int) -> dict:
    """One epoch of ``BatchLoader(shard_by_process=True)`` on this rank:
    its data row's rows of every global batch."""
    from distributed_model_parallel_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(ArrayDataset(images, labels, 10), batch_size,
                         shard_by_process=True)
    batches = list(loader)
    return dict(rank=spec.rank, images=[b[0] for b in batches],
                labels=[b[1] for b in batches])


# -- the remaining data-parallel engines ------------------------------------

def ring_collectives(spec: MeshSpec, xs: dict, tree: dict) -> dict:
    """The explicit ring on this rank: ``ring_all_reduce`` of rank r's
    row of each ``xs`` entry (sum, and mean for ``"mean"``),
    ``ring_reduce_scatter`` of rank r's row of ``xs["scatter"]`` (and its
    refusal of a leading dim not divisible by the ranks), and
    ``ring_psum_tree`` of rank r's row of every leaf of ``tree``; the hops
    each made."""
    from distributed_model_parallel_tpu_torch.ops import ring_reduce as rr

    r = spec.rank
    out = {"all_reduce": {}, "hops": {}}
    for name, x in xs.items():
        row = torch.from_numpy(np.array(x[r]))
        C.reset_counts()
        if name == "scatter":
            out["reduce_scatter"] = _np(rr.ring_reduce_scatter(row.reshape(-1),
                                                               spec.group))
        else:
            out["all_reduce"][name] = _np(rr.ring_all_reduce(
                row, spec.group, mean=name == "mean"))
        out["hops"][name] = C.calls["ring_send"]
    try:
        rr.ring_reduce_scatter(torch.ones(15), spec.group)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["tree"] = _np(rr.ring_psum_tree(
        C.tree_map(lambda a: torch.from_numpy(np.array(a[r])), tree),
        spec.group))
    return out


def zero_linear_loss(params, batch):
    """tests/test_zero.py's problem: the mean squared error of a linear
    map."""
    x, y = batch
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def zero_steps(spec: MeshSpec, params: dict, x: np.ndarray, y: np.ndarray,
               cases: dict, steps: int) -> dict:
    """Per case (``OptimizerConfig`` kwargs), ``steps`` ZeRO steps of
    :func:`zero_linear_loss` from ``params`` on this rank's rows of
    ``(x, y)``: the parameters and loss after each step and this rank's
    momentum slice."""
    from distributed_model_parallel_tpu_torch.parallel import zero

    rows = spec.rows(len(x))
    batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    out = {}
    for name, kw in cases.items():
        init_fn, step_fn = zero.make_zero_train_step(
            zero_linear_loss, OptimizerConfig(**kw), spec)
        p = _t(params)
        state = init_fn(p)
        hist = []
        for _ in range(steps):
            p, state, loss = step_fn(p, state, batch)
            hist.append(dict(params=_np(p), loss=float(loss)))
        out[name] = dict(
            steps=hist, count=state.count,
            momentum=None if state.momentum is None
            else _np(state.momentum))
    return out


def sparse_bow_step(spec: MeshSpec, cfg, params: dict, tokens: np.ndarray,
                    labels: np.ndarray, lr: float) -> dict:
    """One sparse-gradient SGD step of the bag-of-words model on this
    rank's rows of the global batch, the COO pairs crossing by the sparse
    all-reduce; the new parameters and the loss."""
    from distributed_model_parallel_tpu_torch.models import embedding as bow

    rows = spec.rows(len(labels))
    step = bow.make_sparse_sgd_step(cfg, lr, group=spec.group)
    new, loss = step(bow.params_from_jax(params, "cpu"),
                     torch.from_numpy(tokens[rows]),
                     torch.from_numpy(labels[rows]))
    return dict(params=bow.params_to_jax(new), loss=float(loss))


def preempt_resume(spec: MeshSpec, configs: dict, train: tuple,
                   evals: tuple, preempt_at: int,
                   uninterrupted: tuple = ()) -> dict:
    """Per named config, run ``a``: ``Trainer(config).fit()``, and run
    ``b``: the same with a ``step_hook`` that requests preemption at
    global step ``preempt_at`` (on every rank), then a new
    ``Trainer(resume=True)`` that finishes the run; the configs named in
    ``uninterrupted`` run ``a`` only. Each run checkpoints to its own
    directory under ``config.checkpoint_dir``. Returns per config and run
    the history, parameters, momentum and every rank's BN state in the
    JAX layout (under ``spmd_pipeline`` this rank's units, their global
    indices in ``units``), the update count and the global step."""
    tr, ev = ArrayDataset(*train, 10), ArrayDataset(*evals, 10)

    def hook(t):
        if t.global_step == preempt_at:
            t.preemption.request()

    out = {}
    for name, config in configs.items():
        out[name] = {}
        for run in ("a",) if name in uninterrupted else ("a", "b"):
            cfg = config.replace(
                checkpoint_dir=f"{config.checkpoint_dir}/{run}",
                log_name=f"{config.log_name}_{run}")
            t = Trainer(cfg, train_ds=tr, eval_ds=ev, spec=spec)
            history = []
            if run == "b":
                t.step_hook = hook
                history += t.fit()
                t = Trainer(cfg.replace(resume=True), train_ds=tr,
                            eval_ds=ev, spec=spec)
            history += t.fit()
            pipe = cfg.strategy == "spmd_pipeline"
            with torch.no_grad():
                params, state = params_to_jax(t.model)
            out[name][run] = dict(
                history=history, params=params, momentum=t._momentum_tree(),
                state=state if pipe else ddp.gather_replica_state(t.model,
                                                                  spec),
                units=t.stage.units if pipe else None,
                count=t.optimizer.count, step=t.global_step)
    return out
