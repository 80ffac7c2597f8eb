"""The port's CNN slice against the JAX package on the same f32 weights
and inputs: SAME padding, ``ConvUnit`` (stride 1 and 2 on even sizes),
``InvertedResidual`` in both styles, the head, MobileNetV2 (eval and
train, with BN running statistics; the no-BN and ImageNet layouts), the
weight carrier, one full train step (loss, every gradient, the updated
parameters and BN statistics; fused and per-leaf SGD), and
``Trainer.fit`` histories of tinycnn. Tolerance 1e-4 relative to each
tensor's scale (f32 sums in another order through up to 19 units)."""

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.data import loader as jloader
from distributed_model_parallel_tpu.models import layers as jlayers
from distributed_model_parallel_tpu.models import mobilenetv2 as jmnv2
from distributed_model_parallel_tpu.models import staged as jstaged
from distributed_model_parallel_tpu.ops import pallas_optim as jpo
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.data.loader import normalize
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu_torch.models import (
    StagedModel,
    get_model,
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.models import layers as tlayers
from distributed_model_parallel_tpu_torch.models import mobilenetv2 as tmnv2
from distributed_model_parallel_tpu_torch.models import staged as tstaged
from distributed_model_parallel_tpu_torch.train import optim as toptim
from distributed_model_parallel_tpu_torch.train import train_cnn
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import cli_dirs, run_dirs
from tests.conftest import tiny_train_config

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

RTOL = 1e-4


def _close(got, want, what=""):
    """max|got - want| <= 1e-4 · max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= RTOL * scale, (what, err, scale)


def _close_trees(got, want, what=""):
    gl, gt = jax.tree.flatten_with_path(got)
    wl, wt = jax.tree.flatten_with_path(want)
    assert gt == wt, (what, gt, wt)
    for (path, g), (_, w) in zip(gl, wl):
        _close(g, w, f"{what}{jax.tree_util.keystr(path)}")


def _perturbed(model: StagedModel, seed: int):
    """The port model's init as JAX-layout numpy trees, with non-trivial
    BN scales, biases and running statistics (and conv biases), loaded
    back into ``model``."""
    params, state = params_to_jax(model)
    rng = np.random.default_rng(seed)

    def leaf(name, a):
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return a

    params = tuple({m: {k: leaf(k, v) for k, v in d.items()}
                    for m, d in u.items()} for u in params)
    state = tuple({m: {k: leaf(k, v) for k, v in d.items()}
                   for m, d in u.items()} for u in state)
    params_from_jax(model, params, state, "cpu")
    return params, state


def _both_apply(jmodel, tmodel, params, state, x, train):
    """(JAX (y, state), port (y, state)) as numpy trees."""
    jp, js = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    jy, jst = jax.jit(partial(jmodel.apply, train=train))(jp, js,
                                                          jnp.asarray(x))
    ty, _ = tmodel.apply(torch.from_numpy(x), train=train)
    return ((np.asarray(jy), jax.tree.map(np.asarray, jst)),
            (ty.detach().numpy(), params_to_jax(tmodel)[1]))


def _check_units(junits, tunits, x, train, seed=0):
    jm = jstaged.StagedModel(units=tuple(junits))
    tm = StagedModel(tunits)
    tm.reset_parameters(seed)
    params, state = _perturbed(tm, seed)
    (jy, jst), (ty, tst) = _both_apply(jm, tm, params, state, x, train)
    _close(ty, jy, "y")
    _close_trees(tst, jst, "state")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 1), (8, 3, 2), (16, 3, 2), (9, 3, 2), (32, 1, 1), (7, 1, 2),
    (2, 3, 2), (1, 3, 2)])
def test_same_padding_matches_xla(size, kernel, stride):
    assert tlayers.same_padding(size, kernel, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size,stride", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_conv_unit_matches_flax(size, stride, train):
    """Stride 2 on an even input pads (0, 1) as SAME does; a symmetric
    (1, 1) padding shifts every output pixel and fails here."""
    ops = ({"features": 8, "kernel": 3, "stride": stride},)
    _check_units([jlayers.ConvUnit(ops=ops)], [tlayers.ConvUnit(3, ops)],
                 _x((2, size, size, 3)), train)


@pytest.mark.parametrize("cin,exp,cout,stride,style", [
    (16, 6, 24, 1, "reference"),       # projected 1x1+BN shortcut
    (24, 6, 24, 1, "reference"),       # identity residual
    (24, 6, 32, 2, "reference"),       # stride 2, no residual
    (32, 1, 16, 1, "torchvision"),     # no expand conv, no residual
    (16, 6, 16, 1, "torchvision"),     # residual
])
def test_inverted_residual_matches_flax(cin, exp, cout, stride, style):
    _check_units(
        [jmnv2.InvertedResidual(expansion=exp, features=cout, stride=stride,
                                style=style)],
        [tmnv2.InvertedResidual(cin, exp, cout, stride, style=style)],
        _x((2, 8, 8, cin)), train=True)


@pytest.mark.parametrize("conv_features,cin,hw", [(32, 16, 2), (None, 8, 4)])
def test_head_matches_flax(conv_features, cin, hw):
    _check_units(
        [jlayers.ClassifierHead(num_classes=10, conv_features=conv_features)],
        [tlayers.ClassifierHead(cin, 10, conv_features=conv_features)],
        _x((4, hw, hw, cin)), train=True)


# name -> (JAX builder kwargs, port ModelConfig kwargs)
MNV2 = {
    "mobilenetv2": ({}, {}),
    "mobilenetv2_nobn": (dict(bn_mode="none"), dict(name="mobilenetv2_nobn")),
    "mobilenetv2_imagenet": (dict(input_layout="imagenet"),
                             dict(extra={"input_layout": "imagenet"})),
}


@pytest.mark.parametrize("name,train", [
    ("mobilenetv2", False), ("mobilenetv2", True),
    ("mobilenetv2_nobn", True), ("mobilenetv2_imagenet", False)])
def test_mobilenetv2_matches_jax(name, train):
    """Logits on 4 x 16 x 16 and the BN running statistics after a
    training forward: at the 2 x 2 late layers a batch of 4 gives n = 16,
    so torch's unbiased running variance (n/(n-1) = 1.07) would fail.
    The ImageNet layout runs eval only: at 16 px its late layers are
    1 x 1, and batch statistics over 4 values turn f32 rounding into
    differences of 1e-2 between any two f32 evaluations (JAX's own
    against float64 included)."""
    jkw, tkw = MNV2[name]
    jm = jmnv2.build_mobilenetv2(**jkw)
    tm = get_model(tconfig.ModelConfig(**tkw), device="cpu")
    assert tm.name == jm.name and tm.num_units == jm.num_units == 19
    params, state = _perturbed(tm, seed=1)
    (jy, jst), (ty, tst) = _both_apply(jm, tm, params, state,
                                       _x((4, 16, 16, 3)), train)
    _close(ty, jy, "logits")
    _close_trees(tst, jst, "state")


def test_params_from_jax_round_trip_and_errors():
    a = get_model(tconfig.ModelConfig(), seed=0, device="cpu")
    b = get_model(tconfig.ModelConfig(), seed=1, device="cpu")
    params, state = _perturbed(a, seed=2)
    params_from_jax(b, params, state, "cpu")
    for x, y in zip(list(a.parameters()) + list(a.buffers()),
                    list(b.parameters()) + list(b.buffers())):
        assert torch.equal(x, y) and x.stride() == y.stride()
    p2, s2 = params_to_jax(b)
    _close_trees(p2, params)
    _close_trees(s2, state)
    assert sum(v.size for v in jax.tree.leaves(params)) == 2_296_922
    assert len(jax.tree.leaves(params)) == 173

    swapped = list(params)
    swapped[1], swapped[2] = swapped[2], swapped[1]     # 16- vs 24-wide
    with pytest.raises(ValueError, match=r"unit 1 .*expand.kernel.*"
                                         r"expand.kernel"):
        params_from_jax(b, tuple(swapped), state, "cpu")
    renamed = list(params)
    renamed[0] = {"conv": params[0]["conv0"], "bn0": params[0]["bn0"]}
    with pytest.raises(ValueError, match="unit 0 .*conv0"):
        params_from_jax(b, tuple(renamed), state, "cpu")
    with pytest.raises(ValueError, match="units"):
        params_from_jax(b, params[:-1], state, "cpu")


def test_stage_helpers_and_apply_range_match_jax():
    """balanced_boundaries / stage_slices / partition_tree / merge_tree as
    the JAX package's; stage-by-stage ``apply_range`` (NHWC at the
    boundaries) composes to ``apply``."""
    for units, stages in ((19, 4), (19, 1), (7, 7), (5, 2)):
        assert (tstaged.balanced_boundaries(units, stages)
                == jstaged.balanced_boundaries(units, stages))
        assert (tstaged.stage_slices(units, stages)
                == jstaged.stage_slices(units, stages))
    cuts = [0, 4, 10, 16, 19]
    assert tstaged.stage_slices(19, 4, cuts) == jstaged.stage_slices(19, 4,
                                                                     cuts)
    for bad in ([0, 4, 19], [0, 10, 4, 16, 19]):
        for mod in (tstaged, jstaged):
            with pytest.raises(ValueError):
                mod.stage_slices(19, 4, bad)
    tree = tuple(range(19))
    parts = tstaged.partition_tree(tree, tstaged.stage_slices(19, 4))
    assert parts == jstaged.partition_tree(tree, jstaged.stage_slices(19, 4))
    assert tstaged.merge_tree(parts) == jstaged.merge_tree(parts) == tree

    model = get_model(tconfig.ModelConfig(name="tinycnn"), device="cpu")
    x = torch.from_numpy(_x((2, 8, 8, 3)))
    want, _ = model.apply(x, train=False)
    h = x
    for lo, hi in tstaged.stage_slices(model.num_units, 3):
        h, st = model.apply_range(h, lo, hi, train=False)
        assert len(st) == hi - lo
    torch.testing.assert_close(h, want, rtol=0, atol=0)
    y0, s0 = model.apply_unit(0, x, train=False)
    assert tuple(y0.shape) == (2, 8, 8, 16) and set(s0) == {"bn0"}


def _trace(opt_state):
    """The momentum trace of an optax SGD chain or of fused_sgd."""
    for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
            s, (optax.TraceState, jpo.FusedSGDState))):
        if isinstance(s, optax.TraceState):
            return s.trace
        if isinstance(s, jpo.FusedSGDState):
            return s.momentum
    raise AssertionError("no momentum trace")


# The train-step draw. The f32 gradients of a randomly initialized
# MobileNetV2 at batch 4 are ill-conditioned: ReLU masks flip between any
# two f32 evaluations of the same step, and for most weight draws JAX's
# own f32 gradients differ from float64 ones by 1e-3 to 6e-2 of the
# largest gradient (measured on the CPU over 40 draws). At this draw the
# JAX package's f32 gradients agree with float64 within 5e-5 of the
# largest, so the f32 step below holds the port to 2e-4 of it (4x the
# reference's own error), and the float64 test holds every gradient leaf
# to 1e-4.
STEP_SEED = 9


def _step_inputs():
    tm = get_model(tconfig.ModelConfig(), device="cpu")
    params, state = _perturbed(tm, seed=STEP_SEED)
    rng = np.random.default_rng(STEP_SEED + 1)
    images = rng.integers(0, 256, (4, 16, 16, 3), np.uint8)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    return tm, params, state, images, labels


@pytest.fixture(scope="module")
def jax_step():
    """One JAX ``make_train_step`` of MobileNetV2 (augment off; SGD lr 0.1,
    momentum 0.9, wd 1e-4; the optax chain, bitwise equal to the fused
    fallback per tests/test_pallas_optim.py): the new state, the metrics
    and the gradients, from the trace after one update from zero
    momentum (trace = g + wd·p)."""
    _, params, state, images, labels = _step_inputs()
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(learning_rate=0.1),
                               10, 1)
    jp, js = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    st = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                             model_state=js, opt_state=tx.init(jp))
    step = jax.jit(jtrainer.make_train_step(
        jmnv2.build_mobilenetv2(), tx, mean=CIFAR10_MEAN, std=CIFAR10_STD,
        augment=False))
    new, metrics = step(st, jax.random.key(0), jnp.asarray(images),
                        jnp.asarray(labels))
    wd = np.float32(1e-4)
    grads = jax.tree.map(lambda t, p: np.asarray(t) - wd * p,
                         _trace(new.opt_state), params)
    return jax.tree.map(np.asarray, (new.params, new.model_state)), \
        metrics, grads


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(jax_step, fused):
    """One MobileNetV2 step (augment off) from the same weights and batch,
    per-leaf SGD and the fused buckets: loss, top-k sums, every gradient
    leaf (2e-4 of the largest, see STEP_SEED), the updated parameters and
    the BN running statistics (1e-4)."""
    (jparams, jstate), jmet, jgrads = jax_step
    tm, _, _, images, labels = _step_inputs()
    optimizer = toptim.make_optimizer(
        tconfig.OptimizerConfig(learning_rate=0.1, fused=fused), 10, 1,
        tm.parameters())
    assert isinstance(optimizer, toptim.FusedSGD) == fused
    tstep = ttrainer.make_train_step(tm, optimizer, mean=CIFAR10_MEAN,
                                     std=CIFAR10_STD, augment=False)
    tmet = tstep(torch.from_numpy(images), torch.from_numpy(labels))

    _close(tmet["loss"].item(), float(jmet["loss"]), "loss")
    for k in ("batch", "correct@1", "correct@5"):
        assert float(tmet[k]) == float(jmet[k]), k
    tgrads, _ = params_to_jax(tm, grads=True)
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(jgrads))
    for (path, g), w in zip(jax.tree.flatten_with_path(tgrads)[0],
                            jax.tree.leaves(jgrads)):
        err = float(np.abs(g - w).max())
        assert err <= 2 * RTOL * gmax, (jax.tree_util.keystr(path), err)
    tparams, tstate = params_to_jax(tm)
    _close_trees(tparams, jparams, "params")
    _close_trees(tstate, jstate, "bn")


def test_gradients_match_jax_in_float64():
    """The same step's gradients with convolutions and BN computed in
    float64 in both packages (the head's Dense stays f32, as the JAX
    package fixes it): ReLU masks agree, and every gradient leaf is held
    to 1e-4."""
    _, params, state, images, labels = _step_inputs()
    tm = tmnv2.build_mobilenetv2(dtype=torch.float64)
    for m in tm.modules():
        if isinstance(m, (tlayers.Conv, tlayers.BatchNorm)):
            m.double()
    params_from_jax(tm, params, state, "cpu")
    logits, _ = tm.apply(normalize(torch.from_numpy(images), CIFAR10_MEAN,
                                   CIFAR10_STD), train=True)
    ttrainer.cross_entropy(logits, torch.from_numpy(labels)).backward()
    tgrads, _ = params_to_jax(tm, grads=True)

    with jax.enable_x64(True):
        jm = jmnv2.build_mobilenetv2(dtype=jnp.float64)
        xj = jloader.normalize(jnp.asarray(images), CIFAR10_MEAN,
                               CIFAR10_STD)

        def loss(p):
            y, _ = jm.apply(p, jax.tree.map(jnp.asarray, state), xj,
                            train=True)
            return jtrainer.cross_entropy(y, jnp.asarray(labels))

        jgrads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
        jgrads = jax.tree.map(np.asarray, jgrads)
    _close_trees(tgrads, jgrads, "grad")


DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX trainer's tinycnn run on a one-device mesh: its initial
    weights and its 2-epoch history."""
    cfg = tiny_train_config(tmp_path_factory.mktemp("jfit"),
                            mesh=jconfig.MeshConfig(data=1),
                            data=jconfig.DataConfig(**DATA), epochs=2)
    t = jtrainer.Trainer(cfg)
    params = jax.tree.map(np.asarray, t.state.params)
    state = jax.tree.map(np.asarray, t.state.model_state)
    return params, state, t.fit()


@pytest.mark.parametrize("fused,resident", [(False, False), (True, False),
                                            (True, True)])
def test_fit_matches_jax_trainer(jax_fit, fused, resident, tmp_path):
    """2 epochs of tinycnn through ``Trainer.fit`` from the JAX run's
    initial weights: train and eval loss and accuracy per epoch (the
    device-resident path has the per-batch path's batch order)."""
    params, state, want = jax_fit
    cfg = tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(**DATA),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2,
                                          fused=fused),
        epochs=2, log_every_n_steps=1000, device_resident_data=resident,
        steps_per_dispatch=2, device="cpu", **run_dirs(tmp_path))
    got = ttrainer.Trainer(cfg, params=params, state=state).fit()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss_train", "loss_val"):
            _close(g[k], w[k], k)
        for k in ("acc1_train", "acc1_val"):
            assert abs(g[k] - w[k]) < 1e-6, (k, g[k], w[k])
    assert got[-1]["loss_train"] < got[0]["loss_train"]


# Multi-GPU data parallelism (strategy="ddp", data > 1, grad_bucket_mb,
# sync BN), the pipeline (strategy="spmd_pipeline", the stage axis), the
# ring transport, FSDP and checkpoint/resume are ported
# (tests/test_torch_ddp*.py, tests/test_torch_*pipeline*.py,
# test_torch_ring_reduce.py, test_torch_fsdp.py, test_torch_resume.py);
# their entries here became what is still refused.
@pytest.mark.parametrize("bad", [
    dict(optimizer=tconfig.OptimizerConfig(name="adam")),
    dict(optimizer=tconfig.OptimizerConfig(accum_steps=2)),
    dict(stall_budget_s=1.0),
    dict(strategy="auto"),
    dict(mesh=tconfig.MeshConfig(data=2, dcn_data=2)),
    dict(optimizer=tconfig.OptimizerConfig(name="lamb")),
    dict(check_finite_every=1), dict(consistency_every=1),
    dict(emergency_every=5), dict(elastic=True), dict(statusz_port=0),
    dict(strategy="ddp", ddp_allreduce="hierarchical"),
    dict(recovery=tconfig.RecoveryConfig(max_retries=1)),
    dict(recovery=tconfig.RecoveryConfig(faults=("nan_loss@1",))),
    dict(mesh=tconfig.MeshConfig(stage=2, model=2)),
    dict(optimizer=tconfig.OptimizerConfig(name="lars")),
    dict(optimizer=tconfig.OptimizerConfig(name="adafactor")),
    dict(optimizer=tconfig.OptimizerConfig(ema_decay=0.999)),
])
def test_unported_trainer_options_raise(bad):
    cfg = tconfig.TrainConfig(model=tconfig.ModelConfig(name="tinycnn"),
                              data=tconfig.DataConfig(**DATA), device="cpu")
    with pytest.raises(ValueError, match="ROADMAP A"):
        ttrainer.Trainer(dataclasses.replace(cfg, **bad))


# ResNet and the zoo are ported (tests/test_torch_resnet.py,
# tests/test_torch_zoo*.py); what get_model refuses is the LM (built
# elsewhere) and names it does not know.
@pytest.mark.parametrize("name", ["vgg17", "densenet201", "transformer"])
def test_unported_models_raise(name):
    with pytest.raises((KeyError, ValueError)):
        get_model(tconfig.ModelConfig(name=name), device="cpu")


def test_cli_prints_one_record_per_epoch(capsys, tmp_path):
    train_cnn.main(["--device", "cpu", "--model", "tinycnn", "--epochs", "2",
                    "--batch-size", "16", "--synthetic-train-size", "48",
                    "--synthetic-eval-size", "16", "--fused",
                    "--device-data", "--steps-per-dispatch", "2",
                    *cli_dirs(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(x) for x in lines]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss_train"]) for r in records)
    with pytest.raises(SystemExit, match="ROADMAP A6"):
        train_cnn.main(["--device", "cpu", "--dcn-data", "2"])
