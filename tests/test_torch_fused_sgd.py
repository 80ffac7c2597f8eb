"""The port's fused SGD (``ops/fused_sgd.py``, ``train/optim.FusedSGD``)
against the JAX package's ``ops/pallas_optim.py`` on the same f32 inputs:
the plain version against ``_run_xla`` and against the Pallas kernel in
interpret mode (every variant), ``plan_buckets``, ``make_optimizer(fused=
True)`` against the JAX chain (warm-up, cosine, gradient clipping), the
f32-master cast-back path for bf16 leaves, and the bucket views (autograd
accumulates into them; a replaced gradient raises). Tolerances: f32
rounding (the schedule's lr is computed in double here and in f32 by
optax; the clip norm is summed per bucket here and per leaf there)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_model_parallel_tpu.config import OptimizerConfig as JOpt
from distributed_model_parallel_tpu.ops import pallas_optim as jpo
from distributed_model_parallel_tpu.ops.collectives import (
    plan_buckets as j_plan_buckets,
)
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu_torch.config import ModelConfig
from distributed_model_parallel_tpu_torch.config import OptimizerConfig as TOpt
from distributed_model_parallel_tpu_torch.models import get_model
from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
from distributed_model_parallel_tpu_torch.ops.collectives import (
    plan_buckets as t_plan_buckets,
)
from distributed_model_parallel_tpu_torch.train import optim as toptim

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# tests/test_pallas_optim.py's variants, plus nesterov without decay.
VARIANTS = [(0.9, 1e-4, False), (0.9, 1e-4, True), (0.9, 0.0, False),
            (0.0, 1e-4, False), (0.9, 0.0, True)]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"conv": {"w": rng.normal(size=(9, 7)).astype(np.float32),
                     "b": rng.normal(size=(13,)).astype(np.float32)},
            "head": rng.normal(size=(6, 5, 4)).astype(np.float32),
            "scale": rng.normal(size=(1,)).astype(np.float32)}


@pytest.mark.parametrize("ref", ["run_xla", "pallas_interpret"])
@pytest.mark.parametrize("momentum,wd,nesterov", VARIANTS)
def test_plain_version_matches_jax(momentum, wd, nesterov, ref):
    """4 updates of one flat bucket (1000 elements: not a multiple of the
    TPU's 128 lanes) through the wrapper on CPU tensors (the plain
    version) and through the JAX reference math or the Pallas kernel."""
    run = (jpo._run_xla if ref == "run_xla"
           else partial(jpo._run_kernel, interpret=True))
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=1000).astype(np.float32)
    jp, jm = jnp.asarray(p0), (jnp.zeros(1000) if momentum else None)
    tp = torch.from_numpy(p0.copy())
    tm = torch.zeros(1000) if momentum else None
    launches = (fs.fused_sgd_kernel.launches, fs.plain_sgd_kernel.launches)
    for k in range(4):
        g = rng.normal(size=1000).astype(np.float32)
        lr = float(np.float32(0.1 * (k + 1)))
        delta, jm = run(jnp.asarray(lr, jnp.float32), jp, jm, jnp.asarray(g),
                        momentum=momentum, weight_decay=wd,
                        nesterov=nesterov)
        jp = optax.apply_updates(jp, delta)
        if momentum:
            fs.fused_sgd_kernel(tp, tm, torch.from_numpy(g), lr, momentum, wd,
                                nesterov)
        else:
            fs.plain_sgd_kernel(tp, torch.from_numpy(g), lr, wd)
    # f32 rounding: XLA may contract a product and a sum into one FMA
    # (the tolerance of tests/test_pallas_optim.py's kernel check).
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    if momentum:
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-6)
    # CPU tensors take the plain version: nothing was launched.
    assert (fs.fused_sgd_kernel.launches,
            fs.plain_sgd_kernel.launches) == launches


@pytest.mark.parametrize("cap", [64 << 20, 25 << 20, 1 << 20, 4096, 256, 1])
def test_plan_buckets_matches_jax(cap):
    """The same leaf sizes (MobileNetV2's 173 leaves, then odd shapes)
    give the same buckets."""
    shapes = [tuple(p.shape) for p in get_model(
        ModelConfig(), device="cpu").parameters()] + [(3,), (1,), (7, 5)]
    jleaves = [np.zeros(s, np.float32) for s in shapes]
    tleaves = [torch.empty(s, device="meta") for s in shapes]
    assert t_plan_buckets(tleaves, cap) == j_plan_buckets(jleaves, cap)
    assert t_plan_buckets(jleaves, cap) == j_plan_buckets(jleaves, cap)


def _jax_chain_run(cfg: dict, grads: list, steps_per_epoch=5, epochs=2):
    tx = joptim.make_optimizer(JOpt(**cfg), steps_per_epoch, epochs)
    params = jax.tree.map(jnp.asarray, _tree())
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
    fused = [s for s in state if isinstance(s, jpo.FusedSGDState)][0]
    return params, fused.momentum


def _grads(n=10, scale=0.3):
    rng = np.random.default_rng(5)
    return [jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                         .astype(np.float32), _tree()) for _ in range(n)]


@pytest.mark.parametrize("momentum,nesterov,clip", [
    (0.9, False, None), (0.9, False, 1.0), (0.9, True, 1.0),
    (0.0, False, 1.0)])
def test_make_optimizer_fused_matches_jax_chain(momentum, nesterov, clip):
    """10 updates of ``make_optimizer(fused=True)`` (warm-up 3, cosine,
    optional clip by global norm) against the JAX chain, params and
    momentum."""
    cfg = dict(learning_rate=0.4, momentum=momentum, weight_decay=1e-4,
               nesterov=nesterov, warmup_steps=3, grad_clip_norm=clip,
               fused=True)
    grads = _grads()
    ref_params, ref_m = _jax_chain_run(cfg, grads)

    leaves = [torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in jax.tree.leaves(_tree())]
    opt = toptim.make_optimizer(TOpt(**cfg), 5, 2, leaves)
    assert isinstance(opt, toptim.FusedSGD) and len(opt.buckets) == 1
    for g in grads:
        opt.zero_grad()
        for p, a in zip(leaves, jax.tree.leaves(g)):
            p.grad.add_(torch.from_numpy(a))
        opt.step()
    assert opt.count == 10
    for i, (p, ref) in enumerate(zip(leaves, jax.tree.leaves(ref_params))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        if momentum:
            np.testing.assert_allclose(
                opt.momentum_buffer(i).numpy(),
                np.asarray(jax.tree.leaves(ref_m)[i]), rtol=1e-5, atol=1e-6)
        else:
            assert opt.momentum_buffer(i) is None and ref_m is None


def test_bf16_leaves_cast_back_on_cpu_match_jax():
    """Non-f32 leaves (CPU only): updated in f32, the delta cast back to
    the leaf type and added there, as the JAX f32-master path does."""
    grads = _grads(4)
    tx = jpo.fused_sgd(optax.cosine_decay_schedule(0.4, 10), momentum=0.9,
                       weight_decay=1e-4, use_pallas=False)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _tree())
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g), state,
            params)
        params = optax.apply_updates(params, updates)

    leaves = [torch.nn.Parameter(torch.from_numpy(a.copy()).bfloat16())
              for a in jax.tree.leaves(_tree())]
    sched = toptim.make_schedule(TOpt(learning_rate=0.4,
                                      cosine_decay_steps=10), 1, 1)
    opt = toptim.FusedSGD(leaves, TOpt(momentum=0.9, weight_decay=1e-4),
                          sched)
    assert not opt.flat
    for g in grads:
        opt.zero_grad()
        for p, a in zip(leaves, jax.tree.leaves(g)):
            p.grad = torch.from_numpy(a).bfloat16()
        opt.step()
    for p, ref in zip(leaves, jax.tree.leaves(params)):
        assert p.dtype == torch.bfloat16
        # one bf16 ulp (2^-8 relative): the lr is rounded in another place
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(ref, np.float32), rtol=8e-3,
                                   atol=1e-6)


def test_autograd_accumulates_into_bucket_views():
    """tinycnn's channels-last conv weights as bucket views: two backward
    passes leave every .grad in its slot, equal to plain autograd's."""
    cfg = ModelConfig(name="tinycnn", extra={"width": 4, "depth": 2})
    model, ref = (get_model(cfg, seed=3, device="cpu") for _ in range(2))
    opt = toptim.FusedSGD(model.parameters(), TOpt(fused=True),
                          lambda n: 0.1)
    slots = [p.grad.data_ptr() for p in model.parameters()]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, 8, 3)).astype(np.float32))
    for m in (model, ref):
        for _ in range(2):
            m(x, train=True).square().sum().backward()
    assert [p.grad.data_ptr() for p in model.parameters()] == slots
    for a, b in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
        assert a.stride() == b.stride()
    opt.step()                       # the views check passes


@pytest.mark.parametrize("how", ["replaced", "none", "rebound"])
def test_grad_view_check_raises(how):
    leaves = [torch.nn.Parameter(torch.ones(4, 3)),
              torch.nn.Parameter(torch.ones(5))]
    opt = toptim.FusedSGD(leaves, TOpt(fused=True), lambda n: 0.1)
    opt.step()
    if how == "replaced":
        leaves[1].grad = torch.zeros(5)
    elif how == "none":
        leaves[0].grad = None
    else:
        leaves[0].data = torch.ones(4, 3)
    with pytest.raises(RuntimeError, match="bucket slot"):
        opt.step()


def test_fused_with_another_optimizer_raises():
    with pytest.raises(ValueError, match="fused"):
        toptim.make_optimizer(TOpt(name="adamw", fused=True), 5, 1,
                              [torch.nn.Parameter(torch.zeros(2))])
