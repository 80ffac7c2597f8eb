"""The port's fused SGD (``ops/fused_sgd.py``, ``train/optim.FusedSGD``)
against the JAX package's ``ops/pallas_optim.py`` on the same f32 inputs:
the plain version against ``_run_xla`` and against the Pallas kernel in
interpret mode (every variant), ``plan_buckets``, ``make_optimizer(fused=
True)`` against the JAX chain (warm-up, cosine, gradient clipping), the
f32-master cast-back path for bf16 leaves, the bucket views (autograd
accumulates into them; a replaced gradient raises), the bucket checks
``BucketLauncher`` runs once at construction (on CPU buckets, without
launching), the wrappers on ragged and offset views, and chip_smoke.py's
phase-10 byte and bound arithmetic. Tolerances: f32
rounding (the schedule's lr is computed in double here and in f32 by
optax; the clip norm is summed per bucket here and per leaf there)."""

import importlib.util
from functools import partial
from pathlib import Path

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


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_bf16_leaves_stage_through_the_kernel_wrappers(monkeypatch,
                                                       momentum):
    """Non-f32 leaves take the kernel's path on the card: each bucket is
    staged into f32 (weight decay folded into the gradient) and handed to
    ``fused_sgd_kernel`` (``plain_sgd_kernel`` at momentum 0) with a
    zeroed delta buffer in the parameters' place, once a bucket a step;
    the delta, the momentum and the leaves equal the plain version
    (``sgd_delta_plain`` on the same staged values) bit for bit. On the
    CPU the wrappers run the plain version, so this pins the staging."""
    calls = []
    for name in ("fused_sgd_kernel", "plain_sgd_kernel"):
        real = getattr(fs, name)
        monkeypatch.setattr(fs, name, lambda *a, real=real, name=name, **k: (
            calls.append((name, a[0].abs().max().item())), real(*a, **k)))
    base = [torch.from_numpy(a.copy()).bfloat16()
            for a in jax.tree.leaves(_tree())]
    leaves = [torch.nn.Parameter(x.clone()) for x in base]
    cfg = TOpt(fused=True, momentum=momentum, weight_decay=1e-4)
    opt = toptim.FusedSGD(leaves, cfg, lambda n: 0.1, bucket_bytes=64)
    assert not opt.flat and len(opt.buckets) > 1
    moms = [None if m is None else torch.zeros_like(m) for m in opt._m]
    for g in _grads(3):
        grads = [torch.from_numpy(a).bfloat16() for a in jax.tree.leaves(g)]
        for p, x in zip(leaves, grads):
            p.grad = x
        calls.clear()
        opt.step()
        kernel = "fused_sgd_kernel" if momentum else "plain_sgd_kernel"
        # one call a bucket, each on a zeroed delta buffer
        assert calls == [(kernel, 0.0)] * len(opt.buckets)
        for b, bucket in enumerate(opt.buckets):
            p32 = torch.cat([base[i].float().reshape(-1) for i in bucket])
            g32 = torch.cat([grads[i].float().reshape(-1) for i in bucket])
            delta = fs.sgd_delta_plain(p32, moms[b], g32, 0.1, momentum,
                                       1e-4, False)
            assert torch.equal(delta, opt.last_deltas[b])
            if moms[b] is not None:
                assert torch.equal(moms[b], opt._m[b])
            off = 0
            for i in bucket:
                n = base[i].numel()
                base[i].add_(delta[off:off + n].view(base[i].shape)
                             .to(torch.bfloat16))
                off += n
        for p, x in zip(leaves, base):
            assert torch.equal(p.detach(), x)


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


def _cpu_bucket(n=40, momentum=True):
    """A FusedSGD's own flat buckets on the CPU (what it hands the
    launcher on the card)."""
    leaves = [torch.nn.Parameter(torch.ones(n // 2, 2))]
    opt = toptim.FusedSGD(leaves, TOpt(fused=True,
                                       momentum=0.9 if momentum else 0.0),
                          lambda n: 0.1)
    (p, m, g), = opt.flat_buckets()
    return opt, p, m, g


def _bad_bucket(case):
    _, p, m, g = _cpu_bucket()
    if case == "dtype":
        return (p, m, g.double()), TypeError, "float32"
    if case == "2d":
        return (p.view(20, 2), m.view(20, 2), g.view(20, 2)), ValueError, \
            "1-D"
    if case == "strided":
        wide = torch.zeros(80)
        return (p, m, wide[::2]), ValueError, "contiguous"
    if case == "lengths":
        return (p, m[:-4], g), ValueError, "one length"
    if case == "devices":
        return (p, m, torch.empty(40, device="meta")), ValueError, "device"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dtype", "2d", "strided", "lengths",
                                  "devices"])
def test_bucket_checks_raise_as_launch_did(case):
    """The checks the wrapper's launch ran on every call now run once in
    ``BucketLauncher`` (and still in the public wrappers): each bad
    bucket raises the same error, without launching anything."""
    (p, m, g), exc, match = _bad_bucket(case)
    with pytest.raises(exc, match=match):
        fs.check_bucket(p, m, g)
    with pytest.raises(exc, match=match):
        fs.BucketLauncher.check(p, m, g)
    with pytest.raises(exc, match=match):
        fs.BucketLauncher(p, m, g)


def test_launcher_check_takes_fused_sgd_buckets_but_not_the_cpu():
    """FusedSGD's own buffers pass every device-free check (type, shape,
    length, 16-byte alignment); on the CPU the launcher then refuses for
    want of a CUDA device, and an unaligned view is refused first."""
    for momentum in (True, False):
        opt, p, m, g = _cpu_bucket(momentum=momentum)
        assert (m is None) == (not momentum)
        fs.check_bucket(p, m, g)
        assert all(x.data_ptr() % 16 == 0 for x in (p, m, g)
                   if x is not None)
        with pytest.raises(ValueError, match="CUDA device"):
            fs.BucketLauncher.check(p, m, g)
    buf = torch.zeros(44)
    views = (buf[1:41], None, torch.zeros(40))          # p 4 bytes in
    fs.check_bucket(*views)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fs.BucketLauncher.check(*views)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_cpu_fused_sgd_step_takes_the_plain_version(momentum):
    """On the CPU, FusedSGD keeps no launcher and its step is the plain
    version on the bucket (nothing is launched)."""
    leaves = [torch.nn.Parameter(torch.arange(6.).view(2, 3)),
              torch.nn.Parameter(torch.ones(5))]
    cfg = TOpt(fused=True, momentum=momentum, weight_decay=1e-4)
    opt = toptim.FusedSGD(leaves, cfg, lambda n: 0.1)
    assert opt._launchers is None
    (p, m, g), = opt.flat_buckets()
    g.copy_(torch.linspace(-1, 1, g.numel()))
    rp, rm = p.clone(), None if m is None else m.clone()
    launches = (fs.fused_sgd_kernel.launches, fs.plain_sgd_kernel.launches)
    opt.step()
    fs.fused_sgd_plain(rp, rm, g, 0.1, momentum, 1e-4, False)
    assert torch.equal(p, rp) and (m is None or torch.equal(m, rm))
    assert (fs.fused_sgd_kernel.launches,
            fs.plain_sgd_kernel.launches) == launches


@pytest.mark.parametrize("n,offsets", [(1_003, (0, 0, 0)), (17, (1, 1, 1)),
                                       (101, (1, 2, 3))])
def test_wrappers_take_ragged_and_offset_views_on_cpu(n, offsets):
    """The views phase 9 gives the kernel on the card (a length that is
    not a multiple of 4, an unaligned head, differing offsets) are taken
    by the public wrappers; on the CPU they run the plain version in
    place."""
    rng = np.random.default_rng(3)
    bufs = [torch.from_numpy(rng.normal(size=n + 4).astype(np.float32))
            for _ in range(3)]
    p, m, g = (b[o:o + n] for b, o in zip(bufs, offsets))
    rp, rm = p.clone(), m.clone()
    fs.fused_sgd_kernel(p, m, g, 0.1, 0.9, 1e-4, True)
    fs.fused_sgd_plain(rp, rm, g, 0.1, 0.9, 1e-4, True)
    assert torch.equal(p, rp) and torch.equal(m, rm)
    rp = p.clone()
    fs.plain_sgd_kernel(p, g, 0.1, 1e-4)
    fs.fused_sgd_plain(rp, None, g, 0.1, 0.0, 1e-4, False)
    assert torch.equal(p, rp)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,variant,bytes_,bound_ms", [
    ("cnn", "momentum_wd", 45_938_440, 0.013713),
    ("cnn", "nesterov_wd", 45_938_440, 0.013713),
    ("cnn", "no_momentum", 27_563_064, 0.0082278),
    ("cap", "momentum_wd", 335_544_320, 0.10016),
    ("cap", "momentum_no_wd", 335_544_320, 0.10016),
    ("cap", "no_momentum", 201_326_592, 0.060097)])
def test_phase10_byte_and_bound_arithmetic(shape, variant, bytes_, bound_ms):
    """chip_smoke.py's phase-10 arithmetic: 20 B per parameter with a
    trace, 12 without, at 3.35 TB/s; bytes, not f32 operations, bound
    every variant. The CNN shape is MobileNetV2's bucket and the cap
    shape fills FUSED_BUCKET_BYTES."""
    cs = _chip_smoke()
    n = cs.SGD_TIMING_SHAPES[shape]["n"]
    t = cs.sgd_traffic(n, **cs.SGD_VARIANTS[variant])
    assert t["bytes"] == bytes_ and t["bound_by"] == "bytes"
    assert t["bound_ms"] == pytest.approx(bound_ms, rel=1e-4)
    assert cs.SGD_TIMING_SHAPES["cnn"]["n"] == sum(
        p.numel() for p in get_model(ModelConfig(), device="cpu").parameters())
    assert cs.SGD_TIMING_SHAPES["cap"]["n"] == toptim.FUSED_BUCKET_BYTES // 4
    # The R sets of one shape hold at least 3x the card's 50 MB L2.
    s = cs.SGD_TIMING_SHAPES[shape]
    assert s["sets"] * 12 * n >= 3 * 50e6 and s["launches"] % s["sets"] == 0


@pytest.mark.parametrize("index", [0, 1, 3])
def test_kernel_launches_on_its_buckets_card(monkeypatch, index):
    """The kernel launches on the current device, so a bucket on cuda:k
    (a pipeline chunk's) is launched with cuda:k made current and on
    cuda:k's stream, and the previous device is current again after."""
    current = [0]
    seen = {}

    class Guard:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    def stream(device):
        return type("S", (), {"cuda_stream": 100 + torch.device(device).index})

    def kernel(*args):
        seen.update(current=current[0], stream=args[-1])
        return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    fs._call(kernel, 16, 32, 48, 40, 0.1, 0.9, 1e-4, 0,
             torch.device("cuda", index))
    assert seen == {"current": index, "stream": 100 + index}
    assert current[0] == 0


def test_bucket_slots_start_on_16_byte_boundaries():
    """Every parameter and gradient slot of a flat bucket starts on a
    16-byte boundary, whatever the leaf sizes before it (a 10-float head
    bias first in reverse leaf order): cuDNN's f32 BatchNorm faults on a
    scale 8 bytes into its buffer (``misaligned address`` on the card).
    The gaps between slots stay zero through a step, and each slot still
    holds its parameter."""
    sizes = [(64,), (3, 3), (10,), (5, 7), (130,), (10,)]
    leaves = [torch.nn.Parameter(torch.randn(*s)) for s in sizes]
    want = [p.detach().clone() for p in leaves]
    opt = toptim.FusedSGD(leaves, TOpt(fused=True), lambda n: 0.1)
    (p, m, g), = opt.flat_buckets()
    for x, w in zip(leaves, want):
        assert x.data_ptr() % 16 == 0 and x.grad.data_ptr() % 16 == 0
        assert torch.equal(x.detach(), w)
    assert p.numel() == sum(-(-x.numel() // 4) * 4 for x in leaves)
    used = torch.zeros(p.numel(), dtype=torch.bool)
    for x in leaves:
        start = (x.data_ptr() - p.data_ptr()) // 4
        used[start:start + x.numel()] = True
    for x in leaves:
        x.grad.fill_(1.0)
    opt.step()
    assert not p[~used].any() and not m[~used].any()
