"""The port's adam, adamw, lamb, lars and adafactor (``train/adaptive.py``
through ``train/optim.make_optimizer``) and its gradient accumulation
(``optim.Accumulator``, fused and not) against the JAX package's
``make_optimizer`` (optax 0.2.6 and ``optax.MultiSteps``) on the same f32
inputs: the lr curve, then 10 updates of every parameter and every state
tensor. The tree holds a 128 x 160 leaf (adafactor factors it), a conv
kernel, 1-D leaves and a scalar. Tolerance: rtol 1e-6 (f32 rounding: the
schedule is computed in double here and in f32 by optax, and reductions
sum in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_model_parallel_tpu.config import OptimizerConfig as JOpt
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu_torch.config import OptimizerConfig as TOpt
from distributed_model_parallel_tpu_torch.train import adaptive
from distributed_model_parallel_tpu_torch.train import optim as toptim

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

RTOL = 1e-6
STEPS, SPE, EPOCHS = 10, 6, 3


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"big": f(128, 160), "conv": f(3, 3, 4, 8), "bias": f(7),
            "scale": f(1), "s": f(), "tiny": f(2, 3) * 1e-4}


def _grads(tree, n, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: np.asarray(rng.normal(size=np.shape(v)) * 0.5, np.float32)
             for k, v in tree.items()} for _ in range(n)]


KEYS = sorted(_tree())


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=RTOL * max(
                                   1e-30, float(np.abs(want).max())),
                               err_msg=what)


def _jax_run(cfg: JOpt, params, grads):
    tx = joptim.make_optimizer(cfg, SPE, EPOCHS)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    out = []
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)
        out.append((jax.tree.map(np.asarray, p), state))
    return out


def _port_run(cfg: TOpt, params, grads):
    leaves = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
              for k in KEYS]
    opt = toptim.make_optimizer(cfg, SPE, EPOCHS, leaves)
    out = []
    for g in grads:
        opt.zero_grad()
        for p, k in zip(leaves, KEYS):
            g_k = torch.from_numpy(np.array(g[k]))
            if p.grad is None:
                p.grad = g_k
            else:                       # a fused bucket's view
                p.grad.copy_(g_k)
        opt.step()
        state = {name: [None if t is None else t.detach().numpy().copy()
                        for t in ts] for name, ts in opt.leaf_state().items()}
        out.append(({k: p.detach().numpy().copy()
                     for k, p in zip(KEYS, leaves)}, state, opt.counters()))
    return out


def _find(state, cls):
    found = [s for s in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, cls)) if isinstance(s, cls)]
    assert len(found) == 1, (cls, found)
    return found[0]


def _optax_states(name, state):
    """The optax state tensors of the chain, by the port's names."""
    from optax._src import factorized

    if name in ("adam", "adamw", "lamb"):
        s = _find(state, optax.ScaleByAdamState)
        return {"mu": s.mu, "nu": s.nu}
    if name == "lars":
        return {"trace": _find(state, optax.TraceState).trace}
    s = _find(state, factorized.FactoredState)
    return {"v_row": s.v_row, "v_col": s.v_col, "v": s.v}


CASES = [
    dict(name="adam"), dict(name="adamw"), dict(name="lamb"),
    dict(name="lars"), dict(name="adafactor"),
    dict(name="lars", nesterov=True), dict(name="adamw", weight_decay=0.0),
    dict(name="lamb", weight_decay=0.0), dict(name="adafactor",
                                              weight_decay=0.0),
    dict(name="lars", weight_decay=0.0), dict(name="adam",
                                              grad_clip_norm=0.5),
    dict(name="lars", grad_clip_norm=0.5), dict(name="adafactor",
                                                grad_clip_norm=0.5),
]


def _cfg_kw(case):
    return {**dict(learning_rate=0.05, warmup_steps=3, weight_decay=1e-2),
            **case}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_optimizer_matches_optax(case):
    """10 updates: parameters and every state tensor, rtol 1e-6."""
    kw = _cfg_kw(case)
    params = _tree()
    grads = _grads(params, STEPS)
    want = _jax_run(JOpt(**kw), params, grads)
    got = _port_run(TOpt(**kw), params, grads)
    name = case["name"]
    for n, ((wp, ws), (gp, gs, counters)) in enumerate(zip(want, got)):
        for k in KEYS:
            _close(gp[k], wp[k], f"{name} step {n} param {k}")
        jstate = _optax_states(name, ws)
        for sname, leaves in gs.items():
            for i, k in enumerate(KEYS):
                if leaves[i] is None:
                    continue
                _close(leaves[i], np.asarray(jstate[sname][k]),
                       f"{name} step {n} {sname}[{k}]")
    assert counters["count"] == STEPS


def test_adafactor_factors_the_big_leaf_only():
    """min_dim_size_to_factor 128: the 128 x 160 leaf holds v_row/v_col,
    every other leaf a full v; a conv kernel factors by its JAX shape."""
    params = _tree()
    leaves = [torch.from_numpy(params[k]) for k in KEYS]
    tx = adaptive.make_transform(TOpt(name="adafactor"), leaves)
    big = KEYS.index("big")
    assert tx.state["v"][big] is None
    assert tuple(tx.state["v_row"][big].shape) == (128,)
    assert tuple(tx.state["v_col"][big].shape) == (160,)
    for i, k in enumerate(KEYS):
        if k != "big":
            assert tx.state["v_row"][i] is None
            assert tx.state["v"][i] is not None
    # A port conv kernel [O, I, kH, kW] = [256, 128, 3, 3] is JAX's
    # [3, 3, 128, 256]: rows reduce over O (JAX dim 3), columns over I.
    lay = adaptive.LeafLayout((256, 128, 3, 3), (2, 3, 1, 0))
    assert adaptive.factored_dims(lay) == (1, 0)


@pytest.mark.parametrize("name", ["sgd", "adamw", "lars"])
def test_lr_curve_matches_optax(name):
    """The learning rate of every update, with accumulation's update
    units, against the JAX schedule."""
    for accum in (1, 3):
        kw = dict(learning_rate=0.3, warmup_steps=5, cosine_decay_steps=14,
                  name=name, accum_steps=accum)
        jcfg = JOpt(**kw)
        accum_cfg = dataclasses.replace(
            jcfg, warmup_steps=jcfg.warmup_steps // accum,
            cosine_decay_steps=max(1, 14 // accum))
        ref = joptim.make_schedule(accum_cfg,
                                   max(1, SPE * EPOCHS // accum), 1)
        got = toptim.update_schedule(TOpt(**kw), SPE, EPOCHS)
        np.testing.assert_allclose([got(n) for n in range(20)],
                                   [float(ref(n)) for n in range(20)],
                                   atol=1e-7, rtol=0)


@pytest.mark.parametrize("accum", [2, 3])
@pytest.mark.parametrize("name,fused", [("sgd", False), ("sgd", True),
                                        ("adamw", False)])
def test_accumulation_matches_multisteps(name, fused, accum):
    """accum_steps k: the running mean, an update every k calls, the
    clip once on the mean, the schedule in update units — against
    optax.MultiSteps; also the accumulator and its counters."""
    kw = dict(learning_rate=0.1, warmup_steps=4, weight_decay=1e-3,
              grad_clip_norm=2.0, accum_steps=accum, name=name, fused=fused)
    params = _tree()
    grads = _grads(params, 3 * accum + 1)
    want = _jax_run(JOpt(**kw), params, grads)
    got = _port_run(TOpt(**kw), params, grads)
    for n, ((wp, ws), (gp, gs, counters)) in enumerate(zip(want, got)):
        for k in KEYS:
            _close(gp[k], wp[k], f"call {n} param {k}")
        ms = _find(ws, optax.MultiStepsState)
        assert counters["mini_step"] == int(ms.mini_step)
        assert counters["gradient_step"] == int(ms.gradient_step)
        for i, k in enumerate(KEYS):
            _close(gs["acc_grads"][i], np.asarray(ms.acc_grads[k]),
                   f"call {n} acc[{k}]")
    assert got[-1][2]["count"] == 3


def test_accumulation_fused_launches_once_per_update(monkeypatch):
    """Under fused, the kernel's wrapper runs at the boundaries only: one
    call a bucket per update, none between."""
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs

    seen = []
    real = fs.fused_sgd_kernel
    monkeypatch.setattr(fs, "fused_sgd_kernel",
                        lambda *a, **k: (seen.append(1), real(*a, **k)))
    params = _tree()
    leaves = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
              for k in KEYS]
    opt = toptim.make_optimizer(TOpt(fused=True, accum_steps=3), SPE, EPOCHS,
                                leaves, bucket_bytes=1 << 12)
    grads = _grads(params, 7)
    for g in grads:
        opt.zero_grad()
        for p, k in zip(leaves, KEYS):
            p.grad.copy_(torch.from_numpy(g[k]))
        opt.step()
    assert opt.count == 2
    assert len(seen) == 2 * len(opt.buckets) and len(opt.buckets) > 1


def test_refusals_in_jax_words():
    """fused with another optimizer, as the JAX package refuses it; an
    unknown name raises KeyError."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="fused implements the sgd recipe"):
        toptim.make_optimizer(TOpt(name="adamw", fused=True), 5, 1, p)
    with pytest.raises(KeyError, match="unknown optimizer"):
        toptim.make_optimizer(TOpt(name="rmsprop"), 5, 1, p)
