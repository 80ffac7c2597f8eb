"""The port's ZeRO step (``parallel/zero.py``) at 4 gloo ranks against the
JAX package's ``make_zero_train_step`` at ``MeshConfig(data=4)`` on
tests/test_zero.py's problem (a linear map, MSE, 16 rows): 3 steps per
case (SGD variants, and adamw and lars on the flat slice), losses (rel
1e-5) and parameters (rtol 1e-4, atol 1e-5: JAX's own bounds) after each
step, each rank's momentum (or adamw/lars state) slice == JAX's row r, the
fused path (the plain version of the kernel on the CPU) bitwise the
unfused one, and ``flatten_padded``/``unflatten_like`` == the JAX
package's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.ops import collectives as jcoll
from distributed_model_parallel_tpu.parallel import zero as jzero
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.ops import collectives as tcoll
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.parallel import zero as tzero

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N = 4
STEPS = 3
# case -> (optax chain, the port's OptimizerConfig kwargs)
CASES = {
    "momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                 dict(learning_rate=0.1, momentum=0.9, weight_decay=0.0)),
    "no_momentum": (lambda: optax.sgd(0.1),
                    dict(learning_rate=0.1, momentum=0.0, weight_decay=0.0)),
    "nesterov_wd": (lambda: optax.chain(
        optax.add_decayed_weights(1e-2),
        optax.sgd(0.05, momentum=0.9, nesterov=True)),
        dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-2,
             nesterov=True)),
    # Other optimizers run on the flat slice, as JAX's ZeRO runs any tx.
    "adamw": (lambda: optax.adamw(0.01, weight_decay=1e-2),
              dict(name="adamw", learning_rate=0.01, weight_decay=1e-2)),
    "lars": (lambda: optax.lars(0.1, weight_decay=1e-2, momentum=0.9),
             dict(name="lars", learning_rate=0.1, weight_decay=1e-2,
                  momentum=0.9)),
}
SGD_CASES = ("momentum", "no_momentum", "nesterov_wd")


def _problem():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(7, 3)).astype(np.float32),
              "b": np.zeros((3,), np.float32)}
    x = rng.normal(size=(16, 7)).astype(np.float32)
    y = rng.normal(size=(16, 3)).astype(np.float32)
    return params, x, y


def _jloss(p, batch):
    xx, yy = batch
    return jnp.mean((xx @ p["w"] + p["b"] - yy) ** 2)


@pytest.fixture(scope="module")
def jax_side():
    """Per case, the JAX ZeRO step's params and loss after each step and
    its momentum rows."""
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=N))
    params, x, y = _problem()
    out = {}
    for name, (tx, _) in CASES.items():
        init_fn, step = jzero.make_zero_train_step(_jloss, tx(), spec)
        p = jax.tree.map(jnp.asarray, params)
        opt = init_fn(p)
        hist = []
        for _ in range(STEPS):
            p, opt, loss = step(p, opt, (jnp.asarray(x), jnp.asarray(y)))
            hist.append(dict(params=jax.tree.map(np.asarray, p),
                             loss=float(loss)))
        traces = [np.asarray(t.trace) for t in jax.tree.leaves(
            opt, is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(t, optax.TraceState)]
        adam = [s for s in jax.tree.leaves(
            opt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        out[name] = dict(steps=hist, trace=traces[0] if traces else None,
                         adam=adam[0] if adam else None)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, x, y = _problem()
    cases = {}
    for name, (_, kw) in CASES.items():
        cases[name] = kw
        if name in SGD_CASES:
            cases[name + "_fused"] = dict(kw, fused=True)
    return tmesh.spawn(workers.zero_steps, N, params, x, y, cases, STEPS,
                       device="cpu", timeout_s=300, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


def test_flatten_round_trip_matches_jax():
    tree = {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "b": np.arange(5.0, dtype=np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    flat = tcoll.flatten_padded(tt, 8)
    want = jcoll.flatten_padded(jax.tree.map(jnp.asarray, tree), 8)
    assert flat.dtype == torch.float32 and flat.numel() % 8 == 0
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = tcoll.unflatten_like(flat, tt)
    for k in tree:
        assert back[k].dtype == tt[k].dtype
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
    ints = {"i": torch.arange(5, dtype=torch.int32)}
    back = tcoll.unflatten_like(tcoll.flatten_padded(ints, 4), ints)
    assert back["i"].dtype == torch.int32 and back["i"].tolist() == list(
        range(5))


@pytest.mark.parametrize("name", list(CASES))
def test_zero_matches_jax(jax_side, ranks, name):
    """After each of 3 steps: the mean loss over ranks and the gathered
    parameters on every rank == JAX's ZeRO step; every rank with the
    same bits."""
    want = jax_side[name]["steps"]
    for r in ranks:
        got = r[name]["steps"]
        for g, w in zip(got, want):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            for k in ("w", "b"):
                np.testing.assert_allclose(g["params"][k], w["params"][k],
                                           rtol=1e-4, atol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_array_equal(
                got[-1]["params"][k],
                ranks[0][name]["steps"][-1]["params"][k])
        assert r[name]["count"] == STEPS


def test_zero_matches_dense_sgd(ranks):
    """tests/test_zero.py's check: ZeRO with momentum == full-batch SGD
    with momentum on one device (optax), rtol 1e-4, atol 1e-5."""
    params, x, y = _problem()
    tx = optax.sgd(0.1, momentum=0.9)
    p = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p)
    for _ in range(STEPS):
        loss, g = jax.value_and_grad(_jloss)(p, (jnp.asarray(x),
                                                 jnp.asarray(y)))
        u, opt = tx.update(g, opt, p)
        p = optax.apply_updates(p, u)
    for r in ranks:
        last = r["momentum"]["steps"][-1]
        assert last["loss"] == pytest.approx(float(loss), rel=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(last["params"][k], np.asarray(p[k]),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["momentum", "nesterov_wd"])
def test_momentum_slice_is_jax_row(jax_side, ranks, name):
    """Rank r keeps only its 1/N slice of the momentum: JAX's row r of the
    padded flat trace (24 floats over 4 ranks: 6 each)."""
    trace = jax_side[name]["trace"]
    assert trace.shape == (N, 6)
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[name]["momentum"], trace[r],
                                   rtol=1e-4, atol=1e-5)
        assert rank[name]["momentum"].shape == (6,)
    assert all(rank["no_momentum"]["momentum"] is None for rank in ranks)


@pytest.mark.parametrize("name,state", [("adamw", "mu"), ("adamw", "nu"),
                                        ("lars", "trace")])
def test_optimizer_state_slice_is_jax_row(jax_side, ranks, name, state):
    """adamw's mu and nu and lars' trace live as rank r's slice of the
    flat state: JAX's row r (rtol 1e-5)."""
    want = (jax_side[name]["trace"] if state == "trace"
            else np.asarray(getattr(jax_side[name]["adam"], state)))
    assert want.shape == (N, 6)
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[name]["state"][state], want[r],
                                   rtol=1e-5, atol=1e-7)
        assert rank[name]["momentum"] is None


@pytest.mark.parametrize("name", SGD_CASES)
def test_fused_path_equals_unfused(ranks, name):
    """``fused=True`` (the kernel's plain version on the CPU) gives the
    unfused path's bits: same parameters, losses and momentum."""
    for r in ranks:
        a, b = r[name], r[name + "_fused"]
        for sa, sb in zip(a["steps"], b["steps"]):
            assert sa["loss"] == sb["loss"]
            for k in ("w", "b"):
                np.testing.assert_array_equal(sa["params"][k],
                                              sb["params"][k])
        if a["momentum"] is not None:
            np.testing.assert_array_equal(a["momentum"], b["momentum"])


def test_zero_refusals():
    spec = tmesh.make_mesh(device="cpu")
    for kw in (dict(name="adamw", fused=True), dict(grad_clip_norm=1.0),
               dict(accum_steps=2), dict(ema_decay=0.9)):
        with pytest.raises(ValueError):
            tzero.make_zero_train_step(workers.zero_linear_loss,
                                       tconfig.OptimizerConfig(**kw), spec)


def test_zero_at_one_rank_is_plain_sgd():
    """Without a process group the step is SGD on the whole flat vector."""
    params, x, y = _problem()
    spec = tmesh.make_mesh(device="cpu")
    init_fn, step = tzero.make_zero_train_step(
        workers.zero_linear_loss, tconfig.OptimizerConfig(
            learning_rate=0.1, momentum=0.9, weight_decay=0.0), spec)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    state = init_fn(p)
    assert state.momentum.numel() == 24
    p2, state, loss = step(p, state, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
    jp = jax.tree.map(jnp.asarray, params)
    jl, g = jax.value_and_grad(_jloss)(jp, (jnp.asarray(x), jnp.asarray(y)))
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(p2[k].numpy(),
                                   params[k] - 0.1 * np.asarray(g[k]),
                                   rtol=1e-5, atol=1e-6)
