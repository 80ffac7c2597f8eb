"""The port's explicit ring (``ops/ring_reduce.py``) at 4 gloo ranks
against the JAX package's ring in ``shard_map`` at ``MeshConfig(data=4)``
on the same inputs, mirroring tests/test_ring_reduce.py: ``ring_all_reduce``
at sizes the ranks do not divide, with ``mean`` and ndim;
``ring_reduce_scatter``'s chunk convention (rank i owns chunk i) and its
refusal; ``ring_psum_tree`` against ``bucketed_psum``'s mean; every rank
with the same bits; hops per call; and a tinycnn ddp ``fit`` with
``allreduce="ring"`` equal to ``"bucketed"`` (rel 1e-5), per-leaf and
over the fused SGD's buckets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.ops import ring_reduce as jring
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import load_dataset
from distributed_model_parallel_tpu_torch.parallel import ddp as tddp
from distributed_model_parallel_tpu_torch.parallel import workers
from tests._torch_port_util import run_dirs

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N = 4
DATA = dict(name="synthetic", batch_size=32, eval_batch_size=32,
            synthetic_train_size=96, synthetic_eval_size=32, augment=False)


def _inputs():
    rng = np.random.default_rng(0)
    xs = {str(k): np.arange(N * k, dtype=np.float32).reshape(N, k)
          for k in (37, 64, 1)}
    xs["mean"] = rng.normal(size=(N, 3, 5, 2)).astype(np.float32)
    xs["scatter"] = np.arange(N * 16, dtype=np.float32).reshape(N, 16)
    tree = {"w": rng.normal(size=(N, 4, 3)).astype(np.float32),
            "b": np.arange(N * 7, dtype=np.float32).reshape(N, 7),
            "s": np.full((N,), 2.5, np.float32)}
    return xs, tree


def _config(**kw):
    d = dict(model=tconfig.ModelConfig(name="tinycnn"),
             data=tconfig.DataConfig(**DATA),
             optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                               warmup_steps=2),
             mesh=tconfig.MeshConfig(data=N), epochs=1, device="cpu",
             strategy="ddp")
    d.update(kw)
    return tconfig.TrainConfig(**d)


@pytest.fixture(scope="module")
def jax_side():
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=N))
    xs, tree = _inputs()

    def smap(f, in_specs, out_specs):
        return jax.jit(jax.shard_map(f, mesh=spec.mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    out = {"all_reduce": {}}
    for name, x in xs.items():
        if name == "scatter":
            out["scatter"] = smap(lambda v: jring.ring_reduce_scatter(
                v.reshape(16), "data"), P("data"), P("data"))(x)
            out["psum_scatter"] = smap(lambda v: jax.lax.psum_scatter(
                v.reshape(16), "data", scatter_dimension=0, tiled=True),
                P("data"), P("data"))(x)
        else:
            out["all_reduce"][name] = smap(
                lambda v, m=name == "mean": jring.ring_all_reduce(
                    v[0], "data", mean=m)[None], P("data"), P("data"))(x)
    out["tree"] = smap(lambda t: jax.tree.map(
        lambda v: v[None], jring.ring_psum_tree(
            jax.tree.map(lambda v: v[0], t), "data")),
        (P("data"),), P("data"))(jax.tree.map(jnp.asarray, tree))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks: the ring collectives, then two ddp fits
    per transport (per-leaf SGD and the fused buckets)."""
    xs, tree = _inputs()
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    fused = tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=2,
                                    fused=True)
    runs = {f"{t}{'_fused' if f else ''}": dict(
        config=_config(ddp_allreduce=t, optimizer=fused) if f
        else _config(ddp_allreduce=t), params=None, state=None)
        for t in ("ring", "bucketed") for f in (False, True)}
    root = tmp_path_factory.mktemp("runs")
    for name, run in runs.items():
        run["config"] = run["config"].replace(**run_dirs(root, name))
    return tmesh.spawn(
        workers.several, N,
        [("ring_collectives", (xs, tree)),
         ("trainer_runs", (runs, (train.images, train.labels),
                           (evals.images, evals.labels)))],
        device="cpu", timeout_s=300, threads=1,
        store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("name", ["37", "64", "1", "mean"])
def test_ring_all_reduce_matches_jax(jax_side, ranks, name):
    """Sizes 37 and 1 pad to 4 chunks; ``mean`` divides by N; the 4-d
    input comes back in its shape. Each rank == JAX's ring (and the exact
    sum) within 1e-6, all ranks with the same bits."""
    xs, _ = _inputs()
    want = xs[name].sum(0) / (N if name == "mean" else 1)
    for r, (rc, _) in enumerate(ranks):
        got = rc["all_reduce"][name]
        np.testing.assert_allclose(got, jax_side["all_reduce"][name][r],
                                   rtol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, ranks[0][0]["all_reduce"][name])
        assert rc["hops"][name] == 2 * (N - 1)


def test_ring_reduce_scatter_chunk_convention(jax_side, ranks):
    """Rank i ends owning reduced chunk i, as psum_scatter(tiled=True) and
    the JAX ring give it; N - 1 hops."""
    for r, (rc, _) in enumerate(ranks):
        got = rc["reduce_scatter"]
        np.testing.assert_allclose(got, jax_side["scatter"][4 * r:4 * r + 4],
                                   rtol=1e-6)
        np.testing.assert_allclose(got,
                                   jax_side["psum_scatter"][4 * r:4 * r + 4],
                                   rtol=1e-6)
        assert rc["hops"]["scatter"] == N - 1


def test_ring_reduce_scatter_refuses_indivisible(ranks):
    for rc, _ in ranks:
        assert rc["refused"] == "leading dim 15 not divisible by 4"


def test_ring_psum_tree_matches_jax_and_psum_mean(jax_side, ranks):
    _, tree = _inputs()
    for r, (rc, _) in enumerate(ranks):
        for k, leaf in tree.items():
            got = rc["tree"][k]
            np.testing.assert_allclose(got, jax_side["tree"][k][r],
                                       rtol=1e-6)
            np.testing.assert_allclose(got, leaf.mean(0), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_array_equal(got, ranks[0][0]["tree"][k])


@pytest.mark.parametrize("fused", [False, True])
def test_ddp_ring_fit_matches_bucketed(ranks, fused):
    """One tinycnn ddp epoch at 4 ranks from the same seed: the ring's
    losses, accuracies and final parameters equal the bucketed
    all-reduce's (rel 1e-5; sums in another order), the replicas stay
    bitwise equal (checked on every rank by the worker)."""
    sfx = "_fused" if fused else ""
    for _, fits in ranks:
        ring, ref = fits["ring" + sfx], fits["bucketed" + sfx]
        for a, b in zip(ring["history"], ref["history"]):
            for k in ("loss_train", "loss_val"):
                assert a[k] == pytest.approx(b[k], rel=1e-5), k
            assert a["acc1_val"] == pytest.approx(b["acc1_val"])
        for ua, ub in zip(ring["params"], ref["params"]):
            for m in ua:
                for k in ua[m]:
                    np.testing.assert_allclose(ua[m][k], ub[m][k],
                                               rtol=1e-5, atol=1e-6)


def test_resolve_allreduce_takes_ring():
    assert tddp.resolve_allreduce("ring") == ("ring", None)
    assert tddp.resolve_allreduce("ring", grad_bucket_mb=1.0) == (
        "ring", 1 << 20)
    with pytest.raises(ValueError, match="A6"):
        tddp.resolve_allreduce("hierarchical")
