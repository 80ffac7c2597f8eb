"""The port's process group, collectives and DataParallel phases at 4
gloo ranks (``mesh.spawn``, a ``file://`` store under ``tmp_path``)
against the JAX package's at ``MeshConfig(data=4)`` on the same inputs:
``psum_mean``, all-gather, reduce-scatter, ``bucketed_psum`` ==
``psum_mean`` on a ragged mixed-dtype tree (collectives per call ==
``len(plan_buckets)``), f32 accumulation of bf16 leaves, sum mode, the
barrier, scatter/replicate/gather, ``data_parallel_apply`` == one device;
bucket plans, rank slices, the launcher's failure paths and each refusal
by name. Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.ops import collectives as jcoll
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.ops import collectives as tcoll
from distributed_model_parallel_tpu_torch.parallel import ddp as tddp
from distributed_model_parallel_tpu_torch.parallel import (
    spmd_cnn_pipeline as tsp,
)
from distributed_model_parallel_tpu_torch.parallel import workers

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N = 4
CAPS = [64, 150, 1 << 20]


def _ragged():
    """tests/test_collectives_buckets.py's tree: f32 matrices, an f32
    vector, a block that is bf16 on both sides, a one-element leaf."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"conv": {"w": f(9, 7), "b": f(13)}, "bn": f(1),
            "head": f(6, 5, 4), "bias": f(31)}


def _jtree(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["head"] = out["head"].astype(jnp.bfloat16)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results at data=4 on the same inputs."""
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=N))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    tree = _ragged()

    def smap(f, in_specs, out_specs):
        return jax.jit(jax.shard_map(f, mesh=spec.mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    def scaled(t):
        i = jax.lax.axis_index("data")
        return jax.tree.map(
            lambda v: v * (1.0 + i.astype(jnp.float32)).astype(v.dtype), t)

    out = {
        "psum_mean": smap(lambda t: jcoll.psum_mean(t, "data"),
                          (P("data"),), P())(x),
        "all_gather": smap(lambda t: jcoll.all_gather_concat(t, "data"),
                           (P("data"),), P())(x),
        "reduce_scatter": smap(lambda t: jcoll.reduce_scatter_mean(
            scaled(t), "data"), (P(),), P("data"))(x),
        "psum_tree": smap(lambda t: jcoll.psum_mean(scaled(t), "data"),
                          (P(),), P())(_jtree(tree)),
        "bucketed": {cap: smap(lambda t, c=cap: jcoll.bucketed_psum(
            scaled(t), "data", bucket_bytes=c), (P(),), P())(_jtree(tree))
            for cap in CAPS},
        "accum_f32": smap(lambda t: jcoll.bucketed_psum(
            scaled(t), "data", accum_dtype=jnp.float32), (P(),), P())(
            {"g": _jtree(tree)["head"]}),
        "sum_mode": smap(lambda t: jcoll.bucketed_psum(t, "data",
                                                       mean=False),
                         (P(),), P())({"x": jnp.ones((5,), jnp.float32)}),
    }
    model = jget_model(jconfig.ModelConfig(name="tinycnn"))
    images = (np.random.default_rng(1).integers(0, 255, (16, 32, 32, 3))
              .astype(np.float32) / 255.0)
    params, state = model.init(jax.random.key(0), jnp.asarray(images))
    out["single"] = model.apply(params, state, jnp.asarray(images),
                                train=False)[0]
    out = jax.tree.map(lambda a: np.asarray(a, np.float32), out)
    out["plans"] = {cap: jcoll.plan_buckets(_jtree(tree), cap)
                    for cap in CAPS}
    return dict(out=out, x=x, tree=tree, images=images,
                params=jax.tree.map(np.asarray, params),
                state=jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """workers.collectives on 4 gloo ranks."""
    j = jax_side
    return tmesh.spawn(workers.collectives, N, j["x"], j["tree"], CAPS,
                       j["params"], j["state"], j["images"], device="cpu",
                       timeout_s=300, threads=1,
                       store_dir=str(tmp_path_factory.mktemp("store")))


def test_psum_mean(jax_side, ranks):
    """Each rank's row of x, averaged: every rank equals JAX's psum_mean
    (f32, four values summed in another order: 1e-6)."""
    for r in ranks:
        np.testing.assert_allclose(r["psum_mean"],
                                   jax_side["out"]["psum_mean"],
                                   rtol=1e-6, atol=1e-6)


def test_all_gather_and_reduce_scatter(jax_side, ranks):
    """All-gather concatenates the ranks' rows in rank order (exact);
    reduce-scatter gives rank r slice r of the mean of x·(1 + r) (1e-6)."""
    want_rs = jax_side["out"]["reduce_scatter"]
    k = want_rs.shape[0] // N
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["all_gather"], jax_side["x"])
        np.testing.assert_array_equal(r["all_gather"],
                                      jax_side["out"]["all_gather"])
        np.testing.assert_allclose(r["reduce_scatter"],
                                   want_rs[i * k:(i + 1) * k],
                                   rtol=1e-6, atol=1e-6)


def _leaves(tree):
    return tcoll.tree_flatten(tree)[0]


@pytest.mark.parametrize("cap", CAPS)
def test_bucketed_psum_matches_psum_mean_and_jax(jax_side, ranks, cap):
    """bucketed_psum of the ragged tree scaled by r + 1 == the per-leaf
    psum_mean and == JAX's bucketed_psum at the same cap, leaf for leaf
    (sorted-key order). f32 leaves 1e-6; the bf16 leaf 1e-2, as the JAX
    package's own test holds it (in a mixed bucket it reduces in f32, on
    its own in bf16)."""
    want = _leaves(jax_side["out"]["bucketed"][cap])
    for r in ranks:
        got = _leaves(r["bucketed"][cap])
        per_leaf = _leaves(r["psum_tree"])
        for name, g, w, p in zip(["bias", "bn", "conv.b", "conv.w", "head"],
                                 got, want, per_leaf):
            tol = 1e-2 if name == "head" else 1e-6
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=name)
            np.testing.assert_allclose(g, p, rtol=tol, atol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("cap", CAPS)
def test_collectives_per_call_equal_buckets(jax_side, ranks, cap):
    """One collective per bucket, and the port's plan is the JAX
    package's on the same tree."""
    tree = {k: v for k, v in jax_side["tree"].items()}
    ttree = tcoll.tree_map(torch.from_numpy, tree)
    ttree["head"] = ttree["head"].to(torch.bfloat16)
    plan = tcoll.plan_buckets(ttree, cap)
    assert plan == jax_side["out"]["plans"][cap]
    for r in ranks:
        assert r["calls"][cap] == len(plan)


def test_bucketed_psum_accum_dtype_f32(jax_side, ranks):
    """accum_dtype=f32 on a bf16 leaf: reduced and averaged in f32, cast
    back to bf16; against JAX's and against the f32 reference (the bf16
    leaf times the mean of 1..4, rounded once). XLA may keep the product
    x·(1 + r) in f32 where torch rounds it to bf16, so single elements
    differ by one bf16 ulp (2^-8 relative): 1e-2, as the JAX package's
    own test."""
    head = jax_side["tree"]["head"]
    ref = np.asarray(jnp.asarray(head, jnp.bfloat16).astype(jnp.float32)
                     * 2.5).astype(np.float32)
    for r in ranks:
        got = r["accum_f32"]["g"]
        np.testing.assert_allclose(got, jax_side["out"]["accum_f32"]["g"],
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)


def test_bucketed_psum_sum_mode(jax_side, ranks):
    """mean=False sums like a raw psum: 4 ranks of ones give 4."""
    for r in ranks:
        np.testing.assert_array_equal(r["sum_mode"]["x"],
                                      jax_side["out"]["sum_mode"]["x"])
        np.testing.assert_array_equal(r["sum_mode"]["x"], np.full(5, 4.0))


def test_mesh_barrier_returns_world(ranks):
    assert [r["barrier"] for r in ranks] == [4.0] * N


def test_scatter_replicate_gather_roundtrip(ranks):
    """scatter gives rank r rows [4r, 4r + 4) of the batch, gather puts
    the whole batch back in rank order, replicate gives every rank rank
    0's tree (exact)."""
    batch = np.arange(64, dtype=np.float32).reshape(16, 4)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["scatter"], batch[4 * i:4 * i + 4])
        np.testing.assert_array_equal(r["gather"], batch)
        np.testing.assert_array_equal(r["replicate"]["w"], np.zeros((4, 2)))


def test_data_parallel_apply_matches_jax_single_device(jax_side, ranks):
    """tinycnn's eval forward through data_parallel_apply on 4 ranks
    (each rank's own weights perturbed: replicate restores rank 0's) ==
    the JAX model on one device, 1e-4 of the logits' scale (f32 convs in
    another order, as tests/test_torch_cnn.py holds them)."""
    want = jax_side["out"]["single"]
    scale = max(1.0, float(np.abs(want).max()))
    for r in ranks:
        assert r["dp_apply"].shape == want.shape
        assert float(np.abs(r["dp_apply"] - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("cap", [64, 150, 200, 1 << 30])
def test_plan_buckets_matches_jax(cap):
    """Bucket plans of the ragged tree (reverse leaf order, the cap, a
    leaf over the cap alone) equal the JAX package's."""
    tree = _ragged()
    ttree = tcoll.tree_map(torch.from_numpy, tree)
    ttree["head"] = ttree["head"].to(torch.bfloat16)
    assert tcoll.plan_buckets(ttree, cap) == jcoll.plan_buckets(
        _jtree(tree), cap)
    big = {"big": np.zeros((64, 64), np.float32),
           "s1": np.zeros(4, np.float32), "s2": np.zeros(4, np.float32)}
    assert tcoll.plan_buckets(big, 64) == jcoll.plan_buckets(
        jax.tree.map(jnp.asarray, big), 64)


def test_unused_param_mask():
    """A gradient never produced or exactly zero is flagged, as
    ``jax.grad`` gives zeros for a leaf off the loss path."""
    used = torch.nn.Parameter(torch.ones(3))
    unused = torch.nn.Parameter(torch.ones(3))
    (used * torch.arange(3.0)).sum().backward()
    mask = tcoll.unused_param_mask({"used": used.grad,
                                    "unused": unused.grad,
                                    "zero": torch.zeros(2)})
    assert not bool(mask["used"])
    assert bool(mask["unused"]) and bool(mask["zero"])

    def loss(p, x):
        return jnp.sum(p["used"] * x)

    jmask = jcoll.unused_param_mask(jax.grad(loss)(
        {"used": jnp.ones(3), "unused": jnp.ones(3)}, jnp.arange(3.0)))
    assert {k: bool(v) for k, v in jmask.items()} == {
        "used": bool(mask["used"]), "unused": bool(mask["unused"])}


def test_rank_slices_match_jax_shards():
    """local_batch_slice (test_mesh.py's 512 / 8 and 511), and rank r's
    rows of a global batch are the rows JAX's data-axis sharding puts on
    device r."""
    spec8 = tmesh.MeshSpec(tconfig.MeshConfig(data=8))
    assert tmesh.local_batch_slice(512, spec8) == 64
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_batch_slice(511, spec8)
    jspec = jmesh.make_mesh(jconfig.MeshConfig(data=N))
    arr = jax.device_put(jnp.arange(16), jspec.batch_sharded())
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    jrows = [by_device[d] for d in jspec.mesh.devices.ravel()]
    for r in range(N):
        spec = tmesh.MeshSpec(tconfig.MeshConfig(data=N), rank=r)
        np.testing.assert_array_equal(np.arange(16)[spec.rows(16)], jrows[r])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.MeshSpec(tconfig.MeshConfig(data=N), rank=1).rows(30)


def test_spawn_reports_a_failed_rank_and_kills_the_rest(tmp_path):
    """Rank 1 has no row of x and raises; rank 0, blocked in the
    Reducer's collective, is killed; the call fails with rank 1's
    traceback and leaves no process behind."""
    import multiprocessing

    x = np.ones((1, 3), np.float32)
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        tmesh.spawn(workers.unused_param, 2, x, device="cpu",
                    timeout_s=120, threads=1, store_dir=str(tmp_path))
    assert multiprocessing.active_children() == []


def test_spawn_times_out_and_kills_its_ranks(tmp_path):
    import multiprocessing

    with pytest.raises(TimeoutError):
        tmesh.spawn(workers.unused_param, 2, np.ones((2, 3), np.float32),
                    device="cpu", timeout_s=0.5, threads=1,
                    store_dir=str(tmp_path))
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("call,match", [
    (lambda: tsp.spmd_ticks(2, 3, "1f1b", virtual_stages=2),
     "Megatron constraint"),
    (lambda: tmesh.make_mesh(tconfig.MeshConfig(data=2, dcn_data=2),
                             "cpu"), "needs a process group of 2 ranks"),
    (lambda: tmesh.make_mesh(tconfig.MeshConfig(stage=2), "cpu"),
     "needs a process group of 2 ranks"),
    (lambda: tmesh.make_mesh(tconfig.MeshConfig(data=2), "cpu"),
     "needs a process group of 2 ranks"),
    (lambda: tddp.resolve_allreduce("hierarchical", 1 << 20),
     "needs a two-level data axis; set MeshConfig.dcn_data > 1"),
    (lambda: tddp.resolve_allreduce("hierarchical"),
     "needs a two-level data axis; set MeshConfig.dcn_data > 1"),
    (lambda: tmesh.make_mesh(tconfig.MeshConfig(data=4, dcn_data=3), "cpu"),
     "dcn_data=3 must divide data=4"),
    (lambda: tmesh.spawn(workers.unused_param, 2, device="cuda"),
     "no CUDA device"),
])
def test_refusals_by_name(call, match):
    """What is not ported raises naming its ROADMAP item, what the JAX
    package refuses raises in its words (a two-level axis without ranks,
    the hierarchical transport without one); no rank falls back to the
    CPU when asked for the card."""
    with pytest.raises((ValueError, RuntimeError), match=match):
        call()


def test_barrier_with_timeout_reports_a_straggler():
    """A rendezvous that does not complete within its budget raises
    StragglerTimeoutError and calls on_timeout; one that completes returns
    its result."""
    import threading

    seen = []
    release = threading.Event()
    with pytest.raises(tmesh.StragglerTimeoutError, match="straggler"):
        tmesh.barrier_with_timeout(release.wait, 0.2, what="probe",
                                   on_timeout=lambda w, t: seen.append(w))
    release.set()
    assert seen == ["probe"]
    assert tmesh.barrier_with_timeout(lambda: 4.0, 5.0) == 4.0


def test_best_effort_distributed_init_without_torchrun(monkeypatch):
    """No torchrun environment: no process group, False (as the JAX
    package's probe without a coordinator)."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.best_effort_distributed_init("cpu") is False
    assert not torch.distributed.is_initialized()


def test_replicate_model_state_matches_jax():
    """The per-replica BN layout: a leading axis of N copies, as the JAX
    package's replicate_model_state; replica_state takes slice r."""
    from distributed_model_parallel_tpu.parallel import ddp as jddp

    state = ({"bn0": {"mean": np.arange(3, dtype=np.float32),
                      "var": np.ones(3, np.float32)}},)
    got = tddp.replicate_model_state(state, N)
    want = jddp.replicate_model_state(jax.tree.map(jnp.asarray, state), N)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert jax.tree.structure(got) == jax.tree.structure(state)
    np.testing.assert_array_equal(
        tddp.replica_state(got, 2)[0]["bn0"]["mean"], state[0]["bn0"]["mean"])


@pytest.mark.parametrize("side", ["send", "recv"])
def test_exchange_refuses_a_hop_to_itself(side):
    """A hop names another rank: a rank's own value stays where it is (the
    engines keep it), so a hop to or from the rank itself raises before
    anything is counted or posted."""
    tcoll.reset_counts()
    x = torch.zeros(3)
    hops = ([(x, 0)], ()) if side == "send" else ((), [(x, 0)])
    with pytest.raises(ValueError, match="to itself"):
        tcoll.exchange(*hops)
    assert not any(tcoll.calls.values())
