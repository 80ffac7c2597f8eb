"""The port's resilience plane held against the JAX package's on the same
inputs: the consistency sentinel's per-leaf fingerprint (the non-finite
count and the mod-2^32 bitsum bit for bit, a sub-ulp mantissa flip and a
correlated sign flip on a leaf replicated over a model axis included;
sum of squares and sum within rtol 1e-5), ``analyze_fingerprints``'
verdicts, ``fit_mesh_to_devices``' decisions, ``corrupt_one_replica``'s
errors, the ``TopologyMismatchError`` contract; the guards and the
watchdog; and, in one spawn of 4 gloo ranks, the bitflip drill: the
sentinel repairs the flipped replica in place and the run ends bit for
bit equal to its uninjected twin, every parameter still a view of the
fused optimizer's bucket, and ``assert_replicated`` finds the replicas
bitwise equal."""

import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.train import consistency as jcons
from distributed_model_parallel_tpu.train import elastic as jelastic
from distributed_model_parallel_tpu.utils import faults as jfaults
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.train import chaos
from distributed_model_parallel_tpu_torch.train import consistency as tcons
from distributed_model_parallel_tpu_torch.train import elastic as telastic
from distributed_model_parallel_tpu_torch.train import guards as tguards
from distributed_model_parallel_tpu_torch.train import resilience as tres
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    Checkpointer,
    TopologyMismatchError,
)
from distributed_model_parallel_tpu_torch.utils import faults as tfaults

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]
torch.set_num_threads(1)

STAT_RTOL = 1e-5


def _leaves(seed=0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    big = rng.standard_normal(4096).astype(np.float32) * 100
    flipped = big.copy()
    # Flip the mantissa's lowest bit of one element: far below what the
    # float sums resolve.
    flipped.view(np.uint32)[17] ^= 1
    bad = rng.standard_normal((3, 5)).astype(np.float32)
    bad[0, 1], bad[2, 2] = np.nan, np.inf
    return [big, flipped, bad,
            rng.standard_normal((7, 3)).astype(np.float32).astype(
                jnp.bfloat16),
            rng.integers(-50, 50, (6,)).astype(np.int32),
            np.array(-0.0, np.float32), np.array(0.0, np.float32)]


def _t(x: np.ndarray) -> torch.Tensor:
    """numpy → tensor, bf16 through its bit pattern."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(x))


def _check_rows(got: np.ndarray, want: np.ndarray) -> None:
    """Columns 0 and 3 bit for bit, 1 and 2 within STAT_RTOL."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    for col in (0, 3):
        np.testing.assert_array_equal(got[..., col].view(np.uint32),
                                      want[..., col].view(np.uint32))
    for col in (1, 2):
        g, w = got[..., col], want[..., col]
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        np.testing.assert_allclose(g[finite], w[finite], rtol=STAT_RTOL,
                                   atol=STAT_RTOL)


def test_leaf_fingerprint_matches_jax():
    leaves = _leaves()
    want = np.stack([np.asarray(jcons.ConsistencySentinel._leaf_stats(
        jnp.asarray(x))) for x in leaves])
    got = tcons.rows_stats([_t(x) for x in leaves], [0] * len(leaves))
    _check_rows(got, want)
    # The sub-ulp flip: the float stats cannot see it, the bitsum does.
    assert got[0, 3].view(np.uint32) != got[1, 3].view(np.uint32)
    assert got[5, 3].view(np.uint32) != got[6, 3].view(np.uint32)   # ±0.0


def test_tp_replicated_sign_flip_matches_jax_mesh_fingerprint():
    """(data 2, model 2): a leaf replicated over the model axis with the
    same sign flip on both copies of replica 1, beside a leaf cut over the
    model axis. JAX's mesh fingerprint (a psum of copy-rotated bitsums)
    == the port's rows per rank, rotated by the model index, combined."""
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=2, model=2),
                           devices=jax.devices()[:4])
    rng = np.random.default_rng(1)
    rep = rng.standard_normal((4, 3)).astype(np.float32)
    rep[0, 0] = 0.0
    cut = rng.standard_normal((4, 6)).astype(np.float32)
    lied = rep.copy()
    lied[0, 0] = -0.0                       # the correlated sign flip
    devs = np.asarray(spec.mesh.devices)    # [data, stage, model, seq, exp]

    def per_device(fn, sharding, shape):
        bufs = [jax.device_put(fn(d, m), devs[d, 0, m, 0, 0])
                for d in range(2) for m in range(2)]
        return jax.make_array_from_single_device_arrays(shape, sharding,
                                                        bufs)

    rep_sh = NamedSharding(spec.mesh, P())
    cut_sh = NamedSharding(spec.mesh, P(None, "model"))
    j_rep = per_device(lambda d, m: lied if d == 1 else rep, rep_sh,
                       rep.shape)
    j_cut = per_device(lambda d, m: cut[:, 3 * m:3 * m + 3], cut_sh,
                       cut.shape)

    class _Quiet:
        telemetry = None

        def log_line(self, _):
            pass

    sentinel = jcons.ConsistencySentinel(1, spec, logger=_Quiet())
    want = np.asarray(sentinel._fingerprint_fn([j_rep, j_cut])(j_rep,
                                                               j_cut))
    rows, data = [], []
    for d, m in itertools.product(range(2), range(2)):
        mine = lied if d == 1 else rep
        rows.append(tcons.rows_stats(
            [torch.from_numpy(mine), torch.from_numpy(
                np.ascontiguousarray(cut[:, 3 * m:3 * m + 3]))],
            [m, 0]))
        data.append(d)
    got = tcons.combine_rows(np.stack(rows), [2] * 4, data, [0] * 4, 2)
    _check_rows(got, want)
    for fp in (got, want):
        verdict = tcons.analyze_fingerprints(fp)
        assert not verdict.consistent and verdict.n_groups == 2


@pytest.mark.parametrize("case", ["same", "one_bad", "nan_minority",
                                  "tie_one_finite", "tie_finite",
                                  "all_nan", "three_way"])
def test_analyze_fingerprints_matches_jax(case):
    rng = np.random.default_rng(7)
    good = rng.standard_normal((5, 4)).astype(np.float32)
    good[:, 0] = 0
    other = good.copy()
    other[2, 3] += 1
    nan = good.copy()
    nan[1, 0] = 3
    third = good.copy()
    third[4, 1] += 2
    fp = {"same": [good] * 4, "one_bad": [good, good, other, good],
          "nan_minority": [good, nan, good], "tie_one_finite": [good, nan],
          "tie_finite": [good, other], "all_nan": [nan, nan],
          "three_way": [good, other, third]}[case]
    fp = np.stack(fp)
    want = jcons.analyze_fingerprints(fp)
    got = tcons.analyze_fingerprints(fp)
    assert (got.consistent, got.finite, got.good_replica, got.outliers,
            got.n_groups) == (want.consistent, want.finite,
                              want.good_replica, want.outliers,
                              want.n_groups)


def test_fit_mesh_to_devices_matches_jax():
    meshes = [dict(data=8), dict(data=8, dcn_data=2), dict(data=4, model=2),
              dict(data=2, stage=2, seq=2), dict(data=6, dcn_data=3),
              dict(data=1, expert=4)]
    for kw, n, batch in itertools.product(meshes, (1, 2, 3, 4, 6, 8, 16),
                                          (None, 12, 32)):
        j, t = jconfig.MeshConfig(**kw), tconfig.MeshConfig(**kw)
        try:
            jm, jd = jelastic.fit_mesh_to_devices(j, n, batch_size=batch)
        except ValueError as e:
            with pytest.raises(ValueError) as ei:
                telastic.fit_mesh_to_devices(t, n, batch_size=batch)
            assert str(ei.value) == str(e)
            continue
        tm, td = telastic.fit_mesh_to_devices(t, n, batch_size=batch)
        assert (tm.axis_sizes(), tm.dcn_data) == (jm.axis_sizes(),
                                                  jm.dcn_data)
        assert td.describe() == jd.describe()


def test_corrupt_one_replica_errors_match_jax():
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=2),
                           devices=jax.devices()[:2])
    sh = NamedSharding(spec.mesh, P())
    jtree = [jax.device_put(jnp.ones(3), sh)]
    ttree = [torch.ones(3)]
    for kind, param, kw in (("bitflip", None, dict(replica=5)),
                            ("bitflip", 0.5, {}), ("bitflip", 3.0, {}),
                            ("desync", 0.0, {}), ("grad_skew", 0.0, {}),
                            ("nan_loss", None, {})):
        with pytest.raises(ValueError) as want:
            jfaults.corrupt_one_replica(jtree, spec, kind, param, **kw)
        with pytest.raises(ValueError) as got:
            tfaults.corrupt_one_replica(ttree, 2, 0, kind, param, **kw)
        assert str(got.value) == str(want.value)
    one = [torch.ones(3)]
    assert not tfaults.corrupt_one_replica(one, 2, 0, "bitflip")
    assert tfaults.corrupt_one_replica(one, 2, 1, "bitflip")
    assert one[0].tolist() == [0.5, 1.0, 1.0]      # lowest exponent bit


def test_topology_mismatch_error_contract(tmp_path):
    """State whose global shape encodes the saving topology: a typed
    error naming both shapes, raised through the fallback loop, and not
    a ValueError."""
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save({"bn": np.arange(24.0).reshape(8, 3), "w": np.ones(4)}, "ckpt")
    target = {"bn": np.zeros((4, 3)), "w": np.ones(4)}
    for fallback in (True, False):
        with pytest.raises(TopologyMismatchError) as ei:
            ckpt.restore_resharded(target, "ckpt", allow_fallback=fallback)
        assert "(8, 3)" in str(ei.value) and "(4, 3)" in str(ei.value)
        assert ei.value.conflicts == [("bn", (8, 3), (4, 3))]
        assert not isinstance(ei.value, ValueError)
    with pytest.raises(TopologyMismatchError):
        telastic.elastic_restore(ckpt, (target,), ("ckpt",))
    ok = ckpt.restore_resharded({"bn": np.zeros((8, 3)), "w": np.ones(4)},
                                "ckpt")
    assert ok["bn"].sum() == 276.0


def test_guards_and_watchdog():
    with pytest.raises(tguards.NonFiniteError,
                       match=r"params\[1\] contains 1 NaN / 1 Inf"):
        tguards.check_finite([torch.ones(2), torch.tensor(
            [1.0, float("nan"), float("inf")])], name="params")
    tguards.check_finite({"loss": np.float32(1.0)})
    seen = []
    wd = tres.Watchdog(0.05, interval_s=0.02,
                       on_escalate=lambda w, s: seen.append(w))
    with wd.watch("probe"):
        time.sleep(0.15)
    assert wd.stalled and seen == ["probe"] and wd.worst_s >= 0.15
    runner = tguards.GuardRunner(
        check_finite_every=2, stall_budget_s=0.05,
        injector=tfaults.FaultInjector(("stall@0:0.1",)))
    with runner.watch():
        pass
    assert runner.stall.stalled
    with pytest.raises(tguards.NonFiniteError, match="metrics"):
        runner.after_sync({"loss": float("nan")}, 1)


def test_supervisor_rejects_undetectable_plans():
    for kw, match in ((dict(faults=("nan_loss@1",)),
                       "check_finite_every is 0"),
                      (dict(faults=("bitflip@1",)),
                       "consistency_every is\\s+0"),
                      (dict(lr_shrink=0.0), "lr_shrink must be in")):
        with pytest.raises(ValueError, match=match):
            tres.RecoverySupervisor(
                tconfig.RecoveryConfig(**kw), logger=None, ckpt=None,
                preemption=None, check_finite_every=0)


def test_bitflip_repaired_bitwise_at_four_ranks(tmp_path):
    """One spawn of 4 gloo ranks: a bitflip on replica 3 after step 1 is
    detected at the next drain and repaired by broadcast; the run's final
    parameters equal its uninjected twin's bit for bit on every rank, and
    the parameters stay the fused buckets' views throughout."""
    kw = dict(epochs=1, mesh=tconfig.MeshConfig(data=4), consistency_every=1,
              max_inflight_steps=1,
              optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                                warmup_steps=2, fused=True))
    clean = chaos._config(str(tmp_path), "clean", "cpu", **kw,
                          recovery=tconfig.RecoveryConfig(max_retries=1))
    hit = chaos._config(str(tmp_path), "hit", "cpu", **kw,
                        recovery=tconfig.RecoveryConfig(
                            max_retries=1, faults=("bitflip@1",)))
    ranks = tmesh.spawn(chaos.drill_rank, 4, [(clean, True), (hit, True)],
                        device="cpu", threads=1, timeout_s=300,
                        config=tconfig.MeshConfig(data=4),
                        store_dir=str(tmp_path))
    for a, b in ranks:
        assert all(np.array_equal(x, y) for x, y in zip(a["params"],
                                                        b["params"]))
        assert a["views_kept"] and b["views_kept"]
        assert a["replicated"] and b["replicated"]     # assert_replicated
        assert b["repairs"] == 1 and b["fired"] == ["bitflip"]
    statuses = [r["status"] for r in ranks[0][1]["records"]
                if r["kind"] == "consistency"]
    assert statuses == ["divergence", "repaired"]
    outliers = [r["outliers"] for r in ranks[0][1]["records"]
                if r["kind"] == "consistency"]
    assert outliers == [[3], [3]]
