"""The port's DDP and gspmd steps at 4 gloo ranks against the JAX
package's at ``MeshConfig(data=4)``, from the same tinycnn weights and
global batch of 16 (augment off; SGD lr 0.1, momentum 0.9, wd 1e-4):
parameters, per-rank BN state == JAX's replica r (local), BN state equal
on every rank (sync), metrics, the eval step, per-leaf == bucketed ==
fused buckets, clipping after the reduction, collectives per step ==
buckets, an unused parameter that does not hang, and gspmd at 4 ranks ==
JAX gspmd == the port's one-device trainer. Parameters and momentum are
checked bitwise equal across ranks after every step (inside the ranks).
Tolerance: 1e-4 of each tensor's scale (f32 convolutions in another
order, as tests/test_torch_cnn.py holds them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.parallel import ddp as jddp
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import (
    get_model,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.ops import collectives as tcoll
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import run_dirs
from tests.conftest import tiny_train_config
from tests.test_torch_cnn import _close, _close_trees

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

N, B = 4, 16
# name -> (port case, the JAX run it is held against)
CASES = {
    "local_psum": (dict(bn="local"), "local"),
    "local_bucketed": (dict(bn="local", bucket_bytes=1 << 16), "bucketed"),
    "local_fused_bucketed": (dict(bn="local", fused=True,
                                  allreduce="bucketed"), "local"),
    "local_fused_psum": (dict(bn="local", fused=True), "local"),
    "sync_psum": (dict(bn="sync"), "sync"),
    "sync_fused_small_buckets": (dict(bn="sync", fused=True,
                                      bucket_bytes=2048), "sync"),
    "clip": (dict(bn="local", clip=0.05), "clip"),
}


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 255, (B, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, B).astype(np.int32))


@pytest.fixture(scope="module")
def jax_ddp():
    """The JAX DDP step at data=4 from tinycnn's init (key 0) per run:
    new params, per-replica BN state, metrics, eval metrics."""
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=N))
    images, labels = _batch()
    params, state = jget_model(jconfig.ModelConfig(name="tinycnn")).init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3), jnp.float32))
    out = {"params0": jax.tree.map(np.asarray, params),
           "state0": jax.tree.map(np.asarray, state)}
    runs = {"local": dict(bn="local"), "sync": dict(bn="sync"),
            "bucketed": dict(bn="local", bucket_bytes=1 << 16),
            "clip": dict(bn="local", clip=0.05)}
    for name, run in runs.items():
        model = jget_model(
            jconfig.ModelConfig(name="tinycnn", batchnorm=run["bn"]),
            axis_name=spec.data_axis if run["bn"] == "sync" else None)
        tx = joptim.make_optimizer(jconfig.OptimizerConfig(
            learning_rate=0.1, warmup_steps=0,
            grad_clip_norm=run.get("clip")), 2, 2)
        ts = jtrainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            model_state=jddp.replicate_model_state(state, N),
            opt_state=tx.init(params))
        kw = dict(mean=CIFAR10_MEAN, std=CIFAR10_STD)
        step = jddp.make_ddp_train_step(model, tx, spec, augment=False,
                                        bucket_bytes=run.get("bucket_bytes"),
                                        **kw)
        new, metrics = step(ts, jax.random.key(0), jnp.asarray(images),
                            jnp.asarray(labels))
        ev = jddp.make_ddp_eval_step(model, spec, **kw)(
            new, jnp.asarray(images), jnp.asarray(labels))
        out[name] = dict(
            params=jax.tree.map(np.asarray, new.params),
            state=jax.tree.map(np.asarray, new.model_state),
            metrics={k: float(v) for k, v in metrics.items()},
            eval={k: float(v) for k, v in ev.items()})
    return out


@pytest.fixture(scope="module")
def jax_gspmd(tmp_path_factory):
    """One step of the JAX trainer's gspmd path at data=4 (BN over the
    global batch), from its own init."""
    cfg = tiny_train_config(
        tmp_path_factory.mktemp("jg"), mesh=jconfig.MeshConfig(data=N),
        data=jconfig.DataConfig(name="synthetic", batch_size=B,
                                eval_batch_size=B, synthetic_train_size=32,
                                synthetic_eval_size=B, augment=False),
        optimizer=jconfig.OptimizerConfig(learning_rate=0.1,
                                          warmup_steps=0))
    t = jtrainer.Trainer(cfg)
    params = jax.tree.map(np.asarray, t.state.params)
    state = jax.tree.map(np.asarray, t.state.model_state)
    images, labels = _batch()
    new, metrics = t._train_step(t.state, jax.random.key(3),
                                 *t._shard_batch(images, labels))
    return dict(params0=params, state0=state,
                params=jax.tree.map(np.asarray, new.params),
                state=jax.tree.map(np.asarray, new.model_state),
                metrics={k: float(v) for k, v in metrics.items()})


def _port_gspmd_config(data, root):
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn"),
        data=tconfig.DataConfig(name="synthetic", batch_size=B,
                                eval_batch_size=B, synthetic_train_size=32,
                                synthetic_eval_size=B, augment=False),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=0),
        mesh=tconfig.MeshConfig(data=data), epochs=3, device="cpu",
        **run_dirs(root))


@pytest.fixture(scope="module")
def ranks(jax_ddp, jax_gspmd, tmp_path_factory):
    """One spawn of 4 gloo ranks: every DDP case, the unused-parameter
    Reducer, and one gspmd Trainer step."""
    images, labels = _batch()
    store = str(tmp_path_factory.mktemp("store"))
    ddp = tmesh.spawn(
        workers.ddp_steps, N, {k: c for k, (c, _) in CASES.items()},
        jax_ddp["params0"], jax_ddp["state0"], images, labels,
        CIFAR10_MEAN, CIFAR10_STD, device="cpu", timeout_s=300, threads=1,
        store_dir=store)
    x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    unused = tmesh.spawn(workers.unused_param, N, x, device="cpu",
                         timeout_s=300, threads=1, store_dir=store)
    gspmd = tmesh.spawn(
        workers.trainer_runs, N, {"gspmd": dict(
            config=_port_gspmd_config(N, store),
            params=jax_gspmd["params0"],
            state=jax_gspmd["state0"], step=(images, labels))},
        (images, labels), (images, labels), device="cpu", timeout_s=300,
        threads=1, store_dir=store)
    return dict(ddp=ddp, unused=unused, x=x, gspmd=gspmd)


@pytest.mark.parametrize("case", list(CASES))
def test_ddp_step_matches_jax(jax_ddp, ranks, case):
    """Parameters after one step (the same on every rank: checked bitwise
    in the ranks) and the global metrics == the JAX DDP step's; per-leaf,
    bucketed and the fused optimizer's buckets are the same math."""
    want = jax_ddp[CASES[case][1]]
    for r in ranks["ddp"]:
        got = r[case]
        _close_trees(got["params"], want["params"], f"{case} params")
        _close(got["metrics"]["loss"], want["metrics"]["loss"], "loss")
        for k in ("batch", "correct@1", "correct@5"):
            assert got["metrics"][k] == want["metrics"][k], k
        _close(got["eval"]["loss"], want["eval"]["loss"], "eval loss")
        assert got["eval"]["batch"] == want["eval"]["batch"] == B


@pytest.mark.parametrize("case", ["local_psum", "local_bucketed", "clip"])
def test_local_bn_state_is_jax_replica_r(jax_ddp, ranks, case):
    """Per-replica BN: rank r's running statistics == JAX's replica r, and
    the replicas differ from one another."""
    want = jax_ddp[CASES[case][1]]["state"]
    for i, r in enumerate(ranks["ddp"]):
        _close_trees(r[case]["state"], jax.tree.map(lambda a: a[i], want),
                     f"{case} rank {i} state")
    gathered = ranks["ddp"][0][case]["replica_state"]
    _close_trees(gathered, want, "gathered state")
    leaf = jax.tree.leaves(gathered)[0]
    assert not all(np.allclose(leaf[0], leaf[i]) for i in range(1, N))


@pytest.mark.parametrize("case", ["sync_psum", "sync_fused_small_buckets"])
def test_sync_bn_state_equal_on_all_ranks(jax_ddp, ranks, case):
    """SyncBN: the running statistics come from the global batch — bitwise
    equal on every rank, and == JAX's (whose replicas agree too)."""
    want = jax_ddp["sync"]["state"]
    gathered = ranks["ddp"][0][case]["replica_state"]
    for leaf in jax.tree.leaves(gathered):
        for i in range(1, N):
            np.testing.assert_array_equal(leaf[i], leaf[0])
    _close_trees(gathered, want, "sync state")


def test_bucketed_matches_unbucketed(ranks):
    """Within the port: every transport gives the same parameters (1e-5,
    the JAX package's own bucketed-vs-psum tolerance)."""
    r0 = ranks["ddp"][0]
    base = jax.tree.leaves(r0["local_psum"]["params"])
    for case in ("local_bucketed", "local_fused_bucketed",
                 "local_fused_psum"):
        for a, b in zip(base, jax.tree.leaves(r0[case]["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_reducer_collectives_per_step(ranks):
    """One all-reduce per leaf under psum, one per bucket of plan_buckets
    over the model's parameters under bucketed, one per fused optimizer
    bucket over its own buffers."""
    params = list(get_model(tconfig.ModelConfig(name="tinycnn"),
                            device="cpu").parameters())
    want = {"local_psum": len(params), "local_fused_psum": len(params),
            "local_bucketed": len(tcoll.plan_buckets(params, 1 << 16)),
            "local_fused_bucketed": 1,
            "sync_fused_small_buckets": len(tcoll.plan_buckets(params,
                                                               2048))}
    assert want["sync_fused_small_buckets"] > 1
    for r in ranks["ddp"]:
        for case, n in want.items():
            assert r[case]["calls"] == n, case


def test_clipping_runs_after_the_reduction(jax_ddp, ranks):
    """grad_clip_norm 0.05 clips (its step differs from the unclipped
    one) and matches JAX, whose tx.update clips the averaged gradient:
    clipping each rank's own gradient before the average would not."""
    r0 = ranks["ddp"][0]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(r0["clip"]["params"]),
        jax.tree.leaves(r0["local_psum"]["params"])))
    assert diff > 1e-3
    _close_trees(r0["clip"]["params"], jax_ddp["clip"]["params"], "clip")


@pytest.mark.parametrize("mode", ["psum", "bucketed"])
def test_unused_parameter_does_not_hang(ranks, mode):
    """A parameter off the loss path: finish() launches its bucket (within
    a 60 s budget in the ranks), its gradient is zero, the used one is
    the mean of the ranks' x rows, and the mask flags the unused one, as
    the JAX package's grads and unused_param_mask do."""
    want = ranks["x"].mean(0)
    for r in ranks["unused"]:
        got = r[mode]
        np.testing.assert_allclose(got["used"], want, rtol=1e-6)
        np.testing.assert_array_equal(got["unused"], np.zeros(3))
        assert got["mask"] == {"used": False, "unused": True}
        assert got["calls"] == (2 if mode == "psum" else 1)


def test_gspmd_at_4_ranks_matches_jax_and_one_device(jax_gspmd, ranks,
                                                     tmp_path):
    """gspmd: BN over the global batch even under bn_mode "local". 4 ranks
    == the JAX trainer's gspmd step at data=4, and == the port's own
    one-device trainer on the same global batch; BN state equal on every
    rank."""
    images, labels = _batch()
    one = ttrainer.Trainer(_port_gspmd_config(1, tmp_path),
                           params=jax_gspmd["params0"],
                           state=jax_gspmd["state0"])
    m1 = one._train_step(torch.from_numpy(images), torch.from_numpy(labels),
                         None)
    p1, s1 = params_to_jax(one.model)
    for r in ranks["gspmd"]:
        got = r["gspmd"]
        _close_trees(got["params"], jax_gspmd["params"], "vs jax params")
        _close_trees(got["params"], p1, "vs 1 rank params")
        _close(got["metrics"]["loss"], jax_gspmd["metrics"]["loss"], "loss")
        _close(got["metrics"]["loss"], float(m1["loss"]), "loss 1 rank")
        assert got["metrics"]["batch"] == B
        for leaf in jax.tree.leaves(got["replica_state"]):
            for i in range(1, N):
                np.testing.assert_array_equal(leaf[i], leaf[0])
        _close_trees(jax.tree.map(lambda a: a[0], got["replica_state"]),
                     jax_gspmd["state"], "vs jax state")
        _close_trees(jax.tree.map(lambda a: a[0], got["replica_state"]),
                     s1, "vs 1 rank state")
