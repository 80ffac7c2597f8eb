"""The port's pipeline runner (``parallel/pipeline.py``) against the JAX
package's ``PipelineRunner`` and single-device step, from one numpy weight
tree: naive S=4 == one device, GPipe gradients == the full batch's,
microbatch BN pooling, 1F1B == GPipe and interleaved == plain bit for bit
inside the port, the schedules' order, eval, three steps, chunk
placement, the S=1 schedule == JAX's fused one-device program, and
MobileNetV2 at the reference's 4-stage cut. Tolerance: 1e-4 of each
tensor's scale (tests/test_torch_cnn.py's ``_close``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.data.registry import _synthetic
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.parallel import pipeline as jpipe
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu_torch.models import (
    get_model,
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_cnn import (  # noqa: F401  (jax_step: a fixture)
    _close,
    _close_trees,
    _step_inputs,
    jax_step,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

LR = 0.1


@pytest.fixture(scope="module")
def batch():
    ds = _synthetic(32, 32, 10, seed=3)
    return ds.images, ds.labels


def _jax_setup(num_stages, *, model_name="tinycnn", bn="local", M=1,
               schedule="gpipe", V=1, lr=LR):
    model = jget_model(jconfig.ModelConfig(name=model_name, batchnorm=bn))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(
        learning_rate=lr, warmup_steps=0, momentum=0.9), 10, 10)
    runner = jpipe.PipelineRunner(
        model, jax.devices()[:num_stages], tx=tx, rng=jax.random.key(0),
        sample_shape=(2, 32, 32, 3), mean=CIFAR10_MEAN, std=CIFAR10_STD,
        num_microbatches=M, augment=False, schedule=schedule,
        virtual_stages=V)
    return model, tx, runner


def _init(bn="local"):
    """tinycnn's JAX init (key 0), the weights every runner starts from."""
    model = jget_model(jconfig.ModelConfig(name="tinycnn", batchnorm=bn))
    p, s = model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)


def _port(num_stages, params, state, *, model_name="tinycnn", bn="local",
          M=1, schedule="gpipe", V=1, lr=LR, fused=False, boundaries=None,
          devices=None):
    model = get_model(tconfig.ModelConfig(name=model_name, batchnorm=bn),
                      device="cpu")
    params_from_jax(model, params, state, "cpu")
    return tpipe.PipelineRunner(
        model, devices or ["cpu"] * num_stages,
        optimizer=tconfig.OptimizerConfig(learning_rate=lr, warmup_steps=0,
                                          momentum=0.9, fused=fused),
        steps_per_epoch=10, epochs=10, mean=CIFAR10_MEAN, std=CIFAR10_STD,
        num_microbatches=M, augment=False, schedule=schedule,
        virtual_stages=V, boundaries=boundaries)


def _jax_single(model, tx, params, state, images, labels):
    ts = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                             params=jax.tree.map(jnp.asarray, params),
                             model_state=jax.tree.map(jnp.asarray, state),
                             opt_state=tx.init(params))
    step = jtrainer.make_train_step(model, tx, mean=CIFAR10_MEAN,
                                    std=CIFAR10_STD, augment=False)
    new, metrics = jax.jit(step)(ts, jax.random.key(9), jnp.asarray(images),
                                 jnp.asarray(labels))
    return (jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, new.model_state), metrics)


def _bitwise(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fused", [False, True])
def test_naive_pipeline_matches_single_device(batch, fused):
    """M=1 over 4 stages (the reference's schedule) == JAX's one-device
    step: loss, parameters, BN statistics."""
    images, labels = batch
    params, state = _init()
    runner = _port(4, params, state, fused=fused)
    got = runner.train_step(None, images, labels)
    model, tx, _ = _jax_setup(1)
    jp, js, jm = _jax_single(model, tx, params, state, images, labels)
    _close(got["loss"], float(jm["loss"]), "loss")
    assert got["correct@1"] == float(jm["correct@1"])
    _close_trees(runner.merged_params(), jp, "params")
    _close_trees(runner.merged_model_state(), js, "state")


@pytest.mark.parametrize("M", [2, 4])
def test_gpipe_microbatched_matches_full_batch_grad(batch, M):
    """GPipe gradient accumulation over M microbatches == the full batch's
    gradient (no-BN model, so batch statistics do not couple the
    microbatches)."""
    images, labels = batch
    params, state = _init("none")
    runner = _port(4, params, state, bn="none", M=M)
    runner.train_step(None, images, labels)
    model = jget_model(jconfig.ModelConfig(name="tinycnn", batchnorm="none"))
    _, tx, _ = _jax_setup(1, bn="none")
    jp, _, _ = _jax_single(model, tx, params, state, images, labels)
    _close_trees(runner.merged_params(), jp, "params")


@pytest.mark.parametrize("momentum", [0.9, 0.5, 1.0])
def test_merge_microbatch_bn_states_matches_jax(momentum):
    """The law-of-total-variance pooling on seeded trees == JAX's,
    including momentum 1 (frozen statistics, no correction)."""
    rng = np.random.default_rng(0)
    M, C = 4, 16
    micro = [({"bn0": {"mean": rng.normal(size=C).astype(np.float32),
                       "var": rng.uniform(0.1, 2, C).astype(np.float32)}},
              {"bn1": {"mean": rng.normal(size=3).astype(np.float32),
                       "var": rng.uniform(0.1, 2, 3).astype(np.float32)}})
             for _ in range(M)]
    want = jpipe.merge_microbatch_bn_states(
        jax.tree.map(jnp.asarray, micro), momentum=momentum)
    got = tpipe.merge_microbatch_bn_states(
        jax.tree.map(torch.from_numpy, micro), momentum=momentum)
    _close_trees(jax.tree.map(lambda t: t.numpy(), got),
                 jax.tree.map(np.asarray, want), "merged")


def test_gpipe_bn_running_stats_match_jax_and_big_batch(batch):
    """GPipe M=4 pools the microbatch BN updates: == JAX's runner; the
    first unit's (whose input is the same) == the big-batch update."""
    images, labels = batch
    params, state = _init()
    runner = _port(2, params, state, M=4)
    runner.train_step(None, images, labels)
    _, _, jr = _jax_setup(2, M=4)
    jr.stages = [jpipe.StageState(
        params=jax.device_put(tuple(params[lo:hi]), jr.devices[c]),
        model_state=jax.device_put(tuple(state[lo:hi]), jr.devices[c]),
        opt_state=st.opt_state)
        for c, ((lo, hi), st) in enumerate(zip(jr.slices, jr.stages))]
    jr.train_step(jax.random.key(9), images, labels)
    _close_trees(runner.merged_model_state(), jr.merged_model_state(),
                 "state")
    model, tx, _ = _jax_setup(1)
    _, js, _ = _jax_single(model, tx, params, state, images, labels)
    _close_trees(runner.merged_model_state()[0], js[0], "unit 0")


def test_1f1b_matches_gpipe_bitwise(batch):
    """1F1B only reorders the work: every backward still runs in
    microbatch order, so parameters, momentum and BN statistics are bit
    for bit GPipe's (BN on, fused buckets)."""
    images, labels = batch
    params, state = _init()
    runs = [_port(3, params, state, M=4, schedule=s, fused=True)
            for s in ("gpipe", "1f1b")]
    mets = [r.train_step(None, images, labels) for r in runs]
    assert mets[0] == mets[1]
    _bitwise(runs[0].merged_params(), runs[1].merged_params())
    _bitwise(runs[0].merged_model_state(), runs[1].merged_model_state())
    for a, b in zip(runs[0].stages, runs[1].stages):
        for x, y in zip(a.optimizer.flat_buckets(), b.optimizer.flat_buckets()):
            torch.testing.assert_close(x[1], y[1], rtol=0, atol=0)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("M", [1, 3, 4, 8])
def test_schedule_order_matches_jax(schedule, S, M):
    params, state = _init()
    got = _port(S, params, state, M=M, schedule=schedule)._schedule()
    _, _, jr = _jax_setup(S, M=M, schedule=schedule)
    assert got == jr._schedule()


def test_eval_matches_jax(batch):
    images, labels = batch
    params, state = _init()
    got = _port(3, params, state).eval_step(images, labels)
    _, _, jr = _jax_setup(3)
    jr.stages = [jpipe.StageState(
        params=tuple(params[lo:hi]), model_state=tuple(state[lo:hi]),
        opt_state=st.opt_state) for (lo, hi), st in zip(jr.slices, jr.stages)]
    want = jr.eval_step(images, labels)
    _close(got["loss"], want["loss"], "loss")
    assert got["correct@1"] == want["correct@1"]
    assert got["batch"] == want["batch"] == len(labels)


def _jax_from(jr, params, state):
    jr.stages = [jpipe.StageState(
        params=jax.device_put(tuple(params[lo:hi]),
                              jr.devices[c % jr.num_stages]),
        model_state=jax.device_put(tuple(state[lo:hi]),
                                   jr.devices[c % jr.num_stages]),
        opt_state=st.opt_state)
        for c, ((lo, hi), st) in enumerate(zip(jr.slices, jr.stages))]
    return jr


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_three_steps_match_jax_runner(batch, schedule):
    """Three steps at S=2, M=2 (momentum carried, BN pooled every step) ==
    JAX's runner: losses, parameters, BN statistics."""
    images, labels = batch
    params, state = _init()
    runner = _port(2, params, state, M=2, schedule=schedule, fused=True)
    jr = _jax_from(_jax_setup(2, M=2, schedule=schedule)[2], params, state)
    for i in range(3):
        got = runner.train_step(None, images, labels)
        want = jr.train_step(jax.random.key(i), images, labels)
        _close(got["loss"], want["loss"], f"loss {i}")
    _close_trees(runner.merged_params(), jr.merged_params(), "params")
    _close_trees(runner.merged_model_state(), jr.merged_model_state(),
                 "state")


def test_interleaved_matches_plain_bitwise_and_jax(batch):
    """V=2 x S=2 (4 chunks, round-robin) == V=1 x S=4 bit for bit in the
    port (same chunks, another placement), and == JAX's interleaved
    runner."""
    images, labels = batch
    params, state = _init()
    virt = _port(2, params, state, M=2, schedule="1f1b", V=2)
    flat = _port(4, params, state, M=2, schedule="1f1b")
    assert virt.num_chunks == 4 and virt.slices == flat.slices
    m1 = virt.train_step(None, images, labels)
    m2 = flat.train_step(None, images, labels)
    assert m1 == m2
    _bitwise(virt.merged_params(), flat.merged_params())
    _bitwise(virt.merged_model_state(), flat.merged_model_state())
    jr = _jax_from(_jax_setup(2, M=2, schedule="1f1b", V=2)[2], params,
                   state)
    jr.train_step(jax.random.key(0), images, labels)
    _close_trees(virt.merged_params(), jr.merged_params(), "params")


def test_chunks_live_on_their_devices():
    """Chunk c on devices[c % S] with its own optimizer over its own
    parameters; a mix of CPU and CUDA devices, and CUDA without a card,
    raise."""
    params, state = _init()
    devs = [torch.device("cpu", i) for i in range(2)]
    r = _port(2, params, state, V=2, devices=devs, fused=True)
    assert [st.device for st in r.stages] == [devs[0], devs[1], devs[0],
                                               devs[1]]
    owned = [set(map(id, st.params(r.model))) for st in r.stages]
    assert sum(len(o) for o in owned) == len(list(r.model.parameters()))
    for st, o in zip(r.stages, owned):
        assert set(map(id, st.optimizer.params)) == o
        assert st.optimizer.device.type == "cpu"
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        tpipe.resolve_devices(["cpu", "cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.resolve_devices(["cuda", "cuda"])


def test_one_stage_schedule_matches_jax_fused_program(batch):
    """JAX runs S=1 as one fused program; the port runs its one schedule:
    M=2 at S=1 == JAX's fused step (parameters, BN statistics, loss)."""
    images, labels = batch
    params, state = _init()
    runner = _port(1, params, state, M=2)
    jr = _jax_from(_jax_setup(1, M=2)[2], params, state)
    assert jr._fused is not None
    want = jr.train_step(jax.random.key(0), images, labels)
    got = runner.train_step(None, images, labels)
    _close(got["loss"], want["loss"], "loss")
    _close_trees(runner.merged_params(), jr.merged_params(), "params")
    _close_trees(runner.merged_model_state(), jr.merged_model_state(),
                 "state")


@pytest.mark.parametrize("fused", [False, True])
def test_mobilenet_reference_cut_matches_jax(jax_step, fused):
    """MobileNetV2 over the reference's 4-GPU cut 0,4,10,16,19, M=1 ==
    JAX's one-device step at tests/test_torch_cnn.py's STEP_SEED draw
    (where f32 gradients are well conditioned): loss, parameters and BN
    statistics."""
    (jparams, jstate), jmet, _ = jax_step
    tm, params, state, images, labels = _step_inputs()
    runner = tpipe.PipelineRunner(
        tm, ["cpu"] * 4, optimizer=tconfig.OptimizerConfig(
            learning_rate=0.1, fused=fused), steps_per_epoch=10, epochs=1,
        mean=CIFAR10_MEAN, std=CIFAR10_STD, boundaries=[0, 4, 10, 16, 19],
        augment=False)
    assert runner.slices == [(0, 4), (4, 10), (10, 16), (16, 19)]
    got = runner.train_step(None, images, labels)
    _close(got["loss"], float(jmet["loss"]), "loss")
    _close_trees(runner.merged_params(), jparams, "params")
    _close_trees(runner.merged_model_state(), jstate, "state")
