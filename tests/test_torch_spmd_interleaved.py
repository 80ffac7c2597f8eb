"""Interleaved 1F1B over ranks (``parallel/spmd_cnn_pipeline.py`` with
``virtual_stages = V > 1``): the static tick table (complete, each
chunk's backwards in microbatch order, at most ``stash_slots`` chunk
forwards held a rank, the ``M % S`` refusal), two gloo ranks at S=2, V=2,
M=4 from tinycnn's JAX init == the runner's interleaved V=2 at S=2 bit
for bit (parameters, momentum, BN statistics, metrics) and == JAX's
``make_cnn_1f1b_fwd_bwd`` step with ``virtual_stages=2`` within 1e-4;
the hops a step; ``Trainer(strategy="spmd_pipeline", virtual_stages=2)``
at 2 ranks == ``PipelineTrainer`` interleaved (histories within 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu import mesh as jmesh
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.parallel import spmd_cnn_pipeline as jsp
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    load_dataset,
)
from distributed_model_parallel_tpu_torch.parallel import (
    spmd_cnn_pipeline as tsp,
)
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import (
    pipeline_trainer as tpipeline_trainer,
)
from tests._torch_port_util import run_dirs
from tests.test_torch_cnn import _close, _close_trees
from tests.test_torch_pipeline import (
    _bitwise,
    _init,
    _port,
    batch,  # noqa: F401  (a fixture)
)
from tests.test_torch_pipeline_trainer import (
    DATA,
    _check_history,
    _port_config,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CASES = {"v2": dict(M=4, schedule="1f1b", V=2, fused=True),
         "v2_m2": dict(M=2, schedule="1f1b", V=2),
         "1f1b4": dict(M=4, schedule="1f1b", fused=True)}


@pytest.mark.parametrize("S,V,M", [(2, 2, 2), (2, 2, 4), (2, 3, 8),
                                   (3, 2, 6), (4, 2, 8), (4, 4, 4)])
def test_tick_table_runs_every_chunk_in_order(S, V, M):
    """Every (microbatch, chunk) forward and backward runs once, on stage
    chunk % S; a chunk's forwards and backwards come in microbatch order;
    each backward after its forward; a stage never holds more than
    stash_slots forwards awaiting their backward; an operation's input
    arrived at an earlier tick."""
    D = S * V
    ticks = tsp.spmd_ticks(S, M, "1f1b", virtual_stages=V)
    seen = {("F", m, c) for m in range(M) for c in range(D)}
    seen |= {("B", m, c) for m in range(M) for c in range(D)}
    seen |= {("L", m, None) for m in range(M)}
    ran, made, held = [], {}, [0] * S
    for t, row in enumerate(ticks):
        for s, op in enumerate(row):
            if op is None:
                continue
            kind, m, c = op
            assert kind == "L" and s == 0 or c % S == s
            need = tsp._needs(op, D)
            assert need is None or made[need] < t, (op, t)
            out = tsp._makes(op, S, D, True)
            if out is not None:
                made[out[0]] = t
            held[s] += {"F": 1, "B": -1, "L": 0}[kind]
            assert held[s] <= tsp.stash_slots(S, V, M)
            ran.append(op)
    assert sorted(ran, key=str) == sorted(seen, key=str)
    for c in range(D):
        for kind in ("F", "B"):
            assert [m for k, m, cc in ran if (k, cc) == (kind, c)] == \
                list(range(M))
    with pytest.raises(ValueError, match="Megatron constraint"):
        tsp.spmd_ticks(S, M + 1, "1f1b", virtual_stages=V)


def test_eval_ticks_and_refusals():
    ticks = tsp.spmd_ticks(2, 1, train=False, virtual_stages=2)
    assert [op for row in ticks for op in row if op] == [
        ("F", 0, 0), ("F", 0, 1), ("F", 0, 2), ("F", 0, 3),
        ("L", 0, None)]
    with pytest.raises(ValueError, match="1f1b schedule feature"):
        tsp.spmd_ticks(2, 4, "gpipe", virtual_stages=2)


@pytest.fixture(scope="module")
def ranks(batch, tmp_path_factory):
    images, labels = batch
    return tmesh.spawn(
        workers.spmd_pipeline_steps, 2, CASES, *_init(), images, labels,
        CIFAR10_MEAN, CIFAR10_STD, device="cpu", timeout_s=300, threads=1,
        store_dir=str(tmp_path_factory.mktemp("store")),
        config=tconfig.MeshConfig(stage=2))


def _merged(ranks, case, key):
    """The whole model's tree from the ranks' units."""
    units = {}
    for r in ranks:
        for g, tree in zip(r[case]["units"], r[case][key]):
            units[g] = tree
    return tuple(units[g] for g in sorted(units))


@pytest.mark.parametrize("case", ["v2", "v2_m2"])
def test_matches_the_runner_interleaved_bitwise(batch, ranks, case):
    """Each rank holds chunks s and 2 + s of the 4 (tinycnn's 6 units cut
    0,2,4,5,6); after the step every parameter, momentum trace and BN
    statistic == the runner's interleaved V=2 at S=2, bit for bit."""
    images, labels = batch
    c = CASES[case]
    runner = _port(2, *_init(), M=c["M"], schedule="1f1b", V=2,
                   fused=c.get("fused", False))
    want = runner.train_step(None, images, labels)
    assert [r[case]["units"] for r in ranks] == [[0, 1, 4], [2, 3, 5]]
    _bitwise(_merged(ranks, case, "params"), runner.merged_params())
    _bitwise(_merged(ranks, case, "state"), runner.merged_model_state())
    for s, r in enumerate(ranks):
        moms = [st.optimizer.momentum_buffer(i).numpy()
                for st in runner.stages[s::2]
                for i in range(len(st.optimizer.params))]
        assert len(moms) == len(r[case]["momentum"])
        for a, b in zip(r[case]["momentum"], moms):
            np.testing.assert_array_equal(a, b)
        assert r[case]["metrics"][0]["loss"] == pytest.approx(
            want["loss"], rel=1e-6)
        assert r[case]["metrics"][0]["correct@1"] == want["correct@1"]


def test_matches_jax_interleaved_1f1b_step(batch, ranks):
    """JAX's ``make_spmd_cnn_train_step`` with schedule 1f1b and
    virtual_stages 2 over a (data 1, stage 2) mesh, from the same weights
    and batch: parameters, pooled BN statistics and the loss within
    1e-4."""
    images, labels = batch
    model = jget_model(jconfig.ModelConfig(name="tinycnn"))
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(
        learning_rate=0.1, warmup_steps=0), 10, 10)
    params, state = _init()
    ts = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                             params=jax.tree.map(jnp.asarray, params),
                             model_state=jax.tree.map(jnp.asarray, state),
                             opt_state=tx.init(params))
    spec = jmesh.make_mesh(jconfig.MeshConfig(data=1, stage=2))
    step = jax.jit(jsp.make_spmd_cnn_train_step(
        model, spec, tx, sample_shape=(2, 32, 32, 3), mean=CIFAR10_MEAN,
        std=CIFAR10_STD, num_microbatches=4, augment=False,
        schedule="1f1b", virtual_stages=2))
    new, metrics = step(ts, jax.random.key(9), jnp.asarray(images),
                        jnp.asarray(labels))
    _close_trees(_merged(ranks, "v2", "params"),
                 jax.tree.map(np.asarray, new.params), "params")
    _close_trees(_merged(ranks, "v2", "state"),
                 jax.tree.map(np.asarray, new.model_state), "state")
    _close(ranks[0]["v2"]["metrics"][0]["loss"], float(metrics["loss"]),
           "loss")


def test_interleaved_hops_a_step(ranks):
    """A microbatch crosses the ring 2·D times a step (D - 1 activation
    hops and the logits' hop forward, the d(logits) hop and D - 1
    gradient hops back): 2·4·4 = 32 hops over the two ranks at M=4, twice
    1F1B's 2·S·M = 16 at V=1; each rank receives what the other sends."""
    v2 = [r["v2"]["calls"] for r in ranks]
    plain = [r["1f1b4"]["calls"] for r in ranks]
    assert sum(c["p2p_send"] for c in v2) == 2 * 4 * 4
    assert sum(c["p2p_send"] for c in plain) == 2 * 2 * 4
    assert [c["p2p_send"] for c in v2] == [c["p2p_recv"] for c in v2[::-1]]
    sent = [r["v2"]["bytes"]["p2p_send"] for r in ranks]
    got = [r["v2"]["bytes"]["p2p_recv"] for r in ranks]
    assert sent == got[::-1]


def test_spmd_trainer_interleaved_matches_runner_trainer(tmp_path):
    """``Trainer(strategy="spmd_pipeline", virtual_stages=2)`` over 2 gloo
    ranks (M=2) == the runner's ``PipelineTrainer`` interleaved V=2 from
    the same weights: the history on every rank, within 1e-4."""
    params, state = _init()
    kw = dict(pipeline_schedule="1f1b", virtual_stages=2)
    runner = tpipeline_trainer.PipelineTrainer(
        _port_config(**kw, **run_dirs(tmp_path, "runner")), params=params,
        state=state)
    assert runner.runner.num_chunks == 4
    history = runner.fit()
    train, evals = load_dataset(tconfig.DataConfig(**DATA))
    ranks = tmesh.spawn(
        workers.spmd_trainer_fit, 2,
        _port_config(strategy="spmd_pipeline", **kw,
                     **run_dirs(tmp_path, "spmd")),
        params, state, (train.images, train.labels),
        (evals.images, evals.labels), device="cpu", timeout_s=300,
        threads=1, store_dir=str(tmp_path),
        config=tconfig.MeshConfig(stage=2))
    for r in ranks:
        _check_history(r["history"], history)
