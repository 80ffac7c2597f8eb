"""The port's sparse-gradient embedding path (``ops/sparse.py``,
``models/embedding.py``; BASELINE config 5) against the JAX package from
the same weights, tests/test_sparse_embedding.py's four cases: the COO
gradient == dense autodiff, the sparse SGD step == dense SGD (and == the
JAX sparse step), two gloo ranks with the sparse all-reduce == dense SGD
on the global batch (the ranks' tables bitwise equal), and 50 steps of
training; plus the scatter-add with duplicate ids and the weight
carrier. Tolerances: JAX's own (rtol 1e-5, atol 1e-6; losses rel 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models import embedding as jbow
from distributed_model_parallel_tpu.ops import sparse as jsparse
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import embedding as tbow
from distributed_model_parallel_tpu_torch.ops import sparse as tsparse
from distributed_model_parallel_tpu_torch.parallel import workers

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

JCFG = jbow.BowConfig(vocab_size=128, embed_dim=16, num_classes=5)
TCFG = tbow.BowConfig(vocab_size=128, embed_dim=16, num_classes=5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, (16, 8)).astype(np.int64)
    labels = rng.integers(0, JCFG.num_classes, 16).astype(np.int64)
    return tokens, labels


def _jax_params(seed):
    return jax.tree.map(np.asarray, jbow.init_params(jax.random.key(seed),
                                                     JCFG))


def _dense_sgd(params, tokens, labels, lr):
    jp = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(jbow.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    return jax.tree.map(lambda p, g: np.asarray(p - lr * g), jp, grads), \
        float(loss)


def _allclose(got, want):
    for k in tbow.PARAM_NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_coo_grad_matches_dense_autodiff(data):
    tokens, _ = data
    table = np.array(jax.random.normal(jax.random.key(0),
                                       (JCFG.vocab_size, JCFG.embed_dim)))
    jt = jnp.asarray(tokens)
    want = jax.grad(lambda tb: jnp.sum(jnp.sin(
        jsparse.embedding_lookup(tb, jt))))(jnp.asarray(table))
    e = tsparse.embedding_lookup(torch.from_numpy(table),
                                 torch.from_numpy(tokens)).requires_grad_()
    d_out, = torch.autograd.grad(torch.sin(e).sum(), e)
    ids, vals = tsparse.embedding_grad_sparse(torch.from_numpy(tokens),
                                              d_out)
    assert ids.shape == (128,) and vals.shape == (128, 16)
    np.testing.assert_allclose(
        tsparse.densify(ids, vals, JCFG.vocab_size).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sparse_sgd_step_matches_dense_sgd(data):
    tokens, labels = data
    params = _jax_params(1)
    lr = 0.1
    step = tbow.make_sparse_sgd_step(TCFG, lr)
    new, loss = step(tbow.params_from_jax(params, "cpu"),
                     torch.from_numpy(tokens), torch.from_numpy(labels))
    want, loss_d = _dense_sgd(params, tokens, labels, lr)
    jnew, jloss = jax.jit(jbow.make_sparse_sgd_step(JCFG, lr))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(labels))
    assert float(loss) == pytest.approx(loss_d, rel=1e-6)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    got = tbow.params_to_jax(new)
    _allclose(got, want)
    _allclose(got, jax.tree.map(np.asarray, jnew))


def test_ddp_sparse_step_matches_global_dense(data, tmp_path):
    """Two gloo ranks, each on 8 of the 16 rows, the COO pairs crossing by
    the sparse all-reduce: the new parameters == dense SGD on the global
    batch, the loss == its loss, and both ranks' tables bitwise equal."""
    tokens, labels = data
    params = _jax_params(1)
    lr = 0.1
    ranks = tmesh.spawn(workers.sparse_bow_step, 2, TCFG, params, tokens,
                        labels, lr, device="cpu", timeout_s=120, threads=1,
                        store_dir=str(tmp_path))
    want, loss_d = _dense_sgd(params, tokens, labels, lr)
    for r in ranks:
        assert r["loss"] == pytest.approx(loss_d, rel=1e-5)
        _allclose(r["params"], want)
        for k in tbow.PARAM_NAMES:
            np.testing.assert_array_equal(r["params"][k],
                                          ranks[0]["params"][k])


def test_training_reduces_loss_as_jax(data):
    """50 steps at lr 1.0 from JAX's init: each loss == the JAX sparse
    step's (rel 1e-4 after 50 compounded steps), and the last under 0.7 x
    the first, as tests/test_sparse_embedding.py asks of JAX's."""
    tokens, labels = data
    params = _jax_params(2)
    jstep = jax.jit(jbow.make_sparse_sgd_step(JCFG, 1.0))
    tstep = tbow.make_sparse_sgd_step(TCFG, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tbow.params_from_jax(params, "cpu")
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    losses = []
    for _ in range(50):
        jp, jl = jstep(jp, jnp.asarray(tokens), jnp.asarray(labels))
        tp, loss = tstep(tp, tt, tl)
        assert float(loss) == pytest.approx(float(jl), rel=1e-4)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7


def test_apply_sparse_grad_with_duplicates_matches_jax():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(10, 4)).astype(np.float32)
    ids = np.array([3, 1, 3, 3, 9, 1, 0], np.int64)
    vals = rng.normal(size=(7, 4)).astype(np.float32)
    want = jsparse.apply_sparse_grad(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(vals), 0.5)
    got = tsparse.apply_sparse_grad(torch.from_numpy(table),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(vals), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not torch.are_deterministic_algorithms_enabled()
    np.testing.assert_allclose(
        tsparse.densify(torch.from_numpy(ids), torch.from_numpy(vals),
                        10).numpy(),
        np.asarray(jsparse.densify(jnp.asarray(ids), jnp.asarray(vals), 10)),
        rtol=1e-6, atol=1e-6)


def test_params_carrier_and_init():
    params = _jax_params(0)
    tp = tbow.params_from_jax(params, "cpu")
    back = tbow.params_to_jax(tp)
    for k in tbow.PARAM_NAMES:
        np.testing.assert_array_equal(back[k], params[k])
    with pytest.raises(ValueError, match="BOW"):
        tbow.params_from_jax({"embedding": params["embedding"]}, "cpu")
    own = tbow.init_params(TCFG, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: np.shape(v) for k, v in params.items()}
    assert float(own["embedding"].std()) == pytest.approx(0.1, rel=0.1)
    assert not own["b"].any()
