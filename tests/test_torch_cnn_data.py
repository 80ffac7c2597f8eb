"""The port's CNN data path (``data/registry.py``, ``data/loader.py``,
``train/metrics.topk_correct``) against the JAX package: synthetic data,
CIFAR pickles and batch order bit for bit, crop/flip bit for bit when fed
JAX's own draws, normalize in f32 and bf16, top-k sums."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.config import DataConfig as JData
from distributed_model_parallel_tpu.data import loader as jloader
from distributed_model_parallel_tpu.data import registry as jreg
from distributed_model_parallel_tpu.train.metrics import (
    topk_correct as j_topk_correct,
)
from distributed_model_parallel_tpu_torch.config import DataConfig as TData
from distributed_model_parallel_tpu_torch.data import loader as tloader
from distributed_model_parallel_tpu_torch.data import registry as treg
from distributed_model_parallel_tpu_torch.train.metrics import (
    topk_correct as t_topk_correct,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n,size,classes,seed", [(96, 32, 10, 0),
                                                 (33, 16, 7, 5)])
def test_synthetic_bit_identical(n, size, classes, seed):
    j = jreg._synthetic(n, size, classes, seed)
    t = treg._synthetic(n, size, classes, seed)
    _same(t.images, j.images)
    _same(t.labels, j.labels)
    assert t.images.dtype == np.uint8 and t.labels.dtype == np.int32


@pytest.mark.parametrize("name", ["synthetic", "cifar10"])
def test_load_dataset_synthetic_fallback(tmp_path, name):
    kw = dict(name=name, root=str(tmp_path), synthetic_train_size=40,
              synthetic_eval_size=12, seed=3)
    for j, t in zip(jreg.load_dataset(JData(**kw)),
                    treg.load_dataset(TData(**kw))):
        _same(t.images, j.images)
        _same(t.labels, j.labels)
        _same(t.mean, j.mean)
        _same(t.std, j.std)


def test_cifar10_pickles_read_alike(tmp_path):
    """A tiny dataset in the ``cifar-10-batches-py`` format."""
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), np.uint8),
                         b"labels": list(rng.integers(0, 10, 4))}, f)
    cfg = dict(name="cifar10", root=str(tmp_path), synthetic_ok=False)
    for j, t in zip(jreg.load_dataset(JData(**cfg)),
                    treg.load_dataset(TData(**cfg))):
        _same(t.images, j.images)
        _same(t.labels, j.labels)
        assert t.images.shape[1:] == (32, 32, 3)


def test_file_backed_datasets_load_like_jax(tmp_path):
    """``imagenet`` without its tree on disk: the JAX package's 1000-class
    synthetic stand-in, bit for bit (tests/test_torch_data_path.py holds
    the decoded trees)."""
    cfg = dict(name="imagenet", root=str(tmp_path), image_size=8,
               synthetic_train_size=16, synthetic_eval_size=4)
    for j, t in zip(jreg.load_dataset(JData(**cfg)),
                    treg.load_dataset(TData(**cfg))):
        _same(t.images, j.images)
        _same(t.labels, j.labels)
        assert t.num_classes == j.num_classes == 1000


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_loader_order_and_cursor_bit_identical(shuffle):
    ds_j = jreg._synthetic(70, 8, 10, 1)
    ds_t = treg._synthetic(70, 8, 10, 1)
    jl = jloader.BatchLoader(ds_j, 16, shuffle=shuffle, seed=4)
    tl = tloader.BatchLoader(ds_t, 16, shuffle=shuffle, seed=4)
    assert len(tl) == len(jl) == 4
    for epoch in (0, 1, 7):
        _same(tl.epoch_indices(epoch), jl.epoch_indices(epoch))
    for _ in range(2):                        # two epochs, exhaustion moves on
        for (ja, jb), (ta, tb) in zip(list(jl), list(tl)):
            _same(ta, ja)
            _same(tb, jb)
        assert (tl.epoch, tl.cursor) == (jl.epoch, jl.cursor)
    for loader in (jl, tl):
        loader.load_state_dict({"epoch": 3, "batch_cursor": 2})
    assert tl.state_dict() == jl.state_dict()
    _same([b for _, b in tl], [b for _, b in jl])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("flip", [True, False])
def test_apply_crop_flip_matches_augment_batch(seed, flip):
    """JAX's draws, reproduced as ``augment_batch`` makes them, fed to the
    port's ``apply_crop_flip``: the same uint8 images bit for bit."""
    x = np.random.default_rng(seed).integers(0, 256, (6, 10, 10, 3),
                                             np.uint8)
    rng = jax.random.key(seed)
    want = jloader.augment_batch(rng, jnp.asarray(x), flip=flip)
    rng_crop, rng_flip = jax.random.split(rng)
    offs = jax.random.randint(rng_crop, (6, 2), 0, 9)
    flips = jax.random.bernoulli(rng_flip, 0.5, (6,)) if flip else None
    got = tloader.apply_crop_flip(
        torch.from_numpy(x), torch.from_numpy(np.array(offs)),
        None if flips is None else torch.from_numpy(np.array(flips)))
    assert got.dtype == torch.uint8
    _same(got, want)


def test_draws_are_stateless_per_step():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (64, 8, 8, 3), np.uint8))

    def draw(step):
        gen = tloader.step_generator(1, step, "cpu")
        return tloader.draw_crop_flip(gen, 64)

    (o1, f1), (o2, f2), (o3, _) = draw(5), draw(5), draw(6)
    assert torch.equal(o1, o2) and torch.equal(f1, f2)
    assert not torch.equal(o1, o3)
    assert int(o1.min()) >= 0 and int(o1.max()) <= 8 and f1.dtype == torch.bool
    out = tloader.augment_batch(tloader.step_generator(1, 5, "cpu"), x)
    assert torch.equal(out, tloader.apply_crop_flip(x, o1, f1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_matches_jax(dtype):
    x = np.random.default_rng(0).integers(0, 256, (4, 6, 6, 3), np.uint8)
    want = jloader.normalize(jnp.asarray(x), treg.CIFAR10_MEAN,
                             treg.CIFAR10_STD, getattr(jnp, dtype))
    got = tloader.normalize(torch.from_numpy(x), treg.CIFAR10_MEAN,
                            treg.CIFAR10_STD, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    # f32: one rounding per operation in both; bf16: one bf16 ulp (2^-8
    # relative) where XLA keeps a value in f32 between two operations.
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(
        rtol=2 ** -8, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_resolve_input_size_matches_jax():
    for shape, size in (((5, 32, 32, 3), 32), ((5, 32, 32, 3), 224),
                        ((5, 16, 16, 3), 32)):
        assert (tloader.resolve_input_size(shape, size)
                == jloader.resolve_input_size(shape, size))
    with pytest.raises(ValueError, match="square"):
        tloader.resolve_input_size((5, 32, 30, 3), 32)


def test_topk_correct_matches_jax():
    rng = np.random.default_rng(0)
    # tie-free logits: a permutation of distinct values per row
    logits = np.stack([rng.permutation(10) for _ in range(40)]).astype(
        np.float32) + rng.normal(size=(40, 10)).astype(np.float32) * 1e-3
    labels = rng.integers(0, 10, 40).astype(np.int32)
    want = j_topk_correct(jnp.asarray(logits), jnp.asarray(labels))
    got = t_topk_correct(torch.from_numpy(logits), torch.from_numpy(labels))
    assert set(got) == set(want) == {"correct@1", "correct@5"}
    for k in want:
        assert int(got[k]) == int(want[k])
