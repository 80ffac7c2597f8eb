"""The port's data path (``data/registry.py``, ``data/loader.py``,
``data/native.py``) against the JAX package's on the same files and
arrays: ImageFolder (ImageNet, Places365 layouts) and CUB-200 trees built
under ``tmp_path`` decode to the same pixels, labels and lazy/eager
choice, batch order and cursor resume are bit-equal; ``resize_batch``
against ``jax.image.resize`` (uint8 equal away from .5 ties); the host
and device prefetch stages' position protocol, errors and shutdown; the
native gather and ``shard_by_process``."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distributed_model_parallel_tpu.config import DataConfig as JData
from distributed_model_parallel_tpu.data import loader as jloader
from distributed_model_parallel_tpu.data import registry as jreg
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.config import DataConfig as TData
from distributed_model_parallel_tpu_torch.data import loader as tloader
from distributed_model_parallel_tpu_torch.data import native
from distributed_model_parallel_tpu_torch.data import registry as treg
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests._torch_port_util import run_dirs

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# The resize's float values against jax.image.resize, on the 0-255 scale:
# both are f32 bilinear kernels that sum the same taps in another order.
RESIZE_ATOL = 1e-3
# A uint8 output is held equal where the float value is farther than this
# from a .5 tie (the round-half-to-even of a value within float rounding
# of a tie may go either way).
TIE = 1e-3


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _both(**cfg):
    """(JAX (train, eval), port (train, eval)) for one DataConfig."""
    return (jreg.load_dataset(JData(**cfg)), treg.load_dataset(TData(**cfg)))


def _same_splits(j, t):
    for js, ts in zip(j, t):
        assert ts.is_lazy == js.is_lazy
        assert ts.num_classes == js.num_classes
        _same(ts.labels, js.labels)
        _same(ts.mean, js.mean)
        _same(ts.std, js.std)
        idx = np.arange(len(js))
        _same(ts.images[idx], js.images[idx])


def _imagefolder(root, n_per_class=3, size=8, classes=("ant", "bee", "cat"),
                 seed=7):
    rng = np.random.default_rng(seed)
    for split, per in (("train", n_per_class), ("val", 1)):
        for cls in classes:
            cdir = root / split / cls
            cdir.mkdir(parents=True)
            for j in range(per):
                # Odd sizes, so the decode's resize to image_size runs.
                arr = rng.integers(0, 256, (size + j, size + 2, 3),
                                   np.uint8)
                Image.fromarray(arr).save(cdir / f"img{j}.png")


def _cub(root, seed=3):
    rng = np.random.default_rng(seed)
    rows = [(1, "001.Ant/a.png", 1, 1), (2, "001.Ant/b.png", 1, 0),
            (3, "002.Bee/c.png", 2, 1), (4, "002.Bee/d.png", 2, 1),
            (5, "003.Cat/e.png", 3, 0), (6, "003.Cat/f.png", 3, 1)]
    (root / "images").mkdir(parents=True)
    for _, rel, _, _ in rows:
        p = root / "images" / rel
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (9, 7, 3), np.uint8)).save(p)
    (root / "images.txt").write_text(
        "".join(f"{i} {rel}\n" for i, rel, _, _ in rows))
    (root / "image_class_labels.txt").write_text(
        "".join(f"{i} {lb}\n" for i, _, lb, _ in rows))
    (root / "train_test_split.txt").write_text(
        "".join(f"{i} {t}\n" for i, _, _, t in rows))


# -- file-backed datasets --------------------------------------------------------

@pytest.mark.parametrize("name", ["imagenet", "place365"])
@pytest.mark.parametrize("lazy", [None, True, False])
def test_imagefolder_decodes_like_jax(tmp_path, name, lazy):
    """The same ImageFolder tree (classes sorted, files by name, the
    validation split on the training split's class indices, each image
    resized to image_size by PIL): bit-equal pixels and labels, ImageNet
    statistics, the same lazy/eager choice."""
    _imagefolder(tmp_path / name)
    j, t = _both(name=name, root=str(tmp_path), image_size=8,
                 synthetic_ok=False, lazy_decode=lazy)
    _same_splits(j, t)
    assert len(t[0]) == 9 and len(t[1]) == 3 and t[0].num_classes == 3
    assert t[0].is_lazy == bool(lazy)


@pytest.mark.parametrize("lazy", [None, True])
def test_cub200_decodes_like_jax(tmp_path, lazy):
    """CUB-200's three files joined on image id (labels from 1, 1 =
    train): bit-equal pixels, labels and splits."""
    _cub(tmp_path / "CUB_200_2011")
    j, t = _both(name="cub200", root=str(tmp_path), image_size=8,
                 synthetic_ok=False, lazy_decode=lazy)
    _same_splits(j, t)
    _same(t[0].labels, [0, 1, 1, 2])
    _same(t[1].labels, [0, 2])


def test_auto_lazy_threshold_and_refusals(tmp_path, monkeypatch):
    """Above LAZY_AUTO_BYTES the auto choice streams, in both packages;
    a lazy array refuses whole-array conversion; a single index decodes
    one image."""
    _imagefolder(tmp_path / "imagenet")
    monkeypatch.setattr(jreg, "LAZY_AUTO_BYTES", 0)
    monkeypatch.setattr(treg, "LAZY_AUTO_BYTES", 0)
    j, t = _both(name="imagenet", root=str(tmp_path), image_size=8,
                 synthetic_ok=False)
    assert t[0].is_lazy and j[0].is_lazy
    _same_splits(j, t)
    with pytest.raises(TypeError, match="refusing to materialize"):
        np.asarray(t[0].images)
    _same(t[0].images[4], j[0].images[4])
    t[0].images.close()


def test_missing_file_backed_dataset_falls_back_like_jax(tmp_path):
    """Without the files: the synthetic stand-in of the dataset's class
    count (ImageNet 1000, CUB 200), bit-equal; refused with
    synthetic_ok=False."""
    for name in ("imagenet", "cub200", "place365"):
        cfg = dict(name=name, root=str(tmp_path), synthetic_train_size=12,
                   synthetic_eval_size=4, image_size=8)
        j, t = _both(**cfg)
        _same_splits(j, t)
        with pytest.raises(FileNotFoundError, match="synthetic_ok"):
            treg.load_dataset(TData(**cfg, synthetic_ok=False))


@pytest.mark.parametrize("lazy", [False, True])
def test_file_backed_batch_order_and_cursor_resume(tmp_path, lazy):
    """BatchLoader over an ImageFolder: the same batches, in the same
    order, in both packages, and a loader restored at (epoch 2, cursor 1)
    continues with the same batches."""
    _imagefolder(tmp_path / "imagenet", n_per_class=4)
    j, t = _both(name="imagenet", root=str(tmp_path), image_size=8,
                 synthetic_ok=False, lazy_decode=lazy)
    jl = jloader.BatchLoader(j[0], 4, shuffle=True, seed=5)
    tl = tloader.BatchLoader(t[0], 4, shuffle=True, seed=5)
    for _ in range(2):
        for (ja, jb), (ta, tb) in zip(list(jl), list(tl), strict=True):
            _same(ta, ja)
            _same(tb, jb)
    for loader in (jl, tl):
        loader.load_state_dict({"epoch": 2, "batch_cursor": 1})
    assert tl.state_dict() == jl.state_dict()
    for (ja, jb), (ta, tb) in zip(list(jl), list(tl), strict=True):
        _same(ta, ja)
        _same(tb, jb)


def test_device_resident_refuses_a_lazy_dataset_like_jax(tmp_path):
    """device_resident_data needs decoded pixels: a lazily decoded
    dataset is refused, with the JAX trainer's wording."""
    from distributed_model_parallel_tpu import config as jconfig
    from distributed_model_parallel_tpu.train.trainer import (
        Trainer as JTrainer,
    )

    _imagefolder(tmp_path / "imagenet", n_per_class=8, size=32)
    data = dict(name="imagenet", root=str(tmp_path), image_size=32,
                batch_size=8, eval_batch_size=2, synthetic_ok=False,
                lazy_decode=True, augment=False)
    with pytest.raises(ValueError) as jerr:
        JTrainer(jconfig.TrainConfig(
            model=jconfig.ModelConfig(name="tinycnn"),
            data=jconfig.DataConfig(**data),
            mesh=jconfig.MeshConfig(data=1), device_resident_data=True,
            log_dir=str(tmp_path / "jlog"),
            checkpoint_dir=str(tmp_path / "jck")))
    with pytest.raises(ValueError) as terr:
        ttrainer.Trainer(tconfig.TrainConfig(
            model=tconfig.ModelConfig(name="tinycnn"),
            data=tconfig.DataConfig(**data), device="cpu",
            device_resident_data=True, **run_dirs(tmp_path)))
    assert str(terr.value) == str(jerr.value)
    assert "lazy_decode=False" in str(terr.value)


def test_trainer_fits_a_lazy_imagefolder(tmp_path):
    """A Trainer epoch over a lazily decoded ImageFolder through the
    prefetch stages, the head sized to the tree's classes."""
    _imagefolder(tmp_path / "imagenet", n_per_class=2, size=16,
                 classes=("a", "b", "c", "d", "e"))
    t = ttrainer.Trainer(tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="tinycnn", num_classes=5),
        data=tconfig.DataConfig(name="imagenet", root=str(tmp_path),
                                image_size=16, batch_size=5,
                                eval_batch_size=5, synthetic_ok=False,
                                lazy_decode=True),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1,
                                          warmup_steps=0),
        device="cpu", epochs=1, **run_dirs(tmp_path)))
    assert t.train_ds.is_lazy
    (rec,) = t.fit()
    assert np.isfinite(rec["loss_train"]) and np.isfinite(rec["loss_val"])


# -- the on-device resize --------------------------------------------------------

@pytest.mark.parametrize("src,dst", [(32, 224), (32, 48), (8, 29), (48, 32),
                                     (224, 32), (50, 33)])
def test_resize_batch_matches_jax_image_resize(src, dst):
    """Up (the finetune recipe's 32 → 224) and down (antialiased, as
    jax.image.resize is): the float values within RESIZE_ATOL, the uint8
    outputs equal wherever the float value is not within TIE of a .5
    tie."""
    rng = np.random.default_rng(src * 1000 + dst)
    x = rng.integers(0, 256, (3, src, src, 3), np.uint8)
    jf = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float32),
                                     (3, dst, dst, 3), method="bilinear"))
    tf = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2).float(), size=(dst, dst),
        mode="bilinear", align_corners=False,
        antialias=dst < src).permute(0, 2, 3, 1).numpy()
    assert np.abs(tf - jf).max() <= RESIZE_ATOL
    ju = np.asarray(jloader.resize_batch(jnp.asarray(x), dst))
    tu = tloader.resize_batch(torch.from_numpy(x), dst)
    assert tu.dtype == torch.uint8 and tuple(tu.shape) == ju.shape
    away = np.abs(np.abs(jf - np.floor(jf)) - 0.5) > TIE
    _same(tu.numpy()[away], ju[away])
    assert away.mean() > 0.5


def test_resize_batch_identity_and_constants():
    x = torch.full((2, 32, 32, 3), 77, dtype=torch.uint8)
    assert tloader.resize_batch(x, 32) is x
    _same(tloader.resize_batch(x, 224), np.full((2, 224, 224, 3), 77))
    _same(tloader.resize_batch(x, 20), np.full((2, 20, 20, 3), 77))


# -- prefetch ----------------------------------------------------------------------

def test_prefetch_on_and_off_yield_the_same_batches():
    ds = treg._synthetic(70, 8, 10, 1)
    a, b, c = (tloader.BatchLoader(ds, 16, seed=2) for _ in range(3))
    for _ in range(2):
        plain = list(a)
        pre = list(tloader.PrefetchLoader(b, depth=2))
        dev = list(tloader.DevicePrefetchLoader(
            tloader.PrefetchLoader(c, depth=3), "cpu", depth=2))
        assert len(plain) == len(pre) == len(dev) == 4
        for (x, y), (px, py), (dx, dy) in zip(plain, pre, dev):
            _same(px, x)
            _same(py, y)
            _same(dx, x)
            _same(dy, y)
    assert (a.epoch, b.epoch, c.epoch) == (2, 2, 2)


def test_prefetch_never_moves_the_persistent_cursor():
    """A worker producing ahead moves nothing; the consumer's position()
    is what state_dict reports; only a clean exhaustion advances."""
    ds = treg._synthetic(64, 8, 10, 1)
    loader = tloader.BatchLoader(ds, 8)
    it = iter(tloader.PrefetchLoader(loader, depth=4))
    next(it)
    time.sleep(0.3)                    # the worker fills its queue
    assert loader.state_dict() == {"epoch": 0, "batch_cursor": 0}
    loader.position(0, 1)
    assert loader.state_dict() == {"epoch": 0, "batch_cursor": 1}
    it.close()


def test_prefetch_worker_exception_reaches_the_consumer():
    def source():
        yield 1
        yield 2
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in tloader.PrefetchLoader(source(), depth=2):
            got.append(item)
    assert got == [1, 2]


def test_abandoned_prefetch_stops_its_worker_promptly():
    """A consumer that breaks (a preemption) leaves no worker behind, and
    the source generator is closed."""
    closed = threading.Event()

    def source():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.set()

    before = threading.active_count()
    t0 = time.perf_counter()
    for i in tloader.PrefetchLoader(source(), depth=2):
        if i == 3:
            break
    assert closed.wait(5.0)
    deadline = time.perf_counter() + 5.0
    while (threading.active_count() > before
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    assert threading.active_count() == before
    assert time.perf_counter() - t0 < 5.0


def test_device_prefetch_leads_by_its_depth():
    ds = treg._synthetic(80, 8, 10, 1)
    dp = tloader.DevicePrefetchLoader(tloader.BatchLoader(ds, 8), "cpu",
                                      depth=3)
    assert len(list(dp)) == 10
    assert dp.last_stats == {"puts": 10, "max_lead": 3}
    with pytest.raises(ValueError, match=">= 1"):
        tloader.DevicePrefetchLoader([], "cpu", depth=0)


# -- the native gather and process sharding -------------------------------------

@pytest.mark.parametrize("shape,dtype", [((100, 32, 32, 3), np.uint8),
                                         ((50, 7), np.float32),
                                         ((9,), np.int64)])
def test_native_gather_equals_numpy_indexing(shape, dtype):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, shape).astype(dtype)
    idx = rng.integers(0, shape[0], 64)
    for threads in (1, 4):
        _same(native.gather_rows(src, idx, n_threads=threads), src[idx])
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([shape[0]]))


def test_native_loader_batches_equal_numpy_loader():
    ds = treg._synthetic(70, 8, 10, 1)
    a = tloader.BatchLoader(ds, 16, seed=3, use_native=True, num_workers=3)
    b = tloader.BatchLoader(ds, 16, seed=3)
    for (x, y), (u, v) in zip(list(a), list(b), strict=True):
        _same(x, u)
        _same(y, v)


def test_native_build_failure_raises_naming_the_compiler(tmp_path,
                                                         monkeypatch):
    """A failed build raises with the compiler's output; nothing falls
    back to numpy."""
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho 'cxx: no such target' >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no such target"):
        native.gather_rows(np.zeros((2, 2), np.uint8), np.array([1]))


def test_shard_by_process_concatenates_to_the_global_batch(tmp_path):
    """Two gloo ranks: each materializes its contiguous half of every
    global batch; concatenated in rank order they are the one-process
    loader's batches, bit for bit."""
    ds = treg._synthetic(48, 8, 10, 1)
    ranks = tmesh.spawn(workers.sharded_batches, 2, ds.images, ds.labels,
                        16, device="cpu", timeout_s=120, threads=1,
                        store_dir=str(tmp_path))
    whole = list(tloader.BatchLoader(ds, 16, seed=0))
    assert [r["rank"] for r in ranks] == [0, 1]
    for k, (x, y) in enumerate(whole):
        _same(np.concatenate([r["images"][k] for r in ranks]), x)
        _same(np.concatenate([r["labels"][k] for r in ranks]), y)
    with pytest.raises(ValueError, match="not both"):
        tloader.BatchLoader(ds, 16, shard_by_process=True, rows=slice(0, 8))


def test_shard_by_process_follows_the_data_axis(tmp_path):
    """Four gloo ranks as MeshConfig(data=2, stage=2): the two stages of a
    data row materialize the same rows (the rows of ``spec.rows``), and
    the two data rows concatenate to the global batch, bit for bit."""
    ds = treg._synthetic(48, 8, 10, 1)
    ranks = tmesh.spawn(workers.sharded_batches, 4, ds.images, ds.labels,
                        16, device="cpu", timeout_s=120, threads=1,
                        config=tconfig.MeshConfig(data=2, stage=2),
                        store_dir=str(tmp_path))
    whole = list(tloader.BatchLoader(ds, 16, seed=0))
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for k, (x, y) in enumerate(whole):
        for row in (ranks[:2], ranks[2:]):
            _same(row[0]["images"][k], row[1]["images"][k])
            assert row[0]["images"][k].shape[0] == 8
        _same(np.concatenate([ranks[0]["images"][k],
                              ranks[2]["images"][k]]), x)
        _same(np.concatenate([ranks[0]["labels"][k],
                              ranks[2]["labels"][k]]), y)
