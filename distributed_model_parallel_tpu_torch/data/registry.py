"""Dataset registry — the port of
``distributed_model_parallel_tpu/data/registry.py``: the reference's
``DatasetCollection`` (``dataset/dataset_collection.py:28-69``) keyed on
a name, each dataset NHWC uint8 on the host, in memory or decoded per
batch (the same numpy and PIL code as the JAX package, so the arrays,
class indices and the lazy/eager choice are bit-identical):

* ``synthetic`` — deterministic class-conditional images;
* ``cifar10`` — the standard ``cifar-10-batches-py`` pickles;
* ``imagenet`` / ``place365`` — ImageFolder layout
  (``root/{train,val}/<class>/<image>``), decoded with PIL;
* ``cub200`` — CUB-200-2011's ``images.txt``,
  ``image_class_labels.txt`` and ``train_test_split.txt`` joined on image
  id.

Without the files on disk the synthetic stand-in of the dataset's class
count is used when ``DataConfig.synthetic_ok``. PIL is imported inside
the decode, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable

import numpy as np

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class LazyImageArray:
    """Array-like view over image files, decoded per access: only the
    paths are held; ``lazy[idx_array]`` decodes exactly those images (PIL,
    one persistent thread pool) into an NHWC uint8 batch, so an
    ImageNet-scale ImageFolder streams through ``BatchLoader`` batch by
    batch. Exposes the loaders' slice of the ndarray interface
    (``shape``, ``dtype``, ``len``, fancy indexing); converting the whole
    array raises."""

    dtype = np.uint8

    def __init__(self, paths: list[str], image_size: int,
                 num_workers: int = 8):
        self.paths = list(paths)
        self.image_size = image_size
        self.num_workers = num_workers
        self._pool = None          # created on first batch, then reused

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return (len(self.paths), self.image_size, self.image_size, 3)

    def __len__(self) -> int:
        return len(self.paths)

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB").resize((self.image_size, self.image_size))
            return np.asarray(im, np.uint8)

    def __getitem__(self, idx) -> np.ndarray:
        if np.isscalar(idx) or isinstance(idx, (int, np.integer)):
            return self._decode(self.paths[int(idx)])
        idx = np.asarray(idx)
        out = np.empty((len(idx), *self.shape[1:]), np.uint8)
        if len(idx) == 0:
            return out

        def work(j):
            out[j] = self._decode(self.paths[int(idx[j])])

        if self.num_workers > 1 and len(idx) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_workers)
            list(self._pool.map(work, range(len(idx))))
        else:
            for j in range(len(idx)):
                work(j)
        return out

    def close(self) -> None:
        """Shut down the decode pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        self.close()

    def __array__(self, *args, **kwargs):
        raise TypeError(
            f"refusing to materialize all {len(self)} lazily-decoded "
            f"images ({np.prod(self.shape) / 1e9:.1f} GB) into host "
            f"memory; stream batches via BatchLoader, or set "
            f"DataConfig.lazy_decode=False to decode eagerly")


@dataclasses.dataclass
class ArrayDataset:
    """A materialized (or lazily-decoded) labeled image set, NHWC uint8."""

    images: "np.ndarray | LazyImageArray"   # (N, H, W, C) uint8
    labels: np.ndarray                      # (N,) int32
    num_classes: int
    mean: np.ndarray = dataclasses.field(default_factory=lambda: CIFAR10_MEAN)
    std: np.ndarray = dataclasses.field(default_factory=lambda: CIFAR10_STD)

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def is_lazy(self) -> bool:
        return isinstance(self.images, LazyImageArray)


def _synthetic(n: int, image_size: int, num_classes: int, seed: int,
               mean=CIFAR10_MEAN, std=CIFAR10_STD) -> ArrayDataset:
    """Deterministic class-conditional synthetic images (learnable signal,
    so smoke-training shows decreasing loss rather than pure noise)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    base = rng.integers(0, 256, size=(num_classes, image_size, image_size, 3))
    noise = rng.integers(-40, 41, size=(n, image_size, image_size, 3))
    images = np.clip(base[labels] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(images=images, labels=labels, num_classes=num_classes,
                        mean=mean, std=std)


def _load_cifar10(root: str) -> tuple[ArrayDataset, ArrayDataset] | None:
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None

    def read(names):
        xs, ys = [], []
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(batch[b"data"], np.uint8))
            ys.append(np.asarray(batch[b"labels"], np.int32))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(x), np.concatenate(ys)

    xtr, ytr = read([f"data_batch_{i}" for i in range(1, 6)])
    xte, yte = read(["test_batch"])
    return (ArrayDataset(xtr, ytr, 10, CIFAR10_MEAN, CIFAR10_STD),
            ArrayDataset(xte, yte, 10, CIFAR10_MEAN, CIFAR10_STD))


# Datasets whose decoded pixels exceed this stream from disk when
# DataConfig.lazy_decode is None.
LAZY_AUTO_BYTES = 2 << 30


def _build_split(paths: list[str], labels: list[int], image_size: int,
                 num_classes: int, mean, std, lazy: bool | None,
                 num_workers: int) -> ArrayDataset:
    """One split as decoded pixels or a :class:`LazyImageArray`;
    ``lazy=None`` streams when the decoded size exceeds
    :data:`LAZY_AUTO_BYTES`."""
    y = np.asarray(labels, np.int32)
    if lazy is None:
        lazy = len(paths) * image_size * image_size * 3 > LAZY_AUTO_BYTES
    imgs = LazyImageArray(paths, image_size, num_workers=num_workers)
    if not lazy:
        decoded = imgs[np.arange(len(paths))]
        imgs.close()
        imgs = decoded
    return ArrayDataset(imgs, y, num_classes, mean, std)


def _load_imagefolder(root: str, image_size: int,
                      mean=IMAGENET_MEAN, std=IMAGENET_STD, *,
                      lazy: bool | None = None, num_workers: int = 8
                      ) -> tuple[ArrayDataset, ArrayDataset] | None:
    """ImageFolder layout ``root/{train,val}/<class>/<image>``: classes
    in sorted order (the validation split takes the training split's
    indices), files sorted by name."""
    tr, va = os.path.join(root, "train"), os.path.join(root, "val")
    if not (os.path.isdir(tr) and os.path.isdir(va)):
        return None

    def scan(split_dir, class_to_idx=None):
        classes = sorted(e.name for e in os.scandir(split_dir) if e.is_dir())
        if class_to_idx is None:
            class_to_idx = {c: i for i, c in enumerate(classes)}
        paths, ys = [], []
        for c in classes:
            cdir = os.path.join(split_dir, c)
            for e in sorted(os.scandir(cdir), key=lambda e: e.name):
                if e.is_file():
                    paths.append(e.path)
                    ys.append(class_to_idx[c])
        return paths, ys, class_to_idx

    ptr, ytr, c2i = scan(tr)
    pte, yte, _ = scan(va, c2i)
    n = len(c2i)
    return (_build_split(ptr, ytr, image_size, n, mean, std, lazy,
                         num_workers),
            _build_split(pte, yte, image_size, n, mean, std, lazy,
                         num_workers))


def _load_cub200(root: str, image_size: int, *,
                 lazy: bool | None = None, num_workers: int = 8
                 ) -> tuple[ArrayDataset, ArrayDataset] | None:
    """CUB-200-2011: ``images.txt``, ``image_class_labels.txt`` (labels
    from 1) and ``train_test_split.txt`` joined on image id, in id
    order."""
    meta = {n: os.path.join(root, n) for n in
            ("images.txt", "image_class_labels.txt", "train_test_split.txt")}
    if not all(os.path.isfile(p) for p in meta.values()):
        return None

    def read_table(path):
        out = {}
        with open(path) as f:
            for line in f:
                k, v = line.split()
                out[int(k)] = v
        return out

    paths = read_table(meta["images.txt"])
    labels = {k: int(v) - 1
              for k, v in read_table(meta["image_class_labels.txt"]).items()}
    is_train = {k: v == "1"
                for k, v in read_table(meta["train_test_split.txt"]).items()}
    splits = {True: ([], []), False: ([], [])}
    for img_id, rel in sorted(paths.items()):
        ps, ys = splits[is_train[img_id]]
        ps.append(os.path.join(root, "images", rel))
        ys.append(labels[img_id])
    n = max(labels.values()) + 1
    mk = lambda ps, ys: _build_split(ps, ys, image_size, n, IMAGENET_MEAN,
                                     IMAGENET_STD, lazy, num_workers)
    return mk(*splits[True]), mk(*splits[False])


_LOADERS: dict[str, Callable] = {
    "cifar10": lambda cfg: _load_cifar10(cfg.root),
    "imagenet": lambda cfg: _load_imagefolder(
        os.path.join(cfg.root, "imagenet"), cfg.image_size,
        lazy=cfg.lazy_decode, num_workers=max(1, cfg.num_workers)),
    "place365": lambda cfg: _load_imagefolder(
        os.path.join(cfg.root, "place365"), cfg.image_size,
        lazy=cfg.lazy_decode, num_workers=max(1, cfg.num_workers)),
    "cub200": lambda cfg: _load_cub200(
        os.path.join(cfg.root, "CUB_200_2011"), cfg.image_size,
        lazy=cfg.lazy_decode, num_workers=max(1, cfg.num_workers)),
}
_NUM_CLASSES = {"cifar10": 10, "imagenet": 1000, "place365": 365,
                "cub200": 200}


def load_dataset(cfg) -> tuple[ArrayDataset, ArrayDataset]:
    """(train, eval) for ``cfg.name`` (a DataConfig); the synthetic
    stand-in of the dataset's class count when the files are absent and
    ``cfg.synthetic_ok``."""
    if cfg.name == "synthetic":
        loaded = None
        num_classes = 10
    else:
        if cfg.name not in _LOADERS:
            raise KeyError(f"unknown dataset {cfg.name!r}; known: "
                           f"{sorted(_LOADERS)} + synthetic")
        loaded = _LOADERS[cfg.name](cfg)
        num_classes = _NUM_CLASSES[cfg.name]
    if loaded is not None:
        return loaded
    if not cfg.synthetic_ok and cfg.name != "synthetic":
        raise FileNotFoundError(f"dataset {cfg.name!r} not found under "
                                f"{cfg.root!r} and synthetic_ok=False")
    native = cfg.synthetic_native_size or cfg.image_size
    return (_synthetic(cfg.synthetic_train_size, native, num_classes,
                       cfg.seed),
            _synthetic(cfg.synthetic_eval_size, native, num_classes,
                       cfg.seed + 1))
