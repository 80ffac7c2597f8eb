"""Dataset registry — the port of
``distributed_model_parallel_tpu/data/registry.py`` for ``synthetic`` and
``cifar10``.

Datasets are in-memory NHWC uint8 numpy arrays, made or read on the host
(the same numpy code as the JAX package, so the synthetic sets are
bit-identical). CIFAR-10 is read from the standard local
``cifar-10-batches-py`` pickles; without them the deterministic synthetic
stand-in is used when ``DataConfig.synthetic_ok``. ImageFolder and
CUB-200 (lazy decode) are not ported yet (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)

_FILE_BACKED = ("imagenet", "place365", "cub200")


@dataclasses.dataclass
class ArrayDataset:
    """A materialized labeled image set, NHWC uint8."""

    images: np.ndarray                      # (N, H, W, C) uint8
    labels: np.ndarray                      # (N,) int32
    num_classes: int
    mean: np.ndarray = dataclasses.field(default_factory=lambda: CIFAR10_MEAN)
    std: np.ndarray = dataclasses.field(default_factory=lambda: CIFAR10_STD)

    def __len__(self) -> int:
        return len(self.labels)


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


def load_dataset(cfg) -> tuple[ArrayDataset, ArrayDataset]:
    """(train, eval) for ``cfg.name`` (a DataConfig); synthetic fallback
    when the files are absent and ``cfg.synthetic_ok``."""
    if cfg.name in _FILE_BACKED:
        raise ValueError(f"dataset {cfg.name!r} (ImageFolder / CUB, lazy "
                         f"decode) is not ported yet (ROADMAP A3)")
    if cfg.name == "synthetic":
        loaded = None
    elif cfg.name == "cifar10":
        loaded = _load_cifar10(cfg.root)
    else:
        raise KeyError(f"unknown dataset {cfg.name!r}; known: cifar10, "
                       f"synthetic")
    if loaded is not None:
        return loaded
    if not cfg.synthetic_ok and cfg.name != "synthetic":
        raise FileNotFoundError(f"dataset {cfg.name!r} not found under "
                                f"{cfg.root!r} and synthetic_ok=False")
    native = cfg.synthetic_native_size or cfg.image_size
    return (_synthetic(cfg.synthetic_train_size, native, 10, cfg.seed),
            _synthetic(cfg.synthetic_eval_size, native, 10, cfg.seed + 1))
